// Partial-score decode for Hopper (sm_90a): one query token per row over a
// dense KV cache of which this rank holds a slice of Dl of every head's D
// dims, as two passes.
//
// Replaces, with flash_decode.cu, the Pallas TPU kernel
// repro/kernels/decode_attention/kernel.py::flash_decode (body
// _decode_kernel) where the cache [B, C, Hkv, D] is split on its head dim
// (the reference's default cache plan, repro/parallel/sharding.py shards
// it on D): the softmax needs the full q.k scores, which no rank holds, so
// GSPMD partitions the reference by all-reducing the partial scores before
// the softmax.  The TPU kernel computes q.k and p.v in its own body, so the
// two halves are hand-written here, and the caller sums the scores between
// them:
//
// decode_scores (pass 1): s[b, h, c] = scale * sum_d q[b, h, d] *
//   k[b, c, h / G, d] over the local slice; float32 [B, H, C]; no mask
//   (the mask comes after the sum over ranks).
// decode_softmax_pv (pass 2): on the summed s, K3's masks (slot c of row b
//   is attended iff 0 <= k_pos[b, c] <= q_pos[b] and, with a window,
//   k_pos > q_pos - window), an fp32 softmax and p.v over the local slice
//   of V; o [B, H, Dl] in V's type; a head with nothing attended gives 0.
//
// Every product and sum is fp32 on the CUDA cores: no TF32, no bf16
// operand.
//
// Bound on the H100: HBM bytes.  Pass 1 reads the K slice and writes
// B * H * C * 4 bytes of scores for 2 FLOPs per K element and head; pass 2
// reads those scores and the V slice.  At a large model axis the slice is
// small and the scores, not the cache, bound both passes.
//
// Design (simple and right first; wgmma and TMA are later work):
// Pass 1: grid (ceil(C / 128), Hkv * NG, B), 128 threads.  A block stages
//   128 slots of its KV head's K slice in shared memory as fp32, kChunk
//   dims at a time (16-byte loads where the slice's rows allow, each
//   thread's 8 loads issued before any is stored), with the group's Gc
//   queries; thread c then owns slot c and keeps Gc dots in registers, so
//   each K element is read from HBM once per head group and the scores
//   are written coalesced along C.  Staged rows are padded to an odd
//   number of 16-byte pieces (an odd number of floats on the scalar
//   path), so 32 threads reading 32 rows meet no bank conflict.
// Pass 2: grid (n_split, Hkv * NG * ND, B), 128 threads.  Block (s, y, b)
//   walks split s of row b's tiles of kPvTile slots for one head group and
//   one chunk of kChunk dims (ND = ceil(Dl / kChunk)).  A tile's positions,
//   scores and V pieces are loaded into registers one tile ahead (two
//   register sets), so a tile waits on no load of its own.  Per tile,
//   warp w turns the scores of heads w and w + 4 into p against a running
//   max (lane = slot; shuffles give the tile's max and sum), the block
//   stages p and the tile's V chunk (slots not attended as zeros, whatever
//   they hold), and thread (row group, dim) rescales its Gc sums and adds
//   its row group's slots, reading each staged V value once for all Gc
//   heads and their p as broadcast float4s (a read of p and V for each
//   (head, dim) would make shared memory the limit: 2 reads an FMA).
//   The row groups' sums meet in shared memory at the end.  With several splits each writes
//   its fp32 (acc, m, l) to scratch and the last to finish (a
//   __threadfence, then an atomicAdd ticket) merges them, writes o and
//   resets the ticket to 0 for the next launch.  The TPU's sequential
//   cache axis becomes the tile loop; its VMEM (acc, m, l) carry becomes
//   registers.
#include "split_decode.cuh"

namespace {

using repro::from_f32;
using repro::kEmptyPos;
using repro::kNegInf;
using repro::to_f32;
namespace sd = repro::split;

constexpr int kThreads = 128;
constexpr int kScoreTile = kThreads;   // pass 1: slots a block serves
constexpr int kChunk = 64;             // dims staged (pass 1) or served
                                       // (pass 2) at a time
constexpr int kPvTile = 32;            // pass 2: slots a tile (a lane each)
constexpr float kLog2e = 1.4426950408889634f;

// Row stride in floats of a staged chunk of w dims that threads read one
// row each: an odd number of 16-byte pieces for float4 reads, an odd
// number of floats for scalar ones.
__device__ __forceinline__ int odd_stride(int w, bool vec) {
  return vec ? 4 * (((w + 3) / 4) | 1) : (w | 1);
}

// One piece of a row in flight, as loaded: 16 bytes (VEC) or one
// element; store() writes it to shared memory as fp32 (or zeros).
template <typename T, bool VEC>
struct Piece {
  static constexpr int E = 1;
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = *p; }
  __device__ __forceinline__ void store(float* dst, bool keep) const {
    *dst = keep ? to_f32(raw) : 0.f;
  }
};

template <typename T>
struct Piece<T, true> {
  static constexpr int E = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void store(float* dst, bool keep) const {
    float x[E];
    if constexpr (E == 8) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
    } else {
      const float4 f = *reinterpret_cast<const float4*>(&raw);
      x[0] = f.x;
      x[1] = f.y;
      x[2] = f.z;
      x[3] = f.w;
    }
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(dst + e) =
          keep ? make_float4(x[e], x[e + 1], x[e + 2], x[e + 3])
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// Stage rows r < n (row r at src + r * row_stride) of a chunk of w dims
// into dst[r * stride + d] as fp32, U pieces a thread in flight at once
// (VEC: w a multiple of 16 / sizeof(T), every row 16-byte aligned).
template <typename T, bool VEC, int U>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const T* __restrict__ src,
                                           long long row_stride, int n,
                                           int w, int stride) {
  using P = Piece<T, VEC>;
  const int per_row = w / P::E, total = n * per_row;
  for (int base = threadIdx.x; base < total; base += kThreads * U) {
    P x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads, r = i / per_row;
      if (i < total) x[u].load(src + r * row_stride + (i - r * per_row) * P::E);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads, r = i / per_row;
      if (i < total) x[u].store(dst + r * stride + (i - r * per_row) * P::E,
                                true);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Strides in elements; the last dim of q, k and v is contiguous.
struct Strides {
  long long qb, qh, kb, kc, kh;
};

// ------------------------------------------------------------ pass 1
template <typename T, int G, bool VEC>
__global__ void __launch_bounds__(kThreads)
    scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  float* __restrict__ s, Strides st, int C, int Hkv,
                  int Gall, int NG, int Dl, float scale) {
  __shared__ __align__(16) float q_s[G * kChunk];
  __shared__ __align__(16) float k_s[kScoreTile * (kChunk + 4)];
  const int b = blockIdx.z, hk = blockIdx.y / NG, hg = blockIdx.y % NG;
  const int c0 = blockIdx.x * kScoreTile, n = min(kScoreTile, C - c0);
  const int h0 = hk * Gall + hg * G, Gw = min(G, Gall - hg * G);
  const int c = threadIdx.x;
  const T* qb = q + b * st.qb + h0 * st.qh;
  const T* kb = k + b * st.kb + c0 * st.kc + hk * st.kh;

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  for (int d0 = 0; d0 < Dl; d0 += kChunk) {
    const int w = min(kChunk, Dl - d0), stride = odd_stride(w, VEC);
    __syncthreads();                   // the last chunk has been read
    for (int i = threadIdx.x; i < G * w; i += kThreads) {
      const int g = i / w, d = i - g * w;
      q_s[g * kChunk + d] = g < Gw ? to_f32(qb[g * st.qh + d0 + d]) : 0.f;
    }
    stage_rows<T, VEC, 8>(k_s, kb + d0, st.kc, n, w, stride);
    __syncthreads();
    if (c < n) {
      const float* kr = k_s + c * stride;
      if constexpr (VEC) {
        for (int d = 0; d < w; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 qq =
                *reinterpret_cast<const float4*>(q_s + g * kChunk + d);
            acc[g] = fmaf(qq.x, kk.x, acc[g]);
            acc[g] = fmaf(qq.y, kk.y, acc[g]);
            acc[g] = fmaf(qq.z, kk.z, acc[g]);
            acc[g] = fmaf(qq.w, kk.w, acc[g]);
          }
        }
      } else {
        for (int d = 0; d < w; ++d) {
          const float kk = kr[d];
#pragma unroll
          for (int g = 0; g < G; ++g)
            acc[g] = fmaf(q_s[g * kChunk + d], kk, acc[g]);
        }
      }
    }
  }
  if (c < n) {
    float* sb = s + ((long long)b * Hkv * Gall + h0) * C + c0 + c;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g < Gw) sb[(long long)g * C] = acc[g] * scale;
  }
}

// ------------------------------------------------------------ pass 2
// What a thread holds of one tile of kPvTile slots before it is used:
// its lane's slot position and the scores of its warp's heads, and its
// pieces of the tile's V chunk.
template <typename T, bool VEC, int HW>
struct TileRegs {
  static constexpr int NP = kPvTile * kChunk / kThreads / Piece<T, VEC>::E;
  int kp;
  float s[HW];
  Piece<T, VEC> v[NP];
};

template <typename T, int G, bool VEC>
__global__ void __launch_bounds__(kThreads) softmax_pv_kernel(
    const float* __restrict__ s, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    T* __restrict__ o, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ counters, long long vb_,
    long long vc_, long long vh_, int C, int Hkv, int Gall, int NG, int ND,
    int Dl, int n_split, int window) {
  constexpr int HW = (G + 3) / 4;      // heads a warp scores (<= 2)
  constexpr int GP = (G + 3) / 4 * 4;  // heads padded to float4s
  using Regs = TileRegs<T, VEC, HW>;
  constexpr int E = Piece<T, VEC>::E;
  __shared__ __align__(16) float v_s[kPvTile * kChunk];
  __shared__ __align__(16) float p_s[kPvTile * GP];    // [slot][head]
  __shared__ __align__(16) float alpha_s[GP];
  __shared__ float m_s[G], l_s[G];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, split = blockIdx.x;
  const int dc = blockIdx.y % ND, hgk = blockIdx.y / ND;
  const int hk = hgk / NG, hg = hgk % NG;
  const int h0 = hk * Gall + hg * G, Gw = min(G, Gall - hg * G);
  const int H = Hkv * Gall, d0 = dc * kChunk, w = min(kChunk, Dl - d0);
  const int per_row = w / E;
  // p.v: thread (row group rg, dim d) owns dim d of every head over the
  // tile's slots rg, rg + R, ...; W = w rounded up to a power of two
  int W = 1;
  while (W < w) W *= 2;
  const int R = kThreads / W, d = tid % W, rg = tid / W;
  const int qp = q_pos[b];
  const int* kpb = k_pos + (long long)b * C;
  const float* sb = s + ((long long)b * H + h0) * C;
  const T* vb = v + b * vb_ + hk * vh_ + d0;
  const int n_tiles = (C + kPvTile - 1) / kPvTile;
  const int t_lo = (int)((long long)split * n_tiles / n_split);
  const int t_hi = (int)((long long)(split + 1) * n_tiles / n_split);

  // issue the loads of tile t; nothing waits for them until use()
  auto fetch = [&](int t, Regs& x) {
    const int c0 = t * kPvTile, c = c0 + lane;
    const int n = min(kPvTile, C - c0);
    x.kp = c < C ? __ldg(kpb + c) : kEmptyPos;
#pragma unroll
    for (int j = 0; j < HW; ++j) {
      const int g = warp + 4 * j;
      x.s[j] = g < Gw && c < C ? __ldg(sb + (long long)g * C + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < Regs::NP; ++u) {
      const int i = tid + u * kThreads, r = i / per_row;
      if (i < n * per_row)
        x.v[u].load(vb + (c0 + r) * vc_ + (i - r * per_row) * E);
    }
  };

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  float m[HW], l[HW];                  // heads warp + 4 j, on every lane
#pragma unroll
  for (int j = 0; j < HW; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
  }
  if (tid < GP) alpha_s[tid] = 1.f;    // padding heads: p = 0, alpha = 1
  for (int i = tid; i < kPvTile * GP; i += kThreads) p_s[i] = 0.f;

  // the online softmax and p.v over tile t, from its registers
  auto use = [&](int t, const Regs& x) {
    const int c0 = t * kPvTile, n = min(kPvTile, C - c0);
    const bool ok =
        x.kp >= 0 && x.kp <= qp && (window < 0 || x.kp > qp - window);
    __syncthreads();                   // the last tile has been read
#pragma unroll
    for (int j = 0; j < HW; ++j) {
      const int g = warp + 4 * j;
      if (g < G) {
        const bool in = ok && g < Gw;
        const float y = in ? x.s[j] * kLog2e : kNegInf;
        const float mn = fmaxf(m[j], warp_max(y));
        const float p = in ? exp2f(y - mn) : 0.f;
        const float a = exp2f(m[j] - mn);
        l[j] = fmaf(l[j], a, warp_sum(p));
        m[j] = mn;
        p_s[lane * GP + g] = p;
        if (lane == 0) alpha_s[g] = a;
      }
    }
    // a slot that is not attended is staged as zeros (it may hold
    // anything); its row's position sits in lane r of every warp
#pragma unroll
    for (int u = 0; u < Regs::NP; ++u) {
      const int i = tid + u * kThreads, r = i / per_row;
      const bool keep =
          __shfl_sync(0xffffffffu, (int)ok, r & (kPvTile - 1)) != 0;
      if (i < n * per_row)
        x.v[u].store(v_s + r * w + (i - r * per_row) * E, keep);
    }
    __syncthreads();
    if (d < w) {
      // each V value read once for all G heads; p and alpha as float4s
#pragma unroll
      for (int g4 = 0; g4 < GP; g4 += 4) {
        const float4 a = *reinterpret_cast<const float4*>(alpha_s + g4);
        const float al[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (g4 + e < G) acc[g4 + e] *= al[e];
      }
      for (int r = rg; r < n; r += R) {
        const float vv = v_s[r * w + d];
#pragma unroll
        for (int g4 = 0; g4 < GP; g4 += 4) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + r * GP + g4);
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (g4 + e < G) acc[g4 + e] = fmaf(pv[e], vv, acc[g4 + e]);
        }
      }
    }
  };

  // two register sets: tile t + 1's loads fly while tile t is used
  Regs ra, rb;
  if (t_lo < t_hi) fetch(t_lo, ra);
  for (int t = t_lo; t < t_hi; t += 2) {
    if (t + 1 < t_hi) fetch(t + 1, rb);
    use(t, ra);
    if (t + 1 < t_hi) {
      if (t + 2 < t_hi) fetch(t + 2, ra);
      use(t + 1, rb);
    }
  }
#pragma unroll
  for (int j = 0; j < HW; ++j) {
    const int g = warp + 4 * j;
    if (g < G && lane == 0) {
      m_s[g] = m[j];
      l_s[g] = l[j];
    }
  }
  // the row groups' partial sums (same running max) through shared
  // memory: red [R][G][w] over v_s, which the last tile no longer needs
  __syncthreads();
  float* red = v_s;
  if (d < w) {
#pragma unroll
    for (int g = 0; g < G; ++g) red[(rg * G + g) * w + d] = acc[g];
  }
  __syncthreads();
  const int n_out = Gw * w;
  auto total = [&](int i) {
    float a = 0.f;
    for (int r = 0; r < R; ++r) a += red[r * G * w + i];
    return a;
  };
  T* ob = o + ((long long)b * H + h0) * Dl + d0;
  if (n_split == 1) {
    for (int i = tid; i < n_out; i += kThreads) {
      const int g = i / w;
      ob[g * Dl + i - g * w] = from_f32<T>(total(i) / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }

  // scratch of this (b, hk, hg, dc): acc [n_split][G][kChunk], (m, l)
  // [n_split][G][2]
  const long long blk = (long long)b * gridDim.y + blockIdx.y;
  float* pa = part_acc + blk * n_split * G * kChunk;
  float* pm = part_ml + blk * n_split * G * 2;
  for (int i = tid; i < n_out; i += kThreads) {
    const int g = i / w;
    pa[(split * G + g) * kChunk + i - g * w] = total(i);
  }
  if (tid < Gw) {
    pm[(split * G + tid) * 2] = m_s[tid];
    pm[(split * G + tid) * 2 + 1] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + blk, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < n_out; i += kThreads) {
    const int g = i / w, dd = i - g * w;
    float mx = kNegInf;
    for (int sp = 0; sp < n_split; ++sp)
      mx = fmaxf(mx, __ldcg(pm + (sp * G + g) * 2));
    float L = 0.f, A = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float ws = exp2f(__ldcg(pm + (sp * G + g) * 2) - mx);
      L = fmaf(__ldcg(pm + (sp * G + g) * 2 + 1), ws, L);
      A = fmaf(__ldcg(pa + (sp * G + g) * kChunk + dd), ws, A);
    }
    ob[g * Dl + dd] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
  if (tid == 0) counters[blk] = 0;     // ready for the next launch
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch_scores(const void* q, const void* k, void* s,
                          const Strides& st, int B, int C, int Hkv, int G,
                          int Dl, float scale, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int NG = sd::head_groups(G), Gc = sd::group_heads(G);
  const bool vec = aligned16(k) && Dl % E == 0 && st.kb % E == 0 &&
                   st.kc % E == 0 && st.kh % E == 0;
  const dim3 grid((C + kScoreTile - 1) / kScoreTile, Hkv * NG, B);
  return sd::with_group(Gc, [&](auto g) {
    constexpr int Gt = decltype(g)::value;
    auto kernel = vec ? scores_kernel<T, Gt, true> : scores_kernel<T, Gt, false>;
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<float*>(s), st, C, Hkv, G, NG, Dl, scale);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_softmax_pv(const void* s, const void* v, const void* q_pos,
                              const void* k_pos, void* o, void* part_acc,
                              void* part_ml, void* counters, long long vb,
                              long long vc, long long vh, int B, int C,
                              int Hkv, int G, int Dl, int n_split, int window,
                              cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int NG = sd::head_groups(G), Gc = sd::group_heads(G);
  const int ND = (Dl + kChunk - 1) / kChunk;
  const bool vec = aligned16(v) && Dl % E == 0 && vb % E == 0 &&
                   vc % E == 0 && vh % E == 0;
  const dim3 grid(n_split, Hkv * NG * ND, B);
  return sd::with_group(Gc, [&](auto g) {
    constexpr int Gt = decltype(g)::value;
    auto kernel = vec ? softmax_pv_kernel<T, Gt, true>
                      : softmax_pv_kernel<T, Gt, false>;
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(s), static_cast<const T*>(v),
        static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
        static_cast<T*>(o), static_cast<float*>(part_acc),
        static_cast<float*>(part_ml), static_cast<int*>(counters), vb, vc, vh,
        C, Hkv, G, NG, ND, Dl, n_split, window);
    return cudaGetLastError();
  });
}

bool bad_sizes(int B, int C, int Hkv, int G, int Dl, int ND) {
  return B < 1 || C < 1 || Hkv < 1 || G < 1 || Dl < 1 || B > 65535 ||
         (long long)Hkv * sd::head_groups(G) * ND > 65535;
}

}  // namespace

// q [B, Hkv*G, Dl] at strides (q_sb, q_sh, 1), k [B, C, Hkv, Dl] at strides
// (k_sb, k_sc, k_sh, 1), both of one dtype (0 = float32, 1 = bfloat16);
// s float32 [B, Hkv*G, C], contiguous.  Returns cudaGetLastError() of the
// launch.
extern "C" int decode_scores(const void* q, const void* k, void* s,
                             long long q_sb, long long q_sh, long long k_sb,
                             long long k_sc, long long k_sh, int B, int C,
                             int Hkv, int G, int Dl, float scale, int dtype,
                             int device, void* stream) {
  if (bad_sizes(B, C, Hkv, G, Dl, 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides st{q_sb, q_sh, k_sb, k_sc, k_sh};
  auto cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scores<float>(q, k, s, st, B, C, Hkv, G, Dl, scale, cs);
  if (dtype == 1)
    return launch_scores<__nv_bfloat16>(q, k, s, st, B, C, Hkv, G, Dl, scale,
                                        cs);
  return cudaErrorInvalidValue;
}

// s float32 [B, Hkv*G, C] (the scores summed over the ranks), v
// [B, C, Hkv, Dl] at strides (v_sb, v_sc, v_sh, 1), q_pos [B] and k_pos
// [B, C] int32, o [B, Hkv*G, Dl] in v's dtype (0 = float32, 1 = bfloat16);
// s, q_pos, k_pos and o contiguous.  window < 0 means no window.  With
// n_split > 1, over NG = ceil(G / 8) head groups of Gc = ceil(G / NG) heads
// and ND = ceil(Dl / 64) chunks of dims: part_acc float32
// [B, Hkv, NG, ND, n_split, Gc, 64], part_ml float32
// [B, Hkv, NG, ND, n_split, Gc, 2] and counters int32 [B * Hkv * NG * ND],
// all 0 before the first launch (each launch leaves them 0); launches
// sharing counters must run in stream order.  Returns cudaGetLastError()
// of the launch.
extern "C" int decode_softmax_pv(const void* s, const void* v,
                                 const void* q_pos, const void* k_pos,
                                 void* o, void* part_acc, void* part_ml,
                                 void* counters, long long v_sb,
                                 long long v_sc, long long v_sh, int B, int C,
                                 int Hkv, int G, int Dl, int n_split,
                                 int window, int dtype, int device,
                                 void* stream) {
  const int ND = (Dl + kChunk - 1) / kChunk;
  const int n_tiles = (C + kPvTile - 1) / kPvTile;
  if (bad_sizes(B, C, Hkv, G, Dl, ND) || n_split < 1 || n_split > n_tiles ||
      (n_split > 1 && (!part_acc || !part_ml || !counters)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_softmax_pv<float>(s, v, q_pos, k_pos, o, part_acc, part_ml,
                                    counters, v_sb, v_sc, v_sh, B, C, Hkv, G,
                                    Dl, n_split, window, cs);
  if (dtype == 1)
    return launch_softmax_pv<__nv_bfloat16>(
        s, v, q_pos, k_pos, o, part_acc, part_ml, counters, v_sb, v_sc, v_sh,
        B, C, Hkv, G, Dl, n_split, window, cs);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* decode_softmax_pv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
