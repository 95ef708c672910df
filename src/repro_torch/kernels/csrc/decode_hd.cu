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
// Bound on the H100: HBM bytes, in both passes and both dtypes (2 FLOPs
// per K or V element and head, far under the ridge).  Pass 1 reads the K
// slice and writes B * H * C * 4 bytes of scores; pass 2 reads those
// scores, the V slice and the positions.  At a large model axis the slice
// is small and the f32 scores, not the cache, are most of the bytes.  To
// move them at HBM's 3.35 TB/s against ~1 us of latency under load, an SM
// needs some 16-32 KB in flight at every moment, so both passes are built
// around a ring of shared-memory stages filled by 16-byte cp.async:
//
// Pass 1, "ring" (scores_ring_kernel): persistent blocks walk the (row,
//   run of TS slots) tiles, tile blockIdx.x + i * gridDim.x.  A tile's K
//   rows [TS, Hkv, Dl] for every KV head (one contiguous run of a rank's
//   slice), with its row's q [H, Dl], go into stage i % S of the block's
//   ring (TS sized so a stage holds <= 16 KB of K), so S - 1 tiles are in
//   flight while one is used and a tile's score stores overlap the next
//   tiles' copies; one barrier a tile.  bf16: 256 threads, 2 blocks an
//   SM, S = 3; staged rows are padded to an odd number of 16-byte pieces
//   (no bank conflicts for ldmatrix); S^T = Q K^T on the tensor cores
//   (mma.sync m16n8k16: Q's 16 head rows of a KV head as A, loaded once a
//   tile, K's slots as B through ldmatrix; bf16 products are exact in
//   fp32, the sums fp32).  The scores go out along C, 16 bytes a lane:
//   neighbouring lanes swap a pair so each holds 4 slots of a head.
//   float32: 128 threads, up to 4 blocks an SM, S = 2 (its products hold
//   a warp longer, and more, smaller blocks keep more tiles in flight
//   while they run; the bf16 shape measured slower on the H100).  Every
//   product is three TF32 mma.sync m16n8k8 of hi / lo splits (float32 is
//   held to 2e-5, which one TF32 product misses),
//   with decode_block_tf32x3's layout (split_decode.cuh): a warp's row
//   group of up to 8 heads holds hi(q) in rows 0..7 of the m16 tile and
//   lo(q) in rows 8..15, so one mma with hi(K) gives hi.hi and lo.hi for
//   the same slots and one with lo(K) gives hi.lo: two mma a k8 step.  A
//   lane reads dims 4 t4 .. 4 t4 + 3 of each 16 as one float4 of its q
//   row (split once a tile, the first 64 dims held in registers) and of
//   K row g (B (k t4, n g) of two k8 steps), the reads past Dl zero, so a
//   Dl that is not a multiple of 8 (danube's 20) runs as whole k8 steps;
//   staged rows are 64 mod 128 bytes, so the two rows a quarter warp
//   reads meet no bank conflict.  A warp's unit is 8 slots of a row
//   group; G 12 / 16 run as two row groups over the same staged tile
//   (rereading shared memory, not HBM).  No tensor-core accumulator sums
//   more than 64 dims (their fp32 sums are not rounded to nearest): each
//   run's hi.hi, lo.hi and hi.lo meet the others in fp32, and a score is
//   hi.hi + (lo.hi + hi.lo).
// Pass 2, "ring" (softmax_pv_ring_kernel): grid (n_split, units, B), 128
//   threads.  A unit is (KV head, group of <= 16 heads, chunk of <= 64
//   dims); a block serves one unit of split s of row b.  Each of its 4
//   warps walks every 4th tile of 16 or 32 slots of the split through its
//   own ring of 3 stages, as decode_block_mma
//   does for K3 whole: a stage holds the tile's scores of the unit's heads
//   (rows of TW + 8 floats) and its V rows.  Lane l loads slot l's
//   position 2 tiles ahead of the tile's copies, and a ballot of the
//   attended slots decides them: only attended slots are copied (V rows of
//   the rest are zero-filled, whatever they hold; scores by 4-slot
//   pieces), a tile with none is skipped, and the mask stays in a register
//   for the softmax.  The warp syncs only with itself, so no warp waits on
//   another's copies.  Its fp32 online softmax runs in the mma A layout
//   (lane (g, t4) holds heads g and g + 8 of 4 slots a 16-slot chunk;
//   rows 8..15 are skipped when the unit has <= 8 heads).  bf16: O += P V
//   on the tensor cores, P packed to bf16 from registers, V through
//   ldmatrix.trans.  f32: O += P V in 3xTF32 mma.sync m16n8k8, P split
//   straight from its registers (k t4 is the lane's slot 2 t4, k t4 + 4
//   slot 2 t4 + 1): a unit of <= 8 heads holds hi(p) in rows 0..7 and
//   lo(p) in rows 8..15 (two mma a k8 step and n8 tile; at G <= 8 an
//   instance without the wider form), a unit of 9..16 heads heads g and
//   g + 8 with lo(p) in a second A fragment (three: at G 12 it measured
//   faster than two units of 8 rows that each read the V slice);
//   column g of n8 tiles 2 m and 2 m + 1 is dims 16 m + 2 g and + 1, so a
//   lane reads V's B fragments as two float2 of the stage (rows are 4 mod
//   8 floats: the four t4 rows meet no bank conflict).  Each tile's P V
//   is summed from zero and folded into O with the softmax correction by
//   one fp32 fma.  The warps merge through shared memory; with several
//   splits each writes its fp32 (acc, m, l) to scratch and the last to
//   finish (a __threadfence, then an atomicAdd ticket) merges them, writes
//   o and resets the ticket to 0.  The split count is chosen by the caller to
//   fill whole waves.  (A first version, a block over every KV head with
//   one block-wide barrier a tile, measured 2-4x slower at a 8-dim slice:
//   every warp waited on the block's slowest copy and its positions.)
//
// The first design's bodies stay for what 16-byte copies cannot reach
// ("simt": Dl * sizeof(T) not a multiple of 16, such as Dl 5, or a
// pointer or stride not 16-byte aligned), behind the original entry
// points decode_scores and decode_softmax_pv:
// Pass 1: grid (ceil(C / 128), Hkv * NG, B), 128 threads.  A block stages
//   128 slots of its KV head's K slice in shared memory as fp32, kChunk
//   dims at a time, with the group's Gc queries; thread c then owns slot c
//   and keeps Gc dots in registers.
// Pass 2: grid (n_split, Hkv * NG * ND, B), 128 threads.  Block (s, y, b)
//   walks split s of row b's tiles of kPvTile slots for one head group and
//   one chunk of kChunk dims, the next tile's positions, scores and V
//   pieces loaded into a second register set while the current one is
//   used; thread (row group, dim) owns one dim of every head.  Splits
//   merge as in the ring body.
#include <initializer_list>

#include "split_decode.cuh"

namespace {

using repro::allow_smem;
using repro::from_f32;
using repro::kEmptyPos;
using repro::kNegInf;
using repro::to_f32;
namespace sd = repro::split;
namespace sm90 = repro::sm90;

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
                          int NG, int Dl, float scale, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int Gc = (G + NG - 1) / NG;
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
                              int Hkv, int G, int NG, int Dl, int n_split,
                              int window, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int Gc = (G + NG - 1) / NG;
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

// ------------------------------------------------------ ring bodies
constexpr int kUnitRows = 16;          // heads of a pass-2 unit (m16 rows)
constexpr int kUnitDims = 64;          // dims of a pass-2 unit
constexpr int kQregs = 4;              // pass 1: q's k16 steps in registers
constexpr int kPvWarps = 4;            // pass 2: warps of a block, each
constexpr int kPvThreads = 32 * kPvWarps;  // with its own ring
constexpr int kPvStages = 3;           // pass 2: stages of a warp's ring
constexpr int kPvAhead = 2;            // pass 2: tiles of positions loaded
                                       // ahead of the copies
constexpr int kMaxKC = 2;              // pass 2: 16-slot chunks of a tile
constexpr int kMaxSmem = 231424;       // dynamic shared memory of a block
                                       // (227 KB less 1 KB for static)

// Bytes of a staged row of `bytes` (a multiple of 16): an odd number of
// 16-byte pieces, so 8 rows read together meet no bank conflict.
__host__ __device__ inline int odd16(int bytes) {
  return 16 * ((bytes / 16) | 1);
}

// 2^x in one MUFU instruction (max relative error ~2^-22, far inside the
// 2e-5 gate); subnormal results flush to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 / 4 bytes from global memory to the shared-memory address dst, or
// zeros (nothing read)
__device__ __forceinline__ void cp16_or_zero(uint32_t dst, const void* src,
                                             bool copy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(copy ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4_or_zero(uint32_t dst, const void* src,
                                            bool copy) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(copy ? 4 : 0)
               : "memory");
}

// Pass 1's ring by dtype: bf16 blocks of 256 threads, 2 an SM, 3 stages;
// float32 blocks of 128 threads, up to 4 an SM, 2 stages (its products
// take the SM longer, and more, smaller blocks keep more tiles in flight
// while they run).
template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;
template <typename T>
constexpr int kScoresThreads = kIsF32<T> ? 128 : 256;
template <typename T>
constexpr int kScoresStagesOf = kIsF32<T> ? 2 : 3;

// Bytes of a staged pass-1 row of `bytes` (a multiple of 16): bf16, an
// odd number of 16-byte pieces (ldmatrix's 8 rows meet no bank
// conflict); float32, 64 mod 128 bytes (the two rows whose float4 pieces
// a quarter warp reads meet none).
__host__ __device__ inline int scores_row(int bytes, int es) {
  return es == 2 ? odd16(bytes) : bytes + (192 - bytes % 128) % 128;
}

// Pass 1's stage: q [H][qrow] then K [TS][krow] (bytes).
__host__ __device__ inline int scores_stage_bytes(int H, int Hkv, int Dl,
                                                  int es, int TS) {
  return H * scores_row(Dl * es, es) + TS * scores_row(Hkv * Dl * es, es);
}

template <typename T>
__global__ void __launch_bounds__(kScoresThreads<T>, kIsF32<T> ? 4 : 2)
    scores_ring_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       float* __restrict__ s, Strides st, int B, int C,
                       int Hkv, int G, int Dl, int TS, float scale) {
  constexpr bool kF32 = kIsF32<T>;
  constexpr int kThreads = kScoresThreads<T>, kWarps = kThreads / 32;
  constexpr int S = kScoresStagesOf<T>;
  constexpr int kRows = kF32 ? 8 : 16;   // heads of a warp's row group
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = 16 / sizeof(T);
  const int H = Hkv * G, P = Dl / E;   // 16-byte pieces of a head's row
  const int qrow = scores_row(Dl * (int)sizeof(T), sizeof(T));
  const int krow = scores_row(Hkv * Dl * (int)sizeof(T), sizeof(T));
  const int stage_bytes = H * qrow + TS * krow;
  const int nt = (C + TS - 1) / TS, n_tiles = B * nt;
  const int n_my = (int)blockIdx.x < n_tiles
                       ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int tid = threadIdx.x;
  // K's 16-byte pieces: Hkv * P a slot; where that is at most the block's
  // threads, thread tid always copies piece col_k of slots row_k, row_k +
  // rows_k, ... (no division in the copy loop)
  const int per_slot = Hkv * P;
  const int rows_k = kThreads / max(per_slot, 1);
  const int row_k = tid / max(per_slot, 1);
  const int col_k = per_slot <= kThreads && row_k < rows_k
                        ? tid - row_k * per_slot
                        : (per_slot <= kThreads ? -2 : -1);
  const long long off_k =
      col_k >= 0 ? (col_k / P) * st.kh + (col_k % P) * E : 0;
  // warps over (KV head, kRows heads) pairs, wpp warps a pair
  const int NR = (G + kRows - 1) / kRows, KK = (Dl + 15) / 16;
  const int n_pairs = Hkv * NR;
  const int wpp = max(1, kWarps / n_pairs);
  const int pr0 = (tid >> 5) / wpp, jw = (tid >> 5) - pr0 * wpp;
  const int pr_step = kWarps / wpp;

  // q's pieces: thread tid copies piece q_pc of heads q_h, q_h + q_rows,
  // ... (P <= kThreads)
  const int q_rows = kThreads / P, q_h = tid / P, q_pc = tid - q_h * P;
  const long long q_off = q_h * st.qh + q_pc * E;
  // tile i's row and first slot, kept for its use S - 1 tiles later
  int tb[S], tc[S];

  // copy tile i of this block (its row's q and its K rows) into stage i % S
  auto issue = [&](int i) {
    tb[S - 1] = tc[S - 1] = 0;
    if (i < n_my) {
      const int t = blockIdx.x + i * gridDim.x, b = t / nt;
      const int c0 = (t - b * nt) * TS, n = min(TS, C - c0);
      tb[S - 1] = b;
      tc[S - 1] = c0;
      unsigned char* sq = smem + (i % S) * stage_bytes;
      unsigned char* sk = sq + H * qrow;
      if (q_h < q_rows) {
        const T* qb = q + b * st.qb + q_off;
        for (int h = q_h; h < H; h += q_rows)
          sm90::cp_async<16>(sq + h * qrow + q_pc * 16, qb + (h - q_h) * st.qh);
      }
      const T* kb = k + b * st.kb + c0 * st.kc;
      if (col_k >= 0) {              // a fixed piece of every rows_k-th slot
        for (int c = row_k; c < n; c += rows_k)
          sm90::cp_async<16>(sk + c * krow + col_k * 16,
                             kb + c * st.kc + off_k);
      } else if (col_k == -1) {      // more pieces a slot than threads
        for (int idx = tid; idx < n * per_slot; idx += kThreads) {
          const int c = idx / per_slot, r = idx - c * per_slot;
          const int hk = r / P, pc = r - hk * P;
          sm90::cp_async<16>(sk + c * krow + r * 16,
                             kb + c * st.kc + hk * st.kh + pc * E);
        }
      }
    }
    sm90::cp_async_commit();
  };

  auto compute = [&](int i) {
    const int b = tb[0], c0 = tc[0], n = min(TS, C - c0);
    const unsigned char* sq = smem + (i % S) * stage_bytes;
    const unsigned char* sk = sq + H * qrow;
    float* sb = s + (long long)b * H * C + c0;
    if constexpr (kF32) {
      // warp: (KV head, 8 heads) pairs, wpp warps a pair, each taking
      // every wpp-th 8 slots; S^T tile [heads x slots] = Q [heads x Dl]
      // K^T [Dl x slots] in 3xTF32, rows 8..15 the lo halves of rows 0..7
      const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
      const int NJ = (n + 7) / 8;
      const bool pairs = C % 2 == 0;       // float2 stores stay aligned
      constexpr int kQ16 = 4;              // q's k16 steps in registers
      for (int pr = pr0; pr < n_pairs; pr += pr_step) {
        const int hk = pr / NR, h = (pr - hk * NR) * kRows + g;
        const bool h_ok = h < G;           // row g holds a head
        const float* qr = reinterpret_cast<const float*>(
            sq + (hk * G + (h_ok ? h : 0)) * qrow);
        // dims 16 d16 + 4 t4 .. + 3 of a staged row, zeros past Dl
        auto dims4 = [&](const float* row, int d16, bool ok) {
          const int d = 16 * d16 + 4 * t4;
          return ok && d < Dl ? *reinterpret_cast<const float4*>(row + d)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        };
        // Q's A fragments of the k8 steps of dims 16 d16 + 4 t4 + 2 hh
        // (k t4) and + 1 (k t4 + 4): a0 / a2 hi(q) of head h, a1 / a3
        // lo(q) (zero past G)
        auto load_q = [&](int d16, uint32_t (&a)[2][4]) {
          const float4 x = dims4(qr, d16, h_ok);
          sm90::split_tf32_bits(x.x, a[0][0], a[0][1]);
          sm90::split_tf32_bits(x.y, a[0][2], a[0][3]);
          sm90::split_tf32_bits(x.z, a[1][0], a[1][1]);
          sm90::split_tf32_bits(x.w, a[1][2], a[1][3]);
        };
        uint32_t qa[kQ16][2][4];
#pragma unroll
        for (int d16 = 0; d16 < kQ16; ++d16)
          if (d16 < KK) load_q(d16, qa[d16]);
        for (int j = jw; j < NJ; j += wpp) {
          // K row of slot 8 j + g, KV head hk (a slot past n reads a
          // stale row: its column is never stored)
          const float* kr =
              reinterpret_cast<const float*>(sk + (j * 8 + g) * krow) +
              hk * Dl;
          // big: hi(k) (rows 0..7 hi(q) hi(k), 8..15 lo(q) hi(k)); small:
          // lo(k) (rows 0..7 hi(q) lo(k)); each run of <= 64 dims summed
          // from zero, then into hh / lh / hl in fp32
          float big[4], small[4], hh[2] = {}, lh[2] = {}, hl[2] = {};
          auto step = [&](int d16, const uint32_t (&a)[2][4]) {
            const float4 x = dims4(kr, d16, true);
            uint32_t bh[4], bl[4];
            sm90::split_tf32_bits(x.x, bh[0], bl[0]);
            sm90::split_tf32_bits(x.y, bh[1], bl[1]);
            sm90::split_tf32_bits(x.z, bh[2], bl[2]);
            sm90::split_tf32_bits(x.w, bh[3], bl[3]);
#pragma unroll
            for (int hh2 = 0; hh2 < 2; ++hh2) {
              sm90::mma_m16n8k8_tf32(small, a[hh2], bl[2 * hh2],
                                     bl[2 * hh2 + 1]);
              sm90::mma_m16n8k8_tf32(big, a[hh2], bh[2 * hh2],
                                     bh[2 * hh2 + 1]);
            }
          };
          auto start = [&]() {
#pragma unroll
            for (int e = 0; e < 4; ++e) big[e] = small[e] = 0.f;
          };
          auto fold = [&]() {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              hh[e] += big[e];
              lh[e] += big[2 + e];
              hl[e] += small[e];
            }
          };
          start();
#pragma unroll
          for (int d16 = 0; d16 < kQ16; ++d16)
            if (d16 < KK) step(d16, qa[d16]);
          fold();
          for (int r16 = kQ16; r16 < KK; r16 += kQ16) {
            start();
            for (int d16 = r16; d16 < min(r16 + kQ16, KK); ++d16) {
              uint32_t a[2][4];
              load_q(d16, a);
              step(d16, a);
            }
            fold();
          }
          // head h's scores of slots 8 j + 2 t4 and + 1: the large
          // product, then the two small ones
          const int c = j * 8 + 2 * t4;
          if (h_ok && c < n) {
            const float x0 = (hh[0] + (lh[0] + hl[0])) * scale;
            const float x1 = (hh[1] + (lh[1] + hl[1])) * scale;
            float* dst = sb + (long long)(hk * G + h) * C + c;
            if (pairs && c + 1 < n) {
              *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
            } else {
              dst[0] = x0;
              if (c + 1 < n) dst[1] = x1;
            }
          }
        }
      }
    } else {
      // warp: (KV head, 16 heads) pairs, wpp warps a pair, each taking
      // every wpp-th 16 slots; S^T tile [heads x slots] = Q [heads x Dl]
      // K^T [Dl x slots], Q's fragments loaded once a pair (the first
      // kQregs k16 steps) and K's through ldmatrix
      const int lane = tid & 31;
      const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, r8 = lane & 7;
      const int NJ = (n + 15) / 16;
      const bool quads = C % 4 == 0;       // float4 stores stay aligned
      for (int pr = pr0; pr < n_pairs; pr += pr_step) {
        const int hk = pr / NR, rg = pr - hk * NR;
        const bool lo_ok = rg * 16 + g < G, hi_ok = rg * 16 + g + 8 < G;
        const bool two = rg * 16 + 8 < G;  // rows 8..15 hold heads (uniform)
        // rows past G (or H) read a valid row, then count as zero
        const int arow = min(hk * G + rg * 16 + r8 + 8 * (mi & 1), H - 1);
        auto load_a = [&](int kk, uint32_t (&a)[4]) {
          const bool hi = 16 * kk + 8 < Dl;
          sm90::ldmatrix_x4(
              a, sq + arow * qrow + (16 * kk + (hi ? 8 * (mi >> 1) : 0)) * 2,
              false);
          if (!lo_ok) a[0] = a[2] = 0u;
          if (!hi_ok) a[1] = a[3] = 0u;
          if (!hi) a[2] = a[3] = 0u;
        };
        uint32_t aq[kQregs][4];
#pragma unroll
        for (int kk = 0; kk < kQregs; ++kk)
          if (kk < KK) load_a(kk, aq[kk]);
        for (int j = jw; j < NJ; j += wpp) {
          const unsigned char* kr =
              sk + (j * 16 + r8 + 8 * (mi >> 1)) * krow + hk * Dl * 2;
          float acc[2][4];
#pragma unroll
          for (int nt2 = 0; nt2 < 2; ++nt2)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt2][e] = 0.f;
          auto step = [&](int kk, const uint32_t (&a)[4]) {
            const bool hi = 16 * kk + 8 < Dl;  // a whole k16 step (else k8)
            uint32_t bk[4];
            sm90::ldmatrix_x4(
                bk, kr + (16 * kk + (hi ? 8 * (mi & 1) : 0)) * 2, false);
            if (!hi) bk[1] = bk[3] = 0u;
            sm90::mma_m16n8k16(acc[0], a, bk[0], bk[1]);
            sm90::mma_m16n8k16(acc[1], a, bk[2], bk[3]);
          };
#pragma unroll
          for (int kk = 0; kk < kQregs; ++kk)
            if (kk < KK) step(kk, aq[kk]);
          for (int kk = kQregs; kk < KK; ++kk) {
            uint32_t a[4];
            load_a(kk, a);
            step(kk, a);
          }
          // lanes t4 and t4 ^ 1 swap a pair, so the even one stores slots
          // 2 t4 .. 2 t4 + 3 of n8 tile 0 and the odd one slots 8 + 2 (t4 -
          // 1) .. of tile 1: one 16-byte store a lane and head
          const bool odd = t4 & 1;
          const int c = j * 16 + (odd ? 8 + 2 * (t4 - 1) : 2 * t4);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (half == 1 && !two) break;
            const float a0 = acc[0][2 * half] * scale;
            const float a1 = acc[0][2 * half + 1] * scale;
            const float b0 = acc[1][2 * half] * scale;
            const float b1 = acc[1][2 * half + 1] * scale;
            const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
            const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
            const float4 q4 = odd ? make_float4(x0, x1, b0, b1)
                                  : make_float4(a0, a1, x0, x1);
            const int hh = rg * 16 + g + 8 * half;
            if (hh >= G) continue;
            float* dst = sb + (long long)(hk * G + hh) * C + c;
            if (quads && c + 3 < n) {
              *reinterpret_cast<float4*>(dst) = q4;
            } else {
              const float x[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (c + e < n) dst[e] = x[e];
            }
          }
        }
      }
    }
  };

  // tb / tc shift down a place per issue: after issue(i + S - 1), entry 0
  // holds tile i
  auto shift = [&]() {
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {
      tb[j] = tb[j + 1];
      tc[j] = tc[j + 1];
    }
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    issue(i);
    shift();
  }
  for (int i = 0; i < n_my; ++i) {
    sm90::cp_async_wait<S - 2>();    // tile i's copies (this thread's) landed
    __syncthreads();                 // ... everyone's; tile i - 1 is used
    issue(i + S - 1);                // into tile i - 1's stage
    compute(i);
    shift();
  }
  sm90::cp_async_wait<0>();
}

// Pass 2's shared memory: each of the kPvWarps warps' ring of kPvStages
// stages of [GR][TW + 8] f32 scores and [TW][vrow] V; at the end the
// warps' partials [kPvWarps][16][DW] + (m, l) reuse it.
__host__ __device__ inline int pv_stage_bytes(int G, int Dl, int es,
                                              int TW) {
  const int GR = G < kUnitRows ? G : kUnitRows;
  const int DW = Dl < kUnitDims ? Dl : kUnitDims;
  return GR * (TW + 8) * 4 + TW * odd16(DW * es);
}

__host__ __device__ inline int pv_smem_bytes(int G, int Dl, int es,
                                             int TW) {
  const int DW = Dl < kUnitDims ? Dl : kUnitDims;
  const int ring = kPvWarps * kPvStages * pv_stage_bytes(G, Dl, es, TW);
  const int merge = kPvWarps * kUnitRows * (DW + 2) * 4;
  return ring > merge ? ring : merge;
}

// A block serves one unit (KV head, group of <= 16 heads, chunk of <= 64
// dims) of one split of row b: blockIdx.y = (hk * NG + hg) * ND + dc.
// NW: the accumulator's n8 tiles (8: 64 dims; 2: 16).  kWide: units may
// hold 9..16 heads (float32 is instantiated without it for G <= 8, so
// rows 8..15 are lo(p) at compile time and their registers are free).
template <typename T, int NW, bool kWide>
__global__ void __launch_bounds__(kPvThreads, 4) softmax_pv_ring_kernel(
    const float* __restrict__ s, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    T* __restrict__ o, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ counters, long long vb_,
    long long vc_, long long vh_, int C, int Hkv, int G, int Dl, int TW,
    int n_split, int window) {
  constexpr int S = kPvStages;
  constexpr int E = 16 / sizeof(T);
  constexpr bool kF32 = kIsF32<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int b = blockIdx.z, split = blockIdx.x;
  const int H = Hkv * G, NG = (G + 15) / 16, ND = (Dl + 63) / 64;
  const int GR = min(G, kUnitRows), DW = min(Dl, kUnitDims);
  // the block's unit
  const int hg = (blockIdx.y / ND) % NG, dc = blockIdx.y % ND;
  const int hk = blockIdx.y / (NG * ND);
  const int h0 = hk * G + hg * kUnitRows, d0 = dc * kUnitDims;
  const int Gu = min(kUnitRows, G - hg * kUnitRows);
  const int Dc = min(kUnitDims, Dl - d0), nN = Dc / 8;
  const int srow = TW + 8;                         // floats a score row
  const int vrow = odd16(DW * (int)sizeof(T));     // bytes a V row
  const int sc_bytes = GR * srow * 4;
  const int stage_bytes = sc_bytes + TW * vrow;
  unsigned char* ring = smem + warp * S * stage_bytes;

  // this warp's tiles of TW slots: every kPvWarps-th of the split's
  const int n_tiles = (C + TW - 1) / TW;
  const int t_lo = (int)((long long)split * n_tiles / n_split) + warp;
  const int t_hi = (int)((long long)(split + 1) * n_tiles / n_split);
  const int n_my = t_lo < t_hi ? (t_hi - t_lo + kPvWarps - 1) / kPvWarps : 0;
  const int qp = q_pos[b];
  const int* kpb = k_pos + (long long)b * C;
  const bool vec_s = C % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  auto attended = [&](int kp) {
    return kp >= 0 && kp <= qp && (window < 0 || kp > qp - window);
  };
  // lane l's slot of this warp's u-th tile
  auto pos = [&](int u) {
    const int c = (t_lo + kPvWarps * u) * TW + lane;
    return u < n_my && lane < TW && c < C ? __ldg(kpb + c) : kEmptyPos;
  };
  // fixed copy columns, set up once: lane copies V piece col_v of slots
  // row_v, row_v + rows_v, ... and score piece col_s of rows row_s, row_s
  // + rows_s, ... of every tile, stepping its pointers
  const int PW = Dc / E;                           // V pieces a slot
  const int rows_v = 32 / PW, row_v = lane / PW, col_v = lane - row_v * PW;
  const int n_v =
      row_v < rows_v && row_v < TW ? (TW - 1 - row_v) / rows_v + 1 : 0;
  const int per = vec_s ? TW / 4 : TW;             // score pieces a row
  const int rows_s = 32 / per, row_s = lane / per, col_s = lane - row_s * per;
  const int n_s = row_s < Gu ? (Gu - 1 - row_s) / rows_s + 1 : 0;
  const int first_s = vec_s ? 4 * col_s : col_s;   // its first slot in a row
  const unsigned bits_s = vec_s ? 0xfu << first_s : 1u << first_s;
  const float* s_lane = s + ((long long)b * H + h0 + row_s) * C + first_s;
  const long long s_step = (long long)rows_s * C;
  const T* v_lane =
      v + b * vb_ + row_v * vc_ + hk * vh_ + d0 + col_v * E;
  const long long v_step = rows_v * vc_;
  const uint32_t ring_u32 = sm90::smem_u32(ring);
  const uint32_t dst_s = ring_u32 + (row_s * srow + first_s) * 4;
  const uint32_t dst_v = ring_u32 + sc_bytes + row_v * vrow + col_v * 16;

  // copy the attended slots of this warp's u-th tile into stage u % S
  // (V rows of the others are zero-filled; scores go by 4-slot pieces);
  // returns the tile's attended mask (bit l: slot l)
  auto issue = [&](int u, int kp) {
    const unsigned mask = __ballot_sync(0xffffffffu, attended(kp));
    if (mask) {
      const int c0 = (t_lo + kPvWarps * u) * TW;
      const uint32_t st = (u % S) * stage_bytes;
      const bool cp = mask & bits_s;
      const float* ss = s_lane + c0;
      uint32_t ds = dst_s + st;
      for (int k = 0; k < n_s; ++k, ss += s_step, ds += rows_s * srow * 4) {
        if (vec_s)
          cp16_or_zero(ds, cp ? ss : s, cp);
        else
          cp4_or_zero(ds, cp ? ss : s, cp);
      }
      const T* vv = v_lane + c0 * vc_;
      uint32_t dv = dst_v + st;
      for (int k = 0, c = row_v; k < n_v;
           ++k, c += rows_v, vv += v_step, dv += rows_v * vrow) {
        const bool cv = (mask >> c) & 1u;
        cp16_or_zero(dv, cv ? vv : v, cv);
      }
    }
    sm90::cp_async_commit();
    return mask;
  };

  // the online softmax of heads g and g + 8 (lane-held m; l over this
  // lane's slots) and acc in the mma C layout [n8][4] (f32: column g of
  // n8 tiles 2 m and 2 m + 1 is dims 16 m + 2 g and + 1; with <= 8 heads
  // only rows 0..7, acc[.][0..1], hold O)
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NW][4];
#pragma unroll
  for (int a = 0; a < NW; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
  const int KC = TW / 16;
  // rows g + 8 hold heads (uniform)
  const bool two = (!kF32 || kWide) && Gu > 8;

  // this lane's score rows g and g + 8 (a row past Gu reads a valid row
  // instead; its results are never merged) at its slot 2 t4, and its
  // ldmatrix row of V
  const int y_off0 = min(g, GR - 1) * srow + 2 * t4;
  const int y_off1 = min(g + 8, GR - 1) * srow + 2 * t4;
  const int v_off = (r8 + 8 * (mi & 1)) * vrow;
  auto compute = [&](int u, unsigned mask) {
    const unsigned char* st = ring + (u % S) * stage_bytes;
    const unsigned char* vs = st + sc_bytes;
    const float* sr0 = reinterpret_cast<const float*>(st) + y_off0;
    const float* sr1 = reinterpret_cast<const float*>(st) + y_off1;
    const unsigned ml = mask >> (2 * t4);
    // the raw score of (row, slot 16 kc + 2 t4 + {0, 1, 8, 9}), kNegInf
    // where not attended
    auto y = [&](const float* sr, int kc, int e) {
      const int c = 16 * kc + (e & 1) + 8 * (e >> 1);
      return (ml >> c) & 1u ? sr[c] : kNegInf;
    };
    float y0[kMaxKC][4];
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int kc = 0; kc < kMaxKC; ++kc) {
      if (kc < KC) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y0[kc][e] = y(sr0, kc, e);
          mx0 = fmaxf(mx0, y0[kc][e]);
          if (two) mx1 = fmaxf(mx1, y(sr1, kc, e));
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    if (two) {
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    }
    // m0 / m1 stay in score units; log2(e) goes into each exponent's fma
    const float cr0 = fast_exp2((m0 - mx0) * kLog2e);
    const float cr1 = fast_exp2((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    const float nm0 = -mx0 * kLog2e, nm1 = -mx1 * kLog2e;
    l0 *= cr0;
    l1 *= cr1;
    // f32: the tile's P V, summed from zero (pv) and folded into acc with
    // the correction at the end; bf16: acc rescaled here
    float pv[kF32 ? NW : 1][4] = {};
    if constexpr (!kF32) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        acc[j][0] *= cr0;
        acc[j][1] *= cr0;
        if (two) {
          acc[j][2] *= cr1;
          acc[j][3] *= cr1;
        }
      }
    }
    // p = exp(score - m); a masked slot gives exactly 0 (never
    // exp2(kNegInf - kNegInf))
    auto prob = [&](float yv, float nm) {
      return yv != kNegInf ? fast_exp2(fmaf(yv, kLog2e, nm)) : 0.f;
    };
#pragma unroll
    for (int kc = 0; kc < kMaxKC; ++kc) {
      if (kc >= KC) break;
      float p[2][4];                 // [row g / g + 8][slot 2t4 + {0,1,8,9}]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[0][e] = prob(y0[kc][e], nm0);
        l0 += p[0][e];
        p[1][e] = 0.f;
        if (two) {
          p[1][e] = prob(y(sr1, kc, e), nm1);
          l1 += p[1][e];
        }
      }
      if constexpr (kF32) {
        const int vr = vrow / 4;                     // floats a V row
        const float* vf = reinterpret_cast<const float*>(vs) + 16 * kc * vr;
#pragma unroll
        for (int s8 = 0; s8 < 2; ++s8) {
          // k8 step s8: k t4 is slot 16 kc + 8 s8 + 2 t4, k t4 + 4 the
          // next slot; A from p as it is (hi(p) / lo(p) of rows g, g + 8)
          uint32_t ah[4], al[4];
          sm90::split_tf32_bits(p[0][2 * s8], ah[0], al[0]);
          sm90::split_tf32_bits(p[1][2 * s8], ah[1], al[1]);
          sm90::split_tf32_bits(p[0][2 * s8 + 1], ah[2], al[2]);
          sm90::split_tf32_bits(p[1][2 * s8 + 1], ah[3], al[3]);
          if (!two) {                  // rows 8..15: lo(p) of heads 0..7
            ah[1] = al[0];
            ah[3] = al[2];
          }
          const float* v0 = vf + (8 * s8 + 2 * t4) * vr;
#pragma unroll
          for (int mm = 0; mm < NW / 2; ++mm) {
            if (16 * mm < Dc) {
              // B (k t4, n g) of n8 tiles 2 mm, 2 mm + 1: V at dims
              // 16 mm + 2 g, + 1 of the two slots (zeros past Dc)
              const bool in = 16 * mm + 2 * g < Dc;
              const float2 x0 =
                  in ? *reinterpret_cast<const float2*>(v0 + 16 * mm + 2 * g)
                     : make_float2(0.f, 0.f);
              const float2 x1 =
                  in ? *reinterpret_cast<const float2*>(v0 + vr + 16 * mm +
                                                        2 * g)
                     : make_float2(0.f, 0.f);
              uint32_t bh[2][2], bl[2][2];
              sm90::split_tf32_bits(x0.x, bh[0][0], bl[0][0]);
              sm90::split_tf32_bits(x1.x, bh[0][1], bl[0][1]);
              sm90::split_tf32_bits(x0.y, bh[1][0], bl[1][0]);
              sm90::split_tf32_bits(x1.y, bh[1][1], bl[1][1]);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                if (two) {
                  sm90::mma_m16n8k8_tf32x3(pv[2 * mm + i], ah, al, bh[i],
                                           bl[i]);
                } else {
                  sm90::mma_m16n8k8_tf32(pv[2 * mm + i], ah, bl[i][0],
                                         bl[i][1]);
                  sm90::mma_m16n8k8_tf32(pv[2 * mm + i], ah, bh[i][0],
                                         bh[i][1]);
                }
              }
            }
          }
        }
      } else {
        const uint32_t a[4] = {sm90::pack_bf16(p[0][0], p[0][1]),
                               two ? sm90::pack_bf16(p[1][0], p[1][1]) : 0u,
                               sm90::pack_bf16(p[0][2], p[0][3]),
                               two ? sm90::pack_bf16(p[1][2], p[1][3]) : 0u};
        const unsigned char* vr = vs + 16 * kc * vrow + v_off;
#pragma unroll
        for (int j = 0; j < NW; j += 2) {
          if (j < nN) {
            uint32_t bv[4];
            sm90::ldmatrix_x4(
                bv, vr + (8 * j + (j + 1 < nN ? 8 * (mi >> 1) : 0)) * 2,
                true);
            sm90::mma_m16n8k16(acc[j], a, bv[0], bv[1]);
            if (j + 1 < NW && j + 1 < nN)
              sm90::mma_m16n8k16(acc[j + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
    if constexpr (kF32) {
      // rows 8..15 of pv hold lo(p) V (<= 8 heads) or heads g + 8
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        if (two) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] = fmaf(acc[j][e], e < 2 ? cr0 : cr1, pv[j][e]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[j][e] = fmaf(acc[j][e], cr0, pv[j][e] + pv[j][2 + e]);
        }
      }
    }
  };

  // the ring, as split_decode.cuh's decode_block_mma, each warp on its
  // own: a tile's positions are loaded kPvAhead tiles ahead of its copies,
  // its copies S - 1 tiles ahead of its use
  unsigned ok[S];
  int kq[kPvAhead];                  // positions of tiles u + S - 1 + j
  {
    int kp[S - 1];
#pragma unroll
    for (int i = 0; i < S - 1; ++i) kp[i] = pos(i);
#pragma unroll
    for (int j = 0; j < kPvAhead; ++j) kq[j] = pos(S - 1 + j);
#pragma unroll
    for (int i = 0; i < S - 1; ++i) ok[i] = issue(i, kp[i]);
  }
  for (int u = 0; u < n_my; ++u) {
    __syncwarp();                    // stage (u - 1) % S is read: refill it
    ok[S - 1] = issue(u + S - 1, kq[0]);
#pragma unroll
    for (int j = 0; j < kPvAhead - 1; ++j) kq[j] = kq[j + 1];
    kq[kPvAhead - 1] = pos(u + S - 1 + kPvAhead);
    sm90::cp_async_wait<S - 1>();
    __syncwarp();                    // the warp's copies of tile u landed
    const unsigned mask = ok[0];
#pragma unroll
    for (int i = 0; i < S - 1; ++i) ok[i] = ok[i + 1];
    if (mask) compute(u, mask);
  }
  sm90::cp_async_wait<0>();
  __syncthreads();                   // the rings are free: merge the warps

  float* a_s = reinterpret_cast<float*>(smem);     // [warp][16][DW]
  float* m_s = a_s + kPvWarps * kUnitRows * DW;    // [warp][16]
  float* l_s = m_s + kPvWarps * kUnitRows;         // [warp][16]
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  {
    float* aw = a_s + warp * kUnitRows * DW;
    if constexpr (kF32) {
      // a lane's O: dims 16 mm + 4 t4 .. + 3 of heads g (and g + 8)
#pragma unroll
      for (int mm = 0; mm < NW / 2; ++mm) {
        const int d = 16 * mm + 4 * t4;
        if (d < Dc) {
          *reinterpret_cast<float4*>(aw + g * DW + d) =
              make_float4(acc[2 * mm][0], acc[2 * mm + 1][0], acc[2 * mm][1],
                          acc[2 * mm + 1][1]);
          if (two)
            *reinterpret_cast<float4*>(aw + (g + 8) * DW + d) =
                make_float4(acc[2 * mm][2], acc[2 * mm + 1][2],
                            acc[2 * mm][3], acc[2 * mm + 1][3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int d = 8 * j + 2 * t4;
        if (d < Dc) {
          aw[g * DW + d] = acc[j][0];
          aw[g * DW + d + 1] = acc[j][1];
          aw[(g + 8) * DW + d] = acc[j][2];
          aw[(g + 8) * DW + d + 1] = acc[j][3];
        }
      }
    }
    if (t4 == 0) {                   // m in log2 units from here on
      m_s[warp * kUnitRows + g] = m0 * kLog2e;
      l_s[warp * kUnitRows + g] = l0;
      m_s[warp * kUnitRows + g + 8] = m1 * kLog2e;
      l_s[warp * kUnitRows + g + 8] = l1;
    }
  }
  __syncthreads();

  // the warps -> this split's partial (or o); element (r, d)
  const long long blk = (long long)b * gridDim.y + blockIdx.y;
  const int per_unit = kUnitRows * kUnitDims;
  float* pa = part_acc + blk * n_split * per_unit;
  float* pm = part_ml + blk * n_split * kUnitRows * 2;
  T* ob = o + ((long long)b * H + h0) * Dl + d0;
  for (int idx = tid; idx < Gu * Dc; idx += kPvThreads) {
    const int r = idx / Dc, d = idx - r * Dc;
    float mx = kNegInf;
    for (int w = 0; w < kPvWarps; ++w)
      mx = fmaxf(mx, m_s[w * kUnitRows + r]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kPvWarps; ++w) {
      const float wt = exp2f(m_s[w * kUnitRows + r] - mx);
      L = fmaf(l_s[w * kUnitRows + r], wt, L);
      A = fmaf(a_s[(w * kUnitRows + r) * DW + d], wt, A);
    }
    if (n_split == 1) {
      ob[(long long)r * Dl + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
    } else {
      pa[split * per_unit + r * kUnitDims + d] = A;
      if (d == 0) {
        pm[(split * kUnitRows + r) * 2] = mx;
        pm[(split * kUnitRows + r) * 2 + 1] = L;
      }
    }
  }
  if (n_split == 1) return;

  // the last split of this (b, unit) to finish merges all of them
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + blk, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = tid; idx < Gu * Dc; idx += kPvThreads) {
    const int r = idx / Dc, d = idx - r * Dc;
    float mx = kNegInf;
    for (int sp = 0; sp < n_split; ++sp)
      mx = fmaxf(mx, __ldcg(pm + (sp * kUnitRows + r) * 2));
    float L = 0.f, A = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {   // every split's partial
      const float wt = exp2f(__ldcg(pm + (sp * kUnitRows + r) * 2) - mx);
      L = fmaf(__ldcg(pm + (sp * kUnitRows + r) * 2 + 1), wt, L);
      A = fmaf(__ldcg(pa + sp * per_unit + r * kUnitDims + d), wt, A);
    }
    ob[(long long)r * Dl + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
  if (tid == 0) counters[blk] = 0;   // ready for the next launch
}

// The ring bodies' preconditions: 16-byte copies of every row piece.
template <typename T>
bool ring_fits(const void* p, int Dl,
               std::initializer_list<long long> strides) {
  constexpr int E = 16 / sizeof(T);
  if (!aligned16(p) || Dl % E) return false;
  for (long long st : strides)
    if (st % E) return false;
  return true;
}

template <typename T>
cudaError_t launch_scores_ring(const void* q, const void* k, void* s,
                               const Strides& st, int B, int C, int Hkv,
                               int G, int Dl, int TS, int blocks, float scale,
                               cudaStream_t stream) {
  if (!ring_fits<T>(q, Dl, {st.qb, st.qh}) ||
      !ring_fits<T>(k, Dl, {st.kb, st.kc, st.kh}) || TS < 16 || TS % 16 ||
      blocks < 1)
    return cudaErrorInvalidValue;
  const long long smem = (long long)kScoresStagesOf<T> *
                         scores_stage_bytes(Hkv * G, Hkv, Dl, sizeof(T), TS);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(scores_ring_kernel<T>, (size_t)smem);
  if (err != cudaSuccess) return err;
  scores_ring_kernel<T><<<blocks, kScoresThreads<T>, (size_t)smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<float*>(s), st, B, C, Hkv, G, Dl, TS, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_softmax_pv_ring(
    const void* s, const void* v, const void* q_pos, const void* k_pos,
    void* o, void* part_acc, void* part_ml, void* counters, long long vb,
    long long vc, long long vh, int B, int C, int Hkv, int G, int Dl, int TW,
    int n_split, int window, cudaStream_t stream) {
  const int gy = Hkv * ((G + 15) / 16) * ((Dl + 63) / 64);
  if (!ring_fits<T>(v, Dl, {vb, vc, vh}) || (TW != 16 && TW != 32) ||
      gy > 65535 || n_split > (C + TW - 1) / TW)
    return cudaErrorInvalidValue;
  const int smem = pv_smem_bytes(G, Dl, sizeof(T), TW);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid(n_split, gy, B);
  auto run = [&](auto kernel) {
    cudaError_t err = allow_smem(kernel, (size_t)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kPvThreads, (size_t)smem, stream>>>(
        static_cast<const float*>(s), static_cast<const T*>(v),
        static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
        static_cast<T*>(o), static_cast<float*>(part_acc),
        static_cast<float*>(part_ml), static_cast<int*>(counters), vb, vc,
        vh, C, Hkv, G, Dl, TW, n_split, window);
    return cudaGetLastError();
  };
  // the accumulator: 8 n8 tiles (64 dims), or 2 for <= 16 dims
  if constexpr (kIsF32<T>) {
    if (G <= 8)
      return run(Dl > 16 ? softmax_pv_ring_kernel<T, 8, false>
                         : softmax_pv_ring_kernel<T, 2, false>);
  }
  return run(Dl > 16 ? softmax_pv_ring_kernel<T, 8, true>
                     : softmax_pv_ring_kernel<T, 2, true>);
}

bool bad_sizes(int B, int C, int Hkv, int G, int Dl) {
  return B < 1 || C < 1 || Hkv < 1 || G < 1 || Dl < 1 || B > 65535;
}

// The simt passes' head groups: NG groups of Gc = ceil(G / NG) heads, as
// the caller chose them (ops.py::_head_groups(G, "core"), which also sizes
// pass 2's merge scratch), a partition the CUDA-core body serves (Gc <=
// kMaxG, no group empty), with the grid's y of Hkv * NG * ND in range.
bool bad_groups(int Hkv, int G, int NG, int ND) {
  return !sd::groups_served(G, NG, sd::kBodyCore) ||
         (long long)Hkv * NG * ND > 65535;
}

}  // namespace

// q [B, Hkv*G, Dl] at strides (q_sb, q_sh, 1), k [B, C, Hkv, Dl] at strides
// (k_sb, k_sc, k_sh, 1), both of one dtype (0 = float32, 1 = bfloat16);
// s float32 [B, Hkv*G, C], contiguous.  NG: the head groups, Gc =
// ceil(G / NG) heads each (ops.py::_head_groups(G, "core")); a partition
// the CUDA-core body cannot serve is refused.  Returns cudaGetLastError()
// of the launch.
extern "C" int decode_scores(const void* q, const void* k, void* s,
                             long long q_sb, long long q_sh, long long k_sb,
                             long long k_sc, long long k_sh, int B, int C,
                             int Hkv, int G, int Dl, int NG, float scale,
                             int dtype, int device, void* stream) {
  if (bad_sizes(B, C, Hkv, G, Dl) || bad_groups(Hkv, G, NG, 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides st{q_sb, q_sh, k_sb, k_sc, k_sh};
  auto cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scores<float>(q, k, s, st, B, C, Hkv, G, NG, Dl, scale,
                                cs);
  if (dtype == 1)
    return launch_scores<__nv_bfloat16>(q, k, s, st, B, C, Hkv, G, NG, Dl,
                                        scale, cs);
  return cudaErrorInvalidValue;
}

// s float32 [B, Hkv*G, C] (the scores summed over the ranks), v
// [B, C, Hkv, Dl] at strides (v_sb, v_sc, v_sh, 1), q_pos [B] and k_pos
// [B, C] int32, o [B, Hkv*G, Dl] in v's dtype (0 = float32, 1 = bfloat16);
// s, q_pos, k_pos and o contiguous.  window < 0 means no window.  NG as
// decode_scores'.  With
// n_split > 1, over NG head groups (bad_groups) of Gc = ceil(G / NG) heads
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
                                 int window, int NG, int dtype, int device,
                                 void* stream) {
  const int ND = (Dl + kChunk - 1) / kChunk;
  const int n_tiles = (C + kPvTile - 1) / kPvTile;
  if (bad_sizes(B, C, Hkv, G, Dl) || bad_groups(Hkv, G, NG, ND) ||
      n_split < 1 || n_split > n_tiles ||
      (n_split > 1 && (!part_acc || !part_ml || !counters)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_softmax_pv<float>(s, v, q_pos, k_pos, o, part_acc, part_ml,
                                    counters, v_sb, v_sc, v_sh, B, C, Hkv, G,
                                    NG, Dl, n_split, window, cs);
  if (dtype == 1)
    return launch_softmax_pv<__nv_bfloat16>(
        s, v, q_pos, k_pos, o, part_acc, part_ml, counters, v_sb, v_sc, v_sh,
        B, C, Hkv, G, NG, Dl, n_split, window, cs);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* decode_softmax_pv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The ring bodies (see the header), which cut the heads into units of
// their own.  decode_scores_ring: the arguments of decode_scores with
// tile (TS slots, a multiple of 16) and blocks (the persistent grid) in
// NG's place.
// decode_softmax_pv_ring: those of decode_softmax_pv with tile (TW, 16 or
// 32 slots a warp's tile) in NG's place; with
// n_split > 1, over gy = Hkv * ceil(G / 16) * ceil(Dl / 64) units (a block
// each) a row: part_acc float32 [B, gy, n_split, 16, 64], part_ml float32
// [B, gy, n_split, 16, 2] and counters int32 [B * gy], all 0
// before the first launch (each launch leaves them 0).  Both need q / k /
// v 16-byte aligned, Dl * sizeof(T) and every stride's bytes multiples of
// 16; they return cudaErrorInvalidValue otherwise.
extern "C" int decode_scores_ring(const void* q, const void* k, void* s,
                                  long long q_sb, long long q_sh,
                                  long long k_sb, long long k_sc,
                                  long long k_sh, int B, int C, int Hkv,
                                  int G, int Dl, int tile, int blocks,
                                  float scale, int dtype, int device,
                                  void* stream) {
  if (bad_sizes(B, C, Hkv, G, Dl)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides st{q_sb, q_sh, k_sb, k_sc, k_sh};
  auto cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scores_ring<float>(q, k, s, st, B, C, Hkv, G, Dl, tile,
                                     blocks, scale, cs);
  if (dtype == 1)
    return launch_scores_ring<__nv_bfloat16>(q, k, s, st, B, C, Hkv, G, Dl,
                                             tile, blocks, scale, cs);
  return cudaErrorInvalidValue;
}

extern "C" int decode_softmax_pv_ring(
    const void* s, const void* v, const void* q_pos, const void* k_pos,
    void* o, void* part_acc, void* part_ml, void* counters, long long v_sb,
    long long v_sc, long long v_sh, int B, int C, int Hkv, int G, int Dl,
    int n_split, int window, int tile, int dtype, int device,
    void* stream) {
  if (bad_sizes(B, C, Hkv, G, Dl) || n_split < 1 ||
      (n_split > 1 && (!part_acc || !part_ml || !counters)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_softmax_pv_ring<float>(
        s, v, q_pos, k_pos, o, part_acc, part_ml, counters, v_sb, v_sc, v_sh,
        B, C, Hkv, G, Dl, tile, n_split, window, cs);
  if (dtype == 1)
    return launch_softmax_pv_ring<__nv_bfloat16>(
        s, v, q_pos, k_pos, o, part_acc, part_ml, counters, v_sb, v_sc, v_sh,
        B, C, Hkv, G, Dl, tile, n_split, window, cs);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_scores_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* decode_softmax_pv_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
