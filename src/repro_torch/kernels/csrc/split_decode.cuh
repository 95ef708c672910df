// Split-cache one-token decode for Hopper: the kernels that a decode over
// any cache layout launches (flash_decode.cu, dense; paged_flash_decode.cu,
// the paged pool), and their launch and dispatch.
//
// A launch has grid (n_split, Hkv * NG, B).  Block (s, hk * NG + hg, b)
// takes a contiguous run of whole tiles of kTile slots of row b's run of
// slots (split s of n_split; splits differ by at most one tile) and serves
// head group hg of KV head hk's G query heads: NG groups of Gc = ceil(G /
// NG) heads (the last may hold fewer).  The caller chooses NG by one rule
// (kernels/decode_attention/ops.py::_head_groups): NG = ceil(G / limit),
// the limit being at most the body's, kMmaMaxG = 16 heads on the bf16
// tensor-core body (the m16 tile's rows) and kMaxG = 8 on the float32 one
// and on the CUDA cores; the bf16 tensor-core body takes 16 where its
// one-group grid fills the SMs and 8 where it does not (a 16-row block
// walks a tile more slowly, and idle SMs make a second group's reread
// cheaper than that).  dispatch refuses
// a group the body cannot serve.  With one group every K/V tile of a (row,
// KV head, split) is read from HBM once for all G heads, as the TPU kernel
// reads a KV block once for its (1, 1, G, D) q block; with NG groups each
// group's blocks read it again (K/V bytes times NG).  The run is the row's
// whole cache for the dense layout and the slots the mask can reach for
// the paged one.  Three block bodies; the caller names the one it wants
// (Launch::body, chosen by kernels/decode_attention/ops.py::_decode_body),
// and dispatch refuses a tensor-core body where it cannot serve:
//
// decode_block_mma (bf16, D = 64, 80 or 128, 16-byte aligned K/V and
//   4-byte aligned q): each of the 4 warps takes every
//   4th tile of the split, copies it with 16-byte cp.async into its own
//   ring of kMmaStages shared-memory stages (slots that are not attended
//   are zero-filled, never read), and runs both products on the tensor
//   cores with mma.sync m16n8k16: S[16 x 16] = Q K^T with the group's
//   heads as rows and O[16 x D] += P V with P straight from S's
//   accumulator registers and V through ldmatrix.trans.  A group of up to
//   8 heads fills rows 0..7 (the A fragment's a1 = a3 = 0, rows 8..15 of
//   S and O are not read); a group of 9..16 (the kRows16 instance) puts
//   head g + 8 in rows 8..15 (a1 / a3), so each lane runs two online
//   softmax rows, heads g and g + 8, and P V uses all four registers of
//   P's fragment: the same mma count serves twice the heads.  A tile of
//   16 slots costs a warp 2 * D / 8 mma and D / 8 ldmatrix.x4, so the
//   body keeps up with HBM.  At D = 80 a staged row is 176 bytes, 11
//   pieces of 16 (an odd count, as 9 at D 64 and 17 at D 128), QK^T takes
//   5 k16 steps and P V 10 n8 tiles in pairs.
// decode_block_tf32x3 (float32, D = 64, 80 or 128, the same alignment):
//   decode_block_mma's walk with 8 warps, each on half tiles, every
//   product three TF32 mma.sync m16n8k8 of hi / lo splits (float32 is
//   held to 2e-5, which one TF32 product misses), groups of up to 8
//   heads: rows 8..15 of the m16 tile carry the A operand's lo halves, so
//   a k8 step costs two mma, not three.  A float32 row is twice a bf16
//   one, so a ring of 3 stages a warp holds one block an SM at D 80 and
//   128, two at D 64.
// decode_block (bf16 and float32 at other D, or unaligned): a row group
//   of W lanes (W a power of two, at most 32) owns one slot at a time;
//   lane ch holds the pieces ch, ch + W, ... (16 bytes each where D
//   allows, else 1 element) of the G query rows and of its accumulators,
//   and a score is W partial
//   dots reduced with xor shuffles.  Each thread copies with cp.async
//   exactly the pieces it will read, kCoreStages - 1 tiles ahead, so the
//   tile loop needs no barrier.  Its groups stay at 8 heads: a lane keeps
//   every head's query piece and float32 accumulators in registers, so
//   16 heads would double them, and it is not the speed path (head dims
//   or alignments the tensor cores do not take).
//
// In both, a slot's position (or whatever the layout reads first) is
// fetched a tile ahead of its copy, only attended slots are copied, and a
// tile with none is skipped.  Every warp or row group runs its own fp32
// online softmax (m, l, acc) with log2(e) folded into the scale; finish()
// merges them through shared memory.  With one split the block writes o.
// Otherwise it writes its fp32 partial (acc[G][D], m[G], l[G]) to scratch,
// and the last block of a (b, hk) to finish (a __threadfence, then an
// atomicAdd ticket on a counter that starts at 0) merges the n_split
// partials, writes o and resets the counter to 0 for the next launch.
// Whoever writes o also writes each head's log-sum-exp when asked (lse).
// The scratch and the ticket are per (b, hk, hg): part_acc
// [B, Hkv, NG, n_split, Gc, D], part_ml [B, Hkv, NG, n_split, Gc, 2],
// counters [B * Hkv * NG], so two head groups never share a ticket.  A
// split, warp or row group that attended nothing has m = -1e30 and l = 0
// and weighs exp2(-1e30 - M) = 0 in a merge (or 1 x l = 0 when nothing was
// attended at all), so it adds nothing and no NaN; a head with nothing
// attended writes 0.
//
// A layout supplies, for a slot of the row's run (0 .. C-1, C set per row
// by Rows::at): fetch(slot), a value read ahead of the copy (the slot's
// position for the dense cache, its page id for the paged pool; slots past
// the run's end must give one that is not attended, without reading past
// the row's own data), attended(slot, fetched), and offset(slot, fetched),
// the element offset of its K/V row of head hk.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace repro {
namespace split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;          // cache slots per tile
constexpr int kCoreStages = 4;     // decode_block: tiles staged per thread
constexpr int kMmaStages = 3;      // decode_block_mma: tiles staged per warp
constexpr int kTf32x3Warps = 8;    // decode_block_tf32x3: warps a block
constexpr int kTf32x3Stages = 3;   // decode_block_tf32x3: half tiles
                                   // staged per warp
constexpr int kHalfTile = kTile / 2;
constexpr int kMaxSlots = kTile / (kThreads / 32);  // per row group (W = 32)
constexpr int kMaxG = 8;           // heads of a group, CUDA-core body
constexpr int kMmaMaxG = 16;       // heads of a group, tensor-core body (the
                                   // m16 tile's rows)
constexpr int kMaxD = 256;
constexpr int kMmaPad = 16;        // bytes after each staged row (no bank
                                   // conflicts for ldmatrix)
constexpr float kLog2e = 1.4426950408889634f;

// Lanes per row: the pieces of a row, rounded up to a power of two, at
// most 32.
inline int lanes_per_row(int pieces) {
  int w = 1;
  while (w < pieces && w < 32) w *= 2;
  return w;
}

// Shared memory of the partials that finish() merges: RG owners.
inline size_t merge_bytes(int RG, int G, int D) {
  return sizeof(float) * (size_t)RG * G * (D + 2) + 16;
}

inline size_t core_smem_bytes(int elem, int G, int D, int W) {
  const size_t stages = (size_t)kCoreStages * 2 * kTile * D * elem;
  const size_t merge = merge_bytes(kThreads / W, G, D);
  return stages > merge ? stages : merge;
}

inline size_t mma_smem_bytes(int G, int D) {
  const size_t stages =
      (size_t)kWarps * kMmaStages * 2 * kTile * (D * 2 + kMmaPad);
  const size_t merge = merge_bytes(kWarps, G, D);
  return stages > merge ? stages : merge;
}

// ---------------------------------------------------------------- merge
// A head's log-sum-exp in natural log from its log2-domain (m, l): the
// scores are kept as scale * log2(e) * q.k, so ln sum exp = (m + log2 l)
// * ln 2; -1e30 for a head that attended nothing (l = 0).
__device__ __forceinline__ float log_sum_exp(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * 0.69314718055994531f : kNegInf;
}

// Merge RG partials (a_s [RG][G][D], m_s / l_s [RG][G], in shared memory,
// synced) into o (one split) or into this split's scratch, and let the last
// split of the (b, hk, hg) merge the splits.  Heads 0..Gw-1 (Gw <= G) are
// the block's; the rest pad the template's G and are never written.  All
// threads call it.  Thread g < Gw first turns head g's column of m_s into
// the owners' weights exp2(m_r - M) and leaves M and L = sum_r l_r w_r in
// l_s rows 1 and 0 (RG >= 2), so each element of o costs RG loads and
// FMAs, not RG exponentials.  kBlock: the block's threads.
template <typename T, int kBlock = kThreads>
__device__ __forceinline__ void finish(
    const float* a_s, float* m_s, float* l_s, int* last, int RG, int G,
    int Gw, int D, T* __restrict__ o_head, float* __restrict__ lse_head,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ counter, int split, int n_split) {
  const int tid = threadIdx.x;
  if (tid < Gw) {
    float mx = kNegInf;
    for (int r = 0; r < RG; ++r) mx = fmaxf(mx, m_s[r * G + tid]);
    float L = 0.f;
    for (int r = 0; r < RG; ++r) {
      const float w = exp2f(m_s[r * G + tid] - mx);
      m_s[r * G + tid] = w;
      L = fmaf(l_s[r * G + tid], w, L);
    }
    l_s[tid] = L;
    l_s[G + tid] = mx;
  }
  __syncthreads();
  for (int i = tid; i < Gw * D; i += kBlock) {
    const int g = i / D, d = i - g * D;
    float A = 0.f;
    for (int r = 0; r < RG; ++r)
      A = fmaf(a_s[((size_t)r * G + g) * D + d], m_s[r * G + g], A);
    const float L = l_s[g], mx = l_s[G + g];
    if (n_split == 1) {
      o_head[i] = from_f32<T>(A / fmaxf(L, 1e-30f));
      if (lse_head && d == 0) lse_head[g] = log_sum_exp(mx, L);
    } else {
      part_acc[(size_t)split * G * D + i] = A;
      if (d == 0) {
        part_ml[(split * G + g) * 2] = mx;
        part_ml[(split * G + g) * 2 + 1] = L;
      }
    }
  }
  if (n_split == 1) return;

  // the last split of this (b, hk) to finish merges all of them
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(counter, 1) == n_split - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = tid; i < Gw * D; i += kBlock) {
    const int g = i / D;
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, __ldcg(part_ml + (s * G + g) * 2));
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = exp2f(__ldcg(part_ml + (s * G + g) * 2) - mx);
      L = fmaf(__ldcg(part_ml + (s * G + g) * 2 + 1), w, L);
      A = fmaf(__ldcg(part_acc + (size_t)s * G * D + i), w, A);
    }
    o_head[i] = from_f32<T>(A / fmaxf(L, 1e-30f));
    if (lse_head && i - g * D == 0) lse_head[g] = log_sum_exp(mx, L);
  }
  if (tid == 0) *counter = 0;      // ready for the next launch
}

// This split's tiles [lo, hi).
__device__ __forceinline__ void split_tiles(int C, int split, int n_split,
                                            int& lo, int& hi) {
  const int n = (C + kTile - 1) / kTile;
  lo = (int)((long long)split * n / n_split);
  hi = (int)((long long)(split + 1) * n / n_split);
}

// ----------------------------------------------------- CUDA-core body
// Copy VEC elements of T (a piece) from global to shared memory.
template <typename T, int VEC>
__device__ __forceinline__ void copy_piece(T* dst, const T* src) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  if constexpr (kBytes >= 4) {
    sm90::cp_async<kBytes>(dst, src);
  } else {
    *dst = *src;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_piece(const T* src, float (&x)[VEC]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  } else if constexpr (std::is_same<T, float>::value && VEC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = to_f32(src[e]);
  }
}

// a ? x : y without a branch the compiler could turn into indexing
__device__ __forceinline__ float select(bool a, float x, float y) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.s32 p, %3, 0;\n selp.f32 %0, %1, %2, p;\n}"
      : "=f"(r)
      : "f"(x), "f"(y), "r"((int)a));
  return r;
}

// One step of the halving exchange over 2 O values: the lane with bit O
// set keeps (and sums with its partner's) the upper O, the other the lower.
template <int O>
__device__ __forceinline__ void exchange(float (&x)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = select(up, x[j], x[j + O]);
    const float keep = select(up, x[j + O], x[j]);
    x[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// q_head points at head 0 of the group ([Gw][D]), o_head likewise; heads
// Gw..G-1 pad the group (q = 0, never written).  part_acc [n_split][G][D]
// and part_ml [n_split][G][2] are this (b, hk, hg)'s scratch, counter its
// ticket.  VEC elements make a piece; a lane holds up
// to NC pieces of a row; W lanes share a row.  WIDE (W = 32, NC = 1: a
// warp per row group, 4 slots a tile) reduces the 4 x 8 partial dots of a
// tile (heads padded to 8) by halving exchanges, 31 shuffles where 4 G
// butterflies take 20 G, so lane l ends with slot l / 8, head l % 8.
template <typename T, int G, int VEC, int NC, bool WIDE, typename Layout>
__device__ __forceinline__ void decode_block(
    const Layout& lay, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ q_head, T* __restrict__ o_head,
    float* __restrict__ lse_head, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ counter, int C, int Gw,
    int D, int W, float scale_log2,
    int split, int n_split, unsigned char* smem) {
  constexpr int S = kCoreStages;
  const int tid = threadIdx.x, rg = tid / W, ch = tid % W;
  const int RG = kThreads / W;
  const int nsl = (kTile + RG - 1) / RG;     // slots per row group per tile
  const int pieces = (D + VEC - 1) / VEC;
  int t_lo, t_hi;
  split_tiles(C, split, n_split, t_lo, t_hi);

  float q[NC][G][VEC], acc[NC][G][VEC], m[G], l[G];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int pc = ch + W * j;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int d = pc * VEC + e;
        q[j][g][e] = pc < pieces && d < D && g < Gw
                         ? to_f32(q_head[(size_t)g * D + d]) * scale_log2
                         : 0.f;
        acc[j][g][e] = 0.f;
      }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  // stage of tile t, K (kv = 0) or V (1): [kTile][D]
  auto stage = [&](int t, int kv) {
    return reinterpret_cast<T*>(smem) +
           (size_t)(2 * ((t - t_lo) % S) + kv) * kTile * D;
  };
  // fetched values of this thread's slots, one tile ahead of the copies
  int fetched[kMaxSlots];
  auto fetch_tile = [&](int t) {
#pragma unroll
    for (int i = 0; i < kMaxSlots; ++i) {
      const int c = rg + RG * i;
      fetched[i] = (i < nsl && c < kTile && t < t_hi)
                       ? lay.fetch(t * kTile + c)
                       : kEmptyPos;
    }
  };
  // copy this thread's pieces of the attended slots of tile t; returns the
  // attended mask of its slots
  auto issue_tile = [&](int t) {
    unsigned ok = 0;
    if (t < t_hi) {
      T* ks = stage(t, 0);
      T* vs = stage(t, 1);
#pragma unroll
      for (int i = 0; i < kMaxSlots; ++i) {
        const int c = rg + RG * i;
        if (i < nsl && c < kTile && lay.attended(t * kTile + c, fetched[i])) {
          ok |= 1u << i;
          const long long off = lay.offset(t * kTile + c, fetched[i]);
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const int pc = ch + W * j;
            if (pc < pieces) {
              copy_piece<T, VEC>(ks + c * D + pc * VEC, k + off + pc * VEC);
              copy_piece<T, VEC>(vs + c * D + pc * VEC, v + off + pc * VEC);
            }
          }
        }
      }
    }
    sm90::cp_async_commit();
    return ok;
  };

  // ok[i]: attended mask of tile t + i (tiles t .. t + S - 2 in flight)
  unsigned ok[S];
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    fetch_tile(t_lo + i);
    ok[i] = issue_tile(t_lo + i);
  }
  fetch_tile(t_lo + S - 1);
  for (int t = t_lo; t < t_hi; ++t) {
    ok[S - 1] = issue_tile(t + S - 1);
    fetch_tile(t + S);
    sm90::cp_async_wait<S - 1>();  // tile t's copies (this thread's) landed
    const unsigned ok_t = ok[0];
#pragma unroll
    for (int i = 0; i < S - 1; ++i) ok[i] = ok[i + 1];
    if (!__any_sync(0xffffffffu, ok_t)) continue;
    const T* ks = stage(t, 0);
    const T* vs = stage(t, 1);
    if constexpr (WIDE) {
      static_assert(NC == 1 && kMaxSlots == 4, "one piece, 4 slots a lane");
      float x[32];                 // x[8 i + g]: slot i, head g
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float kx[VEC];
        load_piece<T, VEC>(ks + (rg + 4 * i) * D + ch * VEC, kx);
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          x[8 * i + g] = 0.f;
          if (g < G) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              x[8 * i + g] = fmaf(q[0][g][e], kx[e], x[8 * i + g]);
          }
        }
      }
      // halving exchange: lanes with bit o keep the upper half
      exchange<16>(x, ch);
      exchange<8>(x, ch);
      exchange<4>(x, ch);
      exchange<2>(x, ch);
      exchange<1>(x, ch);
      // unattended (or stale) slots never reach the softmax
      const float sc = (ok_t >> (ch / 8)) & 1 ? x[0] : kNegInf;
      float mx = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      mx = fmaxf(m[0], mx);        // m[0], l[0]: head ch % 8 of this lane
      const float corr = exp2f(m[0] - mx);
      // everything masked so far: exp(NEG - NEG) = 1 must not count
      const float p = mx == kNegInf ? 0.f : exp2f(sc - mx);
      float ps = p + __shfl_xor_sync(0xffffffffu, p, 8);
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      l[0] = l[0] * corr + ps;
      m[0] = mx;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float cg = __shfl_sync(0xffffffffu, corr, g);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[0][g][e] *= cg;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!((ok_t >> i) & 1)) continue;    // V not copied (warp-uniform)
        float vx[VEC];
        load_piece<T, VEC>(vs + (rg + 4 * i) * D + ch * VEC, vx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pg = __shfl_sync(0xffffffffu, p, 8 * i + g);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[0][g][e] = fmaf(pg, vx[e], acc[0][g][e]);
        }
      }
      continue;
    }
    float s[kMaxSlots][G];
#pragma unroll
    for (int i = 0; i < kMaxSlots; ++i) {
      const int c = min(rg + RG * i, kTile - 1);
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int pc = ch + W * j;
        if (i < nsl && pc < pieces) {
          float kx[VEC];
          load_piece<T, VEC>(ks + c * D + pc * VEC, kx);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              part[g] = fmaf(q[j][g][e], kx[e], part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        for (int off = W / 2; off; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
        // unattended (or stale) slots never reach the softmax
        s[i][g] = (ok_t >> i) & 1 ? part[g] : kNegInf;
      }
    }
    // online softmax over the tile's slots of this row group, per head
    float p[kMaxSlots][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < kMaxSlots; ++i) mx = fmaxf(mx, s[i][g]);
      const float corr = exp2f(m[g] - mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxSlots; ++i) {
        // everything masked so far: exp(NEG - NEG) = 1 must not count
        p[i][g] = mx == kNegInf ? 0.f : exp2f(s[i][g] - mx);
        sum += p[i][g];
      }
      l[g] = l[g] * corr + sum;
      m[g] = mx;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][g][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < kMaxSlots; ++i) {
      if (!((ok_t >> i) & 1)) continue;    // V not copied
      const int c = rg + RG * i;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int pc = ch + W * j;
        if (pc < pieces) {
          float vx[VEC];
          load_piece<T, VEC>(vs + c * D + pc * VEC, vx);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[j][g][e] = fmaf(p[i][g], vx[e], acc[j][g][e]);
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();                 // the stages are free: merge row groups

  float* a_s = reinterpret_cast<float*>(smem);        // [RG][G][D]
  float* m_s = a_s + (size_t)RG * G * D;              // [RG][G]
  float* l_s = m_s + RG * G;                          // [RG][G]
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int pc = ch + W * j;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int d = pc * VEC + e;
        if (pc < pieces && d < D)
          a_s[((size_t)rg * G + g) * D + d] = acc[j][g][e];
      }
  }
  if (WIDE) {
    if (ch < G) {                  // lanes 0..G-1 hold heads 0..G-1
      m_s[rg * G + ch] = m[0];
      l_s[rg * G + ch] = l[0];
    }
  } else if (ch == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_s[rg * G + g] = m[g];
      l_s[rg * G + g] = l[g];
    }
  }
  __syncthreads();
  finish<T>(a_s, m_s, l_s, reinterpret_cast<int*>(l_s + RG * G), RG, G, Gw,
            D, o_head, lse_head, part_acc, part_ml, counter, split,
            n_split);
}

// ---------------------------------------------------- tensor-core body
// c[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, fp32 accumulate.  Lane
// (g, t4) gives a's row g in a0 (columns 2 t4, 2 t4 + 1) and a2 (the same
// + 8), and row g + 8 in a1 and a3; it gets c's row g in c[0..1] and row
// g + 8 in c[2..3] (columns 2 t4, 2 t4 + 1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, or 16 zero bytes (nothing read)
__device__ __forceinline__ void cp_async_16_or_zero(void* dst,
                                                    const void* src,
                                                    bool copy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(copy ? 16 : 0)
               : "memory");
}

// bf16 body; D = 64, 80 or 128.  kRows16 = false serves G = 1..8 heads
// on rows 0..7 of the m16 tile; kRows16 = true serves G = 9..16, head g
// on row g and head g + 8 on row g + 8, so a lane keeps R = 2 softmax
// rows (r = 0: head g, r = 1: head g + 8).  Arguments as decode_block.
template <int D, bool kRows16, typename Layout>
__device__ __forceinline__ void decode_block_mma(
    const Layout& lay, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ q_head,
    __nv_bfloat16* __restrict__ o_head, float* __restrict__ lse_head,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ counter, int C, int G, float scale_log2, int split,
    int n_split, unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  constexpr int S = kMmaStages;
  constexpr int R = kRows16 ? 2 : 1;           // softmax rows a lane keeps
  constexpr int kRow = D * 2 + kMmaPad;        // staged row, bytes
  constexpr int kStage = 2 * kTile * kRow;     // K then V
  constexpr int kPieces = D / 8;               // 16-byte pieces a row
  constexpr int kCopies = kTile * kPieces / 32;
  constexpr int kN = D / 8;                    // n8 tiles of O
  static_assert(D % 16 == 0 && kTile * kPieces % 32 == 0 && kN % 2 == 0 &&
                    kRow / 16 % 2 == 1,
                "whole k16 steps, copies and n8 pairs; a staged row of an "
                "odd count of 16-byte pieces");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  int t_lo, t_hi;
  split_tiles(C, split, n_split, t_lo, t_hi);
  t_lo += warp;                                // this warp: every 4th tile
  unsigned char* ring = smem + (size_t)warp * S * kStage;

  // Q as the A fragment of S = Q K^T: qa[kk][2 r + h] is head g + 8 r's
  // columns 16 kk + 8 h + 2 t4, + 1 (zero past G); r = 1 is read only by
  // the 16-row instance (a1 = a3 = 0 in the 8-row one)
  uint32_t qa[D / 16][2 * R];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qa[kk][2 * r + h] =
            g + 8 * r < G ? *reinterpret_cast<const uint32_t*>(
                                q_head + (size_t)(g + 8 * r) * D + 16 * kk +
                                8 * h + 2 * t4)
                          : 0u;
  // A registers (a0, a1, a2, a3) of Q for k16 step kk
  auto a_of = [&](int kk, int i) -> uint32_t {
    if constexpr (kRows16) {
      return qa[kk][i % 2 == 0 ? i / 2 : 2 + i / 2];
    } else {
      return i % 2 == 0 ? qa[kk][i / 2] : 0u;
    }
  };
  float acc[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[R], l[R];                // head g + 8 r
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  // lane l < kTile fetches slot l of a tile, one tile ahead of its copy
  int fetched = kEmptyPos;
  auto fetch_tile = [&](int t) {
    fetched = lane < kTile && t < t_hi ? lay.fetch(t * kTile + lane)
                                       : kEmptyPos;
  };
  auto issue_tile = [&](int u) {             // u: this warp's u-th tile
    const int t = t_lo + kWarps * u;
    const unsigned ok =
        __ballot_sync(0xffffffffu, lane < kTile && t < t_hi &&
                                       lay.attended(t * kTile + lane,
                                                    fetched));
    const int slot = t * kTile + lane;
    const long long off =
        lane < kTile ? lay.offset(slot, fetched) : 0;
    if (ok) {
      unsigned char* st = ring + (u % S) * kStage;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int idx = lane + 32 * i, c = idx / kPieces, pc = idx % kPieces;
        const long long row = __shfl_sync(0xffffffffu, off, c);
        const bool copy = (ok >> c) & 1;
        const long long src = copy ? row + pc * 8 : 0;
        cp_async_16_or_zero(st + c * kRow + pc * 16, k + src, copy);
        cp_async_16_or_zero(st + kTile * kRow + c * kRow + pc * 16, v + src,
                            copy);
      }
    }
    sm90::cp_async_commit();
    return ok;
  };

  unsigned ok[S];
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    fetch_tile(t_lo + kWarps * i);
    ok[i] = issue_tile(i);
  }
  fetch_tile(t_lo + kWarps * (S - 1));
  for (int u = 0; t_lo + kWarps * u < t_hi; ++u) {
    __syncwarp();                  // stage (u - 1) % S is read: refill it
    ok[S - 1] = issue_tile(u + S - 1);
    fetch_tile(t_lo + kWarps * (u + S));
    sm90::cp_async_wait<S - 1>();
    __syncwarp();                  // the warp's copies of tile u landed
    const unsigned ok_t = ok[0];
#pragma unroll
    for (int i = 0; i < S - 1; ++i) ok[i] = ok[i + 1];
    if (!ok_t) continue;
    const unsigned char* ks = ring + (u % S) * kStage;
    const unsigned char* vs = ks + kTile * kRow;

    // S = Q K^T: n8 tile nt holds slots 8nt + 2 t4 + {0, 1} of head g
    // (sc[nt][0..1]) and of head g + 8 (sc[nt][2..3])
    float sc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int mi = lane / 8, r = lane % 8;
      uint32_t b[4];
      sm90::ldmatrix_x4(
          b, ks + (r + 8 * (mi / 2)) * kRow + (16 * kk + 8 * (mi % 2)) * 2,
          false);
      mma_bf16(sc[0], a_of(kk, 0), a_of(kk, 1), a_of(kk, 2), a_of(kk, 3),
               b[0], b[1]);
      mma_bf16(sc[1], a_of(kk, 0), a_of(kk, 1), a_of(kk, 2), a_of(kk, 3),
               b[2], b[3]);
    }
    // online softmax of each row r, elements sc[nt][2 r + e]
    float p[2][4] = {}, corr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * nt + 2 * t4 + e;
          float& x = sc[nt][2 * r + e];
          x = (ok_t >> c) & 1 ? x * scale_log2 : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // everything masked so far: exp(NEG - NEG) = 1 must not count
          p[nt][2 * r + e] =
              mx == kNegInf ? 0.f : exp2f(sc[nt][2 * r + e] - mx);
          sum += p[nt][2 * r + e];
        }
      l[r] = l[r] * corr[r] + sum;
      m[r] = mx;
    }
    // P as the A fragment of O = P V: row g in pa0 / pa2 (slots 0..7 /
    // 8..15), row g + 8 in pa1 / pa3
    const uint32_t pa0 = sm90::pack_bf16(p[0][0], p[0][1]);
    const uint32_t pa2 = sm90::pack_bf16(p[1][0], p[1][1]);
    const uint32_t pa1 = kRows16 ? sm90::pack_bf16(p[0][2], p[0][3]) : 0u;
    const uint32_t pa3 = kRows16 ? sm90::pack_bf16(p[1][2], p[1][3]) : 0u;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      if constexpr (kRows16) {
        acc[j][2] *= corr[R - 1];
        acc[j][3] *= corr[R - 1];
      }
    }
    // O += P V: V rows are slots (k), columns d (n), through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < kN; j += 2) {
      const int mi = lane / 8, r = lane % 8;
      uint32_t b[4];
      sm90::ldmatrix_x4(
          b, vs + (r + 8 * (mi % 2)) * kRow + (8 * j + 8 * (mi / 2)) * 2,
          true);
      mma_bf16(acc[j], pa0, pa1, pa2, pa3, b[0], b[1]);
      mma_bf16(acc[j + 1], pa0, pa1, pa2, pa3, b[2], b[3]);
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();                 // the stages are free: merge the warps

  float* a_s = reinterpret_cast<float*>(smem);        // [4][G][D]
  float* m_s = a_s + (size_t)kWarps * G * D;          // [4][G]
  float* l_s = m_s + kWarps * G;                      // [4][G]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int head = g + 8 * r;
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (head < G) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float* dst = a_s + ((size_t)warp * G + head) * D + 8 * j + 2 * t4;
        dst[0] = acc[j][2 * r];
        dst[1] = acc[j][2 * r + 1];
      }
      if (t4 == 0) {
        m_s[warp * G + head] = m[r];
        l_s[warp * G + head] = l[r];
      }
    }
  }
  __syncthreads();
  finish<bf16>(a_s, m_s, l_s, reinterpret_cast<int*>(l_s + kWarps * G),
               kWarps, G, G, D, o_head, lse_head, part_acc, part_ml, counter,
               split, n_split);
}

// -------------------------------------------- float32 tensor-core body
// Staged rows of decode_block_tf32x3, in floats: K rows 16 mod 32 (the
// float4 loads of S = Q K^T hit every bank once), V rows D + 4, 4 mod 16
// (the float2 loads of P V likewise).
__host__ __device__ constexpr int tf32x3_ld_k(int D) {
  return D + (48 - D % 32) % 32;
}
__host__ __device__ constexpr int tf32x3_ld_v(int D) { return D + 4; }
// one stage: K then V of a warp's half tile, floats
__host__ __device__ constexpr int tf32x3_stage(int D) {
  return kHalfTile * (tf32x3_ld_k(D) + tf32x3_ld_v(D));
}

inline size_t tf32x3_smem_bytes(int G, int D) {
  const size_t stages = sizeof(float) * (size_t)kTf32x3Warps *
                        kTf32x3Stages * tf32x3_stage(D);
  const size_t merge = merge_bytes(kTf32x3Warps, G, D);
  return stages > merge ? stages : merge;
}

// float32 body; D = 64, 80 or 128; a group of G = 1..8 heads.  The walk
// is decode_block_mma's with 8 warps on half tiles: warp w takes slots
// 8 (w / 4) .. + 7 of every 4th tile of the split from tile w % 4, so a
// tile's two halves run on two warps at once (a float32 warp does twice a
// bf16 warp's work a slot, and a ring of float32 stages holds one block
// an SM at D 128), each through its own ring of kTf32x3Stages stages
// (16-byte cp.async, unattended slots zero-filled and never read; a
// slot's position or page id fetched two half tiles ahead of its copy).
// Every product is three TF32 products of hi / lo splits, and the m16
// tile's rows 8..15 carry the lo halves of the A operand: rows 0..7 are
// hi(q) (hi(p)) of heads 0..7, rows 8..15 lo(q) (lo(p)) of the same heads,
// so one mma with hi(B) gives hi(a) hi(b) in rows 0..7 and lo(a) hi(b) in
// rows 8..15 of one accumulator (a lane holds both for the same columns),
// and one with lo(B) gives hi(a) lo(b) in rows 0..7: two mma a k8 step,
// not three.  The k order inside a step is free, as in
// flash_attention_fwd_tf32x3.cu: in S = Q K^T lane (g, t4) takes dims
// 4 t4 .. 4 t4 + 3 of each 16 as one float4 of K row g for two k8 steps;
// in O += P V the k index is the two slots S's accumulator gives the lane
// (P goes into the A fragment as it is), and column g of the n8 tiles
// 2 m, 2 m + 1 is dims 16 m + 2 g, + 1 (one float2 of a V row), so a
// lane's O holds dims 16 m + 4 t4 .. + 3 of head g.  Rounding: the tensor
// cores' fp32 sums are not rounded to nearest, so no accumulator runs
// across half tiles: S's small products have their own accumulators and
// meet the large ones in fp32, and each half tile's P V is summed from
// zero and folded into O with the softmax correction by one fp32 fma.
// Arguments as decode_block_mma's, float32.
template <int D, typename Layout>
__device__ __forceinline__ void decode_block_tf32x3(
    const Layout& lay, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ q_head,
    float* __restrict__ o_head, float* __restrict__ lse_head,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ counter, int C, int G, float scale_log2, int split,
    int n_split, unsigned char* smem) {
  constexpr int S = kTf32x3Stages;
  constexpr int kLdK = tf32x3_ld_k(D), kLdV = tf32x3_ld_v(D);
  constexpr int kStage = tf32x3_stage(D);      // floats
  constexpr int kPieces = D / 4;               // 16-byte pieces a row
  constexpr int kCopies = kHalfTile * kPieces / 32;
  constexpr int kN = D / 8;                    // n8 tiles of O
  constexpr int kRuns = 4;                     // accumulators of S a kind
  static_assert(D % 16 == 0 && kHalfTile * kPieces % 32 == 0,
                "whole pairs of k8 steps and whole copies");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int half = kHalfTile * (warp / kWarps);  // first slot of a tile
  int t_lo, t_hi;
  split_tiles(C, split, n_split, t_lo, t_hi);
  t_lo += warp % kWarps;                       // every 4th tile
  float* ring = reinterpret_cast<float*>(smem) + (size_t)warp * S * kStage;

  // lane l < kHalfTile fetches slot half + l of tile t
  auto fetch_tile = [&](int t) {
    return lane < kHalfTile && t < t_hi
               ? lay.fetch(t * kTile + half + lane)
               : kEmptyPos;
  };
  // the first S + 1 tiles' fetches go out before Q is read, so the two
  // reads' latencies overlap
  int fetched[S + 1];
#pragma unroll
  for (int i = 0; i <= S; ++i) fetched[i] = fetch_tile(t_lo + kWarps * i);

  // Q as the A fragment of S = Q K^T, split once: qa[d16][h][.] is the k8
  // step of dims 16 d16 + 4 t4 + 2 h (k t4) and + 1 (k t4 + 4): a0 / a2
  // hi(q) of head g, a1 / a3 lo(q) (zero past G)
  uint32_t qa[D / 16][2][4];
#pragma unroll
  for (int d16 = 0; d16 < D / 16; ++d16)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x =
            g < G ? q_head[(size_t)g * D + 16 * d16 + 4 * t4 + 2 * h + e]
                  : 0.f;
        sm90::split_tf32_bits(x, qa[d16][h][2 * e], qa[d16][h][2 * e + 1]);
      }
  // O of head g: acc[n][e] is dim 16 (n / 2) + 4 t4 + 2 e + n % 2
  float acc[kN][2];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n][0] = acc[n][1] = 0.f;
  float m = kNegInf, l = 0.f;

  // u: this warp's u-th tile; f: its slot's fetched value
  auto issue_tile = [&](int u, int f) {
    const int t = t_lo + kWarps * u;
    const int slot = t * kTile + half + lane;
    const unsigned ok = __ballot_sync(
        0xffffffffu, lane < kHalfTile && t < t_hi && lay.attended(slot, f));
    const long long off = lane < kHalfTile ? lay.offset(slot, f) : 0;
    if (ok) {
      float* ks = ring + (u % S) * kStage;
      float* vs = ks + kHalfTile * kLdK;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int idx = lane + 32 * i, c = idx / kPieces, pc = idx % kPieces;
        const long long row = __shfl_sync(0xffffffffu, off, c);
        const bool copy = (ok >> c) & 1;
        const long long src = copy ? row + pc * 4 : 0;
        cp_async_16_or_zero(ks + c * kLdK + pc * 4, k + src, copy);
        cp_async_16_or_zero(vs + c * kLdV + pc * 4, v + src, copy);
      }
    }
    sm90::cp_async_commit();
    return ok;
  };

  unsigned ok[S];
#pragma unroll
  for (int i = 0; i < S - 1; ++i) ok[i] = issue_tile(i, fetched[i]);
  // the fetched values of the next two tiles to issue
  int f_next = fetched[S - 1], f_after = fetched[S];
  for (int u = 0; t_lo + kWarps * u < t_hi; ++u) {
    __syncwarp();                  // stage (u - 1) % S is read: refill it
    ok[S - 1] = issue_tile(u + S - 1, f_next);
    f_next = f_after;
    f_after = fetch_tile(t_lo + kWarps * (u + S + 1));
    sm90::cp_async_wait<S - 1>();
    __syncwarp();                  // the warp's copies of tile u landed
    const unsigned ok_t = ok[0];
#pragma unroll
    for (int i = 0; i < S - 1; ++i) ok[i] = ok[i + 1];
    if (!ok_t) continue;
    const float* ks = ring + (u % S) * kStage;
    const float* vs = ks + kHalfTile * kLdK;

    // S = Q K^T over the half tile's 8 slots, lane (g, t4) holding slots
    // 2 t4 and 2 t4 + 1: big[r] takes hi(k) (rows 0..7 hi(q) hi(k), rows
    // 8..15 lo(q) hi(k)), small[r] lo(k) (rows 0..7 hi(q) lo(k)), the k16
    // steps dealt round kRuns accumulators of each kind so that no chain of
    // dependent mma is longer than D / 64 k16 steps
    float big[kRuns][4] = {}, small[kRuns][4] = {};
#pragma unroll
    for (int d16 = 0; d16 < D / 16; ++d16) {
      // B (k t4, n g), (k t4 + 4, n g) of the two k8 steps: K[g] at dims
      // c, c + 1, then c + 2, c + 3
      const float4 kv = *reinterpret_cast<const float4*>(
          ks + g * kLdK + 16 * d16 + 4 * t4);
      const float kx[4] = {kv.x, kv.y, kv.z, kv.w};
      uint32_t bh[4], bl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) sm90::split_tf32_bits(kx[e], bh[e], bl[e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sm90::mma_m16n8k8_tf32(small[d16 % kRuns], qa[d16][h], bl[2 * h],
                               bl[2 * h + 1]);
        sm90::mma_m16n8k8_tf32(big[d16 % kRuns], qa[d16][h], bh[2 * h],
                               bh[2 * h + 1]);
      }
    }
    // head g's scores: the large product, then the two small ones
    float sc[2];
    float mx = m;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float hh = 0.f, lh = 0.f, hl = 0.f;
#pragma unroll
      for (int r = 0; r < kRuns; ++r) {
        hh += big[r][e];
        lh += big[r][2 + e];
        hl += small[r][e];
      }
      sc[e] = (ok_t >> (2 * t4 + e)) & 1 ? (hh + (lh + hl)) * scale_log2
                                         : kNegInf;
      mx = fmaxf(mx, sc[e]);
    }
    // online softmax of head g over the quad's 8 slots
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = exp2f(m - mx);
    // P as the A fragment of O = P V: (g, k t4) = slot 2 t4 and (g, k
    // t4 + 4) = slot 2 t4 + 1, hi in a0 / a2, lo in a1 / a3
    uint32_t pa[4];
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // everything masked so far: exp(NEG - NEG) = 1 must not count
      const float p = mx == kNegInf ? 0.f : exp2f(sc[e] - mx);
      sum += p;
      sm90::split_tf32_bits(p, pa[2 * e], pa[2 * e + 1]);
    }
    l = l * corr + sum;
    m = mx;
    // O = O * corr + P V, n8 tiles 2 mm and 2 mm + 1 at a time: B (k t4,
    // n g) = V[slot 2 t4][dim 16 mm + 2 g (+ 1)], k t4 + 4 the next slot;
    // rows 0..7 of pv sum hi(p) lo(v) + hi(p) hi(v), rows 8..15 lo(p) lo(v)
    // + lo(p) hi(v)
#pragma unroll
    for (int mm = 0; mm < kN / 2; ++mm) {
      const float* vr = vs + 2 * t4 * kLdV + 16 * mm + 2 * g;
      const float2 va = *reinterpret_cast<const float2*>(vr);
      const float2 vn = *reinterpret_cast<const float2*>(vr + kLdV);
      const float vx[2][2] = {{va.x, vn.x}, {va.y, vn.y}};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bh[2], bl[2];
        sm90::split_tf32_bits(vx[p][0], bh[0], bl[0]);
        sm90::split_tf32_bits(vx[p][1], bh[1], bl[1]);
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        sm90::mma_m16n8k8_tf32(pv, pa, bl[0], bl[1]);
        sm90::mma_m16n8k8_tf32(pv, pa, bh[0], bh[1]);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[2 * mm + p][e] =
              fmaf(acc[2 * mm + p][e], corr, pv[e] + pv[2 + e]);
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();                 // the stages are free: merge the warps

  constexpr int RG = kTf32x3Warps;
  float* a_s = reinterpret_cast<float*>(smem);        // [RG][G][D]
  float* m_s = a_s + (size_t)RG * G * D;              // [RG][G]
  float* l_s = m_s + RG * G;                          // [RG][G]
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (g < G) {
#pragma unroll
    for (int mm = 0; mm < kN / 2; ++mm)
      *reinterpret_cast<float4*>(a_s + ((size_t)warp * G + g) * D + 16 * mm +
                                 4 * t4) =
          make_float4(acc[2 * mm][0], acc[2 * mm + 1][0], acc[2 * mm][1],
                      acc[2 * mm + 1][1]);
    if (t4 == 0) {
      m_s[warp * G + g] = m;
      l_s[warp * G + g] = l;
    }
  }
  __syncthreads();
  finish<float, 32 * RG>(a_s, m_s, l_s, reinterpret_cast<int*>(l_s + RG * G),
                         RG, G, G, D, o_head, lse_head, part_acc, part_ml,
                         counter, split, n_split);
}

// ------------------------------------------------------ kernels, launch
// A cache layout for the launch: rows.at(b, hk, C) returns the Layout of
// row b, KV head hk, and sets C to the number of slots of the row's run,
// which split_tiles cuts (the whole cache for the dense layout; the
// reachable slots [lo, end) of one row for the paged pool, so the splits
// share a short row's own tiles and not the table's width).
//
// The head group of a block: blockIdx.y = hk * NG + hg covers heads
// g0 = hg * Gc .. g0 + Gw - 1 of KV head hk's G; its scratch region and
// ticket are those of (b, hk, hg).
struct Group {
  int hk, Gw;
  size_t blk, head0;   // (b, hk, hg) index; offset of head g0 in q / o
};

__device__ __forceinline__ Group head_group(int G, int NG, int Gc, int D) {
  const int hk = blockIdx.y / NG, hg = blockIdx.y - hk * NG;
  const int g0 = hg * Gc;
  const size_t Hkv = gridDim.y / NG;
  return Group{hk, min(Gc, G - g0),
               (size_t)blockIdx.z * gridDim.y + blockIdx.y,
               (((size_t)blockIdx.z * Hkv + hk) * G + g0) * D};
}

template <typename Rows, int D, bool kRows16>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const Rows rows, const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int* __restrict__ counters, int G, int NG, int Gc,
                  float scale_log2) {
  const int split = blockIdx.x, n_split = gridDim.x;
  extern __shared__ __align__(16) unsigned char smem[];
  const Group grp = head_group(G, NG, Gc, D);
  int C;
  const auto lay = rows.at(blockIdx.z, grp.hk, C);
  decode_block_mma<D, kRows16>(lay, k, v, q + grp.head0, o + grp.head0,
                               lse ? lse + grp.head0 / D : nullptr,
                               part_acc + grp.blk * n_split * Gc * D,
                               part_ml + grp.blk * n_split * Gc * 2,
                               counters + grp.blk, C, grp.Gw, scale_log2,
                               split, n_split, smem);
}

template <typename Rows, int D>
__global__ void __launch_bounds__(32 * kTf32x3Warps)
decode_tf32x3_kernel(const Rows rows, const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int* __restrict__ counters,
                     int G, int NG, int Gc, float scale_log2) {
  const int split = blockIdx.x, n_split = gridDim.x;
  extern __shared__ __align__(16) unsigned char smem[];
  const Group grp = head_group(G, NG, Gc, D);
  int C;
  const auto lay = rows.at(blockIdx.z, grp.hk, C);
  decode_block_tf32x3<D>(lay, k, v, q + grp.head0, o + grp.head0,
                         lse ? lse + grp.head0 / D : nullptr,
                         part_acc + grp.blk * n_split * Gc * D,
                         part_ml + grp.blk * n_split * Gc * 2,
                         counters + grp.blk, C, grp.Gw, scale_log2, split,
                         n_split, smem);
}

// Gc, the heads of a full group, is the template's G.
template <typename Rows, typename T, int Gc, int VEC, int NC, bool WIDE>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Rows rows, const T* __restrict__ q,
              const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse,
              float* __restrict__ part_acc, float* __restrict__ part_ml,
              int* __restrict__ counters, int G, int NG, int D, int W,
              float scale_log2) {
  const int split = blockIdx.x, n_split = gridDim.x;
  extern __shared__ __align__(16) unsigned char smem[];
  const Group grp = head_group(G, NG, Gc, D);
  int C;
  const auto lay = rows.at(blockIdx.z, grp.hk, C);
  decode_block<T, Gc, VEC, NC, WIDE>(
      lay, k, v, q + grp.head0, o + grp.head0,
      lse ? lse + grp.head0 / D : nullptr,
      part_acc + grp.blk * n_split * Gc * D,
      part_ml + grp.blk * n_split * Gc * 2, counters + grp.blk, C, grp.Gw, D,
      W, scale_log2, split, n_split, smem);
}

// Call f(std::integral_constant<int, G>{}) for a run-time G in 1..kMaxG.
template <typename F>
cudaError_t with_group(int G, F&& f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

// Pointers and sizes of one launch: q/o [B, Hkv * G, D] (any G >= 1) in
// NG head groups of Gc = ceil(G / NG) heads (the caller's choice; NG must
// be ceil(G / Gc), so no group is empty); k/v the cache (the layout
// addresses it); part_acc / part_ml / counters the merge scratch when
// n_split > 1, sized for the head groups; lse, when
// not null, float32 [B, Hkv * G]: each head's log-sum-exp of its scaled
// scores over the slots it attended (-1e30 where none), so that launches
// over disjoint runs of one row's cache can be merged by the caller.
// body: kBodyCore (decode_block), kBodyMma (decode_block_mma) or
// kBodyTf32x3 (decode_block_tf32x3).
// resident, when not null, asks for no launch: the kernel the launch would
// run is chosen as for a launch, and the blocks of it that one SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor, at its threads and
// dynamic shared memory) are written there; aligned then stands for the
// pointers (k and v 16-byte aligned, q 4-byte aligned).
constexpr int kBodyCore = 0, kBodyMma = 1, kBodyTf32x3 = 2;

struct Launch {
  const void *q, *k, *v;
  void *o, *part_acc, *part_ml, *counters;
  int B, Hkv, G, NG, D, n_split;
  float scale;
  cudaStream_t stream;
  void* lse = nullptr;
  int body = kBodyCore;
  int* resident = nullptr;
  bool aligned = false;
};

// Launch kernel over the grid of a with threads a block, or with
// a.resident only count the blocks of it an SM holds.
template <typename Kernel, typename... Args>
cudaError_t launch_or_count(Kernel kernel, int threads, size_t smem,
                            const Launch& a, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (a.resident)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.resident, kernel,
                                                         threads, smem);
  kernel<<<dim3(a.n_split, a.Hkv * a.NG, a.B), threads, smem, a.stream>>>(
      args...);
  return cudaGetLastError();
}

template <typename Rows, int D>
cudaError_t launch_tf32x3(const Rows& rows, const Launch& a) {
  const int NG = a.NG, Gc = (a.G + NG - 1) / NG;
  return launch_or_count(
      decode_tf32x3_kernel<Rows, D>, 32 * kTf32x3Warps,
      tf32x3_smem_bytes(Gc, D), a, rows, static_cast<const float*>(a.q),
      static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<float*>(a.o), static_cast<float*>(a.lse),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
      static_cast<int*>(a.counters), a.G, NG, Gc, a.scale * kLog2e);
}

template <typename Rows, typename T, int VEC, int NC, bool WIDE = false>
cudaError_t launch_core(const Rows& rows, const Launch& a, int W) {
  const int NG = a.NG, Gc = (a.G + NG - 1) / NG;
  const size_t smem = core_smem_bytes(sizeof(T), Gc, a.D, W);
  return with_group(Gc, [&](auto g) {
    return launch_or_count(
        decode_kernel<Rows, T, decltype(g)::value, VEC, NC, WIDE>, kThreads,
        smem, a,
        rows, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o),
        static_cast<float*>(a.lse), static_cast<float*>(a.part_acc),
        static_cast<float*>(a.part_ml),
        static_cast<int*>(a.counters), a.G, NG, a.D, W, a.scale * kLog2e);
  });
}

template <typename Rows, int D>
cudaError_t launch_mma(const Rows& rows, const Launch& a) {
  using bf16 = __nv_bfloat16;
  const int NG = a.NG, Gc = (a.G + NG - 1) / NG;
  const size_t smem = mma_smem_bytes(Gc, D);
  // rows 8..15 of the m16 tile only for a group of more than 8 heads
  auto kernel = Gc > 8 ? decode_mma_kernel<Rows, D, true>
                       : decode_mma_kernel<Rows, D, false>;
  return launch_or_count(
      kernel, kThreads, smem, a, rows, static_cast<const bf16*>(a.q),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<bf16*>(a.o), static_cast<float*>(a.lse),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
      static_cast<int*>(a.counters), a.G, NG, Gc, a.scale * kLog2e);
}

// Whether NG groups of G heads are a partition the body serves: Gc =
// ceil(G / NG) heads at most the body's limit (kMmaMaxG on the bf16
// tensor-core body, kMaxG on the float32 one, whose rows 8..15 carry the
// lo halves, and on the CUDA cores), and no group empty.
inline bool groups_served(int G, int NG, int body) {
  if (G < 1 || NG < 1 || NG > G) return false;
  const int Gc = (G + NG - 1) / NG;
  return (G + Gc - 1) / Gc == NG &&
         Gc <= (body == kBodyMma ? kMmaMaxG : kMaxG);
}

// The body the launch names: the tensor cores for bf16 at D = 64, 80 or
// 128 with 16-byte aligned K/V and 4-byte aligned q, in groups of up to
// 16 heads, and for float32 at those D and alignments (3xTF32) in groups
// of up to 8; the CUDA cores at any D and dtype, in groups of up to 8, with
// 16-byte pieces where D and the cache's alignment allow them and a row
// fits 32 lanes, one element a piece where not.  A launch a body cannot
// serve (its dtype, D, alignment or head groups) is refused, never sent
// elsewhere.
template <typename T, typename Rows>
cudaError_t dispatch(const Rows& rows, const Launch& a) {
  constexpr int kVec = 16 / sizeof(T);
  const int D = a.D;
  const bool aligned = a.resident ? a.aligned
                       : reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  const bool q_aligned =
      a.resident ? a.aligned : reinterpret_cast<uintptr_t>(a.q) % 4 == 0;
  if (!groups_served(a.G, a.NG, a.body)) return cudaErrorInvalidValue;
  if (a.body == kBodyMma) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (aligned && q_aligned) {
        if (D == 64) return launch_mma<Rows, 64>(rows, a);
        if (D == 80) return launch_mma<Rows, 80>(rows, a);
        if (D == 128) return launch_mma<Rows, 128>(rows, a);
      }
    }
    return cudaErrorInvalidValue;
  }
  if (a.body == kBodyTf32x3) {
    if constexpr (std::is_same<T, float>::value) {
      if (aligned && q_aligned) {
        if (D == 64) return launch_tf32x3<Rows, 64>(rows, a);
        if (D == 80) return launch_tf32x3<Rows, 80>(rows, a);
        if (D == 128) return launch_tf32x3<Rows, 128>(rows, a);
      }
    }
    return cudaErrorInvalidValue;
  }
  if (a.body != kBodyCore) return cudaErrorInvalidValue;
  if (aligned && D == 32 * kVec)
    return launch_core<Rows, T, kVec, 1, true>(rows, a, 32);
  if (aligned && D % kVec == 0 && D / kVec <= 32)
    return launch_core<Rows, T, kVec, 1>(rows, a, lanes_per_row(D / kVec));
  return launch_core<Rows, T, 1, kMaxD / 32>(rows, a, lanes_per_row(D));
}

// dtype 0 = float32, 1 = bfloat16
template <typename Rows>
cudaError_t dispatch_dtype(const Rows& rows, const Launch& a, int dtype) {
  if (dtype == 0) return dispatch<float>(rows, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(rows, a);
  return cudaErrorInvalidValue;
}

}  // namespace split
}  // namespace repro
