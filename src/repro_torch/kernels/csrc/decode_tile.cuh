// Device code of the one-token paged decode kernel, paged_flash_decode.cu.
// (The dense-cache kernel, flash_decode.cu, left it for the split design of
// split_decode.cuh, which the paged kernel can adopt in turn.)
//
// One block of kThreads threads serves one (KV head, row) pair.  It keeps
// the G query heads of the group in shared memory (pre-scaled), walks the
// row's cache in tiles of kTile slots, and runs an fp32 online softmax.
// The kernel fills, per slot of the tile, a flag (attended or not) and
// the element offset of the slot's K/V row (the page table says where a
// slot lives, the row's length whether it is attended); stage_rows then
// copies the attended rows into shared memory, attend_tile scores the G
// heads against them and folds them into (acc, m, l), and store_out
// writes acc / max(l, 1e-30).  A slot that is not attended is never read.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;              // cache slots staged per tile
constexpr int kMaxD = 256;
constexpr int kMaxG = 8;
constexpr int kJ = kMaxD / kThreads;   // output columns per thread

// Shared memory of one block, carved from the dynamic buffer.
struct Smem {
  long long* off;  // [kTile] element offset of each slot's K/V row
  float* q;        // [G][D], pre-scaled
  float* k;        // [kTile][D+1]: padded rows, so threads on different
                   // slots read different banks
  float* v;        // [kTile][D]
  float* p;        // [G][kTile] scores -> probabilities
  float* m;        // [G] running max
  float* l;        // [G] running denominator
  float* c;        // [G] this tile's rescale
  int* ok;         // [kTile] 1 if the slot is attended
};

inline size_t smem_bytes(int G, int D) {
  return sizeof(long long) * kTile +
         sizeof(float) * (size_t)(G * D + kTile * (D + 1) + kTile * D +
                                  G * kTile + 3 * G) +
         sizeof(int) * kTile;
}

__device__ __forceinline__ Smem carve(unsigned char* base, int G, int D) {
  Smem s;
  s.off = reinterpret_cast<long long*>(base);
  s.q = reinterpret_cast<float*>(s.off + kTile);
  s.k = s.q + G * D;
  s.v = s.k + kTile * (D + 1);
  s.p = s.v + kTile * D;
  s.m = s.p + G * kTile;
  s.l = s.m + G;
  s.c = s.l + G;
  s.ok = reinterpret_cast<int*>(s.c + G);
  return s;
}

// Load the group's G query rows (qb points at head 0 of the group), scaled,
// and reset the softmax state.  The caller syncs before the first tile.
template <typename T, int G>
__device__ __forceinline__ void load_q(const Smem& s, const T* qb, int D,
                                       float scale, float (&acc)[kJ][G]) {
  const int tid = threadIdx.x;
  for (int i = tid; i < G * D; i += kThreads) s.q[i] = to_f32(qb[i]) * scale;
  if (tid < G) {
    s.m[tid] = kNegInf;
    s.l[tid] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[j][g] = 0.f;
}

// Copy the attended slots' K and V rows into shared memory (zeros for the
// others).  Needs s.ok / s.off of this tile, synced.
template <typename T>
__device__ __forceinline__ void stage_rows(const Smem& s, const T* k,
                                           const T* v, int D) {
  const int ldk = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int c = i / D, d = i - c * D;
    float kv = 0.f, vv = 0.f;
    if (s.ok[c]) {
      kv = to_f32(k[s.off[c] + d]);
      vv = to_f32(v[s.off[c] + d]);
    }
    s.k[c * ldk + d] = kv;
    s.v[c * D + d] = vv;
  }
}

// Score the G heads against the staged tile and fold it into the online
// softmax.  Needs the staged tile, synced; leaves p/c in use until the
// caller's next __syncthreads().  Thread tid owns output columns
// d = tid + j * kThreads.
template <int G>
__device__ __forceinline__ void attend_tile(const Smem& s, int D,
                                            float (&acc)[kJ][G]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldk = D + 1;

  // masked scores of the G heads against the tile
  for (int i = tid; i < G * kTile; i += kThreads) {
    const int g = i / kTile, c = i - g * kTile;
    float sc = kNegInf;
    if (s.ok[c]) {
      const float* qr = s.q + g * D;
      const float* kr = s.k + c * ldk;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      sc = dot;
    }
    s.p[i] = sc;
  }
  __syncthreads();

  // online-softmax statistics, one warp per query head
  for (int g = warp; g < G; g += kWarps) {
    float* pr = s.p + g * kTile;
    float tmax = kNegInf;
    for (int c = lane; c < kTile; c += 32) tmax = fmaxf(tmax, pr[c]);
    for (int o = 16; o; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_old = s.m[g];
    const float m_new = fmaxf(m_old, tmax);
    float sum = 0.f;
    for (int c = lane; c < kTile; c += 32) {
      // everything masked so far: exp(NEG - NEG) = 1 must not count
      const float p = (m_new == kNegInf) ? 0.f : expf(pr[c] - m_new);
      pr[c] = p;
      sum += p;
    }
    for (int o = 16; o; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      s.c[g] = corr;
      s.l[g] = s.l[g] * corr + sum;
      s.m[g] = m_new;
    }
  }
  __syncthreads();

  // acc = acc * corr + P V
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int d = tid + j * kThreads;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < G; ++g) acc[j][g] *= s.c[g];
      for (int c = 0; c < kTile; ++c) {
        const float vv = s.v[c * D + d];
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[j][g] = fmaf(s.p[g * kTile + c], vv, acc[j][g]);
      }
    }
  }
}

// Write the group's G output rows (ob points at head 0 of the group).  A
// head that attended nothing has l = 0 and acc = 0, so it writes 0.
template <typename T, int G>
__device__ __forceinline__ void store_out(const Smem& s, T* ob, int D,
                                          const float (&acc)[kJ][G]) {
  __syncthreads();   // l of every head is final (also with zero tiles)
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int d = threadIdx.x + j * kThreads;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        ob[(size_t)g * D + d] = from_f32<T>(acc[j][g] / fmaxf(s.l[g], 1e-30f));
    }
  }
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

}  // namespace decode
}  // namespace repro
