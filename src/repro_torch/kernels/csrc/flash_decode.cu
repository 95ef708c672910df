// Flash decode for Hopper (sm_90a): one query token per row over a dense
// KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// ::flash_decode (body _decode_kernel).  Same semantics: q [B, Hkv*G, D]
// against k/v [B, C, Hkv, D]; slot c of row b is attended iff
// 0 <= k_pos[b,c] <= q_pos[b] and, with a window, k_pos > q_pos - window.
// Masks come from positions, so the SWA ring layout needs no special case.
// fp32 online softmax; a row with nothing to attend to gives 0.
//
// Bound on the H100: HBM bytes.  Each step reads the whole cache once
// (2 * B * C * Hkv * D elements) against ~4 FLOPs per element, far below
// the card's ~295 FLOP/byte ridge, so the floor is cache bytes / 3.35 TB/s.
// Design: one block per (KV head, batch row) streams its cache slice
// through shared memory in tiles of kTile slots, and the G query heads of
// the group score against each tile while it is on chip, so K and V are
// read from HBM exactly once per step for all G heads (the GQA saving).
// The sequential cache axis of the TPU grid becomes the tile loop inside
// the block, and the VMEM (acc, m, l) carry becomes registers + shared
// memory.  Not yet fast: B * Hkv blocks (64 at B=32, Hkv=2) under-fill the
// 132 SMs, and a tile is staged synchronously.  A split over C with a
// second reduce pass (flash-decoding) and cp.async/TMA double buffering
// are the next steps.
#include "common.cuh"

namespace {

using repro::kEmptyPos;
using repro::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;     // cache slots staged per tile
constexpr int kMaxD = 256;
constexpr int kMaxG = 8;
constexpr int kJ = kMaxD / kThreads;   // output columns per thread

size_t smem_bytes(int G, int D) {
  return sizeof(float) * (size_t)(G * D + kTile * (D + 1) + kTile * D +
                                  G * kTile + 3 * G) +
         sizeof(int) * kTile;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, T* __restrict__ o, int C,
                    int Hkv, int D, int window, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * G;
  const int ldk = D + 1;   // padded K rows: threads on different slots
                           // read different banks

  extern __shared__ float smem[];
  float* q_s = smem;                          // [G][D], pre-scaled
  float* k_s = q_s + G * D;                   // [kTile][D+1]
  float* v_s = k_s + kTile * ldk;             // [kTile][D]
  float* p_s = v_s + kTile * D;               // [G][kTile] scores -> probs
  float* m_s = p_s + G * kTile;               // [G] running max
  float* l_s = m_s + G;                       // [G] running denominator
  float* c_s = l_s + G;                       // [G] this tile's rescale
  int* kp_s = reinterpret_cast<int*>(c_s + G);  // [kTile]

  const int qp = q_pos[b];
  const T* qb = q + ((size_t)b * H + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = repro::to_f32(qb[i]) * scale;
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kJ][G];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[j][g] = 0.f;

  const size_t slot_stride = (size_t)Hkv * D;
  const T* kb = k + (size_t)b * C * slot_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * C * slot_stride + (size_t)hk * D;
  const int* kpb = k_pos + (size_t)b * C;

  for (int c0 = 0; c0 < C; c0 += kTile) {
    __syncthreads();   // the previous tile is consumed; q_s/m_s are ready
    // 1. stage K, V and positions of slots [c0, c0 + kTile)
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int c = i / D, d = i - c * D, slot = c0 + c;
      float kv = 0.f, vv = 0.f;
      if (slot < C) {
        kv = repro::to_f32(kb[slot * slot_stride + d]);
        vv = repro::to_f32(vb[slot * slot_stride + d]);
      }
      k_s[c * ldk + d] = kv;
      v_s[c * D + d] = vv;
    }
    if (tid < kTile) {
      const int slot = c0 + tid;
      kp_s[tid] = slot < C ? kpb[slot] : kEmptyPos;
    }
    __syncthreads();

    // 2. masked scores of the G heads against the tile
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, c = i - g * kTile;
      const int kp = kp_s[c];
      const bool ok = kp >= 0 && kp <= qp && (window < 0 || kp > qp - window);
      float s = kNegInf;
      if (ok) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + c * ldk;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // 3. online-softmax statistics, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* pr = p_s + g * kTile;
      float tmax = kNegInf;
      for (int c = lane; c < kTile; c += 32) tmax = fmaxf(tmax, pr[c]);
      for (int off = 16; off; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.f;
      for (int c = lane; c < kTile; c += 32) {
        // everything masked so far: exp(NEG - NEG) = 1 must not count
        const float p = (m_new == kNegInf) ? 0.f : expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + P V; thread owns columns d = tid + j*kThreads
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tid + j * kThreads;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < G; ++g) acc[j][g] *= c_s[g];
        for (int c = 0; c < kTile; ++c) {
          const float vv = v_s[c * D + d];
#pragma unroll
          for (int g = 0; g < G; ++g) acc[j][g] = fmaf(p_s[g * kTile + c], vv, acc[j][g]);
        }
      }
    }
  }

  T* ob = o + ((size_t)b * H + (size_t)hk * G) * D;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int d = tid + j * kThreads;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        ob[(size_t)g * D + d] =
            repro::from_f32<T>(acc[j][g] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* k_pos, void* o, int B,
                   int C, int Hkv, int D, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(G, D);
  auto kernel = flash_decode_kernel<T, G>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<T*>(o), C, Hkv, D, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const void* q_pos, const void* k_pos, void* o, int B,
                       int C, int Hkv, int D, int window, float scale,
                       cudaStream_t stream) {
#define REPRO_G(n) \
  case n:          \
    return launch<T, n>(q, k, v, q_pos, k_pos, o, B, C, Hkv, D, window, scale, stream);
  switch (G) {
    REPRO_G(1) REPRO_G(2) REPRO_G(3) REPRO_G(4)
    REPRO_G(5) REPRO_G(6) REPRO_G(7) REPRO_G(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_G
}

}  // namespace

// q [B, Hkv*G, D], k/v [B, C, Hkv, D], q_pos [B], k_pos [B, C] (int32),
// o [B, Hkv*G, D]; all contiguous.  dtype 0 = float32, 1 = bfloat16.
// window < 0 means no window.  Returns cudaGetLastError() of the launch.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* q_pos, const void* k_pos, void* o,
                            int B, int C, int Hkv, int G, int D, int window,
                            float scale, int dtype, int device,
                            void* stream) {
  if (B < 1 || C < 1 || Hkv < 1 || G < 1 || G > kMaxG || D < 1 || D > kMaxD)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_g<float>(G, q, k, v, q_pos, k_pos, o, B, C, Hkv, D,
                             window, scale, s);
  if (dtype == 1)
    return dispatch_g<__nv_bfloat16>(G, q, k, v, q_pos, k_pos, o, B, C, Hkv,
                                     D, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
