// Flash decode for Hopper (sm_90a): one query token per row over a dense
// KV cache, split across blocks.
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
// Design (split_decode.cuh): the grid is (n_split, Hkv, B), so a step fills
// the 132 SMs even at small B * Hkv (ops._num_splits picks n_split); each
// block streams its run of the cache in 16-byte cp.async pieces, several
// tiles deep, with the G query heads of the group on chip, so K and V are
// read from HBM once per step for all G heads; the splits merge in the
// same launch (last-block ticket).  bf16 at D = 64 or 128 scores and sums
// on the tensor cores (mma.sync, the heads as the rows of an m16 tile);
// float32 and other D on the CUDA cores.  The TPU's sequential cache axis
// becomes the split's tile loop, and its VMEM (acc, m, l) carry becomes
// registers.  A slot's position is read before its row, and a slot that
// is not attended is never read.
#include "split_decode.cuh"

namespace {

using repro::kEmptyPos;
namespace sd = repro::split;

// The dense cache: slot c of row b sits at ((b * C + c) * Hkv + hk) * D,
// attended by its position.
struct DenseSlots {
  const int* kpb;   // k_pos of row b
  int C, qp, window;
  long long row0, slot_stride;
  __device__ int fetch(int slot) const {
    return slot < C ? __ldg(kpb + slot) : kEmptyPos;
  }
  __device__ bool attended(int, int kp) const {
    return kp >= 0 && kp <= qp && (window < 0 || kp > qp - window);
  }
  __device__ long long offset(int slot, int) const {
    return row0 + slot * slot_stride;
  }
};

template <int D>
__global__ void __launch_bounds__(sd::kThreads)
flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml,
                        int* __restrict__ counters, int C, int Hkv, int G,
                        int window, float scale_log2) {
  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  extern __shared__ __align__(16) unsigned char smem[];
  const DenseSlots lay{k_pos + (size_t)b * C, C, q_pos[b], window,
                       ((long long)b * C * Hkv + hk) * D,
                       (long long)Hkv * D};
  const size_t bh = (size_t)b * Hkv + hk;
  const size_t head0 = bh * G * D;
  sd::decode_block_mma<D>(lay, k, v, q + head0, o + head0,
                          part_acc + bh * n_split * G * D,
                          part_ml + bh * n_split * G * 2, counters + bh, C,
                          G, scale_log2, split, n_split, smem);
}

template <typename T, int G, int VEC, int NC, bool WIDE>
__global__ void __launch_bounds__(sd::kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, T* __restrict__ o,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ counters, int C, int Hkv, int D, int W,
                    int window, float scale_log2) {
  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  extern __shared__ __align__(16) unsigned char smem[];
  const DenseSlots lay{k_pos + (size_t)b * C, C, q_pos[b], window,
                       ((long long)b * C * Hkv + hk) * D,
                       (long long)Hkv * D};
  const size_t bh = (size_t)b * Hkv + hk;
  const size_t head0 = bh * G * D;
  sd::decode_block<T, G, VEC, NC, WIDE>(
      lay, k, v, q + head0, o + head0, part_acc + bh * n_split * G * D,
      part_ml + bh * n_split * G * 2, counters + bh, C, D, W, scale_log2,
      split, n_split, smem);
}

template <typename T, int VEC, int NC, bool WIDE = false>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* k_pos, void* o,
                   void* part_acc, void* part_ml, void* counters, int B,
                   int C, int Hkv, int G, int D, int W, int n_split,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = sd::core_smem_bytes(sizeof(T), G, D, W);
  return sd::with_group(G, [&](auto g) {
    auto kernel = flash_decode_kernel<T, decltype(g)::value, VEC, NC, WIDE>;
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(n_split, Hkv, B), sd::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(q_pos),
        static_cast<const int*>(k_pos), static_cast<T*>(o),
        static_cast<float*>(part_acc), static_cast<float*>(part_ml),
        static_cast<int*>(counters), C, Hkv, D, W, window,
        scale * sd::kLog2e);
    return cudaGetLastError();
  });
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* q_pos, const void* k_pos, void* o,
                       void* part_acc, void* part_ml, void* counters, int B,
                       int C, int Hkv, int G, int n_split, int window,
                       float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = sd::mma_smem_bytes(G, D);
  auto kernel = flash_decode_mma_kernel<D>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_split, Hkv, B), sd::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<bf16*>(o),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), C, Hkv, G, window, scale * sd::kLog2e);
  return cudaGetLastError();
}

// bf16 at D = 64 or 128 on the tensor cores; otherwise the CUDA cores,
// with 16-byte pieces where D and the cache's alignment allow them and a
// row fits 32 lanes, one element a piece where not.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* q_pos, const void* k_pos, void* o,
                     void* part_acc, void* part_ml, void* counters, int B,
                     int C, int Hkv, int G, int D, int n_split, int window,
                     float scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (aligned && reinterpret_cast<uintptr_t>(q) % 4 == 0) {
      if (D == 64)
        return launch_mma<64>(q, k, v, q_pos, k_pos, o, part_acc, part_ml,
                              counters, B, C, Hkv, G, n_split, window, scale,
                              stream);
      if (D == 128)
        return launch_mma<128>(q, k, v, q_pos, k_pos, o, part_acc, part_ml,
                               counters, B, C, Hkv, G, n_split, window,
                               scale, stream);
    }
  }
  if (aligned && D == 32 * kVec)
    return launch<T, kVec, 1, true>(q, k, v, q_pos, k_pos, o, part_acc,
                                    part_ml, counters, B, C, Hkv, G, D, 32,
                                    n_split, window, scale, stream);
  if (aligned && D % kVec == 0 && D / kVec <= 32)
    return launch<T, kVec, 1>(q, k, v, q_pos, k_pos, o, part_acc, part_ml,
                              counters, B, C, Hkv, G, D,
                              sd::lanes_per_row(D / kVec), n_split, window,
                              scale, stream);
  return launch<T, 1, sd::kMaxD / 32>(q, k, v, q_pos, k_pos, o, part_acc,
                                      part_ml, counters, B, C, Hkv, G, D,
                                      sd::lanes_per_row(D), n_split, window,
                                      scale, stream);
}

}  // namespace

// q [B, Hkv*G, D], k/v [B, C, Hkv, D], q_pos [B], k_pos [B, C] (int32),
// o [B, Hkv*G, D]; all contiguous.  dtype 0 = float32, 1 = bfloat16.
// window < 0 means no window.  With n_split > 1: part_acc float32
// [B, Hkv, n_split, G, D], part_ml float32 [B, Hkv, n_split, G, 2] and
// counters int32 [B * Hkv], all 0 before the first launch (each launch
// leaves them 0); launches sharing counters must run in stream order.
// Returns cudaGetLastError() of the launch.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* q_pos, const void* k_pos, void* o,
                            void* part_acc, void* part_ml, void* counters,
                            int B, int C, int Hkv, int G, int D, int n_split,
                            int window, float scale, int dtype, int device,
                            void* stream) {
  const int n_tiles = (C + sd::kTile - 1) / sd::kTile;
  if (B < 1 || C < 1 || Hkv < 1 || G < 1 || G > sd::kMaxG || D < 1 ||
      D > sd::kMaxD || n_split < 1 || n_split > n_tiles || B > 65535 ||
      Hkv > 65535 ||
      (n_split > 1 && (!part_acc || !part_ml || !counters)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, q_pos, k_pos, o, part_acc, part_ml,
                           counters, B, C, Hkv, G, D, n_split, window, scale,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, q_pos, k_pos, o, part_acc,
                                   part_ml, counters, B, C, Hkv, G, D,
                                   n_split, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
