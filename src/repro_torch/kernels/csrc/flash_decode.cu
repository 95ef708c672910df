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
// memory.  The tile loop's device code is shared with the paged kernel
// (decode_tile.cuh); this file says which slots a tile holds and which of
// them the positions let through (only those are read).  Not yet fast:
// B * Hkv blocks (64 at B=32, Hkv=2) under-fill the 132 SMs, and a tile
// is staged synchronously.  A split over C with a
// second reduce pass (flash-decoding) and cp.async/TMA double buffering
// are the next steps.
#include "decode_tile.cuh"

namespace {

using repro::kEmptyPos;
namespace dec = repro::decode;

template <typename T, int G>
__global__ void __launch_bounds__(dec::kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, T* __restrict__ o, int C,
                    int Hkv, int D, int window, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int H = Hkv * G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const dec::Smem s = dec::carve(smem_raw, G, D);

  float acc[dec::kJ][G];
  const size_t head0 = ((size_t)b * H + (size_t)hk * G) * D;
  dec::load_q<T, G>(s, q + head0, D, scale, acc);

  const int qp = q_pos[b];
  const size_t slot_stride = (size_t)Hkv * D;
  const size_t row0 = (size_t)b * C * slot_stride + (size_t)hk * D;
  const int* kpb = k_pos + (size_t)b * C;

  for (int c0 = 0; c0 < C; c0 += dec::kTile) {
    __syncthreads();   // the previous tile is consumed; q/m/l are ready
    // slot c0 + tid is attended iff its position passes the masks
    if (tid < dec::kTile) {
      const int slot = c0 + tid;
      const int kp = slot < C ? kpb[slot] : kEmptyPos;
      s.ok[tid] = kp >= 0 && kp <= qp && (window < 0 || kp > qp - window);
      s.off[tid] = (long long)(row0 + (size_t)slot * slot_stride);
    }
    __syncthreads();
    dec::stage_rows(s, k, v, D);
    __syncthreads();
    dec::attend_tile<G>(s, D, acc);
  }
  dec::store_out<T, G>(s, o + head0, D, acc);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* k_pos, void* o, int B,
                   int C, int Hkv, int G, int D, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = dec::smem_bytes(G, D);
  return dec::with_group(G, [&](auto g) {
    auto kernel = flash_decode_kernel<T, decltype(g)::value>;
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(Hkv, B), dec::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(q_pos),
        static_cast<const int*>(k_pos), static_cast<T*>(o), C, Hkv, D,
        window, scale);
    return cudaGetLastError();
  });
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
  if (B < 1 || C < 1 || Hkv < 1 || G < 1 || G > dec::kMaxG || D < 1 ||
      D > dec::kMaxD)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, q_pos, k_pos, o, B, C, Hkv, G, D, window,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, q_pos, k_pos, o, B, C, Hkv, G, D,
                                 window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
