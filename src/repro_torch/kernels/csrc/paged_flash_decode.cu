// Paged flash decode for Hopper (sm_90a): one query token per sequence over
// a KV cache kept in fixed-size pages of a global pool.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py
// ::paged_flash_decode (body _paged_kernel).  Same semantics: q
// [B, Hkv*G, D] against pools k/v [P, page, Hkv, D]; logical slot i of
// row b lives at pool[table[b, i / page], i % page] and is attended iff
// i < lengths[b] (and i < maxp * page) and, with a window,
// i > lengths[b] - 1 - window.  fp32 online softmax, output
// acc / max(l, 1e-30); a row with nothing to attend to gives 0.  Table ids
// are clamped into [0, P-1] here, as the reference wrapper clamps them, so
// a stale id never addresses outside the pool.
//
// Bound on the H100: HBM bytes.  A step reads each attended slot's K and V
// row once, 2 * Hkv * D elements per slot, against ~4 FLOPs per element:
// far below the ~295 FLOP/byte ridge, so the floor is
// itemsize * D * (2 * B * H + 2 * Hkv * sum_b min(len_b, window)) bytes
// over 3.35 TB/s.
// Design: the TPU walked a sequential grid axis over all maxp pages with
// scalar-prefetched tables and DMA'd every table entry, even of pages past
// the length (hence the null page 0).  Here one block per (KV head, row)
// loads its own length and table row and loops over only the slots the
// mask can reach, from the window's first slot to min(len, maxp * page):
// no byte of a page wholly past the length (or before the window) is read.
// Each tile of kTile logical slots is staged through shared memory with the
// slot -> (page, offset) lookup done once per slot, so a tile may span a
// page boundary and any page size works.  The G query heads of the group
// score against each staged tile, so the pool is read once per step for
// the whole group (the GQA saving, as in flash_decode.cu, whose tile loop
// this kernel shares through decode_tile.cuh).  Not yet fast: B * Hkv
// blocks (64 at B=32, Hkv=2) under-fill the 132 SMs and tiles are staged
// synchronously; a split over pages with a reduce pass and cp.async/TMA
// double buffering are the next steps.
#include "decode_tile.cuh"

namespace {

namespace dec = repro::decode;

template <typename T, int G>
__global__ void __launch_bounds__(dec::kThreads)
paged_flash_decode_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int* __restrict__ tables,
                          const int* __restrict__ lengths,
                          T* __restrict__ o, int P, int page, int maxp,
                          int Hkv, int D, int window, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int H = Hkv * G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const dec::Smem s = dec::carve(smem_raw, G, D);

  float acc[dec::kJ][G];
  const size_t head0 = ((size_t)b * H + (size_t)hk * G) * D;
  dec::load_q<T, G>(s, q + head0, D, scale, acc);

  const int len = lengths[b];
  const int end = min(len, maxp * page);      // the table covers maxp pages
  const int lo = window < 0 ? 0 : max(0, len - window);
  const int* tb = tables + (size_t)b * maxp;
  const long long slot_stride = (long long)Hkv * D;

  for (int c0 = lo; c0 < end; c0 += dec::kTile) {
    __syncthreads();   // the previous tile is consumed; q/m/l are ready
    if (tid < dec::kTile) {
      const int slot = c0 + tid;
      const bool ok = slot < end;
      s.ok[tid] = ok;
      if (ok) {
        const int pid = min(max(tb[slot / page], 0), P - 1);
        s.off[tid] = ((long long)pid * page + slot % page) * slot_stride +
                     (long long)hk * D;
      }
    }
    __syncthreads();
    dec::stage_rows(s, k_pages, v_pages, D);
    __syncthreads();
    dec::attend_tile<G>(s, D, acc);
  }
  dec::store_out<T, G>(s, o + head0, D, acc);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* tables, const void* lengths, void* o, int B,
                   int P, int page, int maxp, int Hkv, int G, int D,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = dec::smem_bytes(G, D);
  return dec::with_group(G, [&](auto g) {
    auto kernel = paged_flash_decode_kernel<T, decltype(g)::value>;
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(Hkv, B), dec::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), static_cast<const int*>(tables),
        static_cast<const int*>(lengths), static_cast<T*>(o), P, page, maxp,
        Hkv, D, window, scale);
    return cudaGetLastError();
  });
}

}  // namespace

// q [B, Hkv*G, D], k_pages/v_pages [P, page, Hkv, D], tables [B, maxp] and
// lengths [B] (int32), o [B, Hkv*G, D]; all contiguous.  dtype 0 = float32,
// 1 = bfloat16.  window < 0 means no window.  Returns cudaGetLastError() of
// the launch.
extern "C" int paged_flash_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* tables,
                                  const void* lengths, void* o, int B, int P,
                                  int page, int maxp, int Hkv, int G, int D,
                                  int window, float scale, int dtype,
                                  int device, void* stream) {
  if (B < 1 || P < 1 || page < 1 || maxp < 1 || Hkv < 1 || G < 1 ||
      G > dec::kMaxG || D < 1 || D > dec::kMaxD)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tables, lengths, o, B, P, page,
                         maxp, Hkv, G, D, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, lengths, o, B,
                                 P, page, maxp, Hkv, G, D, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
