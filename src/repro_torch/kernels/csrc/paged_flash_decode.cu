// Paged flash decode for Hopper (sm_90a): one query token per sequence over
// a KV cache kept in fixed-size pages of a global pool, split across blocks.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py
// ::paged_flash_decode (body _paged_kernel).  Same semantics: q
// [B, Hkv*G, D] against pools k/v [P, page, Hkv, D]; logical slot i of
// row b lives at pool[table[b, i / page], i % page] and is attended iff
// i < lengths[b] (and i < maxp * page) and, with a window,
// i > lengths[b] - 1 - window.  fp32 online softmax, output
// acc / max(l, 1e-30); a row with nothing to attend to gives 0.  Table ids
// are clamped into [0, P-1] here, as the reference wrapper clamps them, so
// a stale id never addresses outside the pool, and the table is never read
// past its maxp entries.
//
// Bound on the H100: HBM bytes.  A step reads each attended slot's K and V
// row once, 2 * Hkv * D elements per slot, against ~4 FLOPs per element:
// far below the ~295 FLOP/byte ridge, so the floor is
// itemsize * D * (2 * B * H + 2 * Hkv * sum_b min(len_b, window)) bytes
// over 3.35 TB/s.
// Design: the split-cache machinery of flash_decode.cu (split_decode.cuh)
// over one more layout.  The TPU walked a sequential grid axis over all
// maxp pages with scalar-prefetched tables and DMA'd every table entry,
// even of pages past the length (hence the null page 0).  Here a row's run
// is only the slots the mask can reach, [lo, end) with
// lo = max(0, len - window) and end = min(len, maxp * page), so no byte of
// a page wholly past the length (or before the window) is read, and the
// n_split blocks of a (row, KV head) cut that run, not the table's width:
// a short row's work is spread over all its splits.  A slot's page id is
// its layout's fetch, read a tile ahead of the copy, so a tile of 16 slots
// may span pages of any size.  bf16 at D = 64, 80 or 128 scores and sums
// on the tensor cores (mma.sync, one group of up to 16 heads, so a page's
// K/V rows are read once for G <= 16), float32 there too (three TF32
// mma.sync of hi / lo splits a product, groups of up to 8), other cases
// on the CUDA cores (groups of up to 8); all stream the pool with cp.async
// several tiles deep and merge the splits in the same launch.  The host
// picks n_split (ops._num_splits) from B, Hkv, the head groups, the blocks
// an SM holds (paged_flash_decode_resident) and the slots a row can reach:
// the table width, or the longest length where the caller knows it on the
// host (the lengths on the card are never read back).
#include "split_decode.cuh"

namespace {

namespace sd = repro::split;

// Slot i of a row's run is logical slot lo + i; its K/V row of head hk is
// ((pid * page + (lo + i) % page) * Hkv + hk) * D.
struct PagedSlots {
  const int* tb;    // table row b
  int P, page, maxp, lo, n;
  long long head, slot_stride;
  __device__ int fetch(int i) const {
    if (i >= n) return 0;          // past the run: the table is not read
    const int pid = __ldg(tb + min((lo + i) / page, maxp - 1));
    return min(max(pid, 0), P - 1);
  }
  __device__ bool attended(int i, int) const { return i < n; }
  __device__ long long offset(int i, int pid) const {
    return ((long long)pid * page + (lo + i) % page) * slot_stride + head;
  }
};

struct PagedRows {
  const int *tables, *lengths;
  int P, page, maxp, Hkv, D, window;
  __device__ PagedSlots at(int b, int hk, int& n) const {
    const int len = lengths[b];
    const int end = min(len, maxp * page);   // the table covers maxp pages
    const int lo = window < 0 ? 0 : max(0, len - window);
    n = max(0, end - lo);
    return PagedSlots{tables + (size_t)b * maxp, P, page, maxp, lo, n,
                      (long long)hk * D, (long long)Hkv * D};
  }
};

}  // namespace

// q [B, Hkv*G, D], k_pages/v_pages [P, page, Hkv, D], tables [B, maxp] and
// lengths [B] (int32), o [B, Hkv*G, D]; all contiguous; any G >= 1.
// dtype 0 = float32, 1 = bfloat16; body and NG (the head groups) as
// flash_decode's (0 = CUDA cores, groups of up to 8 heads; 1 = bf16 tensor
// cores, up to 16; 2 = float32 tensor cores, up to 8).  window < 0 means no
// window.  n_split is at most the tiles of maxp * page slots; with n_split
// > 1, the merge scratch of flash_decode.cu (per head group: part_acc
// float32 [B, Hkv, NG, n_split, Gc, D], part_ml float32 [B, Hkv, NG,
// n_split, Gc, 2] and counters int32 [B * Hkv * NG]), 0 before the launch
// and left 0 by it (shared with flash_decode: launches must run in stream
// order).  Returns cudaGetLastError() of the launch.
extern "C" int paged_flash_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* tables,
                                  const void* lengths, void* o,
                                  void* part_acc, void* part_ml,
                                  void* counters, int B, int P, int page,
                                  int maxp, int Hkv, int G, int NG, int D,
                                  int n_split, int window, float scale,
                                  int dtype, int body, int device,
                                  void* stream) {
  if (B < 1 || P < 1 || page < 1 || maxp < 1 || Hkv < 1 || G < 1 ||
      D < 1 || D > sd::kMaxD || B > 65535 ||
      NG < 1 || (long long)Hkv * NG > 65535 ||
      (long long)maxp * page > (1 << 30) || n_split < 1 ||
      n_split > ((long long)maxp * page + sd::kTile - 1) / sd::kTile ||
      (n_split > 1 && (!part_acc || !part_ml || !counters)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const PagedRows rows{static_cast<const int*>(tables),
                       static_cast<const int*>(lengths), P, page, maxp, Hkv,
                       D, window};
  const sd::Launch a{q, k_pages, v_pages, o, part_acc, part_ml, counters, B,
                     Hkv, G, NG, D, n_split, scale,
                     static_cast<cudaStream_t>(stream), nullptr, body};
  return sd::dispatch_dtype(rows, a, dtype);
}

// As flash_decode_resident (flash_decode.cu), for the kernel
// paged_flash_decode would launch: the blocks of it one SM holds at once.
extern "C" int paged_flash_decode_resident(int G, int NG, int D, int dtype,
                                           int body, int aligned, int device,
                                           int* blocks) {
  if (!blocks || G < 1 || NG < 1 || D < 1 || D > sd::kMaxD)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  sd::Launch a{};
  a.B = a.Hkv = a.n_split = 1;
  a.G = G, a.NG = NG, a.D = D, a.body = body;
  a.resident = blocks, a.aligned = aligned != 0;
  return sd::dispatch_dtype(PagedRows{}, a, dtype);
}

extern "C" const char* paged_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
