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
// Design (split_decode.cuh): the grid is (n_split, Hkv * NG, B), so a step
// fills the 132 SMs even at small B * Hkv (ops._num_splits picks n_split);
// each block streams its run of the cache in 16-byte cp.async pieces,
// several tiles deep, with the G query heads of the group on chip, so K and
// V are read from HBM once per step for all G heads of a group, and the
// splits merge in the same launch (last-block ticket).  bf16 at D = 64, 80
// or 128 scores and sums on the tensor cores (mma.sync, up to 16 heads as
// the rows of an m16 tile: one group, one read of the cache, for G <= 16);
// float32 there likewise, each product three TF32 mma.sync of hi / lo
// splits, in groups of up to 8 heads; other D on the CUDA cores, in groups
// of up to 8 heads.  The
// TPU's sequential cache axis becomes the split's tile loop, and its VMEM
// (acc, m, l) carry becomes registers.  A slot's position is read before its row, and a slot that
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

// Every row's run is its whole cache of C slots.
struct DenseRows {
  const int *q_pos, *k_pos;
  int C, Hkv, D, window;
  __device__ DenseSlots at(int b, int hk, int& n) const {
    n = C;
    return DenseSlots{k_pos + (size_t)b * C, C, q_pos[b], window,
                      ((long long)b * C * Hkv + hk) * D, (long long)Hkv * D};
  }
};

}  // namespace

// q [B, Hkv*G, D], k/v [B, C, Hkv, D], q_pos [B], k_pos [B, C] (int32),
// o [B, Hkv*G, D]; all contiguous; any G >= 1.  lse, when not null,
// float32 [B, Hkv*G]: each head's natural-log sum of exp(scale * q.k) over
// the slots it attended, -1e30 where none (a caller that attends one
// row's cache in several launches, e.g. a context split over ranks,
// merges their outputs by it).  dtype 0 = float32,
// 1 = bfloat16.  body 0 = the CUDA-core body, 1 = the bf16 tensor-core
// body, 2 = the float32 one (3xTF32); both tensor-core bodies at D 64 / 80
// / 128 with 16-byte aligned k, v and 4-byte aligned q, refused otherwise.
// NG: the head groups, Gc = ceil(G / NG) heads each, chosen by the caller
// (decode_attention/ops.py::_head_groups; at most 16 heads a group on the
// bf16 tensor-core body, 8 on the others, refused otherwise).  window < 0
// means no window.  With n_split > 1: part_acc float32
// [B, Hkv, NG, n_split, Gc, D], part_ml float32 [B, Hkv, NG, n_split, Gc, 2]
// and counters int32 [B * Hkv * NG], all 0 before the first launch (each
// launch leaves them 0); launches sharing counters must run in stream
// order.
// Returns cudaGetLastError() of the launch.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* q_pos, const void* k_pos, void* o,
                            void* lse, void* part_acc, void* part_ml,
                            void* counters,
                            int B, int C, int Hkv, int G, int NG, int D,
                            int n_split,
                            int window, float scale, int dtype, int body,
                            int device, void* stream) {
  const int n_tiles = (C + sd::kTile - 1) / sd::kTile;
  if (B < 1 || C < 1 || Hkv < 1 || G < 1 || D < 1 || D > sd::kMaxD ||
      n_split < 1 || n_split > n_tiles || B > 65535 ||
      NG < 1 || (long long)Hkv * NG > 65535 ||
      (n_split > 1 && (!part_acc || !part_ml || !counters)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const DenseRows rows{static_cast<const int*>(q_pos),
                       static_cast<const int*>(k_pos), C, Hkv, D, window};
  const sd::Launch a{q, k, v, o, part_acc, part_ml, counters, B, Hkv, G, NG,
                     D, n_split, scale, static_cast<cudaStream_t>(stream), lse,
                     body};
  return sd::dispatch_dtype(rows, a, dtype);
}

// The blocks of the kernel flash_decode would launch for these arguments
// (body, dtype, D, G in NG head groups; aligned: k and v 16-byte aligned
// and q 4-byte aligned) that one SM of the device holds at once, written
// to *blocks; nothing is launched.  ops._num_splits counts a launch's
// blocks against them.  Refused as flash_decode would refuse the launch.
extern "C" int flash_decode_resident(int G, int NG, int D, int dtype,
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
  return sd::dispatch_dtype(DenseRows{}, a, dtype);
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
