// Flash-attention forward on the Hopper tensor cores (sm_90a), bf16,
// head dim 64, 80 or 128: causal / sliding-window / GQA attention over
// contiguous positions (prefill and training forward).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// ::flash_attention_fwd (body _fwd_kernel) for bf16 at D in {64, 80, 128};
// the fp32 CUDA-core kernel (flash_attention_fwd.cu) keeps float32 and
// every other D.  Same semantics: query row i and key row j sit at absolute
// positions i and j (not right-aligned when Sq != Sk); j is attended iff
// j < Sk, j <= i when causal, and j > i - window with a window.  Query
// head h reads KV head h / G.  fp32 online softmax; p is rounded to bf16
// before P.V, as the reference casts p to v's dtype; a row with nothing to
// attend to gives 0.
//
// Bound on the H100: tensor-core FLOPs at long S (989 TFLOP/s dense bf16),
// HBM bytes at the short prefill shapes.  Design:
// - GQA packing.  A block serves one (batch row, KV head) and 128 packed
//   rows: packed row R is (position R / G, head hk*G + R % G), so the G
//   heads of one position, contiguous in [B, S, H, D], sit in adjacent
//   rows.  Each K/V tile is read once for the whole group, and short
//   prompts fill the rows (6 x 33 = 198 rows in two blocks at G = 6).
// - Warp specialisation.  Warp 8 is the producer: one thread keeps a ring
//   of kStages K/V tiles in flight with TMA (4-d tensor maps over
//   [B, Sk, Hkv, D], 128-byte swizzle, zero fill past Sk) and mbarriers.
//   Warpgroups 0 and 1 each own 64 rows: S = Q K^T by wgmma m64n64k16 with
//   Q and K in shared memory, the online softmax in fp32 registers (exp2
//   with log2(e) folded into the scale), then O += P V by wgmma with P as
//   the register A operand and V as the MN-major B operand.  The two
//   warpgroups' softmax and products interleave on the SM.
// - Skips.  The k-tile range of a block is the union over its positions
//   (from the window's first tile to the causal diagonal), and only tiles
//   that straddle the diagonal, the window edge or Sk are masked.
// - D = 80 (h2o-danube) is padded to two 64-column chunks in shared
//   memory only, as the reference's wrapper pads D to 128 in HBM: the
//   tensor maps keep the true extent, so TMA reads 80 columns a row and
//   fills columns 80..127 of each K/V tile with zeros; Q's padded pieces
//   are written as zeros; Q K^T runs only the 5 k16 steps of real
//   columns; P V runs both 64-wide chunks and the store drops columns
//   past D.
#include <cuda.h>

#include <initializer_list>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::kNegInf;
namespace sm = repro::sm90;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;            // packed rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kStages = 3;          // K/V tiles in flight
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = kConsumers + 32;
constexpr int kSub = 64;            // bf16 columns per 128-byte swizzle row
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static_assert(D % 16 == 0, "whole k16 steps of Q K^T");
  static constexpr int kChunks = (D + kSub - 1) / kSub;  // 128-byte columns
  static constexpr int kQSub = kBM * 128;              // bytes per Q chunk
  static constexpr int kKSub = kBK * 128;              // bytes per K chunk
  static constexpr int kQ = kQSub * kChunks;
  static constexpr int kKV = kKSub * kChunks;          // one K (or V) tile
  static constexpr int kBytes = kQ + 2 * kStages * kKV + 1024;  // + align
};

// First key tile and number of key tiles of the block whose packed rows
// cover positions [p_lo, p_hi]; mirrored by ops._tile_plan.
struct KRange {
  int lo, n;
};
__device__ __forceinline__ KRange k_range(int p_lo, int p_hi, int Sk,
                                          int causal, int window) {
  const int hi = causal ? min(Sk, p_hi + 1) : Sk;
  int lo = window >= 0 ? max(0, p_lo - window + 1) : 0;
  lo = (lo / kBK) * kBK;
  return {lo, hi > lo ? (hi - lo + kBK - 1) / kBK : 0};
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const bf16* __restrict__ q, bf16* __restrict__ o, int Sq,
               int Sk, int H, int Hkv, int G, int causal, int window,
               float scale_log2) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + L::kQ;
  unsigned char* v_s = k_s + kStages * L::kKV;

  // heaviest row tiles (latest positions) first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G, r0 = tile * kBM;
  const int p_lo = r0 / G, p_hi = (min(r0 + kBM, rows) - 1) / G;
  const KRange kr = k_range(p_lo, p_hi, Sk, causal, window);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], kConsumers);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      for (int t = 0; t < kr.n; ++t) {
        const int s = t % kStages;
        sm::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        sm::mbar_expect_tx(&full[s], 2 * L::kKV);
        const int k0 = kr.lo + t * kBK;
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          sm::tma_load_4d(k_s + s * L::kKV + c * L::kKSub, &tm_k, &full[s],
                          c * kSub, hk, k0, b);
          sm::tma_load_4d(v_s + s * L::kKV + c * L::kKSub, &tm_v, &full[s],
                          c * kSub, hk, k0, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp / 4, tid = threadIdx.x % 128, w = warp % 4;
  const size_t q_stride = (size_t)H * D;

  // Q: this warpgroup's 64 packed rows, 16-byte pieces, written in the
  // 128-byte-swizzled layout (piece c of row r at c ^ (r % 8)); pieces
  // past D pad the last chunk with zeros (shared memory is not cleared)
  constexpr int kPieces = L::kChunks * 8;
  for (int i = tid; i < 64 * kPieces; i += 128) {
    const int rr = i / kPieces, pc = i % kPieces;
    const int row = wg * 64 + rr, R = r0 + row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (R < rows && pc < D / 8) {
      const bf16* src = q + ((size_t)b * Sq + R / G) * q_stride +
                        (size_t)(hk * G + R % G) * D + pc * 8;
      val = __ldg(reinterpret_cast<const uint4*>(src));
    }
    unsigned char* dst = q_s + (pc / 8) * L::kQSub + row * 128 +
                         (((pc % 8) ^ (row % 8)) * 16);
    *reinterpret_cast<uint4*>(dst) = val;
  }
  sm::fence_proxy_async();
  sm::named_sync(1 + wg, 128);

  // this thread's two rows of the m64 accumulator layout
  const int row0 = wg * 64 + w * 16 + lane / 4;
  const int qpos[2] = {(r0 + row0) / G, (r0 + row0 + 8) / G};
  const int col = 2 * (lane % 4);

  float acc[L::kChunks][32];
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const unsigned char* q_wg = q_s + wg * 64 * 128;
  for (int t = 0; t < kr.n; ++t) {
    const int s = t % kStages, k0 = kr.lo + t * kBK;
    const unsigned char* kt = k_s + s * L::kKV;
    const unsigned char* vt = v_s + s * L::kKV;
    sm::mbar_wait(&full[s], (t / kStages) & 1);

    // S = Q K^T over the true D in k16 steps (32 bytes within a 128-byte
    // row); the padded columns are never read
    constexpr int kS = kBK / 2;       // scores a thread holds
    float sc[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) sc[i] = 0.f;
    sm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 2;   // descriptor units of 16 B
      sm::wgmma_m64n64k16_ss(sc, sm::desc_sw128(q_wg + c * L::kQSub) + off,
                             sm::desc_sw128(kt + c * L::kKSub) + off,
                             kk > 0);
    }
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_operands(sc);

    // masks, only on tiles that straddle Sk, the diagonal or the window
    const bool full_tile = k0 + kBK <= Sk &&
                           (!causal || k0 + kBK - 1 <= p_lo) &&
                           (window < 0 || k0 > p_hi - window);
    if (!full_tile) {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int kp = k0 + 8 * (i / 4) + col + (i & 1);
        const int qp = qpos[(i / 2) & 1];
        const bool ok = kp < Sk && (!causal || kp <= qp) &&
                        (window < 0 || kp > qp - window);
        if (!ok) sc[i] = kNegInf;
      }
    }

    // online softmax; row h of this thread holds sc[4j + 2h + {0, 1}], and
    // a row's kBK scores are spread over the 4 lanes of a quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float corr = exp2f((m[h] - m_new) * scale_log2);
      const float neg = -m_new * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          // everything masked so far: exp(NEG - NEG) = 1 must not count
          x = m_new == kNegInf ? 0.f : exp2f(fmaf(x, scale_log2, neg));
          sum += x;
        }
      l[h] = l[h] * corr + sum;
      m[h] = m_new;
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[c][4 * j + 2 * h] *= corr;
          acc[c][4 * j + 2 * h + 1] *= corr;
        }
    }

    // P as the A fragment of k16 step kk: the accumulator columns
    // 16kk..16kk+15 are sc[8kk .. 8kk+7] in exactly that fragment order
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = sm::pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

    // O += P V: V rows are keys (the K dimension), columns are D (MN-major)
    sm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        sm::wgmma_m64n64k16_rs_tb(
            acc[c], pa[kk], sm::desc_sw128(vt + c * L::kKSub + kk * 16 * 128));
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) sm::fence_operands(acc[c]);
    sm::mbar_arrive(&empty[s]);
  }

  // epilogue: O / l, straight from the accumulator to [B, Sq, H, D];
  // the padded columns (past D) are not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const float inv = 1.f / fmaxf(lh, 1e-30f);
    const int R = r0 + row0 + 8 * h;
    if (R >= rows) continue;
    bf16* dst = o + ((size_t)b * Sq + R / G) * q_stride +
                (size_t)(hk * G + R % G) * D + col;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c * kSub + 8 * j < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + c * kSub + 8 * j) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * h] * inv,
                                    acc[c][4 * j + 2 * h + 1] * inv);
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of k or v [B, Sk, Hkv, D] bf16: boxes of kBK rows x 64
// columns of one (b, hk), 128-byte swizzle, zeros past Sk and, at D = 80,
// past column D in the second box (the extent is the true D, so the box
// never reads the next KV head's columns).
bool kv_map(CUtensorMap* map, EncodeTiled encode, const void* base, int B,
            int Sk, int Hkv, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv,
                              (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)Sk * Hkv * D * 2};
  const cuuint32_t box[4] = {kSub, 1, kBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_k, tm_v;
  if (!kv_map(&tm_k, encode, k, B, Sk, Hkv, D) ||
      !kv_map(&tm_v, encode, v, B, Sk, Hkv, D))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_sm90<D>;
  cudaError_t err = repro::allow_smem(kernel, Layout<D>::kBytes);
  if (err != cudaSuccess) return err;
  const int G = H / Hkv;
  const dim3 grid((Sq * G + kBM - 1) / kBM, Hkv, B);
  kernel<<<grid, kThreads, Layout<D>::kBytes, stream>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), static_cast<bf16*>(o), Sq, Sk,
      H, Hkv, G, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q/o [B, Sq, H, D], k/v [B, Sk, Hkv, D]; bfloat16, contiguous, 16-byte
// aligned; D = 64, 80 or 128.  window < 0 means no window.  Returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, void* o, int B, int Sq,
                                        int Sk, int H, int Hkv, int D,
                                        int causal, int window, float scale,
                                        int device, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || B > 65535 ||
      Hkv > 65535 || (D != 64 && D != 80 && D != 128))
    return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale,
                      s);
  if (D == 80)
    return launch<80>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale,
                      s);
  return launch<128>(q, k, v, o, B, Sq, Sk, H, Hkv, causal, window, scale, s);
}

extern "C" const char* flash_attention_fwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
