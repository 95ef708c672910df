// Flash-attention forward on the Hopper tensor cores in float32 (sm_90a),
// head dim 64, 80 or 128: causal / sliding-window / GQA attention over
// contiguous positions (prefill and training forward).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// ::flash_attention_fwd (body _fwd_kernel) for float32 at D in {64, 80,
// 128}; bf16 at those D goes to flash_attention_fwd_sm90.cu, every other D
// to the CUDA-core kernel flash_attention_fwd.cu (ops._variant).  Same
// semantics: query row i and key row j sit at absolute positions i and j
// (not right-aligned when Sq != Sk); j is attended iff j < Sk, j <= i when
// causal, and j > i - window with a window.  Query head h reads KV head
// h / G.  The scale is 1/sqrt(D) of the true D; fp32 online softmax; a row
// with nothing to attend to gives 0.
//
// Why 3xTF32 and not TF32.  float32 is held to the reference's 2e-5.  One
// TF32 product keeps 11 bits of each operand and misses that
// (tests/test_torch_flash_tf32x3.py emulates both on a CPU against the
// JAX reference: the split holds 2e-5, one product does not).  Here every
// float32 operand is split in registers as x = hi + lo, hi = tf32(x),
// lo = tf32(x - hi) (cvt.rna), and every product is lo(a) hi(b) +
// hi(a) lo(b) + hi(a) hi(b),
// three mma.sync.m16n8k8.tf32 with fp32 accumulation: the dropped
// lo(a) lo(b) is 2^-22 of the product.  Both products use it, P split as
// well as Q, K, V; no single-TF32 product and no bf16 operand is in this
// kernel.
//
// Bound on the H100: 3xTF32 operations past a few hundred tokens, three
// TF32 products per float32 product at 495 TFLOP/s, so 165 TFLOP/s of
// attention FLOPs (causal 4*B*H*Sq*Sk*D / 2); HBM bytes below that (each
// of q, k, v read once and o written once, at 3.35 TB/s).  Design:
// - GQA packing, as the bf16 kernel: a block serves one (batch row, KV
//   head) and kBM packed rows, packed row R being (position R / G, head
//   hk*G + R % G); each K/V tile is read once for all G heads of the group.
// - A cp.async ring: 16-byte copies stage Q once and kStages K/V tiles of
//   kBK keys (zeros past Sk), kStages - 1 tiles ahead of the products, so
//   the next tile's loads overlap this tile's mma.
// - Four warps of 16 rows each, m16n8k8 tiles, fragments straight from
//   shared memory as 16- and 8-byte loads.  A product's k index and O's
//   columns may be taken in any order, so lane (g, t4) reads contiguous
//   runs: in S = Q K^T the two k8 steps of 16 head dims take dims 4t4,
//   4t4 + 1 and 4t4 + 2, 4t4 + 3 as k = t4, t4 + 4 (one float4 of a Q or
//   K row); in O += P V the k index is the keys the S accumulator gives
//   the lane (2t4, 2t4 + 1 of each 8: P goes from the accumulator into
//   the A fragment as it is), and column g of n8 tiles 2m, 2m + 1 is dims
//   16m + 2g, + 1 (one float2 of a V row), so a lane's O holds dims
//   16m + 4t4 .. + 3 (one float4 store).  Rows are padded so those loads
//   hit every bank once: Q and K rows to a length of 16 mod 32 floats, V
//   rows to D + 4, 4 mod 16.
// - Rounding: S keeps the two small products in their own accumulator,
//   and each tile's P V is summed from zero and then folded into O by one
//   fp32 fma with the softmax correction, so no accumulator carries a long
//   run of tensor-core additions (the mma adds are not rounded to nearest;
//   chip_smoke.py holds the result to the plain version at 2e-5 up to
//   S = 4200).
// - Skips: a block walks only the key tiles from the window's first to
//   the causal diagonal of its last position, and masks only the tiles
//   that straddle Sk, the diagonal or the window edge (ops._tile_plan with
//   this kernel's TF32_ROWS, TF32_KEYS).  Heaviest row tiles start first.
// - Shared memory at D = 128: Q 36 KB + 2 stages of K and V 69 KB, so two
//   blocks (8 warps) share an SM; D <= 80 takes 3 stages.
// - D = 80 (h2o-danube) is 5 steps of 16: no padding of the head dim.
#include <initializer_list>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::kNegInf;
namespace sm = repro::sm90;

constexpr int kBM = 64;             // packed rows per block
constexpr int kBK = 32;             // keys per tile
constexpr int kWarps = kBM / 16;    // each warp owns 16 rows
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static_assert(D % 16 == 0, "whole pairs of k8 steps");
  static constexpr int kLdK = D + (48 - D % 32) % 32;  // Q, K rows: 16 mod 32
  static constexpr int kLdV = D + 4;                   // V rows: 4 mod 16
  static constexpr int kStages = D <= 80 ? 3 : 2;
  static constexpr int kQ = kBM * kLdK;       // floats
  static constexpr int kK = kBK * kLdK;       // one K tile, floats
  static constexpr int kStage = kK + kBK * kLdV;  // K and V of one tile
  static constexpr size_t kBytes =
      sizeof(float) * (size_t)(kQ + kStages * kStage);
};

// First key and number of key tiles of the block whose packed rows cover
// positions [p_lo, p_hi]; mirrored by ops._tile_plan.
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

// 16 bytes from global to shared memory, or 16 zero bytes (nothing read)
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool copy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm::smem_u32(dst)),
               "l"(src), "r"(copy ? 16 : 0)
               : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int H, int Hkv, int G, int causal, int window,
                 float scale_log2) {
  using L = Layout<D>;
  constexpr int kLdK = L::kLdK, kLdV = L::kLdV, S = L::kStages;
  constexpr int kPieces = D / 4;     // 16-byte pieces a row
  extern __shared__ float4 smem_v4[];
  float* q_s = reinterpret_cast<float*>(smem_v4);   // [kBM][kLdK]
  float* kv_s = q_s + L::kQ;         // S x (K [kBK][kLdK], V [kBK][kLdV])

  // heaviest row tiles (latest positions) first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rows = Sq * G, r0 = tile * kBM;
  const int p_lo = r0 / G, p_hi = (min(r0 + kBM, rows) - 1) / G;
  const KRange kr = k_range(p_lo, p_hi, Sk, causal, window);
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hkv * D;
  const float* kb = k + (size_t)b * Sk * kv_stride + (size_t)hk * D;
  const float* vb = v + (size_t)b * Sk * kv_stride + (size_t)hk * D;

  // Q: the block's packed rows, zeros past the last row
  for (int i = threadIdx.x; i < kBM * kPieces; i += kThreads) {
    const int rr = i / kPieces, pc = i % kPieces, R = r0 + rr;
    const bool in = R < rows;
    const float* src =
        q + ((size_t)b * Sq + (in ? R / G : 0)) * q_stride +
        (size_t)(hk * G + (in ? R % G : 0)) * D + pc * 4;
    copy16(q_s + rr * kLdK + pc * 4, src, in);
  }
  // K and V rows of tile t into stage s, zeros past Sk
  auto load_kv = [&](int t, int s) {
    const int k0 = kr.lo + t * kBK;
    float* ks = kv_s + s * L::kStage;
    float* vs = ks + L::kK;
    for (int i = threadIdx.x; i < kBK * kPieces; i += kThreads) {
      const int c = i / kPieces, pc = i % kPieces, kp = k0 + c;
      const bool in = kp < Sk;
      const size_t off = (size_t)(in ? kp : 0) * kv_stride + pc * 4;
      copy16(ks + c * kLdK + pc * 4, kb + off, in);
      copy16(vs + c * kLdV + pc * 4, vb + off, in);
    }
  };
  // the ring's first S - 1 tiles; Q rides in the first group
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < kr.n) load_kv(s, s);
    sm::cp_async_commit();
  }

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // this thread's two rows: g and g + 8 of the warp's 16
  const int row0 = w * 16 + g;
  const int qpos[2] = {(r0 + row0) / G, (r0 + row0 + 8) / G};
  const float* qw = q_s + (w * 16) * kLdK;

  constexpr int kN = D / 8;          // n8 tiles of O
  constexpr int kJ = kBK / 8;        // n8 tiles of S (k8 steps of P V)
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < kr.n; ++t) {
    sm::cp_async_wait<S - 2>();      // tile t (and Q) landed, this thread's
    __syncthreads();                 // ... everyone's; tile t - 1 consumed
    if (t + S - 1 < kr.n) load_kv(t + S - 1, (t + S - 1) % S);
    sm::cp_async_commit();           // empty groups keep the count aligned

    const int s = t % S, k0 = kr.lo + t * kBK;
    const float* kt = kv_s + s * L::kStage;
    const float* vt = kt + L::kK;

    // S = Q K^T: sc[j] holds (row g, keys 8j + 2t4, + 1) in [0], [1] and
    // row g + 8 in [2], [3]; the small products go to small[j]
    float sc[kJ][4], small[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = small[j][e] = 0.f;
#pragma unroll
    for (int d16 = 0; d16 < D / 16; ++d16) {
      const int c = 16 * d16 + 4 * t4;
      const float4 qa = *reinterpret_cast<const float4*>(qw + g * kLdK + c);
      const float4 qb =
          *reinterpret_cast<const float4*>(qw + (g + 8) * kLdK + c);
      // A of the two k8 steps: (g, k t4), (g + 8, k t4), (g, k t4 + 4),
      // (g + 8, k t4 + 4) at dims c, c + 1, then c + 2, c + 3
      const float av[2][4] = {{qa.x, qb.x, qa.y, qb.y},
                              {qa.z, qb.z, qa.w, qb.w}};
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm::split_tf32(av[h2][e], ah[h2][e], al[h2][e]);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        // B: (k t4, n g), (k t4 + 4, n g) = K[8j + g][c, c + 1 | c + 2, + 3]
        const float4 kv = *reinterpret_cast<const float4*>(
            kt + (8 * j + g) * kLdK + c);
        const float bv[2][2] = {{kv.x, kv.y}, {kv.z, kv.w}};
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          uint32_t bh[2], bl[2];
          sm::split_tf32(bv[h2][0], bh[0], bl[0]);
          sm::split_tf32(bv[h2][1], bh[1], bl[1]);
          sm::mma_m16n8k8_tf32(small[j], al[h2], bh[0], bh[1]);
          sm::mma_m16n8k8_tf32(small[j], ah[h2], bl[0], bl[1]);
          sm::mma_m16n8k8_tf32(sc[j], ah[h2], bh[0], bh[1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] += small[j][e];

    // masks, only on tiles that straddle Sk, the diagonal or the window
    const bool full_tile = k0 + kBK <= Sk &&
                           (!causal || k0 + kBK - 1 <= p_lo) &&
                           (window < 0 || k0 > p_hi - window);
    if (!full_tile) {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = qpos[e >> 1];
          const bool ok = kp < Sk && (!causal || kp <= qp) &&
                          (window < 0 || kp > qp - window);
          if (!ok) sc[j][e] = kNegInf;
        }
    }

    // online softmax; row h of this thread holds sc[j][2h + {0, 1}], and
    // a row's kBK scores are spread over the 4 lanes of a quad
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = exp2f((m[h] - m_new) * scale_log2);
      const float neg = -m_new * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[j][2 * h + e];
          // everything masked so far: exp(NEG - NEG) = 1 must not count
          x = m_new == kNegInf ? 0.f : exp2f(fmaf(x, scale_log2, neg));
          sum += x;
        }
      l[h] = l[h] * corr[h] + sum;
      m[h] = m_new;
    }

    // P as the A fragment of k8 step j: (g, k t4) = key 8j + 2t4 and
    // (g, k t4 + 4) = key 8j + 2t4 + 1, rows g + 8 alike
    uint32_t ph[kJ][4], pl[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      sm::split_tf32(sc[j][0], ph[j][0], pl[j][0]);
      sm::split_tf32(sc[j][2], ph[j][1], pl[j][1]);
      sm::split_tf32(sc[j][1], ph[j][2], pl[j][2]);
      sm::split_tf32(sc[j][3], ph[j][3], pl[j][3]);
    }
    // O = O * corr + P V, n8 tiles 2mm and 2mm + 1 at a time: column g is
    // dim 16mm + 2g (+ 1); B (k t4, n g) = V[key 8j + 2t4][dim], k t4 + 4
    // the next key
#pragma unroll
    for (int mm = 0; mm < kN / 2; ++mm) {
      float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float* vr = vt + (8 * j + 2 * t4) * kLdV + 16 * mm + 2 * g;
        const float2 va = *reinterpret_cast<const float2*>(vr);
        const float2 vn = *reinterpret_cast<const float2*>(vr + kLdV);
        uint32_t bh[2][2], bl[2][2];
        sm::split_tf32(va.x, bh[0][0], bl[0][0]);
        sm::split_tf32(vn.x, bh[0][1], bl[0][1]);
        sm::split_tf32(va.y, bh[1][0], bl[1][0]);
        sm::split_tf32(vn.y, bh[1][1], bl[1][1]);
        sm::mma_m16n8k8_tf32x3(pv[0], ph[j], pl[j], bh[0], bl[0]);
        sm::mma_m16n8k8_tf32x3(pv[1], ph[j], pl[j], bh[1], bl[1]);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[2 * mm + p][e] =
              fmaf(acc[2 * mm + p][e], corr[e >> 1], pv[p][e]);
    }
  }
  sm::cp_async_wait<0>();

  // epilogue: O / l, straight from the accumulator to [B, Sq, H, D]: a
  // lane holds dims 16mm + 4t4 .. + 3 of its two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const float inv = 1.f / fmaxf(lh, 1e-30f);
    const int R = r0 + row0 + 8 * h;
    if (R >= rows) continue;
    float* dst = o + ((size_t)b * Sq + R / G) * q_stride +
                 (size_t)(hk * G + R % G) * D + 4 * t4;
#pragma unroll
    for (int mm = 0; mm < kN / 2; ++mm)
      *reinterpret_cast<float4*>(dst + 16 * mm) = make_float4(
          acc[2 * mm][2 * h] * inv, acc[2 * mm + 1][2 * h] * inv,
          acc[2 * mm][2 * h + 1] * inv, acc[2 * mm + 1][2 * h + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int Sq, int Sk, int H, int Hkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32x3<D>;
  cudaError_t err = repro::allow_smem(kernel, Layout<D>::kBytes);
  if (err != cudaSuccess) return err;
  const int G = H / Hkv;
  const long long tiles = ((long long)Sq * G + kBM - 1) / kBM;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, Hkv, B);
  kernel<<<grid, kThreads, Layout<D>::kBytes, stream>>>(
      q, k, v, o, Sq, Sk, H, Hkv, G, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q/o [B, Sq, H, D], k/v [B, Sk, Hkv, D]; float32, contiguous, 16-byte
// aligned; D = 64, 80 or 128.  window < 0 means no window.  Returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd_tf32x3(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Sq, int Sk, int H, int Hkv,
                                          int D, int causal, int window,
                                          float scale, int device,
                                          void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || B > 65535 ||
      Hkv > 65535 || (D != 64 && D != 80 && D != 128))
    return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (D == 64)
    return launch<64>(qf, kf, vf, of, B, Sq, Sk, H, Hkv, causal, window,
                      scale, s);
  if (D == 80)
    return launch<80>(qf, kf, vf, of, B, Sq, Sk, H, Hkv, causal, window,
                      scale, s);
  return launch<128>(qf, kf, vf, of, B, Sq, Sk, H, Hkv, causal, window,
                     scale, s);
}

extern "C" const char* flash_attention_fwd_tf32x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
