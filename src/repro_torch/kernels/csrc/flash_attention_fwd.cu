// Flash-attention forward for Hopper (sm_90a): causal / sliding-window /
// GQA attention over contiguous positions (prefill and training forward).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// ::flash_attention_fwd (body _fwd_kernel).  Same semantics: query row i
// and key row j sit at absolute 0-based positions i and j (NOT right-
// aligned when Sq != Sk); j is attended iff j < Sk, j <= i when causal, and
// j > i - window with a window.  Query head h reads KV head h / G.  fp32
// online softmax (acc, m, l); a row with nothing to attend to gives 0.  The
// scale is 1/sqrt(D) of the true D, and D is not padded to 128 (the TPU
// padded it for its 128-wide matrix unit).
//
// Bound on the H100: FLOPs at long S.  Causal work is 4*B*H*Sq*Sk*D / 2
// FLOPs against (Sq*H + 2*Sk*Hkv)*D elements moved, so past a few hundred
// tokens the floor is the tensor-core rate.  Design: model layout
// [B, S, H, D] is read in place (no transposes); one block per (q tile of
// kBQ rows, query head, batch row) stages its Q tile once and then walks
// the K/V tiles through shared memory.  The k-tile loop starts at the
// window's first tile and stops at the causal diagonal, so fully masked
// tiles cost nothing (on the TPU they still took a grid step).  The
// sequential k axis of the TPU grid becomes that loop; the VMEM carry
// becomes per-thread registers.  Products run on the fp32 CUDA cores and
// tiles are staged synchronously.  This kernel serves only the head dims
// the tensor-core kernels do not take (ops._variant): at D = 64, 80 and
// 128, bf16 goes to flash_attention_fwd_sm90.cu, and float32 to
// flash_attention_fwd_tf32x3.cu, whose 3xTF32 split (three TF32 products
// of hi/lo operands) holds the 2e-5 tolerance that one TF32 product
// misses.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16: ty owns 4 query rows, tx owns
                                 // 2 key columns and D/16 output columns
constexpr int kRows = kBQ / 16;  // 4 query rows per thread
constexpr int kCols = kBK / 16;  // 2 key columns per thread

size_t smem_bytes(int D) {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                                  kBQ * (kBK + 1));
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int Hkv, int D, int causal, int window, float scale) {
  constexpr int kJ = DPAD / 16;    // output columns per thread
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kBQ;
  const int ld = D + 1;            // padded rows: conflict-free column reads

  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBQ][D+1], pre-scaled
  float* k_s = q_s + kBQ * ld;        // [kBK][D+1]
  float* v_s = k_s + kBK * ld;        // [kBK][D]
  float* p_s = v_s + kBK * D;         // [kBQ][kBK+1] probabilities

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * kv_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * Sk * kv_stride + (size_t)hk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D, qp = q0 + r;
    q_s[r * ld + d] = qp < Sq ? repro::to_f32(qb[qp * q_stride + d]) * scale
                              : 0.f;
  }

  // key range [k_lo, k_hi) that any row of this tile can attend to
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (window >= 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / kBK) * kBK;

  float acc[kRows][kJ];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();   // previous tile consumed (and q_s ready on entry)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i - c * D, kp = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        kv = repro::to_f32(kb[kp * kv_stride + d]);
        vv = repro::to_f32(vb[kp * kv_stride + d]);
      }
      k_s[c * ld + d] = kv;
      v_s[c * D + d] = vv;
    }
    __syncthreads();

    // scores of rows ty*4+i against key columns tx + 16*c
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = k_s[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // mask + online softmax; a row's 32 scores live on the 16 lanes that
    // share ty (one half-warp), so xor-shuffles below 16 reduce a row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i, qp = q0 + r;
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool ok = kp < Sk && (!causal || kp <= qp) &&
                        (window < 0 || kp > qp - window);
        if (!ok) s[i][c] = kNegInf;
        rmax = fmaxf(rmax, s[i][c]);
      }
      for (int off = 8; off; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        // everything masked so far: exp(NEG - NEG) = 1 must not count
        const float p = (m_new == kNegInf) ? 0.f : expf(s[i][c] - m_new);
        p_s[r * (kBK + 1) + tx + 16 * c] = p;
        rsum += p;
      }
      for (int off = 8; off; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();      // a row's probabilities come from its own half-warp

    // acc += P V over the tile's kBK keys
    for (int c = 0; c < kBK; ++c) {
      float vv[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? v_s[c * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = p_s[(ty * kRows + i) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = o + (size_t)b * Sq * q_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[qp * q_stride + d] = repro::from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DPAD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_fwd_kernel<T, DPAD>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, D,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int Hkv, int D,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, window,
                         scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, window,
                          scale, stream);
  return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, window,
                        scale, stream);
}

}  // namespace

// q/o [B, Sq, H, D], k/v [B, Sk, Hkv, D]; all contiguous.  dtype 0 =
// float32, 1 = bfloat16.  window < 0 means no window.  Returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int H, int Hkv, int D, int causal,
                                   int window, float scale, int dtype,
                                   int device, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 ||
      D > 256 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal,
                             window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hkv, D,
                                     causal, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
