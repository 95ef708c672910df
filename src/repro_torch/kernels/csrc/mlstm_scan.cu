// Chunked, stabilised mLSTM scan for Hopper (sm_90a): the xLSTM
// counterpart of flash attention, over the (C, n, m) matrix-memory carry.
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan/kernel.py
// ::mlstm_scan_kernel (body _mlstm_kernel).  Same semantics, chunk for
// chunk, in fp32 throughout: per chunk of T steps the log-sigmoid forget
// gate and its cumulative sum b, the decay matrix b_t - b_j + g_j (j <= t),
// the stabiliser m_t = max(m + b_t, max_j decay), scores (q k^T) o
// e^{decay - m_t}, h = (scores v + e^{m + b_t - m_t} q C) / max(|q n_t|,
// e^{-m_t}), then the carry update of C, n and m.  q is scaled by
// 1/sqrt(D) of the true D.  The log-sigmoid is min(x, 0) - log1p(e^{-|x|}),
// so the pad value fg = 1e4 gives exactly 0.
//
// What is new on this card: the TPU kept C [D, D] fp32 whole in VMEM (1 MB
// at D = 512); one H100 SM has 227 KB of shared memory.  So C is split
// over the VALUE dimension: the grid is (BH, ceil(D / kDV)) and each block
// owns C[:, j0 : j0 + kDV] (64 KB at D = 512) and walks its row's chunks in
// order, the TPU's sequential grid axis becoming that loop.  h[:, tile]
// and the C update need only the block's own value columns.  The scores
// q k^T, q C, q n and the stabiliser span all of D: every block recomputes
// them, staging q and k through shared memory in kDK-wide tiles, and keeps
// its own copy of n.  q.n_t is taken as sum_j scores[t, j] + e^{..} q.n, the
// same sum without forming n_t.  At the xlstm-1.3b train shape (BH = 32,
// D = 512) that is 32 x 16 = 512 blocks of about 108 KB, two per SM.
//
// Bound on the H100: per chunk and row 2 T (T + 1) D + 4 T D^2 FLOPs
// (the causal half of q k^T and of scores v, then q C and the C update;
// 71.4 MFLOP per 64-step chunk and row at D = 512) against 4 T D elements moved, so in bf16 the bytes and the
// tensor-core rate give about the same floor.  Products run on the fp32
// CUDA cores with synchronous staging, and every value-column block
// recomputes the [T, T] scores.  Since the tensor-core kernels serve
// D = 64, 128, 256 and 512 (mlstm_scan_sm90.cu bfloat16 with bf16
// operands as two terms, mlstm_scan_tf32x3.cu float32 with three TF32
// products: one TF32 product misses float32's 1e-4 over a 4096-step row,
// tests/test_torch_ssm_tf32x3.py), this kernel serves every other D, in
// either dtype.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kT = 64;           // most steps per chunk (rows of the tile)
constexpr int kDV = 32;          // value columns a block owns
constexpr int kDK = 32;          // width of a staged q/k tile
constexpr int kThreads = 256;    // 16 x 16: ty owns 4 rows (steps), tx owns
                                 // 4 score columns and 2 value columns
constexpr int kMaxD = 512;

__host__ __device__ inline int padded_d(int D) {
  return (D + kDK - 1) / kDK * kDK;
}

size_t smem_floats(int D) {
  const int Dp = padded_d(D);
  return (size_t)Dp * kDV + Dp + kT * (kT + 1) + 2 * kT * (kDK + 1) +
         kT * kDV + 7 * kT + 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mlstm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, T* __restrict__ h,
                  float* __restrict__ C_out, float* __restrict__ n_out,
                  float* __restrict__ m_out, int S, int D, int chunk,
                  float scale) {
  const int bh = blockIdx.x, j0 = blockIdx.y * kDV;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int Dp = padded_d(D);
  constexpr int ldk = kDK + 1, lds = kT + 1;

  extern __shared__ float smem[];
  float* C_s = smem;                   // [Dp][kDV] this block's carry columns
  float* n_s = C_s + Dp * kDV;         // [Dp] normaliser carry
  float* S_s = n_s + Dp;               // [kT][kT+1] weighted scores
  float* q_s = S_s + kT * lds;         // [kT][kDK+1] q tile, pre-scaled
  float* k_s = q_s + kT * ldk;         // [kT][kDK+1] k tile (k * w_end in
                                       // the carry update)
  float* v_s = k_s + kT * ldk;         // [kT][kDV] the block's v columns
  float* b_s = v_s + kT * kDV;         // cumulative log forget gate
  float* g_s = b_s + kT;               // input gate
  float* mt_s = g_s + kT;              // stabiliser m_t
  float* in_s = mt_s + kT;             // e^{m + b_t - m_t}
  float* we_s = in_s + kT;             // e^{b_end - b_j + g_j - m_new}
  float* den_s = we_s + kT;            // max(|q.n_t|, e^{-m_t})
  float* rs_s = den_s + kT;            // row sums of the weighted scores
  float* sc_s = rs_s + kT;             // [0] m, [1] m_new, [2] carry scale

  for (int i = tid; i < Dp * kDV; i += kThreads) C_s[i] = 0.f;
  for (int i = tid; i < Dp; i += kThreads) n_s[i] = 0.f;
  if (tid == 0) sc_s[0] = 0.f;

  const size_t row = (size_t)bh * S;
  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();   // previous chunk done (and the carry zeroed)
    // ---- gates
    if (tid < chunk) {
      const float x = fg[row + c0 + tid];
      b_s[tid] = fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
      g_s[tid] = ig[row + c0 + tid];
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < chunk; ++t) {
        acc += b_s[t];
        b_s[t] = acc;
      }
    }
    __syncthreads();
    const float m_prev = sc_s[0];
    if (tid < chunk) {
      const int t = tid;
      const float bt = b_s[t];
      float mx = kNegInf;
      for (int j = 0; j <= t; ++j) mx = fmaxf(mx, bt - b_s[j] + g_s[j]);
      const float alpha = m_prev + bt;
      const float mt = fmaxf(alpha, mx);
      mt_s[t] = mt;
      in_s[t] = expf(alpha - mt);
    } else if (tid == kT) {
      const float be = b_s[chunk - 1];
      float mx = kNegInf;
      for (int j = 0; j < chunk; ++j) mx = fmaxf(mx, be - b_s[j] + g_s[j]);
      const float mn = fmaxf(m_prev + be, mx);
      sc_s[1] = mn;
      sc_s[2] = expf(m_prev + be - mn);
    }
    __syncthreads();
    if (tid < chunk)
      we_s[tid] = expf(b_s[chunk - 1] - b_s[tid] + g_s[tid] - sc_s[1]);

    // ---- one pass over D: scores q k^T, q C[:, tile] and q.n
    float acc_s[4][4], acc_c[4][2], qns = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_s[i][c] = 0.f;
      acc_c[i][0] = acc_c[i][1] = 0.f;
    }
    for (int d0 = 0; d0 < D; d0 += kDK) {
      __syncthreads();   // previous tile consumed
      for (int i = tid; i < kT * kDK; i += kThreads) {
        const int t = i / kDK, d = i - t * kDK;
        float qv = 0.f, kv = 0.f;
        if (t < chunk && d0 + d < D) {
          const size_t off = (row + c0 + t) * D + d0 + d;
          qv = repro::to_f32(q[off]) * scale;
          kv = repro::to_f32(k[off]);
        }
        q_s[t * ldk + d] = qv;
        k_s[t * ldk + d] = kv;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kDK; ++d) {
        float qv[4], kv[4], cv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * ldk + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = k_s[(tx + 16 * c) * ldk + d];
        cv[0] = C_s[(d0 + d) * kDV + tx];
        cv[1] = C_s[(d0 + d) * kDV + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc_s[i][c] = fmaf(qv[i], kv[c], acc_s[i][c]);
          acc_c[i][0] = fmaf(qv[i], cv[0], acc_c[i][0]);
          acc_c[i][1] = fmaf(qv[i], cv[1], acc_c[i][1]);
        }
      }
      if (tid < chunk)
        for (int d = 0; d < kDK; ++d)
          qns = fmaf(q_s[tid * ldk + d], n_s[d0 + d], qns);
    }

    // ---- weighted scores, their row sums, the block's v columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty * 4 + i;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        float s = 0.f;
        if (t < chunk && j <= t)
          s = acc_s[i][c] * expf(b_s[t] - b_s[j] + g_s[j] - mt_s[t]);
        S_s[t * lds + j] = s;
        rs += s;
      }
      // a row's 64 scores live on the 16 lanes that share ty
      for (int off = 8; off; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (tx == 0) rs_s[t] = rs;
    }
    for (int i = tid; i < kT * kDV; i += kThreads) {
      const int t = i / kDV, c = i - t * kDV;
      float x = 0.f;
      if (t < chunk && j0 + c < D)
        x = repro::to_f32(v[(row + c0 + t) * D + j0 + c]);
      v_s[i] = x;
    }
    __syncthreads();
    if (tid < chunk) {
      const float qn = fabsf(rs_s[tid] + in_s[tid] * qns);
      den_s[tid] = fmaxf(qn, expf(-mt_s[tid]));
    }
    __syncthreads();

    // ---- h[:, tile] = (S v + inter * q C) / den
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty * 4 + i;
      if (t >= chunk) continue;
      float o0 = 0.f, o1 = 0.f;
      for (int j = 0; j <= t; ++j) {
        const float s = S_s[t * lds + j];
        o0 = fmaf(s, v_s[j * kDV + tx], o0);
        o1 = fmaf(s, v_s[j * kDV + tx + 16], o1);
      }
      const float inter = in_s[t], den = den_s[t];
      T* hr = h + (row + c0 + t) * D + j0;
      if (j0 + tx < D)
        hr[tx] = repro::from_f32<T>((o0 + inter * acc_c[i][0]) / den);
      if (j0 + tx + 16 < D)
        hr[tx + 16] = repro::from_f32<T>((o1 + inter * acc_c[i][1]) / den);
    }

    // ---- carry: C = sc C + (k w_end)^T v, n = sc n + sum_j k_j w_end_j
    const float sc = sc_s[2];
    const int cc = tid & 31, dr = tid >> 5;
    for (int d0 = 0; d0 < D; d0 += kDK) {
      __syncthreads();   // k_s free, we_s ready
      for (int i = tid; i < kT * kDK; i += kThreads) {
        const int t = i / kDK, d = i - t * kDK;
        float kv = 0.f;
        if (t < chunk && d0 + d < D)
          kv = repro::to_f32(k[(row + c0 + t) * D + d0 + d]) * we_s[t];
        k_s[t * ldk + d] = kv;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = dr + 8 * r;
        float acc = 0.f;
        for (int t = 0; t < chunk; ++t)
          acc = fmaf(k_s[t * ldk + d], v_s[t * kDV + cc], acc);
        float* cp = C_s + (d0 + d) * kDV + cc;
        *cp = sc * *cp + acc;
      }
      if (tid < kDK) {
        float acc = 0.f;
        for (int t = 0; t < chunk; ++t) acc += k_s[t * ldk + tid];
        n_s[d0 + tid] = sc * n_s[d0 + tid] + acc;
      }
    }
    __syncthreads();
    if (tid == 0) sc_s[0] = sc_s[1];
  }

  __syncthreads();
  if (C_out != nullptr) {
    for (int i = tid; i < D * kDV; i += kThreads) {
      const int d = i / kDV, c = i - d * kDV;
      if (j0 + c < D) C_out[((size_t)bh * D + d) * D + j0 + c] = C_s[i];
    }
    if (blockIdx.y == 0) {
      for (int d = tid; d < D; d += kThreads) n_out[(size_t)bh * D + d] = n_s[d];
      if (tid == 0) m_out[bh] = sc_s[0];
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ig, const float* fg, void* h, float* C_out,
                   float* n_out, float* m_out, int BH, int S, int D,
                   int chunk, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  auto kernel = mlstm_scan_kernel<T>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (D + kDV - 1) / kDV);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ig, fg, static_cast<T*>(h), C_out, n_out,
      m_out, S, D, chunk, scale);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/h [BH, S, D] (dtype 0 = float32, 1 = bfloat16), ig/fg [BH, S]
// float32, all contiguous; S a multiple of chunk (1..64), D <= 512.  C_out
// [BH, D, D], n_out [BH, D], m_out [BH] (float32) receive the final carry
// when C_out is not null.  Returns cudaGetLastError() of the launch.
extern "C" int mlstm_scan(const void* q, const void* k, const void* v,
                          const void* ig, const void* fg, void* h,
                          void* C_out, void* n_out, void* m_out, int BH,
                          int S, int D, int chunk, float scale, int dtype,
                          int device, void* stream) {
  if (BH < 1 || S < 1 || D < 1 || D > kMaxD || chunk < 1 || chunk > kT ||
      S % chunk != 0 || (C_out != nullptr && (n_out == nullptr ||
                                              m_out == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* igf = static_cast<const float*>(ig);
  const float* fgf = static_cast<const float*>(fg);
  float* Cf = static_cast<float*>(C_out);
  float* nf = static_cast<float*>(n_out);
  float* mf = static_cast<float*>(m_out);
  if (dtype == 0)
    return launch<float>(q, k, v, igf, fgf, h, Cf, nf, mf, BH, S, D, chunk,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, igf, fgf, h, Cf, nf, mf, BH, S, D,
                                 chunk, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mlstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
