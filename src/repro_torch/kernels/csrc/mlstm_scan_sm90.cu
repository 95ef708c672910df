// Chunked, stabilised mLSTM scan for Hopper (sm_90a) on the tensor cores:
// bfloat16 q/k/v at D = 64, 128, 256 or 512, as two passes.
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan/kernel.py
// ::mlstm_scan_kernel (body _mlstm_kernel) for bfloat16; float32, whose
// 1e-4 tolerance rules out bf16 operands, goes to mlstm_scan_tf32x3.cu.  Same
// semantics as mlstm_scan.cu, chunk for chunk: per chunk of T <= 64 steps
// the gate cumsum b, the decay b_t - b_j + g_j (j <= t), the stabiliser
// m_t, h = (P v + inter_t q C) / den_t with P = (q k^T) o e^(decay - m_t),
// inter_t = e^(m + b_t - m_t), den_t = max(|rowsum(P)_t + inter_t q.n|,
// e^(-m_t)), then C = sc C + (k o w_end)^T v, n likewise, m = m_new.
//
// Bound on the H100: per chunk and row 2 T (T + 1) D + 4 T D^2 FLOPs (the
// causal half of q k^T and of P v, then q C and the C update) against
// 4 T D elements moved; in bf16 the bytes and the tensor-core rate give
// about the same floor, and at D = 512 the q C product and the C update
// carry 4 T D^2 of the work, which is the tensor cores' to do.
//
// Design.  The TPU kept C [D, D] fp32 whole in VMEM (1 MB at D = 512); one
// SM has 227 KB of shared memory, so C is split over the value columns, and
// the work is split where it splits.  Both kernels read the model layout
// [B, S, H, D] in place (a row is one (b, h), a step H * D elements on), so
// the wrapper copies nothing, and a short last chunk stands for the
// reference's padded one (the pad steps change nothing that is read).
//
// mlstm_intra_kernel, one block per row walking its chunks, does what spans
//   all of D or is scalar: the gates, the m recurrence, S = q k^T on the
//   tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; 8 warps,
//   each 16 steps x 32 keys, tiles above the diagonal skipped), P in fp32
//   and its row sums, q.n against the fp32 n carry in shared memory, den,
//   w_end and the carry scale sc.  It writes P ([BH, chunks, 2, 64, 64]
//   bf16, see below) and (inter, den, w_end, sc) in fp32 ([BH, chunks, 4,
//   64]) to scratch, and the final (n, m).  den comes from the fp32 P.
//   The gate cumsum and the stabiliser's prefix max (max_{j <= t}
//   (b_t - b_j + g_j) = b_t + max_{j <= t} (g_j - b_j)) are warp shuffle
//   scans, and the next chunk's q streams in while den and n are formed.
// mlstm_carry_kernel, grid (BH, D / 64), owns C[:, j0 : j0 + 64] of a row
//   and walks the chunks in order.  It recomputes no score.  The carry
//   lives in accumulator registers, transposed: warp (rb, dh) of 8 holds
//   C^T[16 rb .. 16 rb + 15, dh D/2 .. (dh + 1) D/2 - 1] in fp32 (128
//   floats a thread at D = 512), so the update C^T = sc C^T + (v o w)^T k
//   is an mma into those registers (A = v^T scaled by w_end, through
//   ldmatrix.trans; B = k through ldmatrix.trans), and q C is
//   h^T = C^T q^T with C^T's accumulators repacked to bf16 as the A
//   operand (the fragment of an m16n8 accumulator pair is that of an
//   m16k16 A operand), B = q through ldmatrix.  C itself stays fp32 and
//   never leaves the registers until the final state is written.  The two
//   D halves' partial q C meet in shared memory; the dh = 0 warps add P v
//   (A = v^T, B = P from scratch) and write h.  Shared memory holds one
//   chunk of q, k (all of D: both products span it), the block's v
//   columns, P and the scalars: 174 KB at D = 512, one block (256
//   threads) per SM.  The next chunk's q is copied with cp.async while the
//   C update runs, and its k, v and P while q C runs.
// Operands in two bf16 terms: q, k and v are bf16 already, but P, C and
//   v o w_end are fp32, and this recurrence is not normalised like
//   softmax attention: h_t = (P v + ..)_t / den_t with den_t = |sum_j P_tj
//   + ..|, so an operand's rounding error comes back multiplied by
//   sum_j |P_tj| |v_j| / den_t.  With one bf16 term each, the plain model
//   (ssm_scan/ref.py::mlstm_two_pass_ref, terms=1) errs many times more
//   over 4096 steps than with two (tests/test_torch_ssm_two_pass.py
//   ::test_two_terms_hold_where_one_drifts).  So each is given as hi + lo (hi = bf16(x), lo =
//   bf16(x - hi), 16 bits of mantissa between them) and every product
//   with one of them is two mma: the tensor-core work doubles, the
//   accuracy is that of the fp32 CUDA-core kernel.
// Why DV = 64 and registers: 64 columns is the widest slice whose carry
//   fits 8 warps' registers (16 x 256 fp32 each) next to their other
//   fragments; a shared-memory carry (128 KB fp32 at DV = 64) would leave
//   no room for q and k.  At the train shape (BH = 32, D = 512) that is 256
//   blocks, two waves; the 8 blocks of a row read its q and k from L2.
//
// Steps past a chunk's end in the 64-row tile are zero-filled (P = 0,
// w_end = 0, den = 1); the pad steps (ig = -1e30, fg = 1e4) of a padded
// input have w_end = 0 and leave sc = 1, so the carry passes them
// unchanged.
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::kNegInf;
namespace sm90 = repro::sm90;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;            // steps per chunk tile (chunk <= 64)
constexpr int kDV = 64;           // value columns a carry block owns
constexpr int kThreads = 256;     // 8 warps
constexpr int kPad = 8;           // bf16 after each staged row (16 bytes:
                                  // no bank conflicts for ldmatrix)
constexpr int kLdP = kT + kPad;   // staged P and v rows (64 wide)

__host__ __device__ constexpr int ld_qk(int D) { return D + kPad; }

// 16 bytes from global to shared memory, or 16 zero bytes (nothing read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool copy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(copy ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Copy steps c0 .. c0 + 63 of one row (step s at x + s * stride; zero
// from step c0 + cl on) into a staged [64][ld_qk(D)] tile.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* x,
                                           long long stride, int c0,
                                           int cl) {
  constexpr int kPieces = D / 8;
  for (int i = threadIdx.x; i < kT * kPieces; i += kThreads) {
    const int t = i / kPieces, p = i - t * kPieces;
    const bool ok = t < cl;
    cp16(dst + t * ld_qk(D) + 8 * p,
         x + (ok ? (c0 + t) * stride + 8 * p : 0), ok);
  }
}

// An fp32 pair as two bf16 pairs, hi + lo, whose sum carries 16 bits of
// the mantissa: one term would lose too much (see the header).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  hi = sm90::pack_bf16(x, y);
  lo = sm90::pack_bf16(x - __uint_as_float(hi << 16),
                       y - __uint_as_float(hi & 0xffff0000u));
}

// ------------------------------------------------------ intra-chunk pass
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_intra_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const float* __restrict__ ig, const float* __restrict__ fg,
                   bf16* __restrict__ p_out, float* __restrict__ s_out,
                   float* __restrict__ n_out, float* __restrict__ m_out,
                   int S, int H, int chunk, float scale) {
  constexpr int LD = ld_qk(D);
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wt = warp & 3, wj = warp >> 2;   // steps 16 wt.., keys 32 wj..
  const int nc = (S + chunk - 1) / chunk;
  // row (b, hh) of the model layout [B, S, H, D]: step s at s * H * D
  const int b = bh / H, hh = bh - b * H;
  const long long stride = (long long)H * D;
  const bf16* qr = q + ((size_t)b * S * H + hh) * D;
  const bf16* kr = k + ((size_t)b * S * H + hh) * D;
  const float* igr = ig + (size_t)b * S * H + hh;   // step s at s * H
  const float* fgr = fg + (size_t)b * S * H + hh;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);          // [64][LD]
  bf16* k_s = q_s + kT * LD;                          // [64][LD]
  float* n_s = reinterpret_cast<float*>(k_s + kT * LD);   // [D]
  float* b_s = n_s + D;          // cumulative log forget gate
  float* g_s = b_s + kT;         // input gate
  float* mt_s = g_s + kT;        // stabiliser m_t
  float* in_s = mt_s + kT;       // inter_t
  float* w_s = in_s + kT;        // w_end
  float* qn_s = w_s + kT;        // q.n_prev
  float* pm_s = qn_s + kT;       // prefix max of g_j - b_j
  float* rs_s = pm_s + kT;       // [2][64] row sums of P by key half
  float* sc_s = rs_s + 2 * kT;   // [0] m, [1] m_new, [2] carry scale

  for (int d = tid; d < D; d += kThreads) n_s[d] = 0.f;
  if (tid == 0) sc_s[0] = 0.f;
  stage_rows<D>(q_s, qr, stride, 0, min(chunk, S));
  sm90::cp_async_commit();

  for (int c = 0; c < nc; ++c) {
    // the last chunk may be short: its missing steps are the pad steps of
    // the reference (ig = -1e30, fg = 1e4), which change nothing that is
    // read, so they are left out
    const int c0 = c * chunk, cl = min(chunk, S - c0);
    __syncthreads();   // the previous chunk's tiles are consumed
    stage_rows<D>(k_s, kr, stride, c0, cl);   // q came with the last chunk
    sm90::cp_async_commit();
    if (tid < kT) {
      b_s[tid] = tid < cl ? log_sigmoid(fgr[(size_t)(c0 + tid) * H]) : 0.f;
      g_s[tid] = tid < cl ? igr[(size_t)(c0 + tid) * H] : kNegInf;
    }
    __syncthreads();
    if (warp == 0) {
      // b = cumsum of the log forget gate and pm = prefix max of g_j - b_j
      // (so max_{j <= t} (b_t - b_j + g_j) = b_t + pm_t): lane l holds
      // steps 2l and 2l + 1, then a shuffle scan over the lanes
      const int t0 = 2 * lane;
      float b0 = b_s[t0], b1 = b0 + b_s[t0 + 1], sum = b1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, sum, o);
        if (lane >= o) sum += y;
      }
      b0 += sum - b1;
      b1 = sum;
      float p0 = g_s[t0] - b0, p1 = fmaxf(p0, g_s[t0 + 1] - b1), mx = p1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, mx, o);
        if (lane >= o) mx = fmaxf(mx, y);
      }
      const float before = __shfl_up_sync(0xffffffffu, mx, 1);
      if (lane > 0) {
        p0 = fmaxf(p0, before);
        p1 = fmaxf(p1, before);
      }
      b_s[t0] = b0;
      b_s[t0 + 1] = b1;
      pm_s[t0] = p0;
      pm_s[t0 + 1] = p1;
    }
    __syncthreads();
    const float m_prev = sc_s[0];
    if (tid < kT) {
      const int t = tid;
      if (t < cl) {
        const float alpha = m_prev + b_s[t];
        const float mt = fmaxf(alpha, b_s[t] + pm_s[t]);
        mt_s[t] = mt;
        in_s[t] = expf(alpha - mt);
      } else {
        mt_s[t] = 0.f;
        in_s[t] = 0.f;
      }
    } else if (tid == kT) {
      const float be = b_s[cl - 1];
      const float mn = fmaxf(m_prev + be, be + pm_s[cl - 1]);
      sc_s[1] = mn;
      sc_s[2] = expf(m_prev + be - mn);
    }
    __syncthreads();
    if (tid < kT)
      w_s[tid] = tid < cl ? expf(b_s[cl - 1] - b_s[tid] + g_s[tid] -
                                 sc_s[1])
                          : 0.f;
    sm90::cp_async_wait<0>();
    __syncthreads();

    // S = q k^T: warp (wt, wj) computes steps 16 wt.. x keys 32 wj.. (4 n8
    // tiles); a tile wholly above the diagonal stays 0
    float s[4][4] = {};
    const int mi = lane / 8, r = lane % 8;
    if (32 * wj <= 16 * wt + 15) {
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        sm90::ldmatrix_x4(
            a, q_s + (16 * wt + r + 8 * (mi % 2)) * LD + 16 * kk + 8 * (mi / 2),
            false);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          sm90::ldmatrix_x4(b,
                            k_s + (32 * wj + 16 * np + r + 8 * (mi / 2)) * LD +
                                16 * kk + 8 * (mi % 2),
                            false);
          sm90::mma_m16n8k16(s[2 * np], a, b[0], b[1]);
          sm90::mma_m16n8k16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    // P = S o e^(decay - m_t) (0 above the diagonal and past the chunk), its
    // fp32 row sums, and its hi + lo bf16 copy to scratch
    bf16* p_chunk = p_out + ((size_t)bh * nc + c) * 2 * kT * kT;
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 16 * wt + g + 8 * h;
        const int j = 32 * wj + 8 * nt + 2 * t4;
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = t < cl && j + e <= t;
          p[e] = ok ? s[nt][2 * h + e] * scale *
                          expf(b_s[t] - b_s[j + e] + g_s[j + e] - mt_s[t])
                    : 0.f;
          rsum[h] += p[e];
        }
        uint32_t hi, lo;
        split_bf16(p[0], p[1], hi, lo);
        *reinterpret_cast<uint32_t*>(p_chunk + t * kT + j) = hi;
        *reinterpret_cast<uint32_t*>(p_chunk + (kT + t) * kT + j) = lo;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
      if (t4 == 0) rs_s[wj * kT + 16 * wt + g + 8 * h] = rsum[h];
    }
    // q.n_prev: 4 threads a step
    {
      const int t = tid / 4, part = tid % 4;
      float acc = 0.f;
      for (int d = 2 * part; d < D; d += 8) {
        const float2 qv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(q_s + t * LD + d));
        acc = fmaf(qv.x, n_s[d], fmaf(qv.y, n_s[d + 1], acc));
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) qn_s[t] = acc * scale;
    }
    __syncthreads();   // q_s is read: the next chunk's q streams in
    if (c + 1 < nc)
      stage_rows<D>(q_s, qr, stride, c0 + chunk, min(chunk, S - c0 - chunk));
    sm90::cp_async_commit();
    float* s_chunk = s_out + ((size_t)bh * nc + c) * 4 * kT;
    if (tid < kT) {
      const int t = tid;
      float den = 1.f;
      if (t < cl)
        den = fmaxf(fabsf(rs_s[t] + rs_s[kT + t] + in_s[t] * qn_s[t]),
                    expf(-mt_s[t]));
      s_chunk[t] = in_s[t];
      s_chunk[kT + t] = den;
      s_chunk[2 * kT + t] = w_s[t];
      s_chunk[3 * kT + t] = sc_s[2];
    }
    // n = sc n + sum_t k_t w_end_t (every q.n_prev above is read)
    const float sc = sc_s[2];
    for (int d = 2 * tid; d < D; d += 2 * kThreads) {
      float a0 = 0.f, a1 = 0.f;
      for (int t = 0; t < cl; ++t) {
        const float2 kv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(k_s + t * LD + d));
        a0 = fmaf(kv.x, w_s[t], a0);
        a1 = fmaf(kv.y, w_s[t], a1);
      }
      n_s[d] = sc * n_s[d] + a0;
      n_s[d + 1] = sc * n_s[d + 1] + a1;
    }
    __syncthreads();
    if (tid == 0) sc_s[0] = sc_s[1];
  }
  __syncthreads();
  if (n_out != nullptr) {
    for (int d = tid; d < D; d += kThreads) n_out[(size_t)bh * D + d] = n_s[d];
    if (tid == 0) m_out[bh] = sc_s[0];
  }
}

// ------------------------------------------------------------ carry pass
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_carry_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ p_in,
                   const float* __restrict__ s_in, bf16* __restrict__ h,
                   float* __restrict__ C_out, int S, int H, int chunk,
                   float scale) {
  constexpr int LD = ld_qk(D);
  constexpr int kHalf = D / 2;          // d columns of C^T a warp holds
  constexpr int kN = kHalf / 8;         // their n8 tiles
  const int bh = blockIdx.x, j0 = blockIdx.y * kDV, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int rb = warp & 3, dh = warp >> 2;
  const int d0 = dh * kHalf, mi = lane / 8, r = lane % 8;
  const int nc = (S + chunk - 1) / chunk;
  const int b = bh / H, hh = bh - b * H;
  const long long stride = (long long)H * D;
  const size_t base = ((size_t)b * S * H + hh) * D;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);          // [64][LD]
  bf16* k_s = q_s + kT * LD;                          // [64][LD]
  bf16* v_s = k_s + kT * LD;                          // [64][kLdP]
  bf16* p_s = v_s + kT * kLdP;                        // [2][64][kLdP] hi, lo
  float* red_s = reinterpret_cast<float*>(p_s + 2 * kT * kLdP);  // [4][32][32]
  float* sca_s = red_s + 4 * 32 * 32;  // [4][64]: inter, den, w_end, sc

  auto chunk_len = [&](int c) { return min(chunk, S - c * chunk); };
  auto issue_q = [&](int c) {
    stage_rows<D>(q_s, q + base, stride, c * chunk, chunk_len(c));
  };
  auto issue_rest = [&](int c) {
    const int c0 = c * chunk, cl = chunk_len(c);
    stage_rows<D>(k_s, k + base, stride, c0, cl);
    const bf16* pc = p_in + ((size_t)bh * nc + c) * 2 * kT * kT;
    for (int i = tid; i < kT * 8; i += kThreads) {
      const int t = i / 8, p = i % 8;
      const bool ok = t < cl;
      cp16(v_s + t * kLdP + 8 * p,
           v + base + (ok ? (c0 + t) * stride + j0 + 8 * p : 0), ok);
      cp16(p_s + t * kLdP + 8 * p, pc + t * kT + 8 * p, true);
      cp16(p_s + (kT + t) * kLdP + 8 * p, pc + (kT + t) * kT + 8 * p, true);
    }
    if (tid < kT)
      cp16(sca_s + 4 * tid, s_in + ((size_t)bh * nc + c) * 4 * kT + 4 * tid,
           true);
  };

  // C^T[16 rb + (g, g + 8), d0 + 8 j + 2 t4 + (0, 1)]
  float acc[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // two copy groups a chunk, q then the rest (k, v, P, scalars): q c
  // streams in during chunk c - 1's C update, the rest during chunk c's
  // q C
  issue_q(0);
  sm90::cp_async_commit();
  issue_rest(0);
  sm90::cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int cl = chunk_len(c);
    sm90::cp_async_wait<1>();
    __syncthreads();               // chunk c's q landed

    // h^T partial = C^T q^T over this warp's d half: A = C^T as hi + lo
    // bf16 copies of the accumulators, B = q rows
    float hi[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kHalf / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(acc[2 * kk][0], acc[2 * kk][1], ah[0], al[0]);
      split_bf16(acc[2 * kk][2], acc[2 * kk][3], ah[1], al[1]);
      split_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        sm90::ldmatrix_x4(bq,
                          q_s + (16 * np + r + 8 * (mi / 2)) * LD + d0 +
                              16 * kk + 8 * (mi % 2),
                          false);
        sm90::mma_m16n8k16(hi[2 * np], ah, bq[0], bq[1]);
        sm90::mma_m16n8k16(hi[2 * np + 1], ah, bq[2], bq[3]);
        sm90::mma_m16n8k16(hi[2 * np], al, bq[0], bq[1]);
        sm90::mma_m16n8k16(hi[2 * np + 1], al, bq[2], bq[3]);
      }
    }
    float* red = red_s + rb * 32 * 32;
    if (dh == 1) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(nt * 4 + e) * 32 + lane] = hi[nt][e];
    }
    sm90::cp_async_wait<0>();
    __syncthreads();               // q_s is free, the partials are in red,
                                   // the rest of chunk c landed
    if (c + 1 < nc) issue_q(c + 1);
    sm90::cp_async_commit();

    const float* in_s = sca_s;
    const float* den_s = sca_s + kT;
    const float* w_s = sca_s + 2 * kT;
    if (dh == 0) {
      // h^T = inter (scale C^T q^T) + v^T (P_hi + P_lo)^T, then / den
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 8 * nt + 2 * t4 + (e & 1);
          hi[nt][e] = (hi[nt][e] + red[(nt * 4 + e) * 32 + lane]) * scale *
                      in_s[t];
        }
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        uint32_t a[4];
        sm90::ldmatrix_x4(a,
                          v_s + (16 * kk + 8 * (mi / 2) + r) * kLdP + 16 * rb +
                              8 * (mi % 2),
                          true);
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bp[4];
            sm90::ldmatrix_x4(bp,
                              p_s + (part * kT + 16 * np + r + 8 * (mi / 2)) *
                                        kLdP +
                                  16 * kk + 8 * (mi % 2),
                              false);
            sm90::mma_m16n8k16(hi[2 * np], a, bp[0], bp[1]);
            sm90::mma_m16n8k16(hi[2 * np + 1], a, bp[2], bp[3]);
          }
      }
      bf16* hc = h + base + (size_t)c * chunk * stride + j0 + 16 * rb + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 8 * nt + 2 * t4 + (e & 1);
          if (t < cl)
            hc[t * stride + 8 * (e >> 1)] =
                __float2bfloat16(hi[nt][e] / den_s[t]);
        }
    }

    // C^T = sc C^T + (v o w_end)^T k: A = v^T scaled by w_end per step, as
    // hi + lo bf16 terms
    const float sc = sca_s[3 * kT];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= sc;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t a[4], ah[4], al[4];
      sm90::ldmatrix_x4(a,
                        v_s + (16 * kk + 8 * (mi / 2) + r) * kLdP + 16 * rb +
                            8 * (mi % 2),
                        true);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // the pair's low half is step t, its high half step t + 1
        const int t = 16 * kk + 2 * t4 + 8 * (i / 2);
        split_bf16(__uint_as_float(a[i] << 16) * w_s[t],
                   __uint_as_float(a[i] & 0xffff0000u) * w_s[t + 1], ah[i],
                   al[i]);
      }
#pragma unroll
      for (int jp = 0; jp < kN / 2; ++jp) {
        uint32_t bk[4];
        sm90::ldmatrix_x4(bk,
                          k_s + (16 * kk + r + 8 * (mi % 2)) * LD + d0 +
                              16 * jp + 8 * (mi / 2),
                          true);
        sm90::mma_m16n8k16(acc[2 * jp], ah, bk[0], bk[1]);
        sm90::mma_m16n8k16(acc[2 * jp + 1], ah, bk[2], bk[3]);
        sm90::mma_m16n8k16(acc[2 * jp], al, bk[0], bk[1]);
        sm90::mma_m16n8k16(acc[2 * jp + 1], al, bk[2], bk[3]);
      }
    }
    __syncthreads();               // k, v, P and the scalars are consumed
    if (c + 1 < nc) issue_rest(c + 1);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<0>();

  if (C_out != nullptr) {
    float* Cb = C_out + (size_t)bh * D * D + j0 + 16 * rb + g;
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 8 * j + 2 * t4 + (e & 1);
        Cb[(size_t)d * D + 8 * (e >> 1)] = acc[j][e];
      }
  }
}

size_t intra_smem(int D) {
  return (size_t)2 * kT * ld_qk(D) * sizeof(bf16) +
         sizeof(float) * ((size_t)D + 9 * kT + 4);
}

size_t carry_smem(int D) {
  return (size_t)2 * kT * ld_qk(D) * sizeof(bf16) +
         (size_t)3 * kT * kLdP * sizeof(bf16) +
         sizeof(float) * (4 * 32 * 32 + 4 * kT);
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* ig, const float* fg, bf16* h, float* C_out,
                   float* n_out, float* m_out, bf16* p_scratch,
                   float* s_scratch, int B, int S, int H, int chunk,
                   float scale, cudaStream_t stream) {
  auto intra = mlstm_intra_kernel<D>;
  auto carry = mlstm_carry_kernel<D>;
  cudaError_t err = repro::allow_smem(intra, intra_smem(D));
  if (err != cudaSuccess) return err;
  err = repro::allow_smem(carry, carry_smem(D));
  if (err != cudaSuccess) return err;
  intra<<<B * H, kThreads, intra_smem(D), stream>>>(
      q, k, ig, fg, p_scratch, s_scratch, n_out, m_out, S, H, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry<<<dim3(B * H, D / kDV), kThreads, carry_smem(D), stream>>>(
      q, k, v, p_scratch, s_scratch, h, C_out, S, H, chunk, scale);
  return cudaGetLastError();
}

}  // namespace

// The model layout: q/k/v/h [B, S, H, D] bfloat16 (16-byte aligned),
// ig/fg [B, S, H] float32, all contiguous; any S >= 1 (a short last chunk
// stands for the reference's padded one), chunk 1..64, D in {64, 128,
// 256, 512}.  With nc = ceil(S / chunk): p_scratch bfloat16
// [B * H, nc, 2, 64, 64] (P as hi and lo planes) and s_scratch float32
// [B * H, nc, 4, 64] hold the intra-chunk pass's output for the carry
// pass.  C_out [B*H, D, D], n_out [B*H, D], m_out [B*H] (float32) receive
// the final carry when C_out is not null.  Launches the two passes in
// stream order; returns cudaGetLastError() of the first that fails, else
// of the second.
extern "C" int mlstm_scan_sm90(const void* q, const void* k, const void* v,
                               const void* ig, const void* fg, void* h,
                               void* C_out, void* n_out, void* m_out,
                               void* p_scratch, void* s_scratch, int B,
                               int S, int H, int D, int chunk, float scale,
                               int device, void* stream) {
  if (B < 1 || H < 1 || (long long)B * H > 65535 || S < 1 || chunk < 1 ||
      chunk > kT || !p_scratch || !s_scratch ||
      (C_out != nullptr && (n_out == nullptr || m_out == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const float* igf = static_cast<const float*>(ig);
  const float* fgf = static_cast<const float*>(fg);
  bf16* hb = static_cast<bf16*>(h);
  float* Cf = static_cast<float*>(C_out);
  float* nf = static_cast<float*>(n_out);
  float* mf = static_cast<float*>(m_out);
  bf16* pb = static_cast<bf16*>(p_scratch);
  float* sf = static_cast<float*>(s_scratch);
  switch (D) {
    case 64:
      return launch<64>(qb, kb, vb, igf, fgf, hb, Cf, nf, mf, pb, sf, B, S,
                        H, chunk, scale, s);
    case 128:
      return launch<128>(qb, kb, vb, igf, fgf, hb, Cf, nf, mf, pb, sf, B, S,
                         H, chunk, scale, s);
    case 256:
      return launch<256>(qb, kb, vb, igf, fgf, hb, Cf, nf, mf, pb, sf, B, S,
                         H, chunk, scale, s);
    case 512:
      return launch<512>(qb, kb, vb, igf, fgf, hb, Cf, nf, mf, pb, sf, B, S,
                         H, chunk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* mlstm_scan_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
