// Chunked, stabilised mLSTM scan for Hopper (sm_90a) on the tensor cores in
// float32: q/k/v at D = 64, 128, 256 or 512, as three passes, every
// product as three TF32 products.
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan/kernel.py
// ::mlstm_scan_kernel (body _mlstm_kernel) for float32 at those D (bf16
// goes to mlstm_scan_sm90.cu, every other D to the CUDA-core kernel
// mlstm_scan.cu; ops._variant).  Same semantics, chunk for chunk: per
// chunk of T <= 64 steps the gate cumsum b, the decay b_t - b_j + g_j
// (j <= t), the stabiliser m_t, h = (P v + inter_t scale q C) / den_t with
// P = scale (q k^T) o e^(decay - m_t), inter_t = e^(m + b_t - m_t),
// den_t = max(|rowsum(P)_t + inter_t scale q.n|, e^(-m_t)), then
// C = sc C + k^T (v o w_end), n likewise, m = m_new.  scale = 1/sqrt(D)
// multiplies each product's result; q itself is not scaled.
//
// Why 3xTF32.  float32 is held to the reference's 1e-4, and the
// recurrence is not normalised like softmax attention: an operand's
// rounding error comes back multiplied by sum_j |P_tj| |v_j| / den_t.  One
// TF32 product (11 bits of each operand) misses 1e-4 over a 4096-step row
// at D = 512; three products of x = hi + lo splits, lo(a) hi(b) +
// hi(a) lo(b) + hi(a) hi(b), hold it (tests/test_torch_ssm_tf32x3.py
// emulates both on a CPU against the float64 chunkwise form).  Every
// product here is split so: q k^T, P v, q C and the C update; no single
// TF32 product, no bf16 operand.  hi = tf32(x) is rounded to nearest by
// bit mask (two integer operations; cvt.rna is several, with its NaN and
// infinity cases) and lo = x - hi goes in as it is: mma reads a .tf32
// operand's top 19 bits (split_tf32 below).
//
// Bound on the H100: per chunk and row 2 T (T + 1) D + 4 T D^2 FLOPs (the
// causal half of q k^T and of P v, then q C and the C update; 71.4 MFLOP
// at T = 64, D = 512) against 4 T D elements moved: operations, at
// 495 / 3 TFLOP/s of 3xTF32 (the bytes take a third of that time).
//
// Design: the bf16 kernel's intra-chunk and carry passes
// (mlstm_scan_sm90.cu) with fp32 operands, and the scores ahead of them in
// a pass of their own.  All read the model layout [B, S, H, D] in place
// (a row is one (b, h), a step H * D floats on); a short last chunk stands
// for the reference's padded one; steps past a chunk's end are zero-filled
// in the 64-row tiles (P = 0, w_end = 0, den = 1).
//
// mlstm_scores_tf32x3, grid (chunks, BH), two blocks an SM: what a chunk
//   needs of q and k that does not depend on the carry.  S = q k^T on
//   mma.sync.m16n8k8.tf32 (8 warps, each 16 steps x 32 keys, tiles above
//   the diagonal skipped) into scratch as it is, and u = sum_t k_t
//   e^(b_end - b_t + g_t - M) under the chunk's own stabiliser M =
//   max_t (b_end - b_t + g_t) with M.  In the bf16 kernel the intra pass
//   forms S itself, one block per row walking its chunks, which leaves
//   that pass's one large product on 16 SMs at the long shape (BH = 16 of
//   132).
// mlstm_intra_tf32x3, one block per row walking its chunks: what chains
//   from chunk to chunk.  The gates and the m recurrence (warp shuffle
//   scans, as the bf16 kernel), q.n against n in shared memory (q read
//   straight from global memory), n = sc n + e^(M - m_new) u, and P =
//   scale S o e^(decay - m_t) over S in place, its row sums, den, w_end
//   and sc.  So scratch holds P fp32 [BH, chunks, 64, 64] (the bytes of
//   the bf16 kernel's two bf16 planes) and (inter, den, w_end, sc)
//   [BH, chunks, 4, 64] for the carry pass, and the final (n, m).  P stays
//   fp32: hi / lo planes would double what each of the row's D / 64 carry
//   blocks reads of it, to save each warp the splits of its 32 steps' P
//   once a chunk.
// mlstm_carry_tf32x3, grid (BH, D / 64), owns C[:, j0 : j0 + 64] of a row
//   and walks the chunks in order; it recomputes no score.  C^T lives in
//   fp32 accumulator registers: warp (rb, dh) of 8 holds rows (value
//   columns) 16 rb .. 16 rb + 15 and, of every 64-wide slice of D, the 32
//   dims 32 dh .. 32 dh + 31: 128 floats a thread at D = 512.
// Shared memory.  f32 q and k of a whole chunk at D = 512 take 256 KB, over
//   the 227 KB of an SM, so the score and carry passes stream q and k over
//   D in 64-wide slices through a cp.async ring (the carry's, 3 stages,
//   runs on across chunks): q k^T and q C reduce over D and accumulate
//   slice by slice, and the C update's columns are independent, so it goes
//   slice by slice.  In the carry pass a slice does q C for its dims with
//   the carry as it was, then updates those dims: both products read one
//   staged q / k slice, and every warp has dims in every slice, so all 8
//   warps work on every stage.  The slice loop is unrolled, so the carry
//   registers are indexed by constants (chip_smoke.py prints -Xptxas -v:
//   no spills).  The carry pass holds the ring (114 KB), the chunk's v, P
//   and scalars (36 KB), the (v o w_end)^T planes (34 KB) and the h fold
//   (32 KB): 217 KB, one block (8 warps) an SM, two waves of blocks at the
//   xlstm-1.3b train shape (BH = 32: 256 blocks).  The score pass holds a
//   2-stage ring (81 KB).
// Fragment layouts.  The m16n8k8 accumulator gives lane t4 columns 2t4,
//   2t4 + 1, the A fragment wants k = t4, t4 + 4.  A product's k index may
//   be taken in any order if both operands take it alike, so q C takes
//   C^T's accumulator pairs as they are (k = t4 is column 2 t4, k = t4 + 4
//   column 2 t4 + 1) as its B, and the carry's columns are laid out so
//   that tiles 2m and 2m + 1 of a 16-dim group interleave: column c of
//   tile 2m + p is dim 16m + 2c + p.  Then q's A fragments of both tiles
//   are one float4 of a q row (dims 16m + 4t4 .. + 3), and the update's k
//   B fragments one float2 (dims 16m + 2g, + 1).  Rows are padded so that
//   those loads hit every bank once: q rows to 16 mod 32 floats, k rows
//   (carry pass) and v rows to 8 mod 32, P and the (v o w_end)^T planes
//   to 4 mod 32 (ldmatrix, 16-byte rows of fp32 fragments).
// Rounding.  The tensor cores' fp32 additions are not rounded to
//   nearest, and the carry lives across every chunk (64 at S = 4096).  So no accumulator runs long: each slice's S is summed from
//   zero (the two small products apart) and added to S in fp32 (one
//   accumulator over all 512 dims erred 3x as much as the CUDA-core
//   kernel at the long shape, past the 1e-4 tolerance); each slice's
//   update U = (v o w_end)^T k[:, dims] is summed from zero (the even and
//   the odd k8 steps apart) and folded in by one fp32 fma, C = sc C + U;
//   each slice's q C part is summed from zero and folded, scaled by
//   inter_t scale, into a per-thread fp32 sum in shared memory that starts
//   at the chunk's P v (summed from zero, the even and odd k8 steps
//   apart), so P v and q C meet only in fp32.
// Splits.  Every operand is fp32 and is split in registers where it is
//   loaded: q, k and P per warp, C^T's accumulators once per slice, and
//   v o w_end once per chunk into hi / lo planes read by ldmatrix
//   (sm90.cuh::split_tf32_bits).
#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::kNegInf;
namespace sm = repro::sm90;

constexpr int kT = 64;          // steps per chunk tile (chunk <= 64)
constexpr int kDS = 64;         // head dims of a staged q / k slice
constexpr int kDV = 64;         // value columns a carry block owns
constexpr int kThreads = 256;   // 8 warps
constexpr int kStages = 3;      // slices in the carry pass's ring
constexpr int kScoreStages = 2; // and in the score pass's
constexpr int kLdQ = kDS + 16;  // q rows (k rows in the intra pass): float4
                                // loads of rows g, g + 8: 16 mod 32
constexpr int kLdK = kDS + 8;   // k rows in the carry pass: float2 loads of
                                // rows t4: 8 mod 32
constexpr int kLdV = kDV + 8;   // v rows: scalar loads of rows t4
constexpr int kLdP = kT + 4;    // P rows and (v o w_end)^T rows: ldmatrix
constexpr int kScoreStage = 2 * kT * kLdQ;  // q and k slices (score pass)
constexpr int kCarryStage = kT * kLdQ + kT * kLdK;

// 16 bytes from global to shared memory, or 16 zero bytes (nothing read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool copy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm::smem_u32(dst)),
               "l"(src), "r"(copy ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Head dims d0 .. d0 + 63 of steps c0 .. c0 + 63 of one row (step s at
// x + s * stride; zero from step c0 + cl on) into a [64][ld] tile.
__device__ __forceinline__ void stage_slice(float* dst, int ld,
                                            const float* x, long long stride,
                                            int c0, int cl, int d0) {
  constexpr int kPieces = kDS / 4;
  for (int i = threadIdx.x; i < kT * kPieces; i += kThreads) {
    const int t = i / kPieces, p = i % kPieces;
    const bool ok = t < cl;
    cp16(dst + t * ld + 4 * p, x + (ok ? (c0 + t) * stride + d0 + 4 * p : 0),
         ok);
  }
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) sm::split_tf32_bits(x[i], hi[i], lo[i]);
}

// The A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 7 of an fp32
// [rows][kLdP] tile: ldmatrix's 8x8 b16 matrices are 8 rows of 4 floats,
// and lane (g, t4) receives word t4 of row g of each, which is the
// m16n8k8 tf32 A layout.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const float* tile,
                                           int r0, int c0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  sm::ldmatrix_x4(a, tile + (r0 + lane % 8 + 8 * (mi % 2)) * kLdP + c0 +
                         4 * (mi / 2),
                  false);
}

// ------------------------------------------------------------- score pass
// The gates of chunk c of a row into b_s (cumulative log forget gate,
// 0 past the chunk) and g_s (input gate, -1e30 past it), by tid < 64,
// then warp 0's shuffle scan of b; ends with a barrier.
__device__ __forceinline__ void chunk_gates(const float* igr,
                                            const float* fgr, int H, int c0,
                                            int cl, float* b_s, float* g_s) {
  const int tid = threadIdx.x, lane = tid % 32;
  if (tid < kT) {
    b_s[tid] = tid < cl ? log_sigmoid(fgr[(size_t)(c0 + tid) * H]) : 0.f;
    g_s[tid] = tid < cl ? igr[(size_t)(c0 + tid) * H] : kNegInf;
  }
  __syncthreads();
  if (tid < 32) {
    // lane l holds steps 2l and 2l + 1, then a shuffle scan over the lanes
    const int t0 = 2 * lane;
    float b0 = b_s[t0], b1 = b0 + b_s[t0 + 1], sum = b1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, sum, o);
      if (lane >= o) sum += y;
    }
    b_s[t0] = b0 + sum - b1;
    b_s[t0 + 1] = sum;
  }
  __syncthreads();
}

// Grid (chunks, BH): the parts of a chunk that do not depend on the carry,
// for every chunk at once.  S = q k^T (raw: no scale, no decay) into
// p_out, and u = sum_t k_t e^(b_end - b_t + g_t - M) with its own
// stabiliser M = max_t (b_end - b_t + g_t) into u_out (D floats, then M),
// so that the intra pass's n update is sc n + e^(M - m_new) u.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
mlstm_scores_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ ig, const float* __restrict__ fg,
                    float* __restrict__ p_out, float* __restrict__ u_out,
                    int S, int H, int chunk) {
  constexpr int NS = D / kDS;
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wt = warp & 3, wj = warp >> 2;   // steps 16 wt.., keys 32 wj..
  const int nc = gridDim.x, c0 = c * chunk, cl = min(chunk, S - c0);
  // row (b, hh) of the model layout [B, S, H, D]: step s at s * H * D
  const int b = bh / H, hh = bh - b * H;
  const long long stride = (long long)H * D;
  const float* qr = q + ((size_t)b * S * H + hh) * D;
  const float* kr = k + ((size_t)b * S * H + hh) * D;

  extern __shared__ float4 smem_v4[];
  float* ring = reinterpret_cast<float*>(smem_v4);  // kScoreStages x (q, k)
  float* b_s = ring + kScoreStages * kScoreStage;
  float* g_s = b_s + kT;
  float* w_s = g_s + kT;         // e^(b_end - b_t + g_t - M)

  auto issue = [&](int si) {
    if (si < NS) {
      float* st = ring + (si % kScoreStages) * kScoreStage;
      stage_slice(st, kLdQ, qr, stride, c0, cl, si * kDS);
      stage_slice(st + kT * kLdQ, kLdQ, kr, stride, c0, cl, si * kDS);
    }
    sm::cp_async_commit();   // empty groups keep the count aligned
  };
#pragma unroll
  for (int si = 0; si < kScoreStages - 1; ++si) issue(si);

  chunk_gates(ig + (size_t)b * S * H + hh, fg + (size_t)b * S * H + hh, H,
              c0, cl, b_s, g_s);
  float* uc = u_out + ((size_t)bh * nc + c) * (D + 4);
  if (tid < 32) {
    const float be = b_s[cl - 1];
    float mx = fmaxf(be - b_s[2 * lane] + g_s[2 * lane],
                     be - b_s[2 * lane + 1] + g_s[2 * lane + 1]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * lane + e;
      w_s[t] = t < cl ? expf(be - b_s[t] + g_s[t] - mx) : 0.f;
    }
    if (lane == 0) uc[D] = mx;
  }
  // (the slice loop's first barrier publishes w_s)

  // S = q k^T: warp (wt, wj) holds steps 16 wt.. x keys 32 wj.. (4 n8
  // tiles); each slice's products are summed from zero, the lo x hi and
  // hi x lo ones in small, and folded into sacc in fp32
  float sacc[4][4] = {};
  const bool live = 32 * wj <= 16 * wt + 15 && 16 * wt < cl;
  for (int si = 0; si < NS; ++si) {
    sm::cp_async_wait<kScoreStages - 2>();
    __syncthreads();   // slice si landed; slice si - 1 is consumed
    issue(si + kScoreStages - 1);
    const float* qs = ring + (si % kScoreStages) * kScoreStage;
    const float* ks = qs + kT * kLdQ;
    if (live) {
      float s[4][4] = {}, small[4][4] = {};
#pragma unroll
      for (int u = 0; u < kDS / 16; ++u) {
        // two k8 steps of 16 dims: dims 4t4, 4t4 + 1 as k = t4, t4 + 4,
        // then 4t4 + 2, 4t4 + 3 (one float4 of a q or k row)
        const int col = 16 * u + 4 * t4;
        const float4 qa =
            *reinterpret_cast<const float4*>(qs + (16 * wt + g) * kLdQ + col);
        const float4 qb = *reinterpret_cast<const float4*>(
            qs + (16 * wt + g + 8) * kLdQ + col);
        const float av[2][4] = {{qa.x, qb.x, qa.y, qb.y},
                                {qa.z, qb.z, qa.w, qb.w}};
        uint32_t ah[2][4], al[2][4];
        split(av[0], ah[0], al[0]);
        split(av[1], ah[1], al[1]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (32 * wj + 8 * n > 16 * wt + 15) continue;   // above the diagonal
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + (32 * wj + 8 * n + g) * kLdQ + col);
          const float bv[2][2] = {{kv.x, kv.y}, {kv.z, kv.w}};
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            uint32_t bh2[2], bl2[2];
            split(bv[h2], bh2, bl2);
            sm::mma_m16n8k8_tf32(small[n], al[h2], bh2[0], bh2[1]);
            sm::mma_m16n8k8_tf32(small[n], ah[h2], bl2[0], bl2[1]);
            sm::mma_m16n8k8_tf32(s[n], ah[h2], bh2[0], bh2[1]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] += s[n][e] + small[n][e];
    }
    // u over these dims: 4 threads a dim, each over every fourth step
    {
      const int d = tid / 4, part = tid % 4;
      float a = 0.f;
#pragma unroll 4
      for (int t = part; t < cl; t += 4) a = fmaf(ks[t * kLdQ + d], w_s[t], a);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (part == 0) uc[si * kDS + d] = a;
    }
  }
  sm::cp_async_wait<0>();
  // S to scratch, every entry of the tile (0 above the diagonal and past
  // the chunk: those products read zero rows or are not formed)
  float* p_chunk = p_out + ((size_t)bh * nc + c) * kT * kT;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(p_chunk + (16 * wt + g + 8 * h) * kT +
                                 32 * wj + 8 * n + 2 * t4) =
          make_float2(sacc[n][2 * h], sacc[n][2 * h + 1]);
}

// ------------------------------------------------------ intra-chunk pass
// One block per row walking its chunks: what chains from chunk to chunk.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_intra_tf32x3(const float* __restrict__ q, const float* __restrict__ ig,
                   const float* __restrict__ fg, float* __restrict__ p_io,
                   const float* __restrict__ u_in, float* __restrict__ s_out,
                   float* __restrict__ n_out, float* __restrict__ m_out,
                   int S, int H, int chunk, float scale) {
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wt = warp & 3, wj = warp >> 2;   // steps 16 wt.., keys 32 wj..
  const int nc = (S + chunk - 1) / chunk;
  const int b = bh / H, hh = bh - b * H;
  const long long stride = (long long)H * D;
  const float* qr = q + ((size_t)b * S * H + hh) * D;
  const float* igr = ig + (size_t)b * S * H + hh;   // step s at s * H
  const float* fgr = fg + (size_t)b * S * H + hh;

  extern __shared__ float4 smem_v4[];
  float* n_s = reinterpret_cast<float*>(smem_v4);   // [2][D]: n before and
                                                    // after the chunk
  float* b_s = n_s + 2 * D;      // cumulative log forget gate
  float* g_s = b_s + kT;         // input gate
  float* mt_s = g_s + kT;        // stabiliser m_t
  float* in_s = mt_s + kT;       // inter_t
  float* w_s = in_s + kT;        // w_end
  float* qn_s = w_s + kT;        // scale q.n_prev
  float* pm_s = qn_s + kT;       // prefix max of g_j - b_j
  float* rs_s = pm_s + kT;       // [2][64] row sums of P by key half
  float* sc_s = rs_s + 2 * kT;   // [0] m, [1] m_new, [2] carry scale

  for (int d = tid; d < D; d += kThreads) n_s[d] = 0.f;
  if (tid == 0) sc_s[0] = 0.f;

  for (int c = 0; c < nc; ++c) {
    // the last chunk may be short: its missing steps are the pad steps of
    // the reference (ig = -1e30, fg = 1e4), which change nothing that is
    // read, so they are left out
    const int c0 = c * chunk, cl = min(chunk, S - c0);
    const float* n_old = n_s + (c & 1) * D;
    float* n_new = n_s + ((c + 1) & 1) * D;
    // this thread's entries of the chunk's S, from the score pass: rows
    // 16 wt + g (+ 8 h), keys 32 wj + 8 n + 2 t4 (+ 1)
    float* p_chunk = p_io + ((size_t)bh * nc + c) * kT * kT;
    float2 sv[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sv[n][h] = *reinterpret_cast<const float2*>(
            p_chunk + (16 * wt + g + 8 * h) * kT + 32 * wj + 8 * n + 2 * t4);
    __syncthreads();   // the previous chunk is done with the gates
    chunk_gates(igr, fgr, H, c0, cl, b_s, g_s);
    if (tid < 32) {
      // pm = prefix max of g_j - b_j (max_{j <= t} (b_t - b_j + g_j) =
      // b_t + pm_t), a shuffle scan as above
      const int t0 = 2 * lane;
      const float b0 = b_s[t0], b1 = b_s[t0 + 1];
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
    // q.n_old, 4 threads a step, straight from q
    float qn = 0.f;
    {
      const int t = tid / 4, part = tid % 4;
      if (t < cl) {
        const float* qt = qr + (c0 + t) * stride;
#pragma unroll 8
        for (int d = 4 * part; d < D; d += 16) {
          const float4 qv = *reinterpret_cast<const float4*>(qt + d);
          qn = fmaf(qv.x, n_old[d], fmaf(qv.y, n_old[d + 1], qn));
          qn = fmaf(qv.z, n_old[d + 2], fmaf(qv.w, n_old[d + 3], qn));
        }
      }
    }
    __syncthreads();
    if (tid < kT)
      w_s[tid] = tid < cl ? expf(b_s[cl - 1] - b_s[tid] + g_s[tid] -
                                 sc_s[1])
                          : 0.f;
    // n_new = sc n_old + sum_t w_end_t k_t, the sum from the score pass
    // under its own stabiliser
    {
      const float* uc = u_in + ((size_t)bh * nc + c) * (D + 4);
      const float sc = sc_s[2], ru = expf(uc[D] - sc_s[1]);
      for (int d = tid; d < D; d += kThreads)
        n_new[d] = fmaf(sc, n_old[d], ru * uc[d]);
    }

    // P = scale S o e^(decay - m_t) (0 above the diagonal and past the
    // chunk), over S in scratch, and its row sums
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 16 * wt + g + 8 * h;
        const int j = 32 * wj + 8 * n + 2 * t4;
        const float sr[2] = {sv[n][h].x, sv[n][h].y};
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = t < cl && j + e <= t;
          p[e] = ok ? sr[e] * scale *
                          expf(b_s[t] - b_s[j + e] + g_s[j + e] - mt_s[t])
                    : 0.f;
          rsum[h] += p[e];
        }
        *reinterpret_cast<float2*>(p_chunk + t * kT + j) =
            make_float2(p[0], p[1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
      if (t4 == 0) rs_s[wj * kT + 16 * wt + g + 8 * h] = rsum[h];
    }
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    qn += __shfl_xor_sync(0xffffffffu, qn, 2);
    if (tid % 4 == 0) qn_s[tid / 4] = qn * scale;
    __syncthreads();
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
    __syncthreads();   // every read of this chunk's scalars is done
    if (tid == 0) sc_s[0] = sc_s[1];
  }
  __syncthreads();
  if (n_out != nullptr) {
    const float* n_fin = n_s + (nc & 1) * D;
    for (int d = tid; d < D; d += kThreads)
      n_out[(size_t)bh * D + d] = n_fin[d];
    if (tid == 0) m_out[bh] = sc_s[0];
  }
}

// ------------------------------------------------------------ carry pass
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_carry_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ p_in,
                   const float* __restrict__ s_in, float* __restrict__ h,
                   float* __restrict__ C_out, int S, int H, int chunk,
                   float scale) {
  constexpr int NS = D / kDS;
  const int bh = blockIdx.x, j0 = blockIdx.y * kDV, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int rb = warp & 3, dh = warp >> 2;
  const int nc = (S + chunk - 1) / chunk;
  const int b = bh / H, hh = bh - b * H;
  const long long stride = (long long)H * D;
  const size_t base = ((size_t)b * S * H + hh) * D;

  extern __shared__ float4 smem_v4[];
  float* ring = reinterpret_cast<float*>(smem_v4);  // kStages x (q, k)
  float* v_s = ring + kStages * kCarryStage;   // [64][kLdV] the block's v
  float* p_s = v_s + kT * kLdV;                // [64][kLdP] P
  float* sca_s = p_s + kT * kLdP;   // [4][64] inter, den, w_end, sc
  float* vwh_s = sca_s + 4 * kT;    // [64 cols][kLdP] hi of (v o w_end)^T
  float* vwl_s = vwh_s + kDV * kLdP;   // its lo
  float* fold_s = vwl_s + kDV * kLdP;  // [8 warps][32][32 lanes] h sums
  float* is_s = fold_s + 8 * 32 * 32;  // [64] inter scale of this chunk
  float* den_s = is_s + kT;            // [64] den of this chunk
  float* sc_s = den_s + kT;            // [0] sc of this chunk

  auto chunk_len = [&](int c) { return min(chunk, S - c * chunk); };
  // v's block columns, P and the scalars of chunk c
  auto issue_chunk = [&](int c) {
    const int c0 = c * chunk, cl = chunk_len(c);
    const float* pc = p_in + ((size_t)bh * nc + c) * kT * kT;
    for (int i = tid; i < kT * 16; i += kThreads) {
      const int t = i / 16, p = i % 16;
      const bool ok = t < cl;
      cp16(v_s + t * kLdV + 4 * p,
           v + base + (ok ? (c0 + t) * stride + j0 + 4 * p : 0), ok);
      cp16(p_s + t * kLdP + 4 * p, pc + t * kT + 4 * p, true);
    }
    if (tid < kT)
      cp16(sca_s + 4 * tid, s_in + ((size_t)bh * nc + c) * 4 * kT + 4 * tid,
           true);
  };
  // slice i of the walk: head dims 64 (i % NS).. of chunk i / NS
  auto issue_slice = [&](int i) {
    if (i < nc * NS) {
      const int c = i / NS, d0 = (i - c * NS) * kDS;
      float* st = ring + (i % kStages) * kCarryStage;
      stage_slice(st, kLdQ, q + base, stride, c * chunk, chunk_len(c), d0);
      stage_slice(st + kT * kLdQ, kLdK, k + base, stride, c * chunk,
                  chunk_len(c), d0);
    }
    sm::cp_async_commit();   // empty groups keep the count aligned
  };

  // C^T[16 rb + g (+ 8 for e >= 2)][dim] of tile a = 4 si + 2 m + p, dim =
  // 64 si + 32 dh + 16 m + 2 (2 t4 + (e & 1)) + p
  float acc[4 * NS][4];
#pragma unroll
  for (int a = 0; a < 4 * NS; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
  // this thread's h sums: entry (2 mt + n) 4 + e at fold[32 entry], step
  // 16 mt + g (+ 8 for e >= 2), column 16 rb + 8 n + 2 t4 + (e & 1)
  float* fold = fold_s + warp * 32 * 32 + lane;

  issue_chunk(0);
  sm::cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue_slice(i);

  for (int c = 0; c < nc; ++c) {
    const int cl = chunk_len(c);
    sm::cp_async_wait<0>();
    __syncthreads();   // chunk c's v, P, scalars and first slices landed;
                       // chunk c - 1's h is written
    // (v o w_end)^T as hi / lo TF32 planes [col][t], split once a chunk
    for (int i = tid; i < kT * kDV; i += kThreads) {
      const int t = i % kT, col = i / kT;
      uint32_t hi, lo;
      sm::split_tf32_bits(v_s[t * kLdV + col] * sca_s[2 * kT + t], hi, lo);
      vwh_s[col * kLdP + t] = __uint_as_float(hi);
      vwl_s[col * kLdP + t] = __uint_as_float(lo);
    }
    if (tid < kT) {
      is_s[tid] = sca_s[tid] * scale;
      den_s[tid] = sca_s[kT + tid];
    } else if (tid == kT) {
      sc_s[0] = sca_s[3 * kT];
    }
    // the h sums start at P v for this warp's 32 steps (m tiles 2 dh,
    // 2 dh + 1) and 16 columns, summed from zero; the other m tiles at 0
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      float pv[2][2][4] = {};   // [k8 step parity][n]
      if (mt / 2 == dh && 16 * mt < cl) {
        // keys past the diagonal give P = 0
        for (int kk = 0; kk < 2 * mt + 2; ++kk) {
          uint32_t a[4], ah[4], al[4];
          ldmatrix_a(a, p_s, 16 * mt, 8 * kk);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sm::split_tf32_bits(__uint_as_float(a[e]), ah[e], al[e]);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float* vc = v_s + (8 * kk + t4) * kLdV + 16 * rb + 8 * n + g;
            const float bv[2] = {vc[0], vc[4 * kLdV]};
            uint32_t bh[2], bl[2];
            split(bv, bh, bl);
            sm::mma_m16n8k8_tf32x3(pv[kk % 2][n], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          fold[((2 * mt + n) * 4 + e) * 32] = pv[0][n][e] + pv[1][n][e];
    }
    __syncthreads();   // v, P and the scalars are read: chunk c + 1's stream
                       // in behind this chunk's slices
    if (c + 1 < nc) issue_chunk(c + 1);
    sm::cp_async_commit();
    const float sc = sc_s[0];

#pragma unroll
    for (int si = 0; si < NS; ++si) {
      const int i = c * NS + si;
      sm::cp_async_wait<kStages - 2>();
      __syncthreads();   // slice i landed; slice i - 1 is consumed
      issue_slice(i + kStages - 1);
      const float* qs = ring + (i % kStages) * kCarryStage;
      const float* ks = qs + kT * kLdQ;

      // h sums += inter scale (q C) over this warp's 32 dims of the slice,
      // with the carry as it was: A = q, B = C^T's accumulators (k = t4 is
      // column 2 t4, k = t4 + 4 column 2 t4 + 1)
      {
        float hs[4][2][4] = {};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t bh[2][2][2], bl[2][2][2];   // [p][n][k half]
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int a = 4 * si + 2 * m + p;
            const float b0[2] = {acc[a][0], acc[a][1]};
            const float b1[2] = {acc[a][2], acc[a][3]};
            split(b0, bh[p][0], bl[p][0]);
            split(b1, bh[p][1], bl[p][1]);
          }
          const int col = 32 * dh + 16 * m + 4 * t4;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            if (16 * mt >= cl) continue;
            const float4 x0 = *reinterpret_cast<const float4*>(
                qs + (16 * mt + g) * kLdQ + col);
            const float4 x1 = *reinterpret_cast<const float4*>(
                qs + (16 * mt + g + 8) * kLdQ + col);
            const float av[2][4] = {{x0.x, x1.x, x0.z, x1.z},
                                    {x0.y, x1.y, x0.w, x1.w}};
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              uint32_t ah[4], al[4];
              split(av[p], ah, al);
#pragma unroll
              for (int n = 0; n < 2; ++n)
                sm::mma_m16n8k8_tf32x3(hs[mt][n], ah, al, bh[p][n], bl[p][n]);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& f = fold[((2 * mt + n) * 4 + e) * 32];
              f = fmaf(hs[mt][n][e], is_s[16 * mt + g + 8 * (e >> 1)], f);
            }
      }

      // C^T[:, these dims] = sc C^T + (v o w_end)^T k[:, these dims], the
      // product summed from zero: A = the (v o w_end)^T planes, B = k
      {
        // tiles 2 m + p, the even and the odd k8 steps apart: twice the
        // independent mma chains, and shorter tensor-core sums
        float u[2][4][4] = {};
#pragma unroll
        for (int kk = 0; kk < kT / 8; ++kk) {
          if (8 * kk >= cl) break;   // steps past the chunk have w_end = 0
          uint32_t ah[4], al[4];
          ldmatrix_a(ah, vwh_s, 16 * rb, 8 * kk);
          ldmatrix_a(al, vwl_s, 16 * rb, 8 * kk);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* kc =
                ks + (8 * kk + t4) * kLdK + 32 * dh + 16 * m + 2 * g;
            const float2 k0 = *reinterpret_cast<const float2*>(kc);
            const float2 k1 = *reinterpret_cast<const float2*>(kc + 4 * kLdK);
            const float bv[2][2] = {{k0.x, k1.x}, {k0.y, k1.y}};
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              uint32_t bh[2], bl[2];
              split(bv[p], bh, bl);
              sm::mma_m16n8k8_tf32x3(u[kk % 2][2 * m + p], ah, al, bh, bl);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * si + a][e] =
                fmaf(sc, acc[4 * si + a][e], u[0][a][e] + u[1][a][e]);
      }
    }
    __syncthreads();   // every warp's h sums are in
    // h = (sums of warp (rb, 0) + sums of warp (rb, 1)) / den for this
    // warp's 32 steps and 16 columns
    {
      const float* f0 = fold_s + rb * 32 * 32 + lane;
      const float* f1 = fold_s + (rb + 4) * 32 * 32 + lane;
      float* hc = h + base + (size_t)c * chunk * stride + j0 + 16 * rb + 2 * t4;
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const int mt = 2 * dh + mm;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = 16 * mt + g + 8 * hr;
          if (t >= cl) continue;
          const float inv = 1.f / den_s[t];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int r = ((2 * mt + n) * 4 + 2 * hr) * 32;
            *reinterpret_cast<float2*>(hc + t * stride + 8 * n) = make_float2(
                (f0[r] + f1[r]) * inv, (f0[r + 32] + f1[r + 32]) * inv);
          }
        }
      }
    }
  }
  sm::cp_async_wait<0>();

  if (C_out != nullptr) {
    float* Cb = C_out + (size_t)bh * D * D + j0 + 16 * rb + g;
#pragma unroll
    for (int a = 0; a < 4 * NS; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int si = a / 4, m = (a / 2) % 2, p = a % 2;
        const int d = 64 * si + 32 * dh + 16 * m + 4 * t4 + 2 * (e & 1) + p;
        Cb[(size_t)d * D + 8 * (e >> 1)] = acc[a][e];
      }
  }
}

size_t scores_smem() {
  return sizeof(float) * ((size_t)kScoreStages * kScoreStage + 3 * kT);
}

size_t intra_smem(int D) {
  return sizeof(float) * ((size_t)2 * D + 9 * kT + 4);
}

size_t carry_smem() {
  return sizeof(float) *
         ((size_t)kStages * kCarryStage + kT * kLdV + kT * kLdP + 4 * kT +
          2 * kDV * kLdP + 8 * 32 * 32 + 2 * kT + 4);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* ig, const float* fg, float* h, float* C_out,
                   float* n_out, float* m_out, float* p_scratch,
                   float* s_scratch, int B, int S, int H, int chunk,
                   float scale, cudaStream_t stream) {
  auto scores = mlstm_scores_tf32x3<D>;
  auto intra = mlstm_intra_tf32x3<D>;
  auto carry = mlstm_carry_tf32x3<D>;
  cudaError_t err = repro::allow_smem(scores, scores_smem());
  if (err != cudaSuccess) return err;
  err = repro::allow_smem(carry, carry_smem());
  if (err != cudaSuccess) return err;
  const int nc = (S + chunk - 1) / chunk;
  // s_scratch: the scalars [BH, nc, 4, 64], then u and M [BH, nc, D + 4]
  float* u_scratch = s_scratch + (size_t)B * H * nc * 4 * kT;
  scores<<<dim3(nc, B * H), kThreads, scores_smem(), stream>>>(
      q, k, ig, fg, p_scratch, u_scratch, S, H, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  intra<<<B * H, kThreads, intra_smem(D), stream>>>(
      q, ig, fg, p_scratch, u_scratch, s_scratch, n_out, m_out, S, H, chunk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry<<<dim3(B * H, D / kDV), kThreads, carry_smem(), stream>>>(
      q, k, v, p_scratch, s_scratch, h, C_out, S, H, chunk, scale);
  return cudaGetLastError();
}

}  // namespace

// The model layout: q/k/v/h [B, S, H, D] float32 (16-byte aligned),
// ig/fg [B, S, H] float32, all contiguous; any S >= 1 (a short last chunk
// stands for the reference's padded one), chunk 1..64, D in {64, 128,
// 256, 512}.  With nc = ceil(S / chunk): p_scratch float32
// [B * H, nc, 64, 64] (S from the score pass, then P) and s_scratch
// float32 [B * H, nc, 4, 64] followed by [B * H, nc, D + 4] (the score
// pass's u and M for the intra pass) hold what the passes hand on.
// C_out [B*H, D, D], n_out [B*H, D], m_out [B*H] (float32) receive the
// final carry when C_out is not null.  Launches the three passes in
// stream order; returns cudaGetLastError() of the first that fails, else
// of the last.
extern "C" int mlstm_scan_tf32x3(const void* q, const void* k, const void* v,
                                 const void* ig, const void* fg, void* h,
                                 void* C_out, void* n_out, void* m_out,
                                 void* p_scratch, void* s_scratch, int B,
                                 int S, int H, int D, int chunk, float scale,
                                 int device, void* stream) {
  if (B < 1 || H < 1 || (long long)B * H > 65535 || S < 1 || chunk < 1 ||
      chunk > kT || !p_scratch || !s_scratch ||
      (C_out != nullptr && (n_out == nullptr || m_out == nullptr)))
    return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(h),
                        static_cast<const void*>(p_scratch),
                        static_cast<const void*>(s_scratch)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* igf = static_cast<const float*>(ig);
  const float* fgf = static_cast<const float*>(fg);
  float* hf = static_cast<float*>(h);
  float* Cf = static_cast<float*>(C_out);
  float* nf = static_cast<float*>(n_out);
  float* mf = static_cast<float*>(m_out);
  float* pf = static_cast<float*>(p_scratch);
  float* sf = static_cast<float*>(s_scratch);
  switch (D) {
    case 64:
      return launch<64>(qf, kf, vf, igf, fgf, hf, Cf, nf, mf, pf, sf, B, S,
                        H, chunk, scale, s);
    case 128:
      return launch<128>(qf, kf, vf, igf, fgf, hf, Cf, nf, mf, pf, sf, B, S,
                         H, chunk, scale, s);
    case 256:
      return launch<256>(qf, kf, vf, igf, fgf, hf, Cf, nf, mf, pf, sf, B, S,
                         H, chunk, scale, s);
    case 512:
      return launch<512>(qf, kf, vf, igf, fgf, hf, Cf, nf, mf, pf, sf, B, S,
                         H, chunk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* mlstm_scan_tf32x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
