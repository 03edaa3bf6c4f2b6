// Chunked SSD / decayed linear-attention scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py::ssm_scan
// (def :64, body _ssm_kernel :25, pallas_call :76).  It computes the
// function of its oracle, repro/models/layers/ssm.py::chunked_linear_attn
// (:29-111), per (sequence, head):
//
//   H_t = exp(d_t) H_{t-1} + exp(g_t) k_t v_t^T ;   y_t = q_t . H_t
//
// chunk by chunk: with cum the inclusive cumsum of d inside the chunk and
// total its last entry,
//   y_i   = sum_{j<=i} (q_i.k_j) exp(min(cum_i - cum_j + g_j, 30)) v_j
//           + exp(min(cum_i, 30)) q_i . H_prev
//   H_new = exp(total) H_prev + sum_j exp(min(total - cum_j + g_j, 30)) k_j v_j^T
// Beyond the Pallas kernel, and as the oracle does: S need not be a
// multiple of the chunk (rows past S are identity steps, decay 0 and gate
// -1e30, and are neither read nor written), the state starts from
// `h0` when given, and the final state is written out (Mamba-2 prefill
// carries it into decode).  q and k are read through strides, so Mamba-2's
// B and C, one group shared by every head, arrive as a stride-0 head view
// instead of a copy per head.
//
// What bounds it on an H100.  At zamba2-1.2b's prefill (B=1, S=1000, H=64,
// N=P=64, chunk 128) one layer does 2.08 GFLOP of products on 26.4 MB of
// inputs and outputs: on the CUDA cores' fp32 rate (67 TFLOP/s) the
// operations bound it at 0.031 ms; on the tensor cores' bf16 rate the
// bytes do, 0.008 ms.
//
// Two bodies; the wrapper (kernels/ssm_scan/ops.py::body_for) picks one
// before the launch.
//
// FMA body (every fp32 call, and every call the tensor-core body has no
// instance for; simple and right first): the Pallas grid's sequential
// chunk axis becomes a loop inside one block per (sequence, head, 32
// columns of P): the columns of the state are independent in both y and
// the update, so splitting P gives 128 blocks at zamba2's B=1 where one
// block per head would give 64.  The block keeps its (N x 32) slice of the
// state resident in shared memory across chunks, and per chunk stages its
// v columns (Q x 32) and the scores (Q x Q) as fp32.  q and k it stages a
// slice of NT = 64 columns of N at a time (q as Q x NT, k transposed as
// NT x (Q + 1), padded a column against bank conflicts), so any N fits:
// per chunk it walks the slices twice, first summing the scores q_i.k_j
// over them into the (Q x Q) tile, then, slice by slice, adding
// q_i[slice] . H_prev[slice] to each output's carried sum and updating
// those rows of the state; where N <= NT the one slice stays staged from
// the first walk, and at N > NT each output's sum q_i . H_prev so far is
// kept in shared memory between slices.  Every sum runs over n (and j) in
// order, one fmaf a term.  xlstm-125m's mLSTM (N = 384 and, with the ones
// column that carries the normalizer, P = 385) takes 214,784 B a block at
// chunk 128; its prefill (B = 1, H = 4) runs 52 blocks, each redoing the
// chunk's scores for its column tile.  Every product is fp32 FMA on the
// CUDA cores.
//
// Tensor-core body (bf16 q/k/v at N = P in {16, 32, 64, 128}): the SSD
// decomposition (Dao & Gu 2024, sec. 6), so no block walks the chunks in
// order.  One call enqueues three launches on the stream:
//   (a) chunk sums: one block per (chunk, head) computes S_c = (k o wk)^T v
//       (N x P) and total_c;
//   (b) state passing: one thread per state element walks the chunks,
//       H_c = exp(total_c) H_{c-1} + S_c, in the reference's order, and
//       writes the state entering each chunk and the final state;
//   (c) chunk outputs: one block per (chunk, head) computes
//       y = (Q K^T o W) V + diag(exp(min(cum, 30))) Q H_{c-1}.
// At zamba2's prefill that is 512 (chunk, head) tiles in (a) and (c)
// against the FMA body's 128 serial blocks.  Every product runs as
// mma.sync m16n8k16 on bf16 operands into fp32.  Q K^T is exact that way
// (bf16 x bf16 products are exact in fp32); the other three products each
// have an fp32 operand -- Q K^T o W, the state H_{c-1}, k o wk -- which one
// rounding to bf16 would move by 2^-9 a term (~20x the 1e-4 limit of
// max|ref|), so each is split into bf16 hi + lo (lo = bf16(x - hi)) and
// both halves go through the tensor cores into one fp32 accumulator: 2^-18
// a term.  q/k/v tiles land in swizzled shared memory by 16-byte cp.async;
// a stride-0 q/k head view is read through its strides, each block
// staging its chunk's rows of the one shared group (the staging and
// fragment loaders in ssd_tile.cuh, shared with the backward's "mma"
// body).  The per-chunk states
// (fp32 sums, and the entering states as bf16 hi/lo) go through device
// memory, 8.4 MB each at zamba2's prefill.  No atomics: every output is
// written by one thread, so a launch gives the same bits as the last.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHUNK = 128;
constexpr int PT = 32;             // state columns (of P) per block
constexpr float NEG_INF = -1e30f;  // the reference's padded-step gate

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The block's columns [p0, p0 + pt) of the (N x P) state, into and out of
// its (N x PT) shared tile; a null state loads zeros.  `at` is the state at
// column p0.
__device__ __forceinline__ void load_state(float* hs, const float* at, int N, int P, int pt) {
  for (int i = threadIdx.x; i < N * pt; i += THREADS) {
    const int n = i / pt, p = i - n * pt;
    hs[n * PT + p] = at ? at[(size_t)n * P + p] : 0.f;
  }
}

__device__ __forceinline__ void store_state(float* at, const float* hs, int N, int P, int pt) {
  for (int i = threadIdx.x; i < N * pt; i += THREADS) {
    const int n = i / pt, p = i - n * pt;
    at[(size_t)n * P + p] = hs[n * PT + p];
  }
}

// Stage a chunk's rows of v's block columns, the decay (into `cum`, before
// its cumsum) and the gate as fp32; rows at or past S are identity steps
// (v 0, decay 0, gate -1e30).
template <typename T>
__device__ __forceinline__ void stage_chunk_rows(float* vs, float* cum, float* gs, const T* v,
                                                 const float* ld, const float* lg, int b, int h,
                                                 int S, int H, int P, int c0, int p0, int pt,
                                                 int nrow, int chunk) {
  for (int i = threadIdx.x; i < chunk * pt; i += THREADS) {
    const int r = i / pt, p = i - r * pt;
    vs[r * PT + p] = r < nrow
        ? to_f(v[(((size_t)b * S + c0 + r) * H + h) * P + p0 + p]) : 0.f;
  }
  for (int r = threadIdx.x; r < chunk; r += THREADS) {
    const size_t at = ((size_t)b * S + c0 + r) * H + h;
    cum[r] = r < nrow ? ld[at] : 0.f;
    gs[r] = r < nrow ? lg[at] : NEG_INF;
  }
}

// Inclusive cumsum of cum[0, chunk) in place, by one warp: each lane sums
// 4 consecutive rows, then the lanes' totals are scanned across the warp.
__device__ __forceinline__ void chunk_cumsum(float* cum, int chunk) {
  const int lane = threadIdx.x;
  const int r0 = lane * 4;
  float loc[4];
  float run = 0.f;
  for (int e = 0; e < 4; ++e) {
    run += (r0 + e < chunk) ? cum[r0 + e] : 0.f;
    loc[e] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = incl - run;
  for (int e = 0; e < 4; ++e)
    if (r0 + e < chunk) cum[r0 + e] = excl + loc[e];
}

constexpr int NT = 64;                               // columns of N a slice, at most

// Stage rows [0, chunk) of q and k, columns [n0, n0 + nt), as fp32: q as
// (chunk, sw), k transposed as (sw, KLD); rows at or past S are zeros.
template <typename T>
__device__ __forceinline__ void stage_slice(float* qs, float* kt, const T* qb, const T* kb,
                                            int c0, int nrow, int chunk, int n0, int nt,
                                            int sw, int KLD, int q_ss, int k_ss) {
  for (int i = threadIdx.x; i < chunk * nt; i += THREADS) {
    const int r = i / nt, n = i - r * nt;
    float qv = 0.f, kv = 0.f;
    if (r < nrow) {
      qv = to_f(qb[(size_t)(c0 + r) * q_ss + n0 + n]);
      kv = to_f(kb[(size_t)(c0 + r) * k_ss + n0 + n]);
    }
    qs[r * sw + n] = qv;
    kt[n * KLD + r] = kv;
  }
}

// SLICED: N > NT, q and k walked in slices; else N <= NT, one slice whose
// walk the compiler unrolls away.
template <typename T, bool SLICED>
__global__ void __launch_bounds__(THREADS) ssm_scan_kernel(
    const T* __restrict__ q,            // (B, S, H, N) through strides
    const T* __restrict__ k,            // (B, S, H, N) through strides
    const T* __restrict__ v,            // (B, S, H, P) contiguous
    const float* __restrict__ ld,       // (B, S, H) log decay
    const float* __restrict__ lg,       // (B, S, H) log gate
    const float* __restrict__ h0,       // (B, H, N, P) or null
    float* __restrict__ y,              // (B, S, H, P)
    float* __restrict__ hT,             // (B, H, N, P)
    int S, int H, int N, int P, int chunk,
    int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh) {
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int p0 = blockIdx.y * PT;
  const int pt = min(PT, P - p0);
  const int tid = threadIdx.x;
  const int sw = SLICED ? NT : N;             // columns of a staged slice
  const int slices = SLICED ? (N + NT - 1) / NT : 1;
  const int KLD = chunk + 1;                  // row length of the k^T slice
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                           // (N, PT) the state's columns
  float* sc = hs + N * PT;                    // (chunk, chunk) scores * w
  float* vs = sc + chunk * chunk;             // (chunk, PT)
  float* qs = vs + chunk * PT;                // (chunk, sw) a slice of q
  float* kt = qs + chunk * sw;                // (sw, KLD) a slice of k^T
  float* cum = kt + sw * KLD;                 // (chunk,)
  float* gs = cum + chunk;                    // (chunk,)
  float* wk = gs + chunk;                     // (chunk,)
  float* ys = wk + chunk;                     // (chunk, PT) q . H_prev so far; N > NT only

  const size_t state_base = ((size_t)b * H + h) * N * P + p0;
  load_state(hs, h0 ? h0 + state_base : nullptr, N, P, pt);
  const T* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const T* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int nrow = min(chunk, S - c0);      // rows at or past S: padding
    __syncthreads();                          // the last chunk's reads are done
    stage_chunk_rows(vs, cum, gs, v, ld, lg, b, h, S, H, P, c0, p0, pt, nrow, chunk);
    stage_slice(qs, kt, qb, kb, c0, nrow, chunk, 0, sw, sw, KLD, q_ss, k_ss);
    __syncthreads();
    if (tid < 32) chunk_cumsum(cum, chunk);
    __syncthreads();
    const float total = cum[chunk - 1];
    for (int r = tid; r < chunk; r += THREADS)
      wk[r] = expf(fminf(total - cum[r] + gs[r], 30.f));
    // (1) the scores of the live lower triangle, summed over the slices:
    // sc[i][j] = (q_i.k_j) w_ij, j <= i, weighted after the last slice
    for (int sl = 0; sl < slices; ++sl) {
      const int n0 = sl * NT, nt = min(sw, N - n0);
      const bool last = sl == slices - 1;
      if (n0) {
        stage_slice(qs, kt, qb, kb, c0, nrow, chunk, n0, nt, sw, KLD, q_ss, k_ss);
        __syncthreads();
      }
      for (int e = tid; e < nrow * chunk; e += THREADS) {
        const int i = e / chunk, j = e - i * chunk;
        if (j > i) continue;
        const float* qi = qs + i * sw;
        const float* kj = kt + j;
        float s = n0 ? sc[e] : 0.f;
        for (int n = 0; n < nt; ++n) s = fmaf(qi[n], kj[n * KLD], s);
        sc[e] = last ? s * expf(fminf(cum[i] - cum[j] + gs[j], 30.f)) : s;
      }
      __syncthreads();                        // the slice is read
    }
    // (2) slice by slice: q_i . H_prev[slice] into each output's sum so far
    // (ys), then those rows of H = decay H + (k o wk)^T v; at the last
    // slice y = intra-chunk term + exp(min(cum_i, 30)) q_i . H_prev
    const float decay = expf(total);
    for (int sl = 0; sl < slices; ++sl) {
      const int n0 = sl * NT, nt = min(sw, N - n0);
      const bool last = sl == slices - 1;
      if (SLICED) {                           // else the one slice is still staged
        stage_slice(qs, kt, qb, kb, c0, nrow, chunk, n0, nt, sw, KLD, q_ss, k_ss);
        __syncthreads();
      }
      for (int e = tid; e < nrow * pt; e += THREADS) {
        const int i = e / pt, p = e - i * pt;
        const float* qi = qs + i * sw;
        const float* hn = hs + n0 * PT + p;
        float yo = 0.f;
        if (n0) yo = ys[i * PT + p];
        for (int n = 0; n < nt; ++n) yo = fmaf(qi[n], hn[n * PT], yo);
        if (!last) {
          ys[i * PT + p] = yo;
          continue;
        }
        const float* si = sc + i * chunk;
        float yd = 0.f;
        for (int j = 0; j <= i; ++j) yd = fmaf(si[j], vs[j * PT + p], yd);
        y[(((size_t)b * S + c0 + i) * H + h) * P + p0 + p] =
            yd + expf(fminf(cum[i], 30.f)) * yo;
      }
      __syncthreads();                        // H_prev's rows are read; update them
      for (int e = tid; e < nt * pt; e += THREADS) {
        const int n = e / pt, p = e - n * pt;
        const float* kn = kt + n * KLD;
        float s = 0.f;
        for (int j = 0; j < nrow; ++j) s = fmaf(kn[j] * wk[j], vs[j * PT + p], s);
        hs[(n0 + n) * PT + p] = decay * hs[(n0 + n) * PT + p] + s;
      }
      if (!last) __syncthreads();             // the slice is read before the next
    }
  }
  __syncthreads();
  store_state(hT + state_base, hs, N, P, pt);
}

// Shared memory of one block, in bytes (ssm_smem_bytes gives it to the
// wrapper, which checks it against the 227 KB a block may use).
size_t smem_bytes(int N, int chunk) {
  const size_t sw = N < NT ? N : NT;
  return sizeof(float) * ((size_t)N * PT + (size_t)chunk * chunk + (size_t)chunk * PT +
                          (size_t)chunk * sw + sw * (chunk + 1) + 3 * (size_t)chunk +
                          (N > NT ? (size_t)chunk * PT : 0));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ld, const void* lg,
           const void* h0, void* y, void* hT, int B, int S, int H, int N, int P, int chunk,
           int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, chunk);
  auto kernel = N > NT ? ssm_scan_kernel<T, true> : ssm_scan_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * H, (P + PT - 1) / PT);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ld), static_cast<const float*>(lg),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(hT), S, H, N,
      P, chunk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh);
  return (int)cudaGetLastError();
}

namespace ssd {

using mma_attn::mma16816;
using ssd_tile::bf16;
using ssd_tile::cp_async_commit;
using ssd_tile::cp_async_wait;
using ssd_tile::frag_a;
using ssd_tile::frag_at_scaled;
using ssd_tile::frag_b;
using ssd_tile::frag_bt;
using ssd_tile::prepare_rows;
using ssd_tile::split2;
using ssd_tile::stage_rows;
using ssd_tile::stage_tile;
using ssd_tile::TC_THREADS;
using ssd_tile::WARPS;

constexpr int PASS_THREADS = 256;   // phase (b)

// Shared memory of one block of phase (a) (out = false) or (c) (out =
// true), in bytes, in the order `tiles` lays it out: the chunk's q ((c)
// only) and k tiles, its v tile, (c) the entering state as bf16 hi and lo,
// and the decay and gate rows.
__host__ __device__ constexpr int tile_bytes(bool out, int N, int P, int rows) {
  return (out ? 2 : 1) * rows * N * 2 + rows * P * 2 + (out ? 2 * N * P * 2 : 0) + 2 * rows * 4;
}

struct Tiles {
  bf16 *q, *k, *v, *hhi, *hlo;
  float *dec, *gate;
};

__device__ __forceinline__ Tiles tiles(unsigned char* smem, bool out, int N, int P, int rows) {
  Tiles s;
  s.q = reinterpret_cast<bf16*>(smem);
  s.k = s.q + (out ? rows * N : 0);
  s.v = s.k + rows * N;
  s.hhi = s.v + rows * P;
  s.hlo = s.hhi + N * P;
  s.dec = reinterpret_cast<float*>(out ? s.hlo + N * P : s.hhi);
  s.gate = s.dec + rows;
  return s;
}

// Phase (a): per (chunk, head), wk_j = exp(min(total - cum_j + g_j, 30)) and
// S_c = sum_j (k_j wk_j) v_j^T, (k o wk)^T as the A operand split into hi
// and lo.  Warp w takes the 16-row strips w, w + 4, .. of N.
template <int N, int P>
__global__ void __launch_bounds__(TC_THREADS) ssd_sums_kernel(
    const bf16* __restrict__ k, const bf16* __restrict__ v, const float* __restrict__ ld,
    const float* __restrict__ lg, float* __restrict__ sums, float* __restrict__ totals, int S,
    int H, int chunk, int C, int k_sb, int k_ss, int k_sh) {
  const int c = blockIdx.x % C, bh = blockIdx.x / C, b = bh / H, h = bh - b * H;
  const int c0 = c * chunk, live = min(chunk, S - c0), rows = (chunk + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles s = tiles(smem, false, N, P, rows);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, cq = lane % 4;

  stage_tile<N>(s.k, k + (size_t)b * k_sb + (size_t)c0 * k_ss + (size_t)h * k_sh, k_ss, live,
                rows);
  stage_tile<P>(s.v, v + (((size_t)b * S + c0) * H + h) * P, (size_t)H * P, live, rows);
  stage_rows(s.dec, s.gate, ld, lg, ((size_t)b * S + c0) * H + h, H, live, rows);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  prepare_rows(s.dec, s.gate, live, rows);
  __syncthreads();
  const float total = s.dec[rows - 1];
  for (int r = threadIdx.x; r < rows; r += TC_THREADS)   // gate -> wk, in place
    s.gate[r] = expf(fminf(total - s.dec[r] + s.gate[r], 30.f));
  if (threadIdx.x == 0) totals[(size_t)bh * C + c] = total;
  __syncthreads();
  const float* wk = s.gate;
  for (int sn = warp; sn < N / 16; sn += WARPS) {
    float acc[P / 8][4];
#pragma unroll
    for (int i = 0; i < P / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int kc = 0; kc < rows / 16; ++kc) {
      const int j0 = 16 * kc;
      uint32_t hi[4], lo[4];   // A = (k o wk)^T of rows n 16 sn .., keys j0 ..
      frag_at_scaled<N>(hi, lo, s.k, wk, j0, sn);
#pragma unroll
      for (int dn = 0; dn < P / 8; dn += 2) {
        uint32_t bv[4];   // B of columns 8 dn .. and 8 (dn + 1) .. for keys j0 ..
        frag_bt<P>(bv, s.v, j0, dn);
        mma16816(acc[dn], hi, bv[0], bv[1]);
        mma16816(acc[dn + 1], hi, bv[2], bv[3]);
        mma16816(acc[dn], lo, bv[0], bv[1]);
        mma16816(acc[dn + 1], lo, bv[2], bv[3]);
      }
    }
    float* out = sums + (((size_t)bh * C + c) * N + 16 * sn) * P;
#pragma unroll
    for (int dn = 0; dn < P / 8; ++dn) {
      const int p = 8 * dn + 2 * cq;
      *reinterpret_cast<float2*>(out + g * P + p) = make_float2(acc[dn][0], acc[dn][1]);
      *reinterpret_cast<float2*>(out + (g + 8) * P + p) = make_float2(acc[dn][2], acc[dn][3]);
    }
  }
}

// Phase (b): one thread per element of one (sequence, head)'s state walks
// the chunks in order, as the reference's loop does: it writes the state
// entering chunk c (as bf16 hi and lo, the B operand of phase (c)), then
// H = exp(total_c) H + S_c; the state after the last chunk is the final
// state.
__global__ void __launch_bounds__(PASS_THREADS) ssd_pass_kernel(
    const float* __restrict__ sums, const float* __restrict__ totals,
    const float* __restrict__ h0, float* __restrict__ hT, bf16* __restrict__ hin, int C,
    int NP) {
  const size_t bh = blockIdx.x;
  const int e = blockIdx.y * PASS_THREADS + threadIdx.x;
  if (e >= NP) return;
  float h = h0 ? h0[bh * NP + e] : 0.f;
  for (int c = 0; c < C; ++c) {
    const size_t at = bh * C + c;
    const float s = sums[at * NP + e];
    const bf16 hi = __float2bfloat16_rn(h);
    hin[at * 2 * NP + e] = hi;
    hin[at * 2 * NP + NP + e] = __float2bfloat16_rn(h - __bfloat162float(hi));
    h = expf(totals[at]) * h + s;
  }
  hT[bh * NP + e] = h;
}

// Phase (c): per (chunk, head), y = exp(min(cum_i, 30)) q_i . H_prev
// (H_prev as hi + lo) + sum_{j<=i} (q_i.k_j) w_ij v_j (the weighted scores
// split into hi + lo).  A warp takes 16-row strips w and 7 - w of the
// chunk: strip s walks s + 1 key tiles of 16, so each warp does 9 at
// chunk 128.
template <int N, int P>
__global__ void __launch_bounds__(TC_THREADS) ssd_out_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ lg, const bf16* __restrict__ hin,
    float* __restrict__ y, int S, int H, int chunk, int C, int q_sb, int q_ss, int q_sh, int k_sb,
    int k_ss, int k_sh) {
  const int c = blockIdx.x % C, bh = blockIdx.x / C, b = bh / H, h = bh - b * H;
  const int c0 = c * chunk, live = min(chunk, S - c0), rows = (chunk + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles s = tiles(smem, true, N, P, rows);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, cq = lane % 4;

  stage_tile<N>(s.q, q + (size_t)b * q_sb + (size_t)c0 * q_ss + (size_t)h * q_sh, q_ss, live,
                rows);
  stage_tile<N>(s.k, k + (size_t)b * k_sb + (size_t)c0 * k_ss + (size_t)h * k_sh, k_ss, live,
                rows);
  stage_tile<P>(s.v, v + (((size_t)b * S + c0) * H + h) * P, (size_t)H * P, live, rows);
  const bf16* st = hin + ((size_t)bh * C + c) * 2 * N * P;
  stage_tile<P>(s.hhi, st, P, N, N);
  stage_tile<P>(s.hlo, st + N * P, P, N, N);
  stage_rows(s.dec, s.gate, ld, lg, ((size_t)b * S + c0) * H + h, H, live, rows);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  prepare_rows(s.dec, s.gate, live, rows);
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    const int sr = pass ? 2 * WARPS - 1 - warp : warp, i0 = 16 * sr;
    if (i0 >= rows || i0 >= live) continue;
    uint32_t qf[N / 16][4];   // A of the strip's 16 rows, each k16 step of N
#pragma unroll
    for (int kc = 0; kc < N / 16; ++kc) frag_a<N>(qf[kc], s.q, i0, kc);
    float acc[P / 8][4];
#pragma unroll
    for (int i = 0; i < P / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    // q . H_prev, H_prev (N x P) as B in two halves
#pragma unroll
    for (int kc = 0; kc < N / 16; ++kc) {
#pragma unroll
      for (int dn = 0; dn < P / 8; dn += 2) {
        uint32_t hhi[4], hlo[4];
        frag_bt<P>(hhi, s.hhi, 16 * kc, dn);
        frag_bt<P>(hlo, s.hlo, 16 * kc, dn);
        mma16816(acc[dn], qf[kc], hhi[0], hhi[1]);
        mma16816(acc[dn + 1], qf[kc], hhi[2], hhi[3]);
        mma16816(acc[dn], qf[kc], hlo[0], hlo[1]);
        mma16816(acc[dn + 1], qf[kc], hlo[2], hlo[3]);
      }
    }
    const int ia = i0 + g, ib = ia + 8;   // this thread's rows
    const float ca = s.dec[ia], cb = s.dec[ib];
    const float wa = expf(fminf(ca, 30.f)), wb = expf(fminf(cb, 30.f));
#pragma unroll
    for (int i = 0; i < P / 8; ++i) {
      acc[i][0] *= wa;
      acc[i][1] *= wa;
      acc[i][2] *= wb;
      acc[i][3] *= wb;
    }
    // the causal key tiles, the diagonal one last
    for (int jt = 0; jt <= sr; ++jt) {
      const int j0 = 16 * jt;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc = 0; kc < N / 16; ++kc) {
        uint32_t bk[4];   // B of keys j0 .. j0 + 7 and j0 + 8 .. for k16 step kc
        frag_b<N>(bk, s.k, j0, kc);
        mma16816(sc[0], qf[kc], bk[0], bk[1]);
        mma16816(sc[1], qf[kc], bk[2], bk[3]);
      }
      // (q_i.k_j) w_ij, w_ij = exp(min(cum_i - cum_j + g_j, 30)) for j <= i,
      // else 0; as A fragments of keys j0 .., hi in m[0] and lo in m[1]
      uint32_t m[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int j = j0 + 8 * nb + 2 * cq;
        const float x0 = j <= ia ? sc[nb][0] * expf(fminf(ca - s.dec[j] + s.gate[j], 30.f)) : 0.f;
        const float x1 =
            j + 1 <= ia ? sc[nb][1] * expf(fminf(ca - s.dec[j + 1] + s.gate[j + 1], 30.f)) : 0.f;
        const float x2 = j <= ib ? sc[nb][2] * expf(fminf(cb - s.dec[j] + s.gate[j], 30.f)) : 0.f;
        const float x3 =
            j + 1 <= ib ? sc[nb][3] * expf(fminf(cb - s.dec[j + 1] + s.gate[j + 1], 30.f)) : 0.f;
        split2(x0, x1, m[0][2 * nb], m[1][2 * nb]);
        split2(x2, x3, m[0][2 * nb + 1], m[1][2 * nb + 1]);
      }
#pragma unroll
      for (int dn = 0; dn < P / 8; dn += 2) {
        uint32_t bv[4];   // B of columns 8 dn .. and 8 (dn + 1) .. for keys j0 ..
        frag_bt<P>(bv, s.v, j0, dn);
#pragma unroll
        for (int part = 0; part < 2; ++part) {   // the weighted scores' hi, then lo
          mma16816(acc[dn], m[part], bv[0], bv[1]);
          mma16816(acc[dn + 1], m[part], bv[2], bv[3]);
        }
      }
    }
    float* ya = y + (((size_t)b * S + c0 + ia) * H + h) * P;
    float* yb = y + (((size_t)b * S + c0 + ib) * H + h) * P;
#pragma unroll
    for (int dn = 0; dn < P / 8; ++dn) {
      const int p = 8 * dn + 2 * cq;
      if (ia < live) *reinterpret_cast<float2*>(ya + p) = make_float2(acc[dn][0], acc[dn][1]);
      if (ib < live) *reinterpret_cast<float2*>(yb + p) = make_float2(acc[dn][2], acc[dn][3]);
    }
  }
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int N, int P>
int launch(const void* q, const void* k, const void* v, const void* ld, const void* lg,
           const void* h0, void* y, void* hT, void* sums, void* totals, void* hin, int B, int S,
           int H, int chunk, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
           cudaStream_t stream) {
  const int rows = (chunk + 15) & ~15, C = (S + chunk - 1) / chunk;
  const int sa = tile_bytes(false, N, P, rows), sc = tile_bytes(true, N, P, rows);
  int err = allow_smem(ssd_sums_kernel<N, P>, sa);
  if (!err) err = allow_smem(ssd_out_kernel<N, P>, sc);
  if (err) return err;
  const int blocks = C * B * H;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const float *ldf = static_cast<const float*>(ld), *lgf = static_cast<const float*>(lg);
  ssd_sums_kernel<N, P><<<blocks, TC_THREADS, sa, stream>>>(
      kb, vb, ldf, lgf, static_cast<float*>(sums), static_cast<float*>(totals), S, H, chunk, C,
      k_sb, k_ss, k_sh);
  ssd_pass_kernel<<<dim3(B * H, (N * P + PASS_THREADS - 1) / PASS_THREADS), PASS_THREADS, 0,
                    stream>>>(static_cast<const float*>(sums), static_cast<const float*>(totals),
                              static_cast<const float*>(h0), static_cast<float*>(hT),
                              static_cast<bf16*>(hin), C, N * P);
  ssd_out_kernel<N, P><<<blocks, TC_THREADS, sc, stream>>>(
      qb, kb, vb, ldf, lgf, static_cast<const bf16*>(hin), static_cast<float*>(y), S, H, chunk,
      C, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh);
  return (int)cudaGetLastError();
}

}  // namespace ssd

}  // namespace

// Shared memory one block of a body uses, in bytes (body 0 = FMA; 1 =
// tensor cores, the larger of its two tiled phases), or -1 for a width the
// tensor-core body has no instance of or an unknown body.  The wrapper
// checks it against what a block may use before it launches.
extern "C" int ssm_smem_bytes(int body, int N, int P, int chunk) {
  if (body == 0) return (int)smem_bytes(N, chunk);
  if (body != 1) return -1;
  const int rows = (chunk + 15) & ~15;
  if (N != P || (N != 16 && N != 32 && N != 64 && N != 128)) return -1;
  const int a = ssd::tile_bytes(false, N, P, rows), c = ssd::tile_bytes(true, N, P, rows);
  return a > c ? a : c;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it; the decay, gate,
// states and y are fp32).  h0 may be null (a zero state).  chunk <= 128.
// body: 0 = FMA (any N and P, any alignment), 1 = tensor cores (bf16, N =
// P in {16, 32, 64, 128}; sums (B, H, C, N, P) fp32, totals (B, H, C) fp32
// and hin (B, H, C, 2, N, P) bf16 its scratch, C = cdiv(S, chunk); q, k,
// v 16-byte aligned).  Returns 0 or the CUDA error of a launch.
extern "C" int ssm_scan(const void* q, const void* k, const void* v, const void* ld,
                        const void* lg, const void* h0, void* y, void* hT, void* sums,
                        void* totals, void* hin, int dtype, int B, int S, int H, int N, int P,
                        int chunk, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                        int body, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1 || N != P) return (int)cudaErrorInvalidValue;
    auto run = [&](auto launch) {
      return launch(q, k, v, ld, lg, h0, y, hT, sums, totals, hin, B, S, H, chunk, q_sb, q_ss,
                    q_sh, k_sb, k_ss, k_sh, s);
    };
    switch (N) {
      case 16: return run(ssd::launch<16, 16>);
      case 32: return run(ssd::launch<32, 32>);
      case 64: return run(ssd::launch<64, 64>);
      case 128: return run(ssd::launch<128, 128>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ld, lg, h0, y, hT, B, S, H, N, P, chunk, q_sb, q_ss,
                                 q_sh, k_sb, k_ss, k_sh, s);
  return launch<float>(q, k, v, ld, lg, h0, y, hT, B, S, H, N, P, chunk, q_sb, q_ss, q_sh,
                       k_sb, k_ss, k_sh, s);
}
