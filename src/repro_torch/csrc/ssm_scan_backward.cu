// Backward of the chunked SSD / decayed linear-attention scan for Hopper
// (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel: the TPU kernel whose function it
// differentiates, src/repro/kernels/ssm_scan/kernel.py::ssm_scan (:64),
// has no backward (no custom_vjp in the JAX package); the reference trains
// through its plain function, repro/models/layers/ssm.py::
// chunked_linear_attn (:27-113), and JAX differentiates that.  This kernel
// gives the port's K5 forward (ssm_scan.cu) its gradient, so that Mamba-2
// training runs its scan through K5.
//
// The forward, per (sequence, head), chunk by chunk (cum: the inclusive
// cumsum of the log decay d inside the chunk, T = cum_{Q-1}, g the log
// gate; rows past S are identity steps, d = 0, g = -1e30):
//   W_ij  = exp(min(cum_i - cum_j + g_j, 30))  (j <= i)
//   y_i   = sum_{j<=i} (q_i.k_j) W_ij v_j + wq_i q_i . H_{c-1},  wq_i = exp(min(cum_i, 30))
//   H_c   = exp(T_c) H_{c-1} + S_c,  S_c = sum_j wk_j k_j v_j^T,
//           wk_j = exp(min(T - cum_j + g_j, 30))
// Given dy (and the final state's gradient d_final, or none), with G_c the
// gradient reaching H_c:
//   G_{C-1} = d_final ;  G_{c-1} = exp(T_c) G_c + U_c,  U_c = sum_i wq_i q_i dy_i^T
//   dT_c   += exp(T_c) sum(G_c o H_{c-1})
//   dq_i    = sum_j dA_ij k_j + wq_i H_{c-1} dy_i,   dA_ij = (dy_i.v_j) W_ij
//   dk_j    = sum_i dA_ij q_i + wk_j G_c v_j
//   dv_j    = sum_i (q_i.k_j) W_ij dy_i + wk_j G_c^T k_j
//   dl_ij   = (dy_i.v_j)(q_i.k_j) W_ij  where the clamp is not active (else 0)
//   dcum_i  = sum_j dl_ij - sum_i' dl_i'i + [cum_i < 30] wq_i q_i.(H_{c-1} dy_i)
//             - [.. < 30] wk_i k_i.(G_c v_i) ;   dcum_{Q-1} += dT_c
//   dg_j    = sum_i dl_ij + [.. < 30] wk_j k_j.(G_c v_j)
//   dd_t    = sum_{i >= t} dcum_i  (the reverse cumsum in the chunk)
//   dh0     = G_{-1}
// Above the clamp at 30 the derivative is 0 (the reference's minimum);
// padded rows contribute nothing and no 0 x inf arises (every weight is
// exp of at most 30).
//
// What bounds it on an H100.  At zamba2-1.2b's training shape (B=1, S=512,
// H=64, N=P=64, chunk 128) the gradient needs 2.7 GFLOP of products on
// 25.8 MB: the bytes bound it at 0.0077 ms on the tensor cores' side, the
// 67 TFLOP/s fp32 rate at 0.040 ms on the CUDA cores'.  At xlstm-125m's
// (B=1, S=512, H=4, N=384, P=385, per-head q/k) 3.54 GFLOP on 12.6 MB:
// the bytes at 0.0038 ms, the fp32 rate at 0.053 ms.
//
// Five launches of one call (six where N or P is over 128), on the
// caller's stream; nothing walks the
// chunks in order except the state passing, and no atomics (each output is
// written by one thread, every sum taken in a fixed order), so two
// launches give the same bits:
//   (1) sums: per (chunk, head): S_c, U_c (N x P) and T_c;
//   (2) pass: one thread per state element walks the chunks forward
//       (H_{c-1} over S_c in place) and back (G_c over U_c), and each
//       warp sums its elements' G_c o H_{c-1} for dT_c;
//   (3) rows: dq and the row sums of dl, and the inter-chunk term;
//   (4) cols: dk, dv, the column sums of dl, and the summary terms
//       (where N or P is over 128, (S) scores before (3) computes dA and
//       dl's sums once for both);
//   (5) finish: one warp per (chunk, head): dT_c, then the reverse cumsum
//       as a scan across the lanes (four rows a lane), d log_decay and
//       d log_gate.
// Passes (2) and (5) are one code for both bodies; the wrapper
// (kernels/ssm_scan/ops.py::backward_body_for, the forward's rule) picks
// the body of (1), (3) and (4) before the launch.
//
// FMA body (every fp32 call, every width the "mma" body has no instance
// of, and any call forced onto it): tiles of 64 rows staged as fp32 in
// shared memory (rows padded to an odd stride), every product a
// register-tiled fp32 product on them (fma_tile.cuh).  At N and P up to
// 128 each tile holds whole rows, N and P compiled in two classes, up to
// 64 and up to 128 (a narrower width is zero-padded), one block per
// (chunk, head, tile of rows) in (3) and (4).  Wider (xlstm-125m's mLSTM:
// N = 384, P = 385) it walks N and P in slices of 64 columns, with the
// chunk's scores computed once by a launch of its own and the sums over
// all of N taken as partials that (5) adds in order: six launches; see
// "the FMA body at N or P over 128" below.
//
// Tensor-core body "mma" (bf16 q/k/v at N = P in {16, 32, 64, 128}, each
// 16-byte aligned: every call whose forward ran on the SSD body): blocks
// of four warps, one per (chunk, head) in (3) and (4), two in (1) (S_c's
// and U_c's, each staging only its operands), the forward's staging and
// fragment loaders (ssd_tile.cuh): q/k/v by 16-byte cp.async
// into swizzled shared memory (q and k through their strides), fragments
// by ldmatrix, every product mma.sync m16n8k16 on bf16 into fp32.  A bf16
// x bf16 product is exact that way; every fp32 operand -- dy, the states
// H_{c-1} and G_c, k o wk, q o wq, dA and (QK^T o W) -- is carried as a
// bf16 pair hi = bf16(x), lo = bf16(x - hi), and a product of two fp32
// operands takes three products (hi hi + hi lo + lo hi): modelled on the
// CPU against fp64 (tests/test_torch_backward.py), dropping lo x hi of
// such a product, or carrying the fp32 operands as bf16 alone, puts the
// fp32 gradients 26-67x past their limit, where the pairs leave them at
// ~0.1 of it.  dy lands as fp32 and is split into hi and lo tiles as it
// is staged; (2) writes H_{c-1} and G_c as hi / lo pairs for (3) and (4)
// to stage by cp.async.  Each warp takes the 16-row strips w and 7 - w of
// the chunk, so the causal triangle's tiles split evenly (9 a warp at
// chunk 128).  The row sums of dl and of the inter-chunk and summary terms
// are taken on the fp32 accumulators.
//
// q and k are read through their strides (a stride-0 head view of
// Mamba-2's one group), the gradients written contiguous (B, S, H, .).
#include "fma_tile.cuh"
#include "ssd_tile.cuh"

namespace {

using fma_tile::from_f;
using fma_tile::mm;
using fma_tile::row_sum;
using fma_tile::to_f;
using fma_tile::tx;
using fma_tile::ty;

constexpr int THREADS = fma_tile::THREADS;
constexpr int MAX_CHUNK = 128;
constexpr int BT = 64;             // rows of a tile
constexpr int LDT = BT + 1;        // row stride of a (BT, BT) tile
constexpr float NEG_INF = -1e30f;  // the reference's padded-step gate

// Where one chunk of one (sequence, head) lies.
struct Chunk {
  int b, h, c, c0, nrow;   // nrow: rows of the chunk before S
  size_t bhc;              // (b * H + h) * C + c
};

__device__ __forceinline__ Chunk chunk_of(int blk, int H, int C, int S, int chunk) {
  Chunk k;
  k.c = blk % C;
  const int bh = blk / C;
  k.b = bh / H;
  k.h = bh - k.b * H;
  k.c0 = k.c * chunk;
  k.nrow = min(chunk, S - k.c0);
  k.bhc = blk;
  return k;
}

// The chunk's log decay and gate into shared memory (rows past S: decay 0,
// gate -1e30), then cum = the inclusive cumsum of the decay, summed as the
// forward's FMA body sums it: each lane of the first warp 4 consecutive
// rows, then the lanes' totals scanned across the warp.  Ends synced.
__device__ void load_decay(float* cum, float* gs, const float* __restrict__ ld,
                           const float* __restrict__ lg, const Chunk& ck, int S, int H,
                           int chunk) {
  const int tid = threadIdx.x;
  for (int r = tid; r < chunk; r += blockDim.x) {
    const size_t at = ((size_t)ck.b * S + ck.c0 + r) * H + ck.h;
    cum[r] = r < ck.nrow ? ld[at] : 0.f;
    gs[r] = r < ck.nrow ? lg[at] : NEG_INF;
  }
  __syncthreads();
  if (tid < 32) {
    const int r0 = tid * 4;
    float loc[4];
    float run = 0.f;
    for (int e = 0; e < 4; ++e) {
      run += (r0 + e < chunk) ? cum[r0 + e] : 0.f;
      loc[e] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += o;
    }
    const float excl = incl - run;
    for (int e = 0; e < 4; ++e)
      if (r0 + e < chunk) cum[r0 + e] = excl + loc[e];
  }
  __syncthreads();
}

// Rows [r0, r0 + n) of the chunk of one head of a (B, S, H, w) tensor read
// through strides (sb, ss, sh elements) into dst (rows x ld fp32), zero
// past n rows and w columns.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, const Chunk& ck, int r0,
                                           int n, int w, int rows, int ld, size_t sb,
                                           size_t ss, size_t sh) {
  fma_tile::stage(dst, src + ck.b * sb + (size_t)ck.h * sh + (size_t)(ck.c0 + r0) * ss, ss, n,
                  w, rows, ld);
}

// The intra-chunk weight of (i, j), j <= i: exp(min(lw, 30)) and whether
// the clamp lets the derivative through.
__device__ __forceinline__ float weight(const float* cum, const float* gs, int i, int j,
                                        bool& live) {
  const float lw = cum[i] - cum[j] + gs[j];
  live = lw < 30.f;
  return expf(fminf(lw, 30.f));
}

// ---- (1) sums ----------------------------------------------------------
// One block per (chunk, head, WN x WN tile of the N x P sums): blockIdx.y
// walks the tiles N-major (one tile where N, P <= WN).
template <typename T, int WN>
__global__ void __launch_bounds__(THREADS) ssm_bwd_sums_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ lg, const float* __restrict__ dy,
    float* __restrict__ sums, float* __restrict__ ubuf, float* __restrict__ totals, int S,
    int H, int N, int P, int chunk, int C, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
    int k_sh) {
  constexpr int LD = WN + 1, TW = WN / 16;
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  const int ns = (N + WN - 1) / WN;
  const int n0 = (blockIdx.y % ns) * WN, p0 = (blockIdx.y / ns) * WN;
  const int nw = min(WN, N - n0), pw = min(WN, P - p0);
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                 // (MAX_CHUNK,)
  float* gs = cum + MAX_CHUNK;
  float* w = gs + MAX_CHUNK;
  float* as = w + MAX_CHUNK;         // (chunk, LD): k (q) rows, weighted
  float* bs = as + chunk * LD;       // (chunk, LD): v (dy) rows
  load_decay(cum, gs, ld, lg, ck, S, H, chunk);
  const float total = cum[chunk - 1];
  if (threadIdx.x == 0 && blockIdx.y == 0) totals[ck.bhc] = total;
  const size_t vsb = (size_t)S * H * P, vss = (size_t)H * P;
  for (int half = 0; half < 2; ++half) {
    // S_c = sum_j wk_j k_j v_j^T, then U_c = sum_i wq_i q_i dy_i^T
    for (int r = threadIdx.x; r < chunk; r += THREADS)
      w[r] = half == 0 ? expf(fminf(total - cum[r] + gs[r], 30.f)) : expf(fminf(cum[r], 30.f));
    if (half == 0) {
      stage_rows(as, k + n0, ck, 0, ck.nrow, nw, chunk, LD, k_sb, k_ss, k_sh);
      stage_rows(bs, v + p0, ck, 0, ck.nrow, pw, chunk, LD, vsb, vss, P);
    } else {
      stage_rows(as, q + n0, ck, 0, ck.nrow, nw, chunk, LD, q_sb, q_ss, q_sh);
      stage_rows(bs, dy + p0, ck, 0, ck.nrow, pw, chunk, LD, vsb, vss, P);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < chunk * LD; i += THREADS) as[i] *= w[i / LD];
    __syncthreads();
    float acc[TW][TW];
    fma_tile::zero(acc);
    mm(acc, as, 1, LD, bs, LD, 1, ck.nrow);   // (n, p) = sum_j as[j][n] bs[j][p]
    float* dst = (half == 0 ? sums : ubuf) + ck.bhc * N * P + (size_t)n0 * P + p0;
#pragma unroll
    for (int a = 0; a < TW; ++a)
#pragma unroll
      for (int c = 0; c < TW; ++c) {
        const int n = ty() + 16 * a, p = tx() + 16 * c;
        if (n < nw && p < pw) dst[n * P + p] = acc[a][c];
      }
    __syncthreads();   // as / bs / w are read before the second half restages them
  }
}

// ---- (2) pass ----------------------------------------------------------
// x as a bf16 pair: hi at dst[at], lo = bf16(x - hi) at dst[at + lo_at].
__device__ __forceinline__ void put_pair(__nv_bfloat16* dst, size_t at, size_t lo_at, float x) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  dst[at] = hi;
  dst[at + lo_at] = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// sums[c] <- H_{c-1} (the state entering chunk c), ubuf[c] <- G_c; dtp[c,
// warp] = exp(T_c) * this warp's share of sum(G_c o H_{c-1}) (no block
// barrier); dh0 = G_{-1} (when given).  The "mma" body's hin / gin (else
// null) get H_{c-1} and G_c as bf16 hi / lo pairs (B, H, C, 2, N, P)
// instead: G_c is then not written back over U_c.  Each walk loads PF
// chunks' operands at once, ahead of the stores, so their latencies
// overlap instead of adding up chunk after chunk.
constexpr int PF = 4;

__global__ void __launch_bounds__(THREADS) ssm_bwd_pass_kernel(
    float* __restrict__ sums, float* __restrict__ ubuf, const float* __restrict__ totals,
    const float* __restrict__ h0, const float* __restrict__ dfin, float* __restrict__ dh0,
    float* __restrict__ dtp, __nv_bfloat16* __restrict__ hin, __nv_bfloat16* __restrict__ gin,
    int C, int NP) {
  const size_t bh = blockIdx.x;
  const int e = blockIdx.y * THREADS + threadIdx.x;
  const int nw = gridDim.y * (THREADS / 32), w = blockIdx.y * (THREADS / 32) + threadIdx.x / 32;
  const bool live = e < NP;
  float hs = live && h0 ? h0[bh * NP + e] : 0.f;
  for (int c0 = 0; c0 < C; c0 += PF) {
    float s[PF];
#pragma unroll
    for (int i = 0; i < PF; ++i)
      s[i] = live && c0 + i < C ? sums[(bh * C + c0 + i) * NP + e] : 0.f;
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int c = c0 + i;
      if (c < C) {
        if (live) {
          sums[(bh * C + c) * NP + e] = hs;
          if (hin) put_pair(hin, (bh * C + c) * 2 * NP + e, NP, hs);
        }
        hs = expf(totals[bh * C + c]) * hs + s[i];
      }
    }
  }
  float g = live && dfin ? dfin[bh * NP + e] : 0.f;
  for (int c1 = C - 1; c1 >= 0; c1 -= PF) {
    float hp[PF], u[PF];
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const bool in = live && c1 - i >= 0;
      hp[i] = in ? sums[(bh * C + c1 - i) * NP + e] : 0.f;
      u[i] = in ? ubuf[(bh * C + c1 - i) * NP + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int c = c1 - i;
      if (c >= 0) {
        const size_t at = (bh * C + c) * NP + e;
        const float decay = expf(totals[bh * C + c]);
        if (live) {
          if (gin)
            put_pair(gin, (bh * C + c) * 2 * NP + e, NP, g);
          else
            ubuf[at] = g;
        }
        float prod = g * hp[i];
        for (int off = 16; off; off >>= 1) prod += __shfl_xor_sync(0xffffffffu, prod, off);
        if (threadIdx.x % 32 == 0) dtp[(bh * C + c) * nw + w] = decay * prod;
        g = decay * g + u[i];
      }
    }
  }
  if (live && dh0) dh0[bh * NP + e] = g;
}

// ---- (3) rows ----------------------------------------------------------
// dq's inter-chunk term and the row's share of rsum, for the rows i0 ..
// i0 + ni - 1 of a tile: z = H_{c-1} dy_i over the thread's columns of
// the (staged) q columns qs; dq_i += wq_i z_i, and rsum[i] = sum_j dl_ij
// (rs, the thread's share) + [cum_i < 30] wq_i q_i.z_i, each summed across
// the thread's row in a fixed order.
template <int TW>
__device__ __forceinline__ void dq_inter(float (&dq_acc)[4][TW], const float (&z)[4][TW],
                                         const float* qs, int ld, const float* cum, int i0,
                                         int ni, const float (&rs)[4], float* rsum) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ii = ty() + 16 * a, i = i0 + min(ii, ni - 1);
    const float wq = expf(fminf(cum[i], 30.f));
    float dwq = 0.f;
#pragma unroll
    for (int c = 0; c < TW; ++c) {
      dwq = fmaf(qs[ii * ld + tx() + 16 * c], z[a][c], dwq);
      dq_acc[a][c] = fmaf(wq, z[a][c], dq_acc[a][c]);
    }
    const float dl = row_sum(rs[a]);
    dwq = row_sum(dwq);
    if (tx() == 0 && ii < ni) rsum[i] = dl + (cum[i] < 30.f ? dwq * wq : 0.f);
  }
}

// For the rows i of one tile: dq_i (intra-chunk and inter-chunk terms) and
// rsum_i = sum_j dl_ij + [cum_i < 30] wq_i q_i.(H_{c-1} dy_i).
template <typename T, int WN>
__global__ void __launch_bounds__(THREADS) ssm_bwd_rows_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ lg, const float* __restrict__ dy,
    const float* __restrict__ hprev, T* __restrict__ dq, float* __restrict__ rsum, int S,
    int H, int N, int P, int chunk, int C, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
    int k_sh) {
  constexpr int LD = WN + 1, TW = WN / 16;
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  const int i0 = blockIdx.y * BT, ni = min(BT, ck.nrow - i0);
  if (ni <= 0) return;   // padding rows only: nothing to write
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                 // (MAX_CHUNK,)
  float* gs = cum + MAX_CHUNK;
  float* qs = gs + MAX_CHUNK;        // (BT, LD)
  float* dys = qs + BT * LD;         // (BT, LD)
  float* ks = dys + BT * LD;         // (BT, LD); with vs, H_{c-1} (WN, LD) after the loop
  float* vs = ks + BT * LD;          // (BT, LD)
  float* dat = vs + BT * LD;         // (BT, LDT) dA: rows i by rows j
  load_decay(cum, gs, ld, lg, ck, S, H, chunk);
  const size_t vsb = (size_t)S * H * P, vss = (size_t)H * P;
  stage_rows(qs, q, ck, i0, ni, N, BT, LD, q_sb, q_ss, q_sh);
  stage_rows(dys, dy, ck, i0, ni, P, BT, LD, vsb, vss, P);
  float dq_acc[4][TW], rs[4] = {0.f, 0.f, 0.f, 0.f};
  fma_tile::zero(dq_acc);
  for (int j0 = 0; j0 <= i0; j0 += BT) {
    const int nj = min(BT, ck.nrow - j0);
    __syncthreads();   // the last tile's dA and rows are consumed
    stage_rows(ks, k, ck, j0, nj, N, BT, LD, k_sb, k_ss, k_sh);
    stage_rows(vs, v, ck, j0, nj, P, BT, LD, vsb, vss, P);
    __syncthreads();
    float sa[4][4], dm[4][4];    // q_i.k_j and dy_i.v_j
    fma_tile::zero(sa);
    fma_tile::zero(dm);
    mm(sa, qs, LD, 1, ks, 1, LD, N);
    mm(dm, dys, LD, 1, vs, 1, LD, P);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ii = ty() + 16 * a, jj = tx() + 16 * c;
        float da = 0.f;
        if (ii < ni && jj < nj && j0 + jj <= i0 + ii) {
          bool live;
          da = dm[a][c] * weight(cum, gs, i0 + ii, j0 + jj, live);
          if (live) rs[a] = fmaf(da, sa[a][c], rs[a]);
        }
        dat[ii * LDT + jj] = da;
      }
    __syncthreads();
    mm(dq_acc, dat, LDT, 1, ks, LD, 1, nj);   // dq += dA K
  }
  __syncthreads();
  // inter-chunk: z_i = H_{c-1} dy_i; dq_i += wq_i z_i
  float* hs = ks;
  fma_tile::stage(hs, hprev + ck.bhc * N * P, (size_t)P, N, P, WN, LD);
  __syncthreads();
  float z[4][TW];
  fma_tile::zero(z);
  mm(z, dys, LD, 1, hs, 1, LD, P);   // (i, n) = sum_p dy_i[p] H[n][p]
  dq_inter(dq_acc, z, qs, LD, cum, i0, ni, rs, rsum + ck.bhc * chunk);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < TW; ++c) {
      const int ii = ty() + 16 * a, n = tx() + 16 * c;
      if (ii < ni && n < N)
        dq[(((size_t)ck.b * S + ck.c0 + i0 + ii) * H + ck.h) * N + n] = from_f<T>(dq_acc[a][c]);
    }
}

// ---- (4) cols ----------------------------------------------------------
// For the rows j of one tile: dk_j, dv_j, csum_j = sum_i dl_ij and lk_j =
// [.. < 30] wk_j k_j.(G_c v_j).
template <typename T, int WN>
__global__ void __launch_bounds__(THREADS) ssm_bwd_cols_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ lg, const float* __restrict__ dy,
    const float* __restrict__ gbuf, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ csum, float* __restrict__ lks, int S, int H, int N, int P, int chunk,
    int C, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh) {
  constexpr int LD = WN + 1, TW = WN / 16;
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  const int j0 = blockIdx.y * BT, nj = min(BT, ck.nrow - j0);
  if (nj <= 0) return;
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                 // (MAX_CHUNK,)
  float* gs = cum + MAX_CHUNK;
  float* ks = gs + MAX_CHUNK;        // (BT, LD)
  float* vs = ks + BT * LD;          // (BT, LD)
  float* qs = vs + BT * LD;          // (BT, LD); with dys, G_c (WN, LD) after the loop
  float* dys = qs + BT * LD;         // (BT, LD)
  float* mt = dys + BT * LD;         // (BT, LDT) (q_i.k_j) W_ij: rows j by rows i
  float* dat = mt + BT * LDT;        // (BT, LDT) dA, rows j by rows i
  load_decay(cum, gs, ld, lg, ck, S, H, chunk);
  const size_t vsb = (size_t)S * H * P, vss = (size_t)H * P;
  stage_rows(ks, k, ck, j0, nj, N, BT, LD, k_sb, k_ss, k_sh);
  stage_rows(vs, v, ck, j0, nj, P, BT, LD, vsb, vss, P);
  float dk_acc[4][TW], dv_acc[4][TW], cs[4] = {0.f, 0.f, 0.f, 0.f};
  fma_tile::zero(dk_acc);
  fma_tile::zero(dv_acc);
  for (int i0 = j0; i0 < ck.nrow; i0 += BT) {
    const int ni = min(BT, ck.nrow - i0);
    __syncthreads();   // the last tile's products and rows are consumed
    stage_rows(qs, q, ck, i0, ni, N, BT, LD, q_sb, q_ss, q_sh);
    stage_rows(dys, dy, ck, i0, ni, P, BT, LD, vsb, vss, P);
    __syncthreads();
    float sa[4][4], dm[4][4];    // k_j.q_i and v_j.dy_i: rows j by rows i
    fma_tile::zero(sa);
    fma_tile::zero(dm);
    mm(sa, ks, LD, 1, qs, 1, LD, N);
    mm(dm, vs, LD, 1, dys, 1, LD, P);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = ty() + 16 * a, ii = tx() + 16 * c;
        float m = 0.f, da = 0.f;
        if (ii < ni && jj < nj && j0 + jj <= i0 + ii) {
          bool live;
          const float wgt = weight(cum, gs, i0 + ii, j0 + jj, live);
          m = sa[a][c] * wgt;
          da = dm[a][c] * wgt;
          if (live) cs[a] = fmaf(da, sa[a][c], cs[a]);
        }
        mt[jj * LDT + ii] = m;
        dat[jj * LDT + ii] = da;
      }
    __syncthreads();
    mm(dk_acc, dat, LDT, 1, qs, LD, 1, ni);   // dk += dA^T Q
    mm(dv_acc, mt, LDT, 1, dys, LD, 1, ni);   // dv += (QK^T o W)^T dY
  }
  __syncthreads();
  // the chunk summary S_c = sum_j wk_j k_j v_j^T: dk_j += wk_j G_c v_j,
  // dv_j += wk_j G_c^T k_j
  float* gsm = qs;
  fma_tile::stage(gsm, gbuf + ck.bhc * N * P, (size_t)P, N, P, WN, LD);
  __syncthreads();
  float gv[4][TW], gtk[4][TW];
  fma_tile::zero(gv);
  fma_tile::zero(gtk);
  mm(gv, vs, LD, 1, gsm, 1, LD, P);    // (j, n) = sum_p v_j[p] G[n][p]
  mm(gtk, ks, LD, 1, gsm, LD, 1, N);   // (j, p) = sum_n k_j[n] G[n][p]
  const float total = cum[chunk - 1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int jj = ty() + 16 * a, j = j0 + min(jj, nj - 1);
    const float lk = total - cum[j] + gs[j];
    const float wk = expf(fminf(lk, 30.f));
    float dwk = 0.f;
#pragma unroll
    for (int c = 0; c < TW; ++c) {
      dwk = fmaf(ks[jj * LD + tx() + 16 * c], gv[a][c], dwk);
      dk_acc[a][c] = fmaf(wk, gv[a][c], dk_acc[a][c]);
      dv_acc[a][c] = fmaf(wk, gtk[a][c], dv_acc[a][c]);
    }
    const float dl = row_sum(cs[a]);
    dwk = row_sum(dwk);
    if (tx() == 0 && jj < nj) {
      csum[ck.bhc * chunk + j] = dl;
      lks[ck.bhc * chunk + j] = lk < 30.f ? dwk * wk : 0.f;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < TW; ++c) {
      const int jj = ty() + 16 * a, w = tx() + 16 * c;
      if (jj >= nj) continue;
      const size_t row = ((size_t)ck.b * S + ck.c0 + j0 + jj) * H + ck.h;
      if (w < N) dk[row * N + w] = from_f<T>(dk_acc[a][c]);
      if (w < P) dv[row * P + w] = from_f<T>(dv_acc[a][c]);
    }
}

// ---- (5) finish --------------------------------------------------------
// Row t's sum of n partials laid out `chunk` apart (n = 1: the value itself),
// in order.
__device__ __forceinline__ float parts(const float* p, int n, int chunk, int t) {
  float s = p[t];
  for (int i = 1; i < n; ++i) s += p[(size_t)i * chunk + t];
  return s;
}

// dcum_i = rsum_i - csum_i - lk_i (+ dT_c on the chunk's last row); d log
// decay its reverse cumsum, d log gate csum + lk.  rsum, csum and lk come
// as nr, nc and nl partials a row (one each where the body does not walk N
// and P in slices), each summed in order first.  One warp per chunk: dT_c
// (the pass's nw warp shares and the lk) summed across the lanes, then
// each lane takes four consecutive rows (chunk <= 128), sums them from the
// last, and the lanes' sums are scanned from the last lane down; every sum
// in a fixed order.
__global__ void __launch_bounds__(32) ssm_bwd_finish_kernel(
    const float* __restrict__ rsum, const float* __restrict__ csum,
    const float* __restrict__ lks, const float* __restrict__ dtp, float* __restrict__ dld,
    float* __restrict__ dlg, int S, int H, int chunk, int C, int nw, int nr, int nc, int nl) {
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  const int lane = threadIdx.x;
  const float* rs = rsum + ck.bhc * nr * chunk;
  const float* cs = csum + ck.bhc * nc * chunk;
  const float* lk = lks + ck.bhc * nl * chunk;
  float dt = 0.f;
  for (int i = lane; i < nw; i += 32) dt += dtp[ck.bhc * nw + i];
  for (int j = lane; j < ck.nrow; j += 32) dt += parts(lk, nl, chunk, j);
  // a butterfly: every lane adds the same two operands at each step, so
  // every lane ends with the same dT_c
  for (int off = 16; off; off >>= 1) dt += __shfl_xor_sync(0xffffffffu, dt, off);
  // dT_c lands on the chunk's last row (padding included): every row sees it
  const int t0 = 4 * lane;
  float loc[4], run = 0.f;
#pragma unroll
  for (int e = 3; e >= 0; --e) {
    const int t = t0 + e;
    run += t < ck.nrow
               ? parts(rs, nr, chunk, t) - parts(cs, nc, chunk, t) - parts(lk, nl, chunk, t)
               : 0.f;
    loc[e] = run;
  }
  float incl = run;   // the sum of this lane's rows and every later lane's
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += o;
  }
  float after = __shfl_down_sync(0xffffffffu, incl, 1);   // every later lane's
  if (lane == 31) after = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = t0 + e;
    if (t >= ck.nrow) break;
    const size_t at = ((size_t)ck.b * S + ck.c0 + t) * H + ck.h;
    dld[at] = dt + (after + loc[e]);
    dlg[at] = parts(cs, nc, chunk, t) + parts(lk, nl, chunk, t);
  }
}

size_t sums_smem(int WN, int chunk) {
  return (3 * MAX_CHUNK + 2 * (size_t)chunk * (WN + 1)) * sizeof(float);
}
size_t rows_smem(int WN) {
  return (2 * MAX_CHUNK + 4 * (size_t)BT * (WN + 1) + BT * LDT) * sizeof(float);
}
size_t cols_smem(int WN) {
  return (2 * MAX_CHUNK + 4 * (size_t)BT * (WN + 1) + 2 * BT * LDT) * sizeof(float);
}
int width_class(int N, int P) { return N <= 64 && P <= 64 ? 64 : 128; }

template <typename Kern>
int allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int WN>
int launch(const void* q, const void* k, const void* v, const float* ld, const float* lg,
           const float* h0, const float* dy, const float* dfin, void* dq, void* dk, void* dv,
           float* dld, float* dlg, float* dh0, float* scratch, int B, int S, int H, int N, int P,
           int chunk, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
           cudaStream_t stream, int last_pass) {
  const int C = (S + chunk - 1) / chunk, NP = N * P;
  const int nb = (NP + THREADS - 1) / THREADS, tiles = (chunk + BT - 1) / BT;
  const size_t bhc = (size_t)B * H * C;
  float* sums = scratch;                 // (B, H, C, N, P): S_c, then H_{c-1}
  float* ubuf = sums + bhc * NP;         // (B, H, C, N, P): U_c, then G_c
  float* totals = ubuf + bhc * NP;       // (B, H, C)
  float* dtp = totals + bhc;             // (B, H, C, nb * 8): the warps' shares of dT_c
  float* rsum = dtp + bhc * nb * (THREADS / 32);   // (B, H, C, chunk) each
  float* csum = rsum + bhc * chunk;
  float* lks = csum + bhc * chunk;
  const size_t s1 = sums_smem(WN, chunk), s3 = rows_smem(WN), s4 = cols_smem(WN);
  int err = allow_smem(ssm_bwd_sums_kernel<T, WN>, s1);
  if (!err) err = allow_smem(ssm_bwd_rows_kernel<T, WN>, s3);
  if (!err) err = allow_smem(ssm_bwd_cols_kernel<T, WN>, s4);
  if (err) return err;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  ssm_bwd_sums_kernel<T, WN><<<(unsigned)bhc, THREADS, s1, stream>>>(
      qt, kt, vt, ld, lg, dy, sums, ubuf, totals, S, H, N, P, chunk, C, q_sb, q_ss, q_sh, k_sb,
      k_ss, k_sh);
  if (last_pass == 1) return (int)cudaGetLastError();
  ssm_bwd_pass_kernel<<<dim3(B * H, nb), THREADS, 0, stream>>>(sums, ubuf, totals, h0, dfin,
                                                               dh0, dtp, nullptr, nullptr, C,
                                                               NP);
  if (last_pass == 2) return (int)cudaGetLastError();
  ssm_bwd_rows_kernel<T, WN><<<dim3((unsigned)bhc, tiles), THREADS, s3, stream>>>(
      qt, kt, vt, ld, lg, dy, sums, static_cast<T*>(dq), rsum, S, H, N, P, chunk, C, q_sb, q_ss,
      q_sh, k_sb, k_ss, k_sh);
  if (last_pass == 3) return (int)cudaGetLastError();
  ssm_bwd_cols_kernel<T, WN><<<dim3((unsigned)bhc, tiles), THREADS, s4, stream>>>(
      qt, kt, vt, ld, lg, dy, ubuf, static_cast<T*>(dk), static_cast<T*>(dv), csum, lks, S, H,
      N, P, chunk, C, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh);
  if (last_pass == 4) return (int)cudaGetLastError();
  ssm_bwd_finish_kernel<<<(unsigned)bhc, 32, 0, stream>>>(
      rsum, csum, lks, dtp, dld, dlg, S, H, chunk, C, nb * (THREADS / 32), 1, 1, 1);
  return (int)cudaGetLastError();
}

// ---- the FMA body at N or P over 128: N and P walked in slices --------
// No row of q, k, v or dy is staged whole: every tile holds ST = 64 of
// its columns.  (1) sums runs as the narrow code at WN = ST, one block a
// (chunk, head, 64 x 64 tile of S_c and U_c).  Then, instead of each
// rows / cols block recomputing the scores for its output slice, a launch
// of its own (S) computes them once a (chunk, head, tile pair): q_i.k_j
// summed over N and dy_i.v_j over P slice by slice, into dA = (dy.v) o W
// and M = (q.k) o W (chunk x chunk fp32 each in scratch), with dl's row and
// column sums over the tile pair.  (3) rows: one block a (chunk, head, row
// tile, N slice): dq's slice from the dA tiles and k's slice, then H_{c-1}
// dy_i over P slice by slice.  (4) cols: one block a (chunk, head, row
// tile, N or P slice): dk's N slice (dA^T Q, then G_c v_j over P slices)
// or dv's P slice ((QK^T o W)^T dY, then G_c^T k_j over N slices).  The
// row terms that sum over all of N -- q_i.z_i in rsum and k_j.(G_c v_j) in
// lk -- and dl's sums over the tiles are written as one partial a slice or
// tile, and (5) sums each row's partials in order: no atomics, so two
// launches still give the same bits.  P = 385 ends on a slice one column
// wide (the ones column that carries the mLSTM's normalizer), zero-padded
// like any ragged slice.  The layout takes any width, but at N = P = 64 it
// runs 26-36% slower than whole rows (k5_backward_probe.py layouts: its
// cols pass takes dk and dv in blocks apart, and (S) is a sixth launch), so
// N and P up to 128 keep the whole-row layout.
constexpr int ST = BT;             // columns of N or P a slice
constexpr int LDS = ST + 1;        // row stride of a staged slice

__host__ __device__ constexpr int slices(int w) { return (w + ST - 1) / ST; }
bool sliced(int N, int P) { return N > 128 || P > 128; }

// Partials a row of each sum: rsum's N slices, then its row tiles j
// (dl_ij); csum's tiles i; lk's N slices.
struct Parts {
  int nr, nc, nl;
};
__host__ __device__ inline Parts parts_of(int N, int chunk) {
  const int tiles = (chunk + BT - 1) / BT;
  return {slices(N) + tiles, tiles, slices(N)};
}

// (S): one block per (chunk, head, row tile i, row tile j).  dam and mat
// (B, H, C, chunk, chunk) get dA and M on the causal triangle's live rows
// (zero above the diagonal); rpart (B, H, C, nr, chunk) slot ns + j-tile
// and cpart (B, H, C, nc, chunk) slot i-tile get dl's sums over the pair
// (zero for a pair above the triangle or past the chunk's rows).
template <typename T>
__global__ void __launch_bounds__(THREADS) ssm_bwd_scores_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ lg, const float* __restrict__ dy,
    float* __restrict__ dam, float* __restrict__ mat, float* __restrict__ rpart,
    float* __restrict__ cpart, int S, int H, int N, int P, int chunk, int C, int q_sb, int q_ss,
    int q_sh, int k_sb, int k_ss, int k_sh) {
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  const Parts np = parts_of(N, chunk);
  const int tiles = np.nc, it = blockIdx.y / tiles, jt = blockIdx.y % tiles;
  const int i0 = it * BT, j0 = jt * BT;
  const int ni = min(BT, ck.nrow - i0), nj = min(BT, ck.nrow - j0);
  float* rp = rpart + (ck.bhc * np.nr + slices(N) + jt) * chunk;
  float* cp = cpart + (ck.bhc * np.nc + it) * chunk;
  if (jt > it || ni <= 0) {   // no live pair: the pair's partials are 0
    for (int r = threadIdx.x; r < BT; r += THREADS) {
      if (jt > it && r < ni) rp[i0 + r] = 0.f;
      if (r < nj) cp[j0 + r] = 0.f;
    }
    return;
  }
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                 // (MAX_CHUNK,)
  float* gs = cum + MAX_CHUNK;
  float* as = gs + MAX_CHUNK;        // (BT, LDS) a slice of q (then dy) rows i
  float* bs = as + BT * LDS;         // (BT, LDS) a slice of k (then v) rows j
  float* dls = bs + BT * LDS;        // (BT, LDT) dl: rows i by rows j
  load_decay(cum, gs, ld, lg, ck, S, H, chunk);
  const size_t vsb = (size_t)S * H * P, vss = (size_t)H * P;
  float sa[4][4], dm[4][4];          // q_i.k_j and dy_i.v_j
  fma_tile::zero(sa);
  fma_tile::zero(dm);
  for (int n0 = 0; n0 < N; n0 += ST) {
    const int nw = min(ST, N - n0);
    stage_rows(as, q + n0, ck, i0, ni, nw, BT, LDS, q_sb, q_ss, q_sh);
    stage_rows(bs, k + n0, ck, j0, nj, nw, BT, LDS, k_sb, k_ss, k_sh);
    __syncthreads();
    mm(sa, as, LDS, 1, bs, 1, LDS, nw);
    __syncthreads();
  }
  for (int p0 = 0; p0 < P; p0 += ST) {
    const int pw = min(ST, P - p0);
    stage_rows(as, dy + p0, ck, i0, ni, pw, BT, LDS, vsb, vss, P);
    stage_rows(bs, v + p0, ck, j0, nj, pw, BT, LDS, vsb, vss, P);
    __syncthreads();
    mm(dm, as, LDS, 1, bs, 1, LDS, pw);
    __syncthreads();
  }
  const size_t at = ck.bhc * chunk * chunk + (size_t)i0 * chunk + j0;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ii = ty() + 16 * a, jj = tx() + 16 * c;
      float m = 0.f, da = 0.f, dl = 0.f;
      if (ii < ni && jj < nj && j0 + jj <= i0 + ii) {
        bool live;
        const float wgt = weight(cum, gs, i0 + ii, j0 + jj, live);
        m = sa[a][c] * wgt;
        da = dm[a][c] * wgt;
        if (live) dl = da * sa[a][c];
      }
      if (ii < ni && jj < nj) {
        dam[at + (size_t)ii * chunk + jj] = da;
        mat[at + (size_t)ii * chunk + jj] = m;
      }
      dls[ii * LDT + jj] = dl;
    }
  __syncthreads();
  // dl's sums over the pair: threads 0-63 a row each, 64-127 a column
  const int r = threadIdx.x;
  if (r < BT && r < ni) {
    float sum = 0.f;
    for (int jj = 0; jj < BT; ++jj) sum += dls[r * LDT + jj];
    rp[i0 + r] = sum;
  } else if (r >= BT && r < 2 * BT && r - BT < nj) {
    float sum = 0.f;
    for (int ii = 0; ii < BT; ++ii) sum += dls[ii * LDT + r - BT];
    cp[j0 + r - BT] = sum;
  }
}

// (3) rows, sliced: one block per (chunk, head, row tile, N slice): dq_i
// over the slice, sum_j dA_ij k_j + wq_i H_{c-1} dy_i, and rsum's partial
// of the slice, [cum_i < 30] wq_i q_i.(H_{c-1} dy_i) over its columns.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssm_bwd_rows_sliced_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ ld,
    const float* __restrict__ lg, const float* __restrict__ dy,
    const float* __restrict__ hprev, const float* __restrict__ dam, T* __restrict__ dq,
    float* __restrict__ rpart, int S, int H, int N, int P, int chunk, int C, int q_sb,
    int q_ss, int q_sh, int k_sb, int k_ss, int k_sh) {
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  const int i0 = blockIdx.y * BT, ni = min(BT, ck.nrow - i0);
  if (ni <= 0) return;   // padding rows only: nothing to write
  const int sl = blockIdx.z, n0 = sl * ST, nw = min(ST, N - n0);
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                 // (MAX_CHUNK,)
  float* gs = cum + MAX_CHUNK;
  float* qs = gs + MAX_CHUNK;        // (BT, LDS) q's slice, rows i
  float* ks = qs + BT * LDS;         // (BT, LDS) k's slice, rows j
  float* dys = ks + BT * LDS;        // (BT, LDS) a slice of dy, rows i
  float* hs = dys + BT * LDS;        // (ST, LDS) H_{c-1}: the N slice by a P slice
  float* dat = hs + ST * LDS;        // (BT, LDT) dA: rows i by rows j
  load_decay(cum, gs, ld, lg, ck, S, H, chunk);
  const size_t vsb = (size_t)S * H * P, vss = (size_t)H * P;
  stage_rows(qs, q + n0, ck, i0, ni, nw, BT, LDS, q_sb, q_ss, q_sh);
  float dq_acc[4][4];
  fma_tile::zero(dq_acc);
  for (int j0 = 0; j0 <= i0; j0 += BT) {
    const int nj = min(BT, ck.nrow - j0);
    __syncthreads();   // the last tile is consumed
    stage_rows(ks, k + n0, ck, j0, nj, nw, BT, LDS, k_sb, k_ss, k_sh);
    fma_tile::stage(dat, dam + ck.bhc * chunk * chunk + (size_t)i0 * chunk + j0, chunk, ni,
                    nj, BT, LDT);
    __syncthreads();
    mm(dq_acc, dat, LDT, 1, ks, LDS, 1, nj);   // dq += dA K
  }
  // inter-chunk: z_i = H_{c-1} dy_i over the slice's rows of H, summed
  // over P slice by slice
  float z[4][4];
  fma_tile::zero(z);
  for (int p0 = 0; p0 < P; p0 += ST) {
    const int pw = min(ST, P - p0);
    __syncthreads();
    stage_rows(dys, dy + p0, ck, i0, ni, pw, BT, LDS, vsb, vss, P);
    fma_tile::stage(hs, hprev + ck.bhc * N * P + (size_t)n0 * P + p0, (size_t)P, nw, pw, ST,
                    LDS);
    __syncthreads();
    mm(z, dys, LDS, 1, hs, 1, LDS, pw);   // (i, n) = sum_p dy_i[p] H[n][p]
  }
  const float none[4] = {0.f, 0.f, 0.f, 0.f};   // dl's row sums come from (S)
  dq_inter(dq_acc, z, qs, LDS, cum, i0, ni, none,
           rpart + (ck.bhc * parts_of(N, chunk).nr + sl) * chunk);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ii = ty() + 16 * a, n = tx() + 16 * c;
      if (ii < ni && n < nw)
        dq[(((size_t)ck.b * S + ck.c0 + i0 + ii) * H + ck.h) * N + n0 + n] =
            from_f<T>(dq_acc[a][c]);
    }
}

// (4) cols, sliced: one block per (chunk, head, row tile, slice), the
// slices N's (dk) then P's (dv).  dk_j over an N slice: sum_{i >= j} dA_ij
// q_i + wk_j G_c v_j, with lk's partial of the slice, [.. < 30] wk_j
// k_j.(G_c v_j) over its columns; dv_j over a P slice: sum_{i >= j} M_ij
// dy_i + wk_j G_c^T k_j.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssm_bwd_cols_sliced_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ lg, const float* __restrict__ dy,
    const float* __restrict__ gbuf, const float* __restrict__ dam,
    const float* __restrict__ mat, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ lpart, int S, int H, int N, int P, int chunk, int C, int q_sb,
    int q_ss, int q_sh, int k_sb, int k_ss, int k_sh) {
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  const int j0 = blockIdx.y * BT, nj = min(BT, ck.nrow - j0);
  if (nj <= 0) return;
  const int ns = slices(N), sl = blockIdx.z;
  const bool is_k = sl < ns;                  // dk's N slice, else dv's P slice
  const int x0 = (is_k ? sl : sl - ns) * ST, xw = min(ST, (is_k ? N : P) - x0);
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                 // (MAX_CHUNK,)
  float* gs = cum + MAX_CHUNK;
  float* xs = gs + MAX_CHUNK;        // (BT, LDS) q's (dy's) slice, rows i
  float* ts = xs + BT * LDS;         // (BT, LDT) dA (M): rows i by rows j
  float* ys = ts + BT * LDT;         // (BT, LDS) a slice of v (k), rows j
  float* gsm = ys + BT * LDS;        // (ST, LDS) G_c: an N slice by a P slice
  float* ks = gsm + ST * LDS;        // (BT, LDS) k's slice, rows j (dk)
  load_decay(cum, gs, ld, lg, ck, S, H, chunk);
  const size_t vsb = (size_t)S * H * P, vss = (size_t)H * P;
  if (is_k) stage_rows(ks, k + x0, ck, j0, nj, xw, BT, LDS, k_sb, k_ss, k_sh);
  const float* tsrc = (is_k ? dam : mat) + ck.bhc * chunk * chunk + j0;
  float acc[4][4];
  fma_tile::zero(acc);
  for (int i0 = j0; i0 < ck.nrow; i0 += BT) {
    const int ni = min(BT, ck.nrow - i0);
    __syncthreads();   // the last tile is consumed
    if (is_k)
      stage_rows(xs, q + x0, ck, i0, ni, xw, BT, LDS, q_sb, q_ss, q_sh);
    else
      stage_rows(xs, dy + x0, ck, i0, ni, xw, BT, LDS, vsb, vss, P);
    fma_tile::stage(ts, tsrc + (size_t)i0 * chunk, chunk, ni, nj, BT, LDT);
    __syncthreads();
    mm(acc, ts, 1, LDT, xs, LDS, 1, ni);   // (j, x) += sum_i T[i][j] X[i][x]
  }
  // the chunk summary S_c = sum_j wk_j k_j v_j^T: dk_j += wk_j G_c v_j over
  // P slice by slice, dv_j += wk_j G_c^T k_j over N slice by slice
  float g[4][4];
  fma_tile::zero(g);
  const float* gb = gbuf + ck.bhc * N * P;
  for (int y0 = 0; y0 < (is_k ? P : N); y0 += ST) {
    const int yw = min(ST, (is_k ? P : N) - y0);
    __syncthreads();
    if (is_k) {
      stage_rows(ys, v + y0, ck, j0, nj, yw, BT, LDS, vsb, vss, P);
      fma_tile::stage(gsm, gb + (size_t)x0 * P + y0, (size_t)P, xw, yw, ST, LDS);
    } else {
      stage_rows(ys, k + y0, ck, j0, nj, yw, BT, LDS, k_sb, k_ss, k_sh);
      fma_tile::stage(gsm, gb + (size_t)y0 * P + x0, (size_t)P, yw, xw, ST, LDS);
    }
    __syncthreads();
    if (is_k)
      mm(g, ys, LDS, 1, gsm, 1, LDS, yw);   // (j, n) = sum_p v_j[p] G[n][p]
    else
      mm(g, ys, LDS, 1, gsm, LDS, 1, yw);   // (j, p) = sum_n k_j[n] G[n][p]
  }
  const float total = cum[chunk - 1];
  float* lp = lpart + (ck.bhc * ns + sl) * chunk;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int jj = ty() + 16 * a, j = j0 + min(jj, nj - 1);
    const float lk = total - cum[j] + gs[j];
    const float wk = expf(fminf(lk, 30.f));
    float dwk = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (is_k) dwk = fmaf(ks[jj * LDS + tx() + 16 * c], g[a][c], dwk);
      acc[a][c] = fmaf(wk, g[a][c], acc[a][c]);
    }
    dwk = row_sum(dwk);
    if (is_k && tx() == 0 && jj < nj) lp[j] = lk < 30.f ? dwk * wk : 0.f;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jj = ty() + 16 * a, x = tx() + 16 * c;
      if (jj >= nj || x >= xw) continue;
      const size_t row = ((size_t)ck.b * S + ck.c0 + j0 + jj) * H + ck.h;
      if (is_k)
        dk[row * N + x0 + x] = from_f<T>(acc[a][c]);
      else
        dv[row * P + x0 + x] = from_f<T>(acc[a][c]);
    }
}

size_t scores_smem() {
  return (2 * MAX_CHUNK + 2 * BT * LDS + BT * LDT) * sizeof(float);
}
// (3) and (4), sliced: three (BT, LDS) row slices, a (ST, LDS) state
// slice and a (BT, LDT) tile each
size_t walk_smem() {
  return (2 * MAX_CHUNK + 3 * BT * LDS + ST * LDS + BT * LDT) * sizeof(float);
}

template <typename T>
int launch_sliced(const void* q, const void* k, const void* v, const float* ld,
                  const float* lg, const float* h0, const float* dy, const float* dfin,
                  void* dq, void* dk, void* dv, float* dld, float* dlg, float* dh0,
                  float* scratch, int B, int S, int H, int N, int P, int chunk, int q_sb,
                  int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, cudaStream_t stream,
                  int last_pass) {
  const int C = (S + chunk - 1) / chunk, NP = N * P;
  const int nb = (NP + THREADS - 1) / THREADS, tiles = (chunk + BT - 1) / BT;
  const Parts np = parts_of(N, chunk);
  const size_t bhc = (size_t)B * H * C;
  float* sums = scratch;                 // (B, H, C, N, P): S_c, then H_{c-1}
  float* ubuf = sums + bhc * NP;         // (B, H, C, N, P): U_c, then G_c
  float* totals = ubuf + bhc * NP;       // (B, H, C)
  float* dtp = totals + bhc;             // (B, H, C, nb * 8): the warps' shares of dT_c
  float* rpart = dtp + bhc * nb * (THREADS / 32);   // (B, H, C, nr, chunk)
  float* cpart = rpart + bhc * np.nr * chunk;       // (B, H, C, nc, chunk)
  float* lpart = cpart + bhc * np.nc * chunk;       // (B, H, C, nl, chunk)
  float* dam = lpart + bhc * np.nl * chunk;         // (B, H, C, chunk, chunk): dA
  float* mat = dam + bhc * chunk * chunk;           // (B, H, C, chunk, chunk): M
  const size_t s1 = sums_smem(ST, chunk), s2 = scores_smem(), s3 = walk_smem(), s4 = s3;
  int err = allow_smem(ssm_bwd_sums_kernel<T, ST>, s1);
  if (!err) err = allow_smem(ssm_bwd_scores_kernel<T>, s2);
  if (!err) err = allow_smem(ssm_bwd_rows_sliced_kernel<T>, s3);
  if (!err) err = allow_smem(ssm_bwd_cols_sliced_kernel<T>, s4);
  if (err) return err;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  ssm_bwd_sums_kernel<T, ST><<<dim3((unsigned)bhc, slices(N) * slices(P)), THREADS, s1,
                               stream>>>(qt, kt, vt, ld, lg, dy, sums, ubuf, totals, S, H, N,
                                         P, chunk, C, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh);
  if (last_pass == 1) return (int)cudaGetLastError();
  ssm_bwd_pass_kernel<<<dim3(B * H, nb), THREADS, 0, stream>>>(sums, ubuf, totals, h0, dfin,
                                                               dh0, dtp, nullptr, nullptr, C,
                                                               NP);
  if (last_pass == 2) return (int)cudaGetLastError();
  ssm_bwd_scores_kernel<T><<<dim3((unsigned)bhc, tiles * tiles), THREADS, s2, stream>>>(
      qt, kt, vt, ld, lg, dy, dam, mat, rpart, cpart, S, H, N, P, chunk, C, q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh);
  if (last_pass == 3) return (int)cudaGetLastError();
  ssm_bwd_rows_sliced_kernel<T><<<dim3((unsigned)bhc, tiles, slices(N)), THREADS, s3,
                                  stream>>>(qt, kt, ld, lg, dy, sums, dam,
                                            static_cast<T*>(dq), rpart, S, H, N, P, chunk, C,
                                            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh);
  if (last_pass == 4) return (int)cudaGetLastError();
  ssm_bwd_cols_sliced_kernel<T><<<dim3((unsigned)bhc, tiles, slices(N) + slices(P)), THREADS,
                                  s4, stream>>>(qt, kt, vt, ld, lg, dy, ubuf, dam, mat,
                                                static_cast<T*>(dk), static_cast<T*>(dv),
                                                lpart, S, H, N, P, chunk, C, q_sb, q_ss, q_sh,
                                                k_sb, k_ss, k_sh);
  if (last_pass == 5) return (int)cudaGetLastError();
  ssm_bwd_finish_kernel<<<(unsigned)bhc, 32, 0, stream>>>(
      rpart, cpart, lpart, dtp, dld, dlg, S, H, chunk, C, nb * (THREADS / 32), np.nr, np.nc,
      np.nl);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(const void* q, const void* k, const void* v, const float* ld, const float* lg,
             const float* h0, const float* dy, const float* dfin, void* dq, void* dk, void* dv,
             float* dld, float* dlg, float* dh0, float* scratch, int B, int S, int H, int N,
             int P, int chunk, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
             cudaStream_t stream, int last_pass) {
  if (sliced(N, P))
    return launch_sliced<T>(q, k, v, ld, lg, h0, dy, dfin, dq, dk, dv, dld, dlg, dh0, scratch,
                            B, S, H, N, P, chunk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, stream,
                            last_pass);
  if (width_class(N, P) == 64)
    return launch<T, 64>(q, k, v, ld, lg, h0, dy, dfin, dq, dk, dv, dld, dlg, dh0, scratch, B,
                         S, H, N, P, chunk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, stream,
                         last_pass);
  return launch<T, 128>(q, k, v, ld, lg, h0, dy, dfin, dq, dk, dv, dld, dlg, dh0, scratch, B,
                        S, H, N, P, chunk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, stream,
                        last_pass);
}


// ---- the tensor-core body ("mma") ---------------------------------------
namespace bmma {

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
using ssd_tile::swz;
using ssd_tile::TC_THREADS;
using ssd_tile::WARPS;

// Shared memory of one block of (3) or (4), in bytes, in the order
// `tiles` lays it out: the chunk's q and k (N wide) and v (P wide) as
// bf16, dy as bf16 hi and lo tiles, a state (H_{c-1} or G_c, N x P) as
// bf16 hi and lo, the decay and gate rows.
__host__ __device__ constexpr int tile_bytes(int N, int P, int rows) {
  return rows * (2 * N + 3 * P) * 2 + 2 * N * P * 2 + 2 * rows * 4;
}

struct Tiles {
  bf16 *q, *k, *v, *dyh, *dyl, *sth, *stl;
  float *dec, *gate;
};

__device__ __forceinline__ Tiles tiles(unsigned char* smem, int N, int P, int rows) {
  Tiles s;
  s.q = reinterpret_cast<bf16*>(smem);
  s.k = s.q + rows * N;
  s.v = s.k + rows * N;
  s.dyh = s.v + rows * P;
  s.dyl = s.dyh + rows * P;
  s.sth = s.dyl + rows * P;
  s.stl = s.sth + N * P;
  s.dec = reinterpret_cast<float*>(s.stl + N * P);
  s.gate = s.dec + rows;
  return s;
}

// Rows [0, rows) of an fp32 (rows, W) tile -- row r < live from src + r *
// stride, 16-byte aligned, the rest zeros -- as bf16 hi and lo tiles,
// swizzled as stage_tile lays them (a 16-byte piece of each from two
// 16-byte loads).  Synchronous: it overlaps the cp.async copies in flight.
template <int W>
__device__ __forceinline__ void stage_split(bf16* hi, bf16* lo, const float* __restrict__ src,
                                            size_t stride, int live, int rows) {
  constexpr int CH = W / 8;
  for (int i = threadIdx.x; i < rows * CH; i += TC_THREADS) {
    const int r = i / CH, c = i - r * CH;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r < live) {
      const float4* p = reinterpret_cast<const float4*>(src + r * stride + c * 8);
      a = __ldg(p);
      b = __ldg(p + 1);
    }
    uint4 h, l;
    split2(a.x, a.y, h.x, l.x);
    split2(a.z, a.w, h.y, l.y);
    split2(b.x, b.y, h.z, l.z);
    split2(b.z, b.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + swz<W>(r, c)) = h;
    *reinterpret_cast<uint4*>(lo + swz<W>(r, c)) = l;
  }
}

// d0 (the columns of b[0], b[1]) and d1 (of b[2], b[3]) += A B, for the
// four ways an operand is carried: one product of exact operands (mma1),
// A as a hi / lo pair (mma2a), B as one (mma2b), both (mma3: hi hi + hi lo
// + lo hi; lo lo is below fp32's rounding of the sum).
__device__ __forceinline__ void mma1(float (&d0)[4], float (&d1)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  mma16816(d0, a, b[0], b[1]);
  mma16816(d1, a, b[2], b[3]);
}
__device__ __forceinline__ void mma2a(float (&d0)[4], float (&d1)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const uint32_t (&b)[4]) {
  mma1(d0, d1, ah, b);
  mma1(d0, d1, al, b);
}
__device__ __forceinline__ void mma2b(float (&d0)[4], float (&d1)[4], const uint32_t (&a)[4],
                                      const uint32_t (&bh)[4], const uint32_t (&bl)[4]) {
  mma1(d0, d1, a, bh);
  mma1(d0, d1, a, bl);
}
__device__ __forceinline__ void mma3(float (&d0)[4], float (&d1)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[4],
                                     const uint32_t (&bl)[4]) {
  mma1(d0, d1, ah, bh);
  mma1(d0, d1, ah, bl);
  mma1(d0, d1, al, bh);
}

// A 16 x 16 block held as two accumulator tiles (columns 0-7 in x[0],
// 8-15 in x[1]) as an A operand, split into bf16 hi and lo.
__device__ __forceinline__ void acc_split(const float (&x)[2][4], uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    split2(x[nb][0], x[nb][1], hi[2 * nb], lo[2 * nb]);
    split2(x[nb][2], x[nb][3], hi[2 * nb + 1], lo[2 * nb + 1]);
  }
}

// An accumulator tile's rows g (entries 0, 1) and g + 8 (2, 3) times a and b.
__device__ __forceinline__ void scale4(float (&d)[4], float a, float b) {
  d[0] *= a;
  d[1] *= a;
  d[2] *= b;
  d[3] *= b;
}

// The sum over a quad (the four lanes that hold one accumulator row), in
// a fixed order; every lane of the quad gets it.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// t[r][c] and t[r][c + 1] of a staged bf16 tile, c even, as fp32.
template <int W>
__device__ __forceinline__ float2 pair_at(const bf16* t, int r, int c) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(t + swz<W>(r, c >> 3) + (c & 7));
  return make_float2(__low2float(x), __high2float(x));
}

// Stages the chunk's q, k, v (cp.async) and dy (split), the decay and gate
// rows, and the state st as hi (N x P) then lo; then the decay's cumsum.
// Ends synced.
template <int N, int P>
__device__ __forceinline__ void stage_chunk(const Tiles& s, const bf16* q, const bf16* k,
                                            const bf16* v, const float* ld, const float* lg,
                                            const float* dy, const bf16* st, const Chunk& ck,
                                            int S, int H, int rows, int q_sb, int q_ss, int q_sh,
                                            int k_sb, int k_ss, int k_sh) {
  const size_t vrow = (((size_t)ck.b * S + ck.c0) * H + ck.h) * P, vss = (size_t)H * P;
  stage_tile<N>(s.q, q + (size_t)ck.b * q_sb + (size_t)ck.c0 * q_ss + (size_t)ck.h * q_sh, q_ss,
                ck.nrow, rows);
  stage_tile<N>(s.k, k + (size_t)ck.b * k_sb + (size_t)ck.c0 * k_ss + (size_t)ck.h * k_sh, k_ss,
                ck.nrow, rows);
  stage_tile<P>(s.v, v + vrow, vss, ck.nrow, rows);
  stage_tile<P>(s.sth, st, P, N, N);
  stage_tile<P>(s.stl, st + N * P, P, N, N);
  stage_rows(s.dec, s.gate, ld, lg, ((size_t)ck.b * S + ck.c0) * H + ck.h, H, ck.nrow, rows);
  cp_async_commit();
  stage_split<P>(s.dyh, s.dyl, dy + vrow, vss, ck.nrow, rows);
  cp_async_wait<0>();
  __syncthreads();
  prepare_rows(s.dec, s.gate, ck.nrow, rows);
  __syncthreads();
}

// ---- (1) sums: S_c = (k o wk)^T v (two products: k o wk as hi + lo, v
// exact) in the blocks of blockIdx.y = 0, U_c = (q o wq)^T dy (three) in
// those of blockIdx.y = 1, each staging only its own operands (the A
// operand's rows a, the B operand's b, or b and its lo half bl for dy).
// Warp w takes items w, w + 4, ..: (16-row strip of N, half of P's
// columns; all of them at P = 16).
__host__ __device__ constexpr int sums_bytes(int N, int P, int rows) {
  return rows * (N + 2 * P) * 2 + 2 * rows * 4;
}

template <int N, int P>
__global__ void __launch_bounds__(TC_THREADS) ssm_bwd_sums_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ lg, const float* __restrict__ dy,
    float* __restrict__ sums, float* __restrict__ ubuf, float* __restrict__ totals, int S, int H,
    int chunk, int C, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh) {
  constexpr int PH = P >= 32 ? 2 : 1, PB = P / 8 / PH;   // halves of P; 8-column blocks a half
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  const bool u = blockIdx.y == 1;
  const int rows = (chunk + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem);   // (rows, N): k, or q
  bf16* b = a + rows * N;                    // (rows, P): v, or dy's hi
  bf16* bl = b + rows * P;                   // (rows, P): dy's lo
  float* dec = reinterpret_cast<float*>(bl + rows * P);
  float* gate = dec + rows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, cq = lane % 4;
  const size_t vrow = (((size_t)ck.b * S + ck.c0) * H + ck.h) * P, vss = (size_t)H * P;
  if (u)
    stage_tile<N>(a, q + (size_t)ck.b * q_sb + (size_t)ck.c0 * q_ss + (size_t)ck.h * q_sh, q_ss,
                  ck.nrow, rows);
  else
    stage_tile<N>(a, k + (size_t)ck.b * k_sb + (size_t)ck.c0 * k_ss + (size_t)ck.h * k_sh, k_ss,
                  ck.nrow, rows);
  if (!u) stage_tile<P>(b, v + vrow, vss, ck.nrow, rows);
  stage_rows(dec, gate, ld, lg, ((size_t)ck.b * S + ck.c0) * H + ck.h, H, ck.nrow, rows);
  cp_async_commit();
  if (u) stage_split<P>(b, bl, dy + vrow, vss, ck.nrow, rows);
  cp_async_wait<0>();
  __syncthreads();
  prepare_rows(dec, gate, ck.nrow, rows);
  __syncthreads();
  const float total = dec[rows - 1];
  if (threadIdx.x == 0 && !u) totals[ck.bhc] = total;
  for (int r = threadIdx.x; r < rows; r += TC_THREADS)   // gate -> wk (S) or wq (U), in place
    gate[r] = expf(fminf(u ? dec[r] : total - dec[r] + gate[r], 30.f));
  __syncthreads();
  for (int it = warp; it < N / 16 * PH; it += WARPS) {
    const int sn = it / PH, d0 = (it % PH) * PB;
    float acc[PB][4];
#pragma unroll
    for (int i = 0; i < PB; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int kc = 0; kc < rows / 16; ++kc) {
      const int j0 = 16 * kc;
      uint32_t ah[4], al[4];   // A = (k o wk)^T or (q o wq)^T of rows n 16 sn .., rows j0 ..
      frag_at_scaled<N>(ah, al, a, gate, j0, sn);
#pragma unroll
      for (int dd = 0; dd < PB; dd += 2) {
        uint32_t bh[4];
        frag_bt<P>(bh, b, j0, d0 + dd);
        if (!u) {
          mma2a(acc[dd], acc[dd + 1], ah, al, bh);
        } else {
          uint32_t bo[4];
          frag_bt<P>(bo, bl, j0, d0 + dd);
          mma3(acc[dd], acc[dd + 1], ah, al, bh, bo);
        }
      }
    }
    float* out = (u ? ubuf : sums) + (ck.bhc * N + 16 * sn) * P;
#pragma unroll
    for (int dd = 0; dd < PB; ++dd) {
      const int p = 8 * (d0 + dd) + 2 * cq;
      *reinterpret_cast<float2*>(out + g * P + p) = make_float2(acc[dd][0], acc[dd][1]);
      *reinterpret_cast<float2*>(out + (g + 8) * P + p) = make_float2(acc[dd][2], acc[dd][3]);
    }
  }
}

// ---- (3) rows: for the 16 rows i of a strip, z_i = H_{c-1} dy_i (three
// products), dq_i = wq_i z_i + sum_j dA_ij k_j (dA as hi + lo, two), dA_ij
// = (dy_i.v_j) W_ij from dy as hi + lo (two) and q_i.k_j (one), and
// rsum_i = sum_j dl_ij + [cum_i < 30] wq_i q_i.z_i.
template <int N, int P>
__global__ void __launch_bounds__(TC_THREADS) ssm_bwd_rows_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ lg, const float* __restrict__ dy,
    const bf16* __restrict__ hin, bf16* __restrict__ dq, float* __restrict__ rsum, int S, int H,
    int chunk, int C, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh) {
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  const int rows = (chunk + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles s = tiles(smem, N, P, rows);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, cq = lane % 4;
  stage_chunk<N, P>(s, q, k, v, ld, lg, dy, hin + ck.bhc * 2 * N * P, ck, S, H, rows, q_sb,
                    q_ss, q_sh, k_sb, k_ss, k_sh);
  for (int pass = 0; pass < 2; ++pass) {
    const int sr = pass ? 2 * WARPS - 1 - warp : warp, i0 = 16 * sr;
    if (i0 >= ck.nrow) continue;
    const int ia = i0 + g, ib = ia + 8;   // this thread's rows
    const float ca = s.dec[ia], cb = s.dec[ib];
    float acc[N / 8][4];
#pragma unroll
    for (int i = 0; i < N / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    // the inter-chunk term first: z = dY H_{c-1}^T (i, n)
    for (int kc = 0; kc < P / 16; ++kc) {
      uint32_t ah[4], al[4];
      frag_a<P>(ah, s.dyh, i0, kc);
      frag_a<P>(al, s.dyl, i0, kc);
#pragma unroll
      for (int dn = 0; dn < N / 8; dn += 2) {
        uint32_t bh[4], bl[4];   // B of state rows n = 8 dn .., columns p = 16 kc ..
        frag_b<P>(bh, s.sth, 8 * dn, kc);
        frag_b<P>(bl, s.stl, 8 * dn, kc);
        mma3(acc[dn], acc[dn + 1], ah, al, bh, bl);
      }
    }
    const float wa = expf(fminf(ca, 30.f)), wb = expf(fminf(cb, 30.f));
    float za = 0.f, zb = 0.f;   // q_i . z_i
#pragma unroll
    for (int dn = 0; dn < N / 8; ++dn) {
      const float2 qa = pair_at<N>(s.q, ia, 8 * dn + 2 * cq);
      const float2 qb = pair_at<N>(s.q, ib, 8 * dn + 2 * cq);
      za += qa.x * acc[dn][0] + qa.y * acc[dn][1];
      zb += qb.x * acc[dn][2] + qb.y * acc[dn][3];
      scale4(acc[dn], wa, wb);   // dq_i = wq_i z_i
    }
    float ra = 0.f, rb = 0.f;   // sum_j dl_ij
    for (int jt = 0; jt <= sr; ++jt) {
      const int j0 = 16 * jt;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dm[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc = 0; kc < N / 16; ++kc) {   // q_i . k_j
        uint32_t a[4], b[4];
        frag_a<N>(a, s.q, i0, kc);
        frag_b<N>(b, s.k, j0, kc);
        mma1(sc[0], sc[1], a, b);
      }
#pragma unroll
      for (int kc = 0; kc < P / 16; ++kc) {   // dy_i . v_j
        uint32_t ah[4], al[4], b[4];
        frag_a<P>(ah, s.dyh, i0, kc);
        frag_a<P>(al, s.dyl, i0, kc);
        frag_b<P>(b, s.v, j0, kc);
        mma2a(dm[0], dm[1], ah, al, b);
      }
      // dA_ij = (dy_i.v_j) W_ij for j <= i < nrow, else 0; dl_ij = dA_ij
      // (q_i.k_j) where the clamp lets the derivative through
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib, j = j0 + 8 * nb + 2 * cq + (e & 1);
          float da = 0.f;
          if (j <= i && i < ck.nrow) {
            const float lw = s.dec[i] - s.dec[j] + s.gate[j];
            da = dm[nb][e] * expf(fminf(lw, 30.f));
            if (lw < 30.f) {
              if (e < 2)
                ra = fmaf(da, sc[nb][e], ra);
              else
                rb = fmaf(da, sc[nb][e], rb);
            }
          }
          dm[nb][e] = da;
        }
      uint32_t ah[4], al[4];
      acc_split(dm, ah, al);
#pragma unroll
      for (int dn = 0; dn < N / 8; dn += 2) {   // dq += dA K_j
        uint32_t b[4];
        frag_bt<N>(b, s.k, j0, dn);
        mma2a(acc[dn], acc[dn + 1], ah, al, b);
      }
    }
    ra = quad_sum(ra);
    rb = quad_sum(rb);
    za = quad_sum(za);
    zb = quad_sum(zb);
    if (cq == 0) {
      float* rs = rsum + ck.bhc * chunk;
      if (ia < ck.nrow) rs[ia] = ra + (ca < 30.f ? za * wa : 0.f);
      if (ib < ck.nrow) rs[ib] = rb + (cb < 30.f ? zb * wb : 0.f);
    }
    bf16* qa = dq + (((size_t)ck.b * S + ck.c0 + ia) * H + ck.h) * N;
    bf16* qb = qa + (size_t)8 * H * N;
#pragma unroll
    for (int dn = 0; dn < N / 8; ++dn) {
      const int n = 8 * dn + 2 * cq;
      if (ia < ck.nrow)
        *reinterpret_cast<__nv_bfloat162*>(qa + n) = __floats2bfloat162_rn(acc[dn][0], acc[dn][1]);
      if (ib < ck.nrow)
        *reinterpret_cast<__nv_bfloat162*>(qb + n) = __floats2bfloat162_rn(acc[dn][2], acc[dn][3]);
    }
  }
}

// ---- (4) cols: for the 16 rows j of a strip, the summary terms gv_j =
// G_c v_j and G_c^T k_j (G as hi + lo, two products each), then dk_j +=
// sum_i dA_ij q_i (dA^T as hi + lo, two) and dv_j += sum_i (q_i.k_j) W_ij
// dy_i ((QK^T o W)^T and dy both as pairs, three), k_j.q_i (one) and
// v_j.dy_i (two) recomputed; csum_j = sum_i dl_ij and lk_j = [.. < 30]
// wk_j k_j.gv_j.
template <int N, int P>
__global__ void __launch_bounds__(TC_THREADS) ssm_bwd_cols_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ lg, const float* __restrict__ dy,
    const bf16* __restrict__ gin, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ csum, float* __restrict__ lks, int S, int H, int chunk, int C, int q_sb,
    int q_ss, int q_sh, int k_sb, int k_ss, int k_sh) {
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  const int rows = (chunk + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles s = tiles(smem, N, P, rows);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, cq = lane % 4;
  stage_chunk<N, P>(s, q, k, v, ld, lg, dy, gin + ck.bhc * 2 * N * P, ck, S, H, rows, q_sb,
                    q_ss, q_sh, k_sb, k_ss, k_sh);
  const float total = s.dec[rows - 1];
  for (int pass = 0; pass < 2; ++pass) {
    const int sr = pass ? 2 * WARPS - 1 - warp : warp, j0 = 16 * sr;
    if (j0 >= ck.nrow) continue;
    const int ja = j0 + g, jb = ja + 8;   // this thread's rows
    float dka[N / 8][4], dva[P / 8][4];
#pragma unroll
    for (int i = 0; i < N / 8; ++i) dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
#pragma unroll
    for (int i = 0; i < P / 8; ++i) dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
    // the chunk summary first: gv = V_j G_c^T (j, n) into dk, G_c^T k_j (j, p) into dv
    for (int kc = 0; kc < P / 16; ++kc) {
      uint32_t a[4];
      frag_a<P>(a, s.v, j0, kc);
#pragma unroll
      for (int dn = 0; dn < N / 8; dn += 2) {
        uint32_t bh[4], bl[4];   // B of state rows n = 8 dn .., columns p = 16 kc ..
        frag_b<P>(bh, s.sth, 8 * dn, kc);
        frag_b<P>(bl, s.stl, 8 * dn, kc);
        mma2b(dka[dn], dka[dn + 1], a, bh, bl);
      }
    }
    for (int kc = 0; kc < N / 16; ++kc) {
      uint32_t a[4];
      frag_a<N>(a, s.k, j0, kc);
#pragma unroll
      for (int dn = 0; dn < P / 8; dn += 2) {
        uint32_t bh[4], bl[4];   // B of state rows n = 16 kc .., columns p = 8 dn ..
        frag_bt<P>(bh, s.sth, 16 * kc, dn);
        frag_bt<P>(bl, s.stl, 16 * kc, dn);
        mma2b(dva[dn], dva[dn + 1], a, bh, bl);
      }
    }
    const float lka = total - s.dec[ja] + s.gate[ja], lkb = total - s.dec[jb] + s.gate[jb];
    const float wka = expf(fminf(lka, 30.f)), wkb = expf(fminf(lkb, 30.f));
    float ka = 0.f, kb = 0.f;   // k_j . gv_j
#pragma unroll
    for (int dn = 0; dn < N / 8; ++dn) {
      const float2 xa = pair_at<N>(s.k, ja, 8 * dn + 2 * cq);
      const float2 xb = pair_at<N>(s.k, jb, 8 * dn + 2 * cq);
      ka += xa.x * dka[dn][0] + xa.y * dka[dn][1];
      kb += xb.x * dka[dn][2] + xb.y * dka[dn][3];
      scale4(dka[dn], wka, wkb);
    }
#pragma unroll
    for (int dn = 0; dn < P / 8; ++dn) scale4(dva[dn], wka, wkb);
    float csa = 0.f, csb = 0.f;   // sum_i dl_ij
    for (int it = sr; 16 * it < ck.nrow; ++it) {
      const int i0 = 16 * it;
      float sa[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dmt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc = 0; kc < N / 16; ++kc) {   // k_j . q_i
        uint32_t a[4], b[4];
        frag_a<N>(a, s.k, j0, kc);
        frag_b<N>(b, s.q, i0, kc);
        mma1(sa[0], sa[1], a, b);
      }
#pragma unroll
      for (int kc = 0; kc < P / 16; ++kc) {   // v_j . dy_i
        uint32_t a[4], bh[4], bl[4];
        frag_a<P>(a, s.v, j0, kc);
        frag_b<P>(bh, s.dyh, i0, kc);
        frag_b<P>(bl, s.dyl, i0, kc);
        mma2b(dmt[0], dmt[1], a, bh, bl);
      }
      // rows j by columns i: (q_i.k_j) W_ij and dA_ij for j <= i < nrow
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? ja : jb, i = i0 + 8 * nb + 2 * cq + (e & 1);
          float m = 0.f, da = 0.f;
          if (j <= i && i < ck.nrow) {
            const float lw = s.dec[i] - s.dec[j] + s.gate[j];
            const float wgt = expf(fminf(lw, 30.f));
            m = sa[nb][e] * wgt;
            da = dmt[nb][e] * wgt;
            if (lw < 30.f) {
              if (e < 2)
                csa = fmaf(da, sa[nb][e], csa);
              else
                csb = fmaf(da, sa[nb][e], csb);
            }
          }
          sa[nb][e] = m;
          dmt[nb][e] = da;
        }
      uint32_t mh[4], ml[4], dh[4], dl[4];
      acc_split(sa, mh, ml);
      acc_split(dmt, dh, dl);
#pragma unroll
      for (int dn = 0; dn < N / 8; dn += 2) {   // dk += dA^T Q_i
        uint32_t b[4];
        frag_bt<N>(b, s.q, i0, dn);
        mma2a(dka[dn], dka[dn + 1], dh, dl, b);
      }
#pragma unroll
      for (int dn = 0; dn < P / 8; dn += 2) {   // dv += (QK^T o W)^T dY_i
        uint32_t bh[4], bl[4];
        frag_bt<P>(bh, s.dyh, i0, dn);
        frag_bt<P>(bl, s.dyl, i0, dn);
        mma3(dva[dn], dva[dn + 1], mh, ml, bh, bl);
      }
    }
    csa = quad_sum(csa);
    csb = quad_sum(csb);
    ka = quad_sum(ka);
    kb = quad_sum(kb);
    if (cq == 0) {
      const size_t at = ck.bhc * chunk;
      if (ja < ck.nrow) {
        csum[at + ja] = csa;
        lks[at + ja] = lka < 30.f ? ka * wka : 0.f;
      }
      if (jb < ck.nrow) {
        csum[at + jb] = csb;
        lks[at + jb] = lkb < 30.f ? kb * wkb : 0.f;
      }
    }
    const size_t ra = ((size_t)ck.b * S + ck.c0 + ja) * H + ck.h, rb = ra + (size_t)8 * H;
#pragma unroll
    for (int dn = 0; dn < N / 8; ++dn) {
      const int n = 8 * dn + 2 * cq;
      if (ja < ck.nrow)
        *reinterpret_cast<__nv_bfloat162*>(dk + ra * N + n) =
            __floats2bfloat162_rn(dka[dn][0], dka[dn][1]);
      if (jb < ck.nrow)
        *reinterpret_cast<__nv_bfloat162*>(dk + rb * N + n) =
            __floats2bfloat162_rn(dka[dn][2], dka[dn][3]);
    }
#pragma unroll
    for (int dn = 0; dn < P / 8; ++dn) {
      const int p = 8 * dn + 2 * cq;
      if (ja < ck.nrow)
        *reinterpret_cast<__nv_bfloat162*>(dv + ra * P + p) =
            __floats2bfloat162_rn(dva[dn][0], dva[dn][1]);
      if (jb < ck.nrow)
        *reinterpret_cast<__nv_bfloat162*>(dv + rb * P + p) =
            __floats2bfloat162_rn(dva[dn][2], dva[dn][3]);
    }
  }
}

template <int N, int P>
int launch(const void* q, const void* k, const void* v, const float* ld, const float* lg,
           const float* h0, const float* dy, const float* dfin, void* dq, void* dk, void* dv,
           float* dld, float* dlg, float* dh0, void* scratch, int B, int S, int H, int chunk,
           int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, cudaStream_t stream,
           int last_pass) {
  constexpr int NP = N * P;
  const int C = (S + chunk - 1) / chunk, rows = (chunk + 15) & ~15;
  const int nb = (NP + THREADS - 1) / THREADS;
  const size_t bhc = (size_t)B * H * C;
  bf16* hin = static_cast<bf16*>(scratch);   // (B, H, C, 2, N, P): H_{c-1} as hi, lo
  bf16* gin = hin + bhc * 2 * NP;            // (B, H, C, 2, N, P): G_c as hi, lo
  float* sums = reinterpret_cast<float*>(gin + bhc * 2 * NP);   // (B, H, C, N, P): S_c, H_{c-1}
  float* ubuf = sums + bhc * NP;             // (B, H, C, N, P): U_c
  float* totals = ubuf + bhc * NP;           // (B, H, C)
  float* dtp = totals + bhc;                 // (B, H, C, nb * 8): the warps' shares of dT_c
  float* rsum = dtp + bhc * nb * (THREADS / 32);   // (B, H, C, chunk) each
  float* csum = rsum + bhc * chunk;
  float* lks = csum + bhc * chunk;
  const int s1 = sums_bytes(N, P, rows), s3 = tile_bytes(N, P, rows);
  int err = allow_smem(ssm_bwd_sums_mma_kernel<N, P>, s1);
  if (!err) err = allow_smem(ssm_bwd_rows_mma_kernel<N, P>, s3);
  if (!err) err = allow_smem(ssm_bwd_cols_mma_kernel<N, P>, s3);
  if (err) return err;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  ssm_bwd_sums_mma_kernel<N, P><<<dim3((unsigned)bhc, 2), TC_THREADS, s1, stream>>>(
      qb, kb, vb, ld, lg, dy, sums, ubuf, totals, S, H, chunk, C, q_sb, q_ss, q_sh, k_sb, k_ss,
      k_sh);
  if (last_pass == 1) return (int)cudaGetLastError();
  ssm_bwd_pass_kernel<<<dim3(B * H, nb), THREADS, 0, stream>>>(sums, ubuf, totals, h0, dfin,
                                                               dh0, dtp, hin, gin, C, NP);
  if (last_pass == 2) return (int)cudaGetLastError();
  ssm_bwd_rows_mma_kernel<N, P><<<(unsigned)bhc, TC_THREADS, s3, stream>>>(
      qb, kb, vb, ld, lg, dy, hin, static_cast<bf16*>(dq), rsum, S, H, chunk, C, q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh);
  if (last_pass == 3) return (int)cudaGetLastError();
  ssm_bwd_cols_mma_kernel<N, P><<<(unsigned)bhc, TC_THREADS, s3, stream>>>(
      qb, kb, vb, ld, lg, dy, gin, static_cast<bf16*>(dk), static_cast<bf16*>(dv), csum, lks, S,
      H, chunk, C, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh);
  if (last_pass == 4) return (int)cudaGetLastError();
  ssm_bwd_finish_kernel<<<(unsigned)bhc, 32, 0, stream>>>(
      rsum, csum, lks, dtp, dld, dlg, S, H, chunk, C, nb * (THREADS / 32), 1, 1, 1);
  return (int)cudaGetLastError();
}

}  // namespace bmma

}  // namespace

// Shared memory the largest of a body's blocks uses, in bytes (body 0 =
// FMA, 1 = "mma"), or -1 for a width no layout of the body takes: the
// "mma" body's widths are its instances; the FMA body takes any N and P
// (over 128 in slices) whose N x P state the pass can spread over its
// grid.  The wrapper checks it before it launches.
extern "C" int ssm_backward_smem_bytes(int body, int N, int P, int chunk) {
  if (N < 1 || P < 1 || ((size_t)N * P + THREADS - 1) / THREADS > 65535) return -1;
  if (body == 1) {
    if (N != P || (N != 16 && N != 32 && N != 64 && N != 128)) return -1;
    return bmma::tile_bytes(N, P, (chunk + 15) & ~15);
  }
  size_t a, b, c;
  if (sliced(N, P)) {
    a = sums_smem(ST, chunk), b = scores_smem(), c = walk_smem();
  } else {
    const int wn = width_class(N, P);
    a = sums_smem(wn, chunk), b = rows_smem(wn), c = cols_smem(wn);
  }
  size_t m = a > b ? a : b;
  return (int)(m > c ? m : c);
}

// q, k: (B, S, H, N) through strides (sb, ss, sh), v (B, S, H, P)
// contiguous, in one dtype (0 = float32, 1 = bfloat16); ld, lg (B, S, H)
// fp32; h0, dfin (B, H, N, P) fp32 or null; dy (B, S, H, P) fp32.  Writes
// dq, dk (B, S, H, N) and dv (B, S, H, P) in the inputs' dtype, dld, dlg
// (B, S, H) fp32 and (when h0 is given) dh0 (B, H, N, P) fp32.  scratch:
// 2 B H C N P + B H C (1 + 8 cdiv(N P, 256) + 3 chunk) floats, C = cdiv(S,
// chunk); for body 1 ("mma": bf16, N = P in {16, 32, 64, 128}; q, k, v, dy
// and scratch 16-byte aligned) 2 B H C N P floats more; for the FMA body
// at N or P over 128 (in slices) B H C (2 cdiv(chunk, 64) + 2 cdiv(N,
// 64)) chunk floats in place of B H C 3 chunk, and B H C 2 chunk^2 more.
// chunk <= 128 (and at most S).  last_pass: the launches stop after that
// pass (1-based, in launch order: sums, the state pass, [the sliced
// layout's scores,] rows, cols, finish), so a caller can time each pass as
// the difference of two runs; 0 runs them all (the same bits as ever).
// Returns 0 or the CUDA error of a launch.
extern "C" int ssm_scan_backward(const void* q, const void* k, const void* v, const void* ld,
                                 const void* lg, const void* h0, const void* dy,
                                 const void* dfin, void* dq, void* dk, void* dv, void* dld,
                                 void* dlg, void* dh0, void* scratch, int dtype, int B, int S,
                                 int H, int N, int P, int chunk, int q_sb, int q_ss, int q_sh,
                                 int k_sb, int k_ss, int k_sh, int body, int last_pass,
                                 void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (chunk < 1 || chunk > MAX_CHUNK || ssm_backward_smem_bytes(body, N, P, chunk) < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (body == 1) {
    if (dtype != 1 || N != P) return (int)cudaErrorInvalidValue;
    auto run = [&](auto launch) {
      return launch(q, k, v, f(ld), f(lg), f(h0), f(dy), f(dfin), dq, dk, dv, w(dld), w(dlg),
                    w(dh0), scratch, B, S, H, chunk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, s,
                    last_pass);
    };
    switch (N) {
      case 16: return run(bmma::launch<16, 16>);
      case 32: return run(bmma::launch<32, 32>);
      case 64: return run(bmma::launch<64, 64>);
      case 128: return run(bmma::launch<128, 128>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1)
    return launch_w<__nv_bfloat16>(q, k, v, f(ld), f(lg), f(h0), f(dy), f(dfin), dq, dk, dv,
                                   w(dld), w(dlg), w(dh0), w(scratch), B, S, H, N, P, chunk,
                                   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, s, last_pass);
  return launch_w<float>(q, k, v, f(ld), f(lg), f(h0), f(dy), f(dfin), dq, dk, dv, w(dld),
                         w(dlg), w(dh0), w(scratch), B, S, H, N, P, chunk, q_sb, q_ss, q_sh,
                         k_sb, k_ss, k_sh, s, last_pass);
}
