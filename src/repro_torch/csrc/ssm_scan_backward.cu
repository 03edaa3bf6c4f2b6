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
// 25.8 MB: the bytes bound it at 0.0077 ms on the tensor cores' side.
// This body runs every product as fp32 FMA on the CUDA cores (tensor
// cores come later), so the 67 TFLOP/s fp32 rate bounds it at 0.040 ms.
//
// Five launches of one call, on the caller's stream; nothing walks the
// chunks in order except the state passing, and no atomics (each output is
// written by one thread, every sum taken in a fixed order):
//   (1) sums: one block per (chunk, head): S_c, U_c (N x P) and T_c;
//   (2) pass: one thread per state element walks the chunks forward
//       (H_{c-1} over S_c in place) and back (G_c over U_c in place), and
//       each block sums its elements' G_c o H_{c-1} for dT_c;
//   (3) rows: one block per (chunk, head, tile of rows i): dq and the row
//       sums of dl, and the inter-chunk term;
//   (4) cols: one block per (chunk, head, tile of rows j): dk, dv, the
//       column sums of dl, and the summary terms;
//   (5) finish: one block per (chunk, head): dT_c, the reverse cumsum,
//       d log_decay and d log_gate.
// Tiles of 64 rows are staged as fp32 in shared memory (rows padded to an
// odd stride) and every product is a register-tiled fp32 product on them
// (fma_tile.cuh); N and P are compiled in two classes, up to 64 and up to
// 128 (a narrower width is zero-padded).  q and k are read through their
// strides (a stride-0 head view of Mamba-2's one group), the gradients
// written contiguous (B, S, H, .).
#include "fma_tile.cuh"

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
template <typename T, int WN>
__global__ void __launch_bounds__(THREADS) ssm_bwd_sums_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ld, const float* __restrict__ lg, const float* __restrict__ dy,
    float* __restrict__ sums, float* __restrict__ ubuf, float* __restrict__ totals, int S,
    int H, int N, int P, int chunk, int C, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
    int k_sh) {
  constexpr int LD = WN + 1, TW = WN / 16;
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                 // (MAX_CHUNK,)
  float* gs = cum + MAX_CHUNK;
  float* w = gs + MAX_CHUNK;
  float* as = w + MAX_CHUNK;         // (chunk, LD): k (q) rows, weighted
  float* bs = as + chunk * LD;       // (chunk, LD): v (dy) rows
  load_decay(cum, gs, ld, lg, ck, S, H, chunk);
  const float total = cum[chunk - 1];
  if (threadIdx.x == 0) totals[ck.bhc] = total;
  const size_t vsb = (size_t)S * H * P, vss = (size_t)H * P;
  for (int half = 0; half < 2; ++half) {
    // S_c = sum_j wk_j k_j v_j^T, then U_c = sum_i wq_i q_i dy_i^T
    for (int r = threadIdx.x; r < chunk; r += THREADS)
      w[r] = half == 0 ? expf(fminf(total - cum[r] + gs[r], 30.f)) : expf(fminf(cum[r], 30.f));
    if (half == 0) {
      stage_rows(as, k, ck, 0, ck.nrow, N, chunk, LD, k_sb, k_ss, k_sh);
      stage_rows(bs, v, ck, 0, ck.nrow, P, chunk, LD, vsb, vss, P);
    } else {
      stage_rows(as, q, ck, 0, ck.nrow, N, chunk, LD, q_sb, q_ss, q_sh);
      stage_rows(bs, dy, ck, 0, ck.nrow, P, chunk, LD, vsb, vss, P);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < chunk * LD; i += THREADS) as[i] *= w[i / LD];
    __syncthreads();
    float acc[TW][TW];
    fma_tile::zero(acc);
    mm(acc, as, 1, LD, bs, LD, 1, ck.nrow);   // (n, p) = sum_j as[j][n] bs[j][p]
    float* dst = (half == 0 ? sums : ubuf) + ck.bhc * N * P;
#pragma unroll
    for (int a = 0; a < TW; ++a)
#pragma unroll
      for (int c = 0; c < TW; ++c) {
        const int n = ty() + 16 * a, p = tx() + 16 * c;
        if (n < N && p < P) dst[n * P + p] = acc[a][c];
      }
    __syncthreads();   // as / bs / w are read before the second half restages them
  }
}

// ---- (2) pass ----------------------------------------------------------
// sums[c] <- H_{c-1} (the state entering chunk c), ubuf[c] <- G_c; dtp[c,
// block] = exp(T_c) * this block's share of sum(G_c o H_{c-1}); dh0 =
// G_{-1} (when given).
__global__ void __launch_bounds__(THREADS) ssm_bwd_pass_kernel(
    float* __restrict__ sums, float* __restrict__ ubuf, const float* __restrict__ totals,
    const float* __restrict__ h0, const float* __restrict__ dfin, float* __restrict__ dh0,
    float* __restrict__ dtp, int C, int NP) {
  __shared__ float red[THREADS / 32];
  const size_t bh = blockIdx.x;
  const int e = blockIdx.y * THREADS + threadIdx.x, nb = gridDim.y;
  const bool live = e < NP;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float hs = live && h0 ? h0[bh * NP + e] : 0.f;
  for (int c = 0; c < C; ++c) {
    const size_t at = (bh * C + c) * NP + e;
    if (live) {
      const float s = sums[at];
      sums[at] = hs;
      hs = expf(totals[bh * C + c]) * hs + s;
    }
  }
  float g = live && dfin ? dfin[bh * NP + e] : 0.f;
  for (int c = C - 1; c >= 0; --c) {
    const size_t at = (bh * C + c) * NP + e;
    const float decay = expf(totals[bh * C + c]);
    float prod = 0.f, u = 0.f;
    if (live) {
      prod = g * sums[at];
      u = ubuf[at];
      ubuf[at] = g;
    }
    for (int off = 16; off; off >>= 1) prod += __shfl_xor_sync(0xffffffffu, prod, off);
    if (lane == 0) red[warp] = prod;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < THREADS / 32; ++i) s += red[i];
      dtp[(bh * C + c) * nb + blockIdx.y] = decay * s;
    }
    __syncthreads();
    g = decay * g + u;
  }
  if (live && dh0) dh0[bh * NP + e] = g;
}

// ---- (3) rows ----------------------------------------------------------
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
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ii = ty() + 16 * a, i = i0 + min(ii, ni - 1);
    const float wq = expf(fminf(cum[i], 30.f));
    float dwq = 0.f;
#pragma unroll
    for (int c = 0; c < TW; ++c) {
      dwq = fmaf(qs[ii * LD + tx() + 16 * c], z[a][c], dwq);
      dq_acc[a][c] = fmaf(wq, z[a][c], dq_acc[a][c]);
    }
    const float dl = row_sum(rs[a]);
    dwq = row_sum(dwq);
    if (tx() == 0 && ii < ni)
      rsum[ck.bhc * chunk + i] = dl + (cum[i] < 30.f ? dwq * wq : 0.f);
  }
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
// dcum_i = rsum_i - csum_i - lk_i (+ dT_c on the chunk's last row); d log
// decay its reverse cumsum, d log gate csum + lk.  One thread walks the
// chunk (at most 128 rows) in order.
__global__ void ssm_bwd_finish_kernel(const float* __restrict__ rsum,
                                      const float* __restrict__ csum,
                                      const float* __restrict__ lks, const float* __restrict__ dtp,
                                      float* __restrict__ dld, float* __restrict__ dlg, int S,
                                      int H, int chunk, int C, int nb) {
  const Chunk ck = chunk_of(blockIdx.x, H, C, S, chunk);
  if (threadIdx.x != 0) return;
  const float* rs = rsum + ck.bhc * chunk;
  const float* cs = csum + ck.bhc * chunk;
  const float* lk = lks + ck.bhc * chunk;
  float dt = 0.f;
  for (int i = 0; i < nb; ++i) dt += dtp[ck.bhc * nb + i];
  for (int j = 0; j < ck.nrow; ++j) dt += lk[j];
  float run = dt;   // dT_c lands on the chunk's last row (padding included): every row sees it
  for (int t = ck.nrow - 1; t >= 0; --t) {
    run += rs[t] - cs[t] - lk[t];
    const size_t at = ((size_t)ck.b * S + ck.c0 + t) * H + ck.h;
    dld[at] = run;
    dlg[at] = cs[t] + lk[t];
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
           cudaStream_t stream) {
  const int C = (S + chunk - 1) / chunk, NP = N * P;
  const int nb = (NP + THREADS - 1) / THREADS, tiles = (chunk + BT - 1) / BT;
  const size_t bhc = (size_t)B * H * C;
  float* sums = scratch;                 // (B, H, C, N, P): S_c, then H_{c-1}
  float* ubuf = sums + bhc * NP;         // (B, H, C, N, P): U_c, then G_c
  float* totals = ubuf + bhc * NP;       // (B, H, C)
  float* dtp = totals + bhc;             // (B, H, C, nb)
  float* rsum = dtp + bhc * nb;          // (B, H, C, chunk) each
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
  ssm_bwd_pass_kernel<<<dim3(B * H, nb), THREADS, 0, stream>>>(sums, ubuf, totals, h0, dfin,
                                                               dh0, dtp, C, NP);
  ssm_bwd_rows_kernel<T, WN><<<dim3((unsigned)bhc, tiles), THREADS, s3, stream>>>(
      qt, kt, vt, ld, lg, dy, sums, static_cast<T*>(dq), rsum, S, H, N, P, chunk, C, q_sb, q_ss,
      q_sh, k_sb, k_ss, k_sh);
  ssm_bwd_cols_kernel<T, WN><<<dim3((unsigned)bhc, tiles), THREADS, s4, stream>>>(
      qt, kt, vt, ld, lg, dy, ubuf, static_cast<T*>(dk), static_cast<T*>(dv), csum, lks, S, H,
      N, P, chunk, C, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh);
  ssm_bwd_finish_kernel<<<(unsigned)bhc, 32, 0, stream>>>(rsum, csum, lks, dtp, dld, dlg, S,
                                                          H, chunk, C, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(const void* q, const void* k, const void* v, const float* ld, const float* lg,
             const float* h0, const float* dy, const float* dfin, void* dq, void* dk, void* dv,
             float* dld, float* dlg, float* dh0, float* scratch, int B, int S, int H, int N,
             int P, int chunk, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
             cudaStream_t stream) {
  if (width_class(N, P) == 64)
    return launch<T, 64>(q, k, v, ld, lg, h0, dy, dfin, dq, dk, dv, dld, dlg, dh0, scratch, B,
                         S, H, N, P, chunk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, stream);
  return launch<T, 128>(q, k, v, ld, lg, h0, dy, dfin, dq, dk, dv, dld, dlg, dh0, scratch, B,
                        S, H, N, P, chunk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, stream);
}

}  // namespace

// Shared memory the largest of the call's blocks uses, in bytes, or -1
// for N or P over 128; the wrapper checks it before it launches.
extern "C" int ssm_backward_smem_bytes(int N, int P, int chunk) {
  if (N > 128 || P > 128) return -1;
  const int wn = width_class(N, P);
  size_t a = sums_smem(wn, chunk), b = rows_smem(wn), c = cols_smem(wn);
  size_t m = a > b ? a : b;
  return (int)(m > c ? m : c);
}

// q, k: (B, S, H, N) through strides (sb, ss, sh), v (B, S, H, P)
// contiguous, in one dtype (0 = float32, 1 = bfloat16); ld, lg (B, S, H)
// fp32; h0, dfin (B, H, N, P) fp32 or null; dy (B, S, H, P) fp32.  Writes
// dq, dk (B, S, H, N) and dv (B, S, H, P) in the inputs' dtype, dld, dlg
// (B, S, H) fp32 and (when h0 is given) dh0 (B, H, N, P) fp32.  scratch:
// fp32, 2 B H C N P + B H C (1 + cdiv(N P, 256) + 3 chunk) floats, C =
// cdiv(S, chunk).  chunk <= 128, N and P <= 128.  Returns 0 or the CUDA
// error of a launch.
extern "C" int ssm_scan_backward(const void* q, const void* k, const void* v, const void* ld,
                                 const void* lg, const void* h0, const void* dy,
                                 const void* dfin, void* dq, void* dk, void* dv, void* dld,
                                 void* dlg, void* dh0, void* scratch, int dtype, int B, int S,
                                 int H, int N, int P, int chunk, int q_sb, int q_ss, int q_sh,
                                 int k_sb, int k_ss, int k_sh, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (chunk < 1 || chunk > MAX_CHUNK || N > 128 || P > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 1)
    return launch_w<__nv_bfloat16>(q, k, v, f(ld), f(lg), f(h0), f(dy), f(dfin), dq, dk, dv,
                                   w(dld), w(dlg), w(dh0), w(scratch), B, S, H, N, P, chunk,
                                   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, s);
  return launch_w<float>(q, k, v, f(ld), f(lg), f(h0), f(dy), f(dfin), dq, dk, dv, w(dld),
                         w(dlg), w(dh0), w(scratch), B, S, H, N, P, chunk, q_sb, q_ss, q_sh,
                         k_sb, k_ss, k_sh, s);
}
