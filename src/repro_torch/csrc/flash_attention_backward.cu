// Backward of dense (causal) GQA flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel: the TPU kernel it differentiates,
//   src/repro/kernels/flash_attention/kernel.py::flash_attention (:75),
// has no backward (no custom_vjp in the JAX package); the reference trains
// through its plain function, repro/models/layers/attention.py::
// chunked_attention (:106), and JAX differentiates that.  This kernel
// gives the port's K4 forward (flash_attention.cu) its gradient, so that
// training runs its attention through K4 instead of the plain version.
//
// It computes the gradient of out = softmax(scale Q K^T + mask) V, scale
// 1/sqrt(D), causal (k_pos <= q_pos) or not, GQA with G = H / K query
// heads per kv head, from q, k, v, out, dout and the forward's per-row
// log-sum-exp (flash_attention.cu writes it), as flash-attention-2 does:
//   P  = exp(scale q_i.k_j - lse_i)        (masked entries 0)
//   dV = P^T dO ;  dP = dO V^T ;  D_i = rowsum(dO o O)_i
//   dS = P o (dP - D) ;  dQ = scale dS K ;  dK = scale dS^T Q
// every sum in fp32, the gradients rounded once to the inputs' type.
//
// What bounds it on an H100.  qwen2.5-3b training (B=1, S=512, H=16,
// K=2, D=128, causal) needs 5 products of S^2/2 x D per head (S
// recomputed, dV, dP, dQ, dK), 2.7 GFLOP, on 9.5 MB: 0.0028 ms of bytes
// against 0.0027 ms of operations on the tensor cores' bf16 rate.
//
// Three launches of one call, all on the caller's stream, for both bodies:
//   (1) delta: D = rowsum(dO o O), one warp per (sequence, position, head),
//       into fp32 scratch (B, H, S);
//   (2) dK / dV: one block per (sequence, query head, 64-row kv tile) of
//       that head's kv head; the block walks the q tiles from the diagonal
//       on (every one when not causal) and keeps dK and dV of its tile.
//       For G = 1 it writes dK / dV in the input type; for G > 1 each
//       query head writes its fp32 share to scratch (B, S_kv, H, D) and
//   (2b) a second launch sums the G shares of each kv head in head order
//       and rounds once -- the GQA sum is deterministic, with no atomics,
//       and the G query heads of a group run in parallel (qwen2.5-3b's K=2
//       kv heads alone would give 16 blocks at B=1, S=512);
//   (3) dQ: one block per (sequence, head, 64-row q tile), walking the kv
//       tiles up to the diagonal.
// Any S: the ragged edge past S is masked (rows neither read nor written).
// Non-causal, k and v may have a length of their own, S_kv (B, S_kv, K,
// D), as in the forward: whisper's cross-attention puts the decoder's S
// query rows against the encoder's S_kv = 1500.  Query rows (q, out, dout,
// dq, lse, delta) are indexed by S, key rows (k, v, dk, dv and the fp32
// shares) by S_kv: pass (2) runs a block per key tile of S_kv and walks
// the S query rows, pass (3) walks keys up to S_kv, and no K/V tile is
// staged past S_kv (1500 = 23 x 64 + 28).
// The caller (kernels/flash_attention/ops.py::backward_body_for) picks the
// body of passes (2) and (3) before the launch:
//
// 1. "fma" (fp32, and bf16 at a D other than 64 and 128; D <= 128): every
//    tile lives in shared memory as fp32 (bf16 inputs converted as they
//    are staged, rows padded to an odd stride), and every product is a
//    register-tiled fp32 product on them (fma_tile.cuh): each of the 16 x
//    16 threads holds a 4 x 4 piece of a 64 x 64 score tile, or a 4 x D/16
//    piece of a 64 x D gradient tile across the whole walk.  D is compiled
//    in two classes, 64 and 128 (a smaller D is zero-padded to 64).  It
//    runs 7 products (S and dP in each pass) at the 67 TFLOP/s fp32 rate.
// 2. "mma" (bf16 at D = 64 or 128, every training call of qwen2.5-3b and
//    zamba2): mma.sync m16n8k16 with fp32 accumulators, mma_attention.cuh's
//    fragment helpers, XOR swizzle, ldmatrix and cp_async16.  Four warps
//    own 16 rows each of the block's 64-row tile; the walked tiles (32 rows
//    at D = 128, 64 at D = 64, so that a thread's accumulators fit its
//    registers) are double-buffered with cp.async, the next one in flight
//    while the current one computes.  S (S^T in the dK / dV pass) and dP
//    are products of staged bf16 tiles, exact in fp32.  P and dS are
//    formed in the accumulator registers and turned into the next
//    product's A fragments without a trip through shared memory, each as a
//    bf16 hi + lo pair (hi = bf16(x), lo = bf16(x - hi); ssm_scan.cu splits
//    its fp32 operands the same way), so dV += P^T dO, dK += dS^T Q and
//    dQ += dS K are two products each into one accumulator.  Rounding P
//    and dS to bf16 once, as flash-attention-2 does, would put the
//    gradients past the bf16 limit (tests/test_torch_backward.py models
//    both roundings on the CPU).
#include "fma_tile.cuh"
#include "mma_attention.cuh"

namespace {

using fma_tile::from_f;
using fma_tile::mm;
using fma_tile::to_f;
using fma_tile::tx;
using fma_tile::ty;

constexpr int BT = 64;         // rows of a q tile and of a kv tile
constexpr int LDT = BT + 1;    // row stride of a score tile
constexpr int THREADS = fma_tile::THREADS;
constexpr int MAX_D = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS) fa_bwd_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,   // (B, S, H, D)
    float* __restrict__ delta,                               // (B, H, S)
    int rows, int S, int H, int D) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + (size_t)row * D;
  const T* g = dout + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(g[d]), to_f(o[d]), acc);
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// The row statistics of a q tile: lse and delta of rows i0 .. i0 + ni - 1.
__device__ __forceinline__ void stage_stats(float* lse_s, float* dl_s, const float* lse,
                                            const float* delta, size_t at, int ni) {
  for (int r = threadIdx.x; r < BT; r += THREADS) {
    lse_s[r] = r < ni ? lse[at + r] : 0.f;
    dl_s[r] = r < ni ? delta[at + r] : 0.f;
  }
}

// dK / dV of one 64-row kv tile against the queries of one head, with the
// tile's rows (kv rows jj = ty + 16 i) by D in registers.  part: null (G =
// 1: write dk / dv in T) or the (B, S_kv, H, D) fp32 shares of each query
// head, summed by fa_bwd_sum_heads_kernel.
template <typename T, int DW>
__global__ void __launch_bounds__(THREADS) fa_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dk_part, float* __restrict__ dv_part, int S, int S_kv, int H, int K,
    int D, int causal, float scale) {
  constexpr int LD = DW + 1, TN = DW / 16;
  const int b = blockIdx.x, h = blockIdx.y, G = H / K, kv = h / G;
  const int j0 = blockIdx.z * BT, nj = min(BT, S_kv - j0);
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // (BT, LD)
  float* vs = ks + BT * LD;
  float* qs = vs + BT * LD;
  float* dos = qs + BT * LD;
  float* pt = dos + BT * LD;           // (BT, LDT) P^T: kv rows by q rows
  float* dst = pt + BT * LDT;          // (BT, LDT) dS^T
  float* lse_s = dst + BT * LDT;       // (BT,)
  float* dl_s = lse_s + BT;            // (BT,)

  const size_t kv_stride = (size_t)K * D, q_stride = (size_t)H * D;
  fma_tile::stage(ks, k + ((size_t)b * S_kv + j0) * kv_stride + (size_t)kv * D, kv_stride,
                  nj, D, BT, LD);
  fma_tile::stage(vs, v + ((size_t)b * S_kv + j0) * kv_stride + (size_t)kv * D, kv_stride,
                  nj, D, BT, LD);
  float dk_acc[4][TN], dv_acc[4][TN];
  fma_tile::zero(dk_acc);
  fma_tile::zero(dv_acc);
  for (int i0 = causal ? j0 : 0; i0 < S; i0 += BT) {
    const int ni = min(BT, S - i0);
    __syncthreads();   // the last tile's P / dS and rows are consumed
    const size_t qat = ((size_t)b * S + i0) * q_stride + (size_t)h * D;
    fma_tile::stage(qs, q + qat, q_stride, ni, D, BT, LD);
    fma_tile::stage(dos, dout + qat, q_stride, ni, D, BT, LD);
    stage_stats(lse_s, dl_s, lse, delta, ((size_t)b * H + h) * S + i0, ni);
    __syncthreads();
    float st[4][4], dpt[4][4];   // S^T and dP^T: kv rows by q rows
    fma_tile::zero(st);
    fma_tile::zero(dpt);
    mm(st, ks, LD, 1, qs, 1, LD, D);
    mm(dpt, vs, LD, 1, dos, 1, LD, D);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = ty() + 16 * a, ii = tx() + 16 * c;
        float p = 0.f, ds = 0.f;
        if (ii < ni && jj < nj && (!causal || j0 + jj <= i0 + ii)) {
          p = expf(st[a][c] * scale - lse_s[ii]);
          ds = p * (dpt[a][c] - dl_s[ii]);
        }
        pt[jj * LDT + ii] = p;
        dst[jj * LDT + ii] = ds;
      }
    __syncthreads();
    mm(dv_acc, pt, LDT, 1, dos, LD, 1, ni);   // dV += P^T dO
    mm(dk_acc, dst, LDT, 1, qs, LD, 1, ni);   // dK += dS^T Q
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int jj = ty() + 16 * a, d = tx() + 16 * c;
      if (jj >= nj || d >= D) continue;
      if (dk_part) {
        const size_t at = (((size_t)b * S_kv + j0 + jj) * H + h) * D + d;
        dk_part[at] = dk_acc[a][c] * scale;
        dv_part[at] = dv_acc[a][c];
      } else {
        const size_t at = (((size_t)b * S_kv + j0 + jj) * K + kv) * D + d;
        dk[at] = from_f<T>(dk_acc[a][c] * scale);
        dv[at] = from_f<T>(dv_acc[a][c]);
      }
    }
}

// dk / dv of each kv head: the sum of its G query heads' shares, in head
// order, rounded once to T
template <typename T>
__global__ void __launch_bounds__(THREADS) fa_bwd_sum_heads_kernel(
    const float* __restrict__ dk_part, const float* __restrict__ dv_part,   // (B, S_kv, H, D)
    T* __restrict__ dk, T* __restrict__ dv, size_t n, int G, int D) {     // (B, S_kv, K, D)
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t row = i / D, d = i - row * D;        // row = (b, key row, kv)
  const float* pk = dk_part + row * G * D + d;
  const float* pv = dv_part + row * G * D + d;
  float sk = 0.f, sv = 0.f;
  for (int g = 0; g < G; ++g) {
    sk += pk[(size_t)g * D];
    sv += pv[(size_t)g * D];
  }
  dk[i] = from_f<T>(sk);
  dv[i] = from_f<T>(sv);
}

// dQ of one 64-row q tile of one head, its rows (ii = ty + 16 i) by D in
// registers, over the kv tiles up to the diagonal.
template <typename T, int DW>
__global__ void __launch_bounds__(THREADS) fa_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int S_kv, int H, int K,
    int D, int causal, float scale) {
  constexpr int LD = DW + 1, TN = DW / 16;
  const int b = blockIdx.x, h = blockIdx.y, G = H / K, kv = h / G;
  const int i0 = blockIdx.z * BT, ni = min(BT, S - i0);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // (BT, LD)
  float* dos = qs + BT * LD;
  float* ks = dos + BT * LD;
  float* vs = ks + BT * LD;
  float* dst = vs + BT * LD;           // (BT, LDT) dS: q rows by kv rows
  float* lse_s = dst + BT * LDT;
  float* dl_s = lse_s + BT;

  const size_t kv_stride = (size_t)K * D, q_stride = (size_t)H * D;
  const size_t qat = ((size_t)b * S + i0) * q_stride + (size_t)h * D;
  fma_tile::stage(qs, q + qat, q_stride, ni, D, BT, LD);
  fma_tile::stage(dos, dout + qat, q_stride, ni, D, BT, LD);
  stage_stats(lse_s, dl_s, lse, delta, ((size_t)b * H + h) * S + i0, ni);
  float dq_acc[4][TN];
  fma_tile::zero(dq_acc);
  const int kv_end = causal ? i0 + ni : S_kv;   // no row of this tile sees a key past it
  for (int j0 = 0; j0 < kv_end; j0 += BT) {
    const int nj = min(BT, kv_end - j0);
    __syncthreads();   // the last tile's dS and rows are consumed
    fma_tile::stage(ks, k + ((size_t)b * S_kv + j0) * kv_stride + (size_t)kv * D, kv_stride,
                    nj, D, BT, LD);
    fma_tile::stage(vs, v + ((size_t)b * S_kv + j0) * kv_stride + (size_t)kv * D, kv_stride,
                    nj, D, BT, LD);
    __syncthreads();
    float sc[4][4], dp[4][4];   // S and dP: q rows by kv rows
    fma_tile::zero(sc);
    fma_tile::zero(dp);
    mm(sc, qs, LD, 1, ks, 1, LD, D);
    mm(dp, dos, LD, 1, vs, 1, LD, D);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ii = ty() + 16 * a, jj = tx() + 16 * c;
        float ds = 0.f;
        if (ii < ni && jj < nj && (!causal || j0 + jj <= i0 + ii))
          ds = expf(sc[a][c] * scale - lse_s[ii]) * (dp[a][c] - dl_s[ii]);
        dst[ii * LDT + jj] = ds;
      }
    __syncthreads();
    mm(dq_acc, dst, LDT, 1, ks, LD, 1, nj);   // dQ += dS K
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int ii = ty() + 16 * a, d = tx() + 16 * c;
      if (ii < ni && d < D)
        dq[((size_t)b * S + i0 + ii) * q_stride + (size_t)h * D + d] =
            from_f<T>(dq_acc[a][c] * scale);
    }
}

size_t dkdv_smem(int DW) {
  return (4 * (size_t)BT * (DW + 1) + 2 * BT * LDT + 2 * BT) * sizeof(float);
}
size_t dq_smem(int DW) {
  return (4 * (size_t)BT * (DW + 1) + BT * LDT + 2 * BT) * sizeof(float);
}

template <typename Kern>
int allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int DW>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* scratch, int B, int S,
           int S_kv, int H, int K, int D, int causal, float scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t sa = dkdv_smem(DW), sq = dq_smem(DW);
  int err = allow_smem(fa_bwd_dkdv_kernel<T, DW>, sa);
  if (!err) err = allow_smem(fa_bwd_dq_kernel<T, DW>, sq);
  if (err) return err;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(dout);
  float* delta = scratch;                                   // (B, H, S)
  float* dk_part = G > 1 ? delta + (size_t)B * H * S : nullptr;
  float* dv_part = G > 1 ? dk_part + (size_t)B * S_kv * H * D : nullptr;
  const int rows = B * S * H, warps = THREADS / 32;
  fa_bwd_delta_kernel<T><<<(rows + warps - 1) / warps, THREADS, 0, stream>>>(
      static_cast<const T*>(out), gt, delta, rows, S, H, D);
  const int kv_tiles = (S_kv + BT - 1) / BT, q_tiles = (S + BT - 1) / BT;
  fa_bwd_dkdv_kernel<T, DW><<<dim3(B, H, kv_tiles), THREADS, sa, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), dk_part, dv_part,
      S, S_kv, H, K, D, causal, scale);
  if (G > 1) {
    const size_t n = (size_t)B * S_kv * K * D;
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    fa_bwd_sum_heads_kernel<T><<<blocks, THREADS, 0, stream>>>(
        dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), n, G, D);
  }
  fa_bwd_dq_kernel<T, DW><<<dim3(B, H, q_tiles), THREADS, sq, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), S, S_kv, H, K, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const float* lse, void* dq, void* dk, void* dv, float* scratch, int B, int S,
             int S_kv, int H, int K, int D, int causal, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, dout, lse, dq, dk, dv, scratch, B, S, S_kv, H, K, D,
                         causal, scale, stream);
  return launch<T, 128>(q, k, v, out, dout, lse, dq, dk, dv, scratch, B, S, S_kv, H, K, D,
                        causal, scale, stream);
}


// ---------------------------------------------------------------------------
// Body "mma": bf16 at D = 64 or 128 on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using mma_attn::ldsm_x4;
using mma_attn::ldsm_x4_trans;
using mma_attn::mma16816;
using mma_attn::swz;

constexpr int MMA_THREADS = mma_attn::MMA_THREADS;   // four warps of 16 rows
constexpr int OWN = 64;                              // rows of the block's own tile

// Rows of a walked tile: 32 at D = 128 (a thread then holds dK and dV, 128
// fp32 accumulators, beside a 16 x 32 score tile), 64 at D = 64.
template <int D>
constexpr int WALK = D == 128 ? 32 : 64;

template <int D>
constexpr size_t mma_smem_bytes() {   // the block's own two tiles, two buffers of two walked ones
  return ((size_t)2 * OWN * D + (size_t)4 * WALK<D> * D) * sizeof(bf16) +
         (size_t)4 * WALK<D> * sizeof(float);
}

// Rows [0, n) of a (R, D) bf16 tile, row r at src + r * stride, into the
// swizzled tile dst with cp.async; rows n .. R - 1 are filled with zeros.
template <int D, int R>
__device__ __forceinline__ void stage_rows16(bf16* dst, const bf16* src, int n, size_t stride) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < R * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i - r * CH;
    const bool live = r < n;
    mma_attn::cp_async16(dst + swz<D>(r, c), src + (live ? r * stride + c * 8 : 0), live ? 16 : 0);
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// a and b as a bf16 pair (hi) and the pair of what that rounding left (lo):
// hi + lo carries a and b to 2^-16 of themselves, against 2^-8 for hi alone
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = mma_attn::pack_bf16(a - __low2float(h), b - __high2float(h));
}

// acc (16 rows x 8 n8 blocks of D) += (hi + lo) (16 x 16, k16 step j of the
// walked tile) times the walked tile's rows 16 j .. 16 j + 15 by D, read
// with ldmatrix.trans (k = the walked row, n = d): two products into one
// accumulator, hi first.
template <int D>
__device__ __forceinline__ void add_product(float (&acc)[D / 8][4], const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4], const bf16* tile, int j,
                                            int lane) {
  const int row = 16 * j + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
  for (int dn = 0; dn < D / 8; dn += 2) {
    uint32_t bt[4];   // B of d blocks dn and dn + 1
    ldsm_x4_trans(bt, tile + swz<D>(row, dn + (lane >> 4)));
    mma16816(acc[dn], hi, bt[0], bt[1]);
    mma16816(acc[dn], lo, bt[0], bt[1]);
    mma16816(acc[dn + 1], hi, bt[2], bt[3]);
    mma16816(acc[dn + 1], lo, bt[2], bt[3]);
  }
}

// x (16 rows: this warp's rows `a` of own tile `own`) times the walked tile
// `walk`'s rows^T, and y likewise with `own2` / `walk2`: two 16 x (8 NB)
// score tiles, over D, all four operands staged bf16 tiles (A from own
// rows, B from walked rows, both [row][d], read with ldmatrix).
template <int D, int NB>
__device__ __forceinline__ void two_scores(float (&x)[NB][4], float (&y)[NB][4], const bf16* own,
                                           const bf16* own2, const bf16* walk,
                                           const bf16* walk2, int warp, int lane) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) x[nb][0] = x[nb][1] = x[nb][2] = x[nb][3] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) y[nb][0] = y[nb][1] = y[nb][2] = y[nb][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4], a2[4];
    const int ar = warp * 16 + (lane & 15), ac = 2 * kc + (lane >> 4);
    ldsm_x4(a, own + swz<D>(ar, ac));
    ldsm_x4(a2, own2 + swz<D>(ar, ac));
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t b[4], b2[4];   // B of n8 blocks nb and nb + 1, k16 step kc
      const int br = nb * 8 + (lane >> 4) * 8 + (lane & 7), bc = 2 * kc + ((lane >> 3) & 1);
      ldsm_x4(b, walk + swz<D>(br, bc));
      ldsm_x4(b2, walk2 + swz<D>(br, bc));
      mma16816(x[nb], a, b[0], b[1]);
      mma16816(x[nb + 1], a, b[2], b[3]);
      mma16816(y[nb], a2, b2[0], b2[1]);
      mma16816(y[nb + 1], a2, b2[2], b2[3]);
    }
  }
}

// dK / dV of one 64-row kv tile against the queries of one head, walking
// the q tiles; a warp owns kv rows 16 warp .. + 15.  part: null (G = 1:
// write dk / dv in bf16) or the (B, S_kv, H, D) fp32 shares of each query head.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) fa_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dk_part, float* __restrict__ dv_part, int S, int S_kv, int H, int K,
    int causal, float scale) {
  constexpr int QT = WALK<D>, QN = QT / 8, DN = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // (OWN, D)
  bf16* vs = ks + OWN * D;
  bf16* qs = vs + OWN * D;                     // [2][QT * D]
  bf16* dos = qs + 2 * QT * D;                 // [2][QT * D]
  float* stats = reinterpret_cast<float*>(dos + 2 * QT * D);   // [2][lse QT, delta QT]

  const int b = blockIdx.x, h = blockIdx.y, G = H / K, kv = h / G;
  const int j0 = blockIdx.z * OWN, nj = min(OWN, S_kv - j0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, cq = lane % 4;
  const int ja = j0 + warp * 16 + lane / 4, jb = ja + 8;   // this thread's kv rows
  const size_t kv_stride = (size_t)K * D, q_stride = (size_t)H * D;
  const size_t kvat = ((size_t)b * S_kv + j0) * kv_stride + (size_t)kv * D;
  stage_rows16<D, OWN>(ks, k + kvat, nj, kv_stride);
  stage_rows16<D, OWN>(vs, v + kvat, nj, kv_stride);

  const int i_first = causal ? j0 : 0;   // a multiple of QT
  const int nt = (S - i_first + QT - 1) / QT;
  const size_t srow = ((size_t)b * H + h) * S;
  auto stage_q = [&](int t, int buf) {
    const int i0 = i_first + t * QT, ni = min(QT, S - i0);
    const size_t at = ((size_t)b * S + i0) * q_stride + (size_t)h * D;
    stage_rows16<D, QT>(qs + buf * QT * D, q + at, ni, q_stride);
    stage_rows16<D, QT>(dos + buf * QT * D, dout + at, ni, q_stride);
    float* st = stats + buf * 2 * QT;
    for (int r = threadIdx.x; r < QT; r += MMA_THREADS) {
      st[r] = r < ni ? lse[srow + i0 + r] : 0.f;
      st[QT + r] = r < ni ? delta[srow + i0 + r] : 0.f;
    }
  };

  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  stage_q(0, 0);
  commit();
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1, i0 = i_first + t * QT;
    if (t + 1 < nt) stage_q(t + 1, buf ^ 1);
    commit();
    wait_group<1>();   // this q tile (and, at t = 0, the kv tile) has landed
    __syncthreads();
    const bf16* qt = qs + buf * QT * D;
    const bf16* dt = dos + buf * QT * D;
    const float* lse_s = stats + buf * 2 * QT;
    const float* dl_s = lse_s + QT;
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 kv rows by QT q rows
    float st[QN][4], dpt[QN][4];
    two_scores<D, QN>(st, dpt, ks, vs, qt, dt, warp, lane);
    // P^T and dS^T by k16 step of the q rows, as hi + lo A fragments, then
    // dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int j = 0; j < QN / 2; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb = 2 * j + half;
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = nb * 8 + 2 * cq + (e & 1), i = i0 + ii, jj = e < 2 ? ja : jb;
          const bool live = i < S && jj < S_kv && (!causal || jj <= i);
          p[e] = live ? expf(st[nb][e] * scale - lse_s[ii]) : 0.f;
          ds[e] = p[e] * (dpt[nb][e] - dl_s[ii]);
        }
        split_pair(p[0], p[1], ph[2 * half], pl[2 * half]);
        split_pair(p[2], p[3], ph[2 * half + 1], pl[2 * half + 1]);
        split_pair(ds[0], ds[1], sh[2 * half], sl[2 * half]);
        split_pair(ds[2], ds[3], sh[2 * half + 1], sl[2 * half + 1]);
      }
      add_product<D>(dv_acc, ph, pl, dt, j, lane);   // dV += P^T dO
      add_product<D>(dk_acc, sh, sl, qt, j, lane);   // dK += dS^T Q
    }
    __syncthreads();   // this buffer is consumed before it is staged again
  }
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int d = dn * 8 + 2 * cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jj = half ? jb : ja;
      if (jj >= S_kv) continue;
      const float k0 = dk_acc[dn][2 * half] * scale, k1 = dk_acc[dn][2 * half + 1] * scale;
      const float v0 = dv_acc[dn][2 * half], v1 = dv_acc[dn][2 * half + 1];
      if (dk_part) {
        const size_t at = (((size_t)b * S_kv + jj) * H + h) * D + d;
        *reinterpret_cast<float2*>(dk_part + at) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(dv_part + at) = make_float2(v0, v1);
      } else {
        const size_t at = (((size_t)b * S_kv + jj) * K + kv) * D + d;
        *reinterpret_cast<uint32_t*>(dk + at) = mma_attn::pack_bf16(k0, k1);
        *reinterpret_cast<uint32_t*>(dv + at) = mma_attn::pack_bf16(v0, v1);
      }
    }
  }
}

// dQ of one 64-row q tile of one head, walking the kv tiles up to the
// diagonal; a warp owns q rows 16 warp .. + 15.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) fa_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int S, int S_kv, int H, int K,
    int causal, float scale) {
  constexpr int KT = WALK<D>, KN = KT / 8, DN = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // (OWN, D)
  bf16* dos = qs + OWN * D;
  bf16* ks = dos + OWN * D;                    // [2][KT * D]
  bf16* vs = ks + 2 * KT * D;                  // [2][KT * D]

  const int b = blockIdx.x, h = blockIdx.y, G = H / K, kv = h / G;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * OWN;   // the longest causal walks first
  const int ni = min(OWN, S - i0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, cq = lane % 4;
  const int ia = i0 + warp * 16 + lane / 4, ib = ia + 8;   // this thread's q rows
  const size_t kv_stride = (size_t)K * D, q_stride = (size_t)H * D;
  const size_t qat = ((size_t)b * S + i0) * q_stride + (size_t)h * D;
  stage_rows16<D, OWN>(qs, q + qat, ni, q_stride);
  stage_rows16<D, OWN>(dos, dout + qat, ni, q_stride);
  const size_t srow = ((size_t)b * H + h) * S;
  const float lse_a = ia < S ? lse[srow + ia] : 0.f, lse_b = ib < S ? lse[srow + ib] : 0.f;
  const float dl_a = ia < S ? delta[srow + ia] : 0.f, dl_b = ib < S ? delta[srow + ib] : 0.f;

  const int kv_end = causal ? i0 + ni : S_kv;   // no row of this tile sees a key past it
  const int nt = (kv_end + KT - 1) / KT;
  const bf16* kbase = k + (size_t)b * S_kv * kv_stride + (size_t)kv * D;
  const bf16* vbase = v + (size_t)b * S_kv * kv_stride + (size_t)kv * D;
  auto stage_kv = [&](int t, int buf) {
    const int j0 = t * KT, n = min(KT, kv_end - j0);
    stage_rows16<D, KT>(ks + buf * KT * D, kbase + j0 * kv_stride, n, kv_stride);
    stage_rows16<D, KT>(vs + buf * KT * D, vbase + j0 * kv_stride, n, kv_stride);
  };

  float dq_acc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  stage_kv(0, 0);
  commit();
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1, j0 = t * KT;
    if (t + 1 < nt) stage_kv(t + 1, buf ^ 1);
    commit();
    wait_group<1>();   // this kv tile (and, at t = 0, the q tile) has landed
    __syncthreads();
    const bf16* kt = ks + buf * KT * D;
    const bf16* vt = vs + buf * KT * D;
    // S = Q K^T and dP = dO V^T: this warp's 16 q rows by KT kv rows
    float sc[KN][4], dp[KN][4];
    two_scores<D, KN>(sc, dp, qs, dos, kt, vt, warp, lane);
#pragma unroll
    for (int j = 0; j < KN / 2; ++j) {
      uint32_t sh[4], sl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nb = 2 * j + half;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = j0 + nb * 8 + 2 * cq + (e & 1), i = e < 2 ? ia : ib;
          const bool live = i < S && jj < kv_end && (!causal || jj <= i);
          const float p = live ? expf(sc[nb][e] * scale - (e < 2 ? lse_a : lse_b)) : 0.f;
          ds[e] = p * (dp[nb][e] - (e < 2 ? dl_a : dl_b));
        }
        split_pair(ds[0], ds[1], sh[2 * half], sl[2 * half]);
        split_pair(ds[2], ds[3], sh[2 * half + 1], sl[2 * half + 1]);
      }
      add_product<D>(dq_acc, sh, sl, kt, j, lane);   // dQ += dS K
    }
    __syncthreads();   // this buffer is consumed before it is staged again
  }
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int d = dn * 8 + 2 * cq;
    if (ia < S)
      *reinterpret_cast<uint32_t*>(dq + ((size_t)b * S + ia) * q_stride + (size_t)h * D + d) =
          mma_attn::pack_bf16(dq_acc[dn][0] * scale, dq_acc[dn][1] * scale);
    if (ib < S)
      *reinterpret_cast<uint32_t*>(dq + ((size_t)b * S + ib) * q_stride + (size_t)h * D + d) =
          mma_attn::pack_bf16(dq_acc[dn][2] * scale, dq_acc[dn][3] * scale);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* scratch, int B, int S,
               int S_kv, int H, int K, int causal, float scale, cudaStream_t stream) {
  const int G = H / K;
  constexpr size_t smem = mma_smem_bytes<D>();
  int err = allow_smem(fa_bwd_dkdv_mma_kernel<D>, smem);
  if (!err) err = allow_smem(fa_bwd_dq_mma_kernel<D>, smem);
  if (err) return err;
  const bf16 *qt = static_cast<const bf16*>(q), *kt = static_cast<const bf16*>(k);
  const bf16 *vt = static_cast<const bf16*>(v), *gt = static_cast<const bf16*>(dout);
  float* delta = scratch;                                   // (B, H, S)
  float* dk_part = G > 1 ? delta + (size_t)B * H * S : nullptr;
  float* dv_part = G > 1 ? dk_part + (size_t)B * S_kv * H * D : nullptr;
  const int rows = B * S * H, warps = THREADS / 32;
  fa_bwd_delta_kernel<bf16><<<(rows + warps - 1) / warps, THREADS, 0, stream>>>(
      static_cast<const bf16*>(out), gt, delta, rows, S, H, D);
  const int kv_tiles = (S_kv + OWN - 1) / OWN, q_tiles = (S + OWN - 1) / OWN;
  fa_bwd_dkdv_mma_kernel<D><<<dim3(B, H, kv_tiles), MMA_THREADS, smem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dk_part,
      dv_part, S, S_kv, H, K, causal, scale);
  if (G > 1) {
    const size_t n = (size_t)B * S_kv * K * D;
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    fa_bwd_sum_heads_kernel<bf16><<<blocks, THREADS, 0, stream>>>(
        dk_part, dv_part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, G, D);
  }
  fa_bwd_dq_mma_kernel<D><<<dim3(B, H, q_tiles), MMA_THREADS, smem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), S, S_kv, H, K, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dq: (B, S, H, D); k, v, dk, dv: (B, S_kv, K, D); out, dout: (B, S,
// H, D), all contiguous in one dtype (0 = float32, 1 = bfloat16); lse (B,
// H, S) fp32 from the forward; scratch: fp32, delta (B, H, S) and, for G >
// 1, the per-query-head dk and dv shares, (B, S_kv, H, D) each.  D <= 128.
// S_kv != S only when not causal, and S_kv > 0 where S > 0 (both refused
// otherwise).  body: 0 the FMA body (any D), 1 the tensor-core body (bf16,
// D = 64 or 128; every pointer 16-byte aligned).  Returns 0 or the CUDA
// error of a launch.
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* dq, void* dk, void* dv, void* scratch, int dtype,
                                        int B, int S, int S_kv, int H, int K, int D,
                                        int causal, float scale, int body, void* stream) {
  if (causal && S_kv != S) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  if (S_kv <= 0 || D > MAX_D || H % K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D == 64)
      return launch_mma<64>(q, k, v, out, dout, l, dq, dk, dv, sc, B, S, S_kv, H, K, causal,
                            scale, s);
    if (D == 128)
      return launch_mma<128>(q, k, v, out, dout, l, dq, dk, dv, sc, B, S, S_kv, H, K, causal,
                             scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, dout, l, dq, dk, dv, sc, B, S, S_kv, H, K,
                                   D, causal, scale, s);
  return launch_d<float>(q, k, v, out, dout, l, dq, dk, dv, sc, B, S, S_kv, H, K, D, causal,
                         scale, s);
}
