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
// against 0.0027 ms of operations on the tensor cores' bf16 rate.  This
// body runs every product as fp32 FMA on the CUDA cores (tensor cores
// come later), 7 of them (S and dP in each of its two passes), so the
// 67 TFLOP/s fp32 rate bounds it at 0.056 ms.
//
// Three launches of one call, all on the caller's stream:
//   (1) delta: D = rowsum(dO o O), one warp per (sequence, position, head),
//       into fp32 scratch (B, H, S);
//   (2) dK / dV: one block per (sequence, query head, 64-row kv tile) of
//       that head's kv head; the block stages its K / V tile, walks the
//       64-row q tiles from the diagonal on (every one when not causal),
//       and keeps dK and dV of the tile in fp32 shared memory.  For G = 1
//       it writes dK / dV in the input type; for G > 1 each query head
//       writes its fp32 share to scratch (B, S, H, D) and
//   (2b) a second launch sums the G shares of each kv head in head order
//       and rounds once -- the GQA sum is deterministic, with no atomics,
//       and the G query heads of a group run in parallel (qwen2.5-3b's K=2
//       kv heads alone would give 16 blocks at B=1, S=512);
//   (3) dQ: one block per (sequence, head, 64-row q tile), walking the kv
//       tiles up to the diagonal, dQ of the tile in fp32 shared memory.
// Inside a block every tile lives in shared memory as fp32 (bf16 inputs
// converted as they are staged, rows padded to an odd stride), and every
// product is a register-tiled fp32 product on them (fma_tile.cuh): each of
// the 16 x 16 threads holds a 4 x 4 piece of a 64 x 64 score tile, or a
// 4 x D/16 piece of a 64 x D gradient tile across the whole walk.  D is
// compiled in two classes, 64 and 128 (a smaller D is zero-padded to 64);
// D <= 128, any S: the ragged edge past S is masked (rows neither read nor
// written).
#include "fma_tile.cuh"

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
// 1: write dk / dv in T) or the (B, S, H, D) fp32 shares of each query
// head, summed by fa_bwd_sum_heads_kernel.
template <typename T, int DW>
__global__ void __launch_bounds__(THREADS) fa_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dk_part, float* __restrict__ dv_part, int S, int H, int K, int D,
    int causal, float scale) {
  constexpr int LD = DW + 1, TN = DW / 16;
  const int b = blockIdx.x, h = blockIdx.y, G = H / K, kv = h / G;
  const int j0 = blockIdx.z * BT, nj = min(BT, S - j0);
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
  fma_tile::stage(ks, k + ((size_t)b * S + j0) * kv_stride + (size_t)kv * D, kv_stride, nj,
                  D, BT, LD);
  fma_tile::stage(vs, v + ((size_t)b * S + j0) * kv_stride + (size_t)kv * D, kv_stride, nj,
                  D, BT, LD);
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
        const size_t at = (((size_t)b * S + j0 + jj) * H + h) * D + d;
        dk_part[at] = dk_acc[a][c] * scale;
        dv_part[at] = dv_acc[a][c];
      } else {
        const size_t at = (((size_t)b * S + j0 + jj) * K + kv) * D + d;
        dk[at] = from_f<T>(dk_acc[a][c] * scale);
        dv[at] = from_f<T>(dv_acc[a][c]);
      }
    }
}

// dk / dv of each kv head: the sum of its G query heads' shares, in head
// order, rounded once to T
template <typename T>
__global__ void __launch_bounds__(THREADS) fa_bwd_sum_heads_kernel(
    const float* __restrict__ dk_part, const float* __restrict__ dv_part,   // (B, S, H, D)
    T* __restrict__ dk, T* __restrict__ dv, size_t n, int G, int D) {     // (B, S, K, D)
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t row = i / D, d = i - row * D;        // row = (b, s, kv)
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
    const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int K, int D,
    int causal, float scale) {
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
  const int kv_end = causal ? i0 + ni : S;   // no row of this tile sees a key past it
  for (int j0 = 0; j0 < kv_end; j0 += BT) {
    const int nj = min(BT, kv_end - j0);
    __syncthreads();   // the last tile's dS and rows are consumed
    fma_tile::stage(ks, k + ((size_t)b * S + j0) * kv_stride + (size_t)kv * D, kv_stride,
                    nj, D, BT, LD);
    fma_tile::stage(vs, v + ((size_t)b * S + j0) * kv_stride + (size_t)kv * D, kv_stride,
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
           const float* lse, void* dq, void* dk, void* dv, float* scratch, int B, int S, int H,
           int K, int D, int causal, float scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t sa = dkdv_smem(DW), sq = dq_smem(DW);
  int err = allow_smem(fa_bwd_dkdv_kernel<T, DW>, sa);
  if (!err) err = allow_smem(fa_bwd_dq_kernel<T, DW>, sq);
  if (err) return err;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(dout);
  float* delta = scratch;                                   // (B, H, S)
  float* dk_part = G > 1 ? delta + (size_t)B * H * S : nullptr;
  float* dv_part = G > 1 ? dk_part + (size_t)B * S * H * D : nullptr;
  const int rows = B * S * H, warps = THREADS / 32;
  fa_bwd_delta_kernel<T><<<(rows + warps - 1) / warps, THREADS, 0, stream>>>(
      static_cast<const T*>(out), gt, delta, rows, S, H, D);
  const int tiles = (S + BT - 1) / BT;
  fa_bwd_dkdv_kernel<T, DW><<<dim3(B, H, tiles), THREADS, sa, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), dk_part, dv_part,
      S, H, K, D, causal, scale);
  if (G > 1) {
    const size_t n = (size_t)B * S * K * D;
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    fa_bwd_sum_heads_kernel<T><<<blocks, THREADS, 0, stream>>>(
        dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), n, G, D);
  }
  fa_bwd_dq_kernel<T, DW><<<dim3(B, H, tiles), THREADS, sq, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), S, H, K, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const float* lse, void* dq, void* dk, void* dv, float* scratch, int B, int S,
             int H, int K, int D, int causal, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, dout, lse, dq, dk, dv, scratch, B, S, H, K, D, causal,
                         scale, stream);
  return launch<T, 128>(q, k, v, out, dout, lse, dq, dk, dv, scratch, B, S, H, K, D, causal,
                        scale, stream);
}

}  // namespace

// q, dq: (B, S, H, D); k, v, dk, dv: (B, S, K, D); out, dout: (B, S, H, D),
// all contiguous in one dtype (0 = float32, 1 = bfloat16); lse (B, H, S)
// fp32 from the forward; scratch: fp32, delta (B, H, S) and, for G > 1,
// the per-query-head dk and dv shares, (B, S, H, D) each.  D <= 128.
// Returns 0 or the CUDA error of a launch.
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* dq, void* dk, void* dv, void* scratch, int dtype,
                                        int B, int S, int H, int K, int D, int causal,
                                        float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (D > MAX_D || H % K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, dout, l, dq, dk, dv, sc, B, S, H, K, D,
                                   causal, scale, s);
  return launch_d<float>(q, k, v, out, dout, l, dq, dk, dv, sc, B, S, H, K, D, causal, scale,
                         s);
}
