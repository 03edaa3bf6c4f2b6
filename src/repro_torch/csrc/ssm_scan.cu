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
// What bounds it on an H100: operations.  At zamba2-1.2b's prefill (B=1,
// S=1000, H=64, N=P=64, chunk 128) one layer does ~3.2 GFLOP of fp32
// products on ~27 MB of inputs and outputs: 0.05 ms at the 67 TFLOP/s fp32
// rate, 0.008 ms of bytes.
//
// Design (simple and right first): the Pallas grid's sequential chunk axis
// becomes a loop inside one block per (sequence, head, 32 columns of P):
// the columns of the state are independent in both y and the update, so
// splitting P gives 128 blocks at zamba2's B=1 where one block per head
// would give 64.  Per chunk the block stages q (Q x N), k transposed
// (N x Q, padded a column against bank conflicts), its v columns (Q x 32)
// and the scores (Q x Q) in shared memory as fp32, and keeps its (N x 32)
// slice of the state there across chunks.  Every product is fp32 FMA on
// the CUDA cores; tensor cores, TMA and a chunk-parallel scan are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHUNK = 128;
constexpr int PT = 32;             // state columns (of P) per block
constexpr float NEG_INF = -1e30f;  // the reference's padded-step gate

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
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
  const int KLD = chunk + 1;                  // row length of the k^T tile
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                           // (chunk, N)
  float* kt = qs + chunk * N;                 // (N, KLD)
  float* vs = kt + N * KLD;                   // (chunk, PT)
  float* sc = vs + chunk * PT;                // (chunk, chunk) scores * w
  float* hs = sc + chunk * chunk;             // (N, PT) the state's columns
  float* cum = hs + N * PT;                   // (chunk,)
  float* gs = cum + chunk;                    // (chunk,)
  float* wk = gs + chunk;                     // (chunk,)

  const size_t state_base = ((size_t)b * H + h) * N * P + p0;
  for (int i = tid; i < N * pt; i += THREADS) {
    const int n = i / pt, p = i - n * pt;
    hs[n * PT + p] = h0 ? h0[state_base + (size_t)n * P + p] : 0.f;
  }
  const T* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const T* kb = k + (size_t)b * k_sb + (size_t)h * k_sh;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int nrow = min(chunk, S - c0);      // rows at or past S: padding
    __syncthreads();                          // the last chunk's reads are done
    for (int i = tid; i < chunk * N; i += THREADS) {
      const int r = i / N, n = i - r * N;
      float qv = 0.f, kv = 0.f;
      if (r < nrow) {
        qv = to_f(qb[(size_t)(c0 + r) * q_ss + n]);
        kv = to_f(kb[(size_t)(c0 + r) * k_ss + n]);
      }
      qs[r * N + n] = qv;
      kt[n * KLD + r] = kv;
    }
    for (int i = tid; i < chunk * pt; i += THREADS) {
      const int r = i / pt, p = i - r * pt;
      vs[r * PT + p] = r < nrow
          ? to_f(v[(((size_t)b * S + c0 + r) * H + h) * P + p0 + p]) : 0.f;
    }
    for (int r = tid; r < chunk; r += THREADS) {
      const size_t at = ((size_t)b * S + c0 + r) * H + h;
      cum[r] = r < nrow ? ld[at] : 0.f;
      gs[r] = r < nrow ? lg[at] : NEG_INF;
    }
    __syncthreads();
    if (tid < 32) {
      // inclusive cumsum of the decay: each lane sums 4 consecutive rows,
      // then the lanes' totals are scanned across the warp
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
    const float total = cum[chunk - 1];
    for (int r = tid; r < chunk; r += THREADS)
      wk[r] = expf(fminf(total - cum[r] + gs[r], 30.f));
    // scores of the live lower triangle: sc[i][j] = (q_i.k_j) w_ij, j <= i
    for (int e = tid; e < nrow * chunk; e += THREADS) {
      const int i = e / chunk, j = e - i * chunk;
      if (j > i) continue;
      const float* qi = qs + i * N;
      const float* kj = kt + j;
      float s = 0.f;
      for (int n = 0; n < N; ++n) s = fmaf(qi[n], kj[n * KLD], s);
      sc[i * chunk + j] = s * expf(fminf(cum[i] - cum[j] + gs[j], 30.f));
    }
    __syncthreads();
    // y = intra-chunk term + exp(min(cum_i, 30)) q_i . H_prev
    for (int e = tid; e < nrow * pt; e += THREADS) {
      const int i = e / pt, p = e - i * pt;
      const float* si = sc + i * chunk;
      float yd = 0.f;
      for (int j = 0; j <= i; ++j) yd = fmaf(si[j], vs[j * PT + p], yd);
      const float* qi = qs + i * N;
      float yo = 0.f;
      for (int n = 0; n < N; ++n) yo = fmaf(qi[n], hs[n * PT + p], yo);
      y[(((size_t)b * S + c0 + i) * H + h) * P + p0 + p] =
          yd + expf(fminf(cum[i], 30.f)) * yo;
    }
    __syncthreads();                          // H_prev is read; update it
    const float decay = expf(total);
    for (int e = tid; e < N * pt; e += THREADS) {
      const int n = e / pt, p = e - n * pt;
      const float* kn = kt + n * KLD;
      float s = 0.f;
      for (int j = 0; j < nrow; ++j) s = fmaf(kn[j] * wk[j], vs[j * PT + p], s);
      hs[n * PT + p] = decay * hs[n * PT + p] + s;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * pt; i += THREADS) {
    const int n = i / pt, p = i - n * pt;
    hT[state_base + (size_t)n * P + p] = hs[n * PT + p];
  }
}

// Shared memory of one block, in bytes (ops.py::smem_bytes computes the
// same and checks it against the 227 KB a block may use).
size_t smem_bytes(int N, int chunk) {
  return sizeof(float) * ((size_t)chunk * N + (size_t)N * (chunk + 1) + (size_t)chunk * PT +
                          (size_t)chunk * chunk + (size_t)N * PT + 3 * (size_t)chunk);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ld, const void* lg,
           const void* h0, void* y, void* hT, int B, int S, int H, int N, int P, int chunk,
           int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, chunk);
  auto kernel = ssm_scan_kernel<T>;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it; the decay, gate,
// states and y are fp32).  h0 may be null (a zero state).  chunk <= 128.
// Returns 0 or the CUDA error of the launch.
extern "C" int ssm_scan(const void* q, const void* k, const void* v, const void* ld,
                        const void* lg, const void* h0, void* y, void* hT, int dtype, int B,
                        int S, int H, int N, int P, int chunk, int q_sb, int q_ss, int q_sh,
                        int k_sb, int k_ss, int k_sh, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ld, lg, h0, y, hT, B, S, H, N, P, chunk, q_sb, q_ss,
                                 q_sh, k_sb, k_ss, k_sh, s);
  return launch<float>(q, k, v, ld, lg, h0, y, hT, B, S, H, N, P, chunk, q_sb, q_ss, q_sh,
                       k_sb, k_ss, k_sh, s);
}
