// Dense (causal) flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
// (def :75, body _flash_kernel :25, pallas_call :87).  It computes the
// same function: q (B, S, H, D) against k, v (B, S, K, D), GQA with
// G = H / K query heads per kv head, scale 1/sqrt(D), causal (k_pos <=
// q_pos) or not, online softmax in fp32 with the Pallas kernel's NEG_INF,
// m_safe and l >= 1e-30, p rounded to the input type before the PV
// product.  Any S: the ragged edge is masked, where the Pallas kernel
// asserts S % 512 == 0.
//
// What bounds it on an H100: operations.  zamba2-1.2b's shared-block
// prefill at S=1000 (H=K=32, D=64, bf16) does ~4.1 GFLOP of causal QK^T
// and PV on ~16 MB: 0.004 ms at the 989 TFLOP/s bf16 tensor-core rate,
// 0.005 ms of bytes.  This first version reaches neither: plain FMA on the
// CUDA cores, no tensor cores.
//
// Design (simple and right first): it is the paged prefill kernel with a
// trivial block table and q_start = 0, and shares paged_attention.cuh with
// it.  One thread block per (sequence, kv head, tile of 64 query rows of
// the S * G rows of that kv head; row r is position r / G of query head
// kv * G + r % G).  The Pallas grid's sequential KV axis becomes a loop
// inside the block over 64-row K/V tiles, up to the diagonal when causal;
// K/V rows are staged in shared memory with 16-byte loads, scores, running
// max / sum and the accumulator stay fp32.
#include "paged_attention.cuh"

namespace {

using namespace paged;

constexpr int TILE_ROWS = 64;   // query rows per block
constexpr int KV_TILE = 64;     // K/V rows staged per step

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q,     // (B, S, H, D)
    const T* __restrict__ k,     // (B, S, K, D)
    const T* __restrict__ v,     // (B, S, K, D)
    T* __restrict__ out,         // (B, S, H, D)
    int S, int H, int K, int D, int causal, float scale) {
  const int b = blockIdx.x, kv = blockIdx.y, tid = threadIdx.x;
  const int G = H / K;
  const int r0 = blockIdx.z * TILE_ROWS;
  const int nr = min(TILE_ROWS, S * G - r0);
  extern __shared__ __align__(16) unsigned char smem[];
  T* kblk = reinterpret_cast<T*>(smem);          // (KV_TILE, D)
  T* vblk = kblk + (size_t)KV_TILE * D;          // (KV_TILE, D)
  float* qs = reinterpret_cast<float*>(vblk + (size_t)KV_TILE * D);  // (TILE_ROWS, D)
  float* acc = qs + TILE_ROWS * D;               // (TILE_ROWS, D)
  float* sc = acc + TILE_ROWS * D;               // (TILE_ROWS, KV_TILE)
  float* m_s = sc + TILE_ROWS * KV_TILE;         // (TILE_ROWS,)
  float* l_s = m_s + TILE_ROWS;
  float* corr_s = l_s + TILE_ROWS;

  for (int i = tid; i < nr * D; i += blockDim.x) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr, s = r / G, g = r - s * G;
    qs[i] = to_f(q[(((size_t)b * S + s) * H + (size_t)kv * G + g) * D + d]);
    acc[i] = 0.f;
  }
  for (int rr = tid; rr < nr; rr += blockDim.x) {
    m_s[rr] = NEG_INF;
    l_s[rr] = 0.f;
  }
  // with causality no row of this tile sees a key past its last position
  const int kv_end = causal ? min(S, (r0 + nr - 1) / G + 1) : S;
  const int ntile = (kv_end + KV_TILE - 1) / KV_TILE;
  const size_t row_stride = (size_t)K * D;

  for (int it = 0; it < ntile; ++it) {
    const int base = it * KV_TILE;
    const int nrows = min(KV_TILE, kv_end - base);
    const size_t at = (((size_t)b * S + base) * K + kv) * D;
    __syncthreads();  // the previous tile's rows and scores are consumed
    stage_rows(kblk, k + at, nrows, D, row_stride);
    stage_rows(vblk, v + at, nrows, D, row_stride);
    __syncthreads();
    for (int i = tid; i < nr * KV_TILE; i += blockDim.x) {
      const int rr = i / KV_TILE, j = i - rr * KV_TILE;
      const int q_pos = (r0 + rr) / G, k_pos = base + j;
      float s = NEG_INF;
      if (j < nrows && (!causal || k_pos <= q_pos))
        s = dot_row(qs + rr * D, kblk + (size_t)j * D, D, j) * scale;
      sc[i] = s;
    }
    __syncthreads();
    for (int rr = tid; rr < nr; rr += blockDim.x)
      corr_s[rr] = softmax_update<T>(sc + rr * KV_TILE, KV_TILE, m_s[rr], l_s[rr]);
    __syncthreads();
    for (int i = tid; i < nr * D; i += blockDim.x) {
      const int rr = i / D, d = i - rr * D;
      const float* p = sc + rr * KV_TILE;
      float pv = 0.f;
      for (int j = 0; j < nrows; ++j) pv = fmaf(p[j], to_f(vblk[(size_t)j * D + d]), pv);
      acc[i] = acc[i] * corr_s[rr] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += blockDim.x) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr, s = r / G, g = r - s * G;
    out[(((size_t)b * S + s) * H + (size_t)kv * G + g) * D + d] =
        from_f<T>(acc[i] / fmaxf(l_s[rr], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int K, int D, int causal, float scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = 2 * (size_t)KV_TILE * D * sizeof(T) +
                      ((size_t)2 * TILE_ROWS * D + (size_t)TILE_ROWS * KV_TILE +
                       3 * TILE_ROWS) * sizeof(float);
  auto kernel = flash_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B, K, (S * G + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, K, D, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Returns 0 or the CUDA error of the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int dtype, int B, int S, int H, int K, int D, int causal,
                               float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, K, D, causal, scale, s);
  return launch<float>(q, k, v, out, B, S, H, K, D, causal, scale, s);
}
