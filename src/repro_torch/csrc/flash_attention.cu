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
// asserts S % 512 == 0.  Non-causal, k and v may have a length of their
// own, S_kv (B, S_kv, K, D): the encoder-decoder's cross-attention puts
// the decoder's S queries against the encoder's S_kv = 1500 rows.  q and
// out rows are indexed by S, k and v rows by S_kv, and no K/V tile is
// staged past S_kv (1500 = 23 x 64 + 28: a whole last tile would read
// the next sequence's rows, or past the allocation).  Beyond the Pallas kernel, each row's log-sum-exp
// of its scaled scores is written out when asked (training keeps it for
// the backward kernel, flash_attention_backward.cu); the output is the
// same bits either way.
//
// What bounds it on an H100: operations.  zamba2-1.2b's shared-block
// prefill at S=1000 (H=K=32, D=64, bf16) does ~4.1 GFLOP of causal QK^T
// and PV on ~16 MB: 0.004 ms at the 989 TFLOP/s bf16 tensor-core rate,
// 0.005 ms of bytes.
//
// Two bodies; the caller (kernels/flash_attention/ops.py::body_for) picks
// one from the type and D before the launch.  Both keep one thread block
// per (sequence, kv head, tile of 64 query rows of the S * G rows of that
// kv head; row r is position r / G of query head kv * G + r % G), and turn
// the Pallas grid's sequential KV axis into a loop inside the block over
// 64-row K/V tiles, up to the diagonal when causal.
//
// 1. FMA (fp32, and bf16 at a D other than 64 and 128): the paged prefill
//    kernel with a trivial block table and q_start = 0, sharing
//    paged_attention.cuh with it.  K/V rows are staged in shared memory
//    with 16-byte loads; scores, running max / sum and the accumulator
//    stay fp32 in shared memory; plain FMA on the CUDA cores.
// 2. Tensor cores (bf16, D = 64 or 128), the flash-attention-2 layout:
//    - four warps, each owning 16 query rows, Q held in registers as
//      mma.sync m16n8k16 A fragments;
//    - K/V tiles of 64 rows double-buffered with cp.async (the next tile
//      loads while this one is used), XOR-swizzled by 16-byte chunk and
//      read with ldmatrix (.trans for V);
//    - S = Q K^T and O += P V on the tensor cores, fp32 accumulators;
//    - the row max and sum in registers, reduced over the four threads of
//      a row with shuffles; p rounded to bf16 in registers as the next A
//      operand;
//    - tiles past the diagonal are never visited; the diagonal tile (and
//      the ragged edge past S) is masked to NEG_INF.
//    The core (fragments, swizzle, the step on one tile) is
//    mma_attention.cuh, which the paged prefill kernel's tensor-core body
//    shares; only the K/V loader (contiguous rows here) is this file's.
#include "mma_attention.cuh"

namespace {

using namespace paged;

constexpr int TILE_ROWS = 64;   // query rows per block
constexpr int KV_TILE = 64;     // K/V rows staged per step

// A row's log-sum-exp from its running max and sum, as the output divides
// by them: p = exp(s - m_safe) / max(l, 1e-30) = exp(s - lse).
__device__ __forceinline__ float row_lse(float m, float l) {
  return fmaxf(m, NEG_INF / 2) + logf(fmaxf(l, 1e-30f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q,     // (B, S, H, D)
    const T* __restrict__ k,     // (B, S_kv, K, D)
    const T* __restrict__ v,     // (B, S_kv, K, D)
    T* __restrict__ out,         // (B, S, H, D)
    float* __restrict__ lse,     // (B, H, S) or null
    int S, int S_kv, int H, int K, int D, int causal, float scale) {
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
  const int kv_end = causal ? min(S, (r0 + nr - 1) / G + 1) : S_kv;
  const int ntile = (kv_end + KV_TILE - 1) / KV_TILE;
  const size_t row_stride = (size_t)K * D;

  for (int it = 0; it < ntile; ++it) {
    const int base = it * KV_TILE;
    const int nrows = min(KV_TILE, kv_end - base);
    const size_t at = (((size_t)b * S_kv + base) * K + kv) * D;
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
  if (lse)
    for (int rr = tid; rr < nr; rr += blockDim.x) {
      const int r = r0 + rr, s = r / G, g = r - s * G;
      lse[((size_t)b * H + (size_t)kv * G + g) * S + s] = row_lse(m_s[rr], l_s[rr]);
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int S_kv, int H, int K, int D, int causal, float scale, cudaStream_t stream) {
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
      static_cast<T*>(out), lse, S, S_kv, H, K, D, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Body 2: tensor cores (mma.sync m16n8k16), bf16, D = 64 or 128; the core
// (fragments, the online-softmax step on a 64-key tile) is mma_attention.cuh,
// shared with the paged prefill kernel; the dense K/V loader is here.
// ---------------------------------------------------------------------------

using mma_attn::KV_ROWS;
using mma_attn::MMA_THREADS;

// Rows [0, nrows) of a K or V tile into shared memory with cp.async (16
// bytes each); rows past nrows are filled with zeros.
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int nrows, size_t row_stride) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < KV_ROWS * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i - r * CH;
    const bool live = r < nrows;
    const __nv_bfloat16* g = src + (live ? (size_t)r * row_stride : 0) + c * 8;
    mma_attn::cp_async16(dst + mma_attn::swz<D>(r, c), g, live ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, S, H, D)
    const __nv_bfloat16* __restrict__ k,   // (B, S_kv, K, D)
    const __nv_bfloat16* __restrict__ v,   // (B, S_kv, K, D)
    __nv_bfloat16* __restrict__ out,       // (B, S, H, D)
    float* __restrict__ lse,               // (B, H, S) or null
    int S, int S_kv, int H, int K, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][KV_ROWS * D]
  __nv_bfloat16* vs = ks + 2 * KV_ROWS * D;                      // [2][KV_ROWS * D]

  const int b = blockIdx.x, kv = blockIdx.y, G = H / K;
  const int rows = S * G;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * TILE_ROWS;   // longest causal rows first
  const int nr = min(TILE_ROWS, rows - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4;
  const int ra = r0 + warp * 16 + gq, rb = ra + 8;           // this thread's two rows
  const int pa = ra / G, pb = rb / G;                        // their positions
  auto head_row = [&](int r) -> size_t {   // element offset of row r's head in q / out
    const int s = r / G, g = r - s * G;
    return (((size_t)b * S + s) * H + (size_t)kv * G + g) * D;
  };

  uint32_t qf[D / 16][4];             // Q as A fragments, zeros past the rows
  mma_attn::load_q<D>(qf, ra < rows ? q + head_row(ra) : nullptr,
                      rb < rows ? q + head_row(rb) : nullptr);

  // with causality no row of this tile sees a key past its last position
  const int kv_end = causal ? min(S, (r0 + nr - 1) / G + 1) : S_kv;
  const int ntiles = (kv_end + KV_ROWS - 1) / KV_ROWS;
  const size_t row_stride = (size_t)K * D;
  const __nv_bfloat16* kbase = k + ((size_t)b * S_kv * K + kv) * D;
  const __nv_bfloat16* vbase = v + ((size_t)b * S_kv * K + kv) * D;
  // scale, then the causal mask and the ragged edge past S_kv; the tiles
  // are staged only up to kv_end <= S_kv (zeros past it)
  auto score = [&](float raw, int key, int pos) {
    float s = raw * scale;
    if (key >= S_kv || (causal && key > pos)) s = NEG_INF;
    return s;
  };

  mma_attn::Rows<D> st;
  st.init();
  stage_tile<D>(ks, kbase, min(KV_ROWS, kv_end), row_stride);
  stage_tile<D>(vs, vbase, min(KV_ROWS, kv_end), row_stride);
  asm volatile("cp.async.commit_group;" ::: "memory");

  for (int tile = 0; tile < ntiles; ++tile) {
    const int base = tile * KV_ROWS, buf = tile & 1;
    if (tile + 1 < ntiles) {
      const int next = base + KV_ROWS, n = min(KV_ROWS, kv_end - next);
      stage_tile<D>(ks + (buf ^ 1) * KV_ROWS * D, kbase + next * row_stride, n, row_stride);
      stage_tile<D>(vs + (buf ^ 1) * KV_ROWS * D, vbase + next * row_stride, n, row_stride);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");   // this tile has landed
    __syncthreads();
    mma_attn::tile_step<D>(st, qf, ks + buf * KV_ROWS * D, vs + buf * KV_ROWS * D, base, pa,
                           pb, score);
    __syncthreads();   // this buffer is consumed before it is staged again
  }
  mma_attn::store_rows<D>(st, ra < rows ? out + head_row(ra) : nullptr,
                          rb < rows ? out + head_row(rb) : nullptr);
  // store_rows has summed l over the four threads of each row
  if (lse && lane % 4 == 0) {
    auto lse_at = [&](int r) -> size_t {   // row r's entry of the (B, H, S) lse
      const int s = r / G, g = r - s * G;
      return ((size_t)b * H + (size_t)kv * G + g) * S + s;
    };
    if (ra < rows) lse[lse_at(ra)] = row_lse(st.m_a, st.l_a);
    if (rb < rows) lse[lse_at(rb)] = row_lse(st.m_b, st.l_b);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int S, int S_kv, int H, int K, int causal, float scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = 4 * (size_t)KV_ROWS * D * sizeof(__nv_bfloat16);
  auto kernel = flash_mma_kernel<D>;
  static bool ready = false;
  if (!ready && smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(B, K, (S * G + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, S, S_kv,
      H, K, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  q and out
// are (B, S, H, D), k and v (B, S_kv, K, D); S_kv != S only when not
// causal (the wrapper raises otherwise; the C entry refuses it).  lse: null,
// or a (B, H, S) fp32 output that takes each row's log-sum-exp of its
// scaled scores, m_safe + log(max(l, 1e-30)) -- what the backward
// (flash_attention_backward.cu) rebuilds P from; out is the same either
// way.  body: 0 the FMA body (any D), 1 the tensor-core body (bf16, D = 64
// or 128).  Returns 0 or the CUDA error of the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               void* lse, int dtype, int B, int S, int S_kv, int H, int K,
                               int D, int causal, float scale, int body, void* stream) {
  if (causal && S_kv != S) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D == 64) return launch_mma<64>(q, k, v, out, l, B, S, S_kv, H, K, causal, scale, s);
    if (D == 128) return launch_mma<128>(q, k, v, out, l, B, S, S_kv, H, K, causal, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, l, B, S, S_kv, H, K, D, causal, scale, s);
  return launch<float>(q, k, v, out, l, B, S, S_kv, H, K, D, causal, scale, s);
}
