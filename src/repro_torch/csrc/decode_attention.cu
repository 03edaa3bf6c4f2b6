// Dense decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::decode_attention
// (def :70, body _decode_kernel :33, pallas_call :86).  It computes the
// same function: one query token per sequence, q (B, H, D), against a
// contiguous cache k, v (B, S, K, D); GQA with G = H / K query heads per kv
// head; scale 1/sqrt(D); rows at or past lengths[b] masked; online softmax
// in fp32 with NEG_INF, m_safe and l >= 1e-30; p rounded to the cache type
// before the PV product; fully masked rows give 0.  It returns the output
// only, as the Pallas function does.  Any S (the Pallas kernel asserts
// S % bkv == 0), and lengths[b] > S is allowed: a serving engine's idle
// slots count past the cache, and then every one of the S rows is live.
//
// What bounds it on an H100: memory bandwidth.  Each (sequence, kv head)
// reads its live K and V rows once and does 2 * G flops per element read,
// far below the card's ~295 flops/byte ridge.
//
// Two bodies; the caller (kernels/decode_attention/ops.py::dense_body_for)
// picks one from the type, D and G before the launch.
//
// 1. FMA (fp32, and bf16 at a D other than 64 and 128 or G > 8), the first
//    version: the paged decode kernel's FMA body with the cache read
//    directly.  One thread block per (sequence, kv head) holds all G query
//    heads of the group; the Pallas grid's sequential KV axis becomes a
//    loop inside the block over the min(cdiv(len, 64), cdiv(S, 64)) live
//    64-row tiles only.  K/V rows are staged in shared memory with 16-byte
//    loads; scores, running max / sum and the accumulator stay fp32.  At
//    zamba2's 4 slots and 32 kv heads that is 128 blocks, each walking up
//    to 17 tiles in series with scalar dot products.
// 2. Split over the cache, then a merge (bf16, D = 64 or 128, G <= 8): the
//    paged decode kernel's split body (decode_split.cuh) on a loader that
//    reads row j of kv head kv at ((b * S + j) * K + kv) * D, rows at or
//    past min(lengths[b], S) zero-filled and never read.  NS = cdiv(S, 64)
//    from the cache length on the host; a split past the length writes an
//    empty partial.  zamba2's G = 1 pads the n = 8 side with zero heads,
//    which costs nothing in a kernel bound by bytes.  On a cache read as
//    a pool through a trivial table the two kernels give the same bits.
#include "decode_split.cuh"

namespace {

using namespace paged;

constexpr int KV_TILE = 64;     // K/V rows staged per step

template <typename T>
__global__ void __launch_bounds__(THREADS) dense_decode_kernel(
    const T* __restrict__ q,              // (B, H, D)
    const T* __restrict__ k,              // (B, S, K, D)
    const T* __restrict__ v,              // (B, S, K, D)
    const int32_t* __restrict__ lengths,  // (B,)
    T* __restrict__ out,                  // (B, H, D)
    int S, int H, int K, int D, float scale) {
  const int b = blockIdx.x, kv = blockIdx.y, tid = threadIdx.x;
  const int G = H / K;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kblk = reinterpret_cast<T*>(smem);          // (KV_TILE, D)
  T* vblk = kblk + (size_t)KV_TILE * D;          // (KV_TILE, D)
  float* qs = reinterpret_cast<float*>(vblk + (size_t)KV_TILE * D);  // (G, D)
  float* acc = qs + G * D;                       // (G, D)
  float* sc = acc + G * D;                       // (G, KV_TILE) scores, then p
  float* m_s = sc + G * KV_TILE;                 // (G,)
  float* l_s = m_s + G;                          // (G,)
  float* corr_s = l_s + G;                       // (G,)

  // query heads kv*G .. kv*G+G-1 are contiguous in (B, H, D)
  const T* qb = q + ((size_t)b * H + (size_t)kv * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  const int live = min(max(lengths[b], 0), S);   // rows below lengths[b]
  const int ntile = (live + KV_TILE - 1) / KV_TILE;
  const size_t row_stride = (size_t)K * D;

  for (int it = 0; it < ntile; ++it) {
    const int base = it * KV_TILE;
    const int nrows = min(KV_TILE, live - base);
    const size_t at = (((size_t)b * S + base) * K + kv) * D;
    __syncthreads();  // the previous tile's rows and scores are consumed
    stage_rows(kblk, k + at, nrows, D, row_stride);
    stage_rows(vblk, v + at, nrows, D, row_stride);
    __syncthreads();
    for (int i = tid; i < G * KV_TILE; i += blockDim.x) {
      const int g = i / KV_TILE, r = i - g * KV_TILE;
      sc[i] = r < nrows ? dot_row(qs + g * D, kblk + (size_t)r * D, D, r) * scale : NEG_INF;
    }
    __syncthreads();
    for (int g = tid; g < G; g += blockDim.x)
      corr_s[g] = softmax_update<T>(sc + g * KV_TILE, KV_TILE, m_s[g], l_s[g]);
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i - g * D;
      const float* p = sc + g * KV_TILE;
      float pv = 0.f;
      for (int r = 0; r < nrows; ++r) pv = fmaf(p[r], to_f(vblk[(size_t)r * D + d]), pv);
      acc[i] = acc[i] * corr_s[g] + pv;
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)kv * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x)
    ob[i] = from_f<T>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           int B, int S, int H, int K, int D, float scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = 2 * (size_t)KV_TILE * D * sizeof(T) +
                      ((size_t)2 * G * D + (size_t)G * KV_TILE + 3 * (size_t)G) * sizeof(float);
  auto kernel = dense_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B, K), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), S, H, K, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, cache and out share it).  body: 0
// the FMA body (any D, G), 1 the split body (bf16, D = 64 or 128, G <= 8),
// which takes `splits` = cdiv(S, 64) and fp32 scratch of B * H * splits *
// (D + 2) floats: m, then l, then acc.  Returns 0 or the CUDA error of a
// launch.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, void* scratch, int dtype, int B,
                                int S, int H, int K, int D, int splits, float scale, int body,
                                void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1 || H / K > 8 || (long long)splits * decode_split::SPLIT_KEYS < S)
      return (int)cudaErrorInvalidValue;
    const auto* kc = static_cast<const __nv_bfloat16*>(k);
    const auto* vc = static_cast<const __nv_bfloat16*>(v);
    float* f = static_cast<float*>(scratch);
    if (D == 64)
      return decode_split::launch_split<64>(q, decode_split::DenseRows<64>{kc, vc, S, K},
                                            lengths, out, f, B, H, K, splits, scale, 0.f, s);
    if (D == 128)
      return decode_split::launch_split<128>(q, decode_split::DenseRows<128>{kc, vc, S, K},
                                             lengths, out, f, B, H, K, splits, scale, 0.f, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, H, K, D, scale, s);
  return launch<float>(q, k, v, lengths, out, B, S, H, K, D, scale, s);
}
