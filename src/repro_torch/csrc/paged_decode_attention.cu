// Paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::paged_decode_attention
// (def :163, body _paged_kernel :108, pallas_call :216).  It computes the
// same function: one query token per sequence against the paged KV pool,
// read through the sequence's block table; GQA with G = H / K query heads
// per kv head (query head h reads kv head h / G); scale 1/sqrt(D), optional
// softcap * tanh(s / softcap); online softmax over the pool blocks; rows at
// or past lengths[b] never read; fully masked rows give 0.  The pool is in
// q's type, or int8 with an fp32 scale per (block, row, kv head) (the
// Pallas body's quant branch): each staged row is dequantized to q's type,
// float(int8) * scale in one fp32 multiply and one rounding, before both
// products, and p is rounded to q's type for the PV product.
//
// What bounds it on an H100: memory bandwidth.  Each (sequence, kv head)
// reads its live K and V rows once and does 2 * G flops per element read,
// far below the card's ~295 flops/byte ridge, so the least time is the live
// KV bytes over 3.35 TB/s.
//
// Two bodies; the caller (kernels/decode_attention/ops.py::body_for) picks
// one from the type, D and G before the launch.
//
// 1. FMA (fp32, and bf16 at a D other than 64 and 128 or G > 8), the
//    first version: one thread block per (sequence, kv head) holds all G
//    query heads of the group and loops over the cdiv(lengths[b], bs) live
//    pool blocks only, one block's bs K and V rows staged in shared memory
//    with 16-byte loads (from an int8 pool: dequantized to q's type on the
//    way, stage_rows_i8); scores, running max / sum and accumulator fp32.
//    At 4 sequences and 2 kv heads that is 8 blocks on 132 SMs.
// 2. Split over the KV length, then a merge (bf16, D = 64 or 128, G <= 8):
//    decode_split.cuh, shared with the dense decode kernel, on a row
//    loader that reads key j through the table (PagedRows; QuantPagedRows
//    from an int8 pool, dequantizing as it stages).  Each block takes
//    SPLIT_KEYS = 64 keys (64 / bs pool blocks) of one (sequence, kv head);
//    NS = cdiv(mb * bs, 64) comes from the table width on the host: at
//    serving's B = 4, K = 2, mb = 66 that is 136 blocks.  A log-sum-exp
//    merge of the partials is the call's second launch.
#include <type_traits>

#include "decode_split.cuh"

namespace {

using namespace paged;

// T: q's (and out's) type; P: the pool's, T or int8_t (then with scales)
template <typename T, typename P>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q,              // (B, H, D)
    const P* __restrict__ k_pool,         // (N, bs, K, D)
    const P* __restrict__ v_pool,         // (N, bs, K, D)
    const float* __restrict__ k_scale,    // (N, bs, K), int8 pools only
    const float* __restrict__ v_scale,    // (N, bs, K), int8 pools only
    const int32_t* __restrict__ tables,   // (B, mb)
    const int32_t* __restrict__ lengths,  // (B,)
    T* __restrict__ out,                  // (B, H, D)
    int H, int K, int D, int bs, int mb, int N, float scale, float softcap) {
  const int b = blockIdx.x, kv = blockIdx.y, tid = threadIdx.x;
  const int G = H / K;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kblk = reinterpret_cast<T*>(smem);          // (bs, D)
  T* vblk = kblk + (size_t)bs * D;               // (bs, D)
  float* qs = reinterpret_cast<float*>(vblk + (size_t)bs * D);  // (G, D)
  float* acc = qs + G * D;                       // (G, D)
  float* sc = acc + G * D;                       // (G, bs) scores, then p
  float* m_s = sc + G * bs;                      // (G,)
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
  const int len = lengths[b];
  int nblk = len > 0 ? (len + bs - 1) / bs : 0;
  if (nblk > mb) nblk = mb;
  const size_t row_stride = (size_t)K * D;

  for (int ib = 0; ib < nblk; ++ib) {
    int pb = tables[(size_t)b * mb + ib];
    if (pb < 0 || pb >= N) pb = 0;  // never read outside the pool
    const int nrows = min(bs, len - ib * bs);   // rows below lengths[b]
    const size_t base = ((size_t)pb * bs * K + kv) * D;
    __syncthreads();  // the previous block's rows and scores are consumed
    if constexpr (std::is_same<P, int8_t>::value) {
      const size_t srow = (size_t)pb * bs * K + kv;   // row 0's scale
      stage_rows_i8(kblk, k_pool + base, k_scale + srow, nrows, D, row_stride, K);
      stage_rows_i8(vblk, v_pool + base, v_scale + srow, nrows, D, row_stride, K);
    } else {
      stage_rows(kblk, k_pool + base, nrows, D, row_stride);
      stage_rows(vblk, v_pool + base, nrows, D, row_stride);
    }
    __syncthreads();
    for (int i = tid; i < G * bs; i += blockDim.x) {
      const int g = i / bs, r = i - g * bs;
      float s = NEG_INF;
      if (r < nrows) {
        s = dot_row(qs + g * D, kblk + (size_t)r * D, D, r) * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      sc[i] = s;
    }
    __syncthreads();
    for (int g = tid; g < G; g += blockDim.x)
      corr_s[g] = softmax_update<T>(sc + g * bs, bs, m_s[g], l_s[g]);
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i - g * D;
      const float* p = sc + g * bs;
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

template <typename T, typename P>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* tables, const void* lengths, void* out, int B, int H,
           int K, int D, int bs, int mb, int N, float scale, float softcap, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = 2 * (size_t)bs * D * sizeof(T) +
                      ((size_t)2 * G * D + (size_t)G * bs + 3 * (size_t)G) * sizeof(float);
  auto kernel = paged_decode_kernel<T, P>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B, K), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool), static_cast<const P*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), H, K, D, bs, mb, N, scale, softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_split(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                 const void* v_scale, const void* tables, const void* lengths, void* out,
                 float* scratch, int pool, int B, int H, int K, int bs, int mb, int N,
                 int splits, float scale, float softcap, cudaStream_t s) {
  const auto* tb = static_cast<const int32_t*>(tables);
  if (pool == 1)
    return decode_split::launch_split<D>(
        q,
        decode_split::QuantPagedRows<D>{
            static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool),
            static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), tb, bs, mb,
            N, K},
        lengths, out, scratch, B, H, K, splits, scale, softcap, s);
  return decode_split::launch_split<D>(
      q,
      decode_split::PagedRows<D>{static_cast<const __nv_bfloat16*>(k_pool),
                                 static_cast<const __nv_bfloat16*>(v_pool), tb, bs, mb, N, K},
      lengths, out, scratch, B, H, K, splits, scale, softcap, s);
}

}  // namespace

// dtype: q's (and out's) type, 0 = float32, 1 = bfloat16.  pool: 0 = the
// pools are in q's type (k_scale / v_scale unused), 1 = int8 pools with
// fp32 scales (N, bs, K).  body: 0 the FMA body (any D, G), 1 the split
// body (bf16, D = 64 or 128, G <= 8), which takes `splits` = cdiv(mb * bs,
// 64) and fp32 scratch of B * H * splits * (D + 2) floats: m, then l, then
// acc.  Returns 0 or the CUDA error of a launch.
extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const void* tables, const void* lengths, void* out,
                                      void* scratch, int dtype, int pool, int B, int H, int K,
                                      int D, int bs, int mb, int N, int splits, float scale,
                                      float softcap, int body, void* stream) {
  if (B == 0) return 0;
  if (pool != 0 && pool != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1 || H / K > 8 ||
        (long long)splits * decode_split::SPLIT_KEYS < (long long)mb * bs)
      return (int)cudaErrorInvalidValue;
    float* f = static_cast<float*>(scratch);
    if (D == 64)
      return launch_split<64>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, f,
                              pool, B, H, K, bs, mb, N, splits, scale, softcap, s);
    if (D == 128)
      return launch_split<128>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, f,
                               pool, B, H, K, bs, mb, N, splits, scale, softcap, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1 && pool == 1)
    return launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                                         out, B, H, K, D, bs, mb, N, scale, softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                                 lengths, out, B, H, K, D, bs, mb, N, scale,
                                                 softcap, s);
  if (pool == 1)
    return launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, B,
                                 H, K, D, bs, mb, N, scale, softcap, s);
  return launch<float, float>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, B, H,
                              K, D, bs, mb, N, scale, softcap, s);
}
