// Paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::paged_decode_attention
// (def :163, body _paged_kernel :108, pallas_call :216).  It computes the
// same function: one query token per sequence against the paged KV pool,
// read through the sequence's block table; GQA with G = H / K query heads
// per kv head (query head h reads kv head h / G); scale 1/sqrt(D), optional
// softcap * tanh(s / softcap); online softmax over the pool blocks; rows at
// or past lengths[b] never read; fully masked rows give 0.
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
//    with 16-byte loads; scores, running max / sum and accumulator fp32.
//    At 4 sequences and 2 kv heads that is 8 blocks on 132 SMs.
// 2. Split over the KV length, then a merge (bf16, D = 64 or 128, G <= 8).
//    Two launches from one call, on one stream:
//    - split pass, grid (B, K, NS): each block takes SPLIT_KEYS = 64 keys
//      (64 / bs pool blocks) of one (sequence, kv head) and writes a
//      partial (m, l, acc[G, D]) in fp32.  NS = cdiv(mb * bs, 64) comes
//      from the table width on the host, never from lengths (reading them
//      would sync the stream every decode step): at serving's B = 4, K = 2,
//      mb = 66 that is 136 blocks.  A split starting past lengths[b]
//      writes m = NEG_INF, l = 0, acc = 0 and reads nothing.  All 64 K and
//      V rows are fetched at once with cp.async (32 KB in flight at D =
//      128), rows at or past the length zero-filled (an unwritten pool row
//      may hold NaN; 0 x NaN is NaN).  The G query heads fill the n = 8
//      side of m16n8k16 when the keys take the m side: S^T = K Q^T (a warp
//      per 16 keys, Q^T as B fragments in registers, zeros for heads past
//      G), the max and sum per head over the 64 keys (quad shuffles, then
//      the four warps through shared memory), p = exp(s - m_safe) rounded
//      to bf16 against the split's own max, and O^T = V^T P^T (V^T through
//      ldmatrix.trans, P^T through shared memory; a warp per D / 4 dims).
//    - merge pass, one block per (sequence, query head): the log-sum-exp
//      merge of the reference's merge_lse over the NS partials, M = max m_i,
//      out = sum acc_i e^(m_i - M) / max(sum l_i e^(m_i - M), 1e-30), the
//      exponent clipped at 0 as there; a length-0 sequence gives 0.
#include "mma_attention.cuh"

namespace {

using namespace paged;

template <typename T>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q,              // (B, H, D)
    const T* __restrict__ k_pool,         // (N, bs, K, D)
    const T* __restrict__ v_pool,         // (N, bs, K, D)
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
    stage_rows(kblk, k_pool + base, nrows, D, row_stride);
    stage_rows(vblk, v_pool + base, nrows, D, row_stride);
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

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* lengths, void* out, int B, int H, int K, int D, int bs, int mb,
           int N, float scale, float softcap, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = 2 * (size_t)bs * D * sizeof(T) +
                      ((size_t)2 * G * D + (size_t)G * bs + 3 * (size_t)G) * sizeof(float);
  auto kernel = paged_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B, K), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), H, K, D, bs, mb, N, scale, softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Body 2: split over the KV length on the tensor cores, then the merge
// ---------------------------------------------------------------------------

using mma_attn::MMA_THREADS;
using mma_attn::swz;
constexpr int SPLIT_KEYS = mma_attn::KV_ROWS;   // keys of one split
constexpr int PT_STRIDE = SPLIT_KEYS + 8;       // P^T row in shared memory, padded
                                                // so the B-fragment reads miss no bank

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, H, D)
    const __nv_bfloat16* __restrict__ k_pool,  // (N, bs, K, D)
    const __nv_bfloat16* __restrict__ v_pool,  // (N, bs, K, D)
    const int32_t* __restrict__ tables,        // (B, mb)
    const int32_t* __restrict__ lengths,       // (B,)
    float* __restrict__ part_m,                // (B, H, NS)
    float* __restrict__ part_l,                // (B, H, NS)
    float* __restrict__ part_acc,              // (B, H, NS, D)
    int H, int K, int bs, int mb, int N, int ns, float scale, float softcap) {
  constexpr int KC = D / 16;   // k16 steps of S^T = K Q^T
  constexpr int MT = D / 64;   // m16 tiles of O^T (16 dims each) a warp owns
  __shared__ __align__(16) __nv_bfloat16 ks[SPLIT_KEYS * D];
  __shared__ __align__(16) __nv_bfloat16 vs[SPLIT_KEYS * D];
  __shared__ __align__(16) __nv_bfloat16 pt[8 * PT_STRIDE];   // P^T: (head, key)
  __shared__ float red_m[4][8], red_l[4][8];                  // (warp, head)

  const int b = blockIdx.x, kv = blockIdx.y, split = blockIdx.z, G = H / K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, cq = lane % 4;
  const int base = split * SPLIT_KEYS;
  const int len = min(lengths[b], mb * bs);
  const int nrows = min(SPLIT_KEYS, len - base);   // live keys of this split
  const size_t part = ((size_t)b * H + (size_t)kv * G) * ns + split;   // head kv*G's entry
  if (nrows <= 0) {   // past the length: an empty partial, nothing read
    for (int g = threadIdx.x; g < G; g += MMA_THREADS) {
      part_m[part + (size_t)g * ns] = NEG_INF;
      part_l[part + (size_t)g * ns] = 0.f;
    }
    for (int i = threadIdx.x; i < G * D; i += MMA_THREADS)
      part_acc[(part + (size_t)(i / D) * ns) * D + i % D] = 0.f;
    return;
  }
  mma_attn::stage_paged<D>(ks, vs, k_pool, v_pool, tables + (size_t)b * mb, base, len, bs, K,
                           kv, N);
  asm volatile("cp.async.commit_group;" ::: "memory");

  // Q^T as B fragments: column n is query head kv*G + n, zeros for n >= G
  uint32_t qb[KC][2];
  const __nv_bfloat16* qrow = gq < G ? q + ((size_t)b * H + (size_t)kv * G + gq) * D : nullptr;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qb[kc][0] = qrow ? mma_attn::ld32(qrow + 16 * kc + 2 * cq) : 0u;
    qb[kc][1] = qrow ? mma_attn::ld32(qrow + 16 * kc + 2 * cq + 8) : 0u;
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // S^T = K Q^T: this warp's 16 keys x 8 heads; s[e] is key 16 warp + gq
  // (+ 8 for e >= 2) of head 2 cq + (e & 1)
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4];
    mma_attn::ldsm_x4(a, ks + swz<D>(16 * warp + (lane & 15), 2 * kc + (lane >> 4)));
    mma_attn::mma16816(s, a, qb[kc][0], qb[kc][1]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = 16 * warp + gq + (e >> 1) * 8;   // within the split
    float x = s[e] * scale;
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    if (key >= nrows) x = NEG_INF;
    s[e] = x;
  }
  // the max of each head over the split's 64 keys: the eight threads of a
  // column (shuffles over gq), then the four warps
  float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
  for (int off = 4; off <= 16; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  if (gq == 0) {
    red_m[warp][2 * cq] = mx0;
    red_m[warp][2 * cq + 1] = mx1;
  }
  __syncthreads();
  mx0 = fmaxf(fmaxf(red_m[0][2 * cq], red_m[1][2 * cq]), fmaxf(red_m[2][2 * cq], red_m[3][2 * cq]));
  mx1 = fmaxf(fmaxf(red_m[0][2 * cq + 1], red_m[1][2 * cq + 1]),
              fmaxf(red_m[2][2 * cq + 1], red_m[3][2 * cq + 1]));
  const float ms0 = fmaxf(mx0, NEG_INF / 2), ms1 = fmaxf(mx1, NEG_INF / 2);
  float p[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) p[e] = __expf(s[e] - (e & 1 ? ms1 : ms0));
  float sum0 = p[0] + p[2], sum1 = p[1] + p[3];
#pragma unroll
  for (int off = 4; off <= 16; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
  }
  if (gq == 0) {
    red_l[warp][2 * cq] = sum0;
    red_l[warp][2 * cq + 1] = sum1;
  }
  // p rounded to bf16 (the PV product takes p in v's type, as the Pallas
  // kernel casts it), stored transposed: pt[head][key]
#pragma unroll
  for (int e = 0; e < 4; ++e)
    pt[(2 * cq + (e & 1)) * PT_STRIDE + 16 * warp + gq + (e >> 1) * 8] = __float2bfloat16_rn(p[e]);
  __syncthreads();

  // O^T = V^T P^T: this warp's D / 4 dims x 8 heads over the 64 keys
  float o[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < SPLIT_KEYS / 16; ++kk) {
    const uint32_t b0 = mma_attn::ld32(pt + gq * PT_STRIDE + 16 * kk + 2 * cq);
    const uint32_t b1 = mma_attn::ld32(pt + gq * PT_STRIDE + 16 * kk + 2 * cq + 8);
    const int key = 16 * kk + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];   // V^T rows (dims) 16 dt .., keys 16 kk .. through ldmatrix.trans
      const int dt = warp * MT + mt;
      mma_attn::ldsm_x4_trans(a, vs + swz<D>(key, 2 * dt + ((lane >> 3) & 1)));
      mma_attn::mma16816(o[mt], a, b0, b1);
    }
  }
  // the partial: o[mt][e] is dim 16 dt + gq (+ 8 for e >= 2) of head 2 cq + (e & 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = 2 * cq + (e & 1);
      if (h < G)
        part_acc[(part + (size_t)h * ns) * D + 16 * (warp * MT + mt) + gq + (e >> 1) * 8] =
            o[mt][e];
    }
  }
  if (warp == 0 && gq == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int h = 2 * cq + e;
      if (h < G) {
        part_m[part + (size_t)h * ns] = e ? mx1 : mx0;
        part_l[part + (size_t)h * ns] = red_l[0][h] + red_l[1][h] + red_l[2][h] + red_l[3][h];
      }
    }
  }
}

// One block per (sequence, query head), a thread per output dim.
__global__ void paged_decode_merge_kernel(const float* __restrict__ part_m,
                                          const float* __restrict__ part_l,
                                          const float* __restrict__ part_acc,
                                          __nv_bfloat16* __restrict__ out, int D, int ns) {
  const size_t bh = blockIdx.x;
  const float* m = part_m + bh * ns;
  const float* l = part_l + bh * ns;
  const float* acc = part_acc + bh * ns * D;
  float M = NEG_INF;
  for (int i = 0; i < ns; ++i) M = fmaxf(M, m[i]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int i = 0; i < ns; ++i) {
      const float w = expf(fminf(m[i] - M, 0.f));
      num = fmaf(acc[(size_t)i * D + d], w, num);
      den = fmaf(l[i], w, den);
    }
    out[bh * D + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-30f));
  }
}

template <int D>
int launch_split(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                 const void* lengths, void* out, float* scratch, int B, int H, int K, int bs,
                 int mb, int N, int ns, float scale, float softcap, cudaStream_t stream) {
  const size_t parts = (size_t)B * H * ns;
  float* part_m = scratch;
  float* part_l = part_m + parts;
  float* part_acc = part_l + parts;
  paged_decode_split_kernel<D><<<dim3(B, K, ns), MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), part_m, part_l, part_acc, H, K, bs, mb, N, ns,
      scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge_kernel<<<B * H, D, 0, stream>>>(part_m, part_l, part_acc,
                                                     static_cast<__nv_bfloat16*>(out), D, ns);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).  body: 0
// the FMA body (any D, G), 1 the split body (bf16, D = 64 or 128, G <= 8),
// which takes `splits` = cdiv(mb * bs, 64) and fp32 scratch of B * H *
// splits * (D + 2) floats: m, then l, then acc.  Returns 0 or the CUDA
// error of a launch.
extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* lengths, void* out,
                                      void* scratch, int dtype, int B, int H, int K, int D,
                                      int bs, int mb, int N, int splits, float scale,
                                      float softcap, int body, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1 || H / K > 8 || (long long)splits * SPLIT_KEYS < (long long)mb * bs)
      return (int)cudaErrorInvalidValue;
    float* f = static_cast<float*>(scratch);
    if (D == 64)
      return launch_split<64>(q, k_pool, v_pool, tables, lengths, out, f, B, H, K, bs, mb, N,
                              splits, scale, softcap, s);
    if (D == 128)
      return launch_split<128>(q, k_pool, v_pool, tables, lengths, out, f, B, H, K, bs, mb, N,
                               splits, scale, softcap, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B, H, K, D, bs, mb,
                                 N, scale, softcap, s);
  return launch<float>(q, k_pool, v_pool, tables, lengths, out, B, H, K, D, bs, mb, N, scale,
                       softcap, s);
}
