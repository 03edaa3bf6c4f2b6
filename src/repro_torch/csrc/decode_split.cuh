// Split-KV decode attention on the tensor cores, shared by the paged
// decode kernel (paged_decode_attention.cu, K1: rows through a block
// table, from a bf16 pool or dequantized from an int8 one) and the dense
// one (decode_attention.cu, K3: a contiguous cache).  They differ only in
// their row loader; on a cache read as a pool through a trivial table K1
// and K3 give the same bits.
//
// Two launches from one call, on one stream (bf16, D = 64 or 128, G <= 8):
// - split pass, grid (B, K, NS): each block takes SPLIT_KEYS = 64 keys of
//   one (sequence, kv head) and writes a partial (m, l, acc[G, D]) in fp32.
//   NS = cdiv(rows, 64) comes from the table width or the cache length on
//   the host, never from lengths (reading them would sync the stream every
//   decode step).  A split starting past the length writes m = NEG_INF,
//   l = 0, acc = 0 and reads nothing.  All 64 K and V rows are fetched at
//   once, with cp.async from a bf16 pool or cache (32 KB in flight at D =
//   128), through registers from an int8 pool (16 KB and the scales), rows
//   at or past the length zero-filled (a row past the length may hold NaN,
//   an int8 row's scale too; 0 x NaN is NaN).  The G query heads fill the n = 8 side of m16n8k16 when the keys
//   take the m side: S^T = K Q^T (a warp per 16 keys, Q^T as B fragments
//   in registers, zeros for heads past G), the max and sum per head over
//   the 64 keys (quad shuffles, then the four warps through shared
//   memory), p = exp(s - m_safe) rounded to bf16 against the split's own
//   max, and O^T = V^T P^T (V^T through ldmatrix.trans, P^T through shared
//   memory; a warp per D / 4 dims).
// - merge pass, one block per (sequence, query head): the log-sum-exp
//   merge of the reference's merge_lse over the NS partials, M = max m_i,
//   out = sum acc_i e^(m_i - M) / max(sum l_i e^(m_i - M), 1e-30), the
//   exponent clipped at 0 as there; a length-0 sequence gives 0.  K3 may
//   ask for M and the merged denominator too (its row log-sum-exp).
#pragma once

#include "mma_attention.cuh"

namespace decode_split {

using mma_attn::MMA_THREADS;
using mma_attn::swz;
using paged::NEG_INF;
constexpr int SPLIT_KEYS = mma_attn::KV_ROWS;   // keys of one split
constexpr int PT_STRIDE = SPLIT_KEYS + 8;       // P^T row in shared memory, padded
                                                // so the B-fragment reads miss no bank

// K1's rows: key j of sequence b at pool row (table[j / bs] * bs + j % bs).
template <int D>
struct PagedRows {
  const __nv_bfloat16* k_pool;   // (N, bs, K, D)
  const __nv_bfloat16* v_pool;   // (N, bs, K, D)
  const int32_t* tables;         // (B, mb)
  int bs, mb, N, K;

  __device__ __forceinline__ int length(const int32_t* lengths, int b) const {
    return min(lengths[b], mb * bs);
  }
  __device__ __forceinline__ void stage(__nv_bfloat16* ks, __nv_bfloat16* vs, int b, int kv,
                                        int base, int len) const {
    mma_attn::stage_paged<D>(ks, vs, k_pool, v_pool, tables + (size_t)b * mb, base, len, bs, K,
                             kv, N);
  }
};

// K1's rows from an int8 pool, dequantized to bf16 as they are staged
// (mma_attn::stage_paged_i8, K2's loader too): the tiles stay bf16, so
// shared memory is the bf16 loader's, 33.4 KB static at D = 128.
template <int D>
struct QuantPagedRows {
  const int8_t* k_pool;   // (N, bs, K, D)
  const int8_t* v_pool;   // (N, bs, K, D)
  const float* k_scale;   // (N, bs, K)
  const float* v_scale;   // (N, bs, K)
  const int32_t* tables;  // (B, mb)
  int bs, mb, N, K;

  __device__ __forceinline__ int length(const int32_t* lengths, int b) const {
    return min(lengths[b], mb * bs);
  }
  __device__ __forceinline__ void stage(__nv_bfloat16* ks, __nv_bfloat16* vs, int b, int kv,
                                        int base, int len) const {
    mma_attn::stage_paged_i8<D>(ks, vs, k_pool, v_pool, k_scale, v_scale,
                                tables + (size_t)b * mb, base, len, bs, K, kv, N);
  }
};

// K3's rows: key j of sequence b at row j of its (S, K, D) cache.
template <int D>
struct DenseRows {
  const __nv_bfloat16* k;   // (B, S, K, D)
  const __nv_bfloat16* v;   // (B, S, K, D)
  int S, K;

  __device__ __forceinline__ int length(const int32_t* lengths, int b) const {
    return min(lengths[b], S);
  }
  __device__ __forceinline__ void stage(__nv_bfloat16* ks, __nv_bfloat16* vs, int b, int kv,
                                        int base, int len) const {
    mma_attn::stage_dense<D>(ks, vs, k, v, b, S, base, len, K, kv);
  }
};

template <int D, typename Rows>
__global__ void __launch_bounds__(MMA_THREADS) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, H, D)
    Rows rows,                                 // where key j of a sequence lies
    const int32_t* __restrict__ lengths,       // (B,)
    float* __restrict__ part_m,                // (B, H, NS)
    float* __restrict__ part_l,                // (B, H, NS)
    float* __restrict__ part_acc,              // (B, H, NS, D)
    int H, int K, int ns, float scale, float softcap) {
  constexpr int KC = D / 16;   // k16 steps of S^T = K Q^T
  constexpr int MT = D / 64;   // m16 tiles of O^T (16 dims each) a warp owns
  __shared__ __align__(16) __nv_bfloat16 ks[SPLIT_KEYS * D];
  __shared__ __align__(16) __nv_bfloat16 vs[SPLIT_KEYS * D];
  __shared__ __align__(16) __nv_bfloat16 pt[8 * PT_STRIDE];   // P^T: (head, key)
  __shared__ float red_m[4][8], red_l[4][8];                  // (warp, head)

  const int b = blockIdx.x, kv = blockIdx.y, split = blockIdx.z, G = H / K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, cq = lane % 4;
  const int base = split * SPLIT_KEYS;
  const int len = rows.length(lengths, b);
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
  rows.stage(ks, vs, b, kv, base, len);
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

// One block per (sequence, query head), a thread per output dim.  With
// m_out / l_out (K3's row log-sum-exp, (B, H) fp32 each) it also writes
// the merged M and denominator: the reference's chunked_attention
// residuals m and l, M = NEG_INF and l = 0 where no row is live.
static __global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                           const float* __restrict__ part_l,
                                           const float* __restrict__ part_acc,
                                           __nv_bfloat16* __restrict__ out,
                                           float* __restrict__ m_out,
                                           float* __restrict__ l_out, int D, int ns) {
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
    // den is the same in every thread: the one at d == 0 writes it
    if (m_out != nullptr && d == 0) {
      m_out[bh] = M;
      l_out[bh] = den;
    }
  }
}

// The split pass, then the merge, on `stream`.  `scratch` holds B * H * ns
// * (D + 2) floats: m, then l, then acc.  m_out / l_out: (B, H) fp32 for
// the row log-sum-exp, or null.  Returns 0 or the CUDA error of a launch.
template <int D, typename Rows>
int launch_split(const void* q, Rows rows, const void* lengths, void* out, float* scratch, int B,
                 int H, int K, int ns, float scale, float softcap, cudaStream_t stream,
                 float* m_out = nullptr, float* l_out = nullptr) {
  const size_t parts = (size_t)B * H * ns;
  float* part_m = scratch;
  float* part_l = part_m + parts;
  float* part_acc = part_l + parts;
  decode_split_kernel<D, Rows><<<dim3(B, K, ns), MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), rows, static_cast<const int32_t*>(lengths), part_m,
      part_l, part_acc, H, K, ns, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<<<B * H, D, 0, stream>>>(part_m, part_l, part_acc,
                                               static_cast<__nv_bfloat16*>(out), m_out, l_out,
                                               D, ns);
  return (int)cudaGetLastError();
}

}  // namespace decode_split
