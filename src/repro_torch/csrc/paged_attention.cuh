// Shared pieces of the paged attention kernels (paged_decode_attention.cu,
// paged_prefill_attention.cu): element conversion, the online-softmax
// update of one score row, and the staging of one pool block's K or V rows
// into shared memory, as they are or dequantized from an int8 pool.  Plain C++ and CUDA runtime only: the kernels are
// bound to PyTorch through a C interface and ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr int THREADS = 128;        // threads per block, both kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Copy rows [0, nrows) of one kv head of one pool block into `dst`
// (row-major, D elements a row) with 16-byte loads.  `src` points at row 0
// of that head; consecutive rows are `row_stride` elements apart in the
// (N, bs, K, D) pool.  D * sizeof(T) is a multiple of 16 (the wrapper
// checks), so every row starts 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, const T* __restrict__ src,
                                           int nrows, int D, size_t row_stride) {
  const int vec_per_row = D * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < nrows * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = i - r * vec_per_row;
    reinterpret_cast<int4*>(dst + (size_t)r * D)[c] =
        __ldg(reinterpret_cast<const int4*>(src + (size_t)r * row_stride) + c);
  }
}

// Rows [0, nrows) of one kv head of one int8 pool block, dequantized into
// `dst` in q's type T: each value float(int8) times its row's scale in one
// fp32 multiply (no fused add), rounded once to T -- the reference's
// (int8 -> f32 * scale).astype(q.dtype).  `src` points at row 0 of that
// head, consecutive rows `row_stride` bytes apart; `scale` at row 0's
// scale, consecutive rows' scales `scale_stride` floats apart (K in the
// (N, bs, K) scales: they cannot be read 16 bytes at a time).  16-byte
// loads of 16 values; D is a multiple of 16 (the wrapper checks).  Rows
// at or past nrows are neither read nor written, scales included.
template <typename T>
__device__ __forceinline__ void stage_rows_i8(T* __restrict__ dst, const int8_t* __restrict__ src,
                                              const float* __restrict__ scale, int nrows, int D,
                                              size_t row_stride, size_t scale_stride) {
  const int vec_per_row = D / 16;
  for (int i = threadIdx.x; i < nrows * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = i - r * vec_per_row;
    const int4 raw = __ldg(reinterpret_cast<const int4*>(src + (size_t)r * row_stride) + c);
    const float s = __ldg(scale + (size_t)r * scale_stride);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
    T* d = dst + (size_t)r * D + 16 * c;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      d[e] = from_f<T>(__fmul_rn((float)(signed char)(words[e / 4] >> (8 * (e % 4))), s));
  }
}

// Dot product of an fp32 query row with a staged K row.  Each score row of
// a warp reads a different K row; starting the walk at a row-dependent
// offset spreads those reads over the shared-memory banks.
template <typename T>
__device__ __forceinline__ float dot_row(const float* __restrict__ q, const T* __restrict__ k,
                                         int D, int row) {
  int d = (row * (4 / (int)sizeof(T))) % D;
  float s = 0.f;
  for (int j = 0; j < D; ++j) {
    s = fmaf(q[d], to_f(k[d]), s);
    if (++d == D) d = 0;
  }
  return s;
}

// Online-softmax update of one query row over `n` scores (masked entries
// already NEG_INF), exactly as the reference orders it:
//   m_new = max(m, max s);  m_safe = max(m_new, NEG_INF / 2)
//   p = exp(s - m_safe);    corr = exp(min(m - m_new, 0))
//   l = l * corr + sum p;   scores <- p rounded to T, q's type (the PV
//   product takes p in v's dtype, as the Pallas kernel casts it, and v is
//   q's type: a bf16 / fp32 pool shares it, an int8 pool is dequantized
//   to it)
// Returns corr; the caller rescales the accumulator by it.
template <typename T>
__device__ __forceinline__ float softmax_update(float* __restrict__ s, int n,
                                                float& m, float& l) {
  float mx = NEG_INF;
  for (int j = 0; j < n; ++j) mx = fmaxf(mx, s[j]);
  const float m_new = fmaxf(m, mx);
  const float m_safe = fmaxf(m_new, NEG_INF / 2);
  float sum = 0.f;
  for (int j = 0; j < n; ++j) {
    const float p = expf(s[j] - m_safe);
    sum += p;
    s[j] = to_f(from_f<T>(p));
  }
  const float corr = expf(fminf(m - m_new, 0.f));
  l = l * corr + sum;
  m = m_new;
  return corr;
}

}  // namespace paged
