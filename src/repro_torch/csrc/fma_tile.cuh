// fp32 products of small tiles in shared memory on the CUDA cores, for the
// backward kernels (flash_attention_backward.cu, ssm_scan_backward.cu),
// whose gradients are held to fp32 sums.  Plain C++ and CUDA runtime only.
//
// A block of 256 threads is a 16 x 16 grid (ty = tid / 16, tx = tid % 16);
// a thread owns the outputs (ty + 16 i, tx + 16 j) of a (16 TM) x (16 TN)
// tile, accumulated in registers.  Each step over the inner dimension
// loads TM values of A and TN of B from shared memory for TM x TN
// multiply-adds.  Tiles are stored row-major with an odd row stride (the
// width plus one), so that every access pattern of `mm` -- a row or a
// column of A, a row or a column of B -- spreads a warp's reads over the
// banks or broadcasts them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fma_tile {

constexpr int THREADS = 256;   // 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int ty() { return threadIdx.x / 16; }
__device__ __forceinline__ int tx() { return threadIdx.x % 16; }

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < K} A(ty + 16 i, k) B(k, tx + 16 j), with
// A(r, k) = a[r * a_rs + k * a_cs] and B(k, c) = b[k * b_rs + c * b_cs].
template <int TM, int TN>
__device__ __forceinline__ void mm(float (&acc)[TM][TN], const float* __restrict__ a,
                                   int a_rs, int a_cs, const float* __restrict__ b, int b_rs,
                                   int b_cs, int K) {
  const float* ap = a + ty() * a_rs;
  const float* bp = b + tx() * b_cs;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = ap[16 * i * a_rs + k * a_cs];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = bp[k * b_rs + 16 * j * b_cs];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Rows [0, n) of a tensor whose row r starts at src + r * stride (w values
// each, as fp32) into dst (rows x ld); rows n .. rows-1 and columns w ..
// ld-1 are zeroed, so products over a padded tile add nothing.
template <typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst, const T* __restrict__ src,
                                      size_t stride, int n, int w, int rows, int ld) {
  for (int i = threadIdx.x; i < rows * ld; i += THREADS) {
    const int r = i / ld, c = i - r * ld;
    dst[i] = r < n && c < w ? to_f(src[(size_t)r * stride + c]) : 0.f;
  }
}

// The sum of v over the 16 threads of this thread's row (the same ty; a
// warp holds two rows), in a fixed order: every one of them gets it.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace fma_tile
