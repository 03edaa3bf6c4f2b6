// General matrix product out = x @ y for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/matmul/kernel.py::matmul
// (def :36, body _matmul_kernel :20, pallas_call :46).  It computes the
// same function as its oracle (src/repro/kernels/matmul/ref.py:8-11):
// x (M, K) times y (K, N), products summed in fp32, the sum rounded once
// to x's type.  x and y share one type: fp32, fp16 or bf16.  Unlike the
// Pallas kernel, which asserts that its 512-wide tiles divide the shape,
// this one takes any M, N and K (edges are masked), and each operand comes
// as a pointer and two strides, so a transposed view (w.T, x.T in the
// backward products, the tied LM head's tok.T) is read in place, never
// copied.  The output is written row-major, contiguous.
//
// What bounds it on an H100: for the products of training and prefill
// (M of 512 or more rows against d_model 2048, d_ff 11008, vocab 151936)
// arithmetic -- 2 M N K flops far above the flops-per-byte ridge -- so the
// least time is the flops over the peak of the type (67 TFLOP/s fp32 on
// the CUDA cores, 989 TFLOP/s bf16 / fp16 on the tensor cores).  For
// decode (M of a few rows) the bytes of y: the weight is read once.  This
// kernel does plain fp32 FMA on the CUDA cores at every type, so at bf16
// it sits far from the tensor-core bound: mma / wgmma with TMA staging
// is the later redesign.
//
// Design (simple and right first).  One block per BM x BN output tile
// walks K in slices of BK = 32, staging the x slice (BM x 32) and the y
// slice (32 x BN) in shared memory as fp32; each thread owns a TM x TN
// sub-tile in registers.  The next slice's loads are issued into
// registers before the current slice is multiplied, so global latency
// overlaps the FMAs.
// - Strides: the loader maps consecutive threads along whichever dim of
//   the operand has unit stride, so either layout loads coalesced.
// - Summation order: each slice's 32 products are summed into a fresh
//   fp32 partial, in ascending k, and the partial is added to the
//   accumulator -- the structure of the Pallas kernel's
//   acc += dot(x_tile, y_tile) over K tiles, and a shorter chain of
//   roundings (~sqrt(32) + sqrt(K / 32) instead of sqrt(K) steps) than one
//   running sum.  The order depends only on k, never on the tile shape,
//   so the two tile shapes below give bit-identical results.
// - Two tile shapes: WIDE 128 x 128 (256 threads, 8 x 8 each) for M > 16,
//   NARROW 16 x 32 (128 threads, 2 x 2 each) for the few rows of a decode
//   step, where a 128-row tile would leave 7/8 of its threads idle and a
//   32-column tile gives 4x more blocks to stream the weight.
// - Masked edges: rows, columns and k past the shape load 0 (a product
//   of 0 adds nothing) and are not stored.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;          // depth of one K slice

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Reads n consecutive floats of shared memory into registers, 16 bytes at
// a time where n allows it.
template <int N>
__device__ __forceinline__ void read_row(float (&r)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x; r[i + 1] = v.y; r[i + 2] = v.z; r[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) matmul_kernel(
    const T* __restrict__ x, int sxm, int sxk,      // (M, K) by strides
    const T* __restrict__ y, int syk, int syn,      // (K, N) by strides
    T* __restrict__ out,                            // (M, N) row-major
    int M, int N, int K) {
  constexpr int TX = BN / TN;                       // threads along N
  constexpr int THREADS = (BM / TM) * TX;
  constexpr int A_PER = BM * BK / THREADS;          // x elements staged per thread
  constexpr int B_PER = BK * BN / THREADS;          // y elements staged per thread
  static_assert(A_PER * THREADS == BM * BK && B_PER * THREADS == BK * BN, "tile");
  __shared__ __align__(16) float As[BK][BM + 4];    // x slice, k-major
  __shared__ __align__(16) float Bs[BK][BN + 4];    // y slice

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool x_k_unit = sxk == 1;                   // loader follows the unit stride
  const bool y_n_unit = syn == 1;

  float ra[A_PER], rb[B_PER];                       // the next slice, in flight
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * THREADS;
      const int r = x_k_unit ? idx / BK : idx % BM;
      const int c = x_k_unit ? idx % BK : idx / BM;
      const int m = m0 + r, k = k0 + c;
      ra[i] = (m < M && k < K) ? to_f(x[(long long)m * sxm + (long long)k * sxk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS;
      const int r = y_n_unit ? idx / BN : idx % BK;
      const int c = y_n_unit ? idx % BN : idx / BK;
      const int k = k0 + r, n = n0 + c;
      rb[i] = (k < K && n < N) ? to_f(y[(long long)k * syk + (long long)n * syn]) : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * THREADS;
      if (x_k_unit) As[idx % BK][idx / BK] = ra[i];
      else As[idx / BM][idx % BM] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS;
      if (y_n_unit) Bs[idx / BN][idx % BN] = rb[i];
      else Bs[idx % BK][idx / BK] = rb[i];
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      read_row(a, &As[kk][ty * TM]);
      read_row(b, &Bs[kk][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) out[(long long)m * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN>
cudaError_t launch(const void* x, const void* y, void* out, int M, int N, int K,
                   int sxm, int sxk, int syk, int syn, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T, BM, BN, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(x), sxm, sxk, static_cast<const T*>(y), syk, syn,
      static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tile(int narrow, const void* x, const void* y, void* out, int M,
                          int N, int K, int sxm, int sxk, int syk, int syn,
                          cudaStream_t stream) {
  if (narrow) return launch<T, 16, 32, 2, 2>(x, y, out, M, N, K, sxm, sxk, syk, syn, stream);
  return launch<T, 128, 128, 8, 8>(x, y, out, M, N, K, sxm, sxk, syk, syn, stream);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16 (x, y and out alike).  narrow: 1 for the
// 16 x 32 tile, 0 for the 128 x 128 one.  Strides in elements.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int matmul(const void* x, const void* y, void* out, int dtype, int M, int N,
                      int K, int sxm, int sxk, int syk, int syn, int narrow,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_tile<float>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s);
    case 1:
      return dispatch_tile<__nv_bfloat16>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s);
    case 2: return dispatch_tile<__half>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s);
    default: return cudaErrorInvalidValue;
  }
}
