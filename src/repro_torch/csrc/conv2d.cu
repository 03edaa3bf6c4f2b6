// SAME 2-D convolution as an implicit GEMM for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/conv2d/kernel.py::conv2d
// (def :43, body _conv_kernel :22, pallas_call :57).  It computes the same
// function: x (B, H, W, Cin) NHWC convolved with w (KH, KW, Cin, Cout) HWIO
// at a stride, SAME padding (total // 2 before, the rest after), plus the
// bias b (Cout,); products summed in fp32, the bias added in fp32, the sum
// rounded once to x's type.  x and w share one type: fp32, fp16 or bf16;
// b is fp32 or x's type.
//
// What bounds it on an H100: arithmetic.  GoogLeNet's convolutions do
// 2 * KH * KW * Cin flops per output element, from 128 (1x1 on 64
// channels) to 3456 (3x3 on 192), far above the card's flops-per-byte
// ridge, so the least time is the flops over the peak of the type:
// 67 TFLOP/s for fp32 on the CUDA cores, 989 TFLOP/s for fp16 / bf16 on
// the tensor cores.  This kernel uses plain FMA on the CUDA cores at every
// type, so at fp16 / bf16 it sits far from that bound: tensor cores
// (mma / wgmma) and TMA staging are the later redesign.
//
// Design (simple and right first).  The GEMM is M = B * Hout * Wout output
// pixels by N = Cout channels, over K = KH * KW * Cin (the HWIO weight is
// already that (K, N) matrix, row-major).  Each 256-thread block owns a
// 64 x 64 output tile and walks K in chunks of 16: it stages the x patch
// (64 pixels x 16 of K) and the w slice (16 x 64) in shared memory as fp32,
// then each thread accumulates a 4 x 4 sub-tile in registers.  M tiles run
// across images, so the 7x7 maps of stage 5 (49 pixels an image) still
// give 7 row tiles at batch 8, where the Pallas grid (B, Cout / bc) would
// give one block per image.
// - Padding: taps that fall outside the map read 0 (masked in the load),
//   so no padded copy of the map is written; the asymmetric SAME split
//   comes in as the top / left offsets.
// - Narrow Cin (stem1: Cin = 3): K is walked flat, each thread decomposes
//   its own k into (tap, channel) and loads one element a row, so a pixel
//   of 12 or 6 bytes is never read with a vector load past its end.
// - Wide Cin (Cin % 16 == 0, every other GoogLeNet conv): a K chunk lies
//   inside one tap, its 16 channels are contiguous, and each row is
//   staged with 16-byte loads (the launcher checks x's alignment).
// - Ragged Cout (13 of GoogLeNet's 57 convs have Cout not a multiple of
//   64, e.g. 24, 208): columns past Cout are masked in the load and store.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output pixels per block (GEMM rows)
constexpr int BN = 64;          // output channels per block (GEMM columns)
constexpr int BK = 16;          // depth of one K chunk
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int AS_LD = BM + 4;   // padded row of the staged x tile (float4-aligned)

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

struct Shape {
  int B, H, W, Cin, KH, KW, Cout, stride, Hout, Wout, pad_top, pad_left;
};

// Whether window tap `tap` (= i * KW + j) contributes to the sum.
__device__ __forceinline__ bool tap_live(int tap, const Shape& s) {
  (void)tap;
  (void)s;
  return true;  // every tap contributes
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS) conv2d_kernel(
    const T* __restrict__ x,          // (B, H, W, Cin)
    const T* __restrict__ w,          // (KH, KW, Cin, Cout) = (K, Cout)
    const void* __restrict__ bias,    // (Cout,), fp32 or T
    int bias_f32,
    T* __restrict__ out,              // (B, Hout, Wout, Cout)
    Shape s) {
  __shared__ __align__(16) float As[BK][AS_LD];   // x patch, k-major
  __shared__ __align__(16) float Bs[BK][BN];      // w slice
  __shared__ long long row_base[BM];              // image offset, -1 past M
  __shared__ int row_ih[BM], row_iw[BM];          // window's top-left input pixel

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = s.B * s.Hout * s.Wout;
  const int K = s.KH * s.KW * s.Cin;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  if (tid < BM) {
    const int m = m0 + tid;
    long long base = -1;
    int ih = 0, iw = 0;
    if (m < M) {
      const int hw = s.Hout * s.Wout;
      const int b = m / hw, r = m - b * hw;
      const int oh = r / s.Wout, ow = r - oh * s.Wout;
      base = (long long)b * s.H * s.W * s.Cin;
      ih = oh * s.stride - s.pad_top;
      iw = ow * s.stride - s.pad_left;
    }
    row_base[tid] = base;
    row_ih[tid] = ih;
    row_iw[tid] = iw;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (WIDE) {
      // The chunk lies inside one tap: channels c0 .. c0 + 15, contiguous.
      constexpr int EPV = 16 / (int)sizeof(T);   // elements per 16-byte vector
      constexpr int VPR = BK / EPV;              // vectors per staged row
      const int tap = k0 / s.Cin, c0 = k0 - tap * s.Cin;
      const int di = tap / s.KW, dj = tap - di * s.KW;
      const bool live = tap_live(tap, s);
      for (int v = tid; v < BM * VPR; v += THREADS) {
        const int r = v / VPR, part = v - r * VPR;
        const int ih = row_ih[r] + di, iw = row_iw[r] + dj;
        const long long base = row_base[r];
        int4 raw = make_int4(0, 0, 0, 0);
        if (live && base >= 0 && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W)
          raw = __ldg(reinterpret_cast<const int4*>(
                          x + base + ((long long)ih * s.W + iw) * s.Cin + c0) + part);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < EPV; ++e) As[part * EPV + e][r] = to_f(vals[e]);
      }
    } else {
      // Any Cin: each thread owns one k of the chunk and loads it for 4 rows.
      const int kl = tid % BK, k = k0 + kl;
      int c = 0, di = 0, dj = 0;
      bool kin = k < K;
      if (kin) {
        const int tap = k / s.Cin;
        c = k - tap * s.Cin;
        di = tap / s.KW;
        dj = tap - di * s.KW;
        kin = tap_live(tap, s);
      }
      for (int r = tid / BK; r < BM; r += THREADS / BK) {
        const int ih = row_ih[r] + di, iw = row_iw[r] + dj;
        const long long base = row_base[r];
        float v = 0.f;
        if (kin && base >= 0 && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W)
          v = to_f(x[base + ((long long)ih * s.W + iw) * s.Cin + c]);
        As[kl][r] = v;
      }
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kb = e / BN, n = e - kb * BN;
      const int k = k0 + kb, gn = n0 + n;
      Bs[kb][n] = (k < K && gn < s.Cout) ? to_f(w[(long long)k * s.Cout + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are consumed before the next chunk is staged
  }

  float bn[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    bn[j] = 0.f;
    if (n < s.Cout)
      bn[j] = bias_f32 ? static_cast<const float*>(bias)[n]
                       : to_f(static_cast<const T*>(bias)[n]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < s.Cout) out[(long long)m * s.Cout + n] = from_f<T>(acc[i][j] + bn[j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, int bias_f32, void* out,
           const Shape& s, int wide, cudaStream_t stream) {
  const int M = s.B * s.Hout * s.Wout;
  const dim3 grid((M + BM - 1) / BM, (s.Cout + BN - 1) / BN);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (wide)
    conv2d_kernel<T, true><<<grid, THREADS, 0, stream>>>(xt, wt, bias, bias_f32, ot, s);
  else
    conv2d_kernel<T, false><<<grid, THREADS, 0, stream>>>(xt, wt, bias, bias_f32, ot, s);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w and out share it);
// bias_f32: 1 if b is float32, 0 if it has x's type.  wide: 1 only when
// Cin % 16 == 0 and x is 16-byte aligned (the launcher decides).
// Returns 0 or the CUDA error of the launch.
extern "C" int conv2d(const void* x, const void* w, const void* bias, void* out, int dtype,
                      int bias_f32, int wide, int B, int H, int W, int Cin, int KH, int KW,
                      int Cout, int stride, void* stream) {
  Shape s;
  s.B = B; s.H = H; s.W = W; s.Cin = Cin; s.KH = KH; s.KW = KW; s.Cout = Cout;
  s.stride = stride;
  s.Hout = (H + stride - 1) / stride;
  s.Wout = (W + stride - 1) / stride;
  const int pad_h = (s.Hout - 1) * stride + KH - H;   // SAME: total // 2 before
  const int pad_w = (s.Wout - 1) * stride + KW - W;
  s.pad_top = pad_h > 0 ? pad_h / 2 : 0;
  s.pad_left = pad_w > 0 ? pad_w / 2 : 0;
  if (B == 0 || Cout == 0 || s.Hout == 0 || s.Wout == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, bias, bias_f32, out, s, wide, st);
  if (dtype == 2) return launch<__half>(x, w, bias, bias_f32, out, s, wide, st);
  return launch<float>(x, w, bias, bias_f32, out, s, wide, st);
}
