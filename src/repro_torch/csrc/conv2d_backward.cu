// Backward of the SAME 2-D convolution for Hopper (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel: the TPU kernel whose forward it
// differentiates,
//   src/repro/kernels/conv2d/kernel.py::conv2d (:43),
// has no backward (no custom_vjp in the JAX package); the reference
// trains GoogLeNet through lax.conv_general_dilated
// (repro/models/layers/conv.py:30), and XLA differentiates that.  This
// kernel gives the port's K6 forward (conv2d.cu) its gradient, so that
// training runs every convolution through hand-written kernels both ways.
//
// The forward is out = conv(x, w) + b: x (B, H, W, Cin) NHWC, w (KH, KW,
// Cin, Cout) HWIO, SAME padding at a stride s (pt = total // 2 before, the
// rest after; stem1, 7x7 at stride 2 on 224, pads 2 before and 3 after).
// Given dy (B, Hout, Wout, Cout) it computes
//   dgrad  dx[b, h, w, ci] = sum_{i, j, co} dy[b, oh, ow, co] w[i, j, ci, co]
//          over the taps with oh = (h + pt - i) / s and ow = (w + pl - j) / s
//          exact (a parity test at s = 2) and inside the output map: an
//          implicit GEMM of M = B H W input pixels, N = Cin, K = KH KW Cout;
//   wgrad  dw[i, j, ci, co] = sum_{b, oh, ow} x[b, oh s + i - pt, ow s + j - pl, ci]
//          dy[b, oh, ow, co] (x read as 0 in the padding): a GEMM of M = KH KW
//          Cin (the HWIO rows of dw), N = Cout, over K = B Hout Wout pixels;
//   db     db[co] = sum_{b, oh, ow} dy[b, oh, ow, co], the column sums of the
//          dy tiles wgrad stages anyway (blocks of the first M tile add them).
// Every sum in fp32; dx and dw rounded once to x's and w's type (fp32,
// fp16 or bf16), db to b's (fp32 or x's).
//
// What bounds it on an H100: arithmetic.  Each of dgrad and wgrad does the
// forward's 2 B Hout Wout KH KW Cin Cout flops, so GoogLeNet's batch-8
// backward does about twice its forward's, far above the card's
// flops-per-byte ridge.  This first body runs them as fp32 FMA on the
// CUDA cores (no TF32: the reference sums in fp32), so the 67 TFLOP/s fp32
// rate bounds it; tensor cores and a cp.async ring are later work.
//
// One body, "fma", for both passes: a block owns a 64 x 64 output tile; its
// 256 threads (a 16 x 16 grid, fma_tile.cuh) each keep a 4 x 4 register
// tile.  Each 32-deep K chunk is gathered from device memory into registers
// (the next chunk's loads in flight while the current one computes),
// converted to fp32 and stored k-major into shared memory with an odd row
// stride, then multiplied by fma_tile::mm.  A thread gathers 8 consecutive
// elements along the operand's contiguous axis (co for dgrad's dy and w,
// ci for wgrad's x, co for wgrad's dy), so a warp's loads are coalesced;
// out-of-range taps, padding, pixels past the map and channels past Cout
// read as zero.  dy enters dgrad at the tap of its output pixel: no padded
// or zero-inserted copy of any operand is written.
//
// Split-K: where the output tiles are fewer than the card's SMs (stage 5's
// 7x7 maps; wgrad's short M and N against a K of up to 100,352 pixels at
// batch 8), the host cuts the K chunks into `splits` slices
// (kernels/conv2d/ops.py::conv_splits), blockIdx.z a slice.  Each slice
// writes its fp32 partial tile (and wgrad's db partial) to scratch, and a
// further launch of the same call sums the partials in slice order and
// rounds once: the same bits from run to run, no float atomics.
#include "fma_tile.cuh"

namespace {

using fma_tile::from_f;
using fma_tile::mm;
using fma_tile::to_f;
using fma_tile::tx;
using fma_tile::ty;

constexpr int BM = 64, BN = 64;   // output tile
constexpr int BK = 32;            // K depth of one chunk
constexpr int LDS = BM + 1;       // row stride of the k-major tiles (BM == BN)
constexpr int THREADS = fma_tile::THREADS;
constexpr int PER = BM * BK / THREADS;   // elements a thread gathers of each operand: 8

struct Geo {
  int B, H, W, Cin, KH, KW, Cout, stride, Hout, Wout, pt, pl;
};

// The K chunks [kc0, kc1) of this block's slice: slice z takes chunks
// z * nk / splits up to (z + 1) * nk / splits of nk = cdiv(K, BK).
__device__ __forceinline__ int2 slice_of(int K, int splits) {
  const int nk = (K + BK - 1) / BK, z = blockIdx.z;
  return make_int2(z * nk / splits, (z + 1) * nk / splits);
}

// A block's 64 x 64 fp32 tile: rounded into `out` (no split) or written as
// slice z's partial into part (splits, M, N).
template <typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[4][4], T* __restrict__ out,
                                           float* __restrict__ part, int M, int N, int m0,
                                           int n0, int splits) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty() + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx() + 16 * j;
      if (n >= N) continue;
      if (splits == 1)
        out[(size_t)m * N + n] = from_f<T>(acc[i][j]);
      else
        part[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// dgrad: dx (M = B H W, N = Cin) = sum over K = (tap, co) of dy at the tap's
// output pixel times w[tap, ci, co]
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) conv_dgrad_kernel(
    const T* __restrict__ dy,     // (B, Hout, Wout, Cout)
    const T* __restrict__ w,      // (KH, KW, Cin, Cout)
    T* __restrict__ dx,           // (B, H, W, Cin)
    float* __restrict__ part,     // (splits, M, Cin) fp32, when splits > 1
    Geo g, int splits) {
  __shared__ float as[BK * LDS], bs[BK * LDS];   // A(m, k) at as[k * LDS + m]; B(k, n) likewise
  __shared__ int4 rows[BM];       // a tile row's pixel: (image or -1, h + pt, w + pl)
  const int M = g.B * g.H * g.W, N = g.Cin, K = g.KH * g.KW * g.Cout;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int m = m0 + r;
    int4 v = make_int4(-1, 0, 0, 0);
    if (m < M) {
      const int hw = g.H * g.W, b = m / hw, rem = m - b * hw, h = rem / g.W;
      v = make_int4(b, h + g.pt, rem - h * g.W + g.pl, 0);
    }
    rows[r] = v;
  }
  __syncthreads();

  // this thread gathers k = kq * 8 .. + 7 of the chunk for A's row ar and
  // B's column ar (both contiguous in co)
  const int kq = threadIdx.x % 4, ar = threadIdx.x / 4;
  const int4 row = rows[ar];
  const int n = n0 + ar;
  float ra[PER], rb[PER];
  auto gather = [&](int kc) {
    const int k = kc * BK + kq * PER;
    int tap = k / g.Cout, co = k - tap * g.Cout;
    int i = tap / g.KW, j = tap - i * g.KW;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      float av = 0.f, bv = 0.f;
      if (i < g.KH) {   // k + e < K
        const int nh = row.y - i, nw = row.z - j;
        if (row.x >= 0 && nh >= 0 && nw >= 0) {
          const int oh = nh / g.stride, ow = nw / g.stride;
          if (oh * g.stride == nh && ow * g.stride == nw && oh < g.Hout && ow < g.Wout)
            av = to_f(dy[(((size_t)row.x * g.Hout + oh) * g.Wout + ow) * g.Cout + co]);
        }
        if (n < N) bv = to_f(w[((size_t)tap * g.Cin + n) * g.Cout + co]);
      }
      ra[e] = av;
      rb[e] = bv;
      if (++co == g.Cout) {
        co = 0;
        ++tap;
        if (++j == g.KW) {
          j = 0;
          ++i;
        }
      }
    }
  };

  const int2 sl = slice_of(K, splits);
  float acc[4][4];
  fma_tile::zero(acc);
  if (sl.x < sl.y) gather(sl.x);
  for (int kc = sl.x; kc < sl.y; ++kc) {
    __syncthreads();   // the last chunk's tiles are consumed
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      as[(kq * PER + e) * LDS + ar] = ra[e];
      bs[(kq * PER + e) * LDS + ar] = rb[e];
    }
    __syncthreads();
    if (kc + 1 < sl.y) gather(kc + 1);
    mm(acc, as, 1, LDS, bs, LDS, 1, BK);
  }
  store_tile(acc, dx, part, M, N, m0, n0, splits);
}

// ---------------------------------------------------------------------------
// wgrad: dw (M = KH KW Cin, N = Cout) = sum over K = B Hout Wout pixels of
// x at the pixel's tap times dy; db from the same dy tiles
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) conv_wgrad_kernel(
    const T* __restrict__ x,      // (B, H, W, Cin)
    const T* __restrict__ dy,     // (B, Hout, Wout, Cout)
    T* __restrict__ dw,           // (KH, KW, Cin, Cout) = (M, N)
    void* __restrict__ db,        // (Cout,), fp32 or T
    int bias_f32,
    float* __restrict__ part,     // (splits, M, N) then (splits, N) of db, when splits > 1
    Geo g, int splits) {
  __shared__ float as[BK * LDS], bs[BK * LDS];
  __shared__ int4 rows[BM];       // a tile row's tap: (i - pt, j - pl, ci, live)
  const int M = g.KH * g.KW * g.Cin, N = g.Cout, K = g.B * g.Hout * g.Wout;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int m = m0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (m < M) {
      const int tap = m / g.Cin, i = tap / g.KW;
      v = make_int4(i - g.pt, tap - i * g.KW - g.pl, m - tap * g.Cin, 1);
    }
    rows[r] = v;
  }
  __syncthreads();

  // this thread gathers, for pixel kk of the chunk, A's rows q * 8 .. + 7
  // (contiguous in ci) and B's columns q * 8 .. + 7 (contiguous in co)
  const int q = threadIdx.x % 8, kk = threadIdx.x / 8;
  float ra[PER], rb[PER];
  auto gather = [&](int kc) {
    const int p = kc * BK + kk;
    const bool live = p < K;
    int ih0 = 0, iw0 = 0;
    size_t xb = 0;
    if (live) {
      const int hw = g.Hout * g.Wout, b = p / hw, rem = p - b * hw, oh = rem / g.Wout;
      ih0 = oh * g.stride;
      iw0 = (rem - oh * g.Wout) * g.stride;
      xb = (size_t)b * g.H * g.W * g.Cin;
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int4 r = rows[q * PER + e];
      const int ih = ih0 + r.x, iw = iw0 + r.y, nn = n0 + q * PER + e;
      ra[e] = live && r.w && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W
                  ? to_f(x[xb + ((size_t)ih * g.W + iw) * g.Cin + r.z])
                  : 0.f;
      rb[e] = live && nn < N ? to_f(dy[(size_t)p * N + nn]) : 0.f;
    }
  };

  const bool with_db = blockIdx.x == 0;   // one row of blocks sums db
  const int2 sl = slice_of(K, splits);     // this block's pixels
  float acc[4][4], dbacc = 0.f;
  fma_tile::zero(acc);
  if (sl.x < sl.y) gather(sl.x);
  for (int kc = sl.x; kc < sl.y; ++kc) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      as[kk * LDS + q * PER + e] = ra[e];
      bs[kk * LDS + q * PER + e] = rb[e];
    }
    __syncthreads();
    if (kc + 1 < sl.y) gather(kc + 1);
    if (with_db && threadIdx.x < BN)   // pixels in order within the chunk
      for (int k = 0; k < BK; ++k) dbacc += bs[k * LDS + threadIdx.x];
    mm(acc, as, 1, LDS, bs, LDS, 1, BK);
  }
  store_tile(acc, dw, part, M, N, m0, n0, splits);
  const int n = n0 + threadIdx.x;
  if (with_db && threadIdx.x < BN && n < N) {
    if (splits > 1)
      part[(size_t)splits * M * N + (size_t)blockIdx.z * N + n] = dbacc;
    else if (bias_f32)
      static_cast<float*>(db)[n] = dbacc;
    else
      static_cast<T*>(db)[n] = from_f<T>(dbacc);
  }
}

// ---------------------------------------------------------------------------
// Split-K reduction: the partials summed in slice order, one rounding
// ---------------------------------------------------------------------------

template <typename O>
__global__ void __launch_bounds__(256) conv_bwd_reduce_kernel(const float* __restrict__ part,
                                                              int splits, long long n,
                                                              O* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += part[(size_t)z * n + i];
    out[i] = from_f<O>(sum);
  }
}

template <typename O>
int reduce(const float* part, int splits, long long n, void* out, cudaStream_t stream) {
  const long long need = (n + 255) / 256;
  const int blocks = (int)(need < 4096 ? need : 4096);
  conv_bwd_reduce_kernel<O><<<blocks, 256, 0, stream>>>(part, splits, n, static_cast<O*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* dy, void* dx, void* dw, void* db,
           float* dx_part, float* dw_part, int bias_f32, int dx_splits, int dw_splits,
           const Geo& g, cudaStream_t stream) {
  if (dx != nullptr) {
    const int M = g.B * g.H * g.W, N = g.Cin;
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, dx_splits);
    conv_dgrad_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<T*>(dx), dx_part, g,
        dx_splits);
    int err = (int)cudaGetLastError();
    if (err) return err;
    if (dx_splits > 1 && (err = reduce<T>(dx_part, dx_splits, (long long)M * N, dx, stream)))
      return err;
  }
  const int M = g.KH * g.KW * g.Cin, N = g.Cout;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, dw_splits);
  conv_wgrad_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dw), db, bias_f32,
      dw_part, g, dw_splits);
  int err = (int)cudaGetLastError();
  if (err || dw_splits == 1) return err;
  if ((err = reduce<T>(dw_part, dw_splits, (long long)M * N, dw, stream))) return err;
  const float* db_part = dw_part + (size_t)dw_splits * M * N;
  return bias_f32 ? reduce<float>(db_part, dw_splits, N, db, stream)
                  : reduce<T>(db_part, dw_splits, N, db, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w, dy, dx and dw share
// it); bias_f32: 1 if db is float32, 0 if it has x's type.  dx null: no
// dgrad (the caller's x needs no gradient; dx_splits and dx_part are not
// read).  dx_splits / dw_splits: slices of dgrad's / wgrad's K (1: no
// split); past 1, dx_part holds dx_splits * B H W * Cin floats, dw_part
// dw_splits * (KH KW Cin + 1) * Cout.  The
// launcher decides all of these.  Returns 0 or the CUDA error of a launch.
extern "C" int conv2d_backward(const void* x, const void* w, const void* dy, void* dx,
                               void* dw, void* db, void* dx_part, void* dw_part, int dtype,
                               int bias_f32, int dx_splits, int dw_splits, int B, int H,
                               int W, int Cin, int KH, int KW, int Cout, int stride,
                               void* stream) {
  Geo g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.KH = KH; g.KW = KW; g.Cout = Cout;
  g.stride = stride;
  g.Hout = (H + stride - 1) / stride;
  g.Wout = (W + stride - 1) / stride;
  const int pad_h = (g.Hout - 1) * stride + KH - H;   // SAME: total // 2 before
  const int pad_w = (g.Wout - 1) * stride + KW - W;
  g.pt = pad_h > 0 ? pad_h / 2 : 0;
  g.pl = pad_w > 0 ? pad_w / 2 : 0;
  if (B == 0 || H == 0 || W == 0 || Cin == 0 || Cout == 0) return 0;
  if (stride < 1 || dx_splits < 1 || dw_splits < 1 || (dx && dx_splits > 1 && !dx_part) ||
      (dw_splits > 1 && !dw_part))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dxp = static_cast<float*>(dx_part);
  float* dwp = static_cast<float*>(dw_part);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, dy, dx, dw, db, dxp, dwp, bias_f32, dx_splits,
                                 dw_splits, g, st);
  if (dtype == 2)
    return launch<__half>(x, w, dy, dx, dw, db, dxp, dwp, bias_f32, dx_splits, dw_splits, g,
                          st);
  return launch<float>(x, w, dy, dx, dw, db, dxp, dwp, bias_f32, dx_splits, dw_splits, g, st);
}
