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
// flops-per-byte ridge: 67 TFLOP/s bounds fp32 (no TF32: the reference
// sums in fp32), 989 TFLOP/s fp16 / bf16 on the tensor cores.
//
// Three bodies a pass; the caller (kernels/conv2d/ops.py::backward_body_for)
// picks them before the launch from the type, Cin, Cout, alignment and
// stride, and kernels/conv2d/ops.py::backward_tile the ring bodies' tile.
// - The ring bodies, "fma" (fp32 on the CUDA cores: 256 threads, 32-deep
//   chunks, 8 x 4 or 4 x 4 outputs a thread) and "mma" (fp16 / bf16 on
//   mma.sync m16n8k16 with fp32 accumulators: four warps of 2 x 2, 64-deep
//   chunks, the fragment helpers and swizzle of mma_attention.cuh), on
//   128 x 64 tiles where those still give every SM a tile, else 64 x 64.
//   They take the forward's loader (conv2d.cu): each K chunk of both
//   operands is staged with 16-byte cp.async pieces into a ring of three
//   stages, chunks i + 1 and i + 2 in flight while chunk i computes; a
//   piece lies inside one tap where the contiguous channel count is a
//   multiple of the piece, so a thread finds its tap or pixel once a
//   chunk; padding and ragged edges fill with zeros through src-size 0.
//   They need Cout a multiple of the piece (4 fp32, 8 16-bit values).
//   * dgrad at stride 1 is a SAME conv of dy by the flipped, transposed
//     weight, with the before and after pads swapped: A = dy at the tap's
//     output pixel, contiguous in co; B = w[KH-1-i, KW-1-j, ci, co] as a
//     (k = (tap, co), n = ci) operand, contiguous along k (ldmatrix
//     without .trans, where the forward's weight takes .trans).
//   * wgrad: A = x at (pixel, tap), contiguous in ci (in pieces where Cin
//     is a multiple of the piece, else gathered element by element:
//     stem1's Cin = 3), B = dy rows, contiguous in co; both k-strided
//     (ldmatrix.trans).  db sums the staged dy tiles.
// - The gather bodies, "dgrad_gather" (every stride; the one dgrad at a
//   stride, parity test per tap) and "wgrad_gather" (a Cout the pieces do
//   not fit): a block owns a 64 x 64 output tile; its 256 threads (a 16 x
//   16 grid, fma_tile.cuh) each keep a 4 x 4 register tile.  Each 32-deep
//   K chunk is gathered from device memory into registers (the next
//   chunk's loads in flight while the current one computes), converted to
//   fp32 and stored k-major into shared memory with an odd row stride, then
//   multiplied by fma_tile::mm.  A thread gathers 8 consecutive elements
//   along the operand's contiguous axis (co for dgrad's dy and w, ci for
//   wgrad's x, co for wgrad's dy), so a warp's loads are coalesced;
//   out-of-range taps, padding, pixels past the map and channels past Cout
//   read as zero.  dy enters dgrad at the tap of its output pixel: no
//   padded or zero-inserted copy of any operand is written.
//
// Split-K: where the output tiles are fewer than the card's SMs (stage 5's
// 7x7 maps; wgrad's short M and N against a K of up to 100,352 pixels at
// batch 8), the host cuts the K chunks into `splits` slices
// (kernels/conv2d/ops.py::conv_splits, by the body's tile and chunk),
// blockIdx.z a slice.  Each slice writes its fp32 partial tile (and
// wgrad's db partial) to scratch, and a further launch of the same call
// sums the partials in slice order and rounds once: the same bits from run
// to run, no float atomics.
#include <type_traits>

#include "fma_tile.cuh"
#include "mma_attention.cuh"

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
// The ring bodies: dgrad at stride 1 as a SAME conv of dy by the flipped,
// transposed weight, and wgrad, each K chunk of both operands staged in
// 16-byte cp.async pieces into a ring of STAGES buffers
// ---------------------------------------------------------------------------

using mma_attn::cp_async16;
using mma_attn::ldsm_x4;
using mma_attn::ldsm_x4_trans;
using mma_attn::swz;

constexpr int STAGES = 3;     // chunks i + 1, i + 2 in flight while chunk i computes
constexpr int RING_BN = 64;   // output columns of a block

// fp32 on the CUDA cores ("fma": 256 threads, a 16 x 16 grid, 32-deep
// chunks) or fp16 / bf16 on the tensor cores ("mma": four warps of 2 x 2,
// 64-deep chunks); both read 128-byte rows of K.  BM = 64 or 128 rows.
template <typename T, int BM, bool MMA>
struct Ring {
  static constexpr int THREADS = MMA ? 128 : 256;
  static constexpr int BK = MMA ? 64 : 32;
  static constexpr int EPV = 16 / (int)sizeof(T);   // elements of a piece
  // dgrad, both operands k-contiguous: A (BM, LDK), B (RING_BN, LDK); the
  // FMA rows padded by a piece (a warp's float4 reads of 16 rows then
  // fall in distinct banks), the mma rows swizzled
  static constexpr int LDK = MMA ? BK : BK + EPV;
  static constexpr int NT_STAGE = (BM + RING_BN) * LDK;
  // wgrad, both operands k-strided: A (BK, BM), B (BK, RING_BN)
  static constexpr int TN_STAGE = BK * (BM + RING_BN);
  static constexpr size_t smem(bool tn) {
    return (size_t)STAGES * (tn ? TN_STAGE : NT_STAGE) * sizeof(T) + (size_t)BM * sizeof(int4);
  }
  // where piece c (EPV elements) of row r lies in a staged tile of rows of
  // `len` elements
  template <int len>
  __device__ static __forceinline__ int at(int r, int c) {
    if constexpr (MMA) return swz<len>(r, c);
    else return r * len + c * EPV;
  }
};

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The K chunks [x, y) of this block's slice, chunks of depth bk
__device__ __forceinline__ int2 chunks_of(int K, int bk, int splits) {
  const int nk = (K + bk - 1) / bk, z = blockIdx.z;
  return make_int2(z * nk / splits, (z + 1) * nk / splits);
}

template <typename T>
__device__ __forceinline__ void mma_t(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) mma_attn::mma16816_f16(d, a, b0, b1);
  else mma_attn::mma16816(d, a, b0, b1);
}

// dgrad's tile row: dx pixel m's image (-1 past M) and the top-left dy
// pixel of its flipped window.  At stride 1, dx[h] = sum_i dy[h + pt - i]
// w[i]; with i' = KH - 1 - i that is dy[h - (KH - 1 - pt) + i'] times
// w[KH - 1 - i']: a SAME conv whose before and after pads are swapped.
__device__ __forceinline__ void fill_drows(int4* rows, int m0, int bm, const Geo& g) {
  for (int r = threadIdx.x; r < bm; r += blockDim.x) {
    const int m = m0 + r;
    int4 v = make_int4(-1, 0, 0, 0);
    if (m < g.B * g.H * g.W) {
      const int hw = g.H * g.W, b = m / hw, rem = m - b * hw, h = rem / g.W;
      v = make_int4(b, h - (g.KH - 1 - g.pt), rem - h * g.W - (g.KW - 1 - g.pl), 0);
    }
    rows[r] = v;
  }
}

// wgrad's tile row: dw row m = (tap, ci) as (i - pt, j - pl, ci, live)
__device__ __forceinline__ void fill_wrows(int4* rows, int m0, int bm, const Geo& g) {
  for (int r = threadIdx.x; r < bm; r += blockDim.x) {
    const int m = m0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (m < g.KH * g.KW * g.Cin) {
      const int tap = m / g.Cin, i = tap / g.KW;
      v = make_int4(i - g.pt, tap - i * g.KW - g.pl, m - tap * g.Cin, 1);
    }
    rows[r] = v;
  }
}

// Stage dgrad's K chunk kc: A (BM dx pixels x BK of K = (flipped tap, co))
// from dy, and B (RING_BN input channels x BK) from w[KH KW - 1 - tap, ci,
// co], both contiguous along k.  A piece lies inside one tap (Cout is a
// multiple of the piece), so a thread finds its tap once a chunk; taps
// outside the map, pixels past M and k past K fill with zeros.
template <typename T, int BM, bool MMA>
__device__ __forceinline__ void dgrad_load(T* as, T* bs, const T* __restrict__ dy,
                                           const T* __restrict__ w, const int4* rows, int kc,
                                           int n0, const Geo& g) {
  using R = Ring<T, BM, MMA>;
  constexpr int KPR = R::BK / R::EPV, RPP = R::THREADS / KPR;   // pieces a row, rows a pass
  const int pc = threadIdx.x % KPR, pr = threadIdx.x / KPR;
  const int k = kc * R::BK + pc * R::EPV;
  const bool kl = k < g.KH * g.KW * g.Cout;
  const int tap = kl ? k / g.Cout : 0, co = k - tap * g.Cout;
  const int di = tap / g.KW, dj = tap - di * g.KW;
  const size_t wat = (size_t)(g.KH * g.KW - 1 - tap) * g.Cin * g.Cout + co;
#pragma unroll
  for (int r = pr; r < BM; r += RPP) {
    const int4 row = rows[r];
    const int oh = row.y + di, ow = row.z + dj;
    const bool live = kl && row.x >= 0 && oh >= 0 && oh < g.Hout && ow >= 0 && ow < g.Wout;
    const T* src = dy + (live ? (((size_t)row.x * g.Hout + oh) * g.Wout + ow) * g.Cout + co : 0);
    cp_async16(as + R::template at<R::LDK>(r, pc), src, live ? 16 : 0);
  }
#pragma unroll
  for (int r = pr; r < RING_BN; r += RPP) {
    const bool live = kl && n0 + r < g.Cin;
    cp_async16(bs + R::template at<R::LDK>(r, pc), w + (live ? wat + (size_t)(n0 + r) * g.Cout : 0),
               live ? 16 : 0);
  }
}

// Stage wgrad's K chunk kc: A (BK pixels x BM dw rows) from x at each
// pixel's tap, contiguous along m = (tap, ci) -- in pieces where Cin is a
// multiple of the piece and x aligned (x_vec), else element by element --
// and B (BK pixels x RING_BN channels) from dy's rows.  A thread takes one
// pixel of the chunk, found once a chunk.  Taps in the SAME padding and
// pixels past the map fill with zeros.
template <typename T, int BM, bool MMA>
__device__ __forceinline__ void wgrad_load(T* as, T* bs, const T* __restrict__ x,
                                           const T* __restrict__ dy, const int4* rows, int kc,
                                           int n0, const Geo& g, bool x_vec) {
  using R = Ring<T, BM, MMA>;
  constexpr int EPV = R::EPV, TPR = R::THREADS / R::BK;   // threads a pixel
  const int P = g.B * g.Hout * g.Wout;
  const int kr = threadIdx.x / TPR, tq = threadIdx.x % TPR, p = kc * R::BK + kr;
  const bool pl = p < P;
  int ih0 = 0, iw0 = 0;
  size_t xb = 0;
  if (pl) {
    const int hw = g.Hout * g.Wout, b = p / hw, rem = p - b * hw, oh = rem / g.Wout;
    ih0 = oh * g.stride;
    iw0 = (rem - oh * g.Wout) * g.stride;
    xb = (size_t)b * g.H * g.W * g.Cin;
  }
  if (x_vec) {
#pragma unroll
    for (int mp = tq; mp < BM / EPV; mp += TPR) {
      const int4 r = rows[mp * EPV];
      const int ih = ih0 + r.x, iw = iw0 + r.y;
      const bool live = pl && r.w && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      cp_async16(as + R::template at<BM>(kr, mp),
                 x + (live ? xb + ((size_t)ih * g.W + iw) * g.Cin + r.z : 0), live ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int m = tq; m < BM; m += TPR) {
      const int4 r = rows[m];
      const int ih = ih0 + r.x, iw = iw0 + r.y;
      const bool live = pl && r.w && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      as[R::template at<BM>(kr, m / EPV) + m % EPV] =
          live ? x[xb + ((size_t)ih * g.W + iw) * g.Cin + r.z] : from_f<T>(0.f);
    }
  }
  constexpr int NPR = RING_BN / EPV;
#pragma unroll
  for (int i = threadIdx.x; i < R::BK * NPR; i += R::THREADS) {
    const int k = i / NPR, np = i - k * NPR, pp = kc * R::BK + k, n = n0 + np * EPV;
    const bool live = pp < P && n < g.Cout;
    cp_async16(bs + R::template at<RING_BN>(k, np), dy + (live ? (size_t)pp * g.Cout + n : 0),
               live ? 16 : 0);
  }
}

// One fp32 chunk of dgrad on the CUDA cores: rows ty + 16 i by columns tx +
// 16 j, both operands read as float4 along k, summed in k order.
template <int BM>
__device__ __forceinline__ void fma_nt_chunk(float (&acc)[BM / 16][4][1], const float* as,
                                             const float* bs) {
  constexpr int LD = Ring<float, BM, false>::LDK, TM = BM / 16;
#pragma unroll
  for (int kk = 0; kk < Ring<float, BM, false>::BK; kk += 4) {
    float4 a[TM], b[4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(as + (ty() + 16 * i) * LD + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(bs + (tx() + 16 * j) * LD + kk);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float c = acc[i][j][0];
        c = fmaf(a[i].x, b[j].x, c);
        c = fmaf(a[i].y, b[j].y, c);
        c = fmaf(a[i].z, b[j].z, c);
        acc[i][j][0] = fmaf(a[i].w, b[j].w, c);
      }
  }
}

// One fp32 chunk of wgrad on the CUDA cores: rows ty TM .. ty TM + TM - 1 by
// columns 4 tx .. 4 tx + 3, both operands read as float4 along m and n.
template <int BM>
__device__ __forceinline__ void fma_tn_chunk(float (&acc)[BM / 16][4][1], const float* as,
                                             const float* bs) {
  constexpr int TM = BM / 16;
#pragma unroll 4
  for (int k = 0; k < Ring<float, BM, false>::BK; ++k) {
    float a[TM];
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(as + k * BM + ty() * TM + i);
      a[i] = t.x;
      a[i + 1] = t.y;
      a[i + 2] = t.z;
      a[i + 3] = t.w;
    }
    const float4 t = *reinterpret_cast<const float4*>(bs + k * RING_BN + tx() * 4);
    const float b[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][0] = fmaf(a[i], b[j], acc[i][j][0]);
  }
}

// One 16-bit chunk on the tensor cores: this warp's (BM / 2) x 32 outputs
// over the chunk's four k16 steps.  dgrad (NT): A and B rows k-contiguous,
// read with ldmatrix; wgrad (TN): both k-strided, read with ldmatrix.trans.
template <typename T, int BM, bool TN>
__device__ __forceinline__ void mma_chunk(float (&acc)[BM / 32][4][4], const T* as, const T* bs,
                                          int warp_m, int warp_n, int lane) {
  constexpr int MI = BM / 32, BK = Ring<T, BM, true>::BK;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t af[MI][4], bf[2][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int mb = warp_m * (BM / 2) + mi * 16;
      if constexpr (TN)
        ldsm_x4_trans(af[mi], as + swz<BM>(16 * ks + (lane >> 4) * 8 + (lane & 7),
                                           mb / 8 + ((lane >> 3) & 1)));
      else
        ldsm_x4(af[mi], as + swz<BK>(mb + (lane & 15), 2 * ks + (lane >> 4)));
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {   // B of n8 blocks 2 nj and 2 nj + 1
      const int nb = warp_n * 32 + nj * 16;
      if constexpr (TN)
        ldsm_x4_trans(bf[nj], bs + swz<RING_BN>(16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7),
                                                nb / 8 + (lane >> 4)));
      else
        ldsm_x4(bf[nj], bs + swz<BK>(nb + (lane >> 4) * 8 + (lane & 7),
                                     2 * ks + ((lane >> 3) & 1)));
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_t<T>(acc[mi][ni], af[mi], bf[ni / 2][(ni & 1) * 2], bf[ni / 2][(ni & 1) * 2 + 1]);
  }
}

// dgrad (WGRAD false: dx, M = B H W, N = Cin, K = KH KW Cout) or wgrad
// (dw, M = KH KW Cin, N = Cout, K = B Hout Wout; db from the staged dy
// tiles) on a ring body.  Each output rounded once into `out` (no split),
// or slice z's fp32 partial written into part (splits, M, N).
template <typename T, int BM, bool MMA, bool WGRAD>
__global__ void __launch_bounds__(Ring<T, BM, MMA>::THREADS) conv_bwd_ring_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
    T* __restrict__ out, void* __restrict__ db, int bias_f32, float* __restrict__ part, Geo g,
    int splits, int x_vec) {
  using R = Ring<T, BM, MMA>;
  constexpr int STAGE = WGRAD ? R::TN_STAGE : R::NT_STAGE;
  constexpr int B_AT = WGRAD ? R::BK * BM : BM * R::LDK;   // B's offset in a stage
  extern __shared__ __align__(128) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  int4* rows = reinterpret_cast<int4*>(smem + (size_t)STAGES * STAGE * sizeof(T));
  const int M = WGRAD ? g.KH * g.KW * g.Cin : g.B * g.H * g.W;
  const int N = WGRAD ? g.Cout : g.Cin;
  const int K = WGRAD ? g.B * g.Hout * g.Wout : g.KH * g.KW * g.Cout;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * RING_BN;
  if constexpr (WGRAD) fill_wrows(rows, m0, BM, g);
  else fill_drows(rows, m0, BM, g);
  __syncthreads();
  const int2 sl = chunks_of(K, R::BK, splits);
  const int kc0 = sl.x, nks = sl.y - sl.x;
  auto load = [&](int i) {   // chunk kc0 + i into its stage
    T* as = tiles + (i % STAGES) * STAGE;
    if constexpr (WGRAD)
      wgrad_load<T, BM, MMA>(as, as + B_AT, x, dy, rows, kc0 + i, n0, g, x_vec);
    else
      dgrad_load<T, BM, MMA>(as, as + B_AT, dy, w, rows, kc0 + i, n0, g);
  };

  constexpr int TM = MMA ? BM / 32 : BM / 16;
  float acc[TM][4][MMA ? 4 : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < (MMA ? 4 : 1); ++e) acc[i][j][e] = 0.f;
  const bool with_db = WGRAD && blockIdx.x == 0;   // one row of blocks sums db
  float dbacc = 0.f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nks) load(st);
    commit();
  }
  for (int i = 0; i < nks; ++i) {
    wait_group<STAGES - 2>();   // chunk i has landed
    __syncthreads();            // ... for every thread; chunk i - 1's buffer is free
    if (i + STAGES - 1 < nks) load(i + STAGES - 1);
    commit();
    const T* as = tiles + (i % STAGES) * STAGE;
    const T* bs = as + B_AT;
    if (with_db && threadIdx.x < RING_BN)   // pixels in order within the chunk
      for (int k = 0; k < R::BK; ++k)
        dbacc += to_f(bs[R::template at<RING_BN>(k, threadIdx.x / R::EPV) + threadIdx.x % R::EPV]);
    if constexpr (MMA) mma_chunk<T, BM, WGRAD>(acc, as, bs, warp / 2, warp % 2, lane);
    else if constexpr (WGRAD) fma_tn_chunk<BM>(acc, as, bs);
    else fma_nt_chunk<BM>(acc, as, bs);
  }
  wait_group<0>();

  auto put = [&](int m, int n, float v) {
    if (m >= M || n >= N) return;
    if (splits == 1) out[(size_t)m * N + n] = from_f<T>(v);
    else part[((size_t)blockIdx.z * M + m) * N + n] = v;
  };
  if constexpr (MMA) {
    const int wm = warp / 2, wn = warp % 2, g4 = lane / 4, cq = lane % 4;
#pragma unroll
    for (int mi = 0; mi < TM; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put(m0 + wm * (BM / 2) + mi * 16 + g4 + 8 * (e >> 1),
              n0 + wn * 32 + ni * 8 + 2 * cq + (e & 1), acc[mi][ni][e]);
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        put(WGRAD ? m0 + ty() * TM + i : m0 + ty() + 16 * i,
            WGRAD ? n0 + tx() * 4 + j : n0 + tx() + 16 * j, acc[i][j][0]);
  }
  const int n = n0 + threadIdx.x;
  if (with_db && threadIdx.x < RING_BN && n < N) {
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

// One pass on a ring body, then its split-K reduction where K is split
template <typename T, int BM, bool MMA, bool WGRAD>
int launch_ring(const void* x, const void* w, const void* dy, void* out, void* db, int bias_f32,
                float* part, const Geo& g, int splits, int x_vec, cudaStream_t stream) {
  constexpr size_t smem = Ring<T, BM, MMA>::smem(WGRAD);
  auto kernel = conv_bwd_ring_kernel<T, BM, MMA, WGRAD>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  const int M = WGRAD ? g.KH * g.KW * g.Cin : g.B * g.H * g.W, N = WGRAD ? g.Cout : g.Cin;
  const dim3 grid((M + BM - 1) / BM, (N + RING_BN - 1) / RING_BN, splits);
  kernel<<<grid, Ring<T, BM, MMA>::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(out), db, bias_f32, part, g, splits, x_vec);
  if ((err = (int)cudaGetLastError()) || splits == 1) return err;
  if ((err = reduce<T>(part, splits, (long long)M * N, out, stream)) || !WGRAD) return err;
  const float* db_part = part + (size_t)splits * M * N;
  return bias_f32 ? reduce<float>(db_part, splits, N, db, stream)
                  : reduce<T>(db_part, splits, N, db, stream);
}

// A pass on the ring body `body` (1 fp32 "fma", 2 16-bit "mma") at bm = 64
// or 128 rows a tile
template <typename T, bool WGRAD>
int launch_pass(int body, int bm, const void* x, const void* w, const void* dy, void* out,
                void* db, int bias_f32, float* part, const Geo& g, int splits, int x_vec,
                cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if (body != (f32 ? 1 : 2) || (bm != 64 && bm != 128)) return (int)cudaErrorInvalidValue;
  return bm == 128
             ? launch_ring<T, 128, !f32, WGRAD>(x, w, dy, out, db, bias_f32, part, g, splits,
                                                x_vec, stream)
             : launch_ring<T, 64, !f32, WGRAD>(x, w, dy, out, db, bias_f32, part, g, splits,
                                               x_vec, stream);
}

template <typename T>
int launch(const void* x, const void* w, const void* dy, void* dx, void* dw, void* db,
           float* dx_part, float* dw_part, int bias_f32, const int (&body)[2],
           const int (&bm)[2], int dx_splits, int dw_splits, int x_vec, const Geo& g,
           cudaStream_t stream) {
  int err;
  if (dx != nullptr && body[0]) {
    if ((err = launch_pass<T, false>(body[0], bm[0], x, w, dy, dx, nullptr, 0, dx_part, g,
                                     dx_splits, 0, stream)))
      return err;
  } else if (dx != nullptr) {
    const int M = g.B * g.H * g.W, N = g.Cin;
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, dx_splits);
    conv_dgrad_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<T*>(dx), dx_part, g,
        dx_splits);
    if ((err = (int)cudaGetLastError())) return err;
    if (dx_splits > 1 && (err = reduce<T>(dx_part, dx_splits, (long long)M * N, dx, stream)))
      return err;
  }
  if (body[1])
    return launch_pass<T, true>(body[1], bm[1], x, w, dy, dw, db, bias_f32, dw_part, g,
                                dw_splits, x_vec, stream);
  const int M = g.KH * g.KW * g.Cin, N = g.Cout;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, dw_splits);
  conv_wgrad_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dw), db, bias_f32,
      dw_part, g, dw_splits);
  if ((err = (int)cudaGetLastError()) || dw_splits == 1) return err;
  if ((err = reduce<T>(dw_part, dw_splits, (long long)M * N, dw, stream))) return err;
  const float* db_part = dw_part + (size_t)dw_splits * M * N;
  return bias_f32 ? reduce<float>(db_part, dw_splits, N, db, stream)
                  : reduce<T>(db_part, dw_splits, N, db, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w, dy, dx and dw share
// it); bias_f32: 1 if db is float32, 0 if it has x's type.  dx null: no
// dgrad (the caller's x needs no gradient; dx_body, dx_bm, dx_splits and
// dx_part are not read).  dx_body / dw_body: 0 the gather body (64 x 64
// tiles), 1 the fp32 ring body "fma", 2 the 16-bit ring body "mma"; a ring
// body needs Cout a multiple of the piece (4 fp32, 8 16-bit values) with
// dy 16-byte aligned, and dgrad's also stride 1 and w aligned.  dx_bm /
// dw_bm: rows of a ring body's tile, 64 or 128.  x_vec: wgrad's ring body
// reads x in 16-byte pieces (Cin a multiple of the piece, x aligned), else
// element by element.  dx_splits / dw_splits: slices of dgrad's / wgrad's
// K chunks (1: no split); past 1, dx_part holds dx_splits * B H W * Cin
// floats, dw_part dw_splits * (KH KW Cin + 1) * Cout.  The launcher
// decides all of these.  Returns 0 or the CUDA error of a launch.
extern "C" int conv2d_backward(const void* x, const void* w, const void* dy, void* dx,
                               void* dw, void* db, void* dx_part, void* dw_part, int dtype,
                               int bias_f32, int dx_body, int dw_body, int dx_bm, int dw_bm,
                               int dx_splits, int dw_splits, int x_vec, int B, int H, int W,
                               int Cin, int KH, int KW, int Cout, int stride, void* stream) {
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
  const int epv = dtype == 0 ? 4 : 8;
  if ((dx && dx_body && (stride != 1 || Cout % epv)) || (dw_body && Cout % epv) ||
      (dw_body && x_vec && Cin % epv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dxp = static_cast<float*>(dx_part);
  float* dwp = static_cast<float*>(dw_part);
  const int body[2] = {dx_body, dw_body}, bm[2] = {dx_bm, dw_bm};
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, dy, dx, dw, db, dxp, dwp, bias_f32, body, bm, dx_splits,
                                 dw_splits, x_vec, g, st);
  if (dtype == 2)
    return launch<__half>(x, w, dy, dx, dw, db, dxp, dwp, bias_f32, body, bm, dx_splits,
                          dw_splits, x_vec, g, st);
  return launch<float>(x, w, dy, dx, dw, db, dxp, dwp, bias_f32, body, bm, dx_splits,
                       dw_splits, x_vec, g, st);
}
