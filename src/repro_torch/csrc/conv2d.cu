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
// the tensor cores.  In practice most of GoogLeNet's convolutions are
// small (stages 4 and 5: 14x14 and 7x7 maps, M = 1568 or 392 pixels at
// batch 8), so what bounds them is how many blocks are in flight and how
// long each waits for its loads.
//
// The GEMM is M = B * Hout * Wout output pixels by N = Cout channels, over
// K = KH * KW * Cin (the HWIO weight is already that (K, N) matrix,
// row-major).  M tiles run across images.
//
// One loader, two bodies; the caller (kernels/conv2d/ops.py::body_for)
// picks the body before the launch from the type, Cin, Cout and alignment.
// - The loader stages each K chunk of the x patch (the tile's pixels x the
//   chunk's K) and of the w slice (the chunk's K x the tile's channels)
//   into a ring of STAGES buffers with 16-byte cp.async copies, so chunks
//   i + 1 .. i + STAGES - 1 are in flight while chunk i computes, behind
//   one barrier a chunk.  Each 16-byte piece finds its own address: with
//   Cin a multiple of the piece's elements, a piece lies inside one tap,
//   and a chunk may span taps.  Taps in the SAME padding, pixels past M
//   and K or channels past Cout fill with zeros through cp.async's
//   src-size 0: no padded copy of the map is written.  Where Cin (or Cout)
//   is not a multiple of the piece (stem1's Cin = 3), or the operand is
//   not 16-byte aligned, that operand is gathered element by element
//   (K past the end read as zeros up to the chunk's depth).
// - "mma" (fp16 / bf16 with Cout a multiple of 8 and w 16-byte aligned;
//   x in 16-byte pieces where Cin is a multiple of 8 and x is aligned,
//   else gathered, as stem1's 3-channel pixels are): mma.sync m16n8k16
//   with fp32 accumulators on 128 x 64 or 64 x 64 tiles, four warps of
//   2 x 2, 64-deep chunks, three stages.
//   x rows (pixels, k-contiguous) reach the A fragments through ldmatrix,
//   w rows (n-contiguous) the B fragments through ldmatrix.trans, both
//   from XOR-swizzled tiles (mma_attention.cuh's swz on 128-byte rows).
//   16-bit products are exact in fp32, so the result differs from the
//   plain version only in the order of an fp32 sum.  wgmma with TMA's
//   im2col mode is later work.
// - "fma" (every fp32 call, and 16-bit calls the mma body does not take:
//   a Cout not a multiple of 8, an unaligned w): fp32 FMA on 64 x 64
//   tiles, 256 threads
//   of 4 x 4 outputs, 32-deep chunks, three stages.  No TF32: it keeps
//   about 3 decimal digits, and the reference sums in fp32.
// - Split-K: where the output tiles are fewer than the card's SMs, the
//   host cuts the K chunks into `splits` slices, as even as they come,
//   each of at least two chunks (ops.py::conv_splits), blockIdx.z a slice.  Each slice writes
//   its fp32 partial tile to scratch, and a second launch from the same
//   call sums the partials in slice order, adds the bias in fp32 and
//   rounds once: the same bits from run to run, no float atomics.
#include <cuda_fp16.h>

#include "mma_attention.cuh"

namespace {

using mma_attn::cp_async16;
using mma_attn::swz;

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
  int B, H, W, Cin, KH, KW, Cout, stride, Hout, Wout, pad_top, pad_left, M, K;
};

// One output pixel of a tile: its image's offset in x (-1 past M) and its
// window's top-left input pixel.
struct Row {
  long long base;
  int ih, iw;
};

// Whether window tap `tap` (= i * KW + j) contributes to the sum.
__device__ __forceinline__ bool tap_live(int tap, const Shape& s) {
  (void)tap;
  (void)s;
  return true;  // every tap contributes
}

// Where K index k lies in the window: channel c of tap (di, dj); `live`
// false past K and for a tap that does not contribute.
struct KPos {
  int c, di, dj;
  bool live;
};

__device__ __forceinline__ KPos k_pos(int k, const Shape& s) {
  KPos p{0, 0, 0, false};
  if (k < s.K) {
    const int tap = k / s.Cin;
    p.c = k - tap * s.Cin;
    p.di = tap / s.KW;
    p.dj = tap - p.di * s.KW;
    p.live = tap_live(tap, s);
  }
  return p;
}

// x's element (channel p.c of the window tap p) for tile row `row`, or
// null where it reads zero: past M or K, or a tap in the SAME padding.
template <typename T>
__device__ __forceinline__ const T* x_at(const T* x, const Row& row, const KPos& p,
                                         const Shape& s) {
  const int ih = row.ih + p.di, iw = row.iw + p.dj;
  if (!p.live || row.base < 0 || ih < 0 || ih >= s.H || iw < 0 || iw >= s.W) return nullptr;
  return x + row.base + ((long long)ih * s.W + iw) * s.Cin + p.c;
}

__device__ __forceinline__ void fill_rows(Row* rows, int m0, int bm, const Shape& s) {
  for (int r = threadIdx.x; r < bm; r += blockDim.x) {
    const int m = m0 + r;
    Row row{-1, 0, 0};
    if (m < s.M) {
      const int hw = s.Hout * s.Wout;
      const int b = m / hw, rem = m - b * hw;
      const int oh = rem / s.Wout, ow = rem - oh * s.Wout;
      row.base = (long long)b * s.H * s.W * s.Cin;
      row.ih = oh * s.stride - s.pad_top;
      row.iw = ow * s.stride - s.pad_left;
    }
    rows[r] = row;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ float bias_at(const void* bias, int bias_f32, int n) {
  return bias_f32 ? static_cast<const float*>(bias)[n] : to_f(static_cast<const T*>(bias)[n]);
}

// The K chunks of this block's slice: [kc0, kc1) of the nk = cdiv(K, bk),
// slice z taking chunks z * nk / splits up to (z + 1) * nk / splits.
struct Slice {
  int kc0, kc1;
};

__device__ __forceinline__ Slice slice_of(const Shape& s, int bk, int splits) {
  const int nk = (s.K + bk - 1) / bk, z = blockIdx.z;
  return Slice{z * nk / splits, (z + 1) * nk / splits};
}

// ---------------------------------------------------------------------------
// Body "mma": fp16 / bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // four warps, 2 x 2 over the tile
constexpr int MMA_BN = 64;         // output channels per block
constexpr int MMA_BK = 64;         // K depth of one chunk: a 128-byte row a pixel
constexpr int MMA_STAGES = 3;

template <int BM>
constexpr size_t mma_smem_bytes() {
  return (size_t)MMA_STAGES * (BM + MMA_BK) * MMA_BK * 2 + (size_t)BM * sizeof(Row);
}

template <typename T>
__device__ __forceinline__ void mma_t(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1);
template <>
__device__ __forceinline__ void mma_t<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                     uint32_t b0, uint32_t b1) {
  mma_attn::mma16816(d, a, b0, b1);
}
template <>
__device__ __forceinline__ void mma_t<__half>(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  mma_attn::mma16816_f16(d, a, b0, b1);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  return mma_attn::pack_bf16(lo, hi);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stage K chunk kc: the x patch (BM pixels x 64 of K) into `as` and the w
// slice (64 of K x 64 channels) into `bs`, 128-byte rows, swizzled.  A
// thread copies piece pc (8 elements) of rows pr, pr + 16, ...; without
// a_vec, element kl of rows kl / 64, + 2, ... of the x patch one by one.
template <typename T, int BM>
__device__ __forceinline__ void mma_load(T* as, T* bs, const T* __restrict__ x,
                                         const T* __restrict__ w, const Row* rows, int kc,
                                         int n0, const Shape& s, bool a_vec) {
  const int pc = threadIdx.x % 8, pr = threadIdx.x / 8;
  const int k0 = kc * MMA_BK;
  if (a_vec) {
    const KPos p = k_pos(k0 + pc * 8, s);
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int r = pr + 16 * i;
      const T* src = x_at(x, rows[r], p, s);
      cp_async16(as + swz<MMA_BK>(r, pc), src ? src : x, src ? 16 : 0);
    }
  } else {
    const int kl = threadIdx.x % MMA_BK;
    const KPos p = k_pos(k0 + kl, s);
#pragma unroll 8
    for (int r = threadIdx.x / MMA_BK; r < BM; r += MMA_THREADS / MMA_BK) {
      const T* src = x_at(x, rows[r], p, s);
      as[swz<MMA_BK>(r, kl / 8) + kl % 8] = src ? *src : from_f<T>(0.f);
    }
  }
  const int n = n0 + pc * 8;
#pragma unroll
  for (int i = 0; i < MMA_BK / 16; ++i) {
    const int kr = pr + 16 * i, k = k0 + kr;
    const bool live = k < s.K && n < s.Cout;
    cp_async16(bs + swz<MMA_BN>(kr, pc), live ? w + (size_t)k * s.Cout + n : w, live ? 16 : 0);
  }
}

// One staged chunk on the tensor cores: this warp's (BM / 2) x 32 outputs
// over the chunk's four k16 steps.
template <typename T, int BM>
__device__ __forceinline__ void mma_chunk(float (&acc)[BM / 32][4][4], const T* as, const T* bs,
                                          int warp_m, int warp_n, int lane) {
  constexpr int MI = BM / 32;   // m16 tiles of the warp's BM / 2 rows
#pragma unroll
  for (int ks = 0; ks < MMA_BK / 16; ++ks) {
    uint32_t af[MI][4], bf[2][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      mma_attn::ldsm_x4(af[mi], as + swz<MMA_BK>(warp_m * (BM / 2) + mi * 16 + (lane & 15),
                                                 2 * ks + (lane >> 4)));
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)   // B of n8 blocks 2 nj and 2 nj + 1, k 16 ks ..
      mma_attn::ldsm_x4_trans(bf[nj], bs + swz<MMA_BN>(16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7),
                                                       warp_n * 4 + 2 * nj + (lane >> 4)));
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_t<T>(acc[mi][ni], af[mi], bf[ni / 2][(ni & 1) * 2], bf[ni / 2][(ni & 1) * 2 + 1]);
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(MMA_THREADS) conv2d_mma_kernel(
    const T* __restrict__ x,          // (B, H, W, Cin)
    const T* __restrict__ w,          // (KH, KW, Cin, Cout) = (K, Cout)
    const void* __restrict__ bias,    // (Cout,), fp32 or T
    int bias_f32,
    T* __restrict__ out,              // (B, Hout, Wout, Cout)
    float* __restrict__ part,         // (splits, M, Cout) fp32, when splits > 1
    Shape s, int splits, int a_vec) {
  constexpr int MI = BM / 32;
  constexpr int A_ELEMS = BM * MMA_BK, STAGE_ELEMS = A_ELEMS + MMA_BK * MMA_BN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  Row* rows = reinterpret_cast<Row*>(smem + (size_t)MMA_STAGES * STAGE_ELEMS * sizeof(T));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_m = warp / 2, warp_n = warp % 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * MMA_BN;
  const Slice sl = slice_of(s, MMA_BK, splits);
  const int kc0 = sl.kc0, nks = sl.kc1 - sl.kc0;
  fill_rows(rows, m0, BM, s);
  __syncthreads();

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

#pragma unroll
  for (int st = 0; st < MMA_STAGES - 1; ++st) {
    if (st < nks) {
      T* as = tiles + st * STAGE_ELEMS;
      mma_load<T, BM>(as, as + A_ELEMS, x, w, rows, kc0 + st, n0, s, a_vec);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nks; ++i) {
    cp_async_wait<MMA_STAGES - 2>();   // chunk i has landed
    __syncthreads();                   // ... for every thread; chunk i - 1's buffer is free
    const int next = i + MMA_STAGES - 1;
    if (next < nks) {
      T* as = tiles + (next % MMA_STAGES) * STAGE_ELEMS;
      mma_load<T, BM>(as, as + A_ELEMS, x, w, rows, kc0 + next, n0, s, a_vec);
    }
    cp_async_commit();
    const T* as = tiles + (i % MMA_STAGES) * STAGE_ELEMS;
    mma_chunk<T, BM>(acc, as, as + A_ELEMS, warp_m, warp_n, lane);
  }
  cp_async_wait<0>();

  // acc[mi][ni][2 h + e] is output (row g + 8 h, col 2 cq + e) of the m16
  // x n8 tile (mi, ni); Cout is even, so col + 1 < Cout where col < Cout
  const int g = lane / 4, cq = lane % 4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + warp_n * 32 + ni * 8 + 2 * cq;
      if (col >= s.Cout) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp_m * (BM / 2) + mi * 16 + g + 8 * h;
        if (m >= s.M) continue;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (splits == 1) {
          *reinterpret_cast<uint32_t*>(out + (size_t)m * s.Cout + col) =
              pack2<T>(v0 + bias_at<T>(bias, bias_f32, col),
                       v1 + bias_at<T>(bias, bias_f32, col + 1));
        } else {
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * s.M + m) * s.Cout + col) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Body "fma": any type, any Cin and Cout, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int FMA_BM = 64, FMA_BN = 64;
constexpr int FMA_BK = 32;         // K depth of one chunk
constexpr int FMA_STAGES = 3;

template <typename T>
struct FmaTile {
  static constexpr int EPV = 16 / (int)sizeof(T);     // elements in a 16-byte piece
  static constexpr int A_LD = FMA_BK + EPV;           // x tile row, padded by a piece
  static constexpr int STAGE = FMA_BM * A_LD + FMA_BK * FMA_BN;   // elements
  static constexpr size_t SMEM = (size_t)FMA_STAGES * STAGE * sizeof(T) + FMA_BM * sizeof(Row);
};

// Stage K chunk kc into `as` ((64, A_LD): pixel rows, k-contiguous) and
// `bs` ((32, 64): k rows, n-contiguous).  a_vec / b_vec: 16-byte pieces
// (Cin / Cout a multiple of the piece, the operand aligned) by cp.async;
// otherwise element by element through registers.
template <typename T>
__device__ __forceinline__ void fma_load(T* as, T* bs, const T* __restrict__ x,
                                         const T* __restrict__ w, const Row* rows, int kc,
                                         int n0, const Shape& s, bool a_vec, bool b_vec) {
  using F = FmaTile<T>;
  constexpr int EPV = F::EPV;
  const int tid = threadIdx.x, k0 = kc * FMA_BK;
  if (a_vec) {
    constexpr int PPR = FMA_BK / EPV, RPP = FMA_THREADS / PPR;   // pieces a row, rows a pass
    const int pc = tid % PPR;
    const KPos p = k_pos(k0 + pc * EPV, s);
#pragma unroll
    for (int r = tid / PPR; r < FMA_BM; r += RPP) {
      const T* src = x_at(x, rows[r], p, s);
      cp_async16(as + r * F::A_LD + pc * EPV, src ? src : x, src ? 16 : 0);
    }
  } else {
    const int kl = tid % FMA_BK;
    const KPos p = k_pos(k0 + kl, s);
#pragma unroll
    for (int r = tid / FMA_BK; r < FMA_BM; r += FMA_THREADS / FMA_BK) {
      const T* src = x_at(x, rows[r], p, s);
      as[r * F::A_LD + kl] = src ? *src : from_f<T>(0.f);
    }
  }
  if (b_vec) {
    constexpr int PPR = FMA_BN / EPV, RPP = FMA_THREADS / PPR;
    const int pc = tid % PPR, n = n0 + pc * EPV;
#pragma unroll
    for (int kr = tid / PPR; kr < FMA_BK; kr += RPP) {
      const int k = k0 + kr;
      const bool live = k < s.K && n < s.Cout;
      cp_async16(bs + kr * FMA_BN + pc * EPV, live ? w + (size_t)k * s.Cout + n : w,
                 live ? 16 : 0);
    }
  } else {
    const int nl = tid % FMA_BN, n = n0 + nl;
#pragma unroll
    for (int kr = tid / FMA_BN; kr < FMA_BK; kr += FMA_THREADS / FMA_BN) {
      const int k = k0 + kr;
      bs[kr * FMA_BN + nl] = (k < s.K && n < s.Cout) ? w[(size_t)k * s.Cout + n] : from_f<T>(0.f);
    }
  }
}

__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

template <typename T>
__device__ __forceinline__ void load4(float (&v)[4], const T* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = to_f(e[i]);
}

// One staged chunk: this thread's 4 x 4 outputs (rows 4 ty .., cols 4 tx
// ..) over the chunk's 32 k, in k order.
template <typename T>
__device__ __forceinline__ void fma_chunk(float (&acc)[4][4], const T* as, const T* bs, int tx,
                                          int ty) {
#pragma unroll
  for (int kk = 0; kk < FMA_BK; kk += 4) {
    float a[4][4], b[4][4];   // a[i][j]: row 4 ty + i, k kk + j; b[j][n]: k kk + j, col 4 tx + n
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(a[i], as + (ty * 4 + i) * FmaTile<T>::A_LD + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) load4(b[j], bs + (kk + j) * FMA_BN + tx * 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[i][n] = fmaf(a[i][j], b[j][n], acc[i][n]);
  }
}

template <typename T>
__global__ void __launch_bounds__(FMA_THREADS) conv2d_fma_kernel(
    const T* __restrict__ x,          // (B, H, W, Cin)
    const T* __restrict__ w,          // (KH, KW, Cin, Cout) = (K, Cout)
    const void* __restrict__ bias,    // (Cout,), fp32 or T
    int bias_f32,
    T* __restrict__ out,              // (B, Hout, Wout, Cout)
    float* __restrict__ part,         // (splits, M, Cout) fp32, when splits > 1
    Shape s, int splits, int a_vec, int b_vec) {
  using F = FmaTile<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  Row* rows = reinterpret_cast<Row*>(smem + (size_t)FMA_STAGES * F::STAGE * sizeof(T));

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * FMA_BM, n0 = blockIdx.y * FMA_BN;
  const Slice sl = slice_of(s, FMA_BK, splits);
  const int kc0 = sl.kc0, nks = sl.kc1 - sl.kc0;
  fill_rows(rows, m0, FMA_BM, s);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < FMA_STAGES - 1; ++st) {
    if (st < nks) {
      T* as = tiles + st * F::STAGE;
      fma_load<T>(as, as + FMA_BM * F::A_LD, x, w, rows, kc0 + st, n0, s, a_vec, b_vec);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nks; ++i) {
    cp_async_wait<FMA_STAGES - 2>();   // chunk i has landed
    __syncthreads();                   // ... for every thread; chunk i - 1's buffer is free
    const int next = i + FMA_STAGES - 1;
    if (next < nks) {
      T* as = tiles + (next % FMA_STAGES) * F::STAGE;
      fma_load<T>(as, as + FMA_BM * F::A_LD, x, w, rows, kc0 + next, n0, s, a_vec, b_vec);
    }
    cp_async_commit();
    const T* as = tiles + (i % FMA_STAGES) * F::STAGE;
    fma_chunk<T>(acc, as, as + FMA_BM * F::A_LD, tx, ty);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= s.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= s.Cout) continue;
      if (splits == 1)
        out[(size_t)m * s.Cout + n] = from_f<T>(acc[i][j] + bias_at<T>(bias, bias_f32, n));
      else
        part[((size_t)blockIdx.z * s.M + m) * s.Cout + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// Split-K reduction: the partials summed in slice order, the bias, one rounding
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) conv2d_reduce_kernel(const float* __restrict__ part,
                                                            int splits, long long mn, int Cout,
                                                            const void* __restrict__ bias,
                                                            int bias_f32, T* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += part[(size_t)z * mn + i];
    out[i] = from_f<T>(sum + bias_at<T>(bias, bias_f32, (int)(i % Cout)));
  }
}

template <typename T>
int reduce(const float* part, int splits, const Shape& s, const void* bias, int bias_f32,
           void* out, cudaStream_t stream) {
  const long long mn = (long long)s.M * s.Cout;
  const long long need = (mn + 255) / 256;
  const int blocks = (int)(need < 4096 ? need : 4096);
  conv2d_reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, splits, mn, s.Cout, bias, bias_f32,
                                                      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T, int BM>
int launch_mma(const void* x, const void* w, const void* bias, int bias_f32, void* out,
               float* part, const Shape& s, int splits, int a_vec, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<BM>();
  auto kernel = conv2d_mma_kernel<T, BM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.M + BM - 1) / BM, (s.Cout + MMA_BN - 1) / MMA_BN, splits);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                              bias, bias_f32, static_cast<T*>(out), part, s,
                                              splits, a_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return reduce<T>(part, splits, s, bias, bias_f32, out, stream);
}

template <typename T>
int launch_fma(const void* x, const void* w, const void* bias, int bias_f32, void* out,
               float* part, const Shape& s, int splits, int a_vec, int b_vec,
               cudaStream_t stream) {
  constexpr size_t smem = FmaTile<T>::SMEM;
  auto kernel = conv2d_fma_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.M + FMA_BM - 1) / FMA_BM, (s.Cout + FMA_BN - 1) / FMA_BN, splits);
  kernel<<<grid, FMA_THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                              bias, bias_f32, static_cast<T*>(out), part, s,
                                              splits, a_vec, b_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return reduce<T>(part, splits, s, bias, bias_f32, out, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w and out share it);
// bias_f32: 1 if b is float32, 0 if it has x's type.  body: 1 the mma body
// (fp16 / bf16; Cout a multiple of 8 and w 16-byte aligned: b_vec; bm =
// 128 or 64 rows a tile), 0 the FMA body.  a_vec: x read in 16-byte
// pieces, which needs Cin a multiple of the piece and x 16-byte aligned
// (else gathered); b_vec: the same for w and Cout.  splits: slices of K (1: no split);
// past 1, scratch holds splits * M * Cout floats.  The launcher decides
// all of these.  Returns 0 or the CUDA error of a launch.
extern "C" int conv2d(const void* x, const void* w, const void* bias, void* out, void* scratch,
                      int dtype, int bias_f32, int body, int a_vec, int b_vec, int bm,
                      int splits, int B, int H, int W, int Cin, int KH, int KW, int Cout,
                      int stride, void* stream) {
  Shape s;
  s.B = B; s.H = H; s.W = W; s.Cin = Cin; s.KH = KH; s.KW = KW; s.Cout = Cout;
  s.stride = stride;
  s.Hout = (H + stride - 1) / stride;
  s.Wout = (W + stride - 1) / stride;
  const int pad_h = (s.Hout - 1) * stride + KH - H;   // SAME: total // 2 before
  const int pad_w = (s.Wout - 1) * stride + KW - W;
  s.pad_top = pad_h > 0 ? pad_h / 2 : 0;
  s.pad_left = pad_w > 0 ? pad_w / 2 : 0;
  s.M = B * s.Hout * s.Wout;
  s.K = KH * KW * Cin;
  if (s.M == 0 || Cout == 0) return 0;
  if (splits < 1 || (splits > 1 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const int epv = dtype == 0 ? 4 : 8;
  if ((a_vec && Cin % epv) || (b_vec && Cout % epv)) return (int)cudaErrorInvalidValue;
  if (body == 1) {
    if (!b_vec || (bm != 64 && bm != 128)) return (int)cudaErrorInvalidValue;
    if (dtype == 1)
      return bm == 128
                 ? launch_mma<__nv_bfloat16, 128>(x, w, bias, bias_f32, out, part, s, splits,
                                                  a_vec, st)
                 : launch_mma<__nv_bfloat16, 64>(x, w, bias, bias_f32, out, part, s, splits,
                                                 a_vec, st);
    if (dtype == 2)
      return bm == 128
                 ? launch_mma<__half, 128>(x, w, bias, bias_f32, out, part, s, splits, a_vec, st)
                 : launch_mma<__half, 64>(x, w, bias, bias_f32, out, part, s, splits, a_vec, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1)
    return launch_fma<__nv_bfloat16>(x, w, bias, bias_f32, out, part, s, splits, a_vec, b_vec, st);
  if (dtype == 2)
    return launch_fma<__half>(x, w, bias, bias_f32, out, part, s, splits, a_vec, b_vec, st);
  return launch_fma<float>(x, w, bias, bias_f32, out, part, s, splits, a_vec, b_vec, st);
}
