// General matrix product out = x @ y for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/matmul/kernel.py::matmul
// (def :36, body _matmul_kernel :20, pallas_call :46).  It computes the
// same function as its oracle (src/repro/kernels/matmul/ref.py:8-11):
// x (M, K) times y (K, N), products summed in fp32, the sum rounded once
// to x's type.  x and y share one type: fp32, fp16 or bf16.  Unlike the
// Pallas kernel, which asserts that its 512-wide tiles divide the shape,
// this one takes any M, N and K, and each operand comes as a pointer and
// two strides, so a transposed view (w.T, x.T in the backward products,
// the tied LM head's tok.T) is read in place, never copied.  The output is
// written row-major, contiguous.
//
// What bounds it on an H100: for the products of training and prefill
// (M of 512 or more rows against d_model 2048, d_ff 11008, vocab 151936)
// arithmetic -- 2 M N K flops far above the flops-per-byte ridge -- so the
// least time is the flops over the peak of the type (67 TFLOP/s fp32 on
// the CUDA cores, 989 TFLOP/s bf16 / fp16 on the tensor cores).  For
// decode (M of a few rows) the bytes of y: the weight is read once.
//
// Two bodies, and a third for the batched entry (below); the caller
// (kernels/matmul/ops.py::route, route_batched) picks one from the type,
// the shape and the strides before the launch:
//
// 1. FMA (fp32 at any shape; fp16 / bf16 where TMA cannot read an operand:
//    a base not 16-byte aligned or a row stride not a multiple of 16
//    bytes).  One block per BM x BN output tile walks K in slices of
//    BK = 32, staging the x slice (BM x 32) and the y slice (32 x BN) in
//    shared memory as fp32; each thread owns a TM x TN sub-tile in
//    registers.  The next slice's loads are issued into registers before
//    the current slice is multiplied, so global latency overlaps the FMAs.
//    - Strides: the loader maps consecutive threads along whichever dim of
//      the operand has unit stride, so either layout loads coalesced.
//    - Summation order: each slice's 32 products are summed into a fresh
//      fp32 partial, in ascending k, and the partial is added to the
//      accumulator -- the structure of the Pallas kernel's
//      acc += dot(x_tile, y_tile) over K tiles.  The order depends only on
//      k, never on the tile shape, so the two tile shapes give
//      bit-identical results.
//    - Two tile shapes: WIDE 128 x 128 (256 threads, 8 x 8 each) for
//      M > 16, NARROW 16 x 32 (128 threads, 2 x 2 each) for the few rows of
//      a decode step.
//    - Masked edges: rows, columns and k past the shape load 0 and are not
//      stored.
//
// 2. WGMMA (fp16 / bf16 whose operands TMA can read): the tensor cores.
//    - Staging: each operand has a CUtensorMap (a __grid_constant__
//      parameter) whose box is 64 x 64 elements: 64 along the operand's
//      contiguous dim (128 bytes, the width of the 128-byte swizzle) by 64
//      along the other.  TMA (cp.async.bulk.tensor) copies the boxes of a
//      BK = 64 slice into a ring of shared-memory stages, each with a
//      "full" mbarrier (the TMA transaction bytes) and an "empty" one (one
//      arrival per consumer warpgroup).  TMA fills zeros past each ragged
//      M, N and K edge, so the loads need no masks.
//    - Roles: the last warp of the block is the producer (one thread
//      issues the loads, STAGES slices ahead); each consumer warpgroup owns
//      64 rows of the tile and issues wgmma.mma_async m64n64k16 (fp32
//      accumulators in registers) on its rows against each 64-column part
//      of the tile, k16 by k16, then frees the stage.
//    - Layouts: a k-contiguous operand lands "K-major" (rows of 64 k), an
//      m- or n-contiguous one (the backward's x.T and dY, a row-major
//      weight) "MN-major" (rows of 64 m or n, one row per k) and is read
//      with the instruction's transpose bit.  The descriptor's stride
//      between 8-row groups is 1024 bytes in both; a k16 step moves the
//      start address 32 bytes (K-major) or 16 rows, 2048 bytes (MN-major).
//    - Tiles: WIDE 128 x 128 (two consumer warpgroups) and NARROW 64 x 64
//      (one), the narrow one for decode (a few rows: 172 blocks stream
//      qwen's 45 MB MLP weight over the 132 SMs) and for shapes whose wide
//      tiles would leave SMs idle (N = 256 K/V projections).
//    - Summation order: both tiles issue the same instruction, m64n64k16,
//      on the same 64-row / 64-column parts, walking k16 steps in
//      ascending k into one accumulator, so they agree bit for bit; the
//      order depends on k alone, never on the tile.
//    - Epilogue: the fp32 accumulators, rounded once to the type, stored
//      with masks on the ragged M and N edges.
//
// The batched entry (matmul_batched) computes out[e] = x[e] @ y[e] for
// e in [0, E) in one launch: the E experts' products of a mixture-of-
// experts layer (the reference's einsums "ecd,edf->ecf" and
// "ecf,efd->ecd", src/repro/models/layers/moe.py:67-77, which run outside
// any Pallas kernel: XLA's batched dot).  The grid gains a third dim over
// E, and each body reads expert e's operands and writes its output:
//    - FMA: each operand takes a batch stride (elements between experts);
//      the output is (E, M, N) contiguous.
//    - WGMMA: the tensor maps are rank 3 (inner, outer, expert) and each
//      TMA box is 64 x 64 x 1, so the zeros past an expert's ragged M, N
//      or K edge stay inside that expert (a rank-2 map over the stacked
//      rows would read the next expert's rows into a partial tile).
// Per expert the arithmetic is the 2-D entry's: the same tiles, the same
// order of summation, so an E = 1 launch gives the 2-D entry's bits.
// What bounds it: at the MoE layer's shapes (64 experts of 2048 x 1408,
// 30 rows each in a 256-row prefill chunk, 4 in a decode step) the bytes
// of the expert weights, 369 MB a product -- each weight is read once.
//
// 3. WGMMA_PERSISTENT (the batched entry only, where a product writes at
//    least as many elements as it reads, M N >= K (M + N): the experts'
//    dW = X^T @ dY of MoE training, contracting over the capacity C, 60
//    in a 512-token microbatch).  Such a product leads with its stores --
//    at C = 60 dW writes the 369 MB gradient and reads 26.5 MB -- and
//    body 2 leaves them unhidden: each block loads its slices, stores its
//    tile from registers (half-sector writes) and exits.  This body:
//    - Walk: a grid of as many blocks as fit on the SMs at once; block b
//      takes output tiles b, b + grid, ... of the E x ceil(M/BM) x
//      ceil(N/BN) tiles, numbered expert-major (then row-major inside
//      an expert), so the blocks in flight share one expert's operands
//      in L2.
//    - Ring: two stages that run across tiles, not only along K: the
//      producer loads the next tile's slices while the consumers finish
//      the current tile.
//    - Epilogue: each consumer warpgroup rounds its 64 rows once to the
//      type and writes them into one of two staging buffers in shared
//      memory, in the 128-byte swizzle (a warp's 4-byte writes fall on
//      32 banks), then one thread stores the buffer's 64 x 64 boxes with
//      cp.async.bulk.tensor through a rank-3 map of the output (N, M, E),
//      which clips each expert's ragged M and N edge.  A buffer is
//      rewritten only after its earlier store has read it
//      (cp.async.bulk.wait_group.read), so one tile's store drains while
//      the next tile is computed.
//    - Arithmetic: body 2's, through the same load_slice and mma_slice
//      -- m64n64k16 on the same 64-row / 64-column parts, k16 steps in
//      ascending k into one fp32 accumulator, one rounding -- so each
//      expert's output keeps the 2-D entry's bits.
//    The output row must be a multiple of 16 bytes (the map's stride).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

namespace {

constexpr int BK = 32;          // depth of one K slice

// The expert of this block (the grid's third dim; 0 in a 2-D launch), whose
// weight y[e] it reads, and the offset of its output out[e] (M x N each).
__device__ __forceinline__ int w_expert() { return blockIdx.z; }
__device__ __forceinline__ long long out_offset(int M, int N) {
  return (long long)blockIdx.z * M * N;
}

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
    int M, int N, int K,
    long long bx, long long by) {                   // batch strides (batched entry)
  constexpr int TX = BN / TN;                       // threads along N
  constexpr int THREADS = (BM / TM) * TX;
  constexpr int A_PER = BM * BK / THREADS;          // x elements staged per thread
  constexpr int B_PER = BK * BN / THREADS;          // y elements staged per thread
  static_assert(A_PER * THREADS == BM * BK && B_PER * THREADS == BK * BN, "tile");
  __shared__ __align__(16) float As[BK][BM + 4];    // x slice, k-major
  __shared__ __align__(16) float Bs[BK][BN + 4];    // y slice

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  x += blockIdx.z * bx;
  y += w_expert() * by;
  out += out_offset(M, N);
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

// E experts (the grid's third dim), bx / by elements apart; a 2-D product
// is E = 1.
template <typename T, int BM, int BN, int TM, int TN>
cudaError_t launch(const void* x, const void* y, void* out, int M, int N, int K,
                   int sxm, int sxk, int syk, int syn, cudaStream_t stream, int E,
                   long long bx, long long by) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  matmul_kernel<T, BM, BN, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(x), sxm, sxk, static_cast<const T*>(y), syk, syn,
      static_cast<T*>(out), M, N, K, bx, by);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tile(int narrow, const void* x, const void* y, void* out, int M,
                          int N, int K, int sxm, int sxk, int syk, int syn,
                          cudaStream_t stream, int E = 1, long long bx = 0,
                          long long by = 0) {
  if (narrow)
    return launch<T, 16, 32, 2, 2>(x, y, out, M, N, K, sxm, sxk, syk, syn, stream, E, bx, by);
  return launch<T, 128, 128, 8, 8>(x, y, out, M, N, K, sxm, sxk, syk, syn, stream, E, bx, by);
}

// ---------------------------------------------------------------------------
// Body 2: wgmma on TMA-staged tiles (fp16 / bf16)
// ---------------------------------------------------------------------------

constexpr int WG_BK = 64;                 // K slice of one stage (128 bytes of 16-bit)
constexpr int BOX = 64;                   // a TMA box is BOX x BOX elements
constexpr int BOX_BYTES = BOX * BOX * 2;  // 8 KB, eight 1024-byte swizzle atoms

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
// A wait that never ends (a lost TMA transaction) traps after ~2^26 polls,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// One 64 x 64 box of the operand at (inner, outer) element coordinates
// (of expert e, where the map is rank 3) into shared memory, completing
// its bytes on the barrier.
template <bool RANK3>
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int inner, int outer, int e) {
  if constexpr (RANK3) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer),
        "r"(e)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
        : "memory");
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (K-major or MN-major: 8-row groups 1024 bytes apart in both; the leading
// offset is unused by a 64-wide m / n part and set to the same value).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kGroup << 16) | (kGroup << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma (between the fence and the wait).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_ACC32(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])
#define WG_MMA_64x64(TYPE)                                                                  \
  "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                                            \
  " wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "       \
  "%32, %33, p, 1, 1, %35, %36;\n}\n"

// d (64 x 64, fp32) += a (64 x 16) b (16 x 64), both from shared memory;
// TA / TB: the operand is MN-major (the transpose bit).
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(WG_MMA_64x64("f16")
                 : WG_ACC32(d)
                 : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else {
    asm volatile(WG_MMA_64x64("bf16")
                 : WG_ACC32(d)
                 : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
}

// Two fp32 values rounded to T, as one 32-bit word (the first in the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// The producer's load of one 64-deep K slice (depth k0..) into a ring
// stage: A_BOXES 64 x 64 boxes of x (rows m0..) at `a`, then B_BOXES of y
// (columns n0..), completing on barrier `bar`; ex / ey the expert of x / y
// on rank-3 maps.  Bodies 2 and 3 both load through it.
template <int A_BOXES, int B_BOXES, bool A_MN, bool B_MN, bool RANK3>
__device__ __forceinline__ void load_slice(uint8_t* a, const CUtensorMap* xmap,
                                           const CUtensorMap* ymap, uint64_t* bar, int m0,
                                           int n0, int k0, int ex, int ey) {
  uint8_t* b = a + A_BOXES * BOX_BYTES;
  mbar_expect_tx(bar, (A_BOXES + B_BOXES) * BOX_BYTES);
#pragma unroll
  for (int c = 0; c < A_BOXES; ++c) {
    if (A_MN)
      tma_load<RANK3>(a + c * BOX_BYTES, xmap, bar, m0 + c * BOX, k0, ex);
    else
      tma_load<RANK3>(a + c * BOX_BYTES, xmap, bar, k0, m0 + c * BOX, ex);
  }
#pragma unroll
  for (int j = 0; j < B_BOXES; ++j) {
    if (B_MN)
      tma_load<RANK3>(b + j * BOX_BYTES, ymap, bar, n0 + j * BOX, k0, ey);
    else
      tma_load<RANK3>(b + j * BOX_BYTES, ymap, bar, k0, n0 + j * BOX, ey);
  }
}

// A consumer warpgroup's product of one slice in shared memory: the k16
// steps in ascending k, acc[j] (64 x 64, fp32) += a (the warpgroup's 64
// rows of x) times y's 64-column part j at b.  Bodies 2 and 3 both
// multiply through it, so they give the same bits.
template <typename T, int B_BOXES, bool A_MN, bool B_MN>
__device__ __forceinline__ void mma_slice(float (&acc)[B_BOXES][32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < B_BOXES; ++j) fence_acc(acc[j]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk) {
    // a k16 step: 32 bytes along a K-major row, 16 rows of an MN-major tile
    const uint64_t da = smem_desc(a + kk * (A_MN ? 2048 : 32));
#pragma unroll
    for (int j = 0; j < B_BOXES; ++j)
      wgmma_64x64<T, A_MN, B_MN>(acc[j],
                                 da, smem_desc(b + j * BOX_BYTES + kk * (B_MN ? 2048 : 32)));
  }
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int j = 0; j < B_BOXES; ++j) fence_acc(acc[j]);
}

// The block: NC consumer warpgroups (64 rows each) and one producer warp.
// A_MN: x is m-contiguous; B_MN: y is n-contiguous (else k-contiguous).
// RANK3: the batched entry's rank-3 maps, expert blockIdx.z.
template <typename T, int NC, int BN, int STAGES, bool A_MN, bool B_MN, bool RANK3>
__global__ void __launch_bounds__(NC * 128 + 32) matmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
    T* __restrict__ out, int M, int N, int K) {
  constexpr int BM = NC * 64;
  constexpr int A_BOXES = BM / BOX, B_BOXES = BN / BOX;
  constexpr int STAGE_BYTES = (A_BOXES + B_BOXES) * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // stages at a 1024-byte boundary (the swizzle atom), barriers after them
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NC * 4) {
    // producer: one thread keeps STAGES slices in flight
    if (threadIdx.x % 32 == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        load_slice<A_BOXES, B_BOXES, A_MN, B_MN, RANK3>(smem + s * STAGE_BYTES, &xmap, &ymap,
                                                        &full[s], m0, n0, kt * WG_BK,
                                                        blockIdx.z, w_expert());
      }
    }
  } else {
    // consumer warpgroup wg: rows m0 + 64 wg .. + 63 of the tile
    const int wg = warp / 4;
    float acc[B_BOXES][32];
#pragma unroll
    for (int j = 0; j < B_BOXES; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a = smem_u32(smem + s * STAGE_BYTES) + wg * BOX_BYTES;
      const uint32_t b = smem_u32(smem + s * STAGE_BYTES) + A_BOXES * BOX_BYTES;
      mma_slice<T, B_BOXES, A_MN, B_MN>(acc, a, b);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    }
    // accumulator layout of m64nNk16: warp w of the group holds rows
    // 16 w + lane / 4 (+ 8); register 4 q + 2 h + e is column
    // 8 q + 2 (lane % 4) + e of row half h
    const int lane = threadIdx.x % 32, w = warp % 4;
    const bool pairs = N % 2 == 0;          // a row's even columns start 4-byte aligned
    out += out_offset(M, N);
#pragma unroll
    for (int j = 0; j < B_BOXES; ++j) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wg * 64 + w * 16 + lane / 4 + 8 * h;
          const int n = n0 + j * BOX + 8 * q + 2 * (lane % 4);
          if (m >= M || n >= N) continue;
          T* o = out + (long long)m * N + n;
          const float v0 = acc[j][4 * q + 2 * h], v1 = acc[j][4 * q + 2 * h + 1];
          if (pairs) {
            *reinterpret_cast<uint32_t*>(o) = pack2<T>(v0, v1);
          } else {
            o[0] = from_f<T>(v0);
            if (n + 1 < N) o[1] = from_f<T>(v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Body 3: the persistent, store-overlapped wgmma walk (batched entry)
// ---------------------------------------------------------------------------

constexpr int P_STAGES = 2;   // ring stages, filled across tiles
constexpr int OUT_BUFS = 2;   // staging buffers of the output, stored in turn

// One 64 x 64 box of shared memory into the rank-3 map at (inner, outer,
// e); TMA clips what lies past the map's edges.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int inner,
                                          int outer, int e) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(inner), "r"(outer), "r"(e)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Returns once at most N of this thread's committed store groups have yet
// to read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// Makes this thread's shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// The 128 threads of consumer warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

struct TileAt {
  int e, m0, n0;
};
// Output tile t of the walk: expert-major, then row-major over an expert's
// tm x tn tiles of BT x BT.
__device__ __forceinline__ TileAt tile_at(int t, int tm, int tn, int BT) {
  const int per = tm * tn, r = t % per;
  return {t / per, (r / tn) * BT, (r % tn) * BT};
}

// The block: NC consumer warpgroups (64 rows each of an NC*64-square tile)
// and one producer warp; x's and y's maps rank 3 as in body 2, the
// output's rank 3 (N, M, E).  A_MN / B_MN as in body 2.
template <typename T, int NC, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(NC * 128 + 32) matmul_persistent_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
    const __grid_constant__ CUtensorMap omap, int M, int N, int K, int E) {
  constexpr int BT = NC * 64, BOXES = NC;            // a tile is BOXES x BOXES boxes
  constexpr int STAGE_BYTES = 2 * BOXES * BOX_BYTES;
  constexpr int OUT_BYTES = BOXES * BOX_BYTES;       // one warpgroup's 64 rows of a tile
  extern __shared__ uint8_t smem_raw[];
  // stages, then staging buffers [OUT_BUFS][NC], at 1024-byte boundaries;
  // barriers after them
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = smem + P_STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + OUT_BUFS * NC * OUT_BYTES);
  uint64_t* empty = full + P_STAGES;

  const int tm = (M + BT - 1) / BT, tn = (N + BT - 1) / BT;
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int tiles = E * tm * tn;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NC * 4) {
    // producer: one thread walks the block's tiles, slice g of the walk
    // into stage g % P_STAGES
    if (threadIdx.x % 32 == 0) {
      int g = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TileAt src = tile_at(t, tm, tn, BT);
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int s = g % P_STAGES;
          if (g >= P_STAGES) mbar_wait(&empty[s], (g / P_STAGES - 1) & 1);
          load_slice<BOXES, BOXES, A_MN, B_MN, true>(smem + s * STAGE_BYTES, &xmap, &ymap,
                                                     &full[s], src.m0, src.n0, kt * WG_BK,
                                                     src.e, src.e);
        }
      }
    }
  } else {
    // consumer warpgroup wg: rows 64 wg .. + 63 of each tile
    const int wg = warp / 4, lane = threadIdx.x % 32, w = warp % 4;
    const bool leader = threadIdx.x % 128 == 0;
    int g = 0, u = 0;                   // slices consumed; tiles stored
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++u) {
      float acc[BOXES][32];
#pragma unroll
      for (int j = 0; j < BOXES; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++g) {
        const int s = g % P_STAGES;
        mbar_wait(&full[s], (g / P_STAGES) & 1);
        const uint32_t a = smem_u32(smem + s * STAGE_BYTES) + wg * BOX_BYTES;
        const uint32_t b = smem_u32(smem + s * STAGE_BYTES) + BOXES * BOX_BYTES;
        mma_slice<T, BOXES, A_MN, B_MN>(acc, a, b);
        if (leader) mbar_arrive(&empty[s]);
      }
      const TileAt dst = tile_at(t, tm, tn, BT);
      uint8_t* buf = staging + ((u % OUT_BUFS) * NC + wg) * OUT_BYTES;
      if (leader) bulk_wait_read<OUT_BUFS - 1>();   // the buffer's last store has read it
      wg_sync(wg);
      // accumulator layout as in body 2: row 16 w + lane / 4 + 8 h of the
      // warpgroup's 64, register 4 q + 2 h + e column 8 q + 2 (lane % 4) + e;
      // 16-byte chunk q of a 128-byte row r lands at chunk q ^ (r % 8)
#pragma unroll
      for (int j = 0; j < BOXES; ++j) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = w * 16 + lane / 4 + 8 * h;
            *reinterpret_cast<uint32_t*>(buf + j * BOX_BYTES + r * 128 +
                                         ((q ^ (lane / 4)) * 16) + 4 * (lane % 4)) =
                pack2<T>(acc[j][4 * q + 2 * h], acc[j][4 * q + 2 * h + 1]);
          }
        }
      }
      fence_proxy_async();
      wg_sync(wg);
      if (leader) {
        const int m = dst.m0 + wg * 64;
#pragma unroll
        for (int j = 0; j < BOXES; ++j)
          if (m < M && dst.n0 + j * BOX < N)
            tma_store(&omap, buf + j * BOX_BYTES, dst.n0 + j * BOX, m, dst.e);
        bulk_commit();
      }
    }
    if (leader) bulk_wait_all();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver API, reached through the runtime
// (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int ENCODE_ERROR = 10000;   // returned as ENCODE_ERROR + the CUresult

// A map of an operand: `inner` elements along its contiguous dim, `outer`
// rows `stride` elements apart, and (rank 3, E > 0) E experts `bstride`
// elements apart; 64 x 64 (x 1) boxes, 128-byte swizzle, zeros past the
// edges -- of each expert, where the map is rank 3.  Returns the CUresult
// of the encoding.
int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int inner,
             int outer, int stride, int E = 0, long long bstride = 0) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t rank = E > 0 ? 3 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)stride * 2, (cuuint64_t)bstride * 2};
  const cuuint32_t box[3] = {BOX, BOX, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return (int)fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, int NC, int BN, int STAGES, bool A_MN, bool B_MN, bool RANK3>
cudaError_t launch_wgmma(const CUtensorMap& xm, const CUtensorMap& ym, void* out, int M,
                         int N, int K, int E, cudaStream_t stream) {
  constexpr int BM = NC * 64;
  constexpr int SMEM = STAGES * (BM + BN) * BOX * 2 + 1024 + 2 * STAGES * 8;
  auto kernel = matmul_wgmma_kernel<T, NC, BN, STAGES, A_MN, B_MN, RANK3>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  kernel<<<grid, NC * 128 + 32, SMEM, stream>>>(xm, ym, static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename T, bool A_MN, bool B_MN, bool RANK3>
cudaError_t wgmma_tile(int narrow, const CUtensorMap& xm, const CUtensorMap& ym, void* out,
                       int M, int N, int K, int E, cudaStream_t s) {
  if (narrow) return launch_wgmma<T, 1, 64, 4, A_MN, B_MN, RANK3>(xm, ym, out, M, N, K, E, s);
  return launch_wgmma<T, 2, 128, 3, A_MN, B_MN, RANK3>(xm, ym, out, M, N, K, E, s);
}

template <typename T, bool RANK3>
cudaError_t wgmma_layout(bool a_mn, bool b_mn, int narrow, const CUtensorMap& xm,
                         const CUtensorMap& ym, void* out, int M, int N, int K, int E,
                         cudaStream_t s) {
  if (a_mn && b_mn) return wgmma_tile<T, true, true, RANK3>(narrow, xm, ym, out, M, N, K, E, s);
  if (a_mn) return wgmma_tile<T, true, false, RANK3>(narrow, xm, ym, out, M, N, K, E, s);
  if (b_mn) return wgmma_tile<T, false, true, RANK3>(narrow, xm, ym, out, M, N, K, E, s);
  return wgmma_tile<T, false, false, RANK3>(narrow, xm, ym, out, M, N, K, E, s);
}

// Body 3's launch: as many blocks as the SMs hold at once, or one a tile.
template <typename T, int NC, bool A_MN, bool B_MN>
cudaError_t launch_persistent(const CUtensorMap& xm, const CUtensorMap& ym,
                              const CUtensorMap& om, int M, int N, int K, int E,
                              cudaStream_t stream) {
  constexpr int BT = NC * 64;
  constexpr int SMEM =
      P_STAGES * 2 * BT * BOX * 2 + OUT_BUFS * BT * BT * 2 + 1024 + 2 * P_STAGES * 8;
  auto kernel = matmul_persistent_kernel<T, NC, A_MN, B_MN>;
  static int per_sm = 0;                // blocks of this kernel an SM holds
  if (per_sm == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NC * 128 + 32, SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)E * ((M + BT - 1) / BT) * ((N + BT - 1) / BT);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = (int)std::min<long long>(tiles, (long long)sms * per_sm);
  kernel<<<grid, NC * 128 + 32, SMEM, stream>>>(xm, ym, om, M, N, K, E);
  return cudaGetLastError();
}

template <typename T, bool A_MN, bool B_MN>
cudaError_t persistent_tile(int narrow, const CUtensorMap& xm, const CUtensorMap& ym,
                            const CUtensorMap& om, int M, int N, int K, int E,
                            cudaStream_t s) {
  if (narrow) return launch_persistent<T, 1, A_MN, B_MN>(xm, ym, om, M, N, K, E, s);
  return launch_persistent<T, 2, A_MN, B_MN>(xm, ym, om, M, N, K, E, s);
}

template <typename T>
cudaError_t persistent_layout(bool a_mn, bool b_mn, int narrow, const CUtensorMap& xm,
                              const CUtensorMap& ym, const CUtensorMap& om, int M, int N,
                              int K, int E, cudaStream_t s) {
  if (a_mn && b_mn) return persistent_tile<T, true, true>(narrow, xm, ym, om, M, N, K, E, s);
  if (a_mn) return persistent_tile<T, true, false>(narrow, xm, ym, om, M, N, K, E, s);
  if (b_mn) return persistent_tile<T, false, true>(narrow, xm, ym, om, M, N, K, E, s);
  return persistent_tile<T, false, false>(narrow, xm, ym, om, M, N, K, E, s);
}

// The strides name each operand's contiguous dim: sxk == 1 for a
// k-contiguous x (else sxm == 1), syk == 1 for a k-contiguous y (else
// syn == 1); the other stride is a multiple of 8 elements (ops.py checks).
// E > 0: the batched entry's E experts, sxe / sye elements apart (each a
// multiple of 8), on rank-3 maps; E = 0: a 2-D product.  persistent: body
// 3 (E > 0, N a multiple of 8), which stores through a map of the output.
template <typename T>
int dispatch_wgmma(int narrow, const void* x, const void* y, void* out, int M, int N, int K,
                   int sxm, int sxk, int syk, int syn, cudaStream_t s, int E = 0,
                   long long sxe = 0, long long sye = 0, bool persistent = false) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const bool a_mn = sxk != 1, b_mn = syk != 1;
  // The encoding is a CUDA driver API call: it needs the device's context current on
  // this thread, which a runtime call binds -- once per thread (autograd
  // runs the backward products on a thread of its own).
  thread_local bool context_bound = false;
  if (!context_bound) {
    const cudaError_t err = cudaFree(nullptr);
    if (err != cudaSuccess) return err;
    context_bound = true;
  }
  CUtensorMap xm, ym;
  int res = a_mn ? make_map(&xm, x, type, M, K, sxk, E, sxe)
                 : make_map(&xm, x, type, K, M, sxm, E, sxe);
  if (res == CUDA_SUCCESS)
    res = b_mn ? make_map(&ym, y, type, N, K, syk, E, sye)
               : make_map(&ym, y, type, K, N, syn, E, sye);
  if (res != CUDA_SUCCESS) return ENCODE_ERROR + res;
  if (persistent) {
    CUtensorMap om;                       // the output (E, M, N), row-major
    res = make_map(&om, out, type, N, M, N, E, (long long)M * N);
    if (res != CUDA_SUCCESS) return ENCODE_ERROR + res;
    return persistent_layout<T>(a_mn, b_mn, narrow, xm, ym, om, M, N, K, E, s);
  }
  if (E > 0) return wgmma_layout<T, true>(a_mn, b_mn, narrow, xm, ym, out, M, N, K, E, s);
  return wgmma_layout<T, false>(a_mn, b_mn, narrow, xm, ym, out, M, N, K, 1, s);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16 (x, y and out alike).  narrow: 1 for the
// narrow tile (FMA 16 x 32, wgmma 64 x 64), 0 for the wide one (128 x 128).
// body: 0 FMA, 1 wgmma (fp16 / bf16 only).  Strides in elements.  Returns
// the launch's cudaError_t (0 on success), or ENCODE_ERROR + the CUresult
// where a tensor map could not be encoded.
extern "C" int matmul(const void* x, const void* y, void* out, int dtype, int M, int N,
                      int K, int sxm, int sxk, int syk, int syn, int narrow, int body,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype == 1)
      return dispatch_wgmma<__nv_bfloat16>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s);
    if (dtype == 2)
      return dispatch_wgmma<__half>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s);
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0: return dispatch_tile<float>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s);
    case 1:
      return dispatch_tile<__nv_bfloat16>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s);
    case 2: return dispatch_tile<__half>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s);
    default: return cudaErrorInvalidValue;
  }
}

// The batched entry: out[e] = x[e] @ y[e] for e in [0, E), out (E, M, N)
// contiguous.  x[e] starts sxe elements after x[e - 1], y[e] sye after
// y[e - 1]; within an expert the strides, types and bodies are the 2-D
// entry's; body 2 takes WGMMA_PERSISTENT.  Returns as `matmul` does.
extern "C" int matmul_batched(const void* x, const void* y, void* out, int dtype, int E,
                              int M, int N, int K, long long sxe, int sxm, int sxk,
                              long long sye, int syk, int syn, int narrow, int body,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int experts = E;                 // the grid's third dim, or the walk's experts
  if (body == 1 || body == 2) {
    if (dtype == 1)
      return dispatch_wgmma<__nv_bfloat16>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s,
                                           experts, sxe, sye, body == 2);
    if (dtype == 2)
      return dispatch_wgmma<__half>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s,
                                    experts, sxe, sye, body == 2);
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      return dispatch_tile<float>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s, experts,
                                  sxe, sye);
    case 1:
      return dispatch_tile<__nv_bfloat16>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s,
                                          experts, sxe, sye);
    case 2:
      return dispatch_tile<__half>(narrow, x, y, out, M, N, K, sxm, sxk, syk, syn, s, experts,
                                   sxe, sye);
    default: return cudaErrorInvalidValue;
  }
}
