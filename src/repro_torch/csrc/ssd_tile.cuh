// Tensor-core pieces of the chunked SSD scan, shared by its forward
// (ssm_scan.cu's tensor-core body) and its backward (ssm_scan_backward.cu's
// "mma" body): one block of four warps per (chunk, head); the chunk's bf16
// rows staged by 16-byte cp.async into XOR-swizzled shared memory (q and k
// read through their strides, so a stride-0 head view is read as it is);
// the decay's inclusive cumsum over the chunk; fp32 operands carried into
// mma.sync m16n8k16 as bf16 hi + lo pairs; the fragment loaders (ldmatrix,
// plain or transposed) of the four operand layouts the products need.
// Plain C++ and CUDA runtime only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_attention.cuh"

namespace ssd_tile {

using mma_attn::cp_async16;
using mma_attn::ldsm_x4;
using mma_attn::ldsm_x4_trans;
using mma_attn::pack_bf16;
using mma_attn::smem_addr;
typedef __nv_bfloat16 bf16;

constexpr int TC_THREADS = 128;      // four warps
constexpr int WARPS = TC_THREADS / 32;
constexpr float PAD_GATE = -1e30f;   // the reference's padded-step gate

// Element offset of 16-byte piece c of row r in a staged tile of W bf16 a
// row: the piece index is XORed with the row's low bits (three of them
// where the row has eight pieces or more), so the eight rows an ldmatrix
// reads at one piece fall in different bank groups.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int M = W / 8 < 8 ? W / 8 - 1 : 7;
  return r * W + ((c ^ (r & M)) << 3);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [0, rows) of a (rows, W) tile: row r < live from src + r * stride
// (elements), the rest zeros.
template <int W>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, size_t stride, int live,
                                           int rows) {
  constexpr int CH = W / 8;
  for (int i = threadIdx.x; i < rows * CH; i += TC_THREADS) {
    const int r = i / CH, c = i - r * CH;
    const bool in = r < live;
    cp_async16(dst + swz<W>(r, c), src + (in ? r * stride + c * 8 : 0), in ? 16 : 0);
  }
}

// One head's log decay and log gate over the chunk's rows (at + r * H),
// zeros past the live rows.
__device__ __forceinline__ void stage_rows(float* dec, float* gate, const float* ld,
                                           const float* lg, size_t at, int H, int live,
                                           int rows) {
  for (int r = threadIdx.x; r < rows; r += TC_THREADS) {
    const bool in = r < live;
    const size_t o = in ? at + (size_t)r * H : at;
    cp_async4(dec + r, ld + o, in ? 4 : 0);
    cp_async4(gate + r, lg + o, in ? 4 : 0);
  }
}

// Once a head's rows have landed: dec becomes the inclusive cumsum of the
// decay over the chunk (one warp, four rows a lane, then a scan across the
// lanes; rows <= 128), and the gate of each row past the live ones -1e30,
// the reference's identity steps.  The caller syncs after.
__device__ __forceinline__ void prepare_rows(float* dec, float* gate, int live, int rows) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    const int r0 = tid * 4;
    float loc[4];
    float run = 0.f;
    for (int e = 0; e < 4; ++e) {
      run += (r0 + e < rows) ? dec[r0 + e] : 0.f;
      loc[e] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += o;
    }
    const float excl = incl - run;
    for (int e = 0; e < 4; ++e)
      if (r0 + e < rows) dec[r0 + e] = excl + loc[e];
  }
  for (int r = live + tid; r < rows; r += TC_THREADS) gate[r] = PAD_GATE;
}

// x0, x1 (fp32) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), packed
// the way an mma fragment register holds two neighbours (x0 low).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// ---- fragment loaders, for a warp; t a staged tile of W bf16 a row ------
// The A operand (16 x 16) of rows r0 .. r0 + 15 at k16 step kc of a tile
// stored [row][k].
template <int W>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int r0, int kc) {
  const int lane = threadIdx.x % 32, mi = lane >> 3;
  ldsm_x4(a, t + swz<W>(r0 + (lane & 7) + ((mi & 1) << 3), 2 * kc + (mi >> 1)));
}

// The B operands of rows n0 .. n0 + 7 (b[0], b[1]) and n0 + 8 .. (b[2],
// b[3]) at k16 step kc of a tile stored [n][k].
template <int W>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* t, int n0, int kc) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, t + swz<W>(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kc + ((lane >> 3) & 1)));
}

// The B operands of columns 8 dn .. (b[0], b[1]) and 8 (dn + 1) .. (b[2],
// b[3]) at rows k0 .. k0 + 15 of a tile stored [k][n].
template <int W>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* t, int k0, int dn) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, t + swz<W>(k0 + ((lane >> 3) & 1) * 8 + (lane & 7), dn + (lane >> 4)));
}

// The A operand (16 x 16) of the transpose of a tile stored [k][m]: rows m
// = 16 sm .. of it, k = k0 ..; registers 0-3 hold (m = g, k = 2cq, 2cq +
// 1), (g + 8, the same k), (g, k + 8), (g + 8, k + 8).
template <int W>
__device__ __forceinline__ void frag_at(uint32_t (&a)[4], const bf16* t, int k0, int sm) {
  const int lane = threadIdx.x % 32, mi = lane >> 3;
  ldsm_x4_trans(a, t + swz<W>(k0 + (lane & 7) + ((mi >> 1) << 3), 2 * sm + (mi & 1)));
}

// frag_at's operand with each k's column scaled by w[k] (fp32), as bf16
// hi and lo: the A operand of (t o w)^T.
template <int W>
__device__ __forceinline__ void frag_at_scaled(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const bf16* t, const float* w, int k0, int sm) {
  const int cq = threadIdx.x % 4;
  uint32_t a[4];
  frag_at<W>(a, t, k0, sm);
  const float w0 = w[k0 + 2 * cq], w1 = w[k0 + 2 * cq + 1];
  const float w8 = w[k0 + 2 * cq + 8], w9 = w[k0 + 2 * cq + 9];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a[r]);
    const float wl = r < 2 ? w0 : w8, wh = r < 2 ? w1 : w9;
    split2(__low2float(x) * wl, __high2float(x) * wh, hi[r], lo[r]);
  }
}

}  // namespace ssd_tile
