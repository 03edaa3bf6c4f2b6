// Tensor-core core of the attention kernels (flash_attention.cu's and
// paged_prefill_attention.cu's mma bodies, the split body of the decode
// kernels in decode_split.cuh): mma.sync m16n8k16 on bf16 operands with
// fp32 accumulators, fragments read with ldmatrix from XOR-swizzled shared
// memory, and the reference's online-softmax step on a 64-key tile held in
// registers.  The kernels differ only in how they stage K/V rows (a
// contiguous cache, or pool rows through a block table) and which scores
// they mask.  conv2d.cu's tensor-core body uses the fragment helpers, the
// swizzle and the .f16 form of the product.
#pragma once

#include "paged_attention.cuh"

namespace mma_attn {

using paged::NEG_INF;

constexpr int MMA_THREADS = 128;  // four warps, 16 query rows each
constexpr int TILE_ROWS = 64;     // query rows per block
constexpr int KV_ROWS = 64;       // K/V rows of one staged tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk c of row r in a staged (KV_ROWS, D)
// tile: the chunk index is XORed with the row's low 3 bits, so the eight
// rows an ldmatrix reads at one chunk fall in eight different bank groups.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// 16 bytes from global to shared memory, asynchronously; `bytes` = 0 reads
// nothing and fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Rows [0, KV_ROWS) of a K and a V tile of pool rows, read through one
// sequence's block table: tile row r is key base + r, at pool row
// (table[j / bs] * bs + j % bs) of kv head kv.  Keys at or past kv_end are
// neither looked up nor read: their rows are filled with zeros (an
// unwritten pool row may hold NaN, and 0 x NaN is NaN on the tensor
// cores).  Table entries outside the pool read block 0.
template <int D>
__device__ __forceinline__ void stage_paged(__nv_bfloat16* dk, __nv_bfloat16* dv,
                                            const __nv_bfloat16* k_pool,
                                            const __nv_bfloat16* v_pool,
                                            const int32_t* __restrict__ table, int base,
                                            int kv_end, int bs, int K, int kv, int N) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < KV_ROWS * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i - r * CH;
    const int j = base + r;
    const bool live = j < kv_end;
    size_t at = (size_t)c * 8;
    if (live) {
      int pb = __ldg(table + j / bs);
      if (pb < 0 || pb >= N) pb = 0;   // never read outside the pool
      at += (((size_t)pb * bs + j % bs) * K + kv) * D;
    }
    cp_async16(dk + swz<D>(r, c), k_pool + at, live ? 16 : 0);
    cp_async16(dv + swz<D>(r, c), v_pool + at, live ? 16 : 0);
  }
}

// Rows [0, KV_ROWS) of a K and a V tile of a contiguous (B, S, K, D)
// cache: tile row r is key base + r of sequence b, at ((b * S + j) * K +
// kv) * D.  Keys at or past kv_end are not read: their rows are filled with
// zeros (a cache row past the length may hold NaN).
template <int D>
__device__ __forceinline__ void stage_dense(__nv_bfloat16* dk, __nv_bfloat16* dv,
                                            const __nv_bfloat16* k, const __nv_bfloat16* v,
                                            int b, int S, int base, int kv_end, int K, int kv) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < KV_ROWS * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i - r * CH;
    const int j = base + r;
    const bool live = j < kv_end;
    size_t at = (size_t)c * 8;
    if (live) at += (((size_t)b * S + j) * K + kv) * D;
    cp_async16(dk + swz<D>(r, c), k + at, live ? 16 : 0);
    cp_async16(dv + swz<D>(r, c), v + at, live ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16 x 8, fp32) += a (16 x 16) b (16 x 8), bf16 operands
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same product on fp16 operands
__device__ __forceinline__ void mma16816_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of m16n8k16 (g = lane / 4, c = lane % 4): A registers
// 0-3 hold (row g, cols 2c..2c+1), (g + 8, 2c..), (g, 2c + 8..), (g + 8,
// 2c + 8..); B registers 0-1 hold (rows 2c..2c+1, col g), (2c + 8.., g);
// the accumulator holds (g, 2c..2c+1) and (g + 8, 2c..2c+1).
//
// A thread's part of a warp's 16 query rows: its rows a = g and b = g + 8,
// their output accumulators (cols 2c, 2c + 1 of each n8 block of D), and
// each row's running max and (this thread's share of the) sum.
template <int D>
struct Rows {
  float o[D / 8][4];
  float m_a, m_b, l_a, l_b;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    m_a = m_b = NEG_INF;
    l_a = l_b = 0.f;
  }
};

// Q rows qa and qb (this thread's rows a and b; null: past the rows) as A
// fragments of the k16 steps over D, zeros past the rows.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4], const __nv_bfloat16* qa,
                                       const __nv_bfloat16* qb) {
  const int cq = threadIdx.x % 4;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int d = 16 * kc + 2 * cq;
    qf[kc][0] = qa ? ld32(qa + d) : 0u;
    qf[kc][1] = qb ? ld32(qb + d) : 0u;
    qf[kc][2] = qa ? ld32(qa + d + 8) : 0u;
    qf[kc][3] = qb ? ld32(qb + d + 8) : 0u;
  }
}

// One staged tile of KV_ROWS keys (kt, vt: swizzled, keys base ..), for a
// warp's 16 query rows: S = Q K^T on the tensor cores; each raw score
// through score(raw, key, pos) -- scale, softcap, mask to NEG_INF -- with
// pos the row's position (pa for row a, pb for row b); then the online-
// softmax update of the reference (m_new, m_safe, p = exp(s - m_safe),
// corr, l) and O += P V, p rounded to bf16 in registers as the A operand.
template <int D, typename Score>
__device__ __forceinline__ void tile_step(Rows<D>& st, const uint32_t (&qf)[D / 16][4],
                                          const __nv_bfloat16* kt, const __nv_bfloat16* vt,
                                          int base, int pa, int pb, Score score) {
  constexpr int KC = D / 16;        // k16 steps of QK^T
  constexpr int DN = D / 8;         // n8 blocks of the output
  constexpr int KN = KV_ROWS / 8;   // n8 blocks of a score tile
  const int lane = threadIdx.x % 32, cq = lane % 4;

  // S = Q K^T on the tensor cores, 16 rows x 64 keys a warp
  float sc[KN][4];
#pragma unroll
  for (int nb = 0; nb < KN; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; kc += 2) {
#pragma unroll
    for (int nb = 0; nb < KN; ++nb) {
      uint32_t bk[4];   // B of k16 steps kc and kc + 1 for keys nb * 8 ..
      const int key = nb * 8 + (lane & 7);
      ldsm_x4(bk, kt + swz<D>(key, 2 * kc + (lane >> 3)));
      mma16816(sc[nb], qf[kc], bk[0], bk[1]);
      mma16816(sc[nb], qf[kc + 1], bk[2], bk[3]);
    }
  }
  // scale, mask, and the online-softmax update of the reference: m_new,
  // m_safe, p = exp(s - m_safe), corr, l
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int nb = 0; nb < KN; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = base + nb * 8 + 2 * cq + (e & 1);
      sc[nb][e] = score(sc[nb][e], key, e < 2 ? pa : pb);
    }
    mx_a = fmaxf(mx_a, fmaxf(sc[nb][0], sc[nb][1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[nb][2], sc[nb][3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {   // the four threads of a row
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(st.m_a, mx_a), mn_b = fmaxf(st.m_b, mx_b);
  const float ms_a = fmaxf(mn_a, NEG_INF / 2), ms_b = fmaxf(mn_b, NEG_INF / 2);
  const float corr_a = __expf(fminf(st.m_a - mn_a, 0.f));
  const float corr_b = __expf(fminf(st.m_b - mn_b, 0.f));
  st.m_a = mn_a;
  st.m_b = mn_b;
  uint32_t pf[KN / 2][4];   // p rounded to bf16: the A fragments of P V
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int nb = 0; nb < KN; ++nb) {
    const float p0 = __expf(sc[nb][0] - ms_a), p1 = __expf(sc[nb][1] - ms_a);
    const float p2 = __expf(sc[nb][2] - ms_b), p3 = __expf(sc[nb][3] - ms_b);
    sum_a += p0 + p1;
    sum_b += p2 + p3;
    pf[nb / 2][(nb & 1) * 2] = pack_bf16(p0, p1);
    pf[nb / 2][(nb & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
  st.l_a = st.l_a * corr_a + sum_a;
  st.l_b = st.l_b * corr_b + sum_b;
#pragma unroll
  for (int i = 0; i < DN; ++i) {
    st.o[i][0] *= corr_a;
    st.o[i][1] *= corr_a;
    st.o[i][2] *= corr_b;
    st.o[i][3] *= corr_b;
  }
  // O += P V on the tensor cores; V's B fragments through ldmatrix.trans
#pragma unroll
  for (int j = 0; j < KN / 2; ++j) {
#pragma unroll
    for (int dn = 0; dn < DN; dn += 2) {
      uint32_t bv[4];   // B of d blocks dn and dn + 1 for keys 16 j ..
      const int key = 16 * j + ((lane >> 3) & 1) * 8 + (lane & 7);
      ldsm_x4_trans(bv, vt + swz<D>(key, dn + (lane >> 4)));
      mma16816(st.o[dn], pf[j], bv[0], bv[1]);
      mma16816(st.o[dn + 1], pf[j], bv[2], bv[3]);
    }
  }
}

// The sum over the four threads of a row, acc / max(l, 1e-30) rounded to
// bf16, written to rows oa and ob (null: past the rows).
template <int D>
__device__ __forceinline__ void store_rows(Rows<D>& st, __nv_bfloat16* oa,
                                           __nv_bfloat16* ob) {
  const int cq = threadIdx.x % 4;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    st.l_a += __shfl_xor_sync(0xffffffffu, st.l_a, off);
    st.l_b += __shfl_xor_sync(0xffffffffu, st.l_b, off);
  }
  const float den_a = fmaxf(st.l_a, 1e-30f), den_b = fmaxf(st.l_b, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int d = 8 * i + 2 * cq;
    if (oa)
      *reinterpret_cast<uint32_t*>(oa + d) = pack_bf16(st.o[i][0] / den_a, st.o[i][1] / den_a);
    if (ob)
      *reinterpret_cast<uint32_t*>(ob + d) = pack_bf16(st.o[i][2] / den_b, st.o[i][3] / den_b);
  }
}

}  // namespace mma_attn
