// Dense (causal) flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
// (def :75, body _flash_kernel :25, pallas_call :87).  It computes the
// same function: q (B, S, H, D) against k, v (B, S, K, D), GQA with
// G = H / K query heads per kv head, scale 1/sqrt(D), causal (k_pos <=
// q_pos) or not, online softmax in fp32 with the Pallas kernel's NEG_INF,
// m_safe and l >= 1e-30, p rounded to the input type before the PV
// product.  Any S: the ragged edge is masked, where the Pallas kernel
// asserts S % 512 == 0.
//
// What bounds it on an H100: operations.  zamba2-1.2b's shared-block
// prefill at S=1000 (H=K=32, D=64, bf16) does ~4.1 GFLOP of causal QK^T
// and PV on ~16 MB: 0.004 ms at the 989 TFLOP/s bf16 tensor-core rate,
// 0.005 ms of bytes.
//
// Two bodies; the caller (kernels/flash_attention/ops.py::body_for) picks
// one from the type and D before the launch.  Both keep one thread block
// per (sequence, kv head, tile of 64 query rows of the S * G rows of that
// kv head; row r is position r / G of query head kv * G + r % G), and turn
// the Pallas grid's sequential KV axis into a loop inside the block over
// 64-row K/V tiles, up to the diagonal when causal.
//
// 1. FMA (fp32, and bf16 at a D other than 64 and 128): the paged prefill
//    kernel with a trivial block table and q_start = 0, sharing
//    paged_attention.cuh with it.  K/V rows are staged in shared memory
//    with 16-byte loads; scores, running max / sum and the accumulator
//    stay fp32 in shared memory; plain FMA on the CUDA cores.
// 2. Tensor cores (bf16, D = 64 or 128), the flash-attention-2 layout:
//    - four warps, each owning 16 query rows, Q held in registers as
//      mma.sync m16n8k16 A fragments;
//    - K/V tiles of 64 rows double-buffered with cp.async (the next tile
//      loads while this one is used), XOR-swizzled by 16-byte chunk and
//      read with ldmatrix (.trans for V);
//    - S = Q K^T and O += P V on the tensor cores, fp32 accumulators;
//    - the row max and sum in registers, reduced over the four threads of
//      a row with shuffles; p rounded to bf16 in registers as the next A
//      operand;
//    - tiles past the diagonal are never visited; the diagonal tile (and
//      the ragged edge past S) is masked to NEG_INF.
#include "paged_attention.cuh"

namespace {

using namespace paged;

constexpr int TILE_ROWS = 64;   // query rows per block
constexpr int KV_TILE = 64;     // K/V rows staged per step

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q,     // (B, S, H, D)
    const T* __restrict__ k,     // (B, S, K, D)
    const T* __restrict__ v,     // (B, S, K, D)
    T* __restrict__ out,         // (B, S, H, D)
    int S, int H, int K, int D, int causal, float scale) {
  const int b = blockIdx.x, kv = blockIdx.y, tid = threadIdx.x;
  const int G = H / K;
  const int r0 = blockIdx.z * TILE_ROWS;
  const int nr = min(TILE_ROWS, S * G - r0);
  extern __shared__ __align__(16) unsigned char smem[];
  T* kblk = reinterpret_cast<T*>(smem);          // (KV_TILE, D)
  T* vblk = kblk + (size_t)KV_TILE * D;          // (KV_TILE, D)
  float* qs = reinterpret_cast<float*>(vblk + (size_t)KV_TILE * D);  // (TILE_ROWS, D)
  float* acc = qs + TILE_ROWS * D;               // (TILE_ROWS, D)
  float* sc = acc + TILE_ROWS * D;               // (TILE_ROWS, KV_TILE)
  float* m_s = sc + TILE_ROWS * KV_TILE;         // (TILE_ROWS,)
  float* l_s = m_s + TILE_ROWS;
  float* corr_s = l_s + TILE_ROWS;

  for (int i = tid; i < nr * D; i += blockDim.x) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr, s = r / G, g = r - s * G;
    qs[i] = to_f(q[(((size_t)b * S + s) * H + (size_t)kv * G + g) * D + d]);
    acc[i] = 0.f;
  }
  for (int rr = tid; rr < nr; rr += blockDim.x) {
    m_s[rr] = NEG_INF;
    l_s[rr] = 0.f;
  }
  // with causality no row of this tile sees a key past its last position
  const int kv_end = causal ? min(S, (r0 + nr - 1) / G + 1) : S;
  const int ntile = (kv_end + KV_TILE - 1) / KV_TILE;
  const size_t row_stride = (size_t)K * D;

  for (int it = 0; it < ntile; ++it) {
    const int base = it * KV_TILE;
    const int nrows = min(KV_TILE, kv_end - base);
    const size_t at = (((size_t)b * S + base) * K + kv) * D;
    __syncthreads();  // the previous tile's rows and scores are consumed
    stage_rows(kblk, k + at, nrows, D, row_stride);
    stage_rows(vblk, v + at, nrows, D, row_stride);
    __syncthreads();
    for (int i = tid; i < nr * KV_TILE; i += blockDim.x) {
      const int rr = i / KV_TILE, j = i - rr * KV_TILE;
      const int q_pos = (r0 + rr) / G, k_pos = base + j;
      float s = NEG_INF;
      if (j < nrows && (!causal || k_pos <= q_pos))
        s = dot_row(qs + rr * D, kblk + (size_t)j * D, D, j) * scale;
      sc[i] = s;
    }
    __syncthreads();
    for (int rr = tid; rr < nr; rr += blockDim.x)
      corr_s[rr] = softmax_update<T>(sc + rr * KV_TILE, KV_TILE, m_s[rr], l_s[rr]);
    __syncthreads();
    for (int i = tid; i < nr * D; i += blockDim.x) {
      const int rr = i / D, d = i - rr * D;
      const float* p = sc + rr * KV_TILE;
      float pv = 0.f;
      for (int j = 0; j < nrows; ++j) pv = fmaf(p[j], to_f(vblk[(size_t)j * D + d]), pv);
      acc[i] = acc[i] * corr_s[rr] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += blockDim.x) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr, s = r / G, g = r - s * G;
    out[(((size_t)b * S + s) * H + (size_t)kv * G + g) * D + d] =
        from_f<T>(acc[i] / fmaxf(l_s[rr], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int K, int D, int causal, float scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = 2 * (size_t)KV_TILE * D * sizeof(T) +
                      ((size_t)2 * TILE_ROWS * D + (size_t)TILE_ROWS * KV_TILE +
                       3 * TILE_ROWS) * sizeof(float);
  auto kernel = flash_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B, K, (S * G + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, K, D, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Body 2: tensor cores (mma.sync m16n8k16), bf16, D = 64 or 128
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // four warps, 16 query rows each
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

// Rows [0, nrows) of a K or V tile into shared memory with cp.async (16
// bytes each); rows past nrows are filled with zeros.
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int nrows, size_t row_stride) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < KV_ROWS * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i - r * CH;
    const bool live = r < nrows;
    const __nv_bfloat16* g = src + (live ? (size_t)r * row_stride : 0) + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(dst + swz<D>(r, c))),
                 "l"(g), "r"(live ? 16 : 0)
                 : "memory");
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
template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, S, H, D)
    const __nv_bfloat16* __restrict__ k,   // (B, S, K, D)
    const __nv_bfloat16* __restrict__ v,   // (B, S, K, D)
    __nv_bfloat16* __restrict__ out,       // (B, S, H, D)
    int S, int H, int K, int causal, float scale) {
  constexpr int KC = D / 16;        // k16 steps of QK^T
  constexpr int DN = D / 8;         // n8 blocks of the output
  constexpr int KN = KV_ROWS / 8;   // n8 blocks of a score tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][KV_ROWS * D]
  __nv_bfloat16* vs = ks + 2 * KV_ROWS * D;                      // [2][KV_ROWS * D]

  const int b = blockIdx.x, kv = blockIdx.y, G = H / K;
  const int rows = S * G;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * TILE_ROWS;   // longest causal rows first
  const int nr = min(TILE_ROWS, rows - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, cq = lane % 4;
  const int ra = r0 + warp * 16 + gq, rb = ra + 8;           // this thread's two rows
  const int pa = ra / G, pb = rb / G;                        // their positions
  auto head_row = [&](int r) -> size_t {   // element offset of row r's head in q / out
    const int s = r / G, g = r - s * G;
    return (((size_t)b * S + s) * H + (size_t)kv * G + g) * D;
  };

  uint32_t qf[KC][4];                 // Q as A fragments, zeros past the rows
  {
    const __nv_bfloat16* qa = ra < rows ? q + head_row(ra) : nullptr;
    const __nv_bfloat16* qb = rb < rows ? q + head_row(rb) : nullptr;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int d = 16 * kc + 2 * cq;
      qf[kc][0] = qa ? ld32(qa + d) : 0u;
      qf[kc][1] = qb ? ld32(qb + d) : 0u;
      qf[kc][2] = qa ? ld32(qa + d + 8) : 0u;
      qf[kc][3] = qb ? ld32(qb + d + 8) : 0u;
    }
  }

  // with causality no row of this tile sees a key past its last position
  const int kv_end = causal ? min(S, (r0 + nr - 1) / G + 1) : S;
  const int ntiles = (kv_end + KV_ROWS - 1) / KV_ROWS;
  const size_t row_stride = (size_t)K * D;
  const __nv_bfloat16* kbase = k + ((size_t)b * S * K + kv) * D;
  const __nv_bfloat16* vbase = v + ((size_t)b * S * K + kv) * D;

  float o[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;   // l: this thread's part

  stage_tile<D>(ks, kbase, min(KV_ROWS, kv_end), row_stride);
  stage_tile<D>(vs, vbase, min(KV_ROWS, kv_end), row_stride);
  asm volatile("cp.async.commit_group;" ::: "memory");

  for (int tile = 0; tile < ntiles; ++tile) {
    const int base = tile * KV_ROWS, buf = tile & 1;
    if (tile + 1 < ntiles) {
      const int next = base + KV_ROWS, n = min(KV_ROWS, kv_end - next);
      stage_tile<D>(ks + (buf ^ 1) * KV_ROWS * D, kbase + next * row_stride, n, row_stride);
      stage_tile<D>(vs + (buf ^ 1) * KV_ROWS * D, vbase + next * row_stride, n, row_stride);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");   // this tile has landed
    __syncthreads();
    const __nv_bfloat16* kt = ks + buf * KV_ROWS * D;
    const __nv_bfloat16* vt = vs + buf * KV_ROWS * D;

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
    // scale, mask (causal, ragged edge), and the online-softmax update of
    // the reference: m_new, m_safe, p = exp(s - m_safe), corr, l
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int nb = 0; nb < KN; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = base + nb * 8 + 2 * cq + (e & 1);
        const int pos = e < 2 ? pa : pb;
        float s = sc[nb][e] * scale;
        if (key >= S || (causal && key > pos)) s = NEG_INF;
        sc[nb][e] = s;
      }
      mx_a = fmaxf(mx_a, fmaxf(sc[nb][0], sc[nb][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[nb][2], sc[nb][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {   // the four threads of a row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float ms_a = fmaxf(mn_a, NEG_INF / 2), ms_b = fmaxf(mn_b, NEG_INF / 2);
    const float corr_a = __expf(fminf(m_a - mn_a, 0.f));
    const float corr_b = __expf(fminf(m_b - mn_b, 0.f));
    m_a = mn_a;
    m_b = mn_b;
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
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int i = 0; i < DN; ++i) {
      o[i][0] *= corr_a;
      o[i][1] *= corr_a;
      o[i][2] *= corr_b;
      o[i][3] *= corr_b;
    }
    // O += P V on the tensor cores; V's B fragments through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < KN / 2; ++j) {
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t bv[4];   // B of d blocks dn and dn + 1 for keys 16 j ..
        const int key = 16 * j + ((lane >> 3) & 1) * 8 + (lane & 7);
        ldsm_x4_trans(bv, vt + swz<D>(key, dn + (lane >> 4)));
        mma16816(o[dn], pf[j], bv[0], bv[1]);
        mma16816(o[dn + 1], pf[j], bv[2], bv[3]);
      }
    }
    __syncthreads();   // this buffer is consumed before it is staged again
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* oa = ra < rows ? out + head_row(ra) : nullptr;
  __nv_bfloat16* ob = rb < rows ? out + head_row(rb) : nullptr;
#pragma unroll
  for (int i = 0; i < DN; ++i) {
    const int d = 8 * i + 2 * cq;
    if (oa) *reinterpret_cast<uint32_t*>(oa + d) = pack_bf16(o[i][0] / den_a, o[i][1] / den_a);
    if (ob) *reinterpret_cast<uint32_t*>(ob + d) = pack_bf16(o[i][2] / den_b, o[i][3] / den_b);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
               int K, int causal, float scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = 4 * (size_t)KV_ROWS * D * sizeof(__nv_bfloat16);
  auto kernel = flash_mma_kernel<D>;
  static bool ready = false;
  if (!ready && smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(B, K, (S * G + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, H, K,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  body: 0
// the FMA body (any D), 1 the tensor-core body (bf16, D = 64 or 128).
// Returns 0 or the CUDA error of the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int dtype, int B, int S, int H, int K, int D, int causal,
                               float scale, int body, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D == 64) return launch_mma<64>(q, k, v, out, B, S, H, K, causal, scale, s);
    if (D == 128) return launch_mma<128>(q, k, v, out, B, S, H, K, causal, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, K, D, causal, scale, s);
  return launch<float>(q, k, v, out, B, S, H, K, D, causal, scale, s);
}
