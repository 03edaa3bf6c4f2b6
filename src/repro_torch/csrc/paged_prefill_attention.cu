// Paged prefill attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/prefill_attention/kernel.py::paged_prefill_attention
// (def :90, body _prefill_kernel :30, pallas_call :146).  It computes the
// same function: C query rows per sequence at absolute positions
// q_start[b] .. q_start[b]+C-1 against the paged KV pool read through the
// block table, masked by k_pos <= q_pos and k_pos < lengths[b] -- seeded
// blocks are attended in full, the chunk's own rows triangularly.  GQA rows
// are laid out (K, C*G) per kv head: row r of kv head kv is chunk row r / G
// of query head kv*G + r % G.  Scale, softcap and the online softmax are as
// in the decode kernel, and so is an int8 pool (the Pallas body's quant
// branch): each staged row dequantized to q's type, float(int8) * scale in
// one fp32 multiply and one rounding, before both products.
//
// What bounds it on an H100: at the shapes serving gives it the two bounds
// are close.  A 256-row chunk of qwen2.5-3b at q_start 256 must move 2.6 MB
// (q, out, 512 live K/V rows: 0.78 us at 3.35 TB/s) and do 0.81 GFLOP of
// causal QK^T and PV (0.82 us at the 989 TFLOP/s bf16 peak); a longer
// seeded history tips it to bytes, a longer chunk to operations.
//
// Two bodies; the caller (kernels/prefill_attention/ops.py::body_for) picks
// one from the type and D before the launch.
//
// 1. FMA (fp32, and bf16 at a D other than 64 and 128), the first
//    version: one thread block per (sequence, kv head, tile of 32 query
//    rows of the C*G); the Pallas grid's sequential block axis becomes a
//    loop over pool blocks up to cdiv(min(lengths[b], last q_pos of the
//    tile + 1), bs) -- table entries past that are trash or unwritten and
//    never dereferenced.  K/V rows are staged in shared memory with
//    16-byte loads (from an int8 pool: dequantized on the way); scores,
//    running max / sum and the accumulator are fp32, and plain FMA does
//    the products.
// 2. Tensor cores (bf16, D = 64 or 128): the dense flash kernel's mma body
//    (mma_attention.cuh, shared with it) on a paged K/V loader.  One block
//    of four warps per (sequence, kv head, tile of 64 of the C*G rows),
//    the longest causal rows first; Q in registers as m16n8k16 A
//    fragments; S = Q K^T and O += P V on mma.sync with fp32 accumulators,
//    the row max and sum over each quad with shuffles, p rounded to bf16
//    in registers.  A 64-key tile spans 64 / bs pool blocks: each key row
//    is found through the block table and copied with cp.async into the
//    XOR-swizzled double buffer that ldmatrix(.trans) reads, the next tile
//    loading while this one is used.  Keys at or past kv_end = min(
//    lengths[b], last q_pos of the tile + 1) are neither looked up nor
//    read: their rows are zero-filled, since an unwritten pool row can
//    hold NaN and 0 x NaN is NaN on the tensor cores.  Tiles wholly past
//    kv_end are never visited.  With a trivial table, q_start = 0 and
//    lengths = C, the pool is the dense kernel's cache and the two bodies
//    agree bit for bit.  From an int8 pool (QuantTiles) each 16-byte piece
//    of 16 values and its row's scale are loaded into registers and stored
//    dequantized into the same swizzled tile: the next tile is staged
//    before this one is used, but is not in flight while it is.
#include <type_traits>

#include "mma_attention.cuh"

namespace {

using namespace paged;

constexpr int TILE_ROWS = 32;

// T: q's (and out's) type; P: the pool's, T or int8_t (then with scales)
template <typename T, typename P>
__global__ void __launch_bounds__(THREADS) paged_prefill_kernel(
    const T* __restrict__ q,              // (B, C, H, D)
    const P* __restrict__ k_pool,         // (N, bs, K, D)
    const P* __restrict__ v_pool,         // (N, bs, K, D)
    const float* __restrict__ k_scale,    // (N, bs, K), int8 pools only
    const float* __restrict__ v_scale,    // (N, bs, K), int8 pools only
    const int32_t* __restrict__ tables,   // (B, mb)
    const int32_t* __restrict__ q_start,  // (B,)
    const int32_t* __restrict__ lengths,  // (B,)
    T* __restrict__ out,                  // (B, C, H, D)
    int C, int H, int K, int D, int bs, int mb, int N, float scale, float softcap) {
  const int b = blockIdx.x, kv = blockIdx.y, tid = threadIdx.x;
  const int G = H / K;
  const int r0 = blockIdx.z * TILE_ROWS;
  const int nr = min(TILE_ROWS, C * G - r0);
  extern __shared__ __align__(16) unsigned char smem[];
  T* kblk = reinterpret_cast<T*>(smem);          // (bs, D)
  T* vblk = kblk + (size_t)bs * D;               // (bs, D)
  float* qs = reinterpret_cast<float*>(vblk + (size_t)bs * D);  // (TILE_ROWS, D)
  float* acc = qs + TILE_ROWS * D;               // (TILE_ROWS, D)
  float* sc = acc + TILE_ROWS * D;               // (TILE_ROWS, bs)
  float* m_s = sc + TILE_ROWS * bs;              // (TILE_ROWS,)
  float* l_s = m_s + TILE_ROWS;
  float* corr_s = l_s + TILE_ROWS;

  for (int i = tid; i < nr * D; i += blockDim.x) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr, c = r / G, g = r - c * G;
    qs[i] = to_f(q[(((size_t)b * C + c) * H + (size_t)kv * G + g) * D + d]);
    acc[i] = 0.f;
  }
  for (int rr = tid; rr < nr; rr += blockDim.x) {
    m_s[rr] = NEG_INF;
    l_s[rr] = 0.f;
  }
  const int start = q_start[b];
  const int len = lengths[b];
  // no row of this tile sees a key past its last query position
  const int kv_end = min(len, start + (r0 + nr - 1) / G + 1);
  int nblk = kv_end > 0 ? (kv_end + bs - 1) / bs : 0;
  if (nblk > mb) nblk = mb;
  const size_t row_stride = (size_t)K * D;

  for (int ib = 0; ib < nblk; ++ib) {
    int pb = tables[(size_t)b * mb + ib];
    if (pb < 0 || pb >= N) pb = 0;  // never read outside the pool
    const int nrows = min(bs, kv_end - ib * bs);
    const size_t base = ((size_t)pb * bs * K + kv) * D;
    __syncthreads();
    if constexpr (std::is_same<P, int8_t>::value) {
      const size_t srow = (size_t)pb * bs * K + kv;   // row 0's scale
      stage_rows_i8(kblk, k_pool + base, k_scale + srow, nrows, D, row_stride, K);
      stage_rows_i8(vblk, v_pool + base, v_scale + srow, nrows, D, row_stride, K);
    } else {
      stage_rows(kblk, k_pool + base, nrows, D, row_stride);
      stage_rows(vblk, v_pool + base, nrows, D, row_stride);
    }
    __syncthreads();
    for (int i = tid; i < nr * bs; i += blockDim.x) {
      const int rr = i / bs, j = i - rr * bs;
      const int q_pos = start + (r0 + rr) / G;
      const int k_pos = ib * bs + j;
      float s = NEG_INF;
      if (j < nrows && k_pos <= q_pos && k_pos < len) {
        s = dot_row(qs + rr * D, kblk + (size_t)j * D, D, j) * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      sc[i] = s;
    }
    __syncthreads();
    for (int rr = tid; rr < nr; rr += blockDim.x)
      corr_s[rr] = softmax_update<T>(sc + rr * bs, bs, m_s[rr], l_s[rr]);
    __syncthreads();
    for (int i = tid; i < nr * D; i += blockDim.x) {
      const int rr = i / D, d = i - rr * D;
      const float* p = sc + rr * bs;
      float pv = 0.f;
      for (int j = 0; j < nrows; ++j) pv = fmaf(p[j], to_f(vblk[(size_t)j * D + d]), pv);
      acc[i] = acc[i] * corr_s[rr] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += blockDim.x) {
    const int rr = i / D, d = i - rr * D;
    const int r = r0 + rr, c = r / G, g = r - c * G;
    out[(((size_t)b * C + c) * H + (size_t)kv * G + g) * D + d] =
        from_f<T>(acc[i] / fmaxf(l_s[rr], 1e-30f));
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* tables, const void* q_start, const void* lengths,
           void* out, int B, int C, int H, int K, int D, int bs, int mb, int N, float scale,
           float softcap, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = 2 * (size_t)bs * D * sizeof(T) +
                      ((size_t)2 * TILE_ROWS * D + (size_t)TILE_ROWS * bs + 3 * TILE_ROWS) *
                          sizeof(float);
  auto kernel = paged_prefill_kernel<T, P>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B, K, (C * G + TILE_ROWS - 1) / TILE_ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool), static_cast<const P*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(q_start),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), C, H, K, D, bs, mb, N,
      scale, softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Body 2: tensor cores (mma.sync m16n8k16), bf16, D = 64 or 128
// ---------------------------------------------------------------------------

using mma_attn::KV_ROWS;
using mma_attn::MMA_THREADS;

// A K and a V tile of 64 keys from a bf16 pool: key base + r at pool row
// (table[j / bs] * bs + j % bs), fetched with cp.async (mma_attn::stage_paged).
template <int D>
struct Tiles {
  const __nv_bfloat16* k_pool;   // (N, bs, K, D)
  const __nv_bfloat16* v_pool;   // (N, bs, K, D)
  int bs, K, N;

  __device__ __forceinline__ void stage(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                        const int32_t* table, int base, int kv_end,
                                        int kv) const {
    mma_attn::stage_paged<D>(ks, vs, k_pool, v_pool, table, base, kv_end, bs, K, kv, N);
  }
};

// The same tiles from an int8 pool, dequantized to bf16 as they are staged
// (mma_attn::stage_paged_i8, K1's split loader too).
template <int D>
struct QuantTiles {
  const int8_t* k_pool;   // (N, bs, K, D)
  const int8_t* v_pool;   // (N, bs, K, D)
  const float* k_scale;   // (N, bs, K)
  const float* v_scale;   // (N, bs, K)
  int bs, K, N;

  __device__ __forceinline__ void stage(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                        const int32_t* table, int base, int kv_end,
                                        int kv) const {
    mma_attn::stage_paged_i8<D>(ks, vs, k_pool, v_pool, k_scale, v_scale, table, base, kv_end,
                                bs, K, kv, N);
  }
};

template <int D, typename Loader>
__global__ void __launch_bounds__(MMA_THREADS) paged_prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, C, H, D)
    Loader tiles,                              // the pool's K / V tiles
    const int32_t* __restrict__ tables,        // (B, mb)
    const int32_t* __restrict__ q_start,       // (B,)
    const int32_t* __restrict__ lengths,       // (B,)
    __nv_bfloat16* __restrict__ out,           // (B, C, H, D)
    int C, int H, int K, int bs, int mb, float scale, float softcap) {
  constexpr int ROWS = mma_attn::TILE_ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][KV_ROWS * D]
  __nv_bfloat16* vs = ks + 2 * KV_ROWS * D;                      // [2][KV_ROWS * D]

  const int b = blockIdx.x, kv = blockIdx.y, G = H / K;
  const int rows = C * G;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * ROWS;   // longest causal rows first
  const int nr = min(ROWS, rows - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4;
  const int ra = r0 + warp * 16 + gq, rb = ra + 8;      // this thread's two rows
  const int start = q_start[b], len = lengths[b];
  const int pa = start + ra / G, pb = start + rb / G;   // their absolute positions
  auto head_row = [&](int r) -> size_t {   // element offset of row r's head in q / out
    const int c = r / G, g = r - c * G;
    return (((size_t)b * C + c) * H + (size_t)kv * G + g) * D;
  };

  uint32_t qf[D / 16][4];             // Q as A fragments, zeros past the rows
  mma_attn::load_q<D>(qf, ra < rows ? q + head_row(ra) : nullptr,
                      rb < rows ? q + head_row(rb) : nullptr);

  // no row of this tile sees a key past its last position, past
  // lengths[b], or past the table
  const int kv_end = min(min(len, start + (r0 + nr - 1) / G + 1), mb * bs);
  const int ntiles = kv_end > 0 ? (kv_end + KV_ROWS - 1) / KV_ROWS : 0;
  const int32_t* table = tables + (size_t)b * mb;
  // scale, softcap, then k_pos <= q_pos and k_pos < lengths[b]
  auto score = [&](float raw, int key, int pos) {
    float s = raw * scale;
    if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    if (key > pos || key >= len) s = NEG_INF;
    return s;
  };

  mma_attn::Rows<D> st;
  st.init();
  tiles.stage(ks, vs, table, 0, kv_end, kv);
  asm volatile("cp.async.commit_group;" ::: "memory");

  for (int tile = 0; tile < ntiles; ++tile) {
    const int base = tile * KV_ROWS, buf = tile & 1;
    if (tile + 1 < ntiles)
      tiles.stage(ks + (buf ^ 1) * KV_ROWS * D, vs + (buf ^ 1) * KV_ROWS * D, table,
                  base + KV_ROWS, kv_end, kv);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");   // this tile has landed
    __syncthreads();
    const __nv_bfloat16* kt = ks + buf * KV_ROWS * D;
    const __nv_bfloat16* vt = vs + buf * KV_ROWS * D;
    mma_attn::tile_step<D>(st, qf, kt, vt, base, pa, pb, score);
    __syncthreads();   // this buffer is consumed before it is staged again
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  mma_attn::store_rows<D>(st, ra < rows ? out + head_row(ra) : nullptr,
                          rb < rows ? out + head_row(rb) : nullptr);
}

template <int D, typename Loader>
int launch_mma(const void* q, Loader tiles, const void* tables, const void* q_start,
               const void* lengths, void* out, int B, int C, int H, int K, int bs, int mb,
               float scale, float softcap, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = 4 * (size_t)KV_ROWS * D * sizeof(__nv_bfloat16);
  auto kernel = paged_prefill_mma_kernel<D, Loader>;
  static bool ready = false;
  if (!ready && smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int ROWS = mma_attn::TILE_ROWS;
  const dim3 grid(B, K, (C * G + ROWS - 1) / ROWS);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), tiles, static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(q_start), static_cast<const int32_t*>(lengths),
      static_cast<__nv_bfloat16*>(out), C, H, K, bs, mb, scale, softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
               const void* v_scale, const void* tables, const void* q_start,
               const void* lengths, void* out, int pool, int B, int C, int H, int K, int bs,
               int mb, int N, float scale, float softcap, cudaStream_t stream) {
  if (pool == 1)
    return launch_mma<D>(
        q,
        QuantTiles<D>{static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool),
                      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                      bs, K, N},
        tables, q_start, lengths, out, B, C, H, K, bs, mb, scale, softcap, stream);
  return launch_mma<D>(q,
                       Tiles<D>{static_cast<const __nv_bfloat16*>(k_pool),
                                static_cast<const __nv_bfloat16*>(v_pool), bs, K, N},
                       tables, q_start, lengths, out, B, C, H, K, bs, mb, scale, softcap,
                       stream);
}

}  // namespace

// dtype: q's (and out's) type, 0 = float32, 1 = bfloat16.  pool: 0 = the
// pools are in q's type (k_scale / v_scale unused), 1 = int8 pools with
// fp32 scales (N, bs, K).  body: 0 the FMA body (any D), 1 the tensor-core
// body (bf16, D = 64 or 128).  Returns 0 or the CUDA error of the launch.
extern "C" int paged_prefill_attention(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scale, const void* v_scale,
                                       const void* tables, const void* q_start,
                                       const void* lengths, void* out, int dtype, int pool,
                                       int B, int C, int H, int K, int D, int bs, int mb,
                                       int N, float scale, float softcap, int body,
                                       void* stream) {
  if (B == 0 || C == 0) return 0;
  if (pool != 0 && pool != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D == 64)
      return launch_mma<64>(q, k_pool, v_pool, k_scale, v_scale, tables, q_start, lengths, out,
                            pool, B, C, H, K, bs, mb, N, scale, softcap, s);
    if (D == 128)
      return launch_mma<128>(q, k_pool, v_pool, k_scale, v_scale, tables, q_start, lengths,
                             out, pool, B, C, H, K, bs, mb, N, scale, softcap, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1 && pool == 1)
    return launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, q_start,
                                         lengths, out, B, C, H, K, D, bs, mb, N, scale, softcap,
                                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                                 q_start, lengths, out, B, C, H, K, D, bs, mb,
                                                 N, scale, softcap, s);
  if (pool == 1)
    return launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, q_start, lengths,
                                 out, B, C, H, K, D, bs, mb, N, scale, softcap, s);
  return launch<float, float>(q, k_pool, v_pool, k_scale, v_scale, tables, q_start, lengths,
                              out, B, C, H, K, D, bs, mb, N, scale, softcap, s);
}
