#!/usr/bin/env python3
"""How far ``chip_smoke.py``'s kernel gates (each kernel's ``tolerance``
in ``repro_torch.kernels.dispatch``) sit from a right kernel and from a
wrong one.  Run from the repository root:

    python3 kernel_gate_check.py          # on any host, CPU only
    python3 kernel_gate_check.py --card   # on a host with an NVIDIA card

CPU: chip_smoke's kernel cases at qwen2.5-3b widths (H=16, K=2, D=128,
block 16) on bf16 values, six seeds.  The CUDA kernels' round points are
emulated in fp32 PyTorch (``p`` rounded to bf16 before the PV product, the
output rounded to bf16) and held against the plain version evaluated in
fp32; printed are the largest err/limit of that emulation, of the same
emulation with one 16-row pool block lost, and of the plain version run
at bf16 (which also rounds scores and PV to bf16).  K1's split body is
emulated too: p rounded against each 64-key split's own max, the
partials merged in fp32 (``emulated_split``), printed beside the one-pass
emulation, and with one split lost.  Then K6 conv2d on
chip_smoke's gate shapes at batch 1: the plain version at fp16 / bf16 --
the kernel's own round points, an fp32 sum rounded once -- against it at
fp32, and the same with the FMA body's first 32-deep chunk of K lost.
Then K7 matmul on ``K7_GATE_CASES`` (chip_smoke's shapes, cut in M or N to
run on a CPU in seconds): a product summed in fp64 and rounded once to
the type (what a right kernel can at best return) against the plain
version in fp32, and the same with the first 32-deep slice of K lost.

``--card`` (``--card --only a.cu,b.cu``: only the mutants of those
sources): copies ``src/`` into a temporary directory and changes one
source file there (a kernel's ``.cu``, or a ``.cuh`` that several kernels
share), as ``MUTANTS`` lists: each paged attention kernel's FMA block loop
skips pool block 0 when more than two blocks are live; K2's tensor-core
body skips its first KV tile; the int8 tile loader that K1's split body
and K2's tensor-core body share (``mma_attention.cuh``) stages the first
row of each 64-key tile, or the whole first tile, without the rows'
scales (as if each were 1); the split body of the decode kernels
(``decode_split.cuh``, K1's and K3's) loses the first 16 rows of every
split, or its merge drops split 0's partial; the conv kernel's FMA body
loses its first 32-deep K chunk, its tensor-core body its first 64-deep
chunk, its split-K reduction slice 0's partial, or its loader (both
bodies) the centre tap of the window; the scan's (K5's) FMA body drops
the state carried into the next chunk, its tensor-core body drops it in
the state passing (phase (b)), or loses the lo half of the weighted
scores (Q K^T o W as bf16 hi alone: a precision loss, no lost term), and
its FMA body loses the first 64-column slice of N from the scores (all
of N where N <= 64), each of those four required to fail every case of
its body by 8x or more (the FMA body's: fp32 at zamba2's widths, fp32
and bf16 at xlstm-125m's N = 384, P = 385); each FMA mutant, and K7's
FMA one, must also fail chip_smoke's fp32 xlstm-125m path check (phase
23c) at every depth; the flash kernel (K4) skips the diagonal KV
tile, in its FMA body and in its tensor-core body, or, non-causal, takes
the keys' extent from q's length S instead of S_kv (both bodies; held on
chip_smoke's ``WHISPER_K4_CASES``, phase 28a, where every case with S !=
S_kv must fail); K4's backward skips
the diagonal q tile in its dK / dV pass or loses kv tile 0 in its dQ
pass, each in its FMA body and in its tensor-core body, whose P and dS
may also lose their lo halves (bf16 hi alone), or, non-causal, takes the
keys' extent from q's length S instead of S_kv (the dK / dV pass's grid
of key tiles and the dQ pass's walk, both bodies; held on chip_smoke's
``K4B_WHISPER_CASES``, phase 29a, with NaN right after k and v, where
every case with S != S_kv must fail); K5's backward drops the
gradient carried back over the chunks in the state pass its two bodies
share, or loses dq's inter-chunk term, in its FMA body and in its
tensor-core body, whose dy may also lose its lo halves; its FMA body's
sliced layout (N or P over 128) loses the last slice of P from the
scores' dy.v (the normalizer's one column at xlstm-125m's P = 385), or
its finish leaves partial 1 out of the cross-slice sums -- each FMA
mutant must also fail chip_smoke's ``XLSTM_BWD_CASES`` at xlstm-125m's
widths, fp32 and bf16, by 8x or more, and chip_smoke's phase 24b (the
xlstm training path check); K6's backward loses dgrad's parity test (at a stride,
a tap counts where it should not), drops its wgrad gather body's last
slice of pixels where it splits K, loses each slice's last K chunk in
its ring bodies (dgrad and wgrad, fp32 and fp16), or keeps the forward's
pads in the ring dgrad's flipped conv (held on the cases whose SAME pads
differ before and after); the dense decode
kernel's (K3's) FMA body skips the last live KV tile; the matmul kernel
(K7) loses its first 32-deep slice of K in its FMA body, or its first
64-deep K stage in its wgmma body; K7's batched entry (both bodies) reads
expert 0's weights for every expert, writes each expert's output a row
short of its stride, or skips the last expert, each held on chip_smoke's
``K7B_CASES`` at fp32 and bf16 (every case of more than one expert must
fail by 8x or more), on phase 25c, deepseek-moe-16b's fp32 path check
(``moe_path_gate``: 25c must fail, at one depth at least, its replayed
logits or MoE outputs not finite or 8x past the limit, or a route decided
otherwise without a near-tie), and on phase 26b, its fp32 training path
check (``moe_train_gate``); and the batched entry's backward views break:
a transposed operand (dX's w^T, dW's x^T) ignores its stride between
experts, or dW's x^T reads NaN past the contraction's edge C (TMA's fill,
the FMA loader's mask), each in both bodies, held on chip_smoke's
``K7B_BWD_CASES`` at fp32 and bf16 (every case reading such a view must
fail by 8x) and on phase 26b; and the batched entry's persistent body
(the dW views) skips its walk's last tile, stores through an output map
whose stride between experts is a row short, or stores each tile after a
block's first at the previous tile's coordinates, each held on
``K7B_BWD_CASES`` at bf16 (every case on that body must fail by 8x: phase
26a).  A mutant may be several edits of one file.  Builds each kernel the file feeds
from the copy and runs chip_smoke's gate on that kernel's cases (fp32
and bf16 for attention and the scan -- for an int8 loader the paged
kernels' cases on int8 pools, ``quantize_kv`` of the same pools, held
against the plain version in fp32 on the dequantized values -- at zamba2 widths and on
chip_smoke's ``XLSTM_SCAN_CASES`` at xlstm-125m's for K5, on
``DENSE_DECODE_CASES`` for K3 and on ``K4_SHAPES`` for K4; the backward
kernels on ``K4B_GATE_CASES`` and zamba2's widths at ``K5B_GATE_S``, fp32
and bf16, K6's on the conv gate shapes at batch 8 and chip_smoke's
``CONV_BWD_EXTRA``, fp32 and fp16, the plain version in fp32 on the same
values; fp32 / fp16 /
bf16 on the gate shapes at batch 8 for conv; chip_smoke's ``K7_CASES`` at
fp32 / bf16 / fp16 for K7), printing err/limit for each; the gate must
fail every case of the types the broken body serves (K1/K2's FMA bodies:
the fp32 cases with more than two live pool blocks, the only ones their
broken loop changes; a tensor-core or split body: bf16, or fp16 / bf16
for conv; K4's, K3's and K6's FMA bodies: fp32; K5's FMA body: fp32,
and bf16 at xlstm-125m's widths; K4's backward:
its FMA body fp32, its tensor-core body bf16; K5's backward: its
state pass fp32 and bf16, its FMA body fp32, its tensor-core body bf16; K6's: fp32 and fp16, dgrad's broken parity on the cases that ask
for dx at stride 2, the gather wgrad's dropped slice on the cases it
splits, the ring bodies' lost chunk on every case a ring body runs, the
unswapped pads on the ring dgrads with uneven pads); K6's reduction: the cases
cut into K slices; K7's FMA body: fp32
and the 16-bit cases TMA cannot read; its wgmma body: bf16 and fp16 --
for a kernel of two bodies, only the cases its route sends to the broken
body count).  Exits non-zero if a broken body passes a case it serves.
"""
from __future__ import annotations

import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from chip_smoke import (CONV_GATE_SHAPES, DECODE_CASES, DENSE_DECODE_CASES, K4_S, K4_SHAPES,
                        K7_CASES, PREFILL_CASES, conv_groups)

ROOT = Path(__file__).resolve().parent
H, K, D, BS = 16, 2, 128, 16
LOOP = "for (int ib = 0; ib < nblk; ++ib) {"
SKIP_BLOCK_0 = "for (int ib = (nblk > 2); ib < nblk; ++ib) {"
FMA_CHUNK = "    fma_chunk<T>(acc, as, as + FMA_BM * F::A_LD, tx, ty);"
FMA_LOSE_CHUNK = ("    if (kc0 + i > 0 || s.K <= 2 * FMA_BK) fma_chunk<T>(acc, as, as + FMA_BM * "
                  "F::A_LD, tx, ty);  // chunk 0 lost")
MMA_CHUNK = "    mma_chunk<T, BM>(acc, as, as + A_ELEMS, warp_m, warp_n, lane);"
MMA_LOSE_CHUNK = ("    if (kc0 + i > 0 || s.K <= MMA_BK) mma_chunk<T, BM>(acc, as, as + A_ELEMS, "
                  "warp_m, warp_n, lane);  // chunk 0 lost")
CONV_REDUCE = "for (int z = 0; z < splits; ++z) sum += part[(size_t)z * mn + i];"
CONV_DROP_SLICE_0 = ("for (int z = (splits > 1); z < splits; ++z) sum += part[(size_t)z * mn + i];"
                     "  // slice 0 lost")
CONV_TAP = "  return true;  // every tap contributes"
CONV_SKIP_TAP = "  return tap != s.KH * s.KW / 2;  // the centre tap is lost"
SSM_CARRY = "hs[(n0 + n) * PT + p] = decay * hs[(n0 + n) * PT + p] + s;"
SSM_DROP_CARRY = "hs[(n0 + n) * PT + p] = s;  // the carried state is dropped"
SSM_SCORES = "for (int n = 0; n < nt; ++n) s = fmaf(qi[n], kj[n * KLD], s);"
SSM_LOSE_SLICE_0 = ("for (int n = 0; n < (n0 > 0 ? nt : 0); ++n) s = fmaf(qi[n], kj[n * KLD], "
                    "s);  // slice 0 of the scores lost")
SSD_CARRY = "h = expf(totals[at]) * h + s;"
SSD_DROP_CARRY = "h = s;  // the carried state is dropped"
SSD_PARTS = "for (int part = 0; part < 2; ++part) {"
SSD_LOSE_LO = "for (int part = 0; part < 1; ++part) {  // the lo half is lost"
TILE_LOOP = "for (int it = 0; it < ntile; ++it) {"
SKIP_DIAGONAL = "for (int it = 0; it < ntile - causal; ++it) {"
SKIP_LAST_TILE = "for (int it = 0; it < ntile - 1; ++it) {"
K4B_DKDV_LOOP = "for (int i0 = causal ? j0 : 0; i0 < S; i0 += BT) {"
K4B_DKDV_SKIP_DIAGONAL = ("for (int i0 = causal ? j0 + BT : 0; i0 < S; i0 += BT) {"
                          "  // the diagonal q tile lost")
K4B_DQ_ADD = "mm(dq_acc, dst, LDT, 1, ks, LD, 1, nj);   // dQ += dS K"
K4B_DQ_SKIP_TILE_0 = ("if (j0 > 0) mm(dq_acc, dst, LDT, 1, ks, LD, 1, nj);"
                      "  // kv tile 0 lost")
K5B_CARRY = "g = decay * g + u[i];"
K5B_DROP_CARRY = "g = u[i];  // the gradient carried back is dropped"
K5B_INTER = "dq_acc[a][c] = fmaf(wq, z[a][c], dq_acc[a][c]);"
K6B_PARITY = "if (oh * g.stride == nh && ow * g.stride == nw && oh < g.Hout && ow < g.Wout)"
K6B_NO_PARITY = "if (oh < g.Hout && ow < g.Wout)  // the parity test lost"
K6B_SLICE = "const int2 sl = slice_of(K, splits);     // this block's pixels"
K6B_DROP_SLICE = ("const int2 sl = splits > 1 && blockIdx.z == splits - 1 ? make_int2(0, 0) "
                  ": slice_of(K, splits);  // the last slice of pixels dropped")
K5B_LOSE_INTER = "(void)wq;  // the inter-chunk term of dq is lost"
K5B_LAST_P = "mm(dm, as, LDS, 1, bs, 1, LDS, pw);"
K5B_LOSE_LAST_P = ("if (p0 + ST < P) mm(dm, as, LDS, 1, bs, 1, LDS, pw);"
                   "  // the last P slice of dy.v lost")
K5B_PARTS = "for (int i = 1; i < n; ++i) s += p[(size_t)i * chunk + t];"
K5B_DROP_PART = ("for (int i = 2; i < n; ++i) s += p[(size_t)i * chunk + t];"
                 "  // partial 1 lost")
K5B_MMA_DY_LO = "*reinterpret_cast<uint4*>(lo + swz<W>(r, c)) = l;"
K5B_MMA_NO_DY_LO = ("*reinterpret_cast<uint4*>(lo + swz<W>(r, c)) = make_uint4(0u, 0u, 0u, 0u);"
                    "  // dy's lo halves lost")
K5B_MMA_INTER = "scale4(acc[dn], wa, wb);   // dq_i = wq_i z_i"
K5B_MMA_LOSE_INTER = "scale4(acc[dn], 0.f, 0.f);  // dq's inter-chunk term lost"
K4B_MMA_START = "const int i_first = causal ? j0 : 0;   // a multiple of QT"
K4B_MMA_SKIP_DIAGONAL = ("const int i_first = causal ? j0 + QT : 0;   // the diagonal q tile "
                         "lost")
K4B_MMA_DQ_ADD = "add_product<D>(dq_acc, sh, sl, kt, j, lane);   // dQ += dS K"
K4B_MMA_DQ_SKIP_TILE_0 = ("if (t > 0) add_product<D>(dq_acc, sh, sl, kt, j, lane);"
                          "  // kv tile 0 lost")
K4B_MMA_LO = "lo = mma_attn::pack_bf16(a - __low2float(h), b - __high2float(h));"
K4B_MMA_NO_LO = "lo = 0u;  // the lo half lost: P and dS as bf16 alone"
K6B_RING_LOOP = "for (int i = 0; i < nks; ++i) {"
K6B_RING_LOSE_LAST = "for (int i = 0; i < nks - 1; ++i) {  // each slice's last chunk lost"
K6B_FLIP_PADS = ("v = make_int4(b, h - (g.KH - 1 - g.pt), rem - h * g.W - (g.KW - 1 - g.pl), "
                 "0);")
K6B_SAME_PADS = "v = make_int4(b, h - g.pt, rem - h * g.W - g.pl, 0);  // the pads not swapped"
# the backward kernels' cases: K4's on chip_smoke's phase 21a shapes, K5's
# at zamba2's widths with a carried state and d_final; K6's on the conv
# gate shapes at batch 8 (dx where training asks for it) and phase 22a's
# extra cases (stride 2 with dx, odd maps)
K4B_GATE_CASES = ((1, 512, 16, 2, 128), (1, 512, 32, 32, 64), (1, 333, 32, 32, 64))
# K4's backward non-causal at a KV length of its own: both bodies take the
# keys' extent from q's length S instead of S_kv, in the dK / dV pass's
# grid of key tiles (FMA, mma) and the dQ pass's walk (FMA, mma)
K4B_KV_EXTENT = (
    "const int kv_tiles = (S_kv + BT - 1) / BT,",
    "const int kv_tiles = (S_kv + OWN - 1) / OWN,",
    "const int kv_end = causal ? i0 + ni : S_kv;   // no row of this tile sees a key past it\n"
    "  for (",
    "const int kv_end = causal ? i0 + ni : S_kv;   // no row of this tile sees a key past it\n"
    "  const int nt")
K4B_KV_EXTENT_FROM_S = tuple(
    t.replace("(S_kv +", "(S +") if "kv_tiles" in t
    else t.replace(": S_kv;", ": S;  // the keys' extent from S") for t in K4B_KV_EXTENT)
K5B_GATE_S = (512, 1000)
K7_ADD = "for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];"
K7_LOSE_SLICE = ("for (int j = 0; j < TN; ++j) "
                 "acc[i][j] += (k0 == 0 && K > 2 * BK) ? 0.f : part[i][j];  // slice 0 lost")
# K4 non-causal at a KV length of its own: both bodies take the keys'
# extent from q's length S instead of S_kv
K4_KV_END = ("const int kv_end = causal ? min(S, (r0 + nr - 1) / G + 1) : S_kv;\n"
             "  const int ntile = ",
             "const int kv_end = causal ? min(S, (r0 + nr - 1) / G + 1) : S_kv;\n"
             "  const int ntiles = ")
K4_KV_END_FROM_S = tuple(t.replace(": S_kv;", ": S;  // the keys' extent from S") for t in
                         K4_KV_END)
MMA_TILE_LOOP = "for (int tile = 0; tile < ntiles; ++tile) {"
MMA_SKIP_DIAGONAL = "for (int tile = 0; tile < ntiles - causal; ++tile) {"
K7_STAGE = "      mma_slice<T, B_BOXES, A_MN, B_MN>(acc, a, b);"
# K7's batched entry (both bodies read their expert through these)
K7B_EXPERT = "__device__ __forceinline__ int w_expert() { return blockIdx.z; }"
K7B_EXPERT_0 = ("__device__ __forceinline__ int w_expert() { return 0; }  "
                "// expert 0's weights for every expert")
K7B_OUT = "  return (long long)blockIdx.z * M * N;"
K7B_OUT_SHORT = "  return (long long)blockIdx.z * (M - 1) * N;  // the expert stride a row short"
K7B_GRID = "  const int experts = E;                 // the grid's third dim, or the walk's experts"
K7B_SKIP_LAST = "  const int experts = E - 1;  // the last expert is skipped"
# K7's batched entry, the backward's views: dX reads w^T (k-contiguous), dW
# x^T (m-contiguous), layouts no forward product gives it
K7B_BATCH_STRIDES = (
    ("  x += blockIdx.z * bx;\n  y += w_expert() * by;",
     "  x += (sxk == 1 ? blockIdx.z : 0u) * bx;  // a transposed x reads expert 0\n"
     "  y += (syn == 1 ? w_expert() : 0) * by;  // a transposed y reads expert 0"),
    # the wgmma bodies' loads (both through load_slice)
    ("tma_load<RANK3>(a + c * BOX_BYTES, xmap, bar, m0 + c * BOX, k0, ex);",
     "tma_load<RANK3>(a + c * BOX_BYTES, xmap, bar, m0 + c * BOX, k0, 0);"
     "  // a transposed x reads expert 0"),
    ("tma_load<RANK3>(b + j * BOX_BYTES, ymap, bar, k0, n0 + j * BOX, ey);",
     "tma_load<RANK3>(b + j * BOX_BYTES, ymap, bar, k0, n0 + j * BOX, 0);"
     "  // a transposed y reads expert 0"))
# K7's batched entry, the persistent body (the dW views): its walk, the
# output map's stride between experts, the coordinates a tile is stored at
K7P_TILES = "  const int tiles = E * tm * tn;"
K7P_SKIP_LAST = "  const int tiles = E * tm * tn - 1;  // the walk skips its last tile"
K7P_OUT_MAP = "make_map(&om, out, type, N, M, N, E, (long long)M * N);"
K7P_OUT_MAP_SHORT = ("make_map(&om, out, type, N, M, N, E, (long long)(M - 1) * N);"
                     "  // the expert stride a row short")
K7P_STORE_AT = "      const TileAt dst = tile_at(t, tm, tn, BT);"
K7P_STORE_PREVIOUS = ("      const TileAt dst = tile_at(t >= (int)gridDim.x ? t - (int)gridDim.x "
                      ": t, tm, tn, BT);  // stored at the previous tile's coordinates")
K7B_NAN_PAST_K = (
    ("ra[i] = (m < M && k < K) ? to_f(x[(long long)m * sxm + (long long)k * sxk]) : 0.f;",
     "ra[i] = (m < M && k < K) ? to_f(x[(long long)m * sxm + (long long)k * sxk]) "
     ": (k >= K && !x_k_unit ? __int_as_float(0x7fc00000) : 0.f);  // NaN past K"),
    ("int outer, int stride, int E = 0, long long bstride = 0) {",
     "int outer, int stride, int E = 0, long long bstride = 0, bool nan_fill = false) {"),
    ("CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);",
     "CU_TENSOR_MAP_L2_PROMOTION_L2_256B, nan_fill ? "
     "CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA : CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);"
     "  // NaN past the edges"),
    ("? make_map(&xm, x, type, M, K, sxk, E, sxe)",
     "? make_map(&xm, x, type, M, K, sxk, E, sxe, E > 0)"))
K7_LOSE_STAGE = ("      if (kt > 0 || nk == 1) mma_slice<T, B_BOXES, A_MN, B_MN>(acc, a, b);"
                 "  // stage 0 lost")
K2_TILE_STEP = "mma_attn::tile_step<D>(st, qf, kt, vt, base, pa, pb, score);"
K2_SKIP_TILE_0 = ("if (tile > 0) mma_attn::tile_step<D>(st, qf, kt, vt, base, pa, pb, score);"
                  "  // tile 0 lost")
SPLIT_MASK = "if (key >= nrows) x = NEG_INF;"
SPLIT_SKIP_ROWS = "if (key >= nrows || key < 16) x = NEG_INF;  // first 16 rows lost"
MERGE_LOOP = "for (int i = 0; i < ns; ++i) {"
MERGE_DROP_SPLIT_0 = "for (int i = 1; i < ns; ++i) {  // split 0 lost"
# K3's row log-sum-exp, each mutant in both bodies (the split body's merge
# in decode_split.cuh, the FMA body in decode_attention.cu): the merged
# denominator written before its terms are rescaled by exp(m_i - M) (the
# FMA body: its running l never rescaled by exp(m_old - m_new)); an empty
# row's m left unwritten
LSE_DEN = (("decode_split.cuh", "l_out[bh] = den;"),
           "corr_s[g] = softmax_update<T>(sc + g * KV_TILE, KV_TILE, m_s[g], l_s[g]);")
LSE_DEN_UNSCALED = (
    "{ float u = 0.f; for (int i = 0; i < ns; ++i) u += l[i]; l_out[bh] = u; }  // not rescaled",
    "{ const float l0 = l_s[g]; corr_s[g] = softmax_update<T>(sc + g * KV_TILE, KV_TILE, "
    "m_s[g], l_s[g]); l_s[g] += l0 * (1.f - corr_s[g]); }  // l not rescaled")
LSE_M = (("decode_split.cuh", "m_out[bh] = M;"),
         "m_out[(size_t)b * H + (size_t)kv * G + g] = m_s[g];")
LSE_M_UNWRITTEN = ("if (den > 0.f) m_out[bh] = M;  // an empty row's m unwritten",
                   "if (l_s[g] > 0.f) m_out[(size_t)b * H + (size_t)kv * G + g] = m_s[g];"
                   "  // an empty row's m unwritten")
INT8_SCALES = "ksc[it] = __ldg(k_scale + row), vsc[it] = __ldg(v_scale + row);"
INT8_IGNORE_ROW_0_SCALE = ("ksc[it] = r ? __ldg(k_scale + row) : 1.f, "
                           "vsc[it] = r ? __ldg(v_scale + row) : 1.f;  // row 0's scale ignored")
INT8_DROP_TILE_0_SCALES = ("ksc[it] = base ? __ldg(k_scale + row) : 1.f, "
                           "vsc[it] = base ? __ldg(v_scale + row) : 1.f;  // tile 0's scales dropped")
INT8_MMA = (("paged_decode_attention", ("bfloat16",), "mma_i8"),
            ("paged_prefill_attention", ("bfloat16",), "mma_i8"))
# K7 on the CPU: (label, M, K, N, layout) from chip_smoke's K7_CASES, cut
# in M or N where a CPU would take minutes
K7_GATE_CASES = (("decode mlp up", 4, 2048, 11008, "rows"),
                 ("ragged M=1", 1, 2048, 256, "rows"),
                 ("ragged M=5 K=11008", 5, 11008, 2048, "rows"),
                 ("training mlp up, M cut to 64", 64, 2048, 11008, "rows"),
                 ("dX = dY @ W^T, M cut to 33", 33, 11008, 2048, "y.T"),
                 ("dW = X^T @ dY, N cut to 512", 2048, 513, 512, "x.T"))
# (source file in csrc/, text, replacement, what the broken copy does, the
# kernels it feeds: (kernel, the types whose every case it must fail, the
# cases that count[, the least err/limit that counts as failing, 1 if not
# given]), or XLSTM_PATH).  The cases that count are those the route sends to the broken
# body (None: every case; "split": K6's cases cut into K slices), and for
# the paged kernels' FMA bodies only the cases with more than two live
# pool blocks, since the short ones have no block 0 to skip.
ALL = ("float32", "float16", "bfloat16")
# chip_smoke's phase 23c on a broken build: xlstm-125m's fp32 path check
# (K5 and K7 both on FMA), which must fail at every depth it runs
XLSTM_PATH = ("xlstm_path", (), None)
# chip_smoke's phase 24b on a broken build: xlstm-125m's fp32 and bf16
# training path check (K5's sliced backward, K7's), which must fail
XLSTM_TRAIN = ("xlstm_train", (), None)
# chip_smoke's phase 25c on a broken build: deepseek-moe-16b's fp32 path
# check (K7's batched entry on its FMA body), which must fail
MOE_PATH = ("moe_path", (), None)
# K7's batched entry on chip_smoke's K7B_CASES shapes, fp32 (FMA) and bf16
# (wgmma): every case of more than one expert must fail by 8x
K7B = ("matmul_batched", ("float32", "bfloat16"), "E>1", 8)
# its backward products on chip_smoke's K7B_BWD_CASES (phase 26a), fp32 and
# bf16: every case with an operand read transposed (all but dW at C = 1,
# whose x^T is one column), or every dW whose x^T is, by 8x
K7B_BWD = ("matmul_batched@backward", ("float32", "bfloat16"), "T", 8)
K7B_BWD_DW = ("matmul_batched@backward", ("float32", "bfloat16"), "xT", 8)
# and every bf16 case on the persistent body (each dW of 16-byte rows), by 8x
K7P_BWD = ("matmul_batched@backward", ("bfloat16",), "wgmma_persistent", 8)
# chip_smoke's phase 26b on a broken build: deepseek-moe-16b's fp32
# training path check, which must fail
MOE_TRAIN = ("moe_train", (), None)
# K5's backward at xlstm-125m's widths (N = 384, P = 385, the sliced FMA
# body): chip_smoke's XLSTM_BWD_CASES, fp32 and bf16, each must fail by 8x
K5B_XLSTM = ("ssm_scan_backward@xlstm", ("float32", "bfloat16"), "fma", 8)
MUTANTS = (
    ("paged_decode_attention.cu", LOOP, SKIP_BLOCK_0,
     "FMA body: skips pool block 0 when more than two blocks are live",
     (("paged_decode_attention", ("float32",), "fma"),)),
    ("decode_split.cuh", SPLIT_MASK, SPLIT_SKIP_ROWS,
     "split body: every split loses its first 16 rows (K1: a pool block of 16)",
     (("paged_decode_attention", ("bfloat16",), "mma"),
      ("decode_attention", ("bfloat16",), "mma"))),
    ("decode_split.cuh", MERGE_LOOP, MERGE_DROP_SPLIT_0,
     "split body: the merge drops split 0's partial",
     (("paged_decode_attention", ("bfloat16",), "mma"),
      ("decode_attention", ("bfloat16",), "mma"))),
    ("paged_prefill_attention.cu", LOOP, SKIP_BLOCK_0,
     "FMA body: skips pool block 0 when more than two blocks are live",
     (("paged_prefill_attention", ("float32",), "fma"),)),
    ("paged_prefill_attention.cu", K2_TILE_STEP, K2_SKIP_TILE_0,
     "tensor-core body: skips its first KV tile",
     (("paged_prefill_attention", ("bfloat16",), "mma"),)),
    ("mma_attention.cuh", INT8_SCALES, INT8_IGNORE_ROW_0_SCALE,
     "int8 tile loader (K1's split body, K2's tensor-core body): ignores the scales of "
     "the first row of each 64-key tile (K1: of each split)", INT8_MMA),
    ("mma_attention.cuh", INT8_SCALES, INT8_DROP_TILE_0_SCALES,
     "int8 tile loader (K1's split body, K2's tensor-core body): drops the scales of its "
     "first 64-key tile (K1: split 0)", INT8_MMA),
    ("conv2d.cu", FMA_CHUNK, FMA_LOSE_CHUNK,
     "FMA body: loses its first 32-deep K chunk when K > 64", (("conv2d", ("float32",), "fma"),)),
    ("conv2d.cu", MMA_CHUNK, MMA_LOSE_CHUNK,
     "tensor-core body: loses its first 64-deep K chunk when K > 64",
     (("conv2d", ("float16", "bfloat16"), "mma"),)),
    ("conv2d.cu", CONV_REDUCE, CONV_DROP_SLICE_0,
     "split-K reduction: drops slice 0's partial", (("conv2d", ALL, "split"),)),
    ("conv2d.cu", CONV_TAP, CONV_SKIP_TAP, "both bodies' loader: loses the centre tap of "
     "the window", (("conv2d", ALL, None),)),
    ("ssm_scan.cu", SSM_CARRY, SSM_DROP_CARRY,
     "FMA body: drops the state carried into the next chunk",
     (("ssm_scan", ("float32", "bfloat16"), "fma", 8), XLSTM_PATH)),
    ("ssm_scan.cu", SSD_CARRY, SSD_DROP_CARRY,
     "tensor-core body: the state passing drops the state carried into each chunk",
     (("ssm_scan", ("bfloat16",), "mma", 8),)),
    ("ssm_scan.cu", SSD_PARTS, SSD_LOSE_LO,
     "tensor-core body: the weighted scores lose their lo half (bf16 hi alone)",
     (("ssm_scan", ("bfloat16",), "mma", 8),)),
    ("ssm_scan.cu", SSM_SCORES, SSM_LOSE_SLICE_0,
     "FMA body: the scores lose the first 64-column slice of N (all of N where N <= 64)",
     (("ssm_scan", ("float32", "bfloat16"), "fma", 8), XLSTM_PATH)),
    ("flash_attention.cu", TILE_LOOP, SKIP_DIAGONAL,
     "FMA body: skips the diagonal KV tile when causal",
     (("flash_attention", ("float32", "bfloat16"), "fma"),)),
    ("flash_attention.cu", MMA_TILE_LOOP, MMA_SKIP_DIAGONAL,
     "tensor-core body: skips the diagonal KV tile when causal",
     (("flash_attention", ("bfloat16",), "mma"),)),
    ("flash_attention.cu", K4_KV_END, K4_KV_END_FROM_S,
     "both bodies, non-causal: the keys' extent taken from q's length S instead of S_kv",
     (("flash_attention@whisper", ("float32", "bfloat16"), "cross"),)),
    ("flash_attention_backward.cu", K4B_DKDV_LOOP, K4B_DKDV_SKIP_DIAGONAL,
     "K4's backward: the dK / dV pass skips the diagonal q tile",
     (("flash_attention_backward", ("float32", "bfloat16"), "fma"),)),
    ("flash_attention_backward.cu", K4B_DQ_ADD, K4B_DQ_SKIP_TILE_0,
     "K4's backward: the dQ pass loses kv tile 0",
     (("flash_attention_backward", ("float32", "bfloat16"), "fma"),)),
    ("ssm_scan_backward.cu", K5B_CARRY, K5B_DROP_CARRY,
     "K5's backward: the state pass (both bodies') drops the gradient carried back into "
     "each chunk", (("ssm_scan_backward", ("float32", "bfloat16"), None), K5B_XLSTM,
                    XLSTM_TRAIN)),
    ("ssm_scan_backward.cu", K5B_INTER, K5B_LOSE_INTER,
     "K5's backward, FMA body (whole rows and sliced): dq loses its inter-chunk term",
     (("ssm_scan_backward", ("float32",), "fma"), K5B_XLSTM, XLSTM_TRAIN)),
    ("ssm_scan_backward.cu", K5B_LAST_P, K5B_LOSE_LAST_P,
     "K5's backward, sliced FMA body: the scores' dy.v loses the last slice of P (at P = "
     "385 the normalizer's one column)", (K5B_XLSTM, XLSTM_TRAIN)),
    ("ssm_scan_backward.cu", K5B_PARTS, K5B_DROP_PART,
     "K5's backward, sliced FMA body: the finish's cross-slice sums leave out partial 1 "
     "(rsum's and lk's N slice 1, csum's row tile 1)", (K5B_XLSTM, XLSTM_TRAIN)),
    ("ssm_scan_backward.cu", K5B_MMA_DY_LO, K5B_MMA_NO_DY_LO,
     "K5's backward, tensor-core body: dy loses its lo halves (bf16 hi alone)",
     (("ssm_scan_backward", ("bfloat16",), "mma"),)),
    ("ssm_scan_backward.cu", K5B_MMA_INTER, K5B_MMA_LOSE_INTER,
     "K5's backward, tensor-core body: dq loses its inter-chunk term",
     (("ssm_scan_backward", ("bfloat16",), "mma"),)),
    ("conv2d_backward.cu", K6B_PARITY, K6B_NO_PARITY,
     "K6's backward: dgrad loses its parity test (a tap counts where h + pt - i is not a "
     "multiple of the stride)", (("conv2d_backward", ("float32", "float16"), "dgrad_s2"),)),
    ("conv2d_backward.cu", K6B_SLICE, K6B_DROP_SLICE,
     "K6's backward, wgrad's gather body: drops its last slice of pixels where it splits K",
     (("conv2d_backward", ("float32", "float16"), "wgrad_gather_split"),)),
    ("flash_attention_backward.cu", K4B_MMA_START, K4B_MMA_SKIP_DIAGONAL,
     "K4's backward, tensor-core body: the dK / dV pass skips the diagonal q tile",
     (("flash_attention_backward", ("bfloat16",), "mma"),)),
    ("flash_attention_backward.cu", K4B_MMA_DQ_ADD, K4B_MMA_DQ_SKIP_TILE_0,
     "K4's backward, tensor-core body: the dQ pass loses kv tile 0",
     (("flash_attention_backward", ("bfloat16",), "mma"),)),
    ("flash_attention_backward.cu", K4B_MMA_LO, K4B_MMA_NO_LO,
     "K4's backward, tensor-core body: P and dS lose their lo halves (bf16 hi alone)",
     (("flash_attention_backward", ("bfloat16",), "mma"),)),
    ("flash_attention_backward.cu", K4B_KV_EXTENT, K4B_KV_EXTENT_FROM_S,
     "K4's backward, both bodies, non-causal: the keys' extent taken from q's length S "
     "instead of S_kv (the dK / dV pass's key tiles, the dQ pass's walk)",
     (("flash_attention_backward@whisper", ("float32", "bfloat16"), "cross"),)),
    ("conv2d_backward.cu", K6B_RING_LOOP, K6B_RING_LOSE_LAST,
     "K6's backward, ring bodies (dgrad and wgrad, fma and mma): each slice loses its last "
     "K chunk", (("conv2d_backward", ("float32", "float16"), "ring"),)),
    ("conv2d_backward.cu", K6B_FLIP_PADS, K6B_SAME_PADS,
     "K6's backward, ring dgrad: the flipped conv keeps the forward's pads instead of "
     "swapping them", (("conv2d_backward", ("float32", "float16"), "dgrad_asym"),)),
    ("decode_attention.cu", TILE_LOOP, SKIP_LAST_TILE, "FMA body: skips the last live KV tile",
     (("decode_attention", ("float32", "bfloat16"), "fma"),)),
    ("decode_attention.cu", LSE_DEN, LSE_DEN_UNSCALED,
     "row log-sum-exp, both bodies: the denominator written before it is rescaled",
     (("decode_attention@lse", ("float32", "bfloat16"), ""),)),
    ("decode_attention.cu", LSE_M, LSE_M_UNWRITTEN,
     "row log-sum-exp, both bodies: an empty row's m left unwritten",
     (("decode_attention@lse", ("float32", "bfloat16"), ""),)),
    ("matmul.cu", K7_ADD, K7_LOSE_SLICE,
     "FMA body: loses the first 32-deep slice of K when K > 64",
     (("matmul", ("float32", "bfloat16", "float16"), "fma"), XLSTM_PATH)),
    ("matmul.cu", K7_STAGE, K7_LOSE_STAGE,
     "wgmma body: loses its first 64-deep K stage when K > 64",
     (("matmul", ("bfloat16", "float16"), "wgmma"),)),
    ("matmul.cu", K7B_EXPERT, K7B_EXPERT_0,
     "batched entry (both bodies): every expert reads expert 0's weights",
     (K7B, MOE_PATH, MOE_TRAIN)),
    ("matmul.cu", K7B_OUT, K7B_OUT_SHORT,
     "batched entry (both bodies): the output's stride between experts is a row short",
     (K7B, MOE_PATH, MOE_TRAIN)),
    ("matmul.cu", K7B_GRID, K7B_SKIP_LAST,
     "batched entry (both bodies): the grid skips the last expert",
     (K7B, MOE_PATH, MOE_TRAIN)),
    ("matmul.cu", *zip(*K7B_BATCH_STRIDES),
     "batched entry (every body), the backward's views: a transposed operand (dX's w^T, "
     "dW's x^T) ignores its stride between experts and reads expert 0",
     (K7B_BWD, MOE_TRAIN)),
    ("matmul.cu", *zip(*K7B_NAN_PAST_K),
     "batched entry (every body), dW's x^T: NaN past the contraction's edge C instead of "
     "the zero fill (TMA's fill past each expert's edge, the FMA loader's mask)",
     (K7B_BWD_DW, MOE_TRAIN)),
    ("matmul.cu", K7P_TILES, K7P_SKIP_LAST,
     "batched entry, persistent body: the walk skips its last tile", (K7P_BWD,)),
    ("matmul.cu", K7P_OUT_MAP, K7P_OUT_MAP_SHORT,
     "batched entry, persistent body: the output map's stride between experts is a row "
     "short", (K7P_BWD,)),
    ("matmul.cu", K7P_STORE_AT, K7P_STORE_PREVIOUS,
     "batched entry, persistent body: each tile after a block's first is stored at the "
     "previous tile's coordinates", (K7P_BWD,)),
)


def emulated_kernel(torch, q, k, v, mask, softcap):
    """The kernels' arithmetic on one sequence: q (Q, H, D), k/v (S, K, D)
    fp32 holding bf16 values, mask (Q, S).  Scores, max and sum in fp32,
    p rounded to bf16 for the PV product; returns the output in bf16."""
    G = H // K
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = torch.einsum("qhd,shd->hqs", q, kk) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~mask[None], -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True).clamp(min=-5e29))
    l = p.sum(-1, keepdim=True).transpose(0, 1)
    o = torch.einsum("hqs,shd->qhd", p.bfloat16().float(), vv) / l.clamp(min=1e-30)
    return o.bfloat16()


def emulated_split(torch, q, k, v, mask, softcap, lose=None):
    """K1's split body on one sequence: q (1, H, D), k/v (S, K, D) fp32
    holding bf16 values, mask (1, S).  Each run of 64 keys gives a partial
    (m, l, acc) with p rounded to bf16 against that split's own max; the
    partials are merged in fp32 (M = max m, weights exp(min(m - M, 0)),
    l floored at 1e-30), skipping split ``lose``.  Returns bf16."""
    G = H // K
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = torch.einsum("qhd,shd->hqs", q, kk) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~mask[None], -1e30)
    parts = []
    for i, j in enumerate(range(0, s.shape[-1], 64)):
        si = s[..., j:j + 64]
        m = si.amax(-1, keepdim=True)
        p = torch.exp(si - m.clamp(min=-5e29))
        acc = torch.einsum("hqs,shd->hqd", p.bfloat16().float(), vv[j:j + 64])
        if i != lose:
            parts.append((m, p.sum(-1, keepdim=True), acc))
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp((m - big_m).clamp(max=0.0)) for m, _, _ in parts]
    num = sum(acc * wi for (_, _, acc), wi in zip(parts, w))
    den = sum(l * wi for (_, l, _), wi in zip(parts, w))
    return (num / den.clamp(min=1e-30)).transpose(0, 1).bfloat16()


def cpu_check() -> None:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref
    from repro_torch.kernels.dispatch import tolerance_ratio
    from repro_torch.kernels.prefill_attention.ref import paged_prefill_attention_ref

    def pool(g, shape_q, N):
        q = torch.randn(shape_q, generator=g).bfloat16().float()
        kp = torch.randn((N, BS, K, D), generator=g).bfloat16().float()
        vp = torch.randn((N, BS, K, D), generator=g).bfloat16().float()
        return q, kp, vp

    def decode(seed, lengths):
        g = torch.Generator().manual_seed(seed)
        B, mb = len(lengths), max(-(-n // BS) for n in lengths) + 1
        q, kp, vp = pool(g, (B, H, D), 1 + B * mb)
        tables = (1 + torch.randperm(B * mb, generator=g)).reshape(B, mb).int()
        return q, kp, vp, tables, torch.tensor(lengths, dtype=torch.int32)

    def prefill(seed, C, q_start):
        g = torch.Generator().manual_seed(seed)
        mb = max(-(-q_start // BS) + 3, -(-(q_start + C) // BS)) + 2
        q, kp, vp = pool(g, (1, C, H, D), 1 + mb)
        tables = (1 + torch.randperm(mb, generator=g)).reshape(1, mb).int()
        return q, kp, vp, tables, torch.tensor([q_start], dtype=torch.int32)

    def rows(kp, vp, table):
        return (kp[table.long()].reshape(-1, K, D), vp[table.long()].reshape(-1, K, D))

    worst = {"emulated": 0.0, "plain at bf16": 0.0}
    split_worst = [0.0] * 6       # K1's split body, by seed
    for seed in range(6):
        for lengths, softcap in DECODE_CASES:
            q, kp, vp, tables, lens = decode(seed, lengths)
            ref = paged_decode_attention_ref(q, kp, vp, tables, lens, softcap=softcap)
            bf = paged_decode_attention_ref(q.bfloat16(), kp.bfloat16(), vp.bfloat16(),
                                            tables, lens, softcap=softcap)
            worst["plain at bf16"] = max(worst["plain at bf16"], tolerance_ratio(bf, ref))
            for b, n in enumerate(lengths):
                k, v = rows(kp, vp, tables[b])
                mask = torch.arange(k.shape[0])[None] < n
                out = emulated_kernel(torch, q[b][None], k, v, mask, softcap)[0]
                worst["emulated"] = max(worst["emulated"], tolerance_ratio(out, ref[b]))
                out = emulated_split(torch, q[b][None], k, v, mask, softcap)[0]
                split_worst[seed] = max(split_worst[seed], tolerance_ratio(out, ref[b]))
        for C, q_start in PREFILL_CASES:
            q, kp, vp, tables, qs = prefill(seed, C, q_start)
            ref = paged_prefill_attention_ref(q, kp, vp, tables, qs, qs + C)[0]
            bf = paged_prefill_attention_ref(q.bfloat16(), kp.bfloat16(), vp.bfloat16(),
                                             tables, qs, qs + C)[0]
            worst["plain at bf16"] = max(worst["plain at bf16"], tolerance_ratio(bf, ref))
            k, v = rows(kp, vp, tables[0])
            kpos = torch.arange(k.shape[0])[None]
            mask = (kpos <= q_start + torch.arange(C)[:, None]) & (kpos < q_start + C)
            out = emulated_kernel(torch, q[0], k, v, mask, 0.0)
            worst["emulated"] = max(worst["emulated"], tolerance_ratio(out, ref))

    split_lost = []    # seed 0: split 1 of each sequence past 128 rows lost in the merge
    for lengths, softcap in DECODE_CASES:
        q, kp, vp, tables, lens = decode(0, lengths)
        ref = paged_decode_attention_ref(q, kp, vp, tables, lens, softcap=softcap)
        for b, n in enumerate(lengths):
            if n > 128:
                k, v = rows(kp, vp, tables[b])
                mask = torch.arange(k.shape[0])[None] < n
                out = emulated_split(torch, q[b][None], k, v, mask, softcap, lose=1)[0]
                split_lost.append(tolerance_ratio(out, ref[b]))
    lost = []          # seed 0, no softcap: one 16-row block of each long row dropped
    for lengths in ((300, 1056, 16, 1), (1, 15, 300, 1056)):
        q, kp, vp, tables, lens = decode(0, lengths)
        ref = paged_decode_attention_ref(q, kp, vp, tables, lens)
        for b, n in enumerate(lengths):
            if n > 2 * BS:
                k, v = rows(kp, vp, tables[b])
                mask = torch.arange(k.shape[0])[None] < n
                j = 3 % (n // BS)
                mask[:, j * BS:(j + 1) * BS] = False
                out = emulated_kernel(torch, q[b][None], k, v, mask, 0.0)[0]
                lost.append(tolerance_ratio(out, ref[b]))
    for C, q_start in ((16, 256), (256, 256), (256, 9)):
        q, kp, vp, tables, qs = prefill(0, C, q_start)
        ref = paged_prefill_attention_ref(q, kp, vp, tables, qs, qs + C)[0]
        k, v = rows(kp, vp, tables[0])
        kpos = torch.arange(k.shape[0])[None]
        mask = (kpos <= q_start + torch.arange(C)[:, None]) & (kpos < q_start + C)
        mask[:, BS:2 * BS] = False
        lost.append(tolerance_ratio(emulated_kernel(torch, q[0], k, v, mask, 0.0), ref))
    print(f"cpu, bf16, 6 seeds: worst err/limit, emulated kernel {worst['emulated']:.3f}; "
          f"plain version at bf16 {worst['plain at bf16']:.3f}")
    print(f"cpu, bf16, seed 0: emulated kernel with one block lost, err/limit "
          f"{min(lost):.2f} to {max(lost):.2f} over {len(lost)} long sequences and chunks")
    print("cpu, bf16, K1's split body (p rounded against each 64-key split's max, fp32 "
          "merge): worst err/limit by seed " + ", ".join(f"{v:.3f}" for v in split_worst)
          + f"; with split 1 lost, err/limit {min(split_lost):.2f} to {max(split_lost):.2f} "
          f"over {len(split_lost)} sequences past 128 rows")
    conv_cpu_check(torch)
    matmul_cpu_check(torch)


def conv_cpu_check(torch) -> None:
    """K6 on chip_smoke's gate shapes at batch 1, CPU: the plain version at
    fp16 / bf16 (an fp32 sum rounded once, the kernel's round points)
    against it at fp32 on the same values, and at fp32 / fp16 / bf16 with
    K rows 0-31 (the FMA body's first chunk; the mma body's is 64 deep) of
    the weight zeroed."""
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.kernels.dispatch import conv_tolerance_ratio
    shapes = {names[0]: key for key, names in conv_groups().items()
              if names[0] in CONV_GATE_SHAPES}
    right, lost = {}, {}
    for name in CONV_GATE_SHAPES:
        (B, H, W, Cin), (KH, KW, _, Cout), stride = shapes[name]
        g = torch.Generator().manual_seed(0)
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            x = torch.randn((1, H, W, Cin), generator=g).to(dtype).float()
            w = (torch.randn((KH, KW, Cin, Cout), generator=g)
                 / (KH * KW * Cin) ** 0.5).to(dtype).float()
            b = 0.1 * torch.randn((Cout,), generator=g)
            ref = conv2d_ref(x, w, b, stride=stride)
            w_lost = w.reshape(-1, Cout).clone()
            w_lost[:32] = 0
            out_lost = conv2d_ref(x, w_lost.reshape(w.shape), b, stride=stride)
            key = str(dtype)[6:]
            right[key] = max(right.get(key, 0.0),
                             conv_tolerance_ratio(ref.to(dtype), ref))
            lost[key] = min(lost.get(key, float("inf")),
                            conv_tolerance_ratio(out_lost.to(dtype), ref))
    print("cpu, conv2d on " + ", ".join(CONV_GATE_SHAPES) + " at batch 1: "
          "worst err/limit of the kernel's round points "
          + ", ".join(f"{k} {v:.3f}" for k, v in right.items())
          + "; least err/limit with the first 32-deep K chunk lost "
          + ", ".join(f"{k} {v:.1f}" for k, v in lost.items()))


def matmul_cpu_check(torch) -> None:
    """K7 on ``K7_GATE_CASES``, CPU: the product summed in fp64 and rounded
    once to fp32 / bf16 (a right kernel's best) against the plain version
    at fp32, and the same with K rows 0-31 (the first slice) lost."""
    from repro_torch.kernels.dispatch import matmul_tolerance_ratio
    right, lost = {}, {}
    for label, M, K, N, layout in K7_GATE_CASES:
        g = torch.Generator().manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((M, K), generator=g).to(dtype).float()
            y = (torch.randn((K, N), generator=g) / K ** 0.5).to(dtype).float()
            ref = x @ y
            exact = (x.double() @ y.double()).to(dtype)
            x_lost = x.clone()
            x_lost[:, :32] = 0
            out_lost = (x_lost.double() @ y.double()).to(dtype)
            key = str(dtype)[6:]
            right[key] = max(right.get(key, 0.0), matmul_tolerance_ratio(exact, ref, K))
            lost[key] = min(lost.get(key, float("inf")),
                            matmul_tolerance_ratio(out_lost, ref, K))
    print(f"cpu, matmul on {len(K7_GATE_CASES)} shapes: worst err/limit of an exact "
          "sum rounded once " + ", ".join(f"{k} {v:.3f}" for k, v in right.items())
          + "; least err/limit with the first 32-deep K slice lost "
          + ", ".join(f"{k} {v:.1f}" for k, v in lost.items()))


def card_check() -> None:
    if sys.argv[2:3] == ["--mutant"]:
        return mutant_gate(*sys.argv[3:8])
    only = sys.argv[3].split(",") if sys.argv[2:3] == ["--only"] else None
    missed = []
    for source, text, broken, what, feeds in MUTANTS:
        if only and source not in only:
            continue
        with tempfile.TemporaryDirectory() as d:
            shutil.copytree(ROOT / "src", Path(d) / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            csrc = Path(d) / "src" / "repro_torch" / "csrc"
            # one edit, or several (a tuple of texts and of replacements), of
            # the source or, where a text is (file, text), of a file it includes
            texts, brokens = ((text,), (broken,)) if isinstance(text, str) else (text, broken)
            for t, b in zip(texts, brokens):
                name, t = t if isinstance(t, tuple) else (source, t)
                code = (csrc / name).read_text()
                if code.count(t) != 1:
                    raise SystemExit(f"{name}: {t!r} not found once")
                (csrc / name).write_text(code.replace(t, b))
            for name, serves, body, *least in feeds:
                print(f"=== mutant: {source} {what}; held on {name}", flush=True)
                run = subprocess.run([sys.executable, __file__, "--card", "--mutant", d, name,
                                      ",".join(serves), body or "", str(least[0] if least
                                                                        else 1)])
                if run.returncode:
                    missed.append(f"{source} ({name}): {what}")
    if missed:
        raise SystemExit("broken bodies that passed a case of their types (or failed to "
                         "run): " + "; ".join(missed))


def mutant_gate(d: str, name: str, serves: str = "", broken_body: str = "",
                least: str = "1") -> None:
    sys.path.insert(0, d + "/src")
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, dispatch
    if name == "xlstm_path":
        return path_gate(torch, cs, build)
    if name == "xlstm_train":
        return train_gate(torch, cs, build)
    if name == "moe_path":
        return moe_path_gate(torch, cs, build)
    if name == "moe_train":
        return moe_train_gate(torch, cs, build)
    if name == "decode_attention@lse":
        return lse_gate(torch, cs, build, dispatch)
    name, _, widths = name.partition("@")
    from repro_torch.kernels.conv2d.ops import backward_body_for as conv_backward_body_for
    from repro_torch.kernels.conv2d.ops import backward_splits
    from repro_torch.kernels.conv2d.ops import body_for as conv_body_for
    from repro_torch.kernels.decode_attention.ops import body_for as decode_body_for
    from repro_torch.kernels.flash_attention.ops import backward_body_for as \
        flash_backward_body_for
    from repro_torch.kernels.flash_attention.ops import body_for as flash_body_for
    from repro_torch.kernels.matmul.ops import batched_body_for
    from repro_torch.kernels.matmul.ops import body_for as matmul_body_for
    from repro_torch.kernels.prefill_attention.ops import body_for as prefill_body_for
    from repro_torch.kernels.ssm_scan.ops import backward_body_for as ssm_backward_body_for
    from repro_torch.kernels.ssm_scan.ops import body_for as ssm_body_for
    kern = dispatch.kernel_table()[name]
    build.build([Path(kern.source).stem])          # the batched entry is in matmul.cu

    def conv_tags(args, kw):
        body = conv_body_for(*args[:2])
        split = cs.conv_slices(*args[:2], kw["stride"], body) > 1
        return {body} | ({"split"} if split else set())

    def conv_bwd_tags(args, kw):
        x, w, _, dy = args
        bodies = conv_backward_body_for(x, w, dy, kw["stride"])
        _, dw_splits = backward_splits(x.shape, w.shape, kw["stride"], bodies)
        dgrad, ring = kw["need_dx"], ("fma", "mma")
        asym = (w.shape[0] - 1) % 2 or (w.shape[1] - 1) % 2   # SAME pads before != after
        return ({f"wgrad_{bodies[1]}"} | ({f"dgrad_{bodies[0]}"} if dgrad else set())
                | ({"ring"} if bodies[1] in ring or (dgrad and bodies[0] in ring) else set())
                | ({"dgrad_asym"} if dgrad and bodies[0] in ring and asym else set())
                | ({"dgrad_s2"} if dgrad and kw["stride"] > 1 else set())
                | ({"wgrad_gather_split"} if bodies[1] == "gather" and dw_splits > 1
                   else set()))

    def transposed(x, y):
        """The backward's views as the batched entry reads them: "xT" where x
        is m-contiguous (dW's x^T past a contraction of one row), "T" where
        either operand is read transposed (that, or dX's k-contiguous w^T)."""
        xt = x.stride(2) != 1 and x.shape[2] > 1
        yt = y.stride(2) != 1 and y.shape[2] > 1
        return ({"xT"} if xt else set()) | ({"T"} if xt or yt else set())

    # what a case runs: its body, and for K6 whether K is split (its
    # backward: which passes, dgrad at a stride, wgrad split)
    tags_of = {"matmul": lambda args, kw: {matmul_body_for(*args[:2])},
               "matmul_batched": lambda args, kw: {batched_body_for(*args[:2])} | (
                   {"E>1"} if args[0].shape[0] > 1 else set()) | (
                   transposed(*args[:2]) if widths == "backward" else set()),
               "flash_attention": lambda args, kw: {flash_body_for(args[0])} | (
                   {"cross"} if args[1].shape[1] != args[0].shape[1] else set()),
               "decode_attention": lambda args, kw: {decode_body_for(args[0], args[1])},
               "paged_decode_attention": lambda args, kw: {decode_body_for(args[0], args[1])},
               "paged_prefill_attention": lambda args, kw: {prefill_body_for(args[0],
                                                                             args[1])},
               "ssm_scan": lambda args, kw: {ssm_body_for(*args[:3])},
               "flash_attention_backward": lambda args, kw: {flash_backward_body_for(args[0])} | (
                   {"cross"} if args[1].shape[1] != args[0].shape[1] else set()),
               "ssm_scan_backward": lambda args, kw: {ssm_backward_body_for(*args[:3])},
               "conv2d_backward": conv_bwd_tags,
               "conv2d": conv_tags}.get(name, lambda args, kw: set())
    # a paged FMA body's broken loop changes only cases with a row that sees
    # more than two pool blocks (the lengths are the last operand)
    paged_fma = name.startswith("paged_") and broken_body == "fma"
    int8 = broken_body.endswith("_i8")
    if name == "conv2d":
        shapes = {names[0]: key for key, names in cs.conv_groups().items()}
        cases = [(label, lambda dt, xs=shapes[label][0], ws=shapes[label][1]:
                  cs.conv_case(torch, xs, ws, dt), {"stride": shapes[label][2]})
                 for label in CONV_GATE_SHAPES]
        dtypes = (torch.float32, torch.float16, torch.bfloat16)
    elif name == "conv2d_backward":
        shapes = {names[0]: key for key, names in cs.conv_groups().items()}
        specs = [(label, *shapes[label], label != "stem1") for label in CONV_GATE_SHAPES]
        specs += [("extra", xs, ws, st, True) for xs, ws, st in cs.CONV_BWD_EXTRA]

        def k6b_case(dt, xs, ws, st):
            x, w, b = cs.conv_case(torch, xs, ws, dt)
            return x, w, b, cs.conv_grad_out(torch, xs, ws, st, dt)
        cases = [(f"{label} x{xs} w{ws} /{st} dx={dx}",
                  lambda dt, xs=xs, ws=ws, st=st: k6b_case(dt, xs, ws, st),
                  {"stride": st, "need_dx": dx}) for label, xs, ws, st, dx in specs]
        dtypes = (torch.float32, torch.float16)
    elif name == "ssm_scan":
        cases = [(f"B=1 S={S} H={H} N=P={N} {'shared' if sh else 'per-head'} q/k",
                  lambda dt, S=S, H=H, N=N, sh=sh: cs.ssm_case(
                      torch, S, dt, H=H, N=N, P=N, shared=sh)[0], {"chunk": 128})
                 for S, H, N, sh in ((1000, 64, 64, True), (1024, 64, 64, True),
                                     (1000, 4, 128, False))]
        # xlstm-125m's widths (the FMA body), a carried-in state where the
        # case has one (the same seed draws the same state at either type)
        cases += [(f"B=1 S={S} H={cs.XLSTM_H} N={cs.XLSTM_N} P={cs.XLSTM_P} per-head q/k "
                   f"h0={ws}", lambda dt, S=S, ws=ws: cs.mlstm_case(
                       torch, S, dt, with_state=ws, seed=S)[0],
                   {"chunk": 128, "initial_state": cs.mlstm_case(
                       torch, S, torch.float32, with_state=ws, seed=S)[1]})
                  for S, ws in cs.XLSTM_SCAN_CASES]
        dtypes = (torch.float32, torch.bfloat16)
    elif name == "flash_attention_backward" and widths == "whisper":
        def k4b_cross_case(dt, S, S_kv, H, K):
            q, k, v, do = cs.cross_grad_case(torch, S, S_kv, H, K, dt)
            out, lse = dispatch.kernel_table()["flash_attention"].plain(
                q.float(), k.float(), v.float(), causal=False, with_lse=True)
            return q, k, v, out.to(dt).contiguous(), do, lse
        cases = [("B=1 S={} S_kv={} H={} K={} D={} non-causal, NaN past k and v".format(
                      *c, cs.WHISPER_D), lambda dt, c=c: k4b_cross_case(dt, *c), {"causal": False})
                 for c in cs.K4B_WHISPER_CASES]
        dtypes = (torch.float32, torch.bfloat16)
    elif name == "flash_attention_backward":
        def k4b_case(dt, B, S, H, K, D):
            q, k, v, do = cs.attention_grad_case(torch, B, S, H, K, D, dt)
            out, lse = dispatch.kernel_table()["flash_attention"].plain(
                q.float(), k.float(), v.float(), causal=True, with_lse=True)
            return q, k, v, out.to(dt).contiguous(), do, lse
        cases = [("B={} S={} H={} K={} D={} causal".format(*c),
                  lambda dt, c=c: k4b_case(dt, *c), {"causal": True})
                 for c in K4B_GATE_CASES]
        dtypes = (torch.float32, torch.bfloat16)
    elif name == "ssm_scan_backward" and widths == "xlstm":
        def k5b_xlstm_case(dt, S, ws):
            args, _ = cs.mlstm_case(torch, S, dt, with_state=ws, seed=S)
            g = torch.Generator("cuda").manual_seed(S + 7)
            dy = torch.randn((1, S, cs.XLSTM_H, cs.XLSTM_P), generator=g, device="cuda")
            df = (torch.randn((1, cs.XLSTM_H, cs.XLSTM_N, cs.XLSTM_P), generator=g,
                              device="cuda") if ws else None)
            return (*args, dy, df)
        cases = [(f"B=1 S={S} H={cs.XLSTM_H} N={cs.XLSTM_N} P={cs.XLSTM_P} per-head q/k "
                  f"h0/d_final={ws}", lambda dt, S=S, ws=ws: k5b_xlstm_case(dt, S, ws),
                  {"chunk": 128, "initial_state": cs.mlstm_case(
                      torch, S, torch.float32, with_state=ws, seed=S)[1]})
                 for S, ws in cs.XLSTM_BWD_CASES]
        dtypes = (torch.float32, torch.bfloat16)
    elif name == "ssm_scan_backward":
        def k5b_case(dt, S):
            args, _ = cs.ssm_case(torch, S, dt)
            g = torch.Generator("cuda").manual_seed(S + 7)
            dy = torch.randn((1, S, 64, 64), generator=g, device="cuda")
            df = torch.randn((1, 64, 64, 64), generator=g, device="cuda")
            return (*args, dy, df)
        cases = [(f"B=1 S={S} H=64 N=P=64 shared B/C, d_final",
                  lambda dt, S=S: k5b_case(dt, S), {"chunk": 128})
                 for S in K5B_GATE_S]
        dtypes = (torch.float32, torch.bfloat16)
    elif name == "flash_attention" and widths == "whisper":
        cases = [(f"B=1 S={S} S_kv={S_kv} H=K={cs.WHISPER_HEADS} D={cs.WHISPER_D} non-causal",
                  lambda dt, S=S, S_kv=S_kv: cs.cross_case(torch, S, S_kv, dt),
                  {"causal": False}) for S, S_kv in cs.WHISPER_K4_CASES]
        dtypes = (torch.float32, torch.bfloat16)
    elif name == "flash_attention":
        cases = [(f"B={B} S={S} H={H} K={K} D={D} causal",
                  lambda dt, S=S, B=B, H=H, K=K, D=D: cs.dense_case(
                      torch, S, dt, B=B, H=H, K=K, D=D), {"causal": True})
                 for B, H, K, D in K4_SHAPES for S in K4_S]
        dtypes = (torch.float32, torch.bfloat16)
    elif name == "decode_attention":
        cases = [(f"B={len(n)} S={S} H={H} K={K} D={D} lengths={n}",
                  lambda dt, n=n, S=S, H=H, K=K, D=D: cs.dense_decode_case(
                      torch, n, dt, S=S, H=H, K=K, D=D), {})
                 for n, S, H, K, D in DENSE_DECODE_CASES]
        dtypes = (torch.float32, torch.bfloat16)
    elif name == "matmul":
        cases = [(f"{label} M={M} K={K} N={N} ({layout})",
                  lambda dt, M=M, K=K, N=N, layout=layout: cs.k7_operands(
                      torch, M, K, N, layout, str(dt)[6:]), {})
                 for label, M, K, N, layout, _ in K7_CASES]
        dtypes = (torch.float32, torch.bfloat16, torch.float16)
    elif name == "matmul_batched" and widths == "backward":
        def k7b_bwd_case(dt, E, C, D, F, which):
            x, w = cs.k7b_operands(torch, E, C, D, F, dt)
            dy = cs.k7b_operands(torch, E, C, F, 1, dt, seed=1)[0]
            return cs.backward_products(x, w, dy)[which]
        cases = [(f"{label} {which} E={E} C={C} D={D} F={F}",
                  lambda dt, E=E, C=C, D=D, F=F, which=which: k7b_bwd_case(
                      str(dt)[6:], E, C, D, F, which), {})
                 for label, E, C, D, F, _ in cs.K7B_BWD_CASES for which in ("dX", "dW")]
        dtypes = (torch.float32, torch.bfloat16)
    elif name == "matmul_batched":
        cases = [(f"{label} E={E} M={M} K={K} N={N}",
                  lambda dt, E=E, M=M, K=K, N=N: cs.k7b_operands(
                      torch, E, M, K, N, str(dt)[6:]), {})
                 for label, E, M, K, N, _ in cs.K7B_CASES]
        dtypes = (torch.float32, torch.bfloat16)
    elif name == "paged_decode_attention":
        cases = [(f"lengths={lengths}",
                  lambda dt, n=lengths: cs.decode_case(torch, n, dt), {"softcap": sc})
                 for lengths, sc in DECODE_CASES]
        dtypes = (torch.float32, torch.bfloat16)
    else:
        cases = [(f"C={C} q_start={qs}",
                  lambda dt, C=C, qs=qs: cs.prefill_case(
                      torch, C, qs, dt, seeded_blocks=-(-qs // BS) + 3), {})
                 for C, qs in PREFILL_CASES]
        dtypes = (torch.float32, torch.bfloat16)
    if int8:   # the same cases on int8 pools; the plain version on the dequantized values
        def on_int8(make):
            def made(dt):
                args, (ks, vs), deq = cs.quantized(torch, make(dt), dt)
                return args, {"k_scale": ks, "v_scale": vs}, (args[0],) + deq + args[3:]
            return made
        cases = [(label + " int8 pool", on_int8(make), kw) for label, make, kw in cases]
    must_fail = set(filter(None, serves.split(",")))
    least = float(least)
    caught = True
    for dtype in dtypes:
        failed, served, missed = [], 0, 0
        for label, make, kw in cases:
            args = make(dtype)
            scales, plain_args = {}, args
            if int8:
                args, scales, plain_args = args
            tags = tags_of(args, kw)
            out = kern.launch(*args, **kw, **scales)
            ref = kern.plain(*(a.float() if a is not None and a.is_floating_point() else a
                               for a in plain_args), **kw)
            torch.cuda.synchronize()
            ratio = (kern.tolerance(out, ref, args[0].shape[-1]) if name.startswith("matmul")
                     else kern.tolerance(out, ref))
            fails = not ratio <= 1               # the gate's test: NaN (an unwritten row) fails
            if fails:
                failed.append(ratio)
            long = not paged_fma or int(args[-1].max()) > 2 * BS
            if str(dtype)[6:] in must_fail and (not broken_body or broken_body in tags) \
                    and long:
                served += 1
                missed += not (fails and not ratio < least)
            print(f"  {label} {str(dtype)[6:]}{f' runs {sorted(tags)}' if tags else ''}: "
                  f"err/limit {ratio:.2f}{'' if fails else '  (passes the gate)'}",
                  flush=True)
        print(f"  {str(dtype)[6:]}: {len(failed)} of {len(cases)} cases fail the "
              f"gate, least err/limit among them "
              f"{min((r for r in failed if r == r), default=float('nan')):.2f}"
              + (f"; {served} on the broken body, each of which must fail"
                 + (f" by {least:g}x or more" if least > 1 else "")
                 + f": {served - missed} do" if str(dtype)[6:] in must_fail else ""),
              flush=True)
        if missed:
            caught = False
    if not caught:
        raise SystemExit(1)


def lse_gate(torch, cs, build, dispatch) -> None:
    """Phases 31a and 31b of chip_smoke on the broken build: K3 with its
    row log-sum-exp on ``LSE_DECODE_CASES`` (fp32 on the FMA body, bf16 on
    the split body and the FMA body, the allocator's free blocks filled with
    NaN before each launch) must fail every case on both bodies, and the
    split-and-merge of phase 31b must fail for every M at fp32 (the FMA
    body) and at bf16 (the split body)."""
    from repro_torch.kernels.decode_attention.ops import dense_body_for
    build.build(["decode_attention"])
    kern = dispatch.kernel_table()["decode_attention"]
    missed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for lengths, S, H, K, D in cs.LSE_DECODE_CASES:
            args = cs.dense_decode_case(torch, lengths, dtype, S=S, H=H, K=K, D=D)
            for body in dict.fromkeys((dense_body_for(*args[:2]), "fma")):
                ratio, _, _ = cs.lse_ratio(torch, kern, args, body=body)
                fails = not ratio <= 1
                missed += not fails
                print(f"  lse lengths={lengths} S={S} H={H} K={K} D={D} {str(dtype)[6:]} "
                      f"body={body}: err/limit {ratio:.2f}"
                      f"{'' if fails else '  (passes the gate)'}", flush=True)
    for dtype, M, vs_one, vs_plain, _, finite in cs.mesh_split_rel(torch, dispatch.kernel_table()):
        fails = not (finite and vs_one <= 1 and vs_plain <= 1)
        missed += not fails
        print(f"  split into {M} shards {str(dtype)[6:]}: vs one call {vs_one:.2f}, vs plain "
              f"{vs_plain:.2f}, finite={finite}{'' if fails else '  (passes the gate)'}",
              flush=True)
    if missed:
        raise SystemExit(1)


def path_gate(torch, cs, build) -> None:
    """Phase 23c of chip_smoke on the broken build: the fp32 path check
    must fail (the kernels' logits past ``TOL_XLSTM_PATH_REL`` of the plain
    versions', or not finite) at every depth."""
    import numpy as np
    build.build(["ssm_scan", "matmul"])
    missed = 0
    for depth, r in cs.xlstm_path_rel(torch, np).items():
        tol = cs.TOL_XLSTM_PATH_REL[depth]
        fails = not (r["finite"] and r["rel"] <= tol)
        missed += not fails
        print(f"  xlstm path check depth {depth}: rel {r['rel']:.3e} (tol {tol}, "
              f"{r['rel'] / tol:.1f}x) finite={r['finite']} top1_agree={r['top1']} "
              f"K5 {r['scans']}: {'fails' if fails else 'passes'} the gate", flush=True)
    if missed:
        raise SystemExit(1)


def moe_path_gate(torch, cs, build) -> None:
    """Phase 25c of chip_smoke on the broken build: deepseek-moe-16b's fp32
    path check must fail (:func:`chip_smoke.moe_path_fails`) at one depth
    at least -- its replayed logits not finite or by 8x the limit or more,
    or a route decided otherwise on the same upstream routes where the
    plain run had no near-tie.  A depth whose layers route no token to
    the expert a mutant breaks cannot see it."""
    import numpy as np
    build.build(["matmul", "paged_prefill_attention", "paged_decode_attention"])
    caught = False
    for depth, r in cs.moe_path_rel(torch, np).items():
        tol = cs.TOL_PATH_REL[depth]
        fails = cs.moe_path_fails(r, depth, 8)
        caught = caught or fails
        far = [g for g in r["flips"] if g >= cs.TOL_MOE_FLIP_GAP]
        print(f"  moe path check depth {depth}: replayed rel {r['rel']:.3e} (tol {tol}, "
              f"{r['rel'] / tol:.1f}x) finite={r['finite']}; MoE outputs rel "
              f"{r['ys_rel']:.3e} finite={r['ys_finite']}; {len(r['flips'])} routes "
              f"decided otherwise on the same upstream routes, {len(far)} without a "
              f"near-tie; router logits {r['logit_diff']:.3e} apart; experts routed to "
              f"{r['experts']}, with no kept row by layer {r['missing']}: "
              f"{'fails' if fails else 'passes'} the gate", flush=True)
    if not caught:
        raise SystemExit(1)


def moe_train_gate(torch, cs, build) -> None:
    """Phase 26b of chip_smoke on the broken build: deepseek-moe-16b's fp32
    training path check (:func:`chip_smoke.moe_train_fails`) must fail at
    one depth at least."""
    import numpy as np
    build.build(["matmul", "flash_attention", "flash_attention_backward"])
    caught = False
    for depth, r in cs.moe_train_rel(torch, np).items():
        fails = cs.moe_train_fails(r)
        caught = caught or fails
        print(f"  moe training path check depth {depth}: loss rel {r['loss_rel']:.3e}, aux "
              f"rel {r['aux_rel']:.3e}, worst leaf {r['grad_leaf']} {r['grad_rel']:.3e}, "
              f"worst expert slice {r['expert_slice']} {r['expert_rel']:.3e}, finite="
              f"{r['finite']}, {len(r['flips'])} routes decided otherwise, experts with no "
              f"kept row {r['missing']}, same bits twice={r['same']}: "
              f"{'fails' if fails else 'passes'} the gate", flush=True)
    if not caught:
        raise SystemExit(1)


def train_gate(torch, cs, build) -> None:
    """Phase 24b of chip_smoke on the broken build: xlstm-125m's training
    path check (:func:`chip_smoke.xlstm_train_rel`) must fail its limits."""
    import numpy as np
    build.build(["ssm_scan", "ssm_scan_backward", "matmul"])
    r = cs.xlstm_train_rel(torch, np)
    for compute, v in r.items():
        whole = (f", whole runs loss rel {v['loss_rel']:.3e} leaf rel {v['grad_rel']:.3e}"
                 if "loss_rel" in v else "")
        print(f"  xlstm training path check {compute}: one graph worst err/limit "
              f"{v['graph']:.2f}{whole} finite={v['finite']}", flush=True)
    fails = cs.xlstm_train_fails(r)
    print(f"  xlstm training path check: {'fails' if fails else 'passes'} the gate", flush=True)
    if not fails:
        raise SystemExit(1)


if __name__ == "__main__":
    card_check() if sys.argv[1:2] == ["--card"] else cpu_check()
