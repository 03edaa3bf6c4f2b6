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
scores (Q K^T o W as bf16 hi alone: a precision loss, no lost term), each
of those two required to fail every case by 8x or more; the flash kernel (K4) skips the diagonal KV
tile, in its FMA body and in its tensor-core body; K4's backward skips
the diagonal q tile in its dK / dV pass or loses kv tile 0 in its dQ
pass; K5's backward drops the gradient carried back over the chunks in
its state pass, or loses dq's inter-chunk term; K6's backward loses
dgrad's parity test (at a stride, a tap counts where it should not) or
drops wgrad's last slice of pixels where it splits K; the dense decode
kernel's (K3's) FMA body skips the last live KV tile; the matmul kernel
(K7) loses its first 32-deep slice of K in its FMA body, or its first
64-deep K stage in its wgmma body.  Builds each kernel the file feeds
from the copy and runs chip_smoke's gate on that kernel's cases (fp32
and bf16 for attention and the scan -- for an int8 loader the paged
kernels' cases on int8 pools, ``quantize_kv`` of the same pools, held
against the plain version in fp32 on the dequantized values -- at zamba2 widths for K5, on
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
for conv; K4's, K3's, K5's and K6's FMA bodies: fp32; the backward
kernels' one body: fp32 and bf16 (K6's: fp32 and fp16, dgrad's broken
parity on the cases that ask for dx at stride 2, wgrad's dropped slice on
the cases it splits); K6's reduction: the cases
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
SSM_CARRY = "hs[n * PT + p] = decay * hs[n * PT + p] + s;"
SSM_DROP_CARRY = "hs[n * PT + p] = s;  // the carried state is dropped"
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
K5B_CARRY = "g = decay * g + u;"
K5B_DROP_CARRY = "g = u;  // the gradient carried back is dropped"
K5B_INTER = "dq_acc[a][c] = fmaf(wq, z[a][c], dq_acc[a][c]);"
K6B_PARITY = "if (oh * g.stride == nh && ow * g.stride == nw && oh < g.Hout && ow < g.Wout)"
K6B_NO_PARITY = "if (oh < g.Hout && ow < g.Wout)  // the parity test lost"
K6B_SLICE = "const int2 sl = slice_of(K, splits);     // this block's pixels"
K6B_DROP_SLICE = ("const int2 sl = splits > 1 && blockIdx.z == splits - 1 ? make_int2(0, 0) "
                  ": slice_of(K, splits);  // the last slice of pixels dropped")
K5B_LOSE_INTER = "(void)wq;  // the inter-chunk term of dq is lost"
# the backward kernels' cases: K4's on chip_smoke's phase 21a shapes, K5's
# at zamba2's widths with a carried state and d_final; K6's on the conv
# gate shapes at batch 8 (dx where training asks for it) and phase 22a's
# extra cases (stride 2 with dx, odd maps)
K4B_GATE_CASES = ((1, 512, 16, 2, 128), (1, 512, 32, 32, 64), (1, 333, 32, 32, 64))
K5B_GATE_S = (512, 1000)
K7_ADD = "for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];"
K7_LOSE_SLICE = ("for (int j = 0; j < TN; ++j) "
                 "acc[i][j] += (k0 == 0 && K > 2 * BK) ? 0.f : part[i][j];  // slice 0 lost")
MMA_TILE_LOOP = "for (int tile = 0; tile < ntiles; ++tile) {"
MMA_SKIP_DIAGONAL = "for (int tile = 0; tile < ntiles - causal; ++tile) {"
K7_STAGE = "for (int kk = 0; kk < WG_BK / 16; ++kk) {"
K7_LOSE_STAGE = ("for (int kk = (kt == 0 && nk > 1) ? WG_BK / 16 : 0; kk < WG_BK / 16; "
                 "++kk) {  // stage 0 lost")
K2_TILE_STEP = "mma_attn::tile_step<D>(st, qf, kt, vt, base, pa, pb, score);"
K2_SKIP_TILE_0 = ("if (tile > 0) mma_attn::tile_step<D>(st, qf, kt, vt, base, pa, pb, score);"
                  "  // tile 0 lost")
SPLIT_MASK = "if (key >= nrows) x = NEG_INF;"
SPLIT_SKIP_ROWS = "if (key >= nrows || key < 16) x = NEG_INF;  // first 16 rows lost"
MERGE_LOOP = "for (int i = 0; i < ns; ++i) {"
MERGE_DROP_SPLIT_0 = "for (int i = 1; i < ns; ++i) {  // split 0 lost"
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
# given])).  The cases that count are those the route sends to the broken
# body (None: every case; "split": K6's cases cut into K slices), and for
# the paged kernels' FMA bodies only the cases with more than two live
# pool blocks, since the short ones have no block 0 to skip.
ALL = ("float32", "float16", "bfloat16")
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
     (("ssm_scan", ("float32",), "fma"),)),
    ("ssm_scan.cu", SSD_CARRY, SSD_DROP_CARRY,
     "tensor-core body: the state passing drops the state carried into each chunk",
     (("ssm_scan", ("bfloat16",), "mma", 8),)),
    ("ssm_scan.cu", SSD_PARTS, SSD_LOSE_LO,
     "tensor-core body: the weighted scores lose their lo half (bf16 hi alone)",
     (("ssm_scan", ("bfloat16",), "mma", 8),)),
    ("flash_attention.cu", TILE_LOOP, SKIP_DIAGONAL,
     "FMA body: skips the diagonal KV tile when causal",
     (("flash_attention", ("float32", "bfloat16"), "fma"),)),
    ("flash_attention.cu", MMA_TILE_LOOP, MMA_SKIP_DIAGONAL,
     "tensor-core body: skips the diagonal KV tile when causal",
     (("flash_attention", ("bfloat16",), "mma"),)),
    ("flash_attention_backward.cu", K4B_DKDV_LOOP, K4B_DKDV_SKIP_DIAGONAL,
     "K4's backward: the dK / dV pass skips the diagonal q tile",
     (("flash_attention_backward", ("float32", "bfloat16"), "fma"),)),
    ("flash_attention_backward.cu", K4B_DQ_ADD, K4B_DQ_SKIP_TILE_0,
     "K4's backward: the dQ pass loses kv tile 0",
     (("flash_attention_backward", ("float32", "bfloat16"), "fma"),)),
    ("ssm_scan_backward.cu", K5B_CARRY, K5B_DROP_CARRY,
     "K5's backward: the state pass drops the gradient carried back into each chunk",
     (("ssm_scan_backward", ("float32", "bfloat16"), "fma"),)),
    ("ssm_scan_backward.cu", K5B_INTER, K5B_LOSE_INTER,
     "K5's backward: dq loses its inter-chunk term",
     (("ssm_scan_backward", ("float32", "bfloat16"), "fma"),)),
    ("conv2d_backward.cu", K6B_PARITY, K6B_NO_PARITY,
     "K6's backward: dgrad loses its parity test (a tap counts where h + pt - i is not a "
     "multiple of the stride)", (("conv2d_backward", ("float32", "float16"), "dgrad_s2"),)),
    ("conv2d_backward.cu", K6B_SLICE, K6B_DROP_SLICE,
     "K6's backward: wgrad drops its last slice of pixels where it splits K",
     (("conv2d_backward", ("float32", "float16"), "wgrad_split"),)),
    ("decode_attention.cu", TILE_LOOP, SKIP_LAST_TILE, "FMA body: skips the last live KV tile",
     (("decode_attention", ("float32", "bfloat16"), "fma"),)),
    ("matmul.cu", K7_ADD, K7_LOSE_SLICE,
     "FMA body: loses the first 32-deep slice of K when K > 64",
     (("matmul", ("float32", "bfloat16", "float16"), "fma"),)),
    ("matmul.cu", K7_STAGE, K7_LOSE_STAGE,
     "wgmma body: loses its first 64-deep K stage when K > 64",
     (("matmul", ("bfloat16", "float16"), "wgmma"),)),
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
            path = Path(d) / "src" / "repro_torch" / "csrc" / source
            code = path.read_text()
            if code.count(text) != 1:
                raise SystemExit(f"{source}: {text!r} not found once")
            path.write_text(code.replace(text, broken))
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
    from repro_torch.kernels.conv2d.ops import backward_splits
    from repro_torch.kernels.conv2d.ops import body_for as conv_body_for
    from repro_torch.kernels.decode_attention.ops import body_for as decode_body_for
    from repro_torch.kernels.flash_attention.ops import body_for as flash_body_for
    from repro_torch.kernels.matmul.ops import body_for as matmul_body_for
    from repro_torch.kernels.prefill_attention.ops import body_for as prefill_body_for
    from repro_torch.kernels.ssm_scan.ops import body_for as ssm_body_for
    build.build([name])
    kern = dispatch.kernel_table()[name]

    def conv_tags(args, kw):
        body = conv_body_for(*args[:2])
        split = cs.conv_slices(*args[:2], kw["stride"], body) > 1
        return {body} | ({"split"} if split else set())

    def conv_bwd_tags(args, kw):
        dx_splits, dw_splits = backward_splits(args[0].shape, args[1].shape, kw["stride"])
        dgrad = kw["need_dx"]
        return ({"wgrad"} | ({"dgrad"} if dgrad else set())
                | ({"dgrad_s2"} if dgrad and kw["stride"] > 1 else set())
                | ({"wgrad_split"} if dw_splits > 1 else set()))

    # what a case runs: its body, and for K6 whether K is split (its
    # backward: which passes, dgrad at a stride, wgrad split)
    tags_of = {"matmul": lambda args, kw: {matmul_body_for(*args[:2])},
               "flash_attention": lambda args, kw: {flash_body_for(args[0])},
               "decode_attention": lambda args, kw: {decode_body_for(args[0], args[1])},
               "paged_decode_attention": lambda args, kw: {decode_body_for(args[0], args[1])},
               "paged_prefill_attention": lambda args, kw: {prefill_body_for(args[0],
                                                                             args[1])},
               "ssm_scan": lambda args, kw: {ssm_body_for(*args[:3])},
               "flash_attention_backward": lambda args, kw: {"fma"},
               "ssm_scan_backward": lambda args, kw: {"fma"},
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
            ref = kern.plain(*(a.float() if a.is_floating_point() else a
                               for a in plain_args), **kw)
            torch.cuda.synchronize()
            ratio = (kern.tolerance(out, ref, args[0].shape[1]) if name == "matmul"
                     else kern.tolerance(out, ref))
            if ratio > 1:
                failed.append(ratio)
            long = not paged_fma or int(args[-1].max()) > 2 * BS
            if str(dtype)[6:] in must_fail and (not broken_body or broken_body in tags) \
                    and long:
                served += 1
                missed += not (ratio > 1 and ratio >= least)
            print(f"  {label} {str(dtype)[6:]}{f' runs {sorted(tags)}' if tags else ''}: "
                  f"err/limit {ratio:.2f}{'' if ratio > 1 else '  (passes the gate)'}",
                  flush=True)
        print(f"  {str(dtype)[6:]}: {len(failed)} of {len(cases)} cases fail the "
              f"gate, least err/limit among them {min(failed, default=0):.2f}"
              + (f"; {served} on the broken body, each of which must fail"
                 + (f" by {least:g}x or more" if least > 1 else "")
                 + f": {served - missed} do" if str(dtype)[6:] in must_fail else ""),
              flush=True)
        if missed:
            caught = False
    if not caught:
        raise SystemExit(1)


if __name__ == "__main__":
    card_check() if sys.argv[1:2] == ["--card"] else cpu_check()
