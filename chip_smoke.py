#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each one raises on failure; the script then exits non-zero):

1. Card: require CUDA, print the card's name and power limit.
2. Build: compile every kernel in ``src/repro_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, in parallel); print ``-Xptxas -v``.
3. Kernels: hold K1 and K2 against their plain PyTorch versions on the
   card at qwen2.5-3b widths (H=16, K=2, D=128, block 16), with fp32 and
   with bf16 pools (limits in ``repro_torch.kernels.dispatch``: fp32 1e-4;
   bf16 2^-7 |ref| + 2^-6 rms(ref) per element, against the plain version
   evaluated in fp32 on the same bf16 values), each case printed with the
   body its route takes (bf16: the tensor-core ``mma`` bodies, K1 split
   over the KV length and merged; fp32: FMA) and run twice: as made, and
   with NaN in every pool row that is not a live row of some sequence
   (the plain version then reads the pool as made).  K1: boundary
   lengths, a length-0 sequence, softcap, B=1 at 4096 and 16384; K2: C =
   4 / 16 / 256 at q_start 0, 9, 27, 256 and 2048.  Then both bodies of
   each timed in bf16 beside the plain version, one
   ``scaled_dot_product_attention`` call on the same values and the least
   time the card could take; and the host's time per call of each body.
4. Serving: qwen2.5-3b at full width (random weights from seed 0) through
   ``repro_torch``'s paged ``ServingEngine``: 4 slots, 256-token prefill
   chunks, 8 greedy requests of 256-1024 prompt tokens (half share a
   256-token prefix), 32 new tokens each.  The kernels' launch counts are
   zeroed just before and read just after and held exactly, by body: K1
   36 a decode step and K2 36 a prefill chunk, all on ``mma``; K7 by body;
   no plain version.
5. Profile: a short serving run under ``torch.profiler``; device time by
   kernel and the device's busy share of the wall time.
6. Path check: one request served at full width in fp32 by an engine
   through the kernels and by one through the plain versions; its prefill
   and decode logits are compared at depths 1, 2 and 4 (gated) and 36
   (printed beside two plain runs that differ only in summation order),
   and each side's distance from a run whose weight products are summed
   in fp64 and rounded once is printed.
7. K6 conv2d: the kernel held against its plain version (evaluated in fp32
   on the same values; limits ``CONV_RTOL`` / ``CONV_RMS_ATOL`` in
   ``repro_torch.kernels.dispatch``) on every distinct conv shape of
   GoogLeNet's batch-8 forward at 224: at fp32 on the FMA body, at fp16
   and bf16 on both bodies (the tensor-core ``mma`` body is the route's
   at 16 bits), each case printed with its K slices
   (split-K where the output tiles are fewer than the SMs) and, where
   split, launched twice and required to give the same bits; then each of
   the 57 convolutions timed at fp32 (FMA) and fp16 (the route's body and
   the FMA body) beside its plain version, one ``F.conv2d`` call (cuDNN,
   channels_last, TF32 off) and its bound; and the host's time per call.
8. GoogLeNet: full width (224x224x3, 1000 classes, 9 inception modules),
   random weights from seed 0, ``SyntheticImages``, at fp32 and fp16:
   (a) batch-8 logits through the kernels vs through the plain versions
   (gated: largest difference over the largest logit, ``TOL_GOOGLENET``,
   and the same top-1); (a') the batch-8 forward's host time: enqueue
   alone (median of 20) and 20 forwards back to back, one sync, without
   the engine; (b) img/s, time per batch and img/W against the
   power limit through ``OffloadEngine([TorchTarget])`` at batch 1 and 8,
   with (c) the conv kernel's counts zeroed before and read after each
   run: 57 launches per forward by body (fp32: 57 FMA; fp16: 57 mma), no
   plain call; (d) the paper's fig 7
   estimators (fp16 and bf16 vs fp32 over 48 images); (e) one batch-8
   forward under ``torch.profiler``: device busy share and the conv
   kernel's share of device time.
9. zamba2 kernels: K5 ``ssm_scan``, K4 ``flash_attention`` and K3
   ``decode_attention`` held against their plain versions (evaluated in
   fp32 on the same values) at zamba2-1.2b widths -- K5 at B=1, H=64,
   N=P=64, chunk 128, S 1000 and 1024, B/C as a stride-0 head view, y and
   the final state (limit ``SSM_RTOL`` of the largest |ref|), plus per-head
   q/k at H=4, N=P=128; K4 at S 1000 and 1024 on ``K4_SHAPES`` (zamba2's
   H=K=32, D=64 and qwen2.5-3b's H=16, K=2, D=128; bf16 on the
   tensor-core body, fp32 on the FMA body); K3 on ``DENSE_DECODE_CASES``
   (zamba2's B=4, S=1088, lengths 1033/700/257/1200, the last past S as
   an idle slot; a length-0 row; S not a multiple of 64; qwen2.5-3b's
   heads) -- bf16 on the split body, fp32 on the FMA body, each as made
   and with NaN in every cache row at or past the length -- at fp32 and
   bf16, then each timed in bf16 beside its bound, its plain version and
   (K3, K4) ``scaled_dot_product_attention`` on the same tensors (K3 on
   both bodies, and its host time per call); K4 also at qwen2.5-3b's
   heads, S=1024, printed.
10. zamba2 serving: zamba2-1.2b at full width (38 layers: 6 segments of 6
   Mamba-2 layers and the shared attention block, a 2-layer tail), bf16,
   random weights from seed 0, through the contiguous ``ServingEngine``:
   4 slots, ``max_len`` 1088, 8 greedy requests of 203-1000 prompt tokens
   (none a multiple of 128), 32 new tokens each.  Launch counts zeroed
   just before and read just after, held exactly: K5 38 per prefill, K4 6
   per prefill (every one on the tensor-core body), K3 6 per decode step
   (every one on the split body),
   K7 by body (the bf16 products on wgmma, the fp32 LM head on FMA), no
   plain call.  tok/s, TTFT, TPOT,
   tok/s/W against the power limit, peak memory; then a profiled window
   of prefills and decode steps.
11. zamba2 path check: one 333-token request served at full width in fp32
   by a contiguous engine through the kernels and by one through the plain
   versions, prefill and decode logits compared at depths 6 (one segment)
   and 13 (two segments and a 1-layer tail), gated by ``TOL_HYBRID_PATH_REL``,
   and 38, printed.
12. K7 matmul: the kernel held against its plain version (evaluated in fp32
   on the same values; limit ``dispatch.matmul_tolerance_ratio``) on
   ``K7_CASES``: the training and decode MLP products, the tied LM head
   with y a transposed view, the K/V projection, ragged M / N / K, the
   backward's transposed operands, a row of 600 bytes (16-bit on FMA)
   and zamba2-1.2b's products at M = 1000 and 4, at fp32 / bf16 (fp16 on
   three), each printed with the body it ran (fp16 / bf16 operands that
   TMA can read: wgmma; the rest: FMA); its two tile shapes bit for bit on
   ``K7_TILING``, each bf16 case on the body it names; then ``K7_TIMED``
   timed beside the plain version, one ``torch.matmul`` (cuBLAS, TF32 off)
   and the bound; then the host's time per launch on ``K7_HOST`` (wgmma
   and FMA bodies, the route alone, ``torch.matmul``), printed.
13. K7's backward: ``linear.matmul`` of (512, 2048) x (2048, 11008) bf16,
   forward, dX and dW against autograd through the plain version in fp32;
   three launches, all on the wgmma body (dX and dW from autograd's
   thread).
14. Training path check: qwen2.5-3b at full width cut to 2 layers, fp32,
   one 1 x 512 microbatch: the loss and every gradient leaf through the
   kernels vs through the plain versions (``TOL_TRAIN_LOSS_REL``,
   ``TOL_TRAIN_GRAD_REL``).
15. Training: qwen2.5-3b at full width (36 layers, fp32 master weights,
   bf16 compute, remat "full", AdamW) for 4 steps of 8 x 512 tokens in 8
   microbatches (``--accum 8``) through ``repro_torch.launch.train``: every
   loss finite, K7 launches exactly 1011 a microbatch (derived from the
   config): 1008 bf16 block products on wgmma and the fp32 LM head's 3 on
   FMA; no plain call; step time, tokens/s, tokens/s/W against the power
   limit, peak memory; one more step under ``torch.profiler``.
16. Checkpoint round trip on the card (full width, 2 layers): save after 2
   steps, restore into a fresh trainer, one more step in both; identical
   bit for bit.

K7 also carries every weight product of phases 4-11 (the serving paths and
GoogLeNet's classifier): phases 4, 6, 8, 10 and 11 hold its launch counts
too (exactly, where the engine's calls fix them; phases 4 and 10 by body).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the kernel table (``{"kernels": [...]}``).
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak (K1, K2)
# Kernel cases, qwen2.5-3b widths: K1 (lengths of the sequences, softcap:
# block and split boundaries, a length-0 sequence, one long sequence) and
# K2 (chunk rows C, q_start: a speculative verify's C = 4 at mid-block
# starts, a chunk behind a long seeded history).
DECODE_CASES = (((1, 15, 16, 17), 0.0), ((300, 1056, 16, 1), 0.0),
                ((1, 15, 300, 1056), 30.0), ((0, 1, 64, 65), 0.0), ((4096,), 0.0),
                ((16384,), 30.0))
PREFILL_CASES = ((16, 0), (16, 9), (16, 256), (256, 0), (256, 9), (256, 256), (4, 9),
                 (4, 27), (256, 2048))
# K1 timed: serving's 4 slots, then one long sequence (the split's case)
DECODE_TIMED = ((1056, 800, 512, 300), (4096,), (16384,))
# fp32 path check, kernels vs plain versions, by depth: limits on the
# largest logit difference relative to the largest logit (see path_check);
# and at those depths each side's distance from the exact-products run:
# the kernels' no more than TOL_PATH_EXACT_RATIO times the plain versions'
# (floored at 1e-7).  Depth 1 was gated at 1e-5 until the exact-products
# run showed the plain versions themselves (cuBLAS fp32 products) 1.10e-5
# from it at depth 1 and the kernels 2.24e-6 (NVIDIA H100 80GB HBM3): the
# 1e-5 limit measured cuBLAS's rounding, so it is 2e-5, about twice the
# plain side's own distance, and the ratio holds the kernels to the exact
# products.
TOL_PATH_REL = {1: 2e-5, 2: 1e-4, 4: 1e-2}
TOL_PATH_EXACT_RATIO = 2.0
LM_KERNELS = ("paged_decode_attention", "paged_prefill_attention")
# K6: GoogLeNet's batch-8 forward at 224.  Peak rate for each type timed
# (H100 SXM data sheet, dense): fp32 on the CUDA cores, fp16 / bf16 on the
# tensor cores.
CONV_BATCH, CONV_SIZE = 8, 224
PEAK_FLOPS = {"float32": 67e12, "float16": 989e12}
# The shapes kernel_gate_check.py holds its broken kernels on: stem1 (Cin
# 3, 7x7/2, padding 2 before and 3 after), stem2, 3a.b3 (5x5), 4a.b2 (Cout
# 208), 4b.b3r (1x1 to 24) and 5b.b2 (a 7x7 map).
CONV_GATE_SHAPES = ("stem1", "stem2", "3a.b3", "4a.b2", "4b.b3r", "5b.b2")
# GoogLeNet batch-8 logits, kernels vs plain versions on the same weights
# and images: largest difference over the largest logit.  fp32: the two
# sum in other orders (~1e-6 expected); fp16: both round each conv once,
# but other summation orders flip roundings (~1e-3 expected, as the CPU
# test against the JAX model reads 6.9e-4 for other round points).
TOL_GOOGLENET = {"fp32": 1e-4, "fp16": 4e-3}
# K6 launches of one GoogLeNet forward by body: fp32 all on FMA, fp16 all on
# the tensor cores (stem1's 3-channel pixels gathered element by element).
CONV_BODIES = {"fp32": {"fma": 57}, "fp16": {"mma": 57}}
# zamba2-1.2b: the serving phase's prompts (none a multiple of the scan's
# 128-row chunk) and the per-slot cache; the kernels it must launch.
ZAMBA_PROMPTS = (203, 317, 450, 511, 647, 777, 901, 1000)
ZAMBA_MAX_LEN = 1088
HYBRID_KERNELS = ("ssm_scan", "flash_attention", "decode_attention")
# K3 cases (lengths, S, H, K, D): zamba2's decode step (the last slot past
# S, as an idle slot), a length-0 row and split boundaries, S not a
# multiple of 64, and qwen2.5-3b's heads (G = 8, D = 128) on a contiguous
# cache.  The first is the timed one.
DENSE_DECODE_CASES = (((1033, 700, 257, 1200), ZAMBA_MAX_LEN, 32, 32, 64),
                      ((0, 1, 64, 65), ZAMBA_MAX_LEN, 32, 32, 64),
                      ((999, 1000, 5, 2000), 1000, 32, 32, 64),
                      ((1033, 700, 257, 1200), ZAMBA_MAX_LEN, 16, 2, 128))
FP32_FLOPS = 67e12             # H100 SXM fp32 on the CUDA cores (K5's arithmetic)
# fp32 path check of zamba2, kernels vs plain versions, by depth (6: one
# segment and one shared-block application; 13: two and a 1-layer tail):
# limits on the largest logit difference relative to the largest logit,
# set before the first run from the transformer's path check above (2
# attention layers read 1.3e-6, 4 layers 3.0e-4).
TOL_HYBRID_PATH_REL = {6: 1e-4, 13: 1e-2}
QWEN_PRODUCTS = 7       # weight products a qwen2.5-3b block makes: wq wk wv wo, gate up down
# K7 cases held against the plain version: (label, M, K, N, layout, dtypes).
# The three timed shapes, then ragged M / N / K and the transposed operands
# of the backward products and the tied LM head, a row TMA cannot read
# (16-bit on the FMA body), and zamba2-1.2b's weight products.
K7_CASES = (
    ("training mlp up", 512, 2048, 11008, "rows", ("float32", "bfloat16", "float16")),
    ("decode mlp up", 4, 2048, 11008, "rows", ("float32", "bfloat16")),
    ("tied lm head, y = tok.T", 512, 2048, 151936, "y.T", ("float32",)),
    ("k/v projection", 512, 2048, 256, "rows", ("float32", "bfloat16", "float16")),
    ("training dW = X^T @ dY", 2048, 512, 11008, "x.T", ("float32", "bfloat16")),
    ("ragged M=1", 1, 2048, 256, "rows", ("float32", "bfloat16")),
    ("ragged M=5 K=11008", 5, 11008, 2048, "rows", ("float32", "bfloat16")),
    ("ragged M=513", 513, 2048, 11008, "rows", ("float32", "bfloat16")),
    ("dX = dY @ W^T", 513, 11008, 2048, "y.T", ("float32", "bfloat16")),
    ("dW = X^T @ dY", 2048, 513, 11008, "x.T", ("float32", "bfloat16")),
    ("both transposed", 256, 11008, 513, "both.T", ("float32", "bfloat16")),
    ("row of 600 bytes (16-bit on FMA)", 513, 2048, 300, "rows",
     ("float32", "bfloat16", "float16")),
) + tuple(
    # zamba2-1.2b's products at its longest prompt and at decode (4 slots)
    (f"zamba2 {label}", M, K, N, "rows", ("float32", "bfloat16"))
    for M in (1000, 4)
    for label, K, N in (("mamba in_proj", 2048, 8384),
                        ("mamba out_proj, shared in_proj", 4096, 2048),
                        ("attention q/k/v/o", 2048, 2048), ("mlp gate/up", 2048, 8192),
                        ("mlp down", 8192, 2048)))
# (label, M, K, N, layout, dtype) timed for PERF.md; the first is the kernels line's
K7_TIMED = (("training mlp up", 512, 2048, 11008, "rows", "bfloat16"),
            ("decode mlp up", 4, 2048, 11008, "rows", "bfloat16"),
            ("tied lm head, y = tok.T", 512, 2048, 151936, "y.T", "float32"),
            ("k/v projection", 512, 2048, 256, "rows", "bfloat16"),
            ("training dW = X^T @ dY", 2048, 512, 11008, "x.T", "bfloat16"))
# K7's host cost per launch, at the decode products of qwen2.5-3b and
# zamba2-1.2b: (label, M, K, N); launches timed back to back.
K7_HOST = (("qwen mlp up", 4, 2048, 11008), ("qwen k/v projection", 4, 2048, 256),
           ("zamba2 mamba in_proj", 4, 2048, 8384), ("zamba2 mlp down", 4, 8192, 2048))
HOST_REPS = 200
# The two tiles bit for bit: (M, K, N, the body the bf16 case must take).
# N = 300 is a row of 600 bytes, which TMA cannot read: the FMA body.
K7_TILING = ((1, 2048, 256, "wgmma"), (5, 11008, 2048, "wgmma"), (16, 2048, 11008, "wgmma"),
             (513, 2048, 300, "fma"), (513, 2048, 11008, "wgmma"))
# K4 cases: (B, S, H, K, D) -- zamba2's shared block (G = 1, D = 64) and
# qwen2.5-3b's heads (G = 8, D = 128) -- held at fp32 and bf16, each S.
K4_SHAPES = ((1, 32, 32, 64), (1, 16, 2, 128))
K4_S = (1000, 1024)
# Training path check (fp32, full width, 2 layers, one 1 x 512 microbatch):
# kernels vs plain versions, the loss relative and each gradient leaf
# relative to its largest entry; and both against a third run whose weight
# products are summed in fp64 and rounded once ("exact products").  The
# random model's near-one-hot attention amplifies every rounding of the
# backward: the plain versions' own gradients (cuBLAS fp32 products) sit
# up to 7.4e-3 of a leaf's largest from the exact-products run, the
# kernels' 6.5e-3 (NVIDIA H100 80GB HBM3), so two right fp32 paths differ
# by ~1e-2.  Gates: the loss within 1e-5; each leaf within 2e-2 of the
# plain versions' and no more than TOL_TRAIN_EXACT_RATIO times as far from
# the exact products as the plain versions' is.  (Set at 1e-3 before the
# first run, which read 9.3e-3; the exact-products run then showed the
# plain path itself 7.4e-3 away.)
TOL_TRAIN_LOSS_REL = 1e-5
TOL_TRAIN_GRAD_REL = 2e-2
TOL_TRAIN_EXACT_RATIO = 2.0
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 8, 512


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of one call, L2 flushed before each call (the
    serving path reaches each layer's pools cold), CUDA events around the
    call alone.  The device spins for ~5 ms (``torch.cuda._sleep``) before
    the start event, so the host has enqueued the call before the device
    reaches it: the events time the device's work, not the host's launch
    cost (a conv of 0.02 GFLOP otherwise reads the ~0.05 ms its Python
    launcher takes)."""

    SPIN_CYCLES = 10_000_000        # ~5 ms at the H100's ~2 GHz clock

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / self.reps


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    """Least time of the work on the card (ms) and what bounds it: the
    bytes over the memory rate or the operations over ``peak``."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def decode_case(torch, lengths, dtype, *, H=16, K=2, D=128, bs=16, seed=0):
    """Random pool, shuffled disjoint block tables, given lengths (one
    sequence each)."""
    g = torch.Generator("cuda").manual_seed(seed)
    B = len(lengths)
    mb = max(-(-n // bs) for n in lengths) + 1
    N = 1 + B * mb
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)
    kp = torch.randn((N, bs, K, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((N, bs, K, D), generator=g, device="cuda").to(dtype)
    tables = (1 + torch.randperm(B * mb, generator=g, device="cuda")
              ).reshape(B, mb).int()
    for b, n in enumerate(lengths):          # past the live blocks: trash
        tables[b, -(-n // bs):] = 0
    kp[0], vp[0] = 1e4, -1e4                 # poisoned trash, never attended
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens


def prefill_case(torch, C, q_start, dtype, *, seeded_blocks, H=16, K=2, D=128,
                 bs=16, seed=0):
    """One sequence: a pool, a table of ``seeded_blocks`` + the chunk's
    blocks (a partly seeded table), chunk rows at ``q_start``."""
    g = torch.Generator("cuda").manual_seed(seed)
    mb = max(seeded_blocks, -(-(q_start + C) // bs)) + 2
    N = 1 + mb
    q = torch.randn((1, C, H, D), generator=g, device="cuda").to(dtype)
    kp = torch.randn((N, bs, K, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((N, bs, K, D), generator=g, device="cuda").to(dtype)
    tables = (1 + torch.randperm(mb, generator=g, device="cuda")).reshape(1, mb).int()
    tables[0, -(-(q_start + C) // bs):] = 0  # past the chunk: trash
    kp[0], vp[0] = 1e4, -1e4                 # poisoned trash, never attended
    qs = torch.tensor([q_start], dtype=torch.int32, device="cuda")
    lens = qs + C
    return q, kp, vp, tables, qs, lens


def poison_dead_rows(torch, kp, vp, tables, lengths) -> None:
    """NaN into every pool row that is not a live row of some sequence:
    past each length in its last block, the trash block, blocks no table
    reaches.  A kernel that reads such a row, or lets a masked product
    touch it (0 x NaN), returns NaN."""
    B, mb = tables.shape
    bs = kp.shape[1]
    pos = torch.arange(mb * bs, device=kp.device)
    live = torch.zeros(kp.shape[:2], dtype=torch.bool, device=kp.device)
    for b in range(B):
        n = int(lengths[b])
        live[tables[b, pos[:n] // bs].long(), pos[:n] % bs] = True
    kp[~live] = float("nan")
    vp[~live] = float("nan")


def hold(torch, kern, args, label, *, poison=None, body=None, **kw) -> float:
    """Launch ``kern`` on one case and hold it against its plain version
    evaluated in fp32 on the same values; raise past the kernel's limit
    (``kern.tolerance``).  A kernel with several outputs (K5: y and the
    final state) is held on each.  ``poison(args)``, where given, changes
    the operands in place after the plain version has read them and
    before the kernel does (rows the kernel must not read).  ``body``, where
    given, overrides the kernel's route.  Returns the largest absolute
    error."""
    ref = kern.plain(*(a.float() if a.is_floating_point() else a for a in args), **kw)
    if poison is not None:
        torch.cuda.synchronize()
        poison(args)
    out = kern.launch(*args, **kw, **({"body": body} if body else {}))
    torch.cuda.synchronize()
    pairs = zip(out, ref) if isinstance(out, tuple) else [(out, ref)]
    err = max((o.float() - r.float()).abs().max().item() for o, r in pairs)
    ratio = kern.tolerance(out, ref)
    log(f"{kern.name} {label} {str(args[0].dtype)[6:]}: max_abs_err={err:.3e} "
        f"err/limit={ratio:.3f}")
    if not ratio <= 1.0:
        raise AssertionError(f"{kern.name} {label} disagrees with its plain "
                             f"version: err/limit {ratio}")
    return err


def gathered(torch, kp, vp, tables, G):
    """The pool gathered into logical order with kv heads repeated for the
    library call: (B, H, S, D)."""
    B, mb = tables.shape
    _, bs, K, D = kp.shape
    k = kp[tables.long()].reshape(B, mb * bs, K, D).repeat_interleave(G, 2)
    v = vp[tables.long()].reshape(B, mb * bs, K, D).repeat_interleave(G, 2)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def decode_work(lengths, *, H=16, K=2, D=128, bs=16) -> tuple[float, float]:
    """(bytes, flops) one K1 call must move and do: q and out, each live K
    and V row once, the live table entries and lengths; QK^T and PV over
    the live rows, two flops a multiply-add."""
    rows = sum(lengths)
    nbytes = 2 * (2 * len(lengths) * H * D + 2 * rows * K * D) \
        + 4 * (len(lengths) + sum(-(-n // bs) for n in lengths))
    return nbytes, 4 * H * D * rows


def decode_library(torch, F, args, G):
    """One SDPA call on the same values: the pool gathered to (B, H, S, D),
    a length mask."""
    q, kp, vp, tables, lens = args
    kg, vg = gathered(torch, kp, vp, tables, G)
    mask = (torch.arange(kg.shape[2], device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qh = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask)


def kernel_phase(torch, table):
    """Phase 3: K1 and K2 against their plain versions (each case as made
    and NaN-poisoned), then both bodies timed, and their host cost."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import body_for as dec_body_for
    from repro_torch.kernels.decode_attention.ops import num_splits
    from repro_torch.kernels.prefill_attention.ops import body_for as pre_body_for
    dec = table["paged_decode_attention"]
    pre = table["paged_prefill_attention"]
    timer = Timer(torch)
    results = {}

    def poison_decode(args):
        poison_dead_rows(torch, args[1], args[2], args[3], args[4])

    def poison_prefill(args):
        poison_dead_rows(torch, args[1], args[2], args[3], args[5])

    # --- K1 paged decode: boundary lengths, long lengths, softcap ---------
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in errs:
        for lengths, softcap in DECODE_CASES:
            for poison in (None, poison_decode):
                args = decode_case(torch, lengths, dtype)
                body = dec_body_for(args[0], args[1])
                splits = (f" splits={num_splits(args[3].shape[1], 16)}" if body == "mma"
                          else "")
                errs[dtype] = max(errs[dtype], hold(
                    torch, dec, args, f"lengths={lengths} softcap={softcap} body={body}"
                    f"{splits}{' NaN past the lengths' if poison else ''}",
                    poison=poison, softcap=softcap))
    err_dec = errs[torch.bfloat16]
    # timed: serving's 4 slots (the kernels line's), then B=1 at 4096 and 16384
    for lengths in DECODE_TIMED:
        args = decode_case(torch, lengths, torch.bfloat16)
        q, kp = args[0], args[1]
        G = q.shape[1] // kp.shape[2]
        ms = {body: timer(lambda: dec.launch(*args, body=body)) for body in ("mma", "fma")}
        plain_ms = timer(lambda: dec.plain(*args))
        lib_ms = timer(decode_library(torch, F, args, G))
        nbytes, flops = decode_work(lengths)
        bms, by = bound(nbytes, flops, BF16_FLOPS)
        shape = f"B={len(lengths)} lengths={lengths} bf16"
        log(f"paged_decode_attention timed {shape}: mma (split, "
            f"{num_splits(args[3].shape[1], 16)} splits) {ms['mma']:.4f}ms fma "
            f"{ms['fma']:.4f}ms plain {plain_ms:.4f}ms library {lib_ms:.4f}ms bound "
            f"{bms:.5f}ms ({by}; {nbytes} B, {flops} flop)")
        if lengths == DECODE_TIMED[0]:
            results["paged_decode_attention"] = dict(
                max_abs_err=err_dec, max_abs_err_fp32=errs[torch.float32], ms=ms["mma"],
                fma_ms=ms["fma"], plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                flops=flops, shape=shape + " body=mma")
            host_cost(torch, dec, args, "paged_decode_attention", shape,
                      lambda: dec_body_for(q, kp))

    # --- K2 paged prefill: C = 4 / 16 / 256, q_start 0 .. 2048 -------------
    errs_pre = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in errs_pre:
        for C, q_start in PREFILL_CASES:
            for poison in (None, poison_prefill):
                args = prefill_case(torch, C, q_start, dtype,
                                    seeded_blocks=-(-q_start // 16) + 3)
                errs_pre[dtype] = max(errs_pre[dtype], hold(
                    torch, pre, args, f"C={C} q_start={q_start} body={pre_body_for(args[0])}"
                    f"{' NaN past the length' if poison else ''}", poison=poison))
    err_pre = errs_pre[torch.bfloat16]
    args = prefill_case(torch, 256, 256, torch.bfloat16, seeded_blocks=16)
    q, kp, vp, tables, qs, lens = args
    ms = {body: timer(lambda: pre.launch(*args, body=body)) for body in ("mma", "fma")}
    plain_ms = timer(lambda: pre.plain(*args))
    _, C, H, D = q.shape
    K = kp.shape[2]
    kg, vg = gathered(torch, kp, vp, tables, H // K)
    S = kg.shape[2]
    kpos = torch.arange(S, device="cuda")[None, :]
    qpos = (qs[:, None] + torch.arange(C, device="cuda")[None, :])[0][:, None]
    mask = ((kpos <= qpos) & (kpos < lens[0]))[None, None]
    qh = q.transpose(1, 2)
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask))
    start, n = 256, 256
    keys = sum(min(start + i + 1, start + n) for i in range(n))
    nbytes = 2 * (2 * C * H * D + 2 * (start + n) * K * D) + 4 * (2 + -(-(start + n) // 16))
    flops = 4 * H * D * keys
    blocks = -(-C * (H // K) // 64) * K
    log(f"paged_prefill_attention timed C=256 q_start=256 bf16: mma ({blocks} blocks of 64 "
        f"rows on 132 SMs) {ms['mma']:.4f}ms fma {ms['fma']:.4f}ms plain {plain_ms:.4f}ms "
        f"library {lib_ms:.4f}ms")
    results["paged_prefill_attention"] = dict(
        max_abs_err=err_pre, max_abs_err_fp32=errs_pre[torch.float32], ms=ms["mma"],
        fma_ms=ms["fma"], plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes, flops=flops,
        shape="C=256 q_start=256 bf16 body=mma")
    host_cost(torch, pre, args, "paged_prefill_attention", "C=256 q_start=256 bf16",
              lambda: pre_body_for(q))
    for r in results.values():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"], BF16_FLOPS)
    return results


def host_cost(torch, kern, args, name, shape, route) -> None:
    """The host's time per call of each body, through the launcher (checks,
    the route, the output and scratch allocations, the C call), and of the
    route decision alone; printed."""
    row = []
    for body in ("mma", "fma"):
        host, wall = host_us(torch, lambda: kern.launch(*args, body=body))
        row.append(f"{body} host {host:.2f} us wall {wall:.2f} us")
    route_host, _ = host_us(torch, route)
    log(f"{name} host per call, {shape}, {HOST_REPS} back to back: " + "; ".join(row)
        + f" (route {route_host:.2f} us)")


def serving_requests(cfg, np, Request, greedy):
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, size=256).astype(np.int32)
    lens = (1024, 300, 768, 512, 640, 256, 900, 400)
    reqs = []
    for i, n in enumerate(lens):
        own = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        if i % 2 == 0:                       # half share a 256-token prefix
            own[:256] = prefix
        reqs.append(Request(i, own, max_new_tokens=32, sampler=greedy()))
    return reqs


def serving_phase(torch, np, table):
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    cfg = arch_registry.config("qwen2.5-3b")
    t0 = time.monotonic()
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4,
                        prefill_chunk=256, device="cuda")
    del params                      # the engine keeps its own cast copy
    gc.collect()
    torch.cuda.synchronize()
    log(f"serving: qwen2.5-3b L={cfg.num_layers} d_model={cfg.d_model} "
        f"H={cfg.num_heads} K={cfg.num_kv_heads} D={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}; init {time.monotonic() - t0:.1f}s")
    # warm-up: one short request (cuBLAS handles, kernel loading)
    eng.serve([Request(100, np.arange(40, dtype=np.int32), max_new_tokens=4,
                       sampler=greedy())])
    reqs = serving_requests(cfg, np, Request, greedy)
    # count the prefill chunks (one model call each) as the engine makes them
    chunks = [0]
    prefill_paged = eng._prefill_paged

    def counted_prefill(*a, **kw):
        chunks[0] += 1
        return prefill_paged(*a, **kw)
    eng._prefill_paged = counted_prefill
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    eng._prefill_paged = prefill_paged
    counts = {name: (table[name].launches, table[name].plain_calls)
              for name in LM_KERNELS}
    # every K1 / K2 launch at bf16, D = 128, G = 8 on the tensor-core bodies:
    # one a layer of each decode step and of each prefill chunk
    attn_bodies = {n: dict(table[n].body_launches) for n in LM_KERNELS}
    want_attn = {"paged_decode_attention": {"mma": cfg.num_layers * stats.decode_steps},
                 "paged_prefill_attention": {"mma": cfg.num_layers * chunks[0]}}
    if attn_bodies != want_attn:
        raise AssertionError(f"serving: attention launches by body {attn_bodies}, expected "
                             f"{want_attn} ({stats.decode_steps} decode steps, {chunks[0]} "
                             f"prefill chunks)")
    k7 = (table["matmul"].launches, table["matmul"].plain_calls)
    # every model call (a prefill chunk: one K2 launch a layer; a decode
    # step: one K1 launch a layer) makes the blocks' products and the LM head
    calls = (counts["paged_decode_attention"][0] + counts["paged_prefill_attention"][0]) \
        // cfg.num_layers
    if k7 != ((cfg.num_layers * QWEN_PRODUCTS + 1) * calls, 0):
        raise AssertionError(f"serving: matmul launches/plain calls {k7} for {calls} "
                             f"model calls")
    # every bf16 block product on the tensor cores, the fp32 LM head on FMA
    k7_bodies = dict(table["matmul"].body_launches)
    if k7_bodies != {"wgmma": cfg.num_layers * QWEN_PRODUCTS * calls, "fma": calls}:
        raise AssertionError(f"serving: matmul launches by body {k7_bodies} for {calls} "
                             f"model calls")
    for r in reqs:
        if r.state.value != "done" or len(r.output) != 32:
            raise AssertionError(f"request {r.rid}: state {r.state}, "
                                 f"{len(r.output)} tokens")
    if not stats.prefill_tokens_computed < stats.prefill_tokens_total:
        raise AssertionError("no prefix was seeded: computed "
                             f"{stats.prefill_tokens_computed} of "
                             f"{stats.prefill_tokens_total}")
    for name, (launches, plain) in counts.items():
        if launches <= 0 or plain != 0:
            raise AssertionError(f"{name}: {launches} kernel launches and "
                                 f"{plain} plain-version calls on the path")
    leaks = eng.pool.leak_report()
    if any(leaks.values()):
        raise AssertionError(f"KV pool leak: {leaks}")
    log(f"serving: requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s tok/s={stats.tokens_per_s:.2f} "
        f"ttft_p50={stats.ttft_p50_s * 1e3:.1f}ms ttft_p99={stats.ttft_p99_s * 1e3:.1f}ms "
        f"tpot={stats.mean_tpot_s * 1e3:.2f}ms occupancy={stats.slot_occupancy:.2f}")
    log(f"serving: prefill_tokens={stats.prefill_tokens_computed}/"
        f"{stats.prefill_tokens_total} prefix_shared_blocks={stats.prefix_shared_blocks} "
        f"decode_steps={stats.decode_steps} prefill_compiles={stats.prefill_compiles} "
        f"kv_blocks_peak={stats.kv_blocks_peak} preemptions={stats.preemptions} "
        f"leaks={leaks}")
    log(f"serving: attention launches by body {attn_bodies} (= {cfg.num_layers} x "
        f"{stats.decode_steps} decode steps, {cfg.num_layers} x {chunks[0]} prefill chunks)")
    log(f"serving: launches={ {n: c[0] for n, c in counts.items()} } matmul={k7[0]} "
        f"(= {cfg.num_layers * QWEN_PRODUCTS + 1} x {calls} model calls; by body "
        f"{k7_bodies}) "
        f"plain_calls={ {n: c[1] for n, c in counts.items()} } "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB "
        f"card={torch.cuda.get_device_name(0)}")
    profile_phase(torch, np, eng, Request, greedy)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {n: c[0] for n, c in counts.items()}


def device_rows(prof) -> list[tuple[float, int, str]]:
    """(device ms, calls, name) of each device kernel in a profile, the
    largest first (one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue        # host-side ops: their kernels are listed themselves
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        rows.append((dev / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


def profile_phase(torch, np, eng, Request, greedy):
    """Where the time goes: 4 requests of 512 prompt tokens, 16 new tokens
    each, under torch.profiler; device time by kernel name and the device's
    busy share of the wall time (one stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    reqs = [Request(200 + i, rng.integers(0, eng.cfg.vocab_size, size=512)
                    .astype(np.int32), max_new_tokens=16, sampler=greedy())
            for i in range(4)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    log(f"profile: wall={wall:.3f}s device_busy={busy:.3f}s "
        f"busy_share={busy / wall:.3f} idle_share={1 - busy / wall:.3f} "
        f"decode_steps={stats.decode_steps} "
        f"prefill_tokens={stats.prefill_tokens_computed} (profiled run)")
    mine = {n: sum(r[0] for r in rows if n in r[2]) for n in
            ("decode_split_kernel", "decode_merge_kernel", "paged_decode_kernel",
             "paged_prefill_mma_kernel", "paged_prefill_kernel", "matmul_wgmma_kernel",
             "matmul_kernel")}
    log("profile: device ms " + " ".join(f"{n}={v:.3f}" for n, v in mine.items()))
    for ms, count, name in rows[:12]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {name[:90]}")


def path_check(torch, np):
    """One 300-token request (a 256-row prefill chunk, then 44 rows seeded
    past it, then one decode step) served at full width in fp32 by a
    ``ServingEngine`` through the kernels and by one through the plain
    versions (``dispatch.plain_versions()``), at depths 1, 2, 4 and 36.
    The request's sampler records the prefill and the decode logits and
    answers a fixed token, so both engines decode the same token.

    Depths 1, 2 and 4 are gated (``TOL_PATH_REL``, ``TOL_PATH_EXACT_RATIO``).  The reference's
    random init takes fan-in from the head axis, so attention logits have a
    std of several hundred and the softmax is near one-hot: every layer
    multiplies a rounding difference by a large factor.  So each depth also
    prints a second plain run that differs from the first only in its
    summation order (the plain versions' KV tile, ``chunk`` 64 against
    512): how far two correct fp32 paths drift apart at that depth.  And
    each depth prints how far the kernels and the plain versions each sit
    from a third run, the plain attention with every weight product summed
    in fp64 and rounded once ("exact products", as ``train_path_check``
    makes it): the accuracy both are held to.  Depth 36 is printed, not
    gated."""
    from unittest import mock

    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.models.layers import linear
    from repro_torch.models.layers.module import tree_map
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import Sampler

    class Record(Sampler):
        def __init__(self):
            self.seen = []

        def sample(self, logits):
            self.seen.append(np.array(logits[0], copy=True))
            return np.full((len(logits),), 7)

    torch.backends.cuda.matmul.allow_tf32 = False
    full = arch_registry.config("qwen2.5-3b").replace(compute_dtype="float32")
    params = fns_for(full).init(full, torch.Generator("cuda").manual_seed(0))
    toks = np.random.default_rng(1).integers(0, full.vocab_size, size=300).astype(np.int32)

    def serve(cfg, p, chunk=512):
        """(prefill logits, decode logits) of the request, (2, V)."""
        eng = ServingEngine(cfg, p, max_len=320, batch_slots=1, chunk=chunk,
                            prefill_chunk=256, cache_dtype="float32", device="cuda")
        rec = Record()
        eng.serve([Request(0, toks, max_new_tokens=2, sampler=rec)])
        if any(eng.pool.leak_report().values()) or len(rec.seen) != 2:
            raise AssertionError("path check: the request did not run clean")
        return np.stack(rec.seen)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    for depth in (1, 2, 4, full.num_layers):
        cfg = full.replace(num_layers=depth)
        p = dict(params, blocks=tree_map(lambda t: t[:depth], params["blocks"]))
        dispatch.reset_counts()
        kern = serve(cfg, p)
        table = dispatch.kernel_table()
        launched = all(table[n].launches > 0 for n in LM_KERNELS + ("matmul",)) and \
            not any(k.plain_calls for k in table.values())
        exact_product = lambda x, y: (x.double() @ y.double()).to(x.dtype)   # noqa: E731
        with dispatch.plain_versions():
            plain = serve(cfg, p)
            plain64 = serve(cfg, p, chunk=64)
            with mock.patch.object(linear, "_k7", exact_product):
                exact = serve(cfg, p)
        tol = TOL_PATH_REL.get(depth)
        r_pre, r_dec = rel(kern[0], plain[0]), rel(kern[1], plain[1])
        to_exact = [(rel(kern[i], exact[i]), rel(plain[i], exact[i])) for i in (0, 1)]
        ratio = max(k / max(p, 1e-7) for k, p in to_exact)
        log(f"path check (fp32, full width, depth {depth}): kernels vs plain "
            f"rel prefill={r_pre:.3e} decode={r_dec:.3e} "
            f"top1_agree={bool((kern.argmax(-1) == plain.argmax(-1)).all())} "
            + (f"(tol {tol}); " if tol else "(not gated); ")
            + f"plain chunk 64 vs 512 rel prefill={rel(plain64[0], plain[0]):.3e} "
            f"decode={rel(plain64[1], plain[1]):.3e} "
            f"top1_agree={bool((plain64.argmax(-1) == plain.argmax(-1)).all())}; "
            f"vs exact products: kernels rel prefill={to_exact[0][0]:.3e} "
            f"decode={to_exact[1][0]:.3e}, plain rel prefill={to_exact[0][1]:.3e} "
            f"decode={to_exact[1][1]:.3e}, worst ratio {ratio:.3f}"
            + (f" (tol {TOL_PATH_EXACT_RATIO})" if tol else ""))
        if not launched:
            raise AssertionError("path check: the kernel engine did not run "
                                 "through the attention kernels and K7 alone")
        if tol and not (np.isfinite(kern).all() and max(r_pre, r_dec) <= tol
                        and ratio <= TOL_PATH_EXACT_RATIO):
            raise AssertionError(f"path check, depth {depth}: kernels and plain "
                                 f"versions disagree ({r_pre}, {r_dec}; ratio to the exact "
                                 f"products' distance {ratio})")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def ssm_case(torch, S, dtype, *, B=1, H=64, N=64, P=64, shared=True,
             with_state=False, seed=0):
    """Mamba-2-like scan operands: q, k (B, S, H, N) -- one group shared by
    every head as a stride-0 view, or per head -- v (B, S, H, P), decay
    -dt*A with dt log-uniform in [1e-3, 1e-1] and A in [1, 16], gate
    log(dt); an fp32 initial state when asked."""
    g = torch.Generator("cuda").manual_seed(seed)
    hq = 1 if shared else H
    q, k = (torch.randn((B, S, hq, N), generator=g, device="cuda").to(dtype)
            .expand(B, S, H, N) for _ in range(2))
    v = torch.randn((B, S, H, P), generator=g, device="cuda").to(dtype)
    log_dt = torch.empty((B, S, H), device="cuda").uniform_(-6.9078, -2.3026, generator=g)
    a = 1.0 + 15.0 * (torch.arange(H, device="cuda") + 0.5) / H
    h0 = (torch.randn((B, H, N, P), generator=g, device="cuda") if with_state
          else None)
    return (q, k, v, -torch.exp(log_dt) * a, log_dt), h0


def ssm_work(S, *, B=1, H=64, N=64, P=64, chunk=128, in_bytes=2):
    """(bytes, flops) K5 must move and do: q and k's shared (B, S, N) base,
    v, decay and gate read once, y and the final state written once; per
    chunk of n live rows the causal QK^T and (QK^T.W)V, q.H_prev and the
    state update, two flops a multiply-add."""
    nbytes = in_bytes * (2 * B * S * N + B * S * H * P) + 4 * (2 * B * S * H
                                                              + B * S * H * P + B * H * N * P)
    flops = 0
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        flops += 2 * B * H * (n * (n + 1) // 2 * (N + P) + 2 * n * N * P)
    return nbytes, flops


def dense_case(torch, S, dtype, *, B=1, H=32, K=32, D=64, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((B, S, K, D), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def dense_decode_case(torch, lengths, dtype, *, S=ZAMBA_MAX_LEN, H=32, K=32, D=64,
                      seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    B = len(lengths)
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((B, S, K, D), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def poison_cache_rows(torch, q, k, v, lengths) -> None:
    """NaN into every cache row at or past its sequence's length: a kernel
    that reads such a row, or lets a masked product touch it, returns
    NaN."""
    S = k.shape[1]
    for b, n in enumerate(lengths.tolist()):
        k[b, max(min(n, S), 0):] = float("nan")
        v[b, max(min(n, S), 0):] = float("nan")


def hybrid_kernel_phase(torch, table) -> dict:
    """Phase 9: K5, K4 and K3 against their plain versions at zamba2-1.2b
    widths (fp32 and bf16), then each timed in bf16: kernel, plain version,
    library call and bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import dense_body_for
    from repro_torch.kernels.dispatch import SSM_RTOL
    from repro_torch.kernels.flash_attention.ops import body_for as flash_body_for
    ssm, fla, dec = (table[n] for n in HYBRID_KERNELS)
    timer = Timer(torch)

    def poison_cache(args):
        poison_cache_rows(torch, *args)

    errs = {n: {} for n in HYBRID_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        e = []
        for S, with_state in ((1000, True), (1024, False)):
            args, h0 = ssm_case(torch, S, dtype, with_state=with_state)
            e.append(hold(torch, ssm, args, f"B=1 S={S} H=64 N=P=64 shared B/C "
                          f"h0={with_state} (limit {SSM_RTOL} of max|ref|)",
                          chunk=128, initial_state=h0))
        args, h0 = ssm_case(torch, 1000, dtype, H=4, N=128, P=128, shared=False,
                            with_state=True)
        e.append(hold(torch, ssm, args, "B=1 S=1000 H=4 N=P=128 per-head q/k",
                      chunk=128, initial_state=h0))
        errs["ssm_scan"][dtype] = max(e)
        e = []
        for B, H, K, D in K4_SHAPES:
            for S in K4_S:
                args = dense_case(torch, S, dtype, B=B, H=H, K=K, D=D)
                e.append(hold(torch, fla, args, f"B={B} S={S} H={H} K={K} D={D} causal "
                              f"body={flash_body_for(args[0])}", causal=True))
        errs["flash_attention"][dtype] = max(e)
        e = []
        for lengths, S, H, K, D in DENSE_DECODE_CASES:
            for poison in (None, poison_cache):
                args = dense_decode_case(torch, lengths, dtype, S=S, H=H, K=K, D=D)
                e.append(hold(torch, dec, args, f"B={len(lengths)} S={S} H={H} K={K} D={D} "
                              f"lengths={lengths} body={dense_body_for(args[0], args[1])}"
                              f"{' NaN past the lengths' if poison else ''}", poison=poison))
        errs["decode_attention"][dtype] = max(e)
    out = {}
    # K5, bf16 operands as zamba2's prefill gives them: S = 1000, no state in
    args, _ = ssm_case(torch, 1000, torch.bfloat16)
    nbytes, flops = ssm_work(1000)
    out["ssm_scan"] = dict(
        ms=timer(lambda: ssm.launch(*args, chunk=128)),
        plain_ms=timer(lambda: ssm.plain(*args, chunk=128)), library_ms=None,
        bytes=nbytes, flops=flops, peak=FP32_FLOPS,
        shape="B=1 S=1000 H=64 N=P=64 chunk 128, bf16 in, fp32 out (one Mamba layer)")
    # K4, the shared block's prefill at S = 1000
    q, k, v = dense_case(torch, 1000, torch.bfloat16)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    B, S, H, D = q.shape
    out["flash_attention"] = dict(
        ms=timer(lambda: fla.launch(q, k, v, causal=True)),
        plain_ms=timer(lambda: fla.plain(q, k, v, causal=True)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)),
        bytes=2 * 4 * B * S * H * D, flops=4 * H * D * B * S * (S + 1) // 2,
        peak=BF16_FLOPS, shape=f"B=1 S=1000 H=K=32 D=64 causal bf16 body={flash_body_for(q)}")
    # K4 at qwen2.5-3b's heads (G = 8, D = 128), S = 1024: printed beside
    # SDPA with its own GQA (kv heads not repeated) and the bound
    q, k, v = dense_case(torch, 1024, torch.bfloat16, H=16, K=2, D=128)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    B, S, H, D = q.shape
    K = k.shape[2]
    ms = timer(lambda: fla.launch(q, k, v, causal=True))
    plain_ms = timer(lambda: fla.plain(q, k, v, causal=True))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                          enable_gqa=True))
    nbytes, flops = 2 * 2 * B * S * (H + K) * D, 4 * H * D * B * S * (S + 1) // 2
    bms, by = bound(nbytes, flops, BF16_FLOPS)
    log(f"flash_attention timed B=1 S=1024 H=16 K=2 D=128 causal bf16 "
        f"body={flash_body_for(q)}: kernel {ms:.4f}ms plain {plain_ms:.4f}ms "
        f"library {lib_ms:.4f}ms bound {bms:.5f}ms ({by}; {nbytes} B, {flops} flop)")
    # K3, one decode step's attention over the 4 slots, both bodies
    lengths = DENSE_DECODE_CASES[0][0]
    q, k, v, lens = dense_decode_case(torch, lengths, torch.bfloat16)
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    rows = sum(min(n, S) for n in lengths)
    shape = f"B=4 S={ZAMBA_MAX_LEN} H=K=32 D=64 lengths={lengths} bf16"
    out["decode_attention"] = dict(
        ms=timer(lambda: dec.launch(q, k, v, lens, body="mma")),
        fma_ms=timer(lambda: dec.launch(q, k, v, lens, body="fma")),
        plain_ms=timer(lambda: dec.plain(q, k, v, lens)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kh, vh, attn_mask=mask)),
        bytes=2 * (2 * B * H * D + 2 * rows * K * D) + 4 * B,
        flops=4 * H * D * rows, peak=BF16_FLOPS,
        shape=f"{shape} body={dense_body_for(q, k)} ({-(-S // 64)} splits)")
    host_cost(torch, dec, (q, k, v, lens), "decode_attention", shape,
              lambda: dense_body_for(q, k))
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"], r.pop("peak"))
        r["max_abs_err"] = errs[name][torch.bfloat16]
        r["max_abs_err_fp32"] = errs[name][torch.float32]
    return out


def zamba_requests(cfg, np, Request, greedy, lens=ZAMBA_PROMPTS, new=32, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=new, sampler=greedy()) for i, n in enumerate(lens)]


def hybrid_serving_phase(torch, np, table) -> dict:
    """Phase 10: zamba2-1.2b at full width through the contiguous engine."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    name, watts = card_name_and_power_limit()
    cfg = arch_registry.config("zamba2-1.2b")
    t0 = time.monotonic()
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=ZAMBA_MAX_LEN, batch_slots=4, device="cuda")
    del params                      # the engine keeps its own cast copy
    gc.collect()
    torch.cuda.synchronize()
    s = cfg.ssm
    log(f"zamba2 serving: L={cfg.num_layers} (every {cfg.shared_attn_every}th followed by "
        f"the shared block) d_model={cfg.d_model} H={cfg.num_heads} D={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} d_inner={s.d_inner(cfg.d_model)} ssm_heads={s.num_heads(cfg.d_model)} "
        f"d_state={s.d_state} chunk={s.chunk_size} vocab={cfg.vocab_size}; paged={eng.paged}; "
        f"init {time.monotonic() - t0:.1f}s")
    eng.serve(zamba_requests(cfg, np, Request, greedy, lens=(40,), new=4, seed=9))  # warm-up
    reqs = zamba_requests(cfg, np, Request, greedy)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    counts = {n: (k.launches, k.plain_calls) for n, k in table.items()}
    for r in reqs:
        if r.state.value != "done" or len(r.output) != 32:
            raise AssertionError(f"zamba2 request {r.rid}: state {r.state}, "
                                 f"{len(r.output)} tokens")
    n_seg = cfg.num_layers // cfg.shared_attn_every
    # each model call: in_proj and out_proj of every Mamba-2 layer; the
    # shared block's input projection, q k v, o and its MLP's three at each
    # application; the LM head
    per_call = 2 * cfg.num_layers + (1 + 4 + 3) * n_seg + 1
    want = {"ssm_scan": cfg.num_layers * stats.prefills,
            "flash_attention": n_seg * stats.prefills,
            "decode_attention": n_seg * stats.decode_steps,
            "matmul": per_call * (stats.prefills + stats.decode_steps)}
    got = {n: counts[n][0] for n in want}
    plain = {n: c[1] for n, c in counts.items() if c[1]}
    if got != want or plain or stats.prefills != len(reqs):
        raise AssertionError(f"zamba2 launches {got}, expected {want}; plain calls "
                             f"{plain}; prefills {stats.prefills}")
    # bf16 products on the tensor cores, the fp32 LM head on FMA; every K4
    # launch (D = 64, bf16) on the tensor-core body, every K3 launch (D = 64,
    # G = 1, bf16) on the split body
    calls = stats.prefills + stats.decode_steps
    bodies = {n: dict(table[n].body_launches)
              for n in ("matmul", "flash_attention", "decode_attention")}
    want_bodies = {"matmul": {"wgmma": (per_call - 1) * calls, "fma": calls},
                   "flash_attention": {"mma": want["flash_attention"]},
                   "decode_attention": {"mma": want["decode_attention"]}}
    if bodies != want_bodies:
        raise AssertionError(f"zamba2 launches by body {bodies}, expected {want_bodies}")
    log(f"zamba2 serving: requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s tok/s={stats.tokens_per_s:.2f} "
        f"ttft_p50={stats.ttft_p50_s * 1e3:.1f}ms ttft_p99={stats.ttft_p99_s * 1e3:.1f}ms "
        f"tpot={stats.mean_tpot_s * 1e3:.2f}ms occupancy={stats.slot_occupancy:.2f} "
        f"tok/s/W={stats.tokens_per_s / watts:.4f} at power.limit {watts:.0f} W ({name})")
    log(f"zamba2 serving: prefills={stats.prefills} prefill_tokens={stats.prefill_tokens_computed} "
        f"decode_steps={stats.decode_steps} launches={got} (= 38 x prefills, 6 x prefills, "
        f"6 x decode steps, {per_call} x model calls) by body {bodies} plain_calls=0 "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    hybrid_profile(torch, np, eng, Request, greedy)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return got


def hybrid_profile(torch, np, eng, Request, greedy):
    """One profiled window of prefills and decode steps: 6 requests of
    300-600 prompt tokens, 16 new tokens each, on the 4 slots (the last two
    prefill between decode steps)."""
    from torch.profiler import ProfilerActivity, profile
    reqs = zamba_requests(eng.cfg, np, Request, greedy, lens=(333, 401, 512, 600, 450, 300),
                          new=16, seed=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    if not busy:
        raise AssertionError("zamba2 profile: the profiler saw no device time")
    mine = {n: sum(r[0] for r in rows if n in r[2]) for n in
            ("ssm_scan_kernel", "flash_mma_kernel", "flash_kernel", "decode_split_kernel",
             "decode_merge_kernel", "dense_decode_kernel", "matmul_wgmma_kernel",
             "matmul_kernel")}
    log(f"zamba2 profile: wall={wall:.3f}s device_busy={busy:.3f}s "
        f"busy_share={busy / wall:.3f} idle_share={1 - busy / wall:.3f} "
        f"prefills={stats.prefills} decode_steps={stats.decode_steps}; device ms "
        + " ".join(f"{n}={v:.3f}" for n, v in mine.items()))
    for ms, count, key in rows[:14]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {key[:90]}")


def hybrid_path_check(torch, np):
    """Phase 11: a 333-token request served at full width in fp32 by a
    contiguous engine through the kernels and by one through the plain
    versions, at depths 6, 13 and 38 (gated at 6 and 13)."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.models.hybrid import _segments
    from repro_torch.models.layers.module import tree_map
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import Sampler

    class Record(Sampler):
        def __init__(self):
            self.seen = []

        def sample(self, logits):
            self.seen.append(np.array(logits[0], copy=True))
            return np.full((len(logits),), 7)

    torch.backends.cuda.matmul.allow_tf32 = False
    full = arch_registry.config("zamba2-1.2b").replace(compute_dtype="float32")
    params = fns_for(full).init(full, torch.Generator("cuda").manual_seed(0))
    toks = np.random.default_rng(3).integers(0, full.vocab_size, size=333).astype(np.int32)

    def serve(cfg, p, chunk=512):
        eng = ServingEngine(cfg, p, max_len=352, batch_slots=1, chunk=chunk,
                            cache_dtype="float32", device="cuda")
        rec = Record()
        eng.serve([Request(0, toks, max_new_tokens=2, sampler=rec)])
        if len(rec.seen) != 2:
            raise AssertionError("zamba2 path check: the request did not run clean")
        return np.stack(rec.seen)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    for depth in (6, 13, full.num_layers):
        cfg = full.replace(num_layers=depth)
        n_seg, _, tail = _segments(cfg)
        p = dict(params, seg_blocks=tree_map(lambda t: t[:n_seg], params["seg_blocks"]))
        p.pop("tail_blocks")
        if tail:
            p["tail_blocks"] = tree_map(lambda t: t[:tail], params["tail_blocks"])
        dispatch.reset_counts()
        kern = serve(cfg, p)
        table = dispatch.kernel_table()
        launched = all(table[n].launches > 0 for n in HYBRID_KERNELS + ("matmul",)) and \
            not any(k.plain_calls for k in table.values())
        with dispatch.plain_versions():
            plain = serve(cfg, p)
            plain64 = serve(cfg, p, chunk=64)
        tol = TOL_HYBRID_PATH_REL.get(depth)
        r_pre, r_dec = rel(kern[0], plain[0]), rel(kern[1], plain[1])
        log(f"zamba2 path check (fp32, full width, depth {depth}: {n_seg} segments, tail "
            f"{tail}): kernels vs plain rel prefill={r_pre:.3e} decode={r_dec:.3e} "
            f"top1_agree={bool((kern.argmax(-1) == plain.argmax(-1)).all())} "
            + (f"(tol {tol}); " if tol else "(not gated); ")
            + f"plain chunk 64 vs 512 rel prefill={rel(plain64[0], plain[0]):.3e} "
            f"decode={rel(plain64[1], plain[1]):.3e}")
        if not launched:
            raise AssertionError("zamba2 path check: the kernel engine did not run "
                                 "through the three kernels alone")
        if tol and not (np.isfinite(kern).all() and max(r_pre, r_dec) <= tol):
            raise AssertionError(f"zamba2 path check, depth {depth}: kernels and plain "
                                 f"versions disagree ({r_pre}, {r_dec})")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def conv_case(torch, x_shape, w_shape, dtype, seed=0):
    """Random x (B, H, W, Cin), w (KH, KW, Cin, Cout) scaled by
    1/sqrt(fan-in), both of ``dtype``, and an fp32 bias."""
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(x_shape, generator=g, device="cuda").to(dtype)
    fan_in = w_shape[0] * w_shape[1] * w_shape[2]
    w = (torch.randn(w_shape, generator=g, device="cuda") / fan_in ** 0.5).to(dtype)
    b = 0.1 * torch.randn((w_shape[3],), generator=g, device="cuda")
    return x, w, b


def conv_groups() -> dict:
    """GoogLeNet's 57 convolutions at batch 8 and 224, grouped by shape:
    (x shape, w shape, stride) -> names, in forward order."""
    from repro_torch.models.googlenet import conv_shapes
    groups: dict = {}
    for name, xs, ws, stride in conv_shapes(CONV_BATCH, CONV_SIZE):
        groups.setdefault((xs, ws, stride), []).append(name)
    return groups


def library_conv(torch, F, x, w, b, stride):
    """One ``F.conv2d`` call (cuDNN) computing the same SAME convolution on
    the same values, NHWC viewed as channels_last NCHW.  Where SAME pads
    asymmetrically (stem1: 2 before, 3 after) the map is padded before the
    timed call and the call pads nothing."""
    from repro_torch.kernels.conv2d.ref import same_padding
    (pt, pb), (pl, pr) = (same_padding(x.shape[1], w.shape[0], stride),
                          same_padding(x.shape[2], w.shape[1], stride))
    xc = x.permute(0, 3, 1, 2)
    if (pt, pl) != (pb, pr):
        xc = F.pad(xc, (pl, pr, pt, pb)).contiguous(memory_format=torch.channels_last)
        pt = pl = 0
    wc = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)   # OIHW, channels_last
    bc = b.to(x.dtype)
    return lambda: F.conv2d(xc, wc, bc, stride=stride, padding=(pt, pl))


def conv_slices(x, w, stride, body) -> int:
    """K slices a K6 call on ``body`` runs (1: unsplit), by the wrapper's
    rule."""
    from repro_torch.kernels.conv2d.ops import FMA_BK, MMA_BK, conv_splits, conv_tile
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    M = B * -(-H // stride) * -(-W // stride)
    bm, bn = conv_tile(body, M, Cout)
    return conv_splits(M, Cout, KH * KW * Cin, bm, bn, MMA_BK if body == "mma" else FMA_BK)


def conv_phase(torch, table) -> dict:
    """K6 against its plain version on every distinct conv shape of the
    batch-8 forward at 224: fp32 on the FMA body, fp16 and bf16 on both
    bodies (the route takes the tensor cores); a split
    case launched twice must give the same bits.  Then the 57 convolutions
    timed at fp32 and fp16: the route's body, the FMA body, the plain
    version, one F.conv2d call, the bound; sums are over the 57 launches of
    one forward.  Then the host's time per call."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d.ops import body_for
    conv = table["conv2d"]
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: full fp32 products
    torch.backends.cudnn.allow_tf32 = False         # library call at fp32: no TF32
    groups = conv_groups()
    errs, cases = {}, {}
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        errs[dtype] = 0.0
        for (xs, ws, stride), names in groups.items():
            args = conv_case(torch, xs, ws, dtype)
            route = body_for(*args[:2])
            for body in (("mma", "fma") if route == "mma" else ("fma",)):
                sp = conv_slices(*args[:2], stride, body)
                errs[dtype] = max(errs[dtype], hold(
                    torch, conv, args, f"{names[0]} x{xs} w{ws} /{stride} body={body} "
                    f"splits={sp}", body=body, stride=stride))
                if sp > 1:      # deterministic: the partials summed in slice order
                    first = conv.launch(*args, stride=stride, body=body)
                    again = conv.launch(*args, stride=stride, body=body)
                    torch.cuda.synchronize()
                    if not torch.equal(first, again):
                        raise AssertionError(f"conv2d {names[0]} {dtype} body={body}: two "
                                             f"launches of {sp} K slices differ")
                key = (str(dtype)[6:], body, "split" if sp > 1 else "unsplit")
                cases[key] = cases.get(key, 0) + 1
    log("conv2d cases held, by (type, body, K split): "
        + ", ".join(f"{'/'.join(k)} {n}" for k, n in sorted(cases.items())))
    for dtype in ("float16", "bfloat16"):
        for body in ("mma", "fma"):
            if not all(cases.get((dtype, body, sp)) for sp in ("split", "unsplit")):
                raise AssertionError(f"conv2d {dtype} {body}: split and unsplit cases not "
                                     f"both held")
    timer = Timer(torch, reps=10)
    out = {}
    for dtype in (torch.float32, torch.float16):
        dname = str(dtype)[6:]
        tot = dict(ms=0.0, fma_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0, flops=0.0, bytes=0.0)
        for (xs, ws, stride), names in groups.items():
            x, w, b = conv_case(torch, xs, ws, dtype)
            n = len(names)
            route = body_for(x, w)
            ms = timer(lambda: conv.launch(x, w, b, stride=stride))
            fma_ms = ms if route == "fma" else timer(
                lambda: conv.launch(x, w, b, stride=stride, body="fma"))
            plain_ms = timer(lambda: conv.plain(x, w, b, stride=stride))
            lib_ms = timer(library_conv(torch, F, x, w, b, stride))
            B, H, W, Cin = xs
            KH, KW, _, Cout = ws
            M = B * -(-H // stride) * -(-W // stride)
            flops = 2.0 * M * Cout * KH * KW * Cin
            nbytes = x.element_size() * (x.numel() + w.numel() + M * Cout) + 4 * Cout
            bms, by = bound(nbytes, flops, PEAK_FLOPS[dname])
            for key, v in (("ms", ms), ("fma_ms", fma_ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bound_ms", bms), ("flops", flops),
                           ("bytes", nbytes), ("bytes_ms", nbytes / HBM_BYTES_PER_S * 1e3),
                           ("ops_ms", flops / PEAK_FLOPS[dname] * 1e3)):
                tot[key] += n * v
            log(f"conv2d {dname} {','.join(names)}: x{xs} w{ws} /{stride} kernel "
                f"({route}, {conv_slices(x, w, stride, route)} K slices) {ms:.4f}ms fma "
                f"{fma_ms:.4f}ms plain {plain_ms:.4f}ms library {lib_ms:.4f}ms bound "
                f"{bms:.5f}ms ({by}) {flops / ms / 1e9:.1f} TFLOP/s")
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        log(f"conv2d {dname}, 57 launches of one batch-{CONV_BATCH} forward at "
            f"{CONV_SIZE}: kernel {tot['ms']:.4f}ms (route's bodies) fma body "
            f"{tot['fma_ms']:.4f}ms plain {tot['plain_ms']:.4f}ms "
            f"library {tot['library_ms']:.4f}ms bound {tot['bound_ms']:.4f}ms "
            f"({tot['bound_by']}, {tot['flops'] / 1e9:.2f} GFLOP, "
            f"{tot['bytes'] / 1e6:.1f} MB; peak {PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s)")
        out[dname] = tot
    for label in ("5a.b3r", "stem2"):      # split on the mma body, and not
        xs, ws, stride = next(k for k, names in groups.items() if names[0] == label)
        x, w, b = conv_case(torch, xs, ws, torch.float16)
        host_cost(torch, conv, (x, w, b), "conv2d", f"{label} fp16 (splits: mma "
                  f"{conv_slices(x, w, stride, 'mma')}, fma {conv_slices(x, w, stride, 'fma')})",
                  lambda: body_for(x, w))
    f32 = out["float32"]
    r = dict(out["float16"], max_abs_err=errs[torch.float16],
             max_abs_err_fp32=errs[torch.float32], max_abs_err_bf16=errs[torch.bfloat16],
             fp32_ms=f32["ms"], fp32_plain_ms=f32["plain_ms"],
             fp32_library_ms=f32["library_ms"], fp32_bound_ms=f32["bound_ms"],
             shape=f"57 convs of GoogLeNet, batch {CONV_BATCH} at {CONV_SIZE}, fp16, "
                   f"body=mma")
    return {"conv2d": r}


def googlenet_phase(torch, np, table) -> int:
    """GoogLeNet at full width on the card, fp32 and fp16 (phase 8 of the
    module docstring).  Returns the conv kernel's launches over the engine
    runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry as arch_registry
    from repro_torch.core.power import report
    from repro_torch.core.precision import POLICIES
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.kernels import dispatch
    from repro_torch.launch.offload_inference import precision_deltas, serve_batches
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models import googlenet

    name, watts = card_name_and_power_limit()
    dev = torch.device("cuda")
    conv = table["conv2d"]
    cfg32 = arch_registry.GOOGLENET
    params32 = googlenet.init(cfg32, torch.Generator(dev).manual_seed(0))
    src = SyntheticImages(num_classes=cfg32.vocab_size, size=CONV_SIZE, seed=0)
    x8 = torch.from_numpy(src.sample(CONV_BATCH)["images"]).to(dev)
    launches = 0
    for prec in ("fp32", "fp16"):
        policy = POLICIES[prec]
        cfg = policy.apply_to_config(cfg32)
        params = policy.cast_params(params32)
        # (a) path check: the same weights and images through both
        dispatch.reset_counts()
        kern = googlenet.forward(cfg, params, x8)
        torch.cuda.synchronize()
        n_kern = (conv.launches, conv.plain_calls, table["matmul"].launches,
                  table["matmul"].plain_calls)
        bodies = dict(conv.body_launches)
        with dispatch.plain_versions():
            plain = googlenet.forward(cfg, params, x8)
        rel = ((kern - plain).abs().max() / plain.abs().max()).item()
        top1 = bool((kern.argmax(-1) == plain.argmax(-1)).all())
        log(f"googlenet {prec} path check (batch {CONV_BATCH}, {CONV_SIZE}x{CONV_SIZE}): "
            f"kernels vs plain rel={rel:.3e} (tol {TOL_GOOGLENET[prec]}) top1_agree={top1} "
            f"max|logit|={plain.abs().max().item():.4f} conv launches/plain, matmul "
            f"launches/plain={n_kern}, conv launches by body {bodies}")
        if not (bool(torch.isfinite(kern).all()) and rel <= TOL_GOOGLENET[prec]
                and top1 and n_kern == (57, 0, 1, 0) and bodies == CONV_BODIES[prec]):
            raise AssertionError(f"googlenet {prec} path check failed: rel {rel}, "
                                 f"top1 {top1}, counts {n_kern}, by body {bodies}")
        # (a') the forward's host time: its launches enqueued, and forwards
        # back to back (paced by the host or the device, whichever is slower)
        enqueue = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            googlenet.forward(cfg, params, x8)
            enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            googlenet.forward(cfg, params, x8)
        torch.cuda.synchronize()
        b2b = (time.perf_counter() - t0) / 20
        log(f"googlenet {prec} batch-{CONV_BATCH} forward, host: enqueue median "
            f"{sorted(enqueue)[10] * 1e3:.3f} ms; 20 back to back {b2b * 1e3:.3f} ms a forward "
            f"({CONV_BATCH / b2b:.1f} img/s without the engine)")
        # (b) + (c): through the offload engine at batch 1 and 8
        for B, nb in ((1, 32), (CONV_BATCH, 16)):
            batches = [src.sample(B)["images"] for _ in range(nb)]
            r = serve_batches(cfg, params, batches, dev)
            rep = report(name, 1, r["img_s"], per_device_watts=watts)
            log(f"googlenet {prec} batch {B} through OffloadEngine([TorchTarget]): "
                f"{r['img_s']:.2f} img/s, {r['batch_ms']:.3f} ms per batch over "
                f"{r['batches']} batches, {rep.items_per_watt:.4f} img/W at "
                f"power.limit {watts:.0f} W; conv launches {r['launches']} by body "
                f"{r['body_launches']} plain calls {r['plain_calls']}")
            want = {body: n * nb for body, n in CONV_BODIES[prec].items()}
            if (r["launches"] != 57 * nb or r["body_launches"] != want
                    or r["plain_calls"] != 0):
                raise AssertionError(f"googlenet {prec} batch {B}: {r['launches']} conv "
                                     f"launches ({r['body_launches']} by body, expected "
                                     f"{want}) and {r['plain_calls']} plain calls for {nb} "
                                     f"forwards")
            launches += r["launches"]
        # (e) one batch-8 forward under the profiler
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            googlenet.forward(cfg, params, x8)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows) / 1e3
        k6 = sum(r[0] for r in rows if "conv2d_" in r[2]) / 1e3     # both bodies, the reduction
        if not busy:
            raise AssertionError("googlenet profile: the profiler saw no device time")
        log(f"googlenet {prec} profile (one batch-{CONV_BATCH} forward): wall "
            f"{wall * 1e3:.3f}ms device_busy {busy * 1e3:.3f}ms busy_share "
            f"{busy / wall:.3f} conv2d kernel {k6 * 1e3:.3f}ms = {k6 / busy:.3f} of "
            f"device time ("
            + ", ".join(f"{n} {sum(r[0] for r in rows if n in r[2]):.3f}ms" for n in
                        ("conv2d_mma_kernel", "conv2d_fma_kernel", "conv2d_reduce_kernel"))
            + ")")
        for ms, count, key in rows[:6]:
            log(f"profile: {ms:10.3f} ms  {count:6d} calls  {key[:90]}")
    # (d) fig 7's estimators on the card
    sample = SyntheticImages(num_classes=cfg32.vocab_size, size=CONV_SIZE,
                             seed=7).sample(48)
    deltas = precision_deltas(cfg32, params32, sample["images"], sample["labels"],
                              dev, batch=CONV_BATCH)
    for lp, m in deltas.items():
        log(f"googlenet fig7 {lp} vs fp32 over 48 images: top1 delta "
            f"{m['top1_delta']:.4f} confidence delta {m['confidence_delta']:.3e} "
            f"prediction agreement {m['prediction_agreement']:.4f}")
    del params32, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# K7 matmul and the training slice (phases 12-16)
# ---------------------------------------------------------------------------



def k7_operands(torch, M, K, N, layout, dtype, seed=0):
    """x (M, K), y (K, N) of ``dtype``, each row-major or, where ``layout``
    says, a transposed view of a row-major tensor (as ``tok.T`` and the
    backward's ``x.T`` / ``w.T`` reach the kernel).  y is scaled by
    1/sqrt(K), as weights are."""
    g = torch.Generator("cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    if layout in ("x.T", "both.T"):
        x = torch.randn((K, M), generator=g, device="cuda").to(dt).T
    else:
        x = torch.randn((M, K), generator=g, device="cuda").to(dt)
    if layout in ("y.T", "both.T"):
        y = (torch.randn((N, K), generator=g, device="cuda") / K ** 0.5).to(dt).T
    else:
        y = (torch.randn((K, N), generator=g, device="cuda") / K ** 0.5).to(dt)
    return x, y


def hold_matmul(torch, kern, x, y, label, **kw) -> float:
    """K7 on one case against its plain version evaluated in fp32 on the
    same values (``dispatch.matmul_tolerance_ratio``); raise past the limit.
    Returns the largest absolute error."""
    from repro_torch.kernels.matmul.ops import body_for
    out = kern.launch(x, y, **kw)
    ref = kern.plain(x.float(), y.float())
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    ratio = kern.tolerance(out, ref, x.shape[1])
    log(f"matmul {label} {str(x.dtype)[6:]} M={x.shape[0]} K={x.shape[1]} N={y.shape[1]} "
        f"x.stride={tuple(x.stride())} y.stride={tuple(y.stride())} body={body_for(x, y)}: "
        f"max_abs_err={err:.3e} err/limit={ratio:.3f}")
    if not ratio <= 1.0:
        raise AssertionError(f"matmul {label} disagrees with its plain version: "
                             f"err/limit {ratio}")
    return err


def k7_work(M, K, N, elem) -> tuple[float, float]:
    """(bytes, flops) of one product: x and y read once, out written once."""
    return elem * (M * K + K * N + M * N), 2.0 * M * K * N


def matmul_phase(torch, table) -> dict:
    """Phase 12: K7 against its plain version on every case of ``K7_CASES``,
    the two tile shapes bit for bit on ``K7_TILING`` (each bf16 case on the
    body it names), then the timed shapes: kernel, plain version, one
    ``torch.matmul`` (cuBLAS; TF32 off at fp32) and bound."""
    from repro_torch.kernels.matmul.ops import body_for
    kern = table["matmul"]
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for label, M, K, N, layout, dtypes in K7_CASES:
        for dtype in dtypes:
            x, y = k7_operands(torch, M, K, N, layout, dtype)
            errs[(label, dtype)] = hold_matmul(torch, kern, x, y, f"{label} ({layout})")
            del x, y
    # the order of the sum depends on k alone: both tile shapes agree bit for bit
    for M, K, N, bf16_body in K7_TILING:
        for dtype in ("float32", "bfloat16"):
            x, y = k7_operands(torch, M, K, N, "rows", dtype, seed=1)
            body = body_for(x, y)
            wide = kern.launch(x, y, tile="wide")
            narrow = kern.launch(x, y, tile="narrow")
            same = bool(torch.equal(wide, narrow))
            tiles = "128x128 and 64x64" if body == "wgmma" else "128x128 and 16x32"
            log(f"matmul tiling M={M} K={K} N={N} {dtype} body={body}: {tiles} tiles "
                f"bit-identical={same}")
            if body != ("fma" if dtype == "float32" else bf16_body):
                raise AssertionError(f"matmul tiling M={M} K={K} N={N} {dtype}: body {body}")
            if not same:
                raise AssertionError(f"matmul: the tile shapes disagree at M={M} K={K} "
                                     f"N={N} {dtype}")
    timer = Timer(torch)
    out = {}
    for label, M, K, N, layout, dtype in K7_TIMED:
        x, y = k7_operands(torch, M, K, N, layout, dtype)
        nbytes, flops = k7_work(M, K, N, x.element_size())
        peak = FP32_FLOPS if dtype == "float32" else BF16_FLOPS
        r = dict(ms=timer(lambda: kern.launch(x, y)),
                 plain_ms=timer(lambda: kern.plain(x, y)),
                 library_ms=timer(lambda: torch.matmul(x, y)),
                 bytes=nbytes, flops=flops, max_abs_err=errs[(label, dtype)],
                 max_abs_err_fp32=errs[(label, "float32")],
                 shape=f"{label}: M={M} K={K} N={N} {dtype} ({layout})")
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, peak)
        r["shape"] += f" body={body_for(x, y)}"
        log(f"matmul timed {r['shape']}: kernel {r['ms']:.4f}ms "
            f"({flops / r['ms'] / 1e9:.1f} TFLOP/s) plain {r['plain_ms']:.4f}ms "
            f"torch.matmul {r['library_ms']:.4f}ms bound {r['bound_ms']:.4f}ms "
            f"({r['bound_by']}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        out[label] = r
        del x, y
    matmul_host_cost(torch, kern)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def host_us(torch, fn, reps: int = HOST_REPS) -> tuple[float, float]:
    """(host, wall) microseconds per call of ``fn`` over ``reps`` calls back
    to back: the host's clock to the last enqueue, and to the device's
    end.  ``reps`` stays below the launch queue's depth, so the host is
    never held up by the device."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / reps * 1e6, (t2 - t0) / reps * 1e6


def matmul_host_cost(torch, kern) -> None:
    """K7's host time per launch at the decode shapes, where the host paces
    the step: through the dispatch wrapper as the models call it, bf16 on
    the wgmma body (its route, two tensor maps encoded) beside fp32 on the
    FMA body (neither), the route decision alone, and one ``torch.matmul``;
    printed."""
    from repro_torch.kernels.matmul.ops import route
    for label, M, K, N in K7_HOST:
        row = []
        for dtype in ("bfloat16", "float32"):
            x, y = k7_operands(torch, M, K, N, "rows", dtype)
            body = route(x, y)[0]
            host, wall = host_us(torch, lambda: kern(x, y))
            route_host, _ = host_us(torch, lambda: route(x, y))
            lib_host, _ = host_us(torch, lambda: torch.matmul(x, y))
            row.append(f"{dtype} body={body}: host {host:.2f} us wall {wall:.2f} us "
                       f"(route {route_host:.2f} us), torch.matmul host {lib_host:.2f} us")
            del x, y
        log(f"matmul host per launch, {label} M={M} K={K} N={N}, {HOST_REPS} back to back: "
            + "; ".join(row))


def matmul_backward_phase(torch, table) -> None:
    """Phase 13: ``linear.matmul`` of (512, 2048) x (2048, 11008) bf16 on the
    card: its forward and the two backward products (dX, dW, through
    strided views) against autograd through the plain version run in fp32
    on the same values; three launches."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.layers import linear
    kern = table["matmul"]
    x, w = k7_operands(torch, 512, 2048, 11008, "rows", "bfloat16", seed=2)
    g = torch.randn((512, 11008), generator=torch.Generator("cuda").manual_seed(3),
                    device="cuda").bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    dispatch.reset_counts()
    out = linear.matmul(x, w)
    out.backward(g)
    torch.cuda.synchronize()
    launches = (kern.launches, kern.plain_calls)
    bodies = dict(kern.body_launches)
    with dispatch.plain_versions():
        x32 = x.detach().float().requires_grad_(True)
        w32 = w.detach().float().requires_grad_(True)
        out32 = linear.matmul(x32, w32)
        out32.backward(g.float())
    for name, got, ref, k in (("out", out, out32, 2048), ("dX", x.grad, x32.grad, 11008),
                              ("dW", w.grad, w32.grad, 512)):
        ratio = kern.tolerance(got.detach(), ref.detach(), k)
        err = (got.detach().float() - ref.detach()).abs().max().item()
        log(f"matmul backward (512x2048 @ 2048x11008 bf16) {name} {tuple(got.shape)}: "
            f"max_abs_err={err:.3e} err/limit={ratio:.3f} (K={k})")
        if not ratio <= 1.0:
            raise AssertionError(f"matmul backward: {name} disagrees with autograd "
                                 f"through the plain version ({ratio})")
    log(f"matmul backward: kernel launches/plain calls {launches} (1 forward, dX, dW); "
        f"by body {bodies}")
    if launches != (3, 0) or bodies != {"wgmma": 3}:
        raise AssertionError(f"matmul backward: {launches} launches / plain calls, by body "
                             f"{bodies}")
    del x, w, g, out, out32, x32, w32
    gc.collect()
    torch.cuda.empty_cache()


def train_path_check(torch, np) -> None:
    """Phase 14: qwen2.5-3b at full width, 2 layers, fp32 compute: the loss
    and every gradient leaf of one 1 x 512 microbatch (``make_loss_fn``,
    remat "full") through the kernels, through the plain versions, and
    with every weight product summed in fp64 and rounded once (the
    accuracy both are held to); beside them two plain runs that differ
    only in the attention's KV tile."""
    from unittest import mock

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.models.layers import linear
    from repro_torch.models.registry import fns_for
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = arch_registry.config("qwen2.5-3b").replace(compute_dtype="float32", num_layers=2)
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in next(SyntheticTokens(cfg, 1, TRAIN_SEQ, seed=5)).items()}
    ps = leaves(params)

    def loss_and_grads(chunk=4096):
        for p in ps:
            p.grad = None
            p.requires_grad_(True)
        loss, _ = make_loss_fn(cfg, chunk=chunk)(params, batch)
        loss.backward()
        out = (loss.item(), [p.grad for p in ps])
        for p in ps:
            p.grad = None
            p.requires_grad_(False)
        return out

    dispatch.reset_counts()
    kern_loss, kern_g = loss_and_grads()
    k7 = dispatch.kernel_table()["matmul"]
    counts = (k7.launches, k7.plain_calls)
    want = cfg.num_layers * QWEN_PRODUCTS * 2 + 1 + 2 * (cfg.num_layers * QWEN_PRODUCTS + 1)
    with dispatch.plain_versions():
        plain_loss, plain_g = loss_and_grads()
        plain64_loss, plain64_g = loss_and_grads(chunk=64)
    exact = lambda x, y: (x.double() @ y.double()).to(x.dtype)   # noqa: E731
    with mock.patch.object(linear, "_k7", exact):
        exact_loss, exact_g = loss_and_grads()

    def rel(a, b):
        return [((x - y).abs().max() / y.abs().max().clamp(min=1e-30)).item()
                for x, y in zip(a, b)]
    r_loss = abs(kern_loss - plain_loss) / abs(plain_loss)
    r_grad = rel(kern_g, plain_g)
    k_exact, p_exact = rel(kern_g, exact_g), rel(plain_g, exact_g)
    ratio = max(k / max(p, 1e-7) for k, p in zip(k_exact, p_exact))
    log(f"training path check (fp32, full width, 2 layers, 1 x {TRAIN_SEQ} tokens): "
        f"loss kernels {kern_loss:.6f} plain {plain_loss:.6f} exact products "
        f"{exact_loss:.6f}, kernels vs plain rel={r_loss:.3e} (tol {TOL_TRAIN_LOSS_REL}); "
        f"worst gradient leaf of {len(ps)}: kernels vs plain rel={max(r_grad):.3e} (tol "
        f"{TOL_TRAIN_GRAD_REL}), vs exact products kernels {max(k_exact):.3e} plain "
        f"{max(p_exact):.3e}, worst ratio {ratio:.3f} (tol {TOL_TRAIN_EXACT_RATIO}); plain "
        f"KV tile 64 vs 4096: loss rel={abs(plain64_loss - plain_loss) / abs(plain_loss):.3e}"
        f" gradient rel={max(rel(plain64_g, plain_g)):.3e}; matmul launches/plain {counts}")
    if counts != (want, 0):
        raise AssertionError(f"training path check: matmul {counts}, expected ({want}, 0)")
    finite = all(bool(torch.isfinite(g).all()) for g in kern_g)
    if not (finite and r_loss <= TOL_TRAIN_LOSS_REL and max(r_grad) <= TOL_TRAIN_GRAD_REL
            and ratio <= TOL_TRAIN_EXACT_RATIO):
        raise AssertionError(f"training path check: kernels and plain versions disagree "
                             f"(loss {r_loss}, gradients {max(r_grad)}, ratio {ratio}, "
                             f"finite {finite})")
    del params, ps, kern_g, plain_g, plain64_g, exact_g, batch
    gc.collect()
    torch.cuda.empty_cache()


def training_phase(torch, np, table) -> int:
    """Phase 15: qwen2.5-3b at full width (36 layers) trained for
    ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens through
    ``python -m repro_torch.launch.train``'s entry point, in the config's 8
    microbatches (``--accum 8``: the launcher's default is 1, as the
    reference's).  Every loss finite; K7 launches exactly the count derived
    from the config, no plain call; then one more step under the profiler.
    Returns K7's launches."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.optim.optimizers import leaves

    name, watts = card_name_and_power_limit()
    cfg = arch_registry.config("qwen2.5-3b")
    L, accum = cfg.num_layers, cfg.accum_steps
    # per microbatch: each block's products in the forward and again in the
    # remat recompute, the LM head once, and two products in each backward
    per_micro = L * QWEN_PRODUCTS * 2 + 1 + 2 * (L * QWEN_PRODUCTS + 1)
    want = per_micro * accum * TRAIN_STEPS
    with tempfile.TemporaryDirectory() as d:
        args = train_launcher.parse(
            ["--arch", "qwen2.5-3b", "--steps", str(TRAIN_STEPS), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--accum", str(accum),
             "--ckpt-dir", d])
        dispatch.reset_counts()
        t0 = time.monotonic()
        out = train_launcher.run(args)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {n: (k.launches, k.plain_calls) for n, k in table.items()}
        k7_bodies = dict(table["matmul"].body_launches)
    s = out["summary"]
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    k7 = counts["matmul"]
    plain = {n: c[1] for n, c in counts.items() if c[1]}
    state_bytes = 4 * 4 * sum(p.numel() for p in leaves(out["trainer"].params))
    log(f"training: qwen2.5-3b L={L} d_model={cfg.d_model} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} params={state_bytes / 16 / 1e9:.3f}B fp32 master "
        f"weights, bf16 compute, remat={cfg.remat}, adamw; {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {accum} microbatches; wall {wall:.1f}s "
        f"(init included)")
    log(f"training: losses={[round(v, 4) for v in losses]} first_step={s['first_step_s']:.3f}s "
        f"step={s['step_s']:.3f}s tokens/s={s['tokens_per_s']:.1f} "
        f"tokens/s/W={s['tokens_per_s'] / watts:.4f} at power.limit {watts:.0f} W ({name}) "
        f"max_memory_allocated={s['peak_memory_bytes'] / 2**30:.2f}GiB "
        f"(params+grads+adamw state {state_bytes / 2**30:.2f}GiB)")
    # the fp32 LM head (forward, dX, dW) on FMA, every bf16 block product on wgmma
    want_bodies = {"wgmma": (per_micro - 3) * accum * TRAIN_STEPS,
                   "fma": 3 * accum * TRAIN_STEPS}
    log(f"training: matmul launches={k7[0]} (expected {want} = {per_micro} per microbatch "
        f"x {accum} x {TRAIN_STEPS} steps) by body {k7_bodies} (expected {want_bodies}) "
        f"plain_calls={plain or 0}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training: losses {losses}")
    if k7[0] != want or plain or k7_bodies != want_bodies:
        raise AssertionError(f"training: matmul launches {k7[0]}, expected {want}; by "
                             f"body {k7_bodies}, expected {want_bodies}; plain calls {plain}")
    # where the time goes: one more step (8 microbatches) under the profiler
    tr = out["trainer"]
    batch = next(SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=9))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        tr._step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    if not busy:
        raise AssertionError("training profile: the profiler saw no device time")
    wg_ms = sum(r[0] for r in rows if "matmul_wgmma_kernel" in r[2])
    fma_ms = sum(r[0] for r in rows if "matmul_kernel" in r[2])
    k7_ms = wg_ms + fma_ms
    log(f"training profile (one step, {accum} microbatches): wall={wall:.3f}s "
        f"device_busy={busy:.3f}s busy_share={busy / wall:.3f} "
        f"idle_share={1 - busy / wall:.3f}; matmul kernel {k7_ms / 1e3:.3f}s = "
        f"{k7_ms / 1e3 / busy:.3f} of device time (wgmma {wg_ms / 1e3:.3f}s, "
        f"fma {fma_ms / 1e3:.3f}s)")
    for ms, count, key in rows[:14]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {key[:90]}")
    del out, tr
    gc.collect()
    torch.cuda.empty_cache()
    return k7[0]


def checkpoint_phase(torch, np) -> None:
    """Phase 16: qwen2.5-3b at full width cut to 2 layers (bf16 compute)
    on the card: trainer A takes 2 steps and saves (async); trainer B
    restores that checkpoint into fresh state; both take step 3 on the same
    batch.  The restored state and the states after step 3 must be
    identical, bit for bit."""
    import tempfile

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.optimizers import adamw, leaves, warmup_cosine
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = arch_registry.config("qwen2.5-3b").replace(num_layers=2, accum_steps=2)

    def trainer(d, steps, skip=0, seed=0):
        data = SyntheticTokens(cfg, 2, 128, seed=4)
        for _ in range(skip):
            next(data)
        tc = TrainerConfig(num_steps=steps, ckpt_every=2, ckpt_dir=d, seed=seed,
                           async_save=True, device="cuda")
        return Trainer(cfg, data, tc, optimizer=adamw(warmup_cosine(3e-4, 1, 10)))

    def state(tr):
        return leaves(tr.params) + leaves(tr.opt_state)

    with tempfile.TemporaryDirectory() as d:
        a = trainer(d, 2)
        a.train()                               # saves at step 2
        saved = [t.clone() for t in state(a)]
        b = trainer(d, 3, skip=2, seed=1)       # another init, then the checkpoint
        resumed = b.try_resume()
        same_restore = resumed and b.step == 2 and all(
            torch.equal(x, y) for x, y in zip(saved, state(b)))
        restored_step = b.step
        a.tc.num_steps = 3                      # its data yields the third batch next
        a.train()
        b.train()
        diff = max((x.float() - y.float()).abs().max().item()
                   for x, y in zip(state(a), state(b)))
        losses = (a.history[-1]["loss"], b.history[-1]["loss"])
    log(f"checkpoint round trip (qwen2.5-3b full width, 2 layers, bf16): restored "
        f"step {restored_step} state identical={same_restore}; step 3 losses {losses}, "
        f"largest state difference after it {diff:.3e}")
    if not (same_restore and diff == 0.0 and losses[0] == losses[1]):
        raise AssertionError("checkpoint round trip: restored state or the next step "
                             "differs")
    del a, b, saved
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build, dispatch

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.monotonic()
    build.build()
    log(f"build: {len(build.sources())} kernels in {time.monotonic() - t0:.1f}s")
    for name, text in build.LOGS.items():
        how = "cached build, log of the run that built it" if name in build.CACHED else "built now"
        log(f"--- nvcc -Xptxas -v: {name} ({how}) ---\n{text.strip()}")

    table = dispatch.kernel_table()
    results = kernel_phase(torch, table)
    launches = serving_phase(torch, np, table)
    path_check(torch, np)
    results.update(hybrid_kernel_phase(torch, table))
    launches.update(hybrid_serving_phase(torch, np, table))
    hybrid_path_check(torch, np)
    results.update(conv_phase(torch, table))
    launches["conv2d"] = googlenet_phase(torch, np, table)
    k7 = matmul_phase(torch, table)
    results["matmul"] = k7[K7_TIMED[0][0]]
    matmul_backward_phase(torch, table)
    train_path_check(torch, np)
    launches["matmul"] = training_phase(torch, np, table)
    checkpoint_phase(torch, np)

    kernels = []
    for name in ("paged_decode_attention", "paged_prefill_attention", "decode_attention",
                 "flash_attention", "ssm_scan", "conv2d", "matmul"):
        k, r = table[name], results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
        if "fma_ms" in r:           # a redesigned kernel's first (FMA) body, same inputs
            kernels[-1]["fma_ms"] = r["fma_ms"]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}ms"
        fma = f" (fma body {r['fma_ms']:.4f}ms)" if "fma_ms" in r else ""
        log(f"{name} at {r['shape']}: kernel {r['ms']:.4f}ms{fma} plain {r['plain_ms']:.4f}ms "
            f"library {lib} bound {r['bound_ms']:.4f}ms "
            f"({r['bound_by']}; {r['bytes']:.0f} B, {r['flops']:.0f} flop) on {card}; "
            f"launches {launches[name]}; "
            + " ".join(f"{key}={v:.3e}" for key, v in r.items()
                       if key.startswith("max_abs_err")))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
