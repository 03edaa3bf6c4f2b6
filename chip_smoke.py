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
3b. int8 kernels: K1 and K2 on int8 pools (``quantize_kv`` of phase 3's
   cases: fp32 scales per (block, row, kv head)), with fp32 and bf16 q, on
   the body the route takes (bf16: ``mma_i8``, fp32: ``fma_i8``) and on
   ``fma_i8`` for bf16 q too, each held against the plain version
   evaluated in fp32 on the same dequantized values (phase 3's limits),
   as made and with NaN in the scales of every dead row; and each must
   give the bits of the bf16 / fp32 body on the dequantized pool.  Then
   both int8 bodies timed at phase 3's timed shapes beside the bf16 bodies
   on the dequantized pool, the plain version, SDPA on the dequantized
   bf16 tensors (not the same function: no library call dequantizes), the
   bound from the int8 bytes (rows and scales), and the host's time per
   call.
4. Serving: qwen2.5-3b at full width (random weights from seed 0) through
   ``repro_torch``'s paged ``ServingEngine``: 4 slots, 256-token prefill
   chunks, 8 greedy requests of 256-1024 prompt tokens (half share a
   256-token prefix), 32 new tokens each.  The kernels' launch counts are
   zeroed just before and read just after and held exactly, by body: K1
   36 a decode step and K2 36 a prefill chunk, all on ``mma``; K7 by body;
   no plain version.
4b. int8 serving: phase 4 again with ``cache_dtype="int8"``: K1 36 a
   decode step and K2 36 a prefill chunk, all on ``mma_i8``; K7 as in
   phase 4; tok/s, TTFT, TPOT, tok/s/W, peak memory, the KV pool's bytes
   beside phase 4's; greedy tokens against phase 4's printed, not gated.
5. Profile: a short serving run under ``torch.profiler``; device time by
   kernel and the device's busy share of the wall time (after phase 4,
   and after phase 4b on the int8 pool).
6. Path check: one request served at full width in fp32 by an engine
   through the kernels and by one through the plain versions; its prefill
   and decode logits are compared at depths 1, 2 and 4 (gated) and 36
   (printed beside two plain runs that differ only in summation order),
   and each side's distance from a run whose weight products are summed
   in fp64 and rounded once is printed.
6b. int8 path check: phase 6's request in fp32 on an int8 pool, kernels
   vs plain versions at depths 1, 2 and 4: after one layer the freely
   running sides' int8 pools equal or one step apart (``TOL_INT8_APART``)
   and their scales within ``TOL_INT8_SCALE_REL``; the kernels' logits
   within phase 6's limits of a plain run that stores the kernel run's
   quantized rows; printed: the free-running logits, the values one step
   apart and how far one step moves the logits (measured on the plain
   side).
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
   q/k at H=4, N=P=128; fp32 on the FMA body, bf16 on both (the route's
   tensor-core ``mma`` body, launched twice for the same bits, and FMA);
   K4 at S 1000 and 1024 on ``K4_SHAPES`` (zamba2's
   H=K=32, D=64 and qwen2.5-3b's H=16, K=2, D=128; bf16 on the
   tensor-core body, fp32 on the FMA body); K3 on ``DENSE_DECODE_CASES``
   (zamba2's B=4, S=1088, lengths 1033/700/257/1200, the last past S as
   an idle slot; a length-0 row; S not a multiple of 64; qwen2.5-3b's
   heads) -- bf16 on the split body, fp32 on the FMA body, each as made
   and with NaN in every cache row at or past the length -- at fp32 and
   bf16, then each timed in bf16 beside its bound, its plain version and
   (K3, K4) ``scaled_dot_product_attention`` on the same tensors (K3 and
   K5 on both bodies and their host time per call, K5's bound per body's
   rate); K4 also at qwen2.5-3b's heads, S=1024, printed.
10. zamba2 serving: zamba2-1.2b at full width (38 layers: 6 segments of 6
   Mamba-2 layers and the shared attention block, a 2-layer tail), bf16,
   random weights from seed 0, through the contiguous ``ServingEngine``:
   4 slots, ``max_len`` 1088, 8 greedy requests of 203-1000 prompt tokens
   (none a multiple of 128), 32 new tokens each.  Launch counts zeroed
   just before and read just after, held exactly: K5 38 per prefill and
   K4 6 per prefill (every one on the tensor-core body), K3 6 per decode step
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
   ``TOL_TRAIN_GRAD_REL``); K4 launched 4 times and its backward kernel
   twice, on FMA.
15. Training: qwen2.5-3b at full width (36 layers, fp32 master weights,
   bf16 compute, remat "full", AdamW) for 4 steps of 8 x 512 tokens in 8
   microbatches (``--accum 8``) through ``repro_torch.launch.train``: every
   loss finite, K7 launches exactly 1011 a microbatch (derived from the
   config): 1008 bf16 block products on wgmma and the fp32 LM head's 3 on
   FMA; the attention through K4, 72 a microbatch (36 and the remat
   recompute) on mma, and K4's backward kernel, 36 on FMA; no plain call;
   step time (beside the step measured when this attention was the
   plain version), tokens/s,
   tokens/s/W against the power limit, peak memory; one more step under
   ``torch.profiler``.
16. Checkpoint round trip on the card (full width, 2 layers): save after 2
   steps, restore into a fresh trainer, one more step in both; identical
   bit for bit.

17. Dense contiguous serving: qwen2.5-3b at full width, bf16, random
   weights from seed 0, through ``ServingEngine(paged=False)``: 4 slots of
   1056 rows, phase 4's 8 requests, 32 new tokens each.  Launch counts
   zeroed just before and read just after, held exactly by body: K4 36 a
   prefill and K3 36 a decode step (qwen's 8 query heads a kv head, D =
   128), all on the tensor-core bodies; K7 by body; K1, K2 and every plain
   version zero.  tok/s, TTFT p50/p99, TPOT, tok/s/W, peak memory and the
   caches' bytes beside phase 4's; greedy tokens beside phase 4's (not
   gated); a profiled window.  Then phase 6's fp32 path check through the
   contiguous engine at depths 1, 2 and 4 (phase 6's limits), and the int8
   branch as phase 6b holds the pool: a prompt prefilled through K4 into
   ``make_cache(..., "int8")``, 4 decode steps through the contiguous
   decode's int8 branch (K3 on the dequantized cache), kernels vs plain at
   depths 1, 2 and 4: layer 0's int8 rows equal or one step apart
   (``TOL_INT8_APART``), scales within ``TOL_INT8_SCALE_REL``, logits within
   phase 6's limits of a plain run that stores the kernel run's rows.
18. Speculative decoding: first K2 at the verify shape (``VERIFY_CASES``:
   4 sequences of C = 4 rows at mid-block q_starts and a padding sequence
   on an all-trash table), bf16 on ``mma`` and fp32 on FMA, as made and
   with NaN in every dead pool row, against the plain version (phase 3's
   limits), and timed.  Then qwen2.5-3b at full width, bf16,
   self-speculation (``spec_k`` 3, the drafter on the engine's own
   weights) on phase 4's paged engine and requests: launch counts held
   exactly from the engine's counters (K2 36 a verify pass, a drafter seed
   and a target prefill chunk; K1 36 a drafter step; all ``mma``; K7 by
   body), both pools leak-free, accept rate, verify steps, steps per token,
   TPOT and tok/s beside phase 4's; a profiled window.  Then the gate: at
   depth 2 in fp32 the speculative engine's greedy tokens equal the
   vanilla engine's for phase 4's requests, through the kernels, on an
   fp32 pool and on an int8 pool (on a mismatch the first differing step
   and its logit margins are printed).  Printed, not gated: bf16
   self-speculation's accept rate at depths ``SPEC_BF16_DEPTHS``.
19. The host KV tier, faults and service mode: qwen2.5-3b at full width,
   bf16, random weights from seed 0, phase 4's engine (4 slots, 256-token
   chunks, max_len 1056).  19a: a 264-block pool with a 256-block host
   tier on churn traffic (``tier_waves``: 3 prefixes of 512 tokens, each
   visited twice with a fresh 64-token tail and 16 new tokens, a wave of 4
   fillers of 1024 tokens and 32 new between), as three ``serve`` calls,
   then untiered, then tiered on an int8 pool.  Gated exactly from the
   shapes (``TIER_*``): 211 spills, 96 fetches and host prefix hits, the
   spill bytes (589,824 B a block in bf16, 304,128 int8), prompt tokens
   computed (6016 tiered, 7552 untiered); launches by body from the
   engine's calls (K2 36 a prefill chunk, K1 36 a decode step, all
   ``mma`` / ``mma_i8``; K7 by body); every restored block equal bit for
   bit to the rows cloned at its spill (k, v and the int8 scales); pools
   leak-free after ``drain_tier_io``.  Printed: the revisits' TTFT beside
   the untiered run's, the copy times of a block each way, the executor's
   host time per spill capture and per fetch commit, tokens tiered vs
   untiered.  19b, on 19a's tiered engine and traffic: ``FAULT_PLAN``
   fires every request-level and transfer site, every request ends DONE
   or FAILED, leak-free; two requests past ``deadline_s=0`` fail with
   ``DeadlineExceeded``; ``replica.executor:raise:4`` in blocking
   ``serve`` fails every request, surfaces and refuses later submits.
   19c: phase 4's requests in service mode (``start``, submits from the
   main thread, ``on_finish``, ``stop``): all DONE, launches exact by body
   with every model call on the executor thread, leak-free; a crash there
   surfaces through ``stop()`` once, a second ``stop()`` is silent and a
   later submit refused; TTFT, TPOT, tok/s and tokens beside phase 4's.
   The gate, at depth 2 in fp32 through the kernels: 19a tiered tokens
   equal untiered (and the exact counts), 19b's DONE requests equal the
   no-fault run's, 19c's tokens equal blocking ``serve``'s.
20. The replica router, disaggregated prefill/decode and wave mode, on
   19's weights: fleets of two phase-4 engines on the one card, each
   with its own executor thread, behind ``ReplicaRouter``, on phase 4's
   requests; every fleet run's launches held exactly by body from the
   engines' own calls (K2 36 a prefill chunk, K1 36 a decode step, K7 by
   body), no plain call inside it (the plain versions are switched
   process-wide, so a comparison never wraps a running fleet), every
   model call on an executor thread.  20a: affinity and stealing on;
   ``FLEET_AFFINITY`` exactly; tok/s, TTFT, TPOT, steals, a profiled
   window's busy share and peak memory beside phase 4's and beside one of
   the engines behind a one-replica router (one executor thread).  20b:
   ``prefill,decode`` on a bf16 and an int8 pool: 8 migrations of
   ``FLEET_MIGRATED_BLOCKS`` blocks and their bytes, no prompt token
   computed on the decode replica and no decode step on the prefill
   replica, every adopted block bit for bit its handoff clone (int8 with
   both scales), leak-free pools after ``drain_migrations``; the
   migration worker's copy time a block and the adopting executor's host
   time an adoption.  20c: the mixed fleet under ``FLEET_CRASH`` (one
   replica DEAD, no request failed, retries, all DONE, the survivor
   leak-free) and the disaggregated one under ``FLEET_DROP`` (one
   migration failure, that request retried once from its bare prompt --
   on the decode replica, as the reference's retry prefers a replica
   other than the one charged -- and DONE, 7 adoptions).  20d:
   ``serve_wave``, 8 prompts of 512 in 2 waves of 4: K4 72, K3 2232, all
   ``mma``, no K1 / K2; TTFT and TPOT beside phase 17's.
   The gate, at depth 2 in fp32: the fleets' tokens (fp32 and int8
   pools, both fault runs) equal a single engine's on the same pool;
   wave mode's equal the contiguous engine's on bf16 caches (the waves
   keep bf16 caches whatever ``cache_dtype`` says, as the reference's).

21. zamba2-1.2b training and the two backward kernels.  21a: K4 with its
   log-sum-exp (the output bit for bit the one without) and K4's backward
   kernel against their plain versions in fp32 on the same values
   (``dispatch.grad_tolerance_ratio``: each gradient within 2^-14 of its
   largest at fp32, 2^-8 at bf16) on ``K4_BWD_CASES``, then timed at
   qwen2.5-3b's training heads beside SDPA's backward (autograd of
   ``scaled_dot_product_attention``, measured, never used) and the bound,
   and at zamba2's shared block's, printed.  21b: K5's backward likewise
   on ``K5_BWD_CASES`` (zamba2's widths, B and C stride-0 head views, S
   512 and a ragged 1000, fp32 with an initial state and d_final), timed
   at S = 512.  21c: zamba2-1.2b at full width cut to 7 layers (one
   segment, a 1-layer tail), fp32, one 1 x 512 microbatch: loss and every
   gradient leaf through the kernels, the plain versions and fp64-summed
   products (phase 14's gate), launches exact by body, no plain call.
   21d: zamba2-1.2b at full width (38 layers, fp32 master weights, bf16
   compute, remat "full", AdamW), 3 steps of 8 x 512 in 8 microbatches
   through ``repro_torch.launch.train``: every loss finite; K5 74 a
   microbatch (38 and the 36 of the checkpointed segments' recompute) on
   mma, its backward 38 on FMA, K4 12 on mma, its backward 6 on FMA, K7
   495 (492 wgmma, the fp32 LM head's 3 on FMA); no plain call; step time,
   tokens/s, tokens/s/W, peak memory; one profiled step's device time by
   kernel and busy share.
22. GoogLeNet training and remat "dots".  22a: K6's backward kernel (dgrad
   where x needs its gradient, wgrad and db; split-K by the forward's rule,
   the partials summed in slice order) against its plain version evaluated
   in fp32 on the same values (``dispatch.grad_tolerance_ratio``: 2^-14 of
   each gradient's largest at fp32, 2^-10 at fp16) on every distinct conv
   shape of GoogLeNet's batch-8 forward at 224 (dx for every conv but
   stem1) and on ``CONV_BWD_EXTRA`` (stem1 with dx at stride 2, odd maps),
   at fp32 and fp16, split cases launched twice for the same bits; then
   one batch-8 backward of the 57 convs at fp32 timed beside its plain
   version, cuDNN's backward (autograd of ``F.conv2d`` in NCHW, TF32 off;
   measured, never used) and its bound (operations at 67 TFLOP/s fp32,
   bytes at 3.35 TB/s).  22b: GoogLeNet at full width, fp32, one batch-8
   microbatch: on one forward graph, every gradient leaf through the
   backward kernels within ``grad_tolerance_ratio`` of the same graph's
   backward through the plain versions; two whole runs, the loss within
   ``TOL_TRAIN_LOSS_REL`` and every leaf within ``TOL_TRAIN_GRAD_REL``,
   printed beside a run whose convs and products are summed in fp64;
   launches exact, no plain call.  22c: GoogLeNet trained by the port's
   ``Trainer`` from ``SyntheticImages`` (4 steps of 32 images in 4
   microbatches, AdamW with the launcher's recipe): losses finite, a
   microbatch's launches exact by body (K6 57 on FMA, its backward 56
   dgrad and 57 wgrad, K7 3), no plain call; step time, img/s, img/s/W,
   peak memory, one profiled step's busy share.  22d: qwen2.5-3b under
   remat "dots" (phase 15's batches, 2 steps): K7 759 a microbatch (the
   recompute reuses the kept products; 1011 under "full"), K4 72 and its
   backward 36, no plain call; step time and peak memory beside phase
   15's; then one zamba2-1.2b microbatch under "dots", whose counts equal
   phase 21d's (the hybrid runs "dots" as "full", as the reference).

K7 also carries every weight product of phases 4-11, 17 and 18 (the
serving paths and GoogLeNet's classifier): phases 4, 6, 8, 10, 11, 17 and
18 hold its launch counts too (exactly, where the engine's calls fix them;
phases 4, 10, 17 and 18 by body).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the kernel table (``{"kernels": [...]}``), with K1's
and K2's int8 bodies as entries of their own (``...:int8``: their
launches from phases 4b, 19a's and 20b's int8 runs, no library call).
Each entry's ``launches`` sums the served and trained paths that ran it:
K1 and K2 phases 4, 18, 19a (tiered and untiered), 19c, 20a, 20b and 20c,
K3 phases 10, 17 and 20d, K4 phases 10, 15, 17, 20d, 21d and 22d, K4's
backward 15, 21d and 22d, K5 10, 21d and 22d, K5's backward 21d and 22d,
K6 phases 8 and 22c, K6's backward 22c, K7 phases 4, 4b, 10, 15, 17, 18,
19a, 19c, 20a-d, 21d, 22c and 22d.  The three backward kernels replace no
Pallas kernel (the reference differentiates its plain functions and
``lax.conv_general_dilated``): their entries name the forward's Pallas
kernel under ``replaces`` and say so under ``note``.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import threading
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
# Phase 18: the drafter's proposals per round, and K2 at the verify shape
# (q_start of each live sequence; C = SPEC_K + 1 rows; one more sequence
# pads the batch on an all-trash table): mid-block starts, a block's last
# row, and the table's last rows (1052 + 4 = 1056 = max_len).
SPEC_K = 3
SPEC_BF16_DEPTHS = (1, 3, 9)
# Phase 19's churn traffic (19a) on phase 4's engine with a 264-block pool
# and a 256-block host tier: 3 prefixes of 512 tokens, each visited twice
# with a fresh 64-token tail and 16 new tokens (37 blocks reserved a
# visit), a wave of 4 fillers of 1024 tokens and 32 new (66 blocks each,
# the whole pool) between the visits.  From the shapes: the first visits
# publish 3 x 36 blocks, which the fillers demote (108 spills); the
# revisits' 111 blocks demote 103 of the fillers' 256 held ones; each
# revisit restores its 32 prefix blocks (96 fetches) and computes its tail.
TIER_POOL_BLOCKS, TIER_HOST_BLOCKS = 264, 256
TIER_PREFIX, TIER_TAIL, TIER_NEW = 512, 64, 16
TIER_FILLER, TIER_FILLER_NEW = 1024, 32
TIER_SPILLS, TIER_FETCHES = 108 + 103, 3 * TIER_PREFIX // 16
TIER_COMPUTED = {True: 3 * 576 + 4 * 1024 + 3 * TIER_TAIL,     # tiered
                 False: 2 * 3 * 576 + 4 * 1024}                # recompute
# a spilled block: 36 layers x 16 rows x 2 kv heads x 128 of K and of V
# (bf16: 2 B; int8: 1 B and an fp32 scale a row and head)
TIER_BLOCK_BYTES = {"bfloat16": 589_824, "int8": 304_128}
# Phase 20 on phase 4's engine (4 slots, 256-token chunks, max_len 1056)
# and requests.  Affinity: requests 2, 4 and 6 follow request 0's 16
# shared 256-token blocks (3 hits, 48 blocks).  Migration: every prompt's
# blocks, ceil(P / 16) summed over the 8 prompts, each TIER_BLOCK_BYTES.
FLEET_AFFINITY = {"affinity_hits": 3, "affinity_blocks": 48}
FLEET_MIGRATED_BLOCKS = sum(-(-n // 16) for n in (1024, 300, 768, 512, 640, 256, 900, 400))
FLEET_CRASH = "replica.executor:raise:4"      # 20c: one replica of the fleet dies
FLEET_DROP = "kv.migrate:drop:1"              # 20c: the second migration is lost
# 20d: serve_wave, 8 prompts of one length in 2 waves of 4; a wave decodes
# its 32 tokens in 31 steps (the first comes from the prefill)
WAVE_REQUESTS, WAVE_PROMPT, WAVE_NEW = 8, 512, 32
# 19b: a plan that fires every request-level and transfer site
FAULT_PLAN = ("kv.spill:drop:1:2,kv.fetch:drop:1:2,engine.decode:raise:40:1,"
              "engine.prefill:raise:3:1")
FAULT_SITES = {"engine.prefill", "engine.decode", "kv.spill", "kv.fetch"}
VERIFY_CASES = ((9, 27, 300, 1040), (0, 15, 16, 1052))
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
# The int8 path check (int8_path_check): after one layer the two sides'
# int8 pools may differ only by one step, in at most this share of their
# values (a value moves a step when one ulp of K / V crosses a rounding
# edge: about 127 x 2^-24 = 7.6e-6 of the values at fp32), and their
# scales (absmax / 127 of rows equal to an ulp or two) by this much.
TOL_INT8_APART = 1e-4
TOL_INT8_SCALE_REL = 1e-5
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
FP32_FLOPS = 67e12             # H100 SXM fp32 on the CUDA cores (K5's FMA body)
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
# phase 15's step when its attention was the plain version (two runs of
# this script on an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), printed
# beside this run's step through K4
PLAIN_ATTENTION_STEP_S = "4.618 / 5.405 s"

# Phase 21, zamba2-1.2b training.  21a: K4's backward on (B, S, H, K, D,
# dtype) -- qwen2.5-3b's training heads (G = 8, D = 128), zamba2's shared
# block (G = 1, D = 64), a ragged S, fp32 -- the first timed beside SDPA's
# backward.  21b: K5's backward on (S, dtype, initial state and d_final)
# at zamba2's widths (H=64, N=P=64, chunk 128, B and C as stride-0 head
# views), the first timed.  21c: the fp32 path check at 7 layers (one
# segment, a 1-layer tail), phase 14's three-way gate.  21d: 3 steps of
# 8 x 512 in 8 microbatches at full width.
K4_BWD_CASES = ((1, 512, 16, 2, 128, "bfloat16"), (1, 512, 32, 32, 64, "bfloat16"),
                (1, 333, 32, 32, 64, "bfloat16"), (1, 333, 32, 32, 64, "float32"),
                (1, 512, 16, 2, 128, "float32"))
K5_BWD_CASES = ((512, "bfloat16", False), (1000, "bfloat16", False),
                (1000, "float32", True), (512, "bfloat16", True))
ZAMBA_TRAIN_STEPS = 3
ZAMBA_CHECK_LAYERS = 7
MAMBA_PRODUCTS = 2      # weight products a Mamba-2 layer makes: in_proj, out_proj
SHARED_PRODUCTS = 8     # the shared block's: in_proj, wq wk wv wo, gate up down

# Phase 22, GoogLeNet training and remat "dots".  22a: K6's backward on
# every distinct conv shape of the batch-8 forward at 224, with dx wherever
# the training path asks for it (every conv but stem1, whose images need
# no gradient), and on CONV_BWD_EXTRA: stem1 with dx (stride 2, 7x7, SAME
# padding 2 before and 3 after), odd maps at strides 1 and 2, a Cout and
# Cin no tile divides.  22c: GOOGLENET_TRAIN_STEPS steps of GOOGLENET_BATCH
# images in GOOGLENET_ACCUM microbatches.  22d: qwen2.5-3b under remat
# "dots" for DOTS_TRAIN_STEPS steps of phase 15's batches.
CONV_BWD_EXTRA = (((8, 224, 224, 3), (7, 7, 3, 64), 2), ((3, 13, 11, 5), (3, 3, 5, 7), 2),
                  ((2, 9, 9, 3), (7, 7, 3, 10), 2), ((1, 15, 17, 24), (5, 5, 24, 40), 1),
                  ((2, 10, 10, 33), (1, 1, 33, 17), 2))
GOOGLENET_TRAIN_STEPS, GOOGLENET_BATCH, GOOGLENET_ACCUM = 4, 32, 4
DOTS_TRAIN_STEPS = 2


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
    ref = kern.plain(*(a.float() if a is not None and a.is_floating_point() else a
                       for a in args), **kw)
    if poison is not None:
        torch.cuda.synchronize()
        poison(args)
    out = kern.launch(*args, **kw, **({"body": body} if body else {}))
    torch.cuda.synchronize()
    pairs = zip(out, ref) if isinstance(out, tuple) else [(out, ref)]
    err = max((o.float() - r.float()).abs().max().item() for o, r in pairs
              if o is not None)
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
    lib_ms = timer(prefill_library(torch, F, args))
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


def quantized(torch, args, dtype):
    """Phase 3b's operands from a phase 3 case: its pools quantized by
    ``quantize_kv`` (int8 rows, fp32 scales per (block, row, kv head)) and
    the same pools dequantized to q's type ``dtype`` -- the values every
    int8 body computes on."""
    from repro_torch.models.transformer import dequantize_kv, quantize_kv
    (k8, ks), (v8, vs) = quantize_kv(args[1]), quantize_kv(args[2])
    deq = (dequantize_kv(k8, ks, dtype), dequantize_kv(v8, vs, dtype))
    return (args[0], k8, v8) + tuple(args[3:]), (ks, vs), deq


def hold_int8(torch, kern, args, scales, deq, label, *, lengths, poison, body,
              **kw) -> float:
    """Launch int8 body ``body`` of ``kern`` on ``args`` (int8 pools, their
    ``scales``) and hold it against the plain version evaluated in fp32 on
    the same dequantized values ``deq`` (the pools dequantized to q's
    type), under the kernel's limit; with ``poison``, NaN into the scales
    of every dead row after the plain version has read them.  The same
    body on the bf16 / fp32 pools ``deq`` (NaN in the same dead rows) must
    give the same bits: the int8 loaders stage the values the plain
    loaders read.  Returns the largest absolute error."""
    ks, vs = scales
    q, tables = args[0], args[3]
    ref = kern.plain(q.float(), deq[0].float(), deq[1].float(), *args[3:], **kw)
    twin_args = (q, deq[0].clone(), deq[1].clone()) + tuple(args[3:])
    if poison:
        torch.cuda.synchronize()
        poison_dead_rows(torch, ks, vs, tables, lengths)
        poison_dead_rows(torch, twin_args[1], twin_args[2], tables, lengths)
    out = kern.launch(*args, k_scale=ks, v_scale=vs, body=body, **kw)
    twin = kern.launch(*twin_args, body=body.removesuffix("_i8"), **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    ratio = kern.tolerance(out, ref)
    same = torch.equal(out, twin)
    log(f"{kern.name} int8 pool {label} body={body} q {str(q.dtype)[6:]}"
        f"{' NaN scales past the lengths' if poison else ''}: max_abs_err={err:.3e} "
        f"err/limit={ratio:.3f} bits equal to {body.removesuffix('_i8')} on the "
        f"dequantized pool: {same}")
    if not ratio <= 1.0:
        raise AssertionError(f"{kern.name} {label} {body}: disagrees with its plain "
                             f"version: err/limit {ratio}")
    if not same:
        raise AssertionError(f"{kern.name} {label} {body}: differs from the "
                             f"{body.removesuffix('_i8')} body on the dequantized pool")
    return err


def int8_work(lengths_or_rows, q_rows, *, H=16, K=2, D=128, bs=16, keys) -> tuple:
    """(bytes, flops) of an int8-pool call: q and out in bf16, each live K
    and V row once as int8 with its fp32 scale, the live table entries and
    lengths; QK^T and PV over ``keys`` (query, key) pairs, two flops a
    multiply-add."""
    rows = sum(lengths_or_rows)
    nbytes = 2 * 2 * q_rows * H * D + 2 * rows * K * (D + 4) \
        + 4 * (len(lengths_or_rows) + sum(-(-n // bs) for n in lengths_or_rows))
    return nbytes, 4 * H * D * keys


def int8_kernel_phase(torch, table) -> dict:
    """Phase 3b: K1 and K2 on int8 pools at qwen2.5-3b widths."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import body_for as dec_body_for
    from repro_torch.kernels.prefill_attention.ops import body_for as pre_body_for
    dec = table["paged_decode_attention"]
    pre = table["paged_prefill_attention"]
    timer = Timer(torch)
    results = {}
    errs = {"decode": 0.0, "prefill": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for lengths, softcap in DECODE_CASES:
            base = decode_case(torch, lengths, dtype)
            route = dec_body_for(*quantized(torch, base, dtype)[0][:2])
            for body in dict.fromkeys((route, "fma_i8")):
                for poison in (False, True):
                    args, scales, deq = quantized(torch, base, dtype)
                    err = hold_int8(torch, dec, args, scales, deq,
                                    f"lengths={lengths} softcap={softcap}", lengths=args[4],
                                    poison=poison, body=body, softcap=softcap)
                    if dtype == torch.bfloat16 and body == route:
                        errs["decode"] = max(errs["decode"], err)
        for C, q_start in PREFILL_CASES:
            base = prefill_case(torch, C, q_start, dtype, seeded_blocks=-(-q_start // 16) + 3)
            route = pre_body_for(*quantized(torch, base, dtype)[0][:2])
            for body in dict.fromkeys((route, "fma_i8")):
                for poison in (False, True):
                    args, scales, deq = quantized(torch, base, dtype)
                    err = hold_int8(torch, pre, args, scales, deq, f"C={C} q_start={q_start}",
                                    lengths=args[5], poison=poison, body=body)
                    if dtype == torch.bfloat16 and body == route:
                        errs["prefill"] = max(errs["prefill"], err)

    def timed(kern, name, args, scales, deq, nbytes, flops, library, shape):
        ks, vs = scales
        ms = {b: timer(lambda: kern.launch(*args, k_scale=ks, v_scale=vs, body=b))
              for b in ("mma_i8", "fma_i8")}
        twin = (args[0], deq[0], deq[1]) + tuple(args[3:])
        bf16_ms = {b: timer(lambda: kern.launch(*twin, body=b)) for b in ("mma", "fma")}
        plain_ms = timer(lambda: kern.plain(*args, k_scale=ks, v_scale=vs))
        sdpa_ms = timer(library(twin))
        bms, by = bound(nbytes, flops, BF16_FLOPS)
        log(f"{name} int8 pool timed {shape}: mma_i8 {ms['mma_i8']:.4f}ms fma_i8 "
            f"{ms['fma_i8']:.4f}ms; on the dequantized bf16 pool mma {bf16_ms['mma']:.4f}ms "
            f"fma {bf16_ms['fma']:.4f}ms; plain (gather, dequantize, attend) {plain_ms:.4f}ms; "
            f"SDPA on the dequantized bf16 tensors (not the same function: no library call "
            f"dequantizes) {sdpa_ms:.4f}ms; bound {bms:.5f}ms ({by}; {nbytes} B of int8 rows, "
            f"scales, q and out, {flops} flop)")
        row = []
        for b in ("mma_i8", "fma_i8"):
            host, wall = host_us(torch, lambda: kern.launch(*args, k_scale=ks, v_scale=vs,
                                                            body=b))
            row.append(f"{b} host {host:.2f} us wall {wall:.2f} us")
        log(f"{name} int8 pool host per call, {shape}, {HOST_REPS} back to back: "
            + "; ".join(row))
        return dict(ms=ms["mma_i8"], fma_ms=ms["fma_i8"], bf16_body_ms=bf16_ms["mma"],
                    plain_ms=plain_ms, library_ms=None, sdpa_dequantized_ms=sdpa_ms,
                    bytes=nbytes, flops=flops, bound_ms=bms, bound_by=by,
                    shape=shape + " body=mma_i8")

    lengths = DECODE_TIMED[0]
    args, scales, deq = quantized(torch, decode_case(torch, lengths, torch.bfloat16),
                                  torch.bfloat16)
    nbytes, flops = int8_work(lengths, len(lengths), keys=sum(lengths))
    results["paged_decode_attention:int8"] = dict(
        timed(dec, "paged_decode_attention", args, scales, deq, nbytes, flops,
              lambda a: decode_library(torch, F, a, 8),
              f"B={len(lengths)} lengths={lengths} bf16 q"),
        max_abs_err=errs["decode"])
    C, start = 256, 256
    args, scales, deq = quantized(torch, prefill_case(torch, C, start, torch.bfloat16,
                                                      seeded_blocks=16), torch.bfloat16)
    keys = sum(min(start + i + 1, start + C) for i in range(C))
    nbytes, flops = int8_work((start + C,), C, keys=keys)
    results["paged_prefill_attention:int8"] = dict(
        timed(pre, "paged_prefill_attention", args, scales, deq, nbytes, flops,
              lambda a: prefill_library(torch, F, a), f"C={C} q_start={start} bf16 q"),
        max_abs_err=errs["prefill"])
    return results


def prefill_library(torch, F, args):
    """One SDPA call on a K2 case's values: the pool gathered to (B, H, S,
    D), the causal and length mask."""
    q, kp, vp, tables, qs, lens = args
    _, C, H, D = q.shape
    kg, vg = gathered(torch, kp, vp, tables, H // kp.shape[2])
    kpos = torch.arange(kg.shape[2], device="cuda")[None, :]
    qpos = (qs[:, None] + torch.arange(C, device="cuda")[None, :])[0][:, None]
    mask = ((kpos <= qpos) & (kpos < lens[0]))[None, None]
    qh = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask)


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


def serving_phase(torch, np, table, cache_dtype="bfloat16", baseline=None):
    """Phase 4 (and 5, its profile) on the bf16 pool; phase 4b, with
    ``cache_dtype="int8"``, the same requests on the int8 pool, its KV pool
    bytes and greedy tokens printed beside phase 4's (``baseline``, what
    phase 4 returned).  Returns (launches by kernel, this run's pool bytes,
    outputs, stats and K7 launches)."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    int8 = cache_dtype == "int8"
    tag = "int8 serving" if int8 else "serving"
    card, watts = card_name_and_power_limit()
    cfg = arch_registry.config("qwen2.5-3b")
    t0 = time.monotonic()
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4,
                        prefill_chunk=256, cache_dtype=cache_dtype, device="cuda")
    del params                      # the engine keeps its own cast copy
    gc.collect()
    torch.cuda.synchronize()
    log(f"{tag}: qwen2.5-3b L={cfg.num_layers} d_model={cfg.d_model} "
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
    # every K1 / K2 launch at bf16, D = 128, G = 8 on the tensor-core bodies
    # (their int8 loaders on an int8 pool): one a layer of each decode step
    # and of each prefill chunk
    mma = "mma_i8" if int8 else "mma"
    attn_bodies = {n: dict(table[n].body_launches) for n in LM_KERNELS}
    want_attn = {"paged_decode_attention": {mma: cfg.num_layers * stats.decode_steps},
                 "paged_prefill_attention": {mma: cfg.num_layers * chunks[0]}}
    if attn_bodies != want_attn:
        raise AssertionError(f"{tag}: attention launches by body {attn_bodies}, expected "
                             f"{want_attn} ({stats.decode_steps} decode steps, {chunks[0]} "
                             f"prefill chunks)")
    k7 = (table["matmul"].launches, table["matmul"].plain_calls)
    # every model call (a prefill chunk: one K2 launch a layer; a decode
    # step: one K1 launch a layer) makes the blocks' products and the LM head
    calls = (counts["paged_decode_attention"][0] + counts["paged_prefill_attention"][0]) \
        // cfg.num_layers
    if k7 != ((cfg.num_layers * QWEN_PRODUCTS + 1) * calls, 0):
        raise AssertionError(f"{tag}: matmul launches/plain calls {k7} for {calls} "
                             f"model calls")
    # every bf16 block product on the tensor cores, the fp32 LM head on FMA
    k7_bodies = dict(table["matmul"].body_launches)
    if k7_bodies != {"wgmma": cfg.num_layers * QWEN_PRODUCTS * calls, "fma": calls}:
        raise AssertionError(f"{tag}: matmul launches by body {k7_bodies} for {calls} "
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
    state = eng._state
    if int8 != (state.k.dtype == torch.int8):
        raise AssertionError(f"{tag}: the pool is {state.k.dtype}")
    pool_bytes = sum(t.numel() * t.element_size() for t in state if t.dim() > 2)
    pool_rows = state.k.shape[1] * state.k.shape[2]
    log(f"{tag}: requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s tok/s={stats.tokens_per_s:.2f} "
        f"ttft_p50={stats.ttft_p50_s * 1e3:.1f}ms ttft_p99={stats.ttft_p99_s * 1e3:.1f}ms "
        f"tpot={stats.mean_tpot_s * 1e3:.2f}ms occupancy={stats.slot_occupancy:.2f} "
        f"tok/s/W={stats.tokens_per_s / watts:.4f} at power.limit {watts:.0f} W ({card})")
    outputs = [list(r.output) for r in reqs]
    log(f"{tag}: KV pool {pool_bytes} B ({pool_rows} rows of {pool_bytes // pool_rows} B, "
        f"every layer's K and V" + (" with their scales" if int8 else "") + ")"
        + (f"; {pool_bytes / baseline['pool_bytes']:.4f}x the bf16 pool's "
           f"{baseline['pool_bytes']} B; greedy tokens equal to the bf16 pool's in "
           f"{sum(a == b for a, b in zip(outputs, baseline['outputs']))} of {len(reqs)} "
           f"requests (printed, not gated: the random model at 36 layers is chaotic)"
           if baseline else ""))
    if int8:
        kv_write_host_cost(torch, cfg)
    log(f"{tag}: prefill_tokens={stats.prefill_tokens_computed}/"
        f"{stats.prefill_tokens_total} prefix_shared_blocks={stats.prefix_shared_blocks} "
        f"decode_steps={stats.decode_steps} prefill_compiles={stats.prefill_compiles} "
        f"kv_blocks_peak={stats.kv_blocks_peak} preemptions={stats.preemptions} "
        f"leaks={leaks}")
    log(f"{tag}: attention launches by body {attn_bodies} (= {cfg.num_layers} x "
        f"{stats.decode_steps} decode steps, {cfg.num_layers} x {chunks[0]} prefill chunks)")
    log(f"{tag}: launches={ {n: c[0] for n, c in counts.items()} } matmul={k7[0]} "
        f"(= {cfg.num_layers * QWEN_PRODUCTS + 1} x {calls} model calls; by body "
        f"{k7_bodies}) "
        f"plain_calls={ {n: c[1] for n, c in counts.items()} } "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB "
        f"card={torch.cuda.get_device_name(0)}")
    profile_phase(torch, np, eng, Request, greedy, tag)
    del eng, state
    gc.collect()
    torch.cuda.empty_cache()
    return ({n: c[0] for n, c in counts.items()},
            {"pool_bytes": pool_bytes, "outputs": outputs, "stats": stats,
             "matmul": k7[0]})


def kv_write_host_cost(torch, cfg) -> None:
    """The host's time per layer of a decode step's KV write at serving's
    shape (4 slots): the bf16 pool's two index writes against the int8
    pool's two ``quantize_kv`` calls and four index writes (rows and
    scales); printed."""
    from repro_torch.models.transformer import quantize_kv
    B, K, D = 4, cfg.num_kv_heads, cfg.resolved_head_dim
    row = torch.randn((B, K, D), device="cuda").bfloat16()
    bt = torch.arange(1, B + 1, device="cuda")
    off = torch.arange(B, device="cuda")
    pools = [torch.zeros((B + 1, 16, K, D), device="cuda", dtype=dt)
             for dt in (torch.bfloat16, torch.bfloat16, torch.int8, torch.int8)]
    scales = [torch.zeros((B + 1, 16, K), device="cuda") for _ in range(2)]

    def write_bf16():
        pools[0][bt, off] = row
        pools[1][bt, off] = row

    def write_int8():
        (kq, ks), (vq, vs) = quantize_kv(row), quantize_kv(row)
        pools[2][bt, off], scales[0][bt, off] = kq, ks
        pools[3][bt, off], scales[1][bt, off] = vq, vs
    bf16, _ = host_us(torch, write_bf16)
    int8, _ = host_us(torch, write_int8)
    log(f"int8 serving: host per layer of a decode step's KV write, {HOST_REPS} back to back: "
        f"bf16 pool {bf16:.2f} us, int8 pool {int8:.2f} us (x {cfg.num_layers} layers: "
        f"{(int8 - bf16) * cfg.num_layers / 1e3:.2f} ms more a decode step)")


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


def profile_phase(torch, np, eng, Request, greedy, tag="serving", n=4, new=16):
    """Where the time goes: ``n`` requests of 512 prompt tokens, ``new`` new
    tokens each, under torch.profiler; device time by kernel name and the
    device's busy share of the wall time (one stream, so kernels do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    reqs = [Request(200 + i, rng.integers(0, eng.cfg.vocab_size, size=512)
                    .astype(np.int32), max_new_tokens=new, sampler=greedy())
            for i in range(n)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    label = "profile" if tag == "serving" else f"profile ({tag})"
    log(f"{label}: wall={wall:.3f}s device_busy={busy:.3f}s "
        f"busy_share={busy / wall:.3f} idle_share={1 - busy / wall:.3f} "
        f"decode_steps={stats.decode_steps} verify_steps={stats.verify_steps} "
        f"prefill_tokens={stats.prefill_tokens_computed} (profiled run)")
    mine = {n: sum(r[0] for r in rows if n in r[2]) for n in
            ("decode_split_kernel", "decode_merge_kernel", "paged_decode_kernel",
             "paged_prefill_mma_kernel", "paged_prefill_kernel", "matmul_wgmma_kernel",
             "matmul_kernel") + (("flash_mma_kernel",) if tag == "contiguous serving" else ())}
    log(f"{label}: device ms " + " ".join(f"{n}={v:.3f}" for n, v in mine.items()))
    for ms, count, name in rows[:12]:
        log(f"{label}: {ms:10.3f} ms  {count:6d} calls  {name[:90]}")


def path_check(torch, np, contiguous=False):
    """One 300-token request (a 256-row prefill chunk, then 44 rows seeded
    past it, then one decode step) served at full width in fp32 by a
    ``ServingEngine`` through the kernels and by one through the plain
    versions (``dispatch.plain_versions()``), at depths 1, 2, 4 and 36.
    ``contiguous`` (phase 17): the same request through the contiguous
    engine (the whole prompt prefilled through K4, the decode step through
    K3), at depths 1, 2 and 4, gated as phase 6.
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

    engine_kw = (dict(paged=False) if contiguous else dict(prefill_chunk=256))
    kernels = ("flash_attention", "decode_attention") if contiguous else LM_KERNELS
    label = "contiguous path check" if contiguous else "path check"

    def serve(cfg, p, chunk=512):
        """(prefill logits, decode logits) of the request, (2, V)."""
        eng = ServingEngine(cfg, p, max_len=320, batch_slots=1, chunk=chunk,
                            cache_dtype="float32", device="cuda", **engine_kw)
        rec = Record()
        eng.serve([Request(0, toks, max_new_tokens=2, sampler=rec)])
        leaks = eng.pool.leak_report() if eng.pool is not None else {}
        if any(leaks.values()) or len(rec.seen) != 2:
            raise AssertionError(f"{label}: the request did not run clean")
        return np.stack(rec.seen)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    for depth in (1, 2, 4) if contiguous else (1, 2, 4, full.num_layers):
        cfg = full.replace(num_layers=depth)
        p = dict(params, blocks=tree_map(lambda t: t[:depth], params["blocks"]))
        dispatch.reset_counts()
        kern = serve(cfg, p)
        table = dispatch.kernel_table()
        launched = all(table[n].launches > 0 for n in kernels + ("matmul",)) and \
            not any(k.plain_calls for k in table.values())
        if contiguous:      # and no paged kernel
            launched = launched and not any(table[n].launches for n in LM_KERNELS)
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
        log(f"{label} (fp32, full width, depth {depth}): kernels vs plain "
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
            raise AssertionError(f"{label}: the kernel engine did not run "
                                 f"through {kernels} and K7 alone")
        if tol and not (np.isfinite(kern).all() and max(r_pre, r_dec) <= tol
                        and ratio <= TOL_PATH_EXACT_RATIO):
            raise AssertionError(f"{label}, depth {depth}: kernels and plain "
                                 f"versions disagree ({r_pre}, {r_dec}; ratio to the exact "
                                 f"products' distance {ratio})")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def int8_path_check(torch, np):
    """Phase 6b: phase 6's request served at full width in fp32 with an
    int8 pool, by an engine through the kernels and by ones through the
    plain versions, at depths 1, 2 and 4.

    The int8 path is not continuous in its inputs: a one-ulp difference in
    a K or V element (K7's products against cuBLAS's) can move ``x /
    scale`` across a .5 and the stored int8 by one whole step (amax / 127),
    and the random model carries one step far (measured here).  So the
    gates rest on what is exact.
    - After one layer (depth 1), the pools of the two sides run freely:
      their int8 values equal or one step apart, in at most
      ``TOL_INT8_APART`` of them, and their scales within
      ``TOL_INT8_SCALE_REL``.
    - At each depth, the kernels' logits against a plain run that stores
      the kernel run's quantized rows (every ``quantize_kv`` call answered
      with the kernel run's int8 values and scales, in call order): both
      then read the same pools, and phase 6's limits hold unchanged.
    Printed beside them, not gated: the free-running plain run's logits,
    the values one step apart over all layers and in layer 0 (n0), and how
    far one step moves the logits (s: the largest of six plain runs, each
    with one K or V value of layer 0 a step higher, at positions 0, 128
    and 255 of the first chunk), with the limit TOL + depth x n0 x s they
    would give."""
    from unittest import mock

    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
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
    quantize = transformer.quantize_kv

    def serve(cfg, p, *, record=None, replay=None, moved=None):
        """(prefill and decode logits (2, V), the int8 pools and scales).
        ``record``: a list the quantize_kv calls' (values, scales) are
        appended to; ``replay``: such a list, whose entries answer the calls
        in order; ``moved`` = (call, position): that quantize_kv call of the
        first chunk's layer 0 (1: K, 2: V) stores one value a step higher
        at that position (dim 0 of kv head 0)."""
        calls = [0]

        def hooked(x):
            calls[0] += 1
            if replay is not None:
                q, scale = replay[calls[0] - 1]
                if q.shape != x.shape:
                    raise AssertionError("int8 path check: the replayed schedule differs")
                return q.clone(), scale.clone()
            q, scale = quantize(x)
            if record is not None:
                record.append((q.clone(), scale.clone()))
            if moved and calls[0] == moved[0]:
                at = q[moved[1] // q.shape[1], moved[1] % q.shape[1], 0]
                at[0] += 1 if at[0] < 127 else -1
            return q, scale
        eng = ServingEngine(cfg, p, max_len=320, batch_slots=1, prefill_chunk=256,
                            cache_dtype="int8", device="cuda")
        rec = Record()
        with mock.patch.object(transformer, "quantize_kv", hooked):
            eng.serve([Request(0, toks, max_new_tokens=2, sampler=rec)])
        if any(eng.pool.leak_report().values()) or len(rec.seen) != 2:
            raise AssertionError("int8 path check: the request did not run clean")
        st = eng._state      # blocks 1.. hold the request's rows (0 is the trash block)
        return np.stack(rec.seen), [t[:, 1:].clone() for t in (st.k, st.v, st.k_scale,
                                                                st.v_scale)]

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    for depth in (1, 2, 4):
        cfg = full.replace(num_layers=depth)
        p = dict(params, blocks=tree_map(lambda t: t[:depth], params["blocks"]))
        dispatch.reset_counts()
        recorded = []
        kern, kpools = serve(cfg, p, record=recorded)
        table = dispatch.kernel_table()
        bodies = {n: dict(table[n].body_launches) for n in LM_KERNELS}
        plain_calls = sum(k.plain_calls for k in table.values())
        with dispatch.plain_versions():
            forced, _ = serve(cfg, p, replay=recorded)
            plain, ppools = serve(cfg, p)
            step = max(rel(serve(cfg, p, moved=(call, pos))[0], plain)
                       for call in (1, 2) for pos in (0, 128, 255))
        apart = [(a.int() - b.int()).abs() for a, b in zip(kpools[:2], ppools[:2])]
        n = int(sum((d > 0).sum() for d in apart))
        n0 = int(sum((d[0] > 0).sum() for d in apart))
        worst0 = int(max(d[0].max() for d in apart))
        values = sum(d[0].numel() for d in apart)
        scale_rel0 = max(float(((a[0] - b[0]).abs() / b[0].abs().clamp(min=1e-30)).max())
                         for a, b in zip(kpools[2:], ppools[2:]))
        tol = TOL_PATH_REL[depth]
        r_pre, r_dec = rel(kern[0], forced[0]), rel(kern[1], forced[1])
        f_pre, f_dec = rel(kern[0], plain[0]), rel(kern[1], plain[1])
        log(f"int8 path check (fp32, full width, depth {depth}): kernels vs plain reading "
            f"the kernels' int8 rows rel prefill={r_pre:.3e} decode={r_dec:.3e} "
            f"top1_agree={bool((kern.argmax(-1) == forced.argmax(-1)).all())} (tol {tol}); "
            f"layer 0: {n0} of {values} int8 values one step apart (largest {worst0}, "
            f"tol share {TOL_INT8_APART}), scales rel {scale_rel0:.3e} (tol "
            f"{TOL_INT8_SCALE_REL}); free-running plain: {n} values apart over {depth} "
            f"layer(s), logits rel prefill={f_pre:.3e} decode={f_dec:.3e}, one step moves "
            f"them by up to {step:.3e}, so TOL + depth x n0 x s = "
            f"{tol + depth * n0 * step:.3e} (not gated); attention launches by body {bodies}")
        if not all(set(b) == {"fma_i8"} for b in bodies.values()) or plain_calls:
            raise AssertionError("int8 path check: the kernel engine did not run "
                                 "through the int8 FMA bodies (fp32 q) alone")
        if depth == 1 and not (worst0 <= 1 and n0 <= TOL_INT8_APART * values
                               and scale_rel0 <= TOL_INT8_SCALE_REL):
            raise AssertionError(f"int8 path check: layer 0's int8 pools differ by up to "
                                 f"{worst0} steps in {n0} values, scales by {scale_rel0}")
        if not (np.isfinite(kern).all() and max(r_pre, r_dec) <= tol):
            raise AssertionError(f"int8 path check, depth {depth}: kernels and plain "
                                 f"versions on the same int8 rows disagree ({r_pre}, {r_dec})")
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
    from repro_torch.kernels.ssm_scan.ops import body_for as ssm_body_for
    ssm, fla, dec = (table[n] for n in HYBRID_KERNELS)
    timer = Timer(torch)

    def poison_cache(args):
        poison_cache_rows(torch, *args)

    errs = {n: {} for n in HYBRID_KERNELS}
    ssm_cases = [(f"B=1 S={S} H=64 N=P=64 shared B/C h0={with_state}", S,
                  dict(with_state=with_state)) for S, with_state in ((1000, True),
                                                                      (1024, False))]
    ssm_cases.append(("B=1 S=1000 H=4 N=P=128 per-head q/k", 1000,
                      dict(H=4, N=128, P=128, shared=False, with_state=True)))
    for dtype in (torch.float32, torch.bfloat16):
        e, e_fma = [], []
        for label, S, case in ssm_cases:
            args, h0 = ssm_case(torch, S, dtype, **case)
            route = ssm_body_for(*args[:3])
            if (route == "mma") != (dtype == torch.bfloat16):
                raise AssertionError(f"ssm_scan {label} {dtype}: route {route}")
            label += f" (limit {SSM_RTOL} of max|ref|)"
            e.append(hold(torch, ssm, args, f"{label} body={route}", chunk=128,
                          initial_state=h0))
            if route == "mma":
                e_fma.append(hold(torch, ssm, args, f"{label} body=fma", chunk=128,
                                  initial_state=h0, body="fma"))
                twice = [ssm.launch(*args, chunk=128, initial_state=h0) for _ in range(2)]
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(*twice)):
                    raise AssertionError(f"ssm_scan {label}: two launches of the mma body "
                                         f"differ")
                log(f"ssm_scan {label} body=mma: two launches, the same bits")
        errs["ssm_scan"][dtype] = max(e)
        if e_fma:
            errs["ssm_scan"]["fma bf16"] = max(e_fma)
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
    # K5, bf16 operands as zamba2's prefill gives them: S = 1000, no state
    # in; both bodies, each with the bound at its own rate (the route's, the
    # tensor cores' bf16, in bound_ms; the FMA body's fp32, computed and
    # printed beside it, not in the kernel line), and the host's time a call
    args, _ = ssm_case(torch, 1000, torch.bfloat16)
    nbytes, flops = ssm_work(1000)
    shape = "B=1 S=1000 H=64 N=P=64 chunk 128, bf16 in, fp32 out (one Mamba layer)"
    out["ssm_scan"] = dict(
        ms=timer(lambda: ssm.launch(*args, chunk=128)),
        fma_ms=timer(lambda: ssm.launch(*args, chunk=128, body="fma")),
        plain_ms=timer(lambda: ssm.plain(*args, chunk=128)), library_ms=None,
        bytes=nbytes, flops=flops, peak=BF16_FLOPS,
        fma_bound_ms=bound(nbytes, flops, FP32_FLOPS)[0],
        shape=f"{shape} body={ssm_body_for(*args[:3])}")
    host_cost(torch, ssm, args, "ssm_scan", shape, lambda: ssm_body_for(*args[:3]))
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
    out["ssm_scan"]["max_abs_err_fma_bf16"] = errs["ssm_scan"]["fma bf16"]
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
    # bf16 products on the tensor cores, the fp32 LM head on FMA; every K5
    # launch (bf16, N = P = 64) and every K4 launch (D = 64, bf16) on the
    # tensor-core body, every K3 launch (D = 64, G = 1, bf16) on the split
    # body
    calls = stats.prefills + stats.decode_steps
    bodies = {n: dict(table[n].body_launches)
              for n in ("matmul", "ssm_scan", "flash_attention", "decode_attention")}
    want_bodies = {"matmul": {"wgmma": (per_call - 1) * calls, "fma": calls},
                   "ssm_scan": {"mma": want["ssm_scan"]},
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
            ("ssd_sums_kernel", "ssd_pass_kernel", "ssd_out_kernel", "ssm_scan_kernel",
             "flash_mma_kernel", "flash_kernel", "decode_split_kernel",
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
    only in the plain attention's KV tile.  K4 and its backward kernel
    carry the kernel run's attention, their launches held exactly."""
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
    table = dispatch.kernel_table()
    k7 = table["matmul"]
    counts = (k7.launches, k7.plain_calls)
    want = cfg.num_layers * QWEN_PRODUCTS * 2 + 1 + 2 * (cfg.num_layers * QWEN_PRODUCTS + 1)
    # K4 once a layer and again in the remat recompute, its backward once;
    # fp32, so both on FMA
    k4 = {n: (dict(table[n].body_launches), table[n].plain_calls)
          for n in ("flash_attention", "flash_attention_backward")}
    want_k4 = {"flash_attention": ({"fma": 2 * cfg.num_layers}, 0),
               "flash_attention_backward": ({"fma": cfg.num_layers}, 0)}
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
        f" gradient rel={max(rel(plain64_g, plain_g)):.3e}; matmul launches/plain {counts}; "
        f"K4 launches by body / plain {k4}")
    if counts != (want, 0) or k4 != want_k4:
        raise AssertionError(f"training path check: matmul {counts}, expected ({want}, 0); "
                             f"K4 {k4}, expected {want_k4}")
    finite = all(bool(torch.isfinite(g).all()) for g in kern_g)
    if not (finite and r_loss <= TOL_TRAIN_LOSS_REL and max(r_grad) <= TOL_TRAIN_GRAD_REL
            and ratio <= TOL_TRAIN_EXACT_RATIO):
        raise AssertionError(f"training path check: kernels and plain versions disagree "
                             f"(loss {r_loss}, gradients {max(r_grad)}, ratio {ratio}, "
                             f"finite {finite})")
    del params, ps, kern_g, plain_g, plain64_g, exact_g, batch
    gc.collect()
    torch.cuda.empty_cache()


def training_phase(torch, np, table) -> dict:
    """Phase 15: qwen2.5-3b at full width (36 layers) trained for
    ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens through
    ``python -m repro_torch.launch.train``'s entry point, in the config's 8
    microbatches (``--accum 8``: the launcher's default is 1, as the
    reference's).  Every loss finite; K7, K4 and K4's backward launch
    exactly the counts derived from the config, by body, no plain call;
    then one more step under the profiler.  The step time is printed
    beside ``PLAIN_ATTENTION_STEP_S``, measured with the plain attention.
    Returns the launches by kernel."""
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
        k4_bodies = {n: dict(table[n].body_launches)
                     for n in ("flash_attention", "flash_attention_backward")}
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
    # attention: K4 a layer and again in the recompute (bf16, D = 128: mma),
    # its backward kernel a layer (FMA)
    micro = accum * TRAIN_STEPS
    want_k4 = {"flash_attention": {"mma": 2 * L * micro},
               "flash_attention_backward": {"fma": L * micro}}
    log(f"training: matmul launches={k7[0]} (expected {want} = {per_micro} per microbatch "
        f"x {accum} x {TRAIN_STEPS} steps) by body {k7_bodies} (expected {want_bodies}); "
        f"K4 by body {k4_bodies} (expected {want_k4}); plain_calls={plain or 0}; step "
        f"{s['step_s']:.3f}s with K4 attention beside {PLAIN_ATTENTION_STEP_S} with the "
        f"plain attention")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training: losses {losses}")
    if k7[0] != want or plain or k7_bodies != want_bodies or k4_bodies != want_k4:
        raise AssertionError(f"training: matmul launches {k7[0]}, expected {want}; by "
                             f"body {k7_bodies}, expected {want_bodies}; K4 {k4_bodies}, "
                             f"expected {want_k4}; plain calls {plain}")
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
    k4_ms = sum(r[0] for r in rows if "flash" in r[2])
    k4b_ms = sum(r[0] for r in rows if "fa_bwd_" in r[2])
    log(f"training profile (one step, {accum} microbatches): wall={wall:.3f}s "
        f"device_busy={busy:.3f}s busy_share={busy / wall:.3f} "
        f"idle_share={1 - busy / wall:.3f}; matmul kernel {k7_ms / 1e3:.3f}s = "
        f"{k7_ms / 1e3 / busy:.3f} of device time (wgmma {wg_ms / 1e3:.3f}s, "
        f"fma {fma_ms / 1e3:.3f}s); K4 forward {k4_ms / 1e3:.3f}s, backward "
        f"{k4b_ms / 1e3:.3f}s")
    for ms, count, key in rows[:14]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {key[:90]}")
    del out, tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"matmul": k7[0], "flash_attention": counts["flash_attention"][0],
            "flash_attention_backward": counts["flash_attention_backward"][0],
            "full": (s["step_s"], s["peak_memory_bytes"])}


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


# ---------------------------------------------------------------------------
# Dense contiguous serving and speculative decoding (phases 17-18)
# ---------------------------------------------------------------------------


def serving_summary(stats) -> str:
    return (f"tok/s={stats.tokens_per_s:.2f} ttft_p50={stats.ttft_p50_s * 1e3:.1f}ms "
            f"ttft_p99={stats.ttft_p99_s * 1e3:.1f}ms tpot={stats.mean_tpot_s * 1e3:.2f}ms "
            f"steps_per_token={stats.steps_per_token:.4f}")


def launched_bodies(table) -> tuple[dict, dict]:
    """(launches by body of every kernel that launched, plain calls of
    every kernel that took its plain version) since the last reset."""
    return ({n: dict(k.body_launches) for n, k in table.items() if k.launches},
            {n: k.plain_calls for n, k in table.items() if k.plain_calls})


def contiguous_serving_phase(torch, np, table, baseline) -> dict:
    """Phase 17: qwen2.5-3b at full width, bf16, random weights from seed 0,
    through the contiguous engine (``paged=False``): 4 slots of 1056 rows,
    phase 4's requests.  Launch counts zeroed just before and read just
    after, held exactly by body: K4 36 a prefill and K3 36 a decode step,
    all on the tensor-core bodies; K7 by body; no other kernel and no plain
    call.  Printed beside phase 4's (``baseline``): tok/s, TTFT, TPOT,
    tok/s/W, the caches' bytes against the paged pool's, greedy tokens (not
    gated).  Returns the launches by kernel and the run's stats."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models.registry import fns_for
    from repro_torch.models.transformer import KVCache
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    card, watts = card_name_and_power_limit()
    cfg = arch_registry.config("qwen2.5-3b")
    t0 = time.monotonic()
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    eng = ServingEngine(cfg, params, paged=False, max_len=1024 + 32, batch_slots=4,
                        device="cuda")
    del params                      # the engine keeps its own cast copy
    gc.collect()
    torch.cuda.synchronize()
    log(f"contiguous serving: qwen2.5-3b L={cfg.num_layers} paged={eng.paged}, 4 slots of "
        f"{eng.max_len} rows; init {time.monotonic() - t0:.1f}s")
    eng.serve([Request(100, np.arange(40, dtype=np.int32), max_new_tokens=4,
                       sampler=greedy())])
    reqs = serving_requests(cfg, np, Request, greedy)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    L = cfg.num_layers
    calls = stats.prefills + stats.decode_steps
    want = {"flash_attention": {"mma": L * stats.prefills},
            "decode_attention": {"mma": L * stats.decode_steps},
            "matmul": {"wgmma": L * QWEN_PRODUCTS * calls, "fma": calls}}
    bodies, plain = launched_bodies(table)
    if bodies != want or plain or stats.prefills != len(reqs):
        raise AssertionError(f"contiguous serving: launches by body {bodies}, expected "
                             f"{want}; plain calls {plain}; prefills {stats.prefills}")
    for r in reqs:
        if r.state.value != "done" or len(r.output) != 32:
            raise AssertionError(f"contiguous request {r.rid}: state {r.state}, "
                                 f"{len(r.output)} tokens")
    state = eng._state
    if not isinstance(state, KVCache) or state.k.dtype != torch.bfloat16:
        raise AssertionError(f"contiguous serving: state {type(state).__name__} "
                             f"{state.k.dtype}")
    cache_bytes = 2 * state.k.numel() * state.k.element_size()
    rows = state.k.shape[1] * state.k.shape[2]
    outputs = [list(r.output) for r in reqs]
    base = baseline["stats"]
    log(f"contiguous serving: requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s {serving_summary(stats)} "
        f"occupancy={stats.slot_occupancy:.2f} tok/s/W={stats.tokens_per_s / watts:.4f} "
        f"at power.limit {watts:.0f} W ({card})")
    log(f"contiguous serving: phase 4 (paged, bf16 pool, the same requests) "
        f"{serving_summary(base)} tok/s/W={base.tokens_per_s / watts:.4f}")
    log(f"contiguous serving: KV caches {cache_bytes} B ({rows} rows of {cache_bytes // rows} "
        f"B) against the paged pool's {baseline['pool_bytes']} B; prefills={stats.prefills} "
        f"decode_steps={stats.decode_steps} prefill_compiles={stats.prefill_compiles}; "
        f"greedy tokens equal to phase 4's in "
        f"{sum(a == b for a, b in zip(outputs, baseline['outputs']))} of {len(reqs)} requests "
        f"(printed, not gated: the random model at 36 layers is chaotic)")
    log(f"contiguous serving: launches by body {bodies} (= {L} x {stats.prefills} prefills, "
        f"{L} x {stats.decode_steps} decode steps, {L * QWEN_PRODUCTS + 1} x {calls} model "
        f"calls) plain_calls=0 max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    profile_phase(torch, np, eng, Request, greedy, "contiguous serving")
    del eng, state
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(b.values()) for n, b in bodies.items()}, stats


def contiguous_int8_check(torch, np):
    """Phase 17's int8 branch, as phase 6b holds the pool: a 300-token
    prompt prefilled at full width in fp32 through K4, its rows quantized
    into ``make_cache(..., "int8")``, then 4 decode steps through the
    contiguous decode's int8 branch (``quantize_kv`` of the new row, K3 on
    the cache dequantized to fp32), by the kernels and by the plain
    versions, at depths 1, 2 and 4.  Gated: after one layer the freely
    running sides' int8 rows equal or one step apart in at most
    ``TOL_INT8_APART`` of them, their scales within ``TOL_INT8_SCALE_REL``;
    at each depth the kernels' logits within phase 6's limit
    (``TOL_PATH_REL``) of a plain run that stores the kernel run's
    quantized rows (every ``quantize_kv`` call answered with the kernel
    run's values and scales, in call order).  The free-running plain
    logits are printed beside them."""
    from unittest import mock

    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
    from repro_torch.models.layers.module import tree_map
    from repro_torch.models.registry import fns_for

    torch.backends.cuda.matmul.allow_tf32 = False
    full = arch_registry.config("qwen2.5-3b").replace(compute_dtype="float32")
    params = fns_for(full).init(full, torch.Generator("cuda").manual_seed(0))
    S, steps, max_len = 300, 4, 320
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, full.vocab_size, size=S + steps).astype(np.int32)).cuda()[None]
    quantize = transformer.quantize_kv

    def run(cfg, p, *, record=None, replay=None):
        """(decode logits (steps, V), the QuantKVCache after the steps)."""
        calls = [0]

        def hooked(x):
            calls[0] += 1
            if replay is not None:
                q, scale = replay[calls[0] - 1]
                if q.shape != x.shape:
                    raise AssertionError("contiguous int8 check: the replayed schedule "
                                         "differs")
                return q.clone(), scale.clone()
            q, scale = quantize(x)
            if record is not None:
                record.append((q.clone(), scale.clone()))
            return q, scale
        with mock.patch.object(transformer, "quantize_kv", hooked):
            _, st = transformer.prefill(cfg, p, toks[:, :S], cache_dtype="float32",
                                        max_len=max_len)
            qc = transformer.make_cache(cfg, 1, max_len, "int8", length=st.length,
                                        device="cuda")
            for src, dst, sc in ((st.k, qc.k, qc.k_scale), (st.v, qc.v, qc.v_scale)):
                q, scale = transformer.quantize_kv(src[:, :, :S])
                dst[:, :, :S], sc[:, :, :S] = q, scale
            del st
            logits = []
            for i in range(steps):
                lg, qc = transformer.decode_step(cfg, p, toks[:, S + i:S + i + 1], qc)
                logits.append(lg[0].cpu().numpy())
        return np.stack(logits), qc

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    for depth in (1, 2, 4):
        cfg = full.replace(num_layers=depth)
        p = dict(params, blocks=tree_map(lambda t: t[:depth], params["blocks"]))
        dispatch.reset_counts()
        recorded = []
        kern, kc = run(cfg, p, record=recorded)
        table = dispatch.kernel_table()
        bodies = {n: dict(k.body_launches) for n, k in table.items()
                  if k.launches and n != "matmul"}
        plain_calls = sum(k.plain_calls for k in table.values())
        with dispatch.plain_versions():
            forced, _ = run(cfg, p, replay=recorded)
            plain, pc = run(cfg, p)
        written = slice(0, S + steps)        # layer 0's rows: the prompt's and the steps'
        apart = [(getattr(kc, n)[0, :, written].int() - getattr(pc, n)[0, :, written].int()
                  ).abs() for n in "kv"]
        n0 = int(sum((d > 0).sum() for d in apart))
        worst0 = int(max(d.max() for d in apart))
        values = sum(d.numel() for d in apart)
        scale_rel0 = max(float(((getattr(kc, n)[0, :, written] - getattr(pc, n)[0, :, written])
                                .abs() / getattr(pc, n)[0, :, written].abs().clamp(min=1e-30)
                                ).max()) for n in ("k_scale", "v_scale"))
        tol = TOL_PATH_REL[depth]
        r = rel(kern, forced)
        log(f"contiguous int8 check (fp32, full width, depth {depth}, {steps} decode steps "
            f"on a QuantKVCache of {max_len} rows): kernels vs plain reading the kernels' "
            f"int8 rows rel={r:.3e} top1_agree={bool((kern.argmax(-1) == forced.argmax(-1)).all())} "
            f"(tol {tol}); layer 0: {n0} of {values} int8 values one step apart (largest "
            f"{worst0}, tol share {TOL_INT8_APART}), scales rel {scale_rel0:.3e} (tol "
            f"{TOL_INT8_SCALE_REL}); free-running plain logits rel={rel(kern, plain):.3e} "
            f"(not gated); launches by body {bodies}")
        want = {"flash_attention": {"fma": depth}, "decode_attention": {"fma": depth * steps}}
        if bodies != want or plain_calls:
            raise AssertionError(f"contiguous int8 check: launches by body {bodies}, "
                                 f"expected {want}; {plain_calls} plain calls")
        if depth == 1 and not (worst0 <= 1 and n0 <= TOL_INT8_APART * values
                               and scale_rel0 <= TOL_INT8_SCALE_REL):
            raise AssertionError(f"contiguous int8 check: layer 0's int8 rows differ by up "
                                 f"to {worst0} steps in {n0} values, scales by {scale_rel0}")
        if not (np.isfinite(kern).all() and r <= tol):
            raise AssertionError(f"contiguous int8 check, depth {depth}: kernels and plain "
                                 f"versions on the same int8 rows disagree ({r})")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def verify_case(torch, q_starts, C, dtype, *, H=16, K=2, D=128, bs=16, seed=0):
    """K2 at the verify shape: one sequence per ``q_starts`` entry (C
    candidate rows there, shuffled disjoint tables over the rows they
    reach) and one padding sequence on an all-trash table at q_start 0,
    length C -- as the engine's verify pass pads its batch."""
    g = torch.Generator("cuda").manual_seed(seed)
    live = len(q_starts)
    mb = max(-(-(s + C) // bs) for s in q_starts) + 1
    N = 1 + live * mb
    q = torch.randn((live + 1, C, H, D), generator=g, device="cuda").to(dtype)
    kp = torch.randn((N, bs, K, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((N, bs, K, D), generator=g, device="cuda").to(dtype)
    tables = torch.zeros((live + 1, mb), dtype=torch.int32, device="cuda")
    tables[:live] = (1 + torch.randperm(live * mb, generator=g, device="cuda")
                     ).reshape(live, mb).int()
    for b, s in enumerate(q_starts):          # past the candidate rows: trash
        tables[b, -(-(s + C) // bs):] = 0
    qs = torch.tensor(list(q_starts) + [0], dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, qs, qs + C


def verify_library(torch, F, args):
    """One SDPA call on a verify case's values: the pool gathered to (B, H,
    S, D), each sequence's causal and length mask."""
    q, kp, vp, tables, qs, lens = args
    _, C, H, D = q.shape
    kg, vg = gathered(torch, kp, vp, tables, H // kp.shape[2])
    kpos = torch.arange(kg.shape[2], device="cuda")[None, None, :]
    qpos = (qs[:, None] + torch.arange(C, device="cuda")[None, :])[:, :, None]
    mask = ((kpos <= qpos) & (kpos < lens[:, None, None]))[:, None]
    qh = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask)


def verify_kernel_phase(torch, table) -> None:
    """Phase 18, first: K2 at the verify shape (``VERIFY_CASES``: 4
    sequences of C = spec_k + 1 rows at mid-block q_starts and a padding
    sequence), bf16 on the tensor-core body and fp32 on FMA, each as made
    and with NaN in every pool row that is not live, held against the plain
    version (phase 3's limits); then the first case timed in bf16 beside
    the FMA body, the plain version, SDPA and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.prefill_attention.ops import body_for
    pre = table["paged_prefill_attention"]
    C = SPEC_K + 1
    for dtype in (torch.float32, torch.bfloat16):
        for q_starts in VERIFY_CASES:
            for poison in (None, lambda a: poison_dead_rows(torch, a[1], a[2], a[3], a[5])):
                args = verify_case(torch, q_starts, C, dtype)
                hold(torch, pre, args, f"verify B={len(q_starts)}+1 padding C={C} "
                     f"q_start={q_starts} body={body_for(args[0])}"
                     f"{' NaN in the dead rows' if poison else ''}", poison=poison)
    timer = Timer(torch)
    args = verify_case(torch, VERIFY_CASES[0], C, torch.bfloat16)
    q, kp, _, tables, qs, lens = args
    B, _, H, D = q.shape
    K = kp.shape[2]
    ms = {body: timer(lambda: pre.launch(*args, body=body)) for body in ("mma", "fma")}
    plain_ms = timer(lambda: pre.plain(*args))
    lib_ms = timer(verify_library(torch, F, args))
    keys = sum(int(s) + i + 1 for s in qs.tolist() for i in range(C))
    nbytes = 2 * (2 * B * C * H * D + 2 * int(lens.sum()) * K * D) \
        + 4 * (2 * B + sum(-(-int(n) // 16) for n in lens.tolist()))
    flops = 4 * H * D * keys
    bms, by = bound(nbytes, flops, BF16_FLOPS)
    log(f"paged_prefill_attention timed at the verify shape B={B} (one padding) C={C} "
        f"q_start={VERIFY_CASES[0]} bf16: mma {ms['mma']:.4f}ms fma {ms['fma']:.4f}ms plain "
        f"{plain_ms:.4f}ms library {lib_ms:.4f}ms bound {bms:.5f}ms ({by}; {nbytes} B, "
        f"{flops} flop)")


def spec_serving_phase(torch, np, table, baseline) -> dict:
    """Phase 18: qwen2.5-3b at full width, bf16, random weights from seed 0,
    speculative decoding with the target drafting for itself (``spec_k``
    3, the drafter on the engine's own prepared weights) on the paged
    engine of phase 4 (4 slots, 256-token prefill chunks), phase 4's
    requests.  Launch counts held exactly by body from the engine's own
    counters: K2 36 a verify pass, a drafter seed and a target prefill
    chunk; K1 36 a drafter step and a vanilla decode step; all on the
    tensor-core bodies; K7 by body; no other kernel, no plain call.  Both
    pools leak-free.  Printed beside phase 4's: accept rate, verify steps,
    steps per token, TPOT, tok/s; greedy tokens (not gated).  Returns the
    launches by kernel."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    card, watts = card_name_and_power_limit()
    cfg = arch_registry.config("qwen2.5-3b")
    t0 = time.monotonic()
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, prefill_chunk=256,
                        draft_cfg=cfg, draft_params=params, spec_k=SPEC_K, device="cuda")
    del params                      # the engine (and its drafter) keep one cast copy
    gc.collect()
    torch.cuda.synchronize()
    drafter = eng._drafter
    if drafter.params is not eng.params:
        raise AssertionError("spec serving: the drafter holds a second copy of the weights")
    log(f"spec serving: qwen2.5-3b L={cfg.num_layers} spec_k={eng.spec_k} (self-speculation, "
        f"shared weights), pool {eng.pool.capacity} blocks, table {eng.max_blocks} blocks, "
        f"drafter pool {drafter.pool.capacity} blocks; init {time.monotonic() - t0:.1f}s")
    eng.serve([Request(100, np.arange(40, dtype=np.int32), max_new_tokens=4,
                       sampler=greedy())])
    reqs = serving_requests(cfg, np, Request, greedy)
    # count the model calls the engine and its drafter make
    n = {"chunks": 0, "seeds": 0, "steps": 0}
    wrapped = {"chunks": (eng, "_prefill_paged"), "seeds": (drafter, "_prefill"),
               "steps": (drafter, "_decode")}
    originals = {k: getattr(o, a) for k, (o, a) in wrapped.items()}

    def counted(key):
        def call(*a, **kw):
            n[key] += 1
            return originals[key](*a, **kw)
        return call
    for key, (obj, attr) in wrapped.items():
        setattr(obj, attr, counted(key))
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    for key, (obj, attr) in wrapped.items():
        setattr(obj, attr, originals[key])
    L = cfg.num_layers
    calls = n["chunks"] + n["seeds"] + n["steps"] + stats.verify_steps + stats.decode_steps
    want = {"paged_prefill_attention": {"mma": L * (stats.verify_steps + n["seeds"]
                                                    + n["chunks"])},
            "paged_decode_attention": {"mma": L * (n["steps"] + stats.decode_steps)},
            "matmul": {"wgmma": L * QWEN_PRODUCTS * calls, "fma": calls}}
    bodies, plain = launched_bodies(table)
    if bodies != want or plain:
        raise AssertionError(f"spec serving: launches by body {bodies}, expected {want}; "
                             f"plain calls {plain}; counts {n}, {stats.verify_steps} verify "
                             f"and {stats.decode_steps} decode steps")
    for r in reqs:
        if r.state.value != "done" or len(r.output) != 32:
            raise AssertionError(f"spec request {r.rid}: state {r.state}, "
                                 f"{len(r.output)} tokens")
    leaks = {"target": eng.pool.leak_report(), "drafter": drafter.pool.leak_report()}
    if any(v for d in leaks.values() for v in d.values()):
        raise AssertionError(f"spec serving: KV pool leak {leaks}")
    if not stats.verify_steps or stats.decode_steps or n["seeds"] != len(reqs):
        # every request is greedy, so every slot decodes speculatively
        raise AssertionError(f"spec serving: {stats.verify_steps} verify steps, "
                             f"{stats.decode_steps} vanilla decode steps, {n['seeds']} "
                             f"drafter seeds for {len(reqs)} requests")
    outputs = [list(r.output) for r in reqs]
    base = baseline["stats"]
    log(f"spec serving: requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s {serving_summary(stats)} "
        f"occupancy={stats.slot_occupancy:.2f} tok/s/W={stats.tokens_per_s / watts:.4f} "
        f"at power.limit {watts:.0f} W ({card})")
    log(f"spec serving: accept_rate={stats.accept_rate:.4f} "
        f"({stats.spec_accepted} of {stats.spec_proposed} drafts) "
        f"verify_steps={stats.verify_steps} decode_steps={stats.decode_steps} drafter "
        f"steps={n['steps']} drafter seeds={n['seeds']} target prefill chunks={n['chunks']} "
        f"prefill_compiles={stats.prefill_compiles} preemptions={stats.preemptions} "
        f"leaks={leaks}")
    log(f"spec serving: phase 4 (vanilla decode, the same engine and requests) "
        f"{serving_summary(base)} decode_steps={base.decode_steps}; greedy tokens equal to "
        f"phase 4's in {sum(a == b for a, b in zip(outputs, baseline['outputs']))} of "
        f"{len(reqs)} requests (printed, not gated: bf16 at 36 layers is chaotic)")
    log(f"spec serving: launches by body {bodies} plain_calls=0 max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    # a shorter window than phase 5's: a round makes k + 1 model calls, and
    # reading the profile back takes minutes at phase 5's window
    profile_phase(torch, np, eng, Request, greedy, "spec serving", n=2, new=4)
    del eng, drafter
    gc.collect()
    torch.cuda.empty_cache()
    return {n_: sum(b.values()) for n_, b in bodies.items()}


def spec_gate(torch, np) -> None:
    """Phase 18's gate: qwen2.5-3b at full width cut to 2 layers (random
    weights from seed 0), fp32, phase 4's requests on the paged engine,
    vanilla and speculative (self-speculation, spec_k 3): the greedy tokens
    must be equal, through the kernels (K1 and K2 on their FMA bodies, or
    ``fma_i8``), on an fp32 pool and on an int8 pool.  On a mismatch the
    first differing step is printed with the logit margins of the
    distribution that chose it (a fresh prefill of the common prefix
    through the kernels): top-1 over top-2, and vanilla's token over the
    speculative one's."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = arch_registry.config("qwen2.5-3b").replace(compute_dtype="float32", num_layers=2)
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    for cache_dtype in ("float32", "int8"):
        runs = {}
        for spec in (False, True):
            kw = dict(draft_cfg=cfg, draft_params=params, spec_k=SPEC_K) if spec else {}
            eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4,
                                prefill_chunk=256, cache_dtype=cache_dtype, device="cuda",
                                **kw)
            reqs = serving_requests(cfg, np, Request, greedy)
            dispatch.reset_counts()
            st = eng.serve(reqs)
            torch.cuda.synchronize()
            bodies, plain = launched_bodies(dispatch.kernel_table())
            leaks = [eng.pool.leak_report()] + (
                [eng._drafter.pool.leak_report()] if spec else [])
            fma = "fma_i8" if cache_dtype == "int8" else "fma"
            if plain or any(v for d in leaks for v in d.values()) or set(bodies) != {
                    "paged_decode_attention", "paged_prefill_attention", "matmul"} or any(
                    set(bodies[k]) != {fma} for k in LM_KERNELS):
                raise AssertionError(f"spec gate ({cache_dtype}, spec={spec}): launches by "
                                     f"body {bodies}, plain calls {plain}, leaks {leaks}")
            runs[spec] = ([list(r.output) for r in reqs], st, reqs)
            del eng
        (van, vst, vreqs), (spc, sst, _) = runs[False], runs[True]
        equal = van == spc
        log(f"spec gate (fp32, full width, depth 2, {cache_dtype} pool): speculative greedy "
            f"tokens equal to vanilla's: {equal} ({sum(len(o) for o in spc)} tokens, "
            f"{len(spc)} requests); accept_rate={sst.accept_rate:.4f} "
            f"verify_steps={sst.verify_steps} steps_per_token={sst.steps_per_token:.4f} "
            f"(vanilla {vst.steps_per_token:.4f}, {vst.decode_steps} decode steps)")
        if not equal:
            raise token_mismatch(torch, np, cfg, params, [r.prompt for r in vreqs], van,
                                 spc, f"spec gate ({cache_dtype})", "vanilla", "speculative")
    del params
    # printed, not gated: bf16 self-speculation's accept rate by depth (the
    # drafter's K1 and the verify's K2 round differently; how far the
    # random model carries that is its depth's to say)
    for depth in SPEC_BF16_DEPTHS:
        cfg = arch_registry.config("qwen2.5-3b").replace(num_layers=depth)
        params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
        eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4,
                            prefill_chunk=256, draft_cfg=cfg, draft_params=params,
                            spec_k=SPEC_K, device="cuda")
        st = eng.serve(serving_requests(cfg, np, Request, greedy))
        log(f"spec serving at depth {depth} (bf16, printed, not gated): accept_rate="
            f"{st.accept_rate:.4f} ({st.spec_accepted} of {st.spec_proposed}) "
            f"verify_steps={st.verify_steps} tpot={st.mean_tpot_s * 1e3:.2f}ms")
        del eng, params
    gc.collect()
    torch.cuda.empty_cache()


def token_mismatch(torch, np, cfg, params, prompts, want, got, label, want_name,
                   got_name) -> AssertionError:
    """The error for two greedy token lists that should be equal: the first
    request and step where they part, with the logit margins of the
    distribution that chose there (a fresh prefill of the common prefix
    through the kernels): top-1 over top-2, and ``want``'s token over
    ``got``'s."""
    from repro_torch.models import transformer

    i = next(i for i in range(len(want)) if want[i] != got[i])
    j = next((j for j, (a, b) in enumerate(zip(want[i], got[i])) if a != b), None)
    if j is None:
        return AssertionError(f"{label}: request {i} has {len(want[i])} {want_name} tokens "
                              f"and {len(got[i])} {got_name} tokens, equal as far as both go")
    ctx = np.concatenate([prompts[i], np.asarray(want[i][:j], np.int32)])
    lg, _ = transformer.prefill(cfg, params, torch.from_numpy(ctx[None]).cuda())
    lg = lg[0].cpu().numpy()
    top = np.sort(lg)[-2:]
    return AssertionError(
        f"{label}: request {i} differs first at step {j}: {want_name} {want[i][j]}, "
        f"{got_name} {got[i][j]}; margins there: top-1 over top-2 {top[1] - top[0]:.3e}, "
        f"{want_name}'s over {got_name}'s {lg[want[i][j]] - lg[got[i][j]]:.3e} "
        f"(of max |logit| {np.abs(lg).max():.3e})")


# ---------------------------------------------------------------------------
# Fault tolerance, the host KV tier and service mode (phase 19)
# ---------------------------------------------------------------------------


def tier_waves(cfg, np, Request, greedy, seed=19) -> list:
    """19a's traffic as its three serve calls: the first visits of the 3
    prefixes (rids 0-2), the 4 fillers (10-13), the revisits (3-5)."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    prefixes = [rng.integers(0, V, TIER_PREFIX).astype(np.int32) for _ in range(3)]

    def visit(v):
        return [Request(3 * v + g, np.concatenate(
                    [p, rng.integers(0, V, TIER_TAIL).astype(np.int32)]),
                        max_new_tokens=TIER_NEW, sampler=greedy())
                for g, p in enumerate(prefixes)]
    first = visit(0)
    fillers = [Request(10 + i, rng.integers(0, V, TIER_FILLER).astype(np.int32),
                       max_new_tokens=TIER_FILLER_NEW, sampler=greedy()) for i in range(4)]
    return [first, fillers, visit(1)]


def tier_engine(ServingEngine, cfg, params, host_blocks, cache_dtype="bfloat16", **kw):
    """Phase 4's engine (4 slots, 256-token chunks, max_len 1056) on a
    264-block pool with a ``host_blocks`` host tier."""
    return ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, prefill_chunk=256,
                         pool_blocks=TIER_POOL_BLOCKS, host_blocks=host_blocks,
                         cache_dtype=cache_dtype, device="cuda", **kw)


class CallCounter:
    """Counts the calls of one model function of an engine (a prefill
    chunk: one K2 launch a layer) and the threads that made them."""

    def __init__(self, obj, attr):
        self.obj, self.attr, self.orig = obj, attr, getattr(obj, attr)
        self.n = 0
        self.threads: set = set()
        setattr(obj, attr, self)

    def __call__(self, *a, **kw):
        self.n += 1
        self.threads.add(threading.get_ident())
        return self.orig(*a, **kw)

    def restore(self) -> None:
        setattr(self.obj, self.attr, self.orig)


class SpillRecorder:
    """Keeps the clone each spill takes (the leaves the transfer worker
    copies to the host), by prefix digest, to hold restored blocks
    against."""

    def __init__(self, eng):
        self.leaves: dict = {}
        self._last = None
        self._read, self._spill = eng._read_block_slices, eng._spill_block
        eng._read_block_slices, eng._spill_block = self.read, self.spill

    def read(self, bid):
        self._last = self._read(bid)
        return self._last

    def spill(self, bid, key):
        queued = self._spill(bid, key)
        if queued:
            self.leaves.setdefault(key, self._last)
        return queued


def bits(torch, t):
    """A tensor's bytes, for bit-for-bit comparison."""
    return t.contiguous().view(-1).view(torch.uint8)


def check_restored(torch, eng, rec, revisits, tag) -> int:
    """Every revisit's 32 prefix blocks, restored from the host tier into
    the pool (the prefix index names them after the serve), equal bit for
    bit the rows cloned when the first visit's blocks were spilled, leaf
    by leaf (k, v and an int8 pool's scales).  Returns the blocks held."""
    n = 0
    for r in revisits:
        for key in eng._prefix_keys(r.prompt)[:TIER_PREFIX // eng.block_size]:
            bid, gen = eng._prefix_index[key]
            want = rec.leaves.get(key)
            if want is None or not eng.pool.block_live(bid, gen):
                raise AssertionError(f"{tag}: request {r.rid}'s prefix block was not spilled "
                                     f"or is not live")
            for name, t in want.items():
                if not torch.equal(bits(torch, getattr(eng._state, name)[:, bid]),
                                   bits(torch, t)):
                    raise AssertionError(f"{tag}: request {r.rid}: restored block {bid}'s "
                                         f"{name} differs from the rows cloned at its spill")
            n += 1
    return n


def serve_waves(torch, eng, waves) -> dict:
    """Serve 19a's three waves on ``eng``, one ``serve`` call each, with the
    kernels' counts zeroed just before and read just after."""
    from repro_torch.kernels import dispatch

    chunks = CallCounter(eng, "_prefill_paged")
    dispatch.reset_counts()
    t0 = time.monotonic()
    stats = [eng.serve(w) for w in waves]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    chunks.restore()
    bodies, plain = launched_bodies(dispatch.kernel_table())
    total = {k: sum(getattr(s, k) for s in stats)
             for k in ("kv_spills", "kv_fetches", "prefix_hits_host", "spill_bytes",
                       "prefill_tokens_computed", "prefill_tokens_total", "decode_steps",
                       "tokens", "requests_failed", "faults_injected")}
    return {"stats": stats, "total": total, "bodies": bodies, "plain": plain,
            "chunks": chunks.n, "wall": wall,
            "outputs": [list(r.output) for w in waves for r in w]}


def want_bodies(cfg, run, mma) -> dict:
    """The launches by body a served run must show: K2 one a layer of each
    prefill chunk, K1 one a layer of each decode step, K7 the blocks'
    products of every model call on wgmma and the fp32 LM head on FMA."""
    L, calls = cfg.num_layers, run["chunks"] + run["total"]["decode_steps"]
    return {"paged_prefill_attention": {mma: L * run["chunks"]},
            "paged_decode_attention": {mma: L * run["total"]["decode_steps"]},
            "matmul": {"wgmma": L * QWEN_PRODUCTS * calls, "fma": calls}}


def leak_free(eng, tag) -> dict:
    eng.drain_tier_io()
    leaks = eng.pool.leak_report()
    if any(leaks.values()):
        raise AssertionError(f"{tag}: KV pool leak {leaks}")
    return leaks


def block_copy_ms(torch, eng, bid, reps=20) -> tuple[float, float]:
    """One pool block's device-to-host copy (as the transfer worker makes
    it: ``host_leaf`` of a clone, pageable memory) and its host-to-device
    copy into the pool (``_write_blocks``), median ms of ``reps`` each on
    an idle card."""
    from repro_torch.core.offload import host_leaf

    leaves = eng._read_block_slices(bid)
    torch.cuda.synchronize()
    d2h, h2d = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        host = {k: host_leaf(v) for k, v in leaves.items()}
        d2h.append(time.perf_counter() - t0)
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._write_blocks([bid], [host])        # the same bytes back
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t0)
    return statistics.median(d2h) * 1e3, statistics.median(h2d) * 1e3


def close(torch, *engines) -> None:
    for eng in engines:
        eng.close()
    gc.collect()
    torch.cuda.empty_cache()


def qwen_full(torch):
    """qwen2.5-3b's full-width config and random weights from seed 0."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.models.registry import fns_for

    cfg = arch_registry.config("qwen2.5-3b")
    return cfg, fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))


def tier_phase(torch, np, cfg, params) -> dict:
    """Phase 19a: qwen2.5-3b at full width, bf16, through the host KV tier
    on churn traffic (``tier_waves``), then the same traffic untiered, then
    tiered on an int8 pool.  Gated exactly: spills, fetches and host
    prefix hits, spill bytes, prompt tokens computed (``TIER_*``); the
    launches by body from the engine's calls (all ``mma``, ``mma_i8`` on
    the int8 pool); each restored block equal bit for bit to the rows
    cloned at its spill; leak-free pools and a drained tier.  Printed: the
    revisits' TTFT beside the untiered run's, the copy times, the
    executor's host time per spill capture and per fetch commit, and
    whether the greedy tokens equal the untiered run's.  Returns the
    launches by kernel (the int8 run's under ``name:int8``)."""
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    card, watts = card_name_and_power_limit()
    runs, launches = {}, {}
    for label, host_blocks, cache_dtype in (("tiered", TIER_HOST_BLOCKS, "bfloat16"),
                                            ("untiered", 0, "bfloat16"),
                                            ("tiered int8", TIER_HOST_BLOCKS, "int8")):
        tiered = host_blocks > 0
        eng = tier_engine(ServingEngine, cfg, params, host_blocks, cache_dtype)
        rec = SpillRecorder(eng) if tiered else None
        waves = tier_waves(cfg, np, Request, greedy)
        run = serve_waves(torch, eng, waves)
        tag = f"19a {label}"
        tot = run["total"]
        int8 = cache_dtype == "int8"
        want = want_bodies(cfg, run, "mma_i8" if int8 else "mma")
        if run["bodies"] != want or run["plain"]:
            raise AssertionError(f"{tag}: launches by body {run['bodies']}, expected {want}; "
                                 f"plain calls {run['plain']}")
        bad = [r.rid for w in waves for r in w
               if r.state.value != "done" or len(r.output) != r.max_new_tokens]
        if bad:
            raise AssertionError(f"{tag}: requests {bad} did not finish")
        got = {"kv_spills": tot["kv_spills"], "kv_fetches": tot["kv_fetches"],
               "prefix_hits_host": tot["prefix_hits_host"],
               "spill_bytes": tot["spill_bytes"],
               "prefill_tokens_computed": tot["prefill_tokens_computed"]}
        spills = TIER_SPILLS if tiered else 0
        fetches = TIER_FETCHES if tiered else 0
        expect = {"kv_spills": spills, "kv_fetches": fetches, "prefix_hits_host": fetches,
                  "spill_bytes": spills * TIER_BLOCK_BYTES[cache_dtype],
                  "prefill_tokens_computed": TIER_COMPUTED[tiered]}
        if got != expect:
            raise AssertionError(f"{tag}: counters {got}, expected {expect}")
        leaks = leak_free(eng, tag)
        line = (f"{tag}: {tot['prefill_tokens_computed']} of {tot['prefill_tokens_total']} "
                f"prompt tokens computed, {run['chunks']} prefill chunks, "
                f"{tot['decode_steps']} decode steps, {tot['tokens']} tokens in "
                f"{run['wall']:.3f}s; revisits {serving_summary(run['stats'][2])}; "
                f"leaks={leaks}")
        if tiered:
            held = check_restored(torch, eng, rec, waves[2], tag)
            target = eng._kv_target
            line += (f"; spills={tot['kv_spills']} fetches={tot['kv_fetches']} "
                     f"host_hits={tot['prefix_hits_host']} spill_bytes={tot['spill_bytes']} "
                     f"({tot['spill_bytes'] // tot['kv_spills']} B a block); {held} restored "
                     f"blocks equal bit for bit to their spill-time clones; executor host "
                     f"time {eng.spill_capture_s / tot['kv_spills'] * 1e6:.1f} us a spill "
                     f"capture, {eng.fetch_commit_s / tot['kv_fetches'] * 1e6:.1f} us a fetch "
                     f"commit; transfer worker {target.copy_s / target.copies * 1e3:.4f} ms a "
                     f"block's device-to-host copy (stream wait included, {target.copies} "
                     f"copies)")
            d2h, h2d = block_copy_ms(torch, eng, eng._prefix_index[
                eng._prefix_keys(waves[2][0].prompt)[0]][0])
            nbytes = TIER_BLOCK_BYTES[cache_dtype]
            line += (f"; one block on an idle card: device-to-host {d2h:.4f} ms "
                     f"({nbytes / d2h / 1e6:.2f} GB/s), host-to-device into the pool "
                     f"{h2d:.4f} ms ({nbytes / h2d / 1e6:.2f} GB/s)")
        log(line + f" ({card}, {watts:.0f} W)")
        if not int8:
            for name, b in run["bodies"].items():
                launches[name] = launches.get(name, 0) + sum(b.values())
        else:
            for name, b in run["bodies"].items():
                key = name if name == "matmul" else f"{name}:int8"
                launches[key] = launches.get(key, 0) + sum(b.values())
        runs[label] = run
        close(torch, eng)
        del eng, rec
    t, u = runs["tiered"], runs["untiered"]
    ttft = {k: statistics.median(r["stats"][2].ttft) * 1e3 for k, r in runs.items()}
    churn = {k: r["total"]["prefill_tokens_computed"] - 4 * TIER_FILLER for k, r in runs.items()}
    log(f"19a: revisits' TTFT p50 {ttft['tiered']:.1f} ms tiered, {ttft['untiered']:.1f} ms "
        f"untiered, {ttft['tiered int8']:.1f} ms tiered int8; the six churn requests computed "
        f"{churn['tiered']} of {churn['untiered']} prompt tokens "
        f"({churn['tiered'] / churn['untiered']:.4f}x); K2 launches "
        f"{sum(t['bodies']['paged_prefill_attention'].values())} tiered against "
        f"{sum(u['bodies']['paged_prefill_attention'].values())} untiered; greedy tokens "
        f"equal to the untiered run's: {t['outputs'] == u['outputs']} (printed: bf16 at 36 "
        f"layers; gated at depth 2 in fp32); int8 against bf16 tiered equal in "
        f"{sum(a == b for a, b in zip(runs['tiered int8']['outputs'], t['outputs']))} of "
        f"{len(t['outputs'])} requests")
    return launches


def fault_phase(torch, np, cfg, params) -> None:
    """Phase 19b, on 19a's tiered engine and traffic: ``FAULT_PLAN`` fires
    every request-level and transfer site; every request ends DONE or
    FAILED, the pool leak-free and the tier drained.  Then ``deadline_s=0``
    on two requests fails both with ``DeadlineExceeded``; then a
    ``replica.executor:raise:4`` crash in blocking ``serve`` fails every
    request, surfaces, refuses later submits; pools leak-free."""
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.faults import (DeadlineExceeded, ExecutorCrash, FaultError,
                                            FaultPlan)
    from repro_torch.serving.sampler import greedy

    plan = FaultPlan.parse(FAULT_PLAN)
    fired = {}
    fire = plan.fire

    def counted_fire(site, **kw):
        spec = fire(site, **kw)
        if spec is not None:
            fired[site] = fired.get(site, 0) + 1
        return spec
    plan.fire = counted_fire
    eng = tier_engine(ServingEngine, cfg, params, TIER_HOST_BLOCKS, fault_plan=plan)
    waves = tier_waves(cfg, np, Request, greedy)
    stats = [eng.serve(w) for w in waves]
    torch.cuda.synchronize()
    reqs = [r for w in waves for r in w]
    states = {r.rid: r.state.value for r in reqs}
    if any(v not in ("done", "failed") for v in states.values()):
        raise AssertionError(f"19b: a request is not terminal: {states}")
    leaks = leak_free(eng, "19b")
    if set(fired) != FAULT_SITES or plan.fired < len(FAULT_SITES):
        raise AssertionError(f"19b: sites fired {fired} ({plan.fired} in all), expected "
                             f"each of {sorted(FAULT_SITES)}")
    failed = sorted(r.rid for r in reqs if r.state.value == "failed")
    log(f"19b faults ({FAULT_PLAN}): fired {fired}, {plan.fired} in all; failed requests "
        f"{failed} ({sorted({type(r.error).__name__ for r in reqs if r.error})}); "
        f"requests_failed={sum(s.requests_failed for s in stats)} "
        f"faults_injected={sum(s.faults_injected for s in stats)} "
        f"spills={sum(s.kv_spills for s in stats)} fetches={sum(s.kv_fetches for s in stats)} "
        f"prompt tokens computed {sum(s.prefill_tokens_computed for s in stats)}; "
        f"leaks={leaks}")
    # deadlines: two requests already past theirs, one without
    rng = np.random.default_rng(190)
    dl = [Request(20 + i, rng.integers(0, cfg.vocab_size, 300).astype(np.int32),
                  max_new_tokens=16, sampler=greedy(), deadline_s=0.0 if i < 2 else None)
          for i in range(3)]
    st = eng.serve(dl)
    if [r.state.value for r in dl] != ["failed", "failed", "done"] or not all(
            isinstance(r.error, DeadlineExceeded) for r in dl[:2]):
        raise AssertionError(f"19b deadlines: states {[r.state.value for r in dl]}, errors "
                             f"{[type(r.error).__name__ for r in dl]}")
    leaks = leak_free(eng, "19b deadlines")
    log(f"19b deadlines: 2 requests with deadline_s=0 failed with DeadlineExceeded, the "
        f"third done ({len(dl[2].output)} tokens); requests_failed={st.requests_failed}; "
        f"leaks={leaks}")
    close(torch, eng)
    del eng
    # a crash in blocking serve
    eng = tier_engine(ServingEngine, cfg, params, TIER_HOST_BLOCKS,
                      fault_plan=FaultPlan.parse("replica.executor:raise:4"))
    first = tier_waves(cfg, np, Request, greedy)[0]
    try:
        eng.serve(first)
    except FaultError:
        pass
    else:
        raise AssertionError("19b crash: serve returned")
    if not all(r.state.value == "failed" for r in first) or not isinstance(
            eng.failure, FaultError):
        raise AssertionError(f"19b crash: states {[r.state.value for r in first]}, failure "
                             f"{eng.failure!r}")
    try:
        eng.submit(tier_waves(cfg, np, Request, greedy)[0][0])
    except ExecutorCrash:
        pass
    else:
        raise AssertionError("19b crash: a submit after the crash was taken")
    leaks = leak_free(eng, "19b crash")
    log(f"19b crash (replica.executor:raise:4 in blocking serve): all {len(first)} requests "
        f"FAILED ({first[0].error!r}), the crash surfaced, a later submit refused with "
        f"ExecutorCrash; leaks={leaks}")
    close(torch, eng)


def serve_service(torch, eng, reqs):
    """start(); submit ``reqs`` from this thread; wait for every
    ``on_finish``; stop().  Returns (stats of the window, the prefill
    counter, the decode counter)."""
    done = threading.Semaphore(0)
    chunks = CallCounter(eng, "_prefill_paged")
    steps = CallCounter(eng, "_decode")
    base = eng.begin_window()
    t0 = time.monotonic()
    eng.start()
    try:
        for r in reqs:
            eng.submit(r, on_finish=lambda r: done.release())
        for r in reqs:
            if not done.acquire(timeout=300):
                raise AssertionError("service mode: a request never finished")
    finally:
        eng.stop()
    torch.cuda.synchronize()
    stats = eng.collect_window(base, reqs, time.monotonic() - t0)
    chunks.restore()
    steps.restore()
    return stats, chunks, steps


def service_phase(torch, np, cfg, params, baseline) -> dict:
    """Phase 19c: phase 4's engine and requests in service mode --
    ``start()``, the 8 requests submitted from the main thread, each
    ``on_finish`` waited for, ``stop()``.  Gated: all DONE; K1 / K2 / K7
    launches exact by body, every model call made on the executor thread;
    leak-free.  Then a crash in service mode: ``stop()`` raises
    ``ExecutorCrash`` once, a second ``stop()`` is silent, a later submit
    raises ``ExecutorCrash``, leak-free.  Printed beside phase 4's
    blocking run: TTFT, TPOT, tok/s, tokens.  Returns the launches."""
    from repro_torch.kernels import dispatch
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.faults import ExecutorCrash, FaultPlan
    from repro_torch.serving.sampler import greedy

    eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, prefill_chunk=256,
                        device="cuda")
    eng.serve([Request(100, np.arange(40, dtype=np.int32), max_new_tokens=4,
                       sampler=greedy())])          # warm-up, as phase 4's
    reqs = serving_requests(cfg, np, Request, greedy)
    dispatch.reset_counts()
    stats, chunks, steps = serve_service(torch, eng, reqs)
    bodies, plain = launched_bodies(dispatch.kernel_table())
    run = {"chunks": chunks.n, "total": {"decode_steps": stats.decode_steps}}
    want = want_bodies(cfg, run, "mma")
    threads = chunks.threads | steps.threads
    if bodies != want or plain or steps.n != stats.decode_steps:
        raise AssertionError(f"19c: launches by body {bodies}, expected {want}; plain calls "
                             f"{plain}; {steps.n} decode calls, {stats.decode_steps} steps")
    if not threads or threading.get_ident() in threads:
        raise AssertionError(f"19c: model calls on threads {threads}, the main thread is "
                             f"{threading.get_ident()}")
    bad = [r.rid for r in reqs if r.state.value != "done" or len(r.output) != 32]
    if bad:
        raise AssertionError(f"19c: requests {bad} did not finish")
    leaks = leak_free(eng, "19c")
    outputs = [list(r.output) for r in reqs]
    base = baseline["stats"]
    log(f"19c service mode: requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s {serving_summary(stats)}; every model call on the "
        f"executor thread ({len(threads)} thread, not the main one); launches by body "
        f"{bodies}; leaks={leaks}")
    log(f"19c: phase 4 (blocking serve, the same engine and requests) {serving_summary(base)}; "
        f"greedy tokens equal to phase 4's in "
        f"{sum(a == b for a, b in zip(outputs, baseline['outputs']))} of {len(reqs)} "
        f"requests (printed; gated at depth 2 in fp32)")
    # a crash in service mode
    eng.fault_plan = FaultPlan.parse("replica.executor:raise:2")
    crashed = serving_requests(cfg, np, Request, greedy)[:2]
    done = threading.Semaphore(0)
    for r in crashed:           # queued before the executor runs, so both are in
        eng.submit(r, on_finish=lambda r: done.release())   # when it dies
    eng.start()
    for r in crashed:
        if not done.acquire(timeout=120):
            raise AssertionError("19c crash: a request never reached a terminal state")
    raised = 0
    for _ in range(2):
        try:
            eng.stop()
        except ExecutorCrash:
            raised += 1
    try:
        eng.submit(serving_requests(cfg, np, Request, greedy)[2])
        refused = False
    except ExecutorCrash:
        refused = True
    if raised != 1 or not refused or any(r.state.value != "failed" for r in crashed):
        raise AssertionError(f"19c crash: stop() raised {raised} times, submit refused "
                             f"{refused}, states {[r.state.value for r in crashed]}")
    leaks = leak_free(eng, "19c crash")
    log(f"19c crash (replica.executor:raise:2 in service mode): both requests FAILED, stop() "
        f"raised ExecutorCrash once and was silent the second time, a later submit refused; "
        f"leaks={leaks}")
    close(torch, eng)
    return {n: sum(b.values()) for n, b in bodies.items()}


def tier_gate(torch, np) -> None:
    """Phase 19's gate at depth 2 in fp32 through the kernels (FMA bodies):
    19a's traffic tiered gives the untiered run's greedy tokens (and 19a's
    exact counters); under 19b's plan every DONE request gives the
    no-fault run's tokens; service mode gives blocking ``serve``'s tokens
    for phase 4's requests.  On a mismatch the first differing step and
    its logit margins are printed."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.sampler import greedy

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = arch_registry.config("qwen2.5-3b").replace(compute_dtype="float32", num_layers=2)
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    out = {}
    for label, host, plan in (("untiered", 0, None), ("tiered", TIER_HOST_BLOCKS, None),
                              ("faults", TIER_HOST_BLOCKS, FaultPlan.parse(FAULT_PLAN))):
        eng = tier_engine(ServingEngine, cfg, params, host, "float32", fault_plan=plan)
        waves = tier_waves(cfg, np, Request, greedy)
        stats = [eng.serve(w) for w in waves]
        leak_free(eng, f"19 gate {label}")
        reqs = [r for w in waves for r in w]
        out[label] = (reqs, stats)
        close(torch, eng)
    prompts = [r.prompt for r in out["untiered"][0]]
    toks = {k: [list(r.output) for r in reqs] for k, (reqs, _) in out.items()}
    if toks["tiered"] != toks["untiered"]:
        raise token_mismatch(torch, np, cfg, params, prompts, toks["untiered"], toks["tiered"],
                             "19 gate (19a)", "untiered", "tiered")
    tiered = out["tiered"][1]
    counts = (sum(s.kv_spills for s in tiered), sum(s.kv_fetches for s in tiered),
              sum(s.prefill_tokens_computed for s in tiered))
    if counts != (TIER_SPILLS, TIER_FETCHES, TIER_COMPUTED[True]):
        raise AssertionError(f"19 gate (19a): spills, fetches, computed {counts}")
    done = [i for i, r in enumerate(out["faults"][0]) if r.state.value == "done"]
    if [toks["faults"][i] for i in done] != [toks["untiered"][i] for i in done]:
        raise token_mismatch(torch, np, cfg, params, [prompts[i] for i in done],
                             [toks["untiered"][i] for i in done],
                             [toks["faults"][i] for i in done], "19 gate (19b)", "no-fault",
                             "faulted")
    # service mode against blocking serve, phase 4's requests
    blocking = serving_requests(cfg, np, Request, greedy)
    eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, prefill_chunk=256,
                        cache_dtype="float32", device="cuda")
    eng.serve(blocking)
    close(torch, eng)
    eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, prefill_chunk=256,
                        cache_dtype="float32", device="cuda")
    service = serving_requests(cfg, np, Request, greedy)
    serve_service(torch, eng, service)
    leak_free(eng, "19 gate (19c)")
    close(torch, eng)
    a, b = [list(r.output) for r in blocking], [list(r.output) for r in service]
    if a != b:
        raise token_mismatch(torch, np, cfg, params, [r.prompt for r in blocking], a, b,
                             "19 gate (19c)", "blocking", "service")
    log(f"19 gate (fp32, full width, depth 2): tiered greedy tokens equal to untiered "
        f"({sum(map(len, toks['tiered']))} tokens; spills {counts[0]}, fetches {counts[1]}, "
        f"computed {counts[2]} of {sum(s.prefill_tokens_total for s in tiered)}); under "
        f"the fault plan {len(done)} of {len(toks['faults'])} requests done, each with the "
        f"no-fault tokens; service mode equal to blocking serve ({sum(map(len, b))} tokens)")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The replica router, disaggregated prefill/decode and wave mode (phase 20)
# ---------------------------------------------------------------------------


def fleet_engines(ServingEngine, cfg, params, roles, cache_dtype="bfloat16", plan=None):
    """Phase 4's engine once per role, named ``replica{i}``, one fault plan
    shared by all (so a count in it counts across the fleet)."""
    return [ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, prefill_chunk=256,
                          cache_dtype=cache_dtype, name=f"replica{i}", role=role,
                          fault_plan=plan, device="cuda")
            for i, role in enumerate(roles)]


def warm(np, engines, Request, greedy) -> None:
    """One short blocking request on each engine (as phase 4's warm-up),
    before a router installs its hooks."""
    for eng in engines:
        eng.serve([Request(100, np.arange(40, dtype=np.int32), max_new_tokens=4,
                           sampler=greedy())])


def serve_fleet(torch, router, reqs) -> dict:
    """``router.serve(reqs)`` with the kernels' counts zeroed just before and
    read just after; each engine's prefill chunks and decode calls counted
    (with the threads that made them) and its stats window collected."""
    from repro_torch.kernels import dispatch

    engines = router.replicas
    counters = [(CallCounter(e, "_prefill_paged"), CallCounter(e, "_decode")) for e in engines]
    bases = [e.begin_window() for e in engines]
    dispatch.reset_counts()
    t0 = time.monotonic()
    stats = router.serve(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    bodies, plain = launched_bodies(dispatch.kernel_table())
    for chunks, steps in counters:
        chunks.restore()
        steps.restore()
    windows = [e.collect_window(b, [], wall) for e, b in zip(engines, bases)]
    return {"stats": stats, "bodies": bodies, "plain": plain, "wall": wall,
            "chunks": [c.n for c, _ in counters], "decodes": [d.n for _, d in counters],
            "threads": set().union(*(c.threads | d.threads for c, d in counters)),
            "windows": windows, "outputs": [list(r.output) for r in reqs]}


def fleet_bodies(cfg, run, mma) -> dict:
    """The launches by body a fleet run must show: K2 one a layer of each
    prefill chunk and K1 one a layer of each decode step, of every engine;
    K7 the blocks' products of every model call on wgmma, the LM head on
    FMA."""
    L = cfg.num_layers
    chunks, steps = sum(run["chunks"]), sum(w.decode_steps for w in run["windows"])
    want = {"matmul": {"wgmma": L * QWEN_PRODUCTS * (chunks + steps), "fma": chunks + steps}}
    if chunks:
        want["paged_prefill_attention"] = {mma: L * chunks}
    if steps:
        want["paged_decode_attention"] = {mma: L * steps}
    return want


def check_fleet(cfg, run, mma, tag) -> None:
    """Gates every fleet run shares: launches exact by body from the
    engines' own calls (each decode call a decode step), no plain call,
    every model call on an executor thread, every request DONE with 32
    tokens."""
    want = fleet_bodies(cfg, run, mma)
    steps = [w.decode_steps for w in run["windows"]]
    if run["bodies"] != want or run["plain"] or run["decodes"] != steps:
        raise AssertionError(f"{tag}: launches by body {run['bodies']}, expected {want}; plain "
                             f"calls {run['plain']}; decode calls {run['decodes']}, steps {steps}")
    if not run["threads"] or threading.get_ident() in run["threads"]:
        raise AssertionError(f"{tag}: model calls on threads {run['threads']}, the main "
                             f"thread is {threading.get_ident()}")
    bad = [i for i, o in enumerate(run["outputs"]) if len(o) != 32]
    states = set(run["states"])
    if bad or states != {"done"}:
        raise AssertionError(f"{tag}: requests {bad} did not finish ({states})")


def fleet_profile(torch, np, router, Request, greedy) -> str:
    """The device's busy share of a short fleet window (2 requests of 512
    tokens, 8 new), under torch.profiler: every kernel of both executors
    (one stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(20)
    reqs = [Request(300 + i, rng.integers(0, router.replicas[0].cfg.vocab_size, size=512)
                    .astype(np.int32), max_new_tokens=8, sampler=greedy()) for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        router.serve(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    return (f"profiled window (2 requests of 512 tokens, 8 new): wall={wall:.3f}s "
            f"device_busy={busy:.3f}s busy_share={busy / wall:.3f} "
            f"({sum(r[1] for r in rows)} kernel launches in the trace)")


def mixed_fleet_phase(torch, np, cfg, params, baseline) -> tuple:
    """Phase 20a: two phase-4 engines behind ``ReplicaRouter`` (affinity and
    stealing on) on phase 4's requests, then the same requests on one of
    the engines behind a one-replica router.  Gated: every request DONE, 256
    tokens delivered; ``FLEET_AFFINITY`` exactly; K1 / K2 / K7 launches
    exact by body from both engines' calls, no plain call, model calls on
    the two executor threads only; both pools leak-free.  Printed beside
    phase 4's and the one-replica router's: tok/s, TTFT, TPOT, steals,
    the busy share of a profiled window, peak memory; greedy tokens equal
    to phase 4's (not gated).
    Returns (the launches by kernel, the two engines)."""
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.router import ReplicaRouter
    from repro_torch.serving.sampler import greedy

    card, watts = card_name_and_power_limit()
    torch.cuda.reset_peak_memory_stats()
    engines = fleet_engines(ServingEngine, cfg, params, ("mixed", "mixed"))
    warm(np, engines, Request, greedy)
    router = ReplicaRouter(engines)
    reqs = serving_requests(cfg, np, Request, greedy)
    run = serve_fleet(torch, router, reqs)
    run["states"] = [r.state.value for r in reqs]
    check_fleet(cfg, run, "mma", "20a")
    stats = run["stats"]
    placed = {"affinity_hits": router.stats.affinity_hits,
              "affinity_blocks": router.stats.affinity_blocks}
    if placed != FLEET_AFFINITY or stats.tokens != 256 or len(run["threads"]) != 2:
        raise AssertionError(f"20a: placement {placed}, expected {FLEET_AFFINITY}; "
                             f"{stats.tokens} tokens delivered; model calls on "
                             f"{len(run['threads'])} threads")
    leaks = [leak_free(e, f"20a replica{i}") for i, e in enumerate(engines)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = fleet_profile(torch, np, router, Request, greedy)
    router.close()
    # the same requests on one of the engines behind a one-replica router:
    # service mode and the router's threads, but one executor thread
    alone = ReplicaRouter(engines[:1])
    one = alone.serve(serving_requests(cfg, np, Request, greedy))
    torch.cuda.synchronize()
    alone.close()
    base = baseline["stats"]
    w = run["windows"]
    log(f"20a mixed fleet (2 replicas on one card, affinity and stealing on): "
        f"requests={stats.requests} tokens={stats.tokens} wall={stats.wall_s:.3f}s "
        f"{serving_summary(stats)} tok/s/W={stats.tokens_per_s / watts:.4f} at power.limit "
        f"{watts:.0f} W for the card ({card}); steals={stats.router_steals} "
        f"affinity_hits={placed['affinity_hits']} affinity_blocks={placed['affinity_blocks']}; "
        f"per replica: prefill chunks {run['chunks']}, decode steps "
        f"{[x.decode_steps for x in w]}, prompt tokens computed "
        f"{[x.prefill_tokens_computed for x in w]} of {[x.prefill_tokens_total for x in w]}; "
        f"max_memory_allocated={peak:.2f}GiB (the fp32 weights, two bf16 cast copies, two "
        f"pools); leaks={leaks}")
    log(f"20a: launches by body {run['bodies']} from {len(run['threads'])} executor threads, "
        f"plain calls 0; {prof}")
    log(f"20a: one engine behind a one-replica router (one executor thread), the same "
        f"requests: {serving_summary(one)}; fleet / that tok/s "
        f"{stats.tokens_per_s / one.tokens_per_s:.3f}x")
    log(f"20a: phase 4 (one engine, blocking serve, the same requests) {serving_summary(base)}; "
        f"fleet / phase 4 tok/s {stats.tokens_per_s / base.tokens_per_s:.3f}x; greedy tokens "
        f"equal to phase 4's in {sum(a == b for a, b in zip(run['outputs'], baseline['outputs']))}"
        f" of {len(reqs)} requests (printed; gated at depth 2 in fp32)")
    return {n: sum(b.values()) for n, b in run["bodies"].items()}, engines


class HandoffRecorder:
    """Keeps the clones a prefill replica's handoffs take (the leaves the
    migration worker copies) by request, and the rows the decode replica
    landed for each adoption (gathered on its stream right after the
    write), to hold the two against each other after the run."""

    def __init__(self, pre, dec):
        self.clones: dict = {}
        self.landed: dict = {}
        self._pre, self._dec = pre, dec
        self._read, self._handoff = pre._read_block_slices, pre._handoff
        self._adopt = dec._adopt_slot
        self._taking = None
        pre._read_block_slices, pre._handoff = self.read, self.handoff
        dec._adopt_slot = self.adopt

    def read(self, bid):
        leaves = self._read(bid)
        if self._taking is not None:
            self._taking.append(leaves)
        return leaves

    def handoff(self, slot, job, req, last1):
        self._taking = self.clones.setdefault(req.rid, [])
        self._taking.clear()
        try:
            return self._handoff(slot, job, req, last1)
        finally:
            self._taking = None

    def adopt(self, slot, req, adoption):
        self._adopt(slot, req, adoption)
        n = len(adoption.blocks)
        ids = req.block_ids[:n]
        self.landed[req.rid] = {name: getattr(self._dec._state, name)[:, ids]
                                for name in adoption.blocks[0]}

    def restore(self) -> None:
        self._pre._read_block_slices, self._pre._handoff = self._read, self._handoff
        self._dec._adopt_slot = self._adopt

    def check(self, torch, tag) -> tuple[int, int]:
        """Every landed block equals bit for bit its handoff clone, leaf by
        leaf.  Returns (blocks held, bytes the clones hold)."""
        n = nbytes = 0
        if sorted(self.landed) != sorted(self.clones):
            raise AssertionError(f"{tag}: adopted {sorted(self.landed)}, handed off "
                                 f"{sorted(self.clones)}")
        for rid, clones in self.clones.items():
            for i, want in enumerate(clones):
                for name, t in want.items():
                    if not torch.equal(bits(torch, self.landed[rid][name][:, i]),
                                       bits(torch, t)):
                        raise AssertionError(f"{tag}: request {rid}: adopted block {i}'s "
                                             f"{name} differs from its handoff clone")
                    nbytes += t.numel() * t.element_size()
                n += 1
        return n, nbytes


def disagg_phase(torch, np, cfg, params) -> tuple:
    """Phase 20b: a ``prefill,decode`` fleet of phase-4 engines on phase 4's
    requests, on a bf16 pool and again on an int8 pool.  Gated: 8
    migrations of ``FLEET_MIGRATED_BLOCKS`` blocks and their bytes
    (``TIER_BLOCK_BYTES`` a block); the decode replica computes no prompt
    token and makes no prefill chunk, the prefill replica makes no decode
    step; K1 (``mma`` / ``mma_i8``) 36 a decode step of the decode
    replica, K2 36 a prefill chunk of the prefill replica, K7 by body;
    every adopted block bit for bit its handoff clone (int8 with both
    scales); after ``drain_migrations`` both pools leak-free (no export
    pin left).  Printed: the migration worker's device-to-host ms a block,
    the adopting executor's host ms an adoption, TTFT (the first token at
    handoff), TPOT.  Returns (launches by kernel, the bf16 fleet's
    engines)."""
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.router import ReplicaRouter
    from repro_torch.serving.sampler import greedy

    card, watts = card_name_and_power_limit()
    launches, keep = {}, None
    for cache_dtype in ("bfloat16", "int8"):
        int8 = cache_dtype == "int8"
        tag = f"20b disaggregated {'int8' if int8 else 'bf16'}"
        engines = fleet_engines(ServingEngine, cfg, params, ("prefill", "decode"), cache_dtype)
        pre, dec = engines
        warm(np, engines, Request, greedy)
        router = ReplicaRouter(engines)
        rec = HandoffRecorder(pre, dec)
        reqs = serving_requests(cfg, np, Request, greedy)
        run = serve_fleet(torch, router, reqs)
        rec.restore()
        run["states"] = [r.state.value for r in reqs]
        check_fleet(cfg, run, "mma_i8" if int8 else "mma", tag)
        wp, wd = run["windows"]
        blocks, nbytes = rec.check(torch, tag)
        target = router._mig_io.targets[0]
        got = {"kv_migrations": wd.kv_migrations, "migrated_blocks": wd.migrated_blocks,
               "migrated_bytes": nbytes, "held_blocks": blocks, "worker_blocks": target.copies,
               "decode_computed": wd.prefill_tokens_computed, "decode_chunks": run["chunks"][1],
               "prefill_decode_steps": wp.decode_steps,
               "migrations": router.stats.migrations,
               "migration_failures": router.stats.migration_failures}
        expect = {"kv_migrations": 8, "migrated_blocks": FLEET_MIGRATED_BLOCKS,
                  "migrated_bytes": FLEET_MIGRATED_BLOCKS * TIER_BLOCK_BYTES[cache_dtype],
                  "held_blocks": FLEET_MIGRATED_BLOCKS, "worker_blocks": FLEET_MIGRATED_BLOCKS,
                  "decode_computed": 0, "decode_chunks": 0, "prefill_decode_steps": 0,
                  "migrations": 8, "migration_failures": 0}
        if got != expect:
            raise AssertionError(f"{tag}: {got}, expected {expect}")
        leaks = [leak_free(e, f"{tag} {e.role}") for e in engines]
        stats = run["stats"]
        log(f"{tag}: requests={stats.requests} tokens={stats.tokens} wall={stats.wall_s:.3f}s "
            f"{serving_summary(stats)} tok/s/W={stats.tokens_per_s / watts:.4f} at power.limit "
            f"{watts:.0f} W for the card ({card}); migrations={wd.kv_migrations} "
            f"migrated_blocks={wd.migrated_blocks} migrated_bytes={nbytes} "
            f"({nbytes // blocks} B a block); prefill replica: {run['chunks'][0]} chunks, "
            f"{wp.prefill_tokens_computed} of {wp.prefill_tokens_total} prompt tokens computed; "
            f"decode replica: {wd.decode_steps} decode steps, 0 prompt tokens computed; "
            f"{blocks} adopted blocks equal bit for bit to their handoff clones; migration "
            f"worker {target.copy_s / target.copies * 1e3:.4f} ms a block device to host "
            f"(stream wait included); adopting executor {dec.adopt_commit_s / 8 * 1e3:.3f} ms "
            f"of host an adoption (one batched host-to-device write, {blocks / 8:.1f} blocks "
            f"on average); launches by body {run['bodies']}; leaks={leaks}")
        key = ":int8" if int8 else ""
        for name, b in run["bodies"].items():
            k = name if name == "matmul" else f"{name}{key}"
            launches[k] = launches.get(k, 0) + sum(b.values())
        if int8:
            router.close()
            close(torch, *engines)
            del engines, pre, dec, rec
        else:
            router.close()
            keep = engines
            del rec
    return launches, keep


def fleet_fault_phase(torch, np, cfg, mixed, disagg) -> dict:
    """Phase 20c, on 20a's and 20b's bf16 engines.  The mixed fleet under
    ``FLEET_CRASH`` (one plan, shared) with ``max_retries=2``: one replica
    DEAD, ``replica_failures == 1``, no request FAILED, at least one
    retried, every request DONE, the survivor's pool leak-free.  The
    disaggregated fleet under ``FLEET_DROP``: one migration failure, that
    request (request 1, the second handoff) retried once from its bare
    prompt on the decode replica and DONE there, 7 adoptions, both pools
    leak-free.  Launches exact by body in both.
    Returns the launches."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.router import ReplicaHealth, ReplicaRouter
    from repro_torch.serving.sampler import greedy

    launches = {}
    plan = FaultPlan.parse(FLEET_CRASH)
    for e in mixed:
        e.fault_plan = plan
    router = ReplicaRouter(mixed, max_retries=2)
    reqs = serving_requests(cfg, np, Request, greedy)
    run = serve_fleet(torch, router, reqs)
    run["states"] = [r.state.value for r in reqs]
    health = router.health()
    router.close()
    stats = run["stats"]
    dead = [i for i, h in enumerate(health) if h is ReplicaHealth.DEAD]
    got = (stats.replica_failures, len(dead), stats.requests_failed, plan.fired)
    if got != (1, 1, 0, 1) or stats.requests_retried < 1:
        raise AssertionError(f"20c crash: replica_failures, dead, requests_failed, fired {got}; "
                             f"retried {stats.requests_retried}")
    check_fleet(cfg, run, "mma", "20c crash")
    survivor = mixed[1 - dead[0]]
    leaks = leak_free(survivor, "20c crash survivor")
    log(f"20c crash ({FLEET_CRASH}, max_retries=2): replica{dead[0]} DEAD ({health}), "
        f"replica_failures={stats.replica_failures} requests_failed={stats.requests_failed} "
        f"requests_retried={stats.requests_retried}; all {len(reqs)} requests DONE with 32 "
        f"tokens; {serving_summary(stats)}; the survivor's pool leaks={leaks}, the dead "
        f"replica's {mixed[dead[0]].pool.leak_report()}; launches by body {run['bodies']}")
    for name, b in run["bodies"].items():
        launches[name] = launches.get(name, 0) + sum(b.values())
    plan = FaultPlan.parse(FLEET_DROP)
    for e in disagg:
        e.fault_plan = plan
    router = ReplicaRouter(disagg, max_retries=2)
    reqs = serving_requests(cfg, np, Request, greedy)
    run = serve_fleet(torch, router, reqs)
    run["states"] = [r.state.value for r in reqs]
    failures = router.stats.migration_failures
    router.close()
    stats = run["stats"]
    wd = run["windows"][1]
    got = (failures, stats.requests_retried, stats.requests_failed, wd.kv_migrations,
           wd.prefill_tokens_computed, plan.fired)
    # the second handoff is request 1's (300 tokens; the prefill replica
    # finishes prompts in arrival order); its failure is charged to the
    # prefill replica, so the retry prefers the other one, the decode
    # replica, which serves it whole (roles are policy, as the reference's)
    if got != (1, 1, 0, 7, 300, 1):
        raise AssertionError(f"20c drop: migration_failures, retried, failed, adoptions, decode "
                             f"replica's computed tokens, fired {got}")
    check_fleet(cfg, run, "mma", "20c drop")
    leaks = [leak_free(e, f"20c drop {e.role}") for e in disagg]
    log(f"20c drop ({FLEET_DROP}): migration_failures={failures}, the request retried from "
        f"its bare prompt once (on the decode replica, which computed its "
        f"{wd.prefill_tokens_computed} prompt tokens) and DONE; {wd.kv_migrations} adoptions "
        f"of {wd.migrated_blocks} blocks; prefill replica computed "
        f"{run['windows'][0].prefill_tokens_computed} prompt tokens; {serving_summary(stats)}; "
        f"leaks={leaks}; launches by body {run['bodies']}")
    for name, b in run["bodies"].items():
        launches[name] = launches.get(name, 0) + sum(b.values())
    return launches


def wave_requests(cfg, np, Request, greedy):
    rng = np.random.default_rng(20)
    return [Request(i, rng.integers(0, cfg.vocab_size, WAVE_PROMPT).astype(np.int32),
                    max_new_tokens=WAVE_NEW, sampler=greedy()) for i in range(WAVE_REQUESTS)]


def wave_phase(torch, np, cfg, params, contiguous) -> dict:
    """Phase 20d: ``serve_wave`` on one phase-4 engine, 8 requests of 512
    tokens in 2 waves of 4, 32 new each.  Gated: 2 prefills and 62 decode
    steps; K4 36 a wave (72), K3 36 a decode step (2232), all ``mma``; K7
    by body; no K1 / K2 launch and no plain call.  Printed: TTFT, TPOT
    beside phase 17's (``contiguous``: contiguous continuous batching of
    phase 4's requests).  Returns the launches."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    card, watts = card_name_and_power_limit()
    eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, prefill_chunk=256,
                        device="cuda")
    reqs = wave_requests(cfg, np, Request, greedy)
    dispatch.reset_counts()
    stats = eng.serve_wave(reqs)
    torch.cuda.synchronize()
    bodies, plain = launched_bodies(dispatch.kernel_table())
    L, calls = cfg.num_layers, stats.prefills + stats.decode_steps
    waves = WAVE_REQUESTS // 4
    want = {"flash_attention": {"mma": L * waves},
            "decode_attention": {"mma": L * waves * (WAVE_NEW - 1)},
            "matmul": {"wgmma": L * QWEN_PRODUCTS * calls, "fma": calls}}
    if (stats.prefills, stats.decode_steps) != (waves, waves * (WAVE_NEW - 1)) \
            or bodies != want or plain:
        raise AssertionError(f"20d: prefills {stats.prefills}, decode steps "
                             f"{stats.decode_steps}; launches by body {bodies}, expected "
                             f"{want}; plain calls {plain}")
    if any(r.state.value != "done" or len(r.output) != WAVE_NEW for r in reqs):
        raise AssertionError("20d: a request did not finish")
    log(f"20d wave mode ({WAVE_REQUESTS} requests of {WAVE_PROMPT} tokens, {waves} waves of "
        f"4, {WAVE_NEW} new): requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s {serving_summary(stats)} "
        f"occupancy={stats.slot_occupancy:.2f} tok/s/W={stats.tokens_per_s / watts:.4f} at "
        f"power.limit {watts:.0f} W ({card}); launches by body {bodies}, no K1 / K2")
    log(f"20d: phase 17 (contiguous continuous batching, phase 4's requests) "
        f"{serving_summary(contiguous)}")
    close(torch, eng)
    return {n: sum(b.values()) for n, b in bodies.items()}


def fleet_gate(torch, np) -> None:
    """Phase 20's gate at depth 2 in fp32 through the kernels (FMA bodies):
    the greedy tokens of the mixed fleet, the disaggregated fleet on an
    fp32 and an int8 pool, every request of both fault runs (the retried
    ones included) and wave mode each equal a blocking single-engine
    ``serve`` of the same requests: phase 4's engine on the same pool for
    the fleets; for the waves, which keep their caches in bf16 whatever
    ``cache_dtype`` says, the contiguous engine on bf16 caches.  On a
    mismatch the first differing step and its logit margins are
    printed."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.router import ReplicaRouter
    from repro_torch.serving.sampler import greedy

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = arch_registry.config("qwen2.5-3b").replace(compute_dtype="float32", num_layers=2)
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    prompts = [r.prompt for r in serving_requests(cfg, np, Request, greedy)]

    def single(cache_dtype, reqs=None, paged=True):
        reqs = reqs or serving_requests(cfg, np, Request, greedy)
        eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, paged=paged,
                            prefill_chunk=256 if paged else None, cache_dtype=cache_dtype,
                            device="cuda")
        eng.serve(reqs)
        if paged:
            leak_free(eng, f"20 gate single engine {cache_dtype}")
        close(torch, eng)
        return [list(r.output) for r in reqs]

    def fleet(label, roles, cache_dtype, plan=None):
        engines = fleet_engines(ServingEngine, cfg, params, roles, cache_dtype, plan)
        router = ReplicaRouter(engines, max_retries=2)
        reqs = serving_requests(cfg, np, Request, greedy)
        stats = router.serve(reqs)
        router.close()
        if any(r.state.value != "done" for r in reqs):
            raise AssertionError(f"20 gate ({label}): states {[r.state.value for r in reqs]}")
        for e, role in zip(engines, roles):
            if not (plan is not None and e.failure is not None):
                leak_free(e, f"20 gate ({label}) {role}")
        close(torch, *engines)
        return [list(r.output) for r in reqs], stats

    want = {"float32": single("float32"), "int8": single("int8")}
    runs = {"mixed fleet": (("mixed", "mixed"), "float32", None),
            "disaggregated fp32": (("prefill", "decode"), "float32", None),
            "disaggregated int8": (("prefill", "decode"), "int8", None),
            "crash": (("mixed", "mixed"), "float32", FLEET_CRASH),
            "migration drop": (("prefill", "decode"), "float32", FLEET_DROP)}
    retried = 0
    for label, (roles, cache_dtype, plan) in runs.items():
        got, stats = fleet(label, roles, cache_dtype, plan and FaultPlan.parse(plan))
        retried += stats.requests_retried if plan else 0
        if got != want[cache_dtype]:
            raise token_mismatch(torch, np, cfg, params, prompts, want[cache_dtype], got,
                                 f"20 gate ({label})", "single engine", label)
    # wave mode against the contiguous engine on bf16 caches
    wave = wave_requests(cfg, np, Request, greedy)
    eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, prefill_chunk=256,
                        cache_dtype="float32", device="cuda")
    eng.serve_wave(wave)
    close(torch, eng)
    got = [list(r.output) for r in wave]
    ref = single("bfloat16", wave_requests(cfg, np, Request, greedy), paged=False)
    if got != ref:
        raise token_mismatch(torch, np, cfg, params, [r.prompt for r in wave], ref, got,
                             "20 gate (wave)", "contiguous", "wave")
    log(f"20 gate (fp32, full width, depth 2): the mixed fleet, the disaggregated fleet on "
        f"fp32 and int8 pools, the crash ({FLEET_CRASH}) and migration drop ({FLEET_DROP}) "
        f"runs ({retried} requests retried) each gave the single engine's greedy tokens for "
        f"phase 4's {len(prompts)} requests ({sum(map(len, want['float32']))} tokens); wave "
        f"mode gave the contiguous engine's on bf16 caches ({sum(map(len, got))} tokens)")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# zamba2-1.2b training, and the two backward kernels (phase 21)
# ---------------------------------------------------------------------------


def attention_grad_case(torch, B, S, H, K, D, dtype, seed=0):
    """q, k, v as ``dense_case`` makes them, K4's output and log-sum-exp on
    them, and a random output gradient."""
    q, k, v = dense_case(torch, S, dtype, B=B, H=H, K=K, D=D, seed=seed)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    do = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    return q, k, v, do


def attention_backward_work(B, S, H, K, D, elem) -> tuple[float, float, float]:
    """(bytes, flops, the FMA body's flops) of K4's causal backward: q, out,
    dout and dq (B, S, H, D), k, v, dk and dv (B, S, K, D) once each, the
    fp32 lse; the least work is five products over the causal half (S
    recomputed, dV, dP, dQ, dK), the FMA body does seven (S and dP in each
    of its two passes)."""
    pairs = B * S * (S + 1) // 2 * H * D
    return elem * (4 * B * S * H * D + 4 * B * S * K * D) + 4 * B * H * S, 10 * pairs, 14 * pairs


def attention_backward_phase(torch, table) -> dict:
    """Phase 21a: K4 with its log-sum-exp, then its backward kernel, each
    against its plain version evaluated in fp32 on the same values, on
    ``K4_BWD_CASES``; then the backward timed at qwen2.5-3b's training
    shape beside its plain version, SDPA's backward (autograd of
    ``scaled_dot_product_attention`` on the same tensors, measured only)
    and its bound, and at zamba2's shared block's, printed."""
    import torch.nn.functional as F
    from repro_torch.kernels.dispatch import GRAD_RTOL
    fwd, bwd = table["flash_attention"], table["flash_attention_backward"]
    timer = Timer(torch)
    errs = {}
    for B, S, H, K, D, dt in K4_BWD_CASES:
        dtype = getattr(torch, dt)
        q, k, v, do = attention_grad_case(torch, B, S, H, K, D, dtype)
        out, lse = fwd.launch(q, k, v, causal=True, with_lse=True)
        ref_lse = fwd.plain(q.float(), k.float(), v.float(), causal=True, with_lse=True)[1]
        same = torch.equal(out, fwd.launch(q, k, v, causal=True))
        lse_rel = ((lse - ref_lse).abs().max() / ref_lse.abs().max().clamp(min=1.0)).item()
        label = (f"B={B} S={S} H={H} K={K} D={D} causal (limit {GRAD_RTOL[dtype]:.2e} of "
                 f"each gradient's max|ref|)")
        log(f"flash_attention {label} {dt}: the output with lse equals the one without: "
            f"{same}; lse vs plain rel={lse_rel:.3e} (tol 1e-5)")
        if not (same and lse_rel <= 1e-5):
            raise AssertionError(f"flash_attention {label}: lse or output off")
        errs.setdefault(dtype, []).append(
            hold(torch, bwd, (q, k, v, out, do, lse), label, causal=True))
    out_r = {}
    for (B, S, H, K, D), key in (((1, TRAIN_SEQ, 16, 2, 128), "qwen"),
                                 ((1, TRAIN_SEQ, 32, 32, 64), "zamba2")):
        q, k, v, do = attention_grad_case(torch, B, S, H, K, D, torch.bfloat16)
        out, lse = fwd.launch(q, k, v, causal=True, with_lse=True)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        y = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=H != K)
        dyh = do.transpose(1, 2).contiguous()
        nbytes, flops, fma_flops = attention_backward_work(B, S, H, K, D, 2)
        r = dict(ms=timer(lambda: bwd.launch(q, k, v, out, do, lse, causal=True)),
                 plain_ms=timer(lambda: bwd.plain(q, k, v, out, do, lse, causal=True)),
                 library_ms=timer(lambda: torch.autograd.grad(y, (qh, kh, vh), dyh,
                                                              retain_graph=True)),
                 bytes=nbytes, flops=flops,
                 fp32_rate_bound_ms=bound(nbytes, fma_flops, FP32_FLOPS)[0],
                 shape=f"B={B} S={S} H={H} K={K} D={D} causal bf16 body=fma")
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
        log(f"flash_attention_backward timed {r['shape']}: kernel {r['ms']:.4f}ms plain "
            f"{r['plain_ms']:.4f}ms SDPA backward {r['library_ms']:.4f}ms (kernel / SDPA "
            f"{r['ms'] / r['library_ms']:.2f}) bound {r['bound_ms']:.5f}ms ({r['bound_by']}; "
            f"{nbytes} B, {flops} flop; the FMA body's own at 67 TFLOP/s fp32 "
            f"{r['fp32_rate_bound_ms']:.4f}ms)")
        out_r[key] = r
        del y, qh, kh, vh
    r = out_r["qwen"]
    r["max_abs_err"] = max(errs[torch.bfloat16])
    r["max_abs_err_fp32"] = max(errs[torch.float32])
    return {"flash_attention_backward": r}


def scan_backward_work(S, *, B=1, H=64, N=64, P=64, chunk=128, elem=2) -> tuple:
    """(bytes, flops) of K5's backward: q and k's shared (B, S, N) base, v,
    the decay, gate and dy read once; dq, dk (B, S, H, N), dv, the decay's
    and gate's gradients written once.  Per chunk of n live rows, the least
    products: the causal q.k and dy.v recomputed, dA K, dA^T Q and (QK^T
    o W)^T dY (n(n+1)/2 terms of N or P each), and the chunk sums S_c, U_c,
    H_{c-1} dy, G_c v and G_c^T k (n N P each); two flops a multiply-add."""
    nbytes = elem * (2 * B * S * N + 2 * B * S * H * N + 2 * B * S * H * P) + 4 * (
        4 * B * S * H + B * S * H * P)
    flops = 0
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        flops += 2 * B * H * (n * (n + 1) // 2 * (3 * N + 2 * P) + 5 * n * N * P)
    return nbytes, flops


def scan_backward_phase(torch, table) -> dict:
    """Phase 21b: K5's backward against its plain version evaluated in fp32
    on the same values, on ``K5_BWD_CASES`` (B and C as stride-0 head
    views), then timed at zamba2-1.2b's training shape beside its plain
    version and its bound (no library call computes it)."""
    from repro_torch.kernels.dispatch import GRAD_RTOL
    bwd = table["ssm_scan_backward"]
    timer = Timer(torch)
    errs = {}
    for S, dt, with_state in K5_BWD_CASES:
        dtype = getattr(torch, dt)
        args, h0 = ssm_case(torch, S, dtype, with_state=with_state)
        g = torch.Generator("cuda").manual_seed(S + 7)
        dy = torch.randn((1, S, 64, 64), generator=g, device="cuda")
        df = torch.randn((1, 64, 64, 64), generator=g, device="cuda") if with_state else None
        label = (f"B=1 S={S} H=64 N=P=64 chunk 128 shared B/C h0/d_final={with_state} "
                 f"(limit {GRAD_RTOL[dtype]:.2e} of each gradient's max|ref|, fp32 "
                 f"gradients {GRAD_RTOL[torch.float32]:.2e})")
        errs.setdefault(dtype, []).append(
            hold(torch, bwd, (*args, dy, df), label, chunk=128, initial_state=h0))
    args, _ = ssm_case(torch, TRAIN_SEQ, torch.bfloat16)
    dy = torch.randn((1, TRAIN_SEQ, 64, 64), device="cuda")
    nbytes, flops = scan_backward_work(TRAIN_SEQ)
    r = dict(ms=timer(lambda: bwd.launch(*args, dy, chunk=128)),
             plain_ms=timer(lambda: bwd.plain(*args, dy, chunk=128)), library_ms=None,
             bytes=nbytes, flops=flops,
             shape=f"B=1 S={TRAIN_SEQ} H=64 N=P=64 chunk 128, bf16 q/k/v (B and C "
                   f"stride-0 head views), fp32 dy, body=fma (one Mamba layer)")
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
    r["fp32_rate_bound_ms"] = bound(nbytes, flops, FP32_FLOPS)[0]
    log(f"ssm_scan_backward timed {r['shape']}: kernel {r['ms']:.4f}ms plain "
        f"{r['plain_ms']:.4f}ms bound {r['bound_ms']:.5f}ms ({r['bound_by']}; {nbytes} B, "
        f"{flops} flop; at 67 TFLOP/s fp32 {r['fp32_rate_bound_ms']:.4f}ms)")
    r["max_abs_err"] = max(errs[torch.bfloat16])
    r["max_abs_err_fp32"] = max(errs[torch.float32])
    return {"ssm_scan_backward": r}


def zamba_counts(cfg, micro: int) -> dict:
    """Launches by body of ``micro`` microbatches of zamba2 training under
    remat "full", from the config: K5 once a Mamba layer and again in the
    recompute of each checkpointed segment (the tail is not checkpointed),
    K4 once a shared-block application and again in its recompute, each
    backward once; K7 for every weight product, again in the recompute and
    twice in the backward (dX, dW).  bf16 compute puts K5 and K4 on their
    tensor-core bodies and every block product on wgmma, the fp32 LM head
    (forward, dX, dW) on FMA; fp32 compute puts everything on FMA."""
    from repro_torch.models.hybrid import _segments
    n_seg, e, tail = _segments(cfg)
    layers = n_seg * e + tail
    fwd = MAMBA_PRODUCTS * layers + SHARED_PRODUCTS * n_seg + 1
    again = MAMBA_PRODUCTS * n_seg * e + SHARED_PRODUCTS * n_seg
    products = fwd + again + 2 * fwd
    bf16 = cfg.compute_dtype == "bfloat16"
    tc = "mma" if bf16 else "fma"
    return {"ssm_scan": {tc: (layers + n_seg * e) * micro},
            "ssm_scan_backward": {"fma": layers * micro},
            "flash_attention": {tc: 2 * n_seg * micro},
            "flash_attention_backward": {"fma": n_seg * micro},
            "matmul": ({"wgmma": (products - 3) * micro, "fma": 3 * micro} if bf16
                       else {"fma": products * micro})}


def hybrid_train_path_check(torch, np) -> None:
    """Phase 21c: zamba2-1.2b at full width cut to ``ZAMBA_CHECK_LAYERS``
    layers (one segment of 6 Mamba-2 layers and the shared block, a 1-layer
    tail), fp32 compute, remat "full", one 1 x 512 microbatch: the loss and
    every gradient leaf through the kernels (K5, K4, their backward kernels,
    K7), through the plain versions, and with every weight product summed
    in fp64 and rounded once -- phase 14's three-way gate and limits.  The
    kernel run's launches are held exactly, with no plain call."""
    from unittest import mock

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.models.layers import linear
    from repro_torch.models.registry import fns_for
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = arch_registry.config("zamba2-1.2b").replace(compute_dtype="float32",
                                                       num_layers=ZAMBA_CHECK_LAYERS)
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in next(SyntheticTokens(cfg, 1, TRAIN_SEQ, seed=5)).items()}
    ps = leaves(params)

    def loss_and_grads():
        for p in ps:
            p.grad = None
            p.requires_grad_(True)
        loss, _ = make_loss_fn(cfg)(params, batch)
        loss.backward()
        out = (loss.item(), [p.grad for p in ps])
        for p in ps:
            p.grad = None
            p.requires_grad_(False)
        return out

    dispatch.reset_counts()
    kern_loss, kern_g = loss_and_grads()
    table = dispatch.kernel_table()
    got = {n: dict(table[n].body_launches) for n in zamba_counts(cfg, 1)}
    plain_calls = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
    with dispatch.plain_versions():
        plain_loss, plain_g = loss_and_grads()
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
    log(f"zamba2 training path check (fp32, full width, {cfg.num_layers} layers, 1 x "
        f"{TRAIN_SEQ} tokens): loss kernels {kern_loss:.6f} plain {plain_loss:.6f} exact "
        f"products {exact_loss:.6f}, kernels vs plain rel={r_loss:.3e} (tol "
        f"{TOL_TRAIN_LOSS_REL}); worst gradient leaf of {len(ps)}: kernels vs plain "
        f"rel={max(r_grad):.3e} (tol {TOL_TRAIN_GRAD_REL}), vs exact products kernels "
        f"{max(k_exact):.3e} plain {max(p_exact):.3e}, worst ratio {ratio:.3f} (tol "
        f"{TOL_TRAIN_EXACT_RATIO}); launches by body {got}; plain calls {plain_calls or 0}")
    if got != zamba_counts(cfg, 1) or plain_calls:
        raise AssertionError(f"zamba2 training path check: launches {got}, expected "
                             f"{zamba_counts(cfg, 1)}; plain calls {plain_calls}")
    finite = all(bool(torch.isfinite(g).all()) for g in kern_g)
    if not (finite and r_loss <= TOL_TRAIN_LOSS_REL and max(r_grad) <= TOL_TRAIN_GRAD_REL
            and ratio <= TOL_TRAIN_EXACT_RATIO):
        raise AssertionError(f"zamba2 training path check: kernels and plain versions "
                             f"disagree (loss {r_loss}, gradients {max(r_grad)}, ratio "
                             f"{ratio}, finite {finite})")
    del params, ps, kern_g, plain_g, exact_g, batch
    gc.collect()
    torch.cuda.empty_cache()


def hybrid_training_phase(torch, np, table) -> dict:
    """Phase 21d: zamba2-1.2b at full width (38 layers: 6 segments and a
    2-layer tail; fp32 master weights, bf16 compute, remat "full", AdamW)
    trained for ``ZAMBA_TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` tokens in the config's 8 microbatches through
    ``python -m repro_torch.launch.train``'s entry point.  Every loss
    finite; K5, K4, their backward kernels and K7 launch exactly the counts
    ``zamba_counts`` derives, by body; no plain call.  Step time, tokens/s,
    tokens/s/W against the power limit, peak memory; then one more step
    under the profiler: device time by kernel and the busy share.  Returns
    the launches by kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.optim.optimizers import leaves

    name, watts = card_name_and_power_limit()
    cfg = arch_registry.config("zamba2-1.2b")
    accum = cfg.accum_steps
    want = zamba_counts(cfg, accum * ZAMBA_TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as d:
        args = train_launcher.parse(
            ["--arch", "zamba2-1.2b", "--steps", str(ZAMBA_TRAIN_STEPS), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--accum", str(accum),
             "--ckpt-dir", d])
        dispatch.reset_counts()
        t0 = time.monotonic()
        out = train_launcher.run(args)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        got = {n: dict(table[n].body_launches) for n in want}
        plain = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
    s = out["summary"]
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    state_bytes = 4 * 4 * sum(p.numel() for p in leaves(out["trainer"].params))
    log(f"zamba2 training: L={cfg.num_layers} d_model={cfg.d_model} vocab={cfg.vocab_size} "
        f"params={state_bytes / 16 / 1e9:.3f}B fp32 master weights, bf16 compute, "
        f"remat={cfg.remat}, adamw; {ZAMBA_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens in {accum} microbatches; wall {wall:.1f}s (init included)")
    log(f"zamba2 training: losses={[round(v, 4) for v in losses]} "
        f"first_step={s['first_step_s']:.3f}s step={s['step_s']:.3f}s "
        f"tokens/s={s['tokens_per_s']:.1f} tokens/s/W={s['tokens_per_s'] / watts:.4f} at "
        f"power.limit {watts:.0f} W ({name}) max_memory_allocated="
        f"{s['peak_memory_bytes'] / 2**30:.2f}GiB (params+grads+adamw state "
        f"{state_bytes / 2**30:.2f}GiB)")
    log(f"zamba2 training: launches by body {got} (expected {want}); plain_calls="
        f"{plain or 0}")
    if len(losses) != ZAMBA_TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"zamba2 training: losses {losses}")
    if got != want or plain:
        raise AssertionError(f"zamba2 training: launches {got}, expected {want}; plain "
                             f"calls {plain}")
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
        raise AssertionError("zamba2 training profile: the profiler saw no device time")
    by = {"K7 matmul": ("matmul_wgmma_kernel", "matmul_kernel"),
          "K5 ssm_scan": ("ssd_", "ssm_scan_kernel"), "K5 backward": ("ssm_bwd_",),
          "K4 flash_attention": ("flash",), "K4 backward": ("fa_bwd_",)}
    parts = {k: sum(r[0] for r in rows if any(n in r[2] for n in v)) / 1e3
             for k, v in by.items()}
    log(f"zamba2 training profile (one step, {accum} microbatches): wall={wall:.3f}s "
        f"device_busy={busy:.3f}s busy_share={busy / wall:.3f} idle_share="
        f"{1 - busy / wall:.3f}; " + ", ".join(f"{k} {v:.3f}s ({v / busy:.3f} of device "
                                               f"time)" for k, v in parts.items()))
    for ms, count, key in rows[:16]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {key[:90]}")
    del out, tr
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(c.values()) for n, c in got.items()}


# ---------------------------------------------------------------------------
# GoogLeNet training and remat "dots" (phase 22)
# ---------------------------------------------------------------------------


def conv_grad_out(torch, x_shape, w_shape, stride, dtype, seed=1):
    """A random output gradient (B, Hout, Wout, Cout) for a conv case."""
    g = torch.Generator("cuda").manual_seed(seed)
    B, H, W, _ = x_shape
    shape = (B, -(-H // stride), -(-W // stride), w_shape[3])
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def conv_backward_work(x_shape, w_shape, stride, need_dx, elem) -> tuple[float, float]:
    """(bytes, flops) of K6's backward: x, w and dy read once, dw, db (fp32)
    and, with ``need_dx``, dx written once; each of dgrad and wgrad does the
    forward's multiply-adds, and db one add an output element."""
    B, H, W, Cin = x_shape
    KH, KW, _, Cout = w_shape
    M = B * -(-H // stride) * -(-W // stride)
    macs = M * KH * KW * Cin * Cout
    nbytes = elem * (B * H * W * Cin * (2 if need_dx else 1) + 2 * KH * KW * Cin * Cout
                     + M * Cout) + 4 * Cout
    return nbytes, 2.0 * macs * (2 if need_dx else 1) + M * Cout


def library_conv_backward(torch, F, x, w, b, dy, stride, need_dx):
    """Autograd of one ``F.conv2d`` call (cuDNN, NCHW, TF32 off) on the same
    values: the gradients of the inputs the training path asks for, from
    the retained graph.  Where SAME pads asymmetrically (stem1) the map is
    padded first and the call pads nothing."""
    from repro_torch.kernels.conv2d.ref import same_padding
    (pt, pb), (pl, pr) = (same_padding(x.shape[1], w.shape[0], stride),
                          same_padding(x.shape[2], w.shape[1], stride))
    xc = x.permute(0, 3, 1, 2).contiguous()
    if (pt, pl) != (pb, pr):
        xc = F.pad(xc, (pl, pr, pt, pb))
        pt = pl = 0
    xc = xc.detach().requires_grad_(need_dx)
    wc = w.permute(3, 2, 0, 1).contiguous().requires_grad_(True)     # OIHW
    bc = b.clone().requires_grad_(True)
    y = F.conv2d(xc, wc, bc, stride=stride, padding=(pt, pl))
    dyc = dy.permute(0, 3, 1, 2).contiguous()
    inputs = (xc, wc, bc) if need_dx else (wc, bc)
    return lambda: torch.autograd.grad(y, inputs, dyc, retain_graph=True)


def conv_backward_phase(torch, table) -> dict:
    """Phase 22a: K6's backward against its plain version evaluated in fp32
    on the same values (``dispatch.grad_tolerance_ratio``) on every distinct
    conv shape of GoogLeNet's batch-8 forward at 224 and on
    ``CONV_BWD_EXTRA``, at fp32 and fp16; a case whose dgrad or wgrad splits
    K is launched twice and must give the same bits.  Then one batch-8
    backward of the 57 convolutions at fp32 (dx for every conv but stem1,
    as training asks) timed beside its plain version, cuDNN's backward
    (measured, never used) and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d.ops import backward_splits
    from repro_torch.kernels.dispatch import GRAD_RTOL
    bwd = table["conv2d_backward"]
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: full fp32 products
    torch.backends.cudnn.allow_tf32 = False         # cuDNN at fp32: no TF32
    groups = conv_groups()
    cases = [(xs, ws, stride, names[0], names[0] != "stem1")
             for (xs, ws, stride), names in groups.items()]
    cases += [(xs, ws, stride, "extra", True) for xs, ws, stride in CONV_BWD_EXTRA]
    errs, split = {}, 0
    for dtype in (torch.float32, torch.float16):
        for xs, ws, stride, name, need_dx in cases:
            x, w, b = conv_case(torch, xs, ws, dtype)
            dy = conv_grad_out(torch, xs, ws, stride, dtype)
            sp = backward_splits(xs, ws, stride)
            label = (f"{name} x{xs} w{ws} /{stride} dx={need_dx} K slices (dgrad, wgrad) "
                     f"{sp} (limit {GRAD_RTOL[dtype]:.2e} of each gradient's max|ref|)")
            errs[dtype] = max(errs.get(dtype, 0.0), hold(
                torch, bwd, (x, w, b, dy), label, stride=stride, need_dx=need_dx))
            if max(sp) > 1:     # deterministic: the partials summed in slice order
                split += 1
                first = bwd.launch(x, w, b, dy, stride=stride, need_dx=need_dx)
                again = bwd.launch(x, w, b, dy, stride=stride, need_dx=need_dx)
                torch.cuda.synchronize()
                if not all(torch.equal(u, v) for u, v in zip(first, again) if u is not None):
                    raise AssertionError(f"conv2d_backward {label}: two launches differ")
    log(f"conv2d_backward: {2 * len(cases)} cases held, {split} of them split and "
        f"launched twice for the same bits")
    timer = Timer(torch, reps=10)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    for (xs, ws, stride), names in groups.items():
        need_dx = names[0] != "stem1"
        x, w, b = conv_case(torch, xs, ws, torch.float32)
        dy = conv_grad_out(torch, xs, ws, stride, torch.float32)
        n = len(names)
        ms = timer(lambda: bwd.launch(x, w, b, dy, stride=stride, need_dx=need_dx))
        plain_ms = timer(lambda: bwd.plain(x, w, b, dy, stride=stride, need_dx=need_dx))
        lib_ms = timer(library_conv_backward(torch, F, x, w, b, dy, stride, need_dx))
        nbytes, flops = conv_backward_work(xs, ws, stride, need_dx, 4)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bytes", nbytes), ("flops", flops)):
            tot[key] += n * v
        log(f"conv2d_backward fp32 {','.join(names)}: x{xs} w{ws} /{stride} dx={need_dx} "
            f"K slices {backward_splits(xs, ws, stride)} kernel {ms:.4f}ms plain "
            f"{plain_ms:.4f}ms cuDNN {lib_ms:.4f}ms bound "
            f"{bound(nbytes, flops, FP32_FLOPS)[0]:.5f}ms {flops / ms / 1e9:.1f} TFLOP/s")
    tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["flops"], FP32_FLOPS)
    log(f"conv2d_backward fp32, the 57 convs of one batch-{CONV_BATCH} backward at "
        f"{CONV_SIZE} (dgrad 56, wgrad 57): kernel {tot['ms']:.4f}ms plain "
        f"{tot['plain_ms']:.4f}ms cuDNN {tot['library_ms']:.4f}ms (kernel / cuDNN "
        f"{tot['ms'] / tot['library_ms']:.2f}) bound {tot['bound_ms']:.4f}ms "
        f"({tot['bound_by']}; {tot['flops'] / 1e9:.2f} GFLOP at 67 TFLOP/s fp32, "
        f"{tot['bytes'] / 1e6:.1f} MB at 3.35 TB/s)")
    return {"conv2d_backward": dict(
        tot, max_abs_err=errs[torch.float32], max_abs_err_fp16=errs[torch.float16],
        shape=f"the 57 convs of GoogLeNet's backward, batch {CONV_BATCH} at {CONV_SIZE}, "
              f"fp32, body=fma (dgrad 56, wgrad 57)")}


def googlenet_counts(micro: int) -> dict:
    """Launches by body of ``micro`` fp32 GoogLeNet training microbatches:
    K6 once a conv (FMA), its backward's wgrad once a conv and dgrad once a
    conv but stem1 (the images need no gradient), K7 for the classifier's
    forward, dX and dW (FMA)."""
    return {"conv2d": {"fma": 57 * micro},
            "conv2d_backward": {"dgrad": 56 * micro, "wgrad": 57 * micro},
            "matmul": {"fma": 3 * micro}}


def googlenet_train_path_check(torch, np) -> None:
    """Phase 22b: GoogLeNet at full width (224, 1000 classes), fp32, one
    batch-8 microbatch of ``SyntheticImages``.  (1) The backward on one
    forward graph: the gradient of every leaf through the backward kernels
    (K6's, K7's) and, from the same retained graph -- the same ReLU masks
    and max-pool choices -- through their plain versions, held leaf by leaf
    to ``dispatch.grad_tolerance_ratio`` (the per-conv limit of 22a).
    (2) Two whole runs, through the kernels and through the plain versions:
    the loss within ``TOL_TRAIN_LOSS_REL``, every gradient leaf within
    ``TOL_TRAIN_GRAD_REL`` of its largest entry (phase 14's limit: two fp32
    paths part where a pre-activation near 0 or a near-tie in a max-pool
    window goes the other way), and both printed beside a run with every
    conv and product summed in fp64 and rounded once.  The kernel run's
    launches held exactly, with no plain call."""
    from unittest import mock

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d.ref import conv2d_backward_ref, conv2d_ref
    from repro_torch.models.layers import linear
    from repro_torch.models.registry import fns_for
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = arch_registry.config("googlenet")
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    batch = {k: torch.as_tensor(v).cuda() for k, v in SyntheticImages(
        cfg.vocab_size, CONV_BATCH, CONV_SIZE, seed=5).sample(CONV_BATCH).items()}
    ps = leaves(params)
    loss_fn = make_loss_fn(cfg)

    def loss_and_grads():
        for p in ps:
            p.requires_grad_(True)
        loss, _ = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, ps)
        for p in ps:
            p.requires_grad_(False)
        return loss.item(), grads

    def exact_conv(x, w, b, *, stride=1):
        return conv2d_ref(x.double(), w.double(), b.double(), stride=stride).to(x.dtype)

    def exact_backward(x, w, b, dy, *, stride=1, need_dx=True):
        dx, dw, db = conv2d_backward_ref(x.double(), w.double(), b.double(), dy.double(),
                                         stride=stride, need_dx=need_dx)
        return None if dx is None else dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype)

    table = dispatch.kernel_table()
    want = googlenet_counts(1)
    # (1) one forward through the kernels; its backward through the kernels,
    # then again through the plain versions
    for p in ps:
        p.requires_grad_(True)
    dispatch.reset_counts()
    loss, _ = loss_fn(params, batch)
    kern_g = torch.autograd.grad(loss, ps, retain_graph=True)
    got = {n: dict(table[n].body_launches) for n in want}
    plain_calls = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
    with dispatch.plain_versions():
        same_g = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    kern_loss = loss.item()
    del loss
    ratios = [dispatch.grad_tolerance_ratio([k], [g]) for k, g in zip(kern_g, same_g)]
    # (2) whole runs through the plain versions and through fp64 sums
    with dispatch.plain_versions():
        plain_loss, plain_g = loss_and_grads()
        with mock.patch.object(conv_ops.KERNEL, "plain", exact_conv), \
                mock.patch.object(conv_ops.BACKWARD, "plain", exact_backward), \
                mock.patch.object(linear, "_k7",
                                  lambda x, y: (x.double() @ y.double()).to(x.dtype)):
            exact_loss, exact_g = loss_and_grads()

    def rel(a, b):
        return [((x - y).abs().max() / y.abs().max().clamp(min=1e-30)).item()
                for x, y in zip(a, b)]
    r_loss = abs(kern_loss - plain_loss) / abs(plain_loss)
    r_grad = rel(kern_g, plain_g)
    k_exact, p_exact = rel(kern_g, exact_g), rel(plain_g, exact_g)
    log(f"googlenet training path check (fp32, 224, batch {CONV_BATCH}, {len(ps)} gradient "
        f"leaves): one forward graph, backward kernels vs plain versions: worst leaf "
        f"err/limit {max(ratios):.3f} (grad_tolerance_ratio, fp32 2^-14 of a leaf's max), "
        f"median {statistics.median(ratios):.3f}; launches by body {got}; plain calls "
        f"{plain_calls or 0}")
    log(f"googlenet training path check, whole runs: loss kernels {kern_loss:.7f} plain "
        f"{plain_loss:.7f} fp64 sums {exact_loss:.7f}, kernels vs plain rel={r_loss:.3e} "
        f"(tol {TOL_TRAIN_LOSS_REL}); worst gradient leaf, of its max: kernels vs plain "
        f"{max(r_grad):.3e} (tol {TOL_TRAIN_GRAD_REL}), vs fp64 sums kernels "
        f"{max(k_exact):.3e} plain {max(p_exact):.3e}")
    if got != want or plain_calls:
        raise AssertionError(f"googlenet training path check: launches {got}, expected "
                             f"{want}; plain calls {plain_calls}")
    finite = all(bool(torch.isfinite(g).all()) for g in kern_g)
    if not (finite and max(ratios) <= 1.0 and r_loss <= TOL_TRAIN_LOSS_REL
            and max(r_grad) <= TOL_TRAIN_GRAD_REL):
        raise AssertionError(f"googlenet training path check: kernels and plain versions "
                             f"disagree (one graph: worst err/limit {max(ratios)}; whole "
                             f"runs: loss {r_loss}, gradients {max(r_grad)}; finite {finite})")
    del params, ps, kern_g, same_g, plain_g, exact_g, batch
    gc.collect()
    torch.cuda.empty_cache()


def googlenet_training_phase(torch, np, table) -> dict:
    """Phase 22c: GoogLeNet at full width (224x224x3, 1000 classes, fp32)
    trained by the port's ``Trainer`` from ``SyntheticImages``, as the
    reference trains it (its launcher feeds only tokens):
    ``GOOGLENET_TRAIN_STEPS`` steps of ``GOOGLENET_BATCH`` images in
    ``GOOGLENET_ACCUM`` microbatches, AdamW with the launcher's recipe.
    Every loss finite; launches exact by body (``googlenet_counts``), no
    plain call.  Step time, img/s, img/s/W against the power limit, peak
    memory; one more step under the profiler.  Returns the launches by
    kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.optim.optimizers import adamw, leaves, warmup_cosine
    from repro_torch.training.trainer import Trainer, TrainerConfig

    name, watts = card_name_and_power_limit()
    cfg = arch_registry.config("googlenet")
    want = googlenet_counts(GOOGLENET_ACCUM * GOOGLENET_TRAIN_STEPS)
    data = SyntheticImages(cfg.vocab_size, GOOGLENET_BATCH, CONV_SIZE, seed=0)
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(num_steps=GOOGLENET_TRAIN_STEPS, ckpt_every=50, ckpt_dir=d,
                           device="cuda")
        tr = Trainer(cfg, iter(data), tc, accum=GOOGLENET_ACCUM,
                     optimizer=adamw(warmup_cosine(3e-3, 20, GOOGLENET_TRAIN_STEPS)))
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_counts()
        t0 = time.monotonic()
        hist = tr.train()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        got = {n: dict(table[n].body_launches) for n in want}
        plain = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist if "loss" in h]
    times = [h["step_time_s"] for h in hist if "loss" in h]
    step = statistics.mean(times[1:])
    state_bytes = 4 * 4 * sum(p.numel() for p in leaves(tr.params))
    log(f"googlenet training: 57 convs, 1000 classes, {state_bytes / 16 / 1e6:.3f}M params, "
        f"fp32, adamw; {GOOGLENET_TRAIN_STEPS} steps of {GOOGLENET_BATCH} images at "
        f"{CONV_SIZE} in {GOOGLENET_ACCUM} microbatches; wall {wall:.1f}s (init included)")
    log(f"googlenet training: losses={[round(v, 4) for v in losses]} first_step="
        f"{times[0]:.3f}s step={step:.4f}s img/s={GOOGLENET_BATCH / step:.1f} img/s/W="
        f"{GOOGLENET_BATCH / step / watts:.4f} at power.limit {watts:.0f} W ({name}) "
        f"max_memory_allocated={peak / 2**30:.2f}GiB (params+grads+adamw state "
        f"{state_bytes / 2**30:.3f}GiB)")
    log(f"googlenet training: launches by body {got} (expected {want}: a microbatch "
        f"{googlenet_counts(1)}); plain_calls={plain or 0}")
    if len(losses) != GOOGLENET_TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"googlenet training: losses {losses}")
    if got != want or plain:
        raise AssertionError(f"googlenet training: launches {got}, expected {want}; "
                             f"plain calls {plain}")
    batch = data.sample(GOOGLENET_BATCH)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        tr._step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    if not busy:
        raise AssertionError("googlenet training profile: the profiler saw no device time")
    by = {"K6 conv2d": ("conv2d_fma", "conv2d_mma", "conv2d_reduce"),
          "K6 backward": ("conv_dgrad", "conv_wgrad", "conv_bwd_reduce"),
          "K7 matmul": ("matmul_kernel", "matmul_wgmma_kernel")}
    parts = {k: sum(r[0] for r in rows if any(n in r[2] for n in v)) / 1e3
             for k, v in by.items()}
    log(f"googlenet training profile (one step, {GOOGLENET_ACCUM} microbatches): wall="
        f"{wall:.3f}s device_busy={busy:.3f}s busy_share={busy / wall:.3f} idle_share="
        f"{1 - busy / wall:.3f}; " + ", ".join(f"{k} {v:.4f}s ({v / busy:.3f} of device "
                                               f"time)" for k, v in parts.items()))
    for ms, count, key in rows[:12]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {key[:90]}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(c.values()) for n, c in got.items()}


def dots_training_phase(torch, np, table, full) -> dict:
    """Phase 22d: qwen2.5-3b at full width under remat "dots" (each block's
    weight products kept, the rest recomputed) for ``DOTS_TRAIN_STEPS``
    steps of phase 15's 8 x 512 tokens in 8 microbatches; step time and
    peak memory beside phase 15's "full" (``full``: its step seconds and
    peak bytes).  Launches exact by body: K7 without the recompute's block
    products, K4 72 and its backward 36 a microbatch as under "full"; no
    plain call.  Then one zamba2-1.2b microbatch (1 x 512) under "dots":
    its counts are phase 21d's, since the hybrid runs "dots" as "full" (as
    the reference does).  Returns the launches by kernel."""
    import tempfile

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import fns_for
    from repro_torch.optim.optimizers import adamw, leaves, warmup_cosine
    from repro_torch.training.train_step import make_loss_fn
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = arch_registry.config("qwen2.5-3b").replace(remat="dots")
    L, accum = cfg.num_layers, cfg.accum_steps
    micro = accum * DOTS_TRAIN_STEPS
    # per microbatch: each block's products once (kept for the recompute),
    # the LM head once, two products in each backward
    per_micro = L * QWEN_PRODUCTS + 1 + 2 * (L * QWEN_PRODUCTS + 1)
    want = {"matmul": {"wgmma": (per_micro - 3) * micro, "fma": 3 * micro},
            "flash_attention": {"mma": 2 * L * micro},
            "flash_attention_backward": {"fma": L * micro}}
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(num_steps=DOTS_TRAIN_STEPS, ckpt_every=50, ckpt_dir=d,
                           device="cuda")
        tr = Trainer(cfg, iter(SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ)), tc,
                     accum=accum, optimizer=adamw(warmup_cosine(3e-3, 20, DOTS_TRAIN_STEPS)))
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_counts()
        hist = tr.train()
        torch.cuda.synchronize()
        got = {n: dict(table[n].body_launches) for n in want}
        plain = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist if "loss" in h]
    times = [h["step_time_s"] for h in hist if "loss" in h]
    log(f"qwen2.5-3b training under remat=dots: {DOTS_TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in {accum} microbatches: losses={[round(v, 4) for v in losses]} "
        f"step times {[round(t, 3) for t in times]}s (the last "
        f"{TRAIN_BATCH * TRAIN_SEQ / times[-1]:.1f} tokens/s) max_memory_allocated="
        f"{peak / 2**30:.2f}GiB; phase 15 under remat=full: step {full[0]:.3f}s "
        f"max_memory_allocated {full[1] / 2**30:.2f}GiB")
    log(f"qwen2.5-3b training under remat=dots: launches by body {got} (expected {want}: "
        f"K7 {per_micro} a microbatch against 1011 under full); plain_calls={plain or 0}")
    if len(losses) != DOTS_TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"remat=dots training: losses {losses}")
    if got != want or plain:
        raise AssertionError(f"remat=dots training: launches {got}, expected {want}; "
                             f"plain calls {plain}")
    out = {n: sum(c.values()) for n, c in got.items()}
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    cfg = arch_registry.config("zamba2-1.2b").replace(remat="dots")
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in next(SyntheticTokens(cfg, 1, TRAIN_SEQ, seed=5)).items()}
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    zwant = zamba_counts(cfg, 1)
    dispatch.reset_counts()
    loss, _ = make_loss_fn(cfg)(params, batch)
    loss.backward()
    torch.cuda.synchronize()
    zgot = {n: dict(table[n].body_launches) for n in zwant}
    plain = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
    log(f"zamba2-1.2b, one 1 x {TRAIN_SEQ} microbatch under remat=dots: loss "
        f"{loss.item():.4f}; launches by body {zgot} (expected phase 21d's {zwant}); "
        f"plain_calls={plain or 0}")
    if zgot != zwant or plain or not bool(torch.isfinite(loss)):
        raise AssertionError(f"zamba2 remat=dots: launches {zgot}, expected {zwant}; plain "
                             f"calls {plain}; loss {loss.item()}")
    for n, c in zgot.items():
        out[n] = out.get(n, 0) + sum(c.values())
    del params, ps, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
    start = time.monotonic()

    def timed(label, fn, *args, **kw):
        """Run one phase; log its wall time and the total so far."""
        t = time.monotonic()
        out = fn(*args, **kw)
        log(f"[time] {label}: {time.monotonic() - t:.1f}s (total {time.monotonic() - start:.1f}s)")
        return out
    results = timed("3 kernels", kernel_phase, torch, table)
    results.update(timed("3b int8 kernels", int8_kernel_phase, torch, table))
    launches, bf16_serving = timed("4-5 serving", serving_phase, torch, np, table)
    int8_launches, int8_serving = timed("4b int8 serving", serving_phase, torch, np, table,
                                        "int8", bf16_serving)
    launches.update({f"{n}:int8": c for n, c in int8_launches.items()})
    timed("6 path check", path_check, torch, np)
    timed("6b int8 path check", int8_path_check, torch, np)
    results.update(timed("9 zamba2 kernels", hybrid_kernel_phase, torch, table))
    hybrid = timed("10 zamba2 serving", hybrid_serving_phase, torch, np, table)
    launches.update(hybrid)
    timed("11 zamba2 path check", hybrid_path_check, torch, np)
    results.update(timed("7 conv", conv_phase, torch, table))
    launches["conv2d"] = timed("8 googlenet", googlenet_phase, torch, np, table)
    k7 = timed("12 matmul", matmul_phase, torch, table)
    results["matmul"] = k7[K7_TIMED[0][0]]
    timed("13 matmul backward", matmul_backward_phase, torch, table)
    timed("14 training path check", train_path_check, torch, np)
    trained = timed("15 training", training_phase, torch, np, table)
    launches["matmul"] = trained.pop("matmul")
    timed("16 checkpoint", checkpoint_phase, torch, np)
    contiguous, contiguous_stats = timed("17 contiguous serving", contiguous_serving_phase,
                                         torch, np, table, bf16_serving)
    timed("17 contiguous path check", path_check, torch, np, contiguous=True)
    timed("17 contiguous int8", contiguous_int8_check, torch, np)
    timed("18 verify kernels", verify_kernel_phase, torch, table)
    spec = timed("18 spec serving", spec_serving_phase, torch, np, table, bf16_serving)
    timed("18 spec gate", spec_gate, torch, np)
    cfg, params = qwen_full(torch)
    tier = timed("19a host tier", tier_phase, torch, np, cfg, params)
    timed("19b faults", fault_phase, torch, np, cfg, params)
    service = timed("19c service mode", service_phase, torch, np, cfg, params, bf16_serving)
    fleet, mixed = timed("20a mixed fleet", mixed_fleet_phase, torch, np, cfg, params,
                         bf16_serving)
    disagg, pair = timed("20b disaggregated fleet", disagg_phase, torch, np, cfg, params)
    faults = timed("20c fleet faults", fleet_fault_phase, torch, np, cfg, mixed, pair)
    close(torch, *mixed, *pair)
    del mixed, pair
    wave = timed("20d wave mode", wave_phase, torch, np, cfg, params, contiguous_stats)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    timed("19 gate", tier_gate, torch, np)
    timed("20 gate", fleet_gate, torch, np)
    results.update(timed("21a attention backward", attention_backward_phase, torch, table))
    results.update(timed("21b scan backward", scan_backward_phase, torch, table))
    timed("21c zamba2 training path check", hybrid_train_path_check, torch, np)
    zamba_trained = timed("21d zamba2 training", hybrid_training_phase, torch, np, table)
    results.update(timed("22a conv backward", conv_backward_phase, torch, table))
    timed("22b googlenet training path check", googlenet_train_path_check, torch, np)
    googlenet_trained = timed("22c googlenet training", googlenet_training_phase, torch, np,
                              table)
    dots_trained = timed("22d remat dots", dots_training_phase, torch, np, table,
                         trained["full"])
    # the trained paths: qwen2.5-3b's K4 and its backward (phase 15), and
    # zamba2's K5, K4, their backward kernels and K7 (21d)
    launches["flash_attention"] += trained["flash_attention"]
    launches["flash_attention_backward"] = trained["flash_attention_backward"]
    launches["ssm_scan_backward"] = 0
    for name, count in zamba_trained.items():
        launches[name] += count
    # GoogLeNet training's K6, its backward and K7 (22c); remat "dots" (22d)
    launches["conv2d_backward"] = 0
    for name, count in list(googlenet_trained.items()) + list(dots_trained.items()):
        launches[name] += count
    # each entry counts every served or trained path that ran it
    launches["matmul"] += bf16_serving["matmul"] + int8_serving["matmul"] + hybrid["matmul"]
    for name, count in (list(contiguous.items()) + list(spec.items()) + list(tier.items())
                        + list(service.items()) + list(fleet.items()) + list(disagg.items())
                        + list(faults.items()) + list(wave.items())):
        launches[name] += count

    kernels = []
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "paged_decode_attention:int8", "paged_prefill_attention:int8",
                 "decode_attention", "flash_attention", "flash_attention_backward",
                 "ssm_scan", "ssm_scan_backward", "conv2d", "conv2d_backward", "matmul"):
        k, r = table[name.split(":")[0]], results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
        if k.note:
            kernels[-1]["note"] = k.note
        for extra in ("fma_ms", "bf16_body_ms", "sdpa_dequantized_ms"):
            if extra in r:   # the FMA body, the bf16 body on the dequantized pool, SDPA on it
                kernels[-1][extra] = r[extra]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}ms"
        if "sdpa_dequantized_ms" in r:
            lib += (f" (SDPA on the dequantized bf16 tensors, not the same function, "
                    f"{r['sdpa_dequantized_ms']:.4f}ms; the bf16 body on them "
                    f"{r['bf16_body_ms']:.4f}ms)")
        fma = f" (fma body {r['fma_ms']:.4f}ms)" if "fma_ms" in r else ""
        if "fma_bound_ms" in r:
            fma = f" (fma body {r['fma_ms']:.4f}ms, its bound {r['fma_bound_ms']:.4f}ms)"
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
