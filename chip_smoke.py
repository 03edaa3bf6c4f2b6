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
   recompute) on mma, and K4's backward kernel, 36 on mma; no plain call;
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
   window's busy share and peak memory beside phase 4's.  20b:
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
   largest at fp32, 2^-8 at bf16) on ``K4_BWD_CASES``, the backward on
   the body its route picks (bf16 at D 64 / 128 on "mma": P and dS as
   bf16 hi + lo pairs; fp32 on "fma") and each bf16 case on "fma" too,
   the route's body launched twice for the same bits; then both bodies
   timed at qwen2.5-3b's and zamba2's training heads beside SDPA's
   backward (autograd of ``scaled_dot_product_attention``, measured,
   never used) and the bound.  21b: K5's backward likewise
   on ``K5_BWD_CASES`` (zamba2's widths, B and C stride-0 head views, S
   512 and a ragged 1000, fp32 with an initial state and d_final): bf16
   on "mma" (the fp32 operands as bf16 hi + lo pairs) and on "fma", fp32
   on "fma", the route's body twice for the same bits; both bodies timed
   at S = 512 beside the plain version and the bound, and each body's
   five passes timed apart with CUDA events (runs stopped after each pass
   by ``last_pass``, differenced; ``pass_times``).  21c: zamba2-1.2b at
   full width cut to 7 layers (one segment, a 1-layer tail), fp32, one 1
   x 512 microbatch: loss and every
   gradient leaf through the kernels, the plain versions and fp64-summed
   products (phase 14's gate), launches exact by body, no plain call.
   21d: zamba2-1.2b at full width (38 layers, fp32 master weights, bf16
   compute, remat "full", AdamW), 3 steps of 8 x 512 in 8 microbatches
   through ``repro_torch.launch.train``: every loss finite; K5 74 a
   microbatch (38 and the 36 of the checkpointed segments' recompute) on
   mma, its backward 38 on mma, K4 12 on mma, its backward 6 on mma, K7
   495 (492 wgmma, the fp32 LM head's 3 on FMA); no plain call; step time,
   tokens/s, tokens/s/W, peak memory; one profiled step's device time by
   kernel and busy share.
22. GoogLeNet training and remat "dots".  22a: K6's backward kernel (dgrad
   where x needs its gradient, wgrad and db, each pass on the body its
   route picks: the cp.async-ring bodies "fma" (fp32) and "mma" (fp16) --
   dgrad at stride 1 as the SAME conv of dy by the flipped weight -- or
   "gather" (the one dgrad at a stride, a Cout the 16-byte pieces do not
   fit); split-K by the forward's rule on the body's tile and chunk, the
   partials summed in slice order) against its plain version evaluated
   in fp32 on the same values (``dispatch.grad_tolerance_ratio``: 2^-14 of
   each gradient's largest at fp32, 2^-10 at fp16) on every distinct conv
   shape of GoogLeNet's batch-8 forward at 224 (dx for every conv but
   stem1) and on ``CONV_BWD_EXTRA`` (stem1 with dx at stride 2, odd maps,
   a 4x2 window whose pads the flipped dgrad swaps), at fp32 and fp16,
   split cases launched twice for the same bits; then one batch-8
   backward of the 57 convs timed at fp32 beside its plain version,
   cuDNN's backward (autograd of ``F.conv2d`` in NCHW, TF32 off;
   measured, never used) and its bound (operations at 67 TFLOP/s fp32,
   bytes at 3.35 TB/s), and at fp16 beside cuDNN's fp16 backward and its
   bound (989 TFLOP/s).  22b: GoogLeNet at full width, fp32, one batch-8
   microbatch: on one forward graph, every gradient leaf through the
   backward kernels within ``grad_tolerance_ratio`` of the same graph's
   backward through the plain versions; two whole runs, the loss within
   ``TOL_TRAIN_LOSS_REL`` and every leaf within ``TOL_TRAIN_GRAD_REL``,
   printed beside a run whose convs and products are summed in fp64;
   launches exact, no plain call.  22c: GoogLeNet trained by the port's
   ``Trainer`` from ``SyntheticImages`` (4 steps of 32 images in 4
   microbatches, AdamW with the launcher's recipe): losses finite, a
   microbatch's launches exact by body (K6 57 on FMA, its backward 56
   ``dgrad_fma`` and 57 ``wgrad_fma``, K7 3), no plain call; step time, img/s, img/s/W,
   peak memory, one profiled step's busy share.  22d: qwen2.5-3b under
   remat "dots" (phase 15's batches, 2 steps): K7 759 a microbatch (the
   recompute reuses the kept products; 1011 under "full"), K4 72 and its
   backward 36, all on mma, no plain call; step time and peak memory beside phase
   15's; then one zamba2-1.2b microbatch under "dots", whose counts equal
   phase 21d's (the hybrid runs "dots" as "full", as the reference).

23. xlstm-125m at full width (12 blocks: 9 mLSTM, 3 sLSTM; d_model 768,
   vocab 50304, fp32 parameters from seed 0, bf16 compute).  23a: K5 at
   its mLSTM scan's widths (B=1, H=4, N=384 and, with the normalizer's
   ones column, P=385, per-head q/k, chunk 128) on the FMA body its route
   takes (N staged in six slices of 64), ``XLSTM_SCAN_CASES`` at fp32 and
   bf16 (ragged S, carried-in states) against the plain version
   (``ssm_tolerance_ratio``), each launched twice for the same bits; the
   bf16 prefill shape timed beside the plain version and the bound; the
   sLSTM's recurrent product timed as one K7 launch on the block-diagonal
   weight and as 4 per-head launches (not gated; ``slstm_product_timing``).
   xlstm-125m's weight products are K7 cases of phase 12.
   23b: served through the contiguous engine, 4 slots, zamba2's 8
   prompts (203-1000 tokens), 32 new each: tok/s, TTFT, TPOT, tok/s/W,
   peak memory; launches exact by body (K5 9 "fma" a prefill; K7 by
   ``xlstm_counts``: the sLSTM's recurrent product once a token, a
   decode step in fp32 from the first block's conv on, as the
   reference's); no plain call, no other kernel; a profiled window's busy
   share.  23c: the last-token logits of prompts of 333 and 1000 tokens
   in fp32, kernels against plain versions at depths 4 and 12
   (``TOL_XLSTM_PATH_REL``).

25. deepseek-moe-16b (28 layers: a first dense layer of d_ff 10944, then
   64 routed experts of d_ff 1408, top-6, and 2 shared experts; d_model
   2048, vocab 102400; random weights from seed 0, the product weights
   drawn a layer at a time and stored in bf16).  25a: K7's batched entry
   (the E experts' products in one launch) against its plain version on
   ``K7B_CASES`` -- a 256-row prefill chunk's expert products (64 experts
   of 30 rows), a decode step's (4 rows), a ragged E, M, N and K, and an
   fp32 case on the FMA body -- each launched twice for the same bits and
   timed beside the plain version, one ``torch.bmm`` and the bound.  25b:
   served at full width and depth, bf16, through the paged engine (4
   slots, 256-row chunks, phase 4's 8 requests, 32 new tokens each):
   tok/s, TTFT, TPOT, tok/s/W, peak memory, the pool's 229,376 B a token
   and a profiled window's busy share; launches exact by body per model
   call (K7 196 wgmma + 28 FMA, its batched entry 81 wgmma, K2 28 a
   prefill chunk, K1 28 a decode step); no plain call.  25c: the fp32
   path check at full width cut to 1 dense + 1 and + 3 MoE layers:
   phase 6's request through the plain versions (routes recorded), the
   kernels running free (their route differences and logits printed) and
   the kernels replaying the plain routes (logits within phase 6's
   ``TOL_PATH_REL``; each layer's own decision on those upstream routes
   may differ from the plain run's only where the plain run's smallest
   neighbouring log-probability gap among the top k + 1 is below
   ``TOL_MOE_FLIP_GAP``); every expert receives a kept row in each MoE
   layer, and the replayed run's MoE outputs, every row of every call,
   are finite and within ``TOL_MOE_OUT_REL`` of the plain run's.

26. deepseek-moe-16b training.  26a: the batched entry's backward
   products, dX = dY @ W^T and dW = X^T @ dY on transposed views, against
   the plain version on ``K7B_BWD_CASES`` -- a 512-token microbatch's 60
   rows an expert for gate/up and down, dW contracting over 1, 7 and 61
   rows, 5 experts of odd sizes on both bodies, fp32 on FMA -- each on its
   route's body (every 16-bit view TMA can read on a wgmma body: dW,
   writing more than it reads into a 16-byte output row, on the persistent
   one, "wgmma_persistent"; dX on the tile-per-block "wgmma"), launched twice for
   the same bits, timed beside the plain version, ``torch.bmm`` on the
   same views and the bound; the training shape's views on both wgmma
   bodies in turns.  26b: the fp32 training path check at full
   width cut to 1 dense + 1 and + 3 MoE layers, one 1 x 512 microbatch
   under remat "full", the kernels replaying the plain run's routes: loss
   and aux loss within ``TOL_TRAIN_LOSS_REL``; each gradient leaf no
   farther from an fp64-products run than ``TOL_MOE_EXACT_RATIO``
   times the plain run's, and at depth 2 within ``TOL_TRAIN_GRAD_REL`` of
   the plain run's largest, each expert's slice within
   ``TOL_MOE_EXPERT_GRAD_REL`` of its own; every expert receives a kept
   row; the recompute routes as the forward; two kernel runs the same
   bits; the allocator's free blocks filled with NaN before each run.
   26c: deepseek-moe-16b at full width cut to 4 layers (1 dense + 3 MoE,
   ~2.27 B parameters) trained by the port's ``Trainer`` (fp32 master
   weights, bf16 compute, AdamW, remat "full"; 3 steps of 4 x 512 tokens
   in 4 microbatches): losses finite, launches exact by body per
   microbatch (``moe_train_counts``: K7 112 wgmma + 15 FMA, its batched
   entry 27 wgmma + 9 wgmma_persistent, K4 8 and its backward 4 on mma),
   no plain call; step
   time, tok/s, tok/s/W, peak memory, one profiled microbatch's busy share
   beside CUDA events around it, and its recompute's routes equal to its
   forward's.

27. qwen2-vl-72b (M-RoPE sections (16, 24, 24), theta 1e6, qkv bias; d_model
   8192, 64 / 8 heads of 128, d_ff 29568, vocab 152064) at full width, its
   80 layers cut to 24 (42.1 GB of bf16 products drawn a layer at a time;
   the fp32 embedding and head 2 x 4.98 GB).  27a: served through the
   paged engine on phase 4's requests, 4 slots, block 16, 256-row chunks,
   the positions three equal streams: launches exact by body per model
   call (K2 24 a prefill chunk, K1 24 a decode step, all ``mma``; K7 168
   wgmma and the fp32 head on FMA), no plain call; tok/s, TTFT, TPOT,
   tok/s/W, peak memory, the pool's 98,304 B a token, a profiled window's
   busy share.  27b: phase 6's fp32 path check at depths 1, 2 and 4 (its
   limits), and one ``transformer.prefill`` at depth 2 whose position
   streams 1 and 2 differ from stream 0, held to the same gate.
28. whisper-medium at its full config (24 encoder and 24 decoder layers,
   d_model 1024, 16 heads of 64, d_ff 4096, vocab 51865, 1500 frames; the
   audio frontend a stub, frames of zeros).  28a: K4 non-causal with k and
   v of their own length (``WHISPER_K4_CASES``: the encoder's 1500 x
   1500, the cross-attention's 192 queries against 1500 and a ragged 1037
   rows, one query row, 1501 rows) and K3 at the cross-attention's decode
   shape (4 slots against 1500 rows; ragged lengths with NaN past them),
   fp32 and bf16, against their plain versions (phase 3's limits); then
   K4's encoder, cross and ragged cross shapes and K3's timed in bf16
   beside the plain version, SDPA and the bound.  28b: the fp32 path check
   of a 100-token request through the contiguous engine at (encoder,
   decoder) depths (1, 1), (2, 2) and (4, 4), phase 6's limits.  28c:
   served through the contiguous engine, 4 slots, ``max_len`` 256, 8
   requests of decoder prompts in [16, 192] from seed 0, 32 new each:
   launches exact by body (K4 72 a prefill: 24 encoder, 24 causal self,
   24 cross; K3 48 a decode step: 24 self with the row write, 24 cross; K7
   by ``whisper_counts``), no plain call; tok/s, TTFT, TPOT, tok/s/W, peak
   memory, the cross caches' 147.5 MB a slot, a profiled window's busy
   share.
29. whisper-medium training.  29a: K4's backward non-causal with k and v
   of their own length (``K4B_WHISPER_CASES``: the encoder's 1500 x 1500,
   the cross-attention's 448 decoder rows against 1500 and a ragged 1037,
   one query row, 1501 rows, 70 queries against 33 keys at G = 1 and 8),
   fp32 and bf16, after K4 with its log-sum-exp, against the plain version
   evaluated in fp32, on the body its route picks and on "fma" for bf16,
   NaN right after k and v (rows no tile may stage), the route's body
   launched twice for the same bits; then both bodies timed at the
   encoder's and the cross-attention's shapes beside the plain version,
   SDPA's backward and the bound.  29b: the fp32 training path check at
   (encoder, decoder) depths 1 and 2, full widths, 1500 frames, one 1 x 448
   microbatch under remat "full", three seeds: the loss and every gradient
   leaf through the kernels against the plain versions and a run whose
   weight products are summed in fp64 (``WHISPER_TRAIN_LIMITS``), launches
   exact by body.  30a's check is the same on qwen2-vl-72b.  29c: trained
   at its full config by the port's ``Trainer`` (fp32 master weights, bf16
   compute, remat "full", AdamW), 3 steps of 8 x 448 tokens in 8
   microbatches: launches exact by body (:func:`whisper_train_counts`: K4
   144, its backward 72, K7 1488 wgmma + 3 FMA a microbatch), no plain
   call; step time, tok/s, tok/s/W, peak memory, a profiled microbatch's
   busy share.
30. qwen2-vl-72b training.  30a: the fp32 training path check at depths 1
   and 2, full widths, one 1 x 256 microbatch whose position streams 1 and
   2 differ from stream 0, one seed (``VLM_TRAIN_LIMITS``).  30b: cut to
   4 of its 80 layers (~6.0 B parameters), fp32 master weights, bf16
   compute, remat "full", Adafactor (the config's optimizer), 3 steps of 4
   x 512 tokens in 4 microbatches, three equal position streams: launches
   exact by body (K4 8, its backward 4, K7 112 wgmma + 3 FMA a
   microbatch), no plain call; step time, tok/s, peak memory, a profiled
   microbatch's busy share.
31. Serving under a device mesh.  31a: K3 with its row log-sum-exp
   (``return_lse``: m and l beside the output) on ``LSE_DECODE_CASES``
   (local lengths of 0, of S and past S; zamba2's and qwen2.5-3b's heads),
   fp32 on FMA and bf16 on both bodies, as made and with NaN past the
   lengths, the allocator's free blocks filled with NaN before each
   launch: out, m and l held by ``dispatch.lse_tolerance_ratio``, out the
   same bits as the call without the log-sum-exp, and those bits the
   build's before it was added (``K3_PARENT_BITS``); timed with and
   without it on both bodies beside the plain version and the bound.
   31b: a 1056-row cache cut into 2, 4 and 8 slices, K3 with its
   log-sum-exp on each at the shard's lengths, ``merge_lse``: held against
   one call and the plain version, fp32 and bf16.  The policy's per-card
   bytes of qwen2-vl-72b and qwen3-moe-235b-a22b on a 1 x 4 mesh
   (``mesh_plan``, printed).  Then a ``torch.distributed`` world of one
   rank on NCCL (a ``HashStore``) and a 1 x 1 DeviceMesh, destroyed at the
   end: 31c, qwen2.5-3b at full width through the contiguous engine
   without the mesh and then under it (``rules_for``'s decode rules:
   ``kv_seq`` on model), phase 17's requests: the same greedy tokens,
   launches exact by body (K3 36 a decode step, every one ``mma_lse``; K4
   36 a prefill; K7 as phase 17), one all-gather a layer a decode step,
   no plain call; TPOT, tok/s, peak memory side by side.  31d: ``moe_ep``
   at deepseek-moe-16b's MoE widths on a 256-row chunk on the model group
   of one rank, against its plain versions and, at capacity factor 8,
   ``moe_dense``; K7's batched entry 3 ``wgmma`` launches a call.
32. Training under a device mesh.  32b: K4 and its backward on a 1 x 4
   rank's heads of qwen2.5-3b (4 query heads, the one KV head their group
   reads, 2 x 512, bf16) and K7 on its slices (the SwiGLU's 2752 ``ff``
   columns: gate / up, down, the backward's dX and dW on transposed views,
   each on ``wgmma``; the LM head's 37984 vocabulary columns read from
   the tied table's slice transposed, bf16 on ``wgmma`` and fp32 on FMA),
   each against its plain version, timed beside the plain version, the
   library call and the bound.  The policy's per-card bytes of
   parameters, gradients and optimizer state of qwen2-vl-72b (80 layers)
   and qwen3-moe-235b-a22b under the training rules on 16 x 16, 1 x 4 and
   2 x 4 meshes (``mesh_train_plan``, printed).  Then an NCCL world of one
   rank and a 1 x 1 mesh, destroyed at the end: 32a, qwen2.5-3b at full
   width cut to 4 layers, 2 steps of 4 x 512 in 2 microbatches through the
   ``Trainer`` without the mesh and then under ``rules_for``'s training
   rules (heads, ``ff`` and the vocabulary on model, ``seq_sp``): the
   same bits of every metric and updated parameter, the same launches by
   body, no plain call, the collectives printed, step times side by side,
   a block's host time with and without the mesh.  32c: ``moe_ep``'s
   forward and backward at deepseek-moe-16b's MoE widths on a 256-row
   chunk against its plain versions at capacity factors 1.25 and 8, and
   at 8 (nothing drops) against ``moe_einsum``'s output and gradients
   through the plain versions (``TOL_MOE_EP_GRAD_REL``); K7's batched
   entry 3 + 6 launches a call.

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
K1 and K2 phases 4, 18, 19a (tiered and untiered), 19c, 20a, 20b, 20c and
27a, K3 phases 10, 17, 20d, 28c and 31c, K4 phases 10, 15, 17, 20d, 21d, 22d,
26c, 28c, 29c, 30b, 31c and 32a,
K4's backward 15, 21d, 22d, 26c, 29c, 30b and 32a, K5 10, 21d, 22d and 23b, K5's backward 21d and
22d, K6 phases 8 and 22c, K6's backward 22c, K7 phases 4, 4b, 10, 15, 17,
18, 19a, 19c, 20a-d, 21d, 22c, 22d, 23b, 25b, 26c, 27a, 28c, 29c, 30b, 31c and 32a, K7's batched entry
25b and 26c (its entry also carries the decode step's shape:
``decode_ms``, ``decode_plain_ms``, ``decode_library_ms``,
``decode_bound_ms``, ``decode_bound_by``, ``decode_shape``; and its two
backward products at a training microbatch's, ``train_dx_*`` and
``train_dw_*``, each also timed on both wgmma bodies: ``*_wgmma_ms``,
``*_persistent_ms``).  K5's entry also carries its
time at xlstm-125m's prefill shape (``xlstm_ms``, ``xlstm_plain_ms``,
``xlstm_bound_ms``, ``xlstm_bound_by``, ``xlstm_shape``); K4's its times
at whisper-medium's encoder and cross-attention shapes and K3's at its
cross-decode shape (``whisper_encoder_*``, ``whisper_cross_*``,
``whisper_cross_ragged_*``, ``whisper_cross_decode_*``: ``ms``,
``plain_ms``, ``library_ms`` (SDPA), ``bound_ms``, ``bound_by``,
``shape``) and its times with its row log-sum-exp at phase 31a's timed
case (``lse_ms``, ``lse_nolse_ms`` without it, ``lse_fma_ms``,
``lse_fma_nolse_ms``, ``lse_plain_ms``, ``lse_library_ms`` none,
``lse_bound_ms``, ``lse_bound_by``, ``lse_shape``, ``max_abs_err_lse``);
K4, its backward and K7 carry phase 32b's times at a 1 x 4 rank's shapes
(``tp4_*``; K7's ``tp4_ff_*``, ``tp4_vocab_bfloat16_*``,
``tp4_vocab_float32_*``); K4's backward the same at the encoder's and the
cross-attention's training shapes (``whisper_encoder_*``,
``whisper_cross_*``, with ``fma_ms``, the FMA body's time, and
``library_ms`` SDPA's backward).  The three backward kernels replace no
Pallas kernel (the reference differentiates its plain functions and
``lax.conv_general_dilated``): their entries name the forward's Pallas
kernel under ``replaces`` and say so under ``note``.
"""
from __future__ import annotations

import gc
import json
import math
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
PATH_LIMITS = {d: (TOL_PATH_REL[d], TOL_PATH_EXACT_RATIO) for d in TOL_PATH_REL}
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
# xlstm-125m (phase 23): its mLSTM scan's widths (d_inner 1536 over 4 heads,
# v widened by the normalizer's ones column) and K5's cases there, (S,
# initial state): the timed prefill shape first, a ragged one, chunk
# multiples; every case past one chunk or carrying a state in, so a lost
# carry shows.  The serving phase takes zamba2's prompts and cache length.
XLSTM_H, XLSTM_N, XLSTM_P = 4, 384, 385
XLSTM_SCAN_CASES = ((1000, False), (203, True), (777, True), (1024, False), (256, True))
XLSTM_PRODUCTS = 7      # weight products an mLSTM block makes: up, q k v, w_i w_f, down
# the fp32 path check's limits on the largest logit difference relative to
# the largest logit, by depth, set before its first run: the hybrid path
# check's (TOL_HYBRID_PATH_REL), 4 blocks (the first sLSTM and three
# mLSTM) at its 6-layer limit, the full 12 at its 13-layer one
TOL_XLSTM_PATH_REL = {4: 1e-4, 12: 1e-2}
# Phase 24, xlstm-125m training.  24a: K5's backward at the mLSTM's widths
# (FMA body, N and P walked in slices of 64), (S, h0 and d_final): the
# training length, a ragged S with and without a carried state, S under
# one chunk.  24b: the fp32 and bf16 train path check at full width cut to
# 2 blocks (an mLSTM, an sLSTM), 1 x XLSTM_CHECK_SEQ tokens.  On one
# forward graph the backward through the kernels against the backward
# through the plain versions, each leaf against its own largest entry:
# every leaf but the mLSTM's b_i within 2^-14 (fp32) or
# TOL_XLSTM_BF16_GRAD_REL (bf16), set before the first run: a bf16
# gradient's one rounding moves an entry up to 2^-8 of the largest
# (GRAD_RTOL's bf16 limit), and a leaf's gradient passes through two such
# products (K5's backward or a dX, then the dW) on each side, so 4x that.
# b_i (4 entries: d log_gate summed over the sequence) cancels 1e4-1e6
# fold (sum |d log_gate| over |the sum|, PR 29 run F), so rounding that
# moves no other leaf past 1e-2 of its largest moves b_i by 1e-3 (fp32) to
# 0.15 (bf16) of its own: at bf16 the upstream products' bf16 dX differ
# from an fp64-backed run's in 377 of the 462,000 entries of the scan's
# dy, and those flips alone move b_i by 0.11 of its largest (the scan in
# fp64 on both runs' dy), the plain run's b_i 0.149 from the fp64 one.
# So b_i is held twice: in the graph within TOL_XLSTM_BI_REL of its
# largest (fp32 2^-8 over readings of 8e-4-1.7e-3, bf16 2^-1 over 0.10-
# 0.11: a zero or sign-flipped b_i fails by 2x-4x there), and the scan's
# part on the graph's own inputs: K5's backward launched again on the
# operands its launch in the graph received, its d log_gate summed over
# the sequence per head against the plain version's sums on the same
# operands, within TOL_XLSTM_BI_SCAN_REL of their largest (readings 3e-4-
# 2.2e-3, run F: a zero or sign-flipped sum fails by 64x-128x), with that
# launch's every output within grad_tolerance_ratio.  Then whole fp32
# runs: loss and leaves at phase 14's limits.
# 24c: xlstm-125m trained for XLSTM_TRAIN_STEPS steps of 4 x TRAIN_SEQ
# tokens in 4 microbatches (the 8 x 512 / 8 recipe's 1 x 512 microbatch).
XLSTM_BWD_CASES = ((512, False), (300, True), (300, False), (7, True))
XLSTM_CHECK_SEQ = 300
TOL_XLSTM_BF16_GRAD_REL = 2.0 ** -6
TOL_XLSTM_BI_REL = {"float32": 2.0 ** -8, "bfloat16": 2.0 ** -1}
TOL_XLSTM_BI_SCAN_REL = 2.0 ** -6
XLSTM_TRAIN_STEPS, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_ACCUM = 3, 4, 4
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
# (16-bit on the FMA body), and zamba2-1.2b's and xlstm-125m's weight products.
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
                        ("mlp down", 8192, 2048))
) + tuple(
    # xlstm-125m's products at its longest prompt, at a prefill's one row
    # (the sLSTM's fp32 recurrent product a token, on the block-diagonal
    # (768, 3072) weight, and the LM head) and at decode (4 slots)
    (f"xlstm {label}", M, K, N, "rows", ("float32", "bfloat16"))
    for M in (1000, 1, 4)
    for label, K, N in (("mLSTM up_proj, sLSTM w_in and recurrent", 768, 3072),
                        ("mLSTM wq/wk/wv", 1536, 1536), ("mLSTM w_i/w_f", 1536, 4),
                        ("mLSTM down_proj", 1536, 768), ("sLSTM up_gate/up", 768, 1024),
                        ("sLSTM down", 1024, 768))
) + tuple(("xlstm tied lm head, y = tok.T", M, 768, 50304, "y.T", ("float32",))
          for M in (1, 4))
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
# how K5's backward's passes are timed apart (``pass_times``)
PASS_TIMING = ("CUDA events, 10 calls of each run stopped after pass n by last_pass, L2 "
               "flushed; a pass's time the difference of neighbouring runs")
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
# Cin no tile divides, and a 4x2 window at stride 1 (SAME pads 1 / 2 and
# 0 / 1: the flipped dgrad swaps them).  22c: GOOGLENET_TRAIN_STEPS steps of GOOGLENET_BATCH
# images in GOOGLENET_ACCUM microbatches.  22d: qwen2.5-3b under remat
# "dots" for DOTS_TRAIN_STEPS steps of phase 15's batches.
CONV_BWD_EXTRA = (((8, 224, 224, 3), (7, 7, 3, 64), 2), ((3, 13, 11, 5), (3, 3, 5, 7), 2),
                  ((2, 9, 9, 3), (7, 7, 3, 10), 2), ((1, 15, 17, 24), (5, 5, 24, 40), 1),
                  ((2, 10, 10, 33), (1, 1, 33, 17), 2), ((2, 9, 10, 16), (4, 2, 16, 24), 1))
GOOGLENET_TRAIN_STEPS, GOOGLENET_BATCH, GOOGLENET_ACCUM = 4, 32, 4
DOTS_TRAIN_STEPS = 2
# Phase 25: deepseek-moe-16b (d_model 2048, 28 layers: a first dense layer
# of d_ff 10944, then 64 routed experts of d_ff 1408, top-6, and 2 shared
# experts fused into one SwiGLU of d_ff 2816).  K7's batched entry on its
# expert products, (label, E, M, K, N, dtype): a 256-row prefill chunk
# gives each expert 30 rows (capacity ceil(256 x 6 x 1.25 / 64)), a decode
# step of 4 slots 4 rows (capacity 1 a slot); a ragged E, M (13 rows of a
# 64-row tile), N and K; the fp32 products of phase 25c on the FMA body.
# The first is the kernels line's; the decode gate/up shape rides along.
K7B_CASES = (("prefill gate/up", 64, 30, 2048, 1408, "bfloat16"),
             ("prefill down", 64, 30, 1408, 2048, "bfloat16"),
             ("decode gate/up", 64, 4, 2048, 1408, "bfloat16"),
             ("decode down", 64, 4, 1408, 2048, "bfloat16"),
             ("ragged E=5 M=13 K=520 N=1000", 5, 13, 520, 1000, "bfloat16"),
             ("fp32 prefill gate/up", 64, 30, 2048, 1408, "float32"))
# the products of one model call: the dense layer's 7 and each MoE layer's
# q k v o, router, shared gate / up / down on the 2-D entry; the experts'
# gate / up / down on the batched entry; the fp32 LM head
DEEPSEEK_LAYERS, DEEPSEEK_MOE_LAYERS = 28, 27
DEEPSEEK_K7 = {"wgmma": 7 + 7 * DEEPSEEK_MOE_LAYERS, "fma": DEEPSEEK_MOE_LAYERS + 1}
DEEPSEEK_K7B = {"wgmma": 3 * DEEPSEEK_MOE_LAYERS}
DEEPSEEK_KV_BYTES = 2 * DEEPSEEK_LAYERS * 16 * 128 * 2      # K and V, bf16, a token
# Phase 25c: the fp32 path check at full width cut to 1 dense + 3 MoE
# layers, gated at depths 2 and 4 by phase 6's limits (TOL_PATH_REL).  On
# the plain run's upstream routes the kernels' own decision may route a
# token otherwise only where the plain run's top-(k+1) router
# probabilities hold a neighbouring pair within this gap of
# log-probability.  A flip of two experts needs their logits' difference
# to move by the gap; the two runs' router logits differ by the rounding
# of h carried through the layers' near-one-hot attention, 7.0e-4 at
# depth 2 and 2.3e-2 at depth 4 (NVIDIA H100 80GB HBM3), so the gap is
# twice the latter; a broken expert product moves them by 0.7-1.2.
MOE_PATH_DEPTHS = (2, 4)
TOL_MOE_FLIP_GAP = 5e-2
# Phase 25c also holds the replayed run's MoE layer outputs, every row of
# every call (the padded chunk's rows too), against the plain run's,
# relative to the largest.  At depth 2 the one MoE layer is the last, so
# its output reaches the two logit rows the check reads and no other: a
# lost expert whose tokens are other rows left those logits bit for bit
# (a mutant of the batched entry that skips the last expert).  The right
# kernels read 2.2e-4 at depth 2 and 8.6e-3 at depth 4 (NVIDIA H100 80GB
# HBM3, 700.00 W); the limits are ~9x and ~6x those.  A lost expert's rows
# move by O(1) or read NaN.
TOL_MOE_OUT_REL = {2: 2e-3, 4: 5e-2}
# Phase 26: deepseek-moe-16b training.  26a: the batched entry's backward
# products on transposed views, (label, E, C, D, F, dtype): a product
# y = x @ w of x (E, C, D) and w (E, D, F) gives dX = dY @ w^T (E, C, D)
# and dW = x^T @ dY (E, D, F), whose contraction is the capacity C.  A
# 512-token microbatch gives each expert 60 rows (ceil(512 x 6 x 1.25 /
# 64)): gate/up (D 2048 -> F 1408) and down (1408 -> 2048); C = 1, 7 and
# 61 (contractions under and past one 64-deep K step); 5 experts of sizes
# TMA can read and of sizes it cannot (bf16 on the FMA body); fp32 on FMA.
# The first is the kernels line's.
K7B_BWD_CASES = (("train gate/up", 64, 60, 2048, 1408, "bfloat16"),
                 ("train down", 64, 60, 1408, 2048, "bfloat16"),
                 ("C=1", 64, 1, 2048, 1408, "bfloat16"),
                 ("C=7", 64, 7, 1408, 2048, "bfloat16"),
                 ("C=61", 64, 61, 2048, 1408, "bfloat16"),
                 ("E=5 C=13 D=520 F=1000", 5, 13, 520, 1000, "bfloat16"),
                 ("E=5 C=13 D=517 F=999", 5, 13, 517, 999, "bfloat16"),
                 ("fp32 train gate/up", 64, 60, 2048, 1408, "float32"))
# 26b: the fp32 training path check at full width cut to 1 dense + 1 and +
# 3 MoE layers, one 1 x TRAIN_SEQ microbatch under remat "full", the
# kernels replaying the plain run's routes (as 25c): the loss and aux loss
# within TOL_TRAIN_LOSS_REL, each gradient leaf within TOL_TRAIN_GRAD_REL
# of its largest entry (phase 14's limits), and each expert's slice of the
# expert weights' gradients within TOL_MOE_EXPERT_GRAD_REL of that slice's
# own largest entry, set before the first run: an expert's gradient sums
# its C rows' products, so its rounding is a leaf's, but the slice of an
# expert with few rows is read against a smaller largest entry; a lost or
# misplaced expert moves its slice by O(1).
MOE_TRAIN_DEPTHS = (2, 4)
TOL_MOE_EXPERT_GRAD_REL = 1e-1
# At depth 4 two right fp32 paths part further: the kernels' leaves read up
# to 0.23 of their largest from the plain versions' (the first layer's MLP,
# the deepest gradient; an expert slice 0.27), where depth 2 reads 1.1e-3;
# the plain run itself sits 0.148 from a run whose weight products (2-D
# and batched) are summed in fp64 and rounded once ("exact products"),
# and two plain runs that differ only in the attention's KV tile 6.0e-3
# apart (NVIDIA H100 80GB HBM3, 700.00 W): three layers of near-one-hot
# attention amplify the products' rounding.  So each depth is held, as
# phase 14 is, against the exact products: every leaf of the kernels no
# more than TOL_MOE_EXACT_RATIO times as far from them as the plain
# versions' (floored at 1e-7; an expert's slice is not: one of the 576
# slices, each a sum over 60 rows, read 2.33x at depth 2).  At
# depth 2 that is phase 14's 2.0 (the worst leaf read 0.86); at depth 4 the
# deepest leaf read 3.11 (0.46 against the plain run's 0.148), so 8.  And
# at the depths in MOE_TRAIN_ABSOLUTE every leaf within TOL_TRAIN_GRAD_REL
# and every expert's slice within TOL_MOE_EXPERT_GRAD_REL of the plain
# versions'.
MOE_TRAIN_ABSOLUTE = (2,)
TOL_MOE_EXACT_RATIO = {2: TOL_TRAIN_EXACT_RATIO, 4: 8.0}
# 26c: deepseek-moe-16b cut to 1 dense + 3 MoE layers (full width), fp32
# master weights, bf16 compute, AdamW, remat "full": MOE_TRAIN_STEPS steps
# of MOE_TRAIN_BATCH x TRAIN_SEQ tokens in MOE_TRAIN_ACCUM microbatches
# (xlstm's recipe in 24c).
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_ACCUM = 3, 4, 4
# Phase 27: qwen2-vl-72b (M-RoPE, qkv bias, theta 1e6) at full width, its
# 80 layers cut to 24 (42.1 GB of bf16 products; all 80 are ~140 GB).  A
# model call makes 7 products a layer (wgmma) and the fp32 LM head (FMA);
# K2 takes every prefill chunk's layers, K1 every decode step's (G = 8,
# D = 128: the split body).  27b: phase 6's fp32 path check at depths 1, 2
# and 4, and a prefill whose position streams differ (``streams_check``).
VLM_LAYERS = 24
VLM_KV_BYTES = 2 * VLM_LAYERS * 8 * 128 * 2               # K and V, bf16, a token
VLM_PATH_DEPTHS = (1, 2, 4)
# 27b and 28b hold three requests (token seeds PATH_SEEDS) at each depth,
# {depth: (kernels-vs-plain rel or None, ratio)}: the kernels' logits
# within rel of the plain versions' and no farther from an exact-products
# run than ratio times the plain run.  Phase 6's limits (qwen2.5-3b's) do
# not fit these widths; these were set from a run of these three requests
# with the gates open (NVIDIA H100 80GB HBM3, 700.00 W).  qwen2-vl: the
# kernels vs the plain versions read up to 1.6e-5 / 5.1e-4 / 6.5e-2 at
# depths 1 / 2 / 4 (two plain runs apart only in the KV tile: up to
# 1.0e-5 / 1.9e-4 / 2.5e-3), the ratio up to 1.57 / 2.77 (the streams
# prefill) / 5.24: at depth 1 the kernels' fp32 path (K7's FMA body sums
# K = 8192 and 29568) sits 1.4-1.6x as far from the exact products as the
# plain versions' on each request, and each layer of the near-one-hot
# attention amplifies the two runs' rounding by chance, one more than the
# other.  whisper-medium: up to 3.2e-5 / 2.5e-3 /
# 0.59, two plain runs up to 4.0e-6 / 3.0e-4 / 0.18 -- at depth 4 the random
# model is chaotic, so the rel is printed, not gated -- and the ratio up to
# 1.08 / 1.23 / 0.96.  A broken kernel moves a logit by O(1) at depth 1
# (``kernel_gate_check.py``'s mutants fail their gates by 100-40000x).
PATH_SEEDS = (1, 11, 21)
VLM_PATH_LIMITS = {1: (1e-4, 2.0), 2: (2e-3, 4.0), 4: (2e-1, 8.0)}
WHISPER_PATH_LIMITS = {1: (2e-4, 2.0), 2: (1e-2, 2.0), 4: (None, 2.0)}
# Phase 28: whisper-medium at its full config (24 + 24 layers, d_model
# 1024, 16 heads of 64, 1500 encoder frames).  28a: K4 non-causal at the
# encoder's S = S_kv = 1500, the cross-attention's S = 192 queries against
# S_kv = 1500 and a ragged 1037 rows, one query row, and S_kv one row past
# 1500; H = K = 16, D = 64, B = 1.  K3 at the cross-attention's decode
# shape, B = 4 slots against 1500 rows each, and at ragged lengths.
WHISPER_K4_CASES = ((1500, 1500), (192, 1500), (192, 1037), (1, 1500), (300, 1501))
WHISPER_K3_LENGTHS = ((1500, 1500, 1500, 1500), (1500, 1037, 1, 0))
WHISPER_FRAMES, WHISPER_HEADS, WHISPER_D = 1500, 16, 64
# 28b: the fp32 path check of one request (a 100-token decoder prompt and
# one decode step) at (encoder, decoder) depths (1, 1), (2, 2) and (4, 4),
# phase 6's limits by the decoder's depth.  28c: 8 requests of decoder
# prompts drawn in [16, 192] from seed 0, 32 new each, 4 slots, max_len
# 256 (inside Whisper's 448-token decoder context).
WHISPER_PATH_DEPTHS = (1, 2, 4)
WHISPER_PROMPT_RANGE, WHISPER_MAX_LEN = (16, 192), 256
# Phase 29: whisper-medium training.  29a: K4's backward non-causal on
# (S, S_kv, H, K) at D = 64, B = 1: the encoder's 1500 x 1500, the
# cross-attention's 448 decoder rows (the decoder's whole context) against
# 1500 frames and a ragged 1037, one query row, S_kv one row past 1500,
# more queries than keys at G = 1 and at G = 4 (8 query heads on 2).
K4B_WHISPER_CASES = ((1500, 1500, 16, 16), (448, 1500, 16, 16), (448, 1037, 16, 16),
                     (1, 1500, 16, 16), (300, 1501, 16, 16), (70, 33, 16, 16), (70, 33, 8, 2))
WHISPER_DECODER_CONTEXT = 448
# 29b / 30a: the fp32 training path checks, one microbatch (whisper 1 x
# 448 tokens and 1500 frames; qwen2-vl 1 x VLM_CHECK_SEQ, streams 1 and 2
# apart) at TRAIN_PATH_DEPTHS (whisper's encoder and decoder each), three
# seeds for whisper and the first for qwen2-vl (PATH_SEEDS' data draws,
# weights from seed 0; qwen2-vl's other two seeds' 48 s pay for phase
# 32), {depth: (loss,
# rel, ratio)}: the loss within loss of the plain versions' (relative),
# each gradient leaf within rel of the plain versions' largest entry, and
# no farther from an exact-products run than ratio times the plain run
# (floored at 1e-7).  Set from a run of these three seeds with the gates
# open (NVIDIA H100 80GB HBM3, 700.00 W).  whisper-medium read, at depths
# 1 / 2: loss 1.7e-7 / 2.1e-5, leaves 1.05e-3 / 0.213 (the plain run
# itself 7.6e-4 / 0.164 from the exact products: at depth 2 the random
# model's near-one-hot attention already parts two right fp32 paths by a
# fifth), ratio 1.90 / 2.48 (a cross-attention key bias, whose exact
# gradient is zero); qwen2-vl-72b: loss 1.7e-7 / 1.6e-6, leaves 3.4e-4 /
# 8.3e-3, ratio 1.34 / 0.96.  The limits sit ~5x past the leaves read and
# ~1.6x past the ratios; a broken kernel moves a gradient by 250x its
# limit or more (``kernel_gate_check.py``'s mutants).
TRAIN_PATH_DEPTHS = (1, 2)
VLM_CHECK_SEQ = 256
WHISPER_TRAIN_LIMITS = {1: (TOL_TRAIN_LOSS_REL, 5e-3, 3.0), 2: (1e-4, 1.0, 4.0)}
VLM_TRAIN_LIMITS = {1: (TOL_TRAIN_LOSS_REL, 2e-3, 2.0), 2: (TOL_TRAIN_LOSS_REL, 5e-2, 2.0)}
# 29c: whisper-medium at its full config, fp32 master weights, bf16
# compute, remat "full", AdamW: 3 steps of 8 x 448 tokens in 8 microbatches
# (the config's accum_steps).  30b: qwen2-vl-72b at full width cut to 4 of
# its 80 layers (~6.0 B parameters: 22.4 GiB of fp32 weights and as much
# of gradients), Adafactor (its config's; AdamW's two fp32 moments would
# add 44.7 GiB), 3 steps of 4 x TRAIN_SEQ in 4 microbatches.
WHISPER_TRAIN_STEPS, WHISPER_TRAIN_BATCH = 3, 8
VLM_TRAIN_LAYERS, VLM_TRAIN_STEPS, VLM_TRAIN_BATCH = 4, 3, 4
# Phase 31: serving under a device mesh.  31a: K3 with its row log-sum-exp
# (``return_lse``) on LSE_DECODE_CASES, (lengths, S, H, K, D): phase 9's
# DENSE_DECODE_CASES, each with a sequence whose local length is 0 (a shard
# with no live row) and lengths of S and past S, then qwen2.5-3b's heads at
# S = MESH_MAX_LEN (31c's cache) and at 132 rows (one of 8 shards of it).
# fp32 and bf16, both bodies, as made and with NaN in every cache row at or
# past the length, the allocator's free blocks filled with NaN before each
# launch (an m or l left unwritten reads NaN); out, m and l held by
# ``dispatch.lse_tolerance_ratio``.  The fourth case is the timed one.
LSE_DECODE_CASES = (((1033, 700, 257, 1200, 0), ZAMBA_MAX_LEN, 32, 32, 64),
                    ((0, 1, 64, 65, ZAMBA_MAX_LEN), ZAMBA_MAX_LEN, 32, 32, 64),
                    ((999, 1000, 5, 2000, 0), 1000, 32, 32, 64),
                    ((1033, 700, 0, 1056, 1200), 1056, 16, 2, 128),
                    ((132, 0, 200, 57), 132, 16, 2, 128))
# return_lse=False keeps the bits of the build before the LSE was added:
# sha1 over the outputs of LSE_DECODE_CASES in order (as made), by body and
# type, read from that build on an NVIDIA H100 80GB HBM3 (``k3_digests``).
K3_PARENT_BITS = {"fma float32": "5d128f92cbee81ea1f03912eb479ed842d6c04b5",
                  "mma bfloat16": "bef5acbe8976d8eb271aff03a019eae9e17154de",
                  "fma bfloat16": "1e46cf60feec21ea0e4f6deab4ea601f3d3fc474"}
# 31b: the cache of MESH_MAX_LEN rows cut into M contiguous slices, K3 with
# its log-sum-exp on each at the shard's lengths, merged (``merge_lse``):
# held against one K3 call over the whole cache and against the plain
# version, fp32 and bf16.
MESH_MAX_LEN = 1056
MESH_SPLITS = (2, 4, 8)
MESH_SPLIT_LENGTHS = (1033, 700, 0, 1056, 1200, 5)
# 31d: moe_ep at deepseek-moe-16b's MoE widths (d_model 2048, 64 experts of
# d_ff 1408, top-6) on a MOE_EP_ROWS-row prefill chunk, bf16, on a model
# group of 1: the kernels' output within TOL_MOE_EP_REL of the largest of
# the plain versions' (both round each expert product to bf16: a rounding
# that falls otherwise moves a row by 2^-8 of itself, and the SwiGLU carries
# it through one more product); at capacity factor 8 (nothing drops) the
# same against moe_dense through the kernels.
MOE_EP_ROWS = 256
TOL_MOE_EP_REL = 2.0 ** -6
# Phase 32: training under a device mesh.  32a: qwen2.5-3b at full width cut
# to MESH_TRAIN_LAYERS layers, MESH_TRAIN_STEPS steps of MESH_TRAIN_BATCH x
# TRAIN_SEQ in MESH_TRAIN_ACCUM microbatches, with and without a 1 x 1 mesh.
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS, MESH_TRAIN_BATCH, MESH_TRAIN_ACCUM = 4, 2, 4, 2
# 32b: a rank's shapes of qwen2.5-3b on a 1 x 4 mesh, a 2 x 512 microbatch:
# K4 on 16 / 4 query heads against the one of 2 KV heads their group reads
# (B, S, H, K, D); K7 (tag, M, K, N, layout, dtype, the body the route must
# pick): the SwiGLU's ff slice 11008 / 4 = 2752 -- gate / up, down, the
# backward's dX (dY @ W^T, W^T a view) and dW (X^T @ dY, X^T a view) -- and
# the LM head's vocabulary slice 151936 / 4 = 37984 (the tied table's
# slice read transposed in place), bf16 and fp32 (the model's head).
MESH_SHARD_ATTENTION = (2, TRAIN_SEQ, 4, 1, 128)
MESH_SHARD_K7 = (("tp4_ff", 1024, 2048, 2752, "rows", "bfloat16", "wgmma"),
                 ("tp4_ff_down", 1024, 2752, 2048, "rows", "bfloat16", "wgmma"),
                 ("tp4_ff_dx", 1024, 2752, 2048, "y.T", "bfloat16", "wgmma"),
                 ("tp4_ff_dw", 2048, 1024, 2752, "x.T", "bfloat16", "wgmma"),
                 ("tp4_vocab", 1024, 2048, 37984, "y.T", "bfloat16", "wgmma"),
                 ("tp4_vocab", 1024, 2048, 37984, "y.T", "float32", "fma"))
# 32c: moe_ep's output and gradients through the kernels against its plain
# versions and, where nothing drops, moe_einsum's, bf16: TOL_MOE_EP_REL's
# bf16 roundings, and against moe_einsum also its combine weight rounded to
# bf16 first (the reference's einsum in x's type; moe_ep's stays fp32), 2^-9
# of a row more.
TOL_MOE_EP_GRAD_REL = 2.0 ** -6


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
    launcher takes).  ``flush="read"`` flushes L2 by reading the buffer,
    not writing it: a write leaves up to L2's 50 MB of dirty lines for the
    timed call to evict, a read leaves clean ones."""

    SPIN_CYCLES = 10_000_000        # ~5 ms at the H100's ~2 GHz clock

    def __init__(self, torch, reps: int = 20, flush: str = "write"):
        if flush not in ("write", "read"):
            raise ValueError(f"flush {flush!r}: 'write' or 'read'")
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
        self.flush_by_read = flush == "read"

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(self.reps):
            if self.flush_by_read:
                self.flush.sum()
            else:
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


def profile_phase(torch, np, eng, Request, greedy, tag="serving", n=2, new=8, prompt=512):
    """Where the time goes: ``n`` requests of ``prompt`` tokens, ``new`` new
    tokens each, under torch.profiler; device time by kernel name and the
    device's busy share of the wall time (one stream, so kernels do not
    overlap).  Reading the trace back costs ~16x the window, so the window
    is short: 2 requests of 8 new tokens (a window of 4 of 16 took ~70 s
    more of the script's time over phases 4, 4b and 17), and every profile
    of the script records device activity alone: the host ops' records
    are most of what is read back, and nothing here reads them."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    reqs = [Request(200 + i, rng.integers(0, eng.cfg.vocab_size, size=prompt)
                    .astype(np.int32), max_new_tokens=new, sampler=greedy())
            for i in range(n)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
             "matmul_kernel") + (("flash_mma_kernel",) if tag in ("contiguous serving",
                                                                   "whisper serving") else ())}
    log(f"{label}: device ms " + " ".join(f"{n}={v:.3f}" for n, v in mine.items()))
    for ms, count, name in rows[:12]:
        log(f"{label}: {ms:10.3f} ms  {count:6d} calls  {name[:90]}")


def path_check(torch, np, contiguous=False, arch="qwen2.5-3b", depths=(1, 2, 4, 36),
               limits=None, seeds=(1,), layers=None):
    """One 300-token request (a 256-row prefill chunk, then 44 rows seeded
    past it, then one decode step) served at full width in fp32 by a
    ``ServingEngine`` through the kernels and by one through the plain
    versions (``dispatch.plain_versions()``), at ``depths`` (qwen2.5-3b's
    1, 2, 4 and 36; ``arch`` qwen2-vl-72b at 1, 2 and 4, phase 27b, its
    weights drawn for ``layers`` layers, not its 80).  ``contiguous`` (phase 17): the
    same request through the contiguous engine (the whole prompt prefilled
    through K4, the decode step through K3), gated as phase 6.
    The request's sampler records the prefill and the decode logits and
    answers a fixed token, so both engines decode the same token.

    Depths 1, 2 and 4 are gated (``TOL_PATH_REL``, ``TOL_PATH_EXACT_RATIO``;
    ``limits``, {depth: (rel or None, ratio)}, another config's own, and
    ``seeds``, the request's token draws, each held).  The reference's
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
    gated.  Under M-RoPE (qwen2-vl) one ``transformer.prefill`` call more,
    at depth 2, whose position streams 1 and 2 differ from stream 0, is
    held to the same gate (:func:`streams_check`)."""
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
    full = arch_registry.config(arch).replace(compute_dtype="float32")
    full = full.replace(num_layers=layers or full.num_layers)
    params = fns_for(full).init(full, torch.Generator("cuda").manual_seed(0))
    limits = limits or PATH_LIMITS

    engine_kw = (dict(paged=False) if contiguous else dict(prefill_chunk=256))
    kernels = ("flash_attention", "decode_attention") if contiguous else LM_KERNELS
    label = ("contiguous path check" if contiguous else "path check") \
        + ("" if arch == "qwen2.5-3b" else f" ({arch})")

    def serve(cfg, p, toks, chunk=512):
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

    for seed, depth in ((s, d) for s in seeds for d in depths):
        toks = np.random.default_rng(seed).integers(0, full.vocab_size,
                                                    size=300).astype(np.int32)
        cfg = full.replace(num_layers=depth)
        p = dict(params, blocks=tree_map(lambda t: t[:depth], params["blocks"]))
        dispatch.reset_counts()
        kern = serve(cfg, p, toks)
        table = dispatch.kernel_table()
        launched = all(table[n].launches > 0 for n in kernels + ("matmul",)) and \
            not any(k.plain_calls for k in table.values())
        if contiguous:      # and no paged kernel
            launched = launched and not any(table[n].launches for n in LM_KERNELS)
        exact_product = lambda x, y: (x.double() @ y.double()).to(x.dtype)   # noqa: E731
        with dispatch.plain_versions():
            plain = serve(cfg, p, toks)
            plain64 = serve(cfg, p, toks, chunk=64)
            with mock.patch.object(linear, "_k7", exact_product):
                exact = serve(cfg, p, toks)
        tol, max_ratio = limits.get(depth, (None, None))
        r_pre, r_dec = rel(kern[0], plain[0]), rel(kern[1], plain[1])
        to_exact = [(rel(kern[i], exact[i]), rel(plain[i], exact[i])) for i in (0, 1)]
        ratio = max(k / max(p, 1e-7) for k, p in to_exact)
        log(f"{label} (fp32, full width, depth {depth}, request seed {seed}): kernels vs "
            f"plain rel prefill={r_pre:.3e} decode={r_dec:.3e} "
            f"top1_agree={bool((kern.argmax(-1) == plain.argmax(-1)).all())} "
            + (f"(tol {tol}); " if tol else "(not gated); ")
            + f"plain chunk 64 vs 512 rel prefill={rel(plain64[0], plain[0]):.3e} "
            f"decode={rel(plain64[1], plain[1]):.3e} "
            f"top1_agree={bool((plain64.argmax(-1) == plain.argmax(-1)).all())}; "
            f"vs exact products: kernels rel prefill={to_exact[0][0]:.3e} "
            f"decode={to_exact[1][0]:.3e}, plain rel prefill={to_exact[0][1]:.3e} "
            f"decode={to_exact[1][1]:.3e}, worst ratio {ratio:.3f}"
            + (f" (tol {max_ratio})" if max_ratio else ""))
        if not launched:
            raise AssertionError(f"{label}: the kernel engine did not run "
                                 f"through {kernels} and K7 alone")
        if max_ratio and not (np.isfinite(kern).all() and ratio <= max_ratio
                              and (tol is None or max(r_pre, r_dec) <= tol)):
            raise AssertionError(f"{label}, depth {depth}, request seed {seed}: kernels and "
                                 f"plain versions disagree ({r_pre}, {r_dec}; ratio to the "
                                 f"exact products' distance {ratio})")
    if full.m_rope:
        for seed in seeds:
            streams_check(torch, np, full.replace(num_layers=2),
                          dict(params, blocks=tree_map(lambda t: t[:2], params["blocks"])),
                          rel, limits[2], seed + 4)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def streams_check(torch, np, cfg, params, rel, limit, seed) -> None:
    """Phase 27b's M-RoPE call: ``transformer.prefill`` of a 300-token
    prompt at ``cfg``'s depth (2), fp32, whose position streams 1 and 2
    differ from stream 0 (each row's index, as K4 masks): last-position
    logits through the kernels (K4 and K7) vs the plain versions, within
    ``limit`` (rel, ratio), the path check's at that depth: the kernels no
    farther from an exact-products run than ratio times the plain run.
    ``seed`` draws the tokens and streams 1 and 2."""
    from unittest import mock

    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
    from repro_torch.models.layers import linear
    rng = np.random.default_rng(seed)
    S = 300
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)), dtype=torch.int32,
                        device="cuda")
    pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(3, 1, S).clone()
    pos[1:] = torch.tensor(rng.integers(0, 4 * S, (2, 1, S)), dtype=torch.int32,
                           device="cuda")

    def run():
        return transformer.prefill(cfg, params, toks, pos)[0].cpu().numpy()
    dispatch.reset_counts()
    kern = run()
    table = dispatch.kernel_table()
    launched = {n: table[n].launches for n in ("flash_attention", "matmul")}
    exact_product = lambda x, y: (x.double() @ y.double()).to(x.dtype)   # noqa: E731
    with dispatch.plain_versions():
        plain = run()
        with mock.patch.object(linear, "_k7", exact_product):
            exact = run()
    r, (tol, max_ratio) = rel(kern, plain), limit
    ratio = rel(kern, exact) / max(rel(plain, exact), 1e-7)
    want = {"flash_attention": cfg.num_layers, "matmul": QWEN_PRODUCTS * cfg.num_layers + 1}
    log(f"vlm path check: transformer.prefill at depth {cfg.num_layers}, fp32, streams 1 and "
        f"2 apart from stream 0 (seed {seed}): kernels vs plain rel {r:.3e} (tol {tol}); vs "
        f"exact products: kernels {rel(kern, exact):.3e}, plain {rel(plain, exact):.3e}, "
        f"ratio {ratio:.3f} (tol {max_ratio}); launches {launched} (expected {want})")
    if launched != want or not (np.isfinite(kern).all() and r <= tol
                                and ratio <= max_ratio):
        raise AssertionError(f"vlm path check, differing streams: rel {r}, ratio {ratio}, "
                             f"launches {launched}")


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


def ssm_work(S, *, B=1, H=64, N=64, P=64, chunk=128, in_bytes=2, shared=True):
    """(bytes, flops) K5 must move and do: q and k (their shared (B, S, N)
    base, or per head), v, decay and gate read once, y and the final state
    written once; per chunk of n live rows the causal QK^T and (QK^T.W)V,
    q.H_prev and the state update, two flops a multiply-add."""
    qk = 2 * B * S * N * (1 if shared else H)
    nbytes = in_bytes * (qk + B * S * H * P) + 4 * (2 * B * S * H + B * S * H * P
                                                   + B * H * N * P)
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    # attention: K4 a layer and again in the recompute, its backward kernel
    # a layer (bf16, D = 128: both on mma)
    micro = accum * TRAIN_STEPS
    want_k4 = {"flash_attention": {"mma": 2 * L * micro},
               "flash_attention_backward": {"mma": L * micro}}
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    stealing on) on phase 4's requests.  Gated: every request DONE, 256
    tokens delivered; ``FLEET_AFFINITY`` exactly; K1 / K2 / K7 launches
    exact by body from both engines' calls, no plain call, model calls on
    the two executor threads only; both pools leak-free.  Printed beside
    phase 4's: tok/s, TTFT, TPOT, steals, the busy share of a profiled
    window, peak memory; greedy tokens equal to phase 4's (not gated).  One
    engine behind a one-replica router is not run here: phase 19c serves
    the same requests on one engine in service mode, on one executor
    thread.
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


def attention_backward_work(B, S, H, K, D, elem, S_kv=None) -> tuple[float, float, float]:
    """(bytes, flops, the FMA body's flops) of K4's backward: q, out, dout
    and dq (B, S, H, D), k, v, dk and dv (B, S_kv, K, D) once each, the
    fp32 lse; the least work is five products over the pairs a row sees (S
    recomputed, dV, dP, dQ, dK), the FMA body does seven (S and dP in each
    of its two passes).  The pairs are the causal half of S x S where
    ``S_kv`` is None, else every one of the S x S_kv (non-causal)."""
    pairs = (B * S * (S + 1) // 2 if S_kv is None else B * S * S_kv) * H * D
    S_kv = S if S_kv is None else S_kv
    return (elem * (4 * B * S * H * D + 4 * B * S_kv * K * D) + 4 * B * H * S, 10 * pairs,
            14 * pairs)


def attention_backward_phase(torch, table) -> dict:
    """Phase 21a: K4 with its log-sum-exp, then its backward kernel, each
    against its plain version evaluated in fp32 on the same values, on
    ``K4_BWD_CASES``: the backward on the body its route picks
    (``backward_body_for``: bf16 at D 64 / 128 on "mma", P and dS carried
    as bf16 hi + lo pairs; fp32 on "fma"), each bf16 case on "fma" too,
    every ratio printed, and the route's body launched twice for the same
    bits.  Then both bodies timed at qwen2.5-3b's and zamba2's training
    shapes beside the plain version, SDPA's backward (autograd of
    ``scaled_dot_product_attention`` on the same tensors, measured only)
    and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.dispatch import GRAD_RTOL
    from repro_torch.kernels.flash_attention.ops import backward_body_for
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
        args = (q, k, v, out, do, lse)
        route = backward_body_for(q)
        for body in dict.fromkeys((route, "fma")):
            errs.setdefault((dtype, body), []).append(
                hold(torch, bwd, args, f"{label} body={body}", causal=True, body=body))
        first = bwd.launch(*args, causal=True)
        again = bwd.launch(*args, causal=True)
        torch.cuda.synchronize()
        if not all(torch.equal(u, w) for u, w in zip(first, again)):
            raise AssertionError(f"flash_attention_backward {label} body={route}: two "
                                 f"launches differ")
    out_r = {}
    for (B, S, H, K, D), key in (((1, TRAIN_SEQ, 16, 2, 128), "qwen"),
                                 ((1, TRAIN_SEQ, 32, 32, 64), "zamba2")):
        q, k, v, do = attention_grad_case(torch, B, S, H, K, D, torch.bfloat16)
        out, lse = fwd.launch(q, k, v, causal=True, with_lse=True)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        y = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=H != K)
        dyh = do.transpose(1, 2).contiguous()
        nbytes, flops, fma_flops = attention_backward_work(B, S, H, K, D, 2)
        args = (q, k, v, out, do, lse)
        r = dict(ms=timer(lambda: bwd.launch(*args, causal=True)),
                 fma_ms=timer(lambda: bwd.launch(*args, causal=True, body="fma")),
                 plain_ms=timer(lambda: bwd.plain(*args, causal=True)),
                 library_ms=timer(lambda: torch.autograd.grad(y, (qh, kh, vh), dyh,
                                                              retain_graph=True)),
                 bytes=nbytes, flops=flops,
                 fp32_rate_bound_ms=bound(nbytes, fma_flops, FP32_FLOPS)[0],
                 shape=f"B={B} S={S} H={H} K={K} D={D} causal bf16 "
                       f"body={backward_body_for(q)}")
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
        log(f"flash_attention_backward timed {r['shape']}: mma body {r['ms']:.4f}ms fma body "
            f"{r['fma_ms']:.4f}ms plain {r['plain_ms']:.4f}ms SDPA backward "
            f"{r['library_ms']:.4f}ms (mma / SDPA {r['ms'] / r['library_ms']:.2f}, fma / SDPA "
            f"{r['fma_ms'] / r['library_ms']:.2f}) bound {r['bound_ms']:.5f}ms "
            f"({r['bound_by']}; {nbytes} B, {flops} flop; the FMA body's own at 67 TFLOP/s "
            f"fp32 {r['fp32_rate_bound_ms']:.4f}ms)")
        out_r[key] = r
        del y, qh, kh, vh
    r = out_r["qwen"]
    r["max_abs_err"] = max(errs[(torch.bfloat16, "mma")])
    r["max_abs_err_bf16_fma"] = max(errs[(torch.bfloat16, "fma")])
    r["max_abs_err_fp32"] = max(errs[(torch.float32, "fma")])
    return {"flash_attention_backward": r}


def scan_backward_work(S, *, B=1, H=64, N=64, P=64, chunk=128, elem=2,
                       shared=True) -> tuple:
    """(bytes, flops) of K5's backward: q and k (``shared``: their one
    (B, S, N) base each, Mamba-2's B and C as stride-0 head views; else
    (B, S, H, N) each, xlstm's per-head q and k), v, the decay, gate and dy
    read once; dq, dk (B, S, H, N), dv, the decay's and gate's gradients
    written once.  Per chunk of n live rows, the least products: the causal
    q.k and dy.v recomputed, dA K, dA^T Q and (QK^T o W)^T dY (n(n+1)/2
    terms of N or P each), and the chunk sums S_c, U_c, H_{c-1} dy, G_c v
    and G_c^T k (n N P each); two flops a multiply-add."""
    qk = 2 * B * S * N * (1 if shared else H)
    nbytes = elem * (qk + 2 * B * S * H * N + 2 * B * S * H * P) + 4 * (
        4 * B * S * H + B * S * H * P)
    flops = 0
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        flops += 2 * B * H * (n * (n + 1) // 2 * (3 * N + 2 * P) + 5 * n * N * P)
    return nbytes, flops


def pass_times(torch, fn, passes, reps: int = 10) -> dict[str, float]:
    """Device ms of each of a kernel's ``passes`` (its launches, in order):
    ``fn(n)`` runs the launches up to pass n and stops (K5's backward's
    ``last_pass``).  Each n = 1 .. len(passes) is timed with CUDA events,
    ``reps`` calls, the L2 flushed before each (:class:`Timer`), and each
    pass's time is the difference of neighbouring runs
    (:func:`pass_deltas`).  No profiler: late in the whole script it lost
    some or all of these launches."""
    timer = Timer(torch, reps=reps)
    rows = [(n, timer(lambda n=n: fn(n))) for n in range(1, len(passes) + 1)]
    return pass_deltas(rows, passes)


def pass_deltas(rows, passes) -> dict[str, float]:
    """``rows``: (n, ms of the run that stops after pass n), in any order,
    for n = 1 .. k -> {name of pass n: its ms less pass n - 1's} in pass
    order (pass 1: its own ms); no rows, {}.  A gap in n raises: the
    difference would charge two passes to one."""
    cum = dict(rows)
    if sorted(cum) != list(range(1, len(cum) + 1)) or len(cum) > len(passes):
        raise ValueError(f"runs stopped after passes {sorted(cum)}: want 1 .. k of "
                         f"{len(passes)}")
    out, before = {}, 0.0
    for n in sorted(cum):
        out[passes[n - 1]] = cum[n] - before
        before = cum[n]
    return out


def launch_times(t: dict) -> str:
    """:func:`pass_times`' result as a line: each pass's ms and their sum,
    or "none" for a kernel of no passes."""
    if not t:
        return "none"
    return (", ".join(f"{name} {ms:.4f}ms" for name, ms in t.items())
            + f"; sum {sum(t.values()):.4f}ms")


def scan_backward_phase(torch, table) -> dict:
    """Phase 21b: K5's backward against its plain version evaluated in fp32
    on the same values, on ``K5_BWD_CASES`` (B and C as stride-0 head
    views): each case on the body its route picks (``backward_body_for``:
    bf16 at N = P 64 on "mma", the fp32 operands as bf16 hi + lo pairs;
    fp32 on "fma"), each bf16 case on "fma" too, the route's body launched
    twice for the same bits.  Then both bodies timed at zamba2-1.2b's
    training shape beside the plain version and the bound (no library call
    computes it), and each body's five passes timed apart
    (:func:`pass_times`)."""
    from repro_torch.kernels.dispatch import GRAD_RTOL
    from repro_torch.kernels.ssm_scan.ops import backward_body_for, backward_passes
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
        route = backward_body_for(*args[:3])
        for body in dict.fromkeys((route, "fma")):
            errs.setdefault((dtype, body), []).append(
                hold(torch, bwd, (*args, dy, df), f"{label} body={body}", body=body,
                     chunk=128, initial_state=h0))
        first = bwd.launch(*args, dy, df, chunk=128, initial_state=h0)
        again = bwd.launch(*args, dy, df, chunk=128, initial_state=h0)
        torch.cuda.synchronize()
        if not all(torch.equal(u, w) for u, w in zip(first, again) if u is not None):
            raise AssertionError(f"ssm_scan_backward {label} body={route}: two launches "
                                 f"differ")
        log(f"ssm_scan_backward {label} body={route}: two launches give the same bits")
    args, _ = ssm_case(torch, TRAIN_SEQ, torch.bfloat16)
    dy = torch.randn((1, TRAIN_SEQ, 64, 64), device="cuda")
    nbytes, flops = scan_backward_work(TRAIN_SEQ)
    route = backward_body_for(*args[:3])
    r = dict(ms=timer(lambda: bwd.launch(*args, dy, chunk=128)),
             fma_ms=timer(lambda: bwd.launch(*args, dy, chunk=128, body="fma")),
             plain_ms=timer(lambda: bwd.plain(*args, dy, chunk=128)), library_ms=None,
             bytes=nbytes, flops=flops,
             shape=f"B=1 S={TRAIN_SEQ} H=64 N=P=64 chunk 128, bf16 q/k/v (B and C "
                   f"stride-0 head views), fp32 dy, body={route} (the fma body beside it; "
                   f"one Mamba layer)")
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
    r["fp32_rate_bound_ms"] = bound(nbytes, flops, FP32_FLOPS)[0]
    log(f"ssm_scan_backward timed {r['shape']}: {route} body {r['ms']:.4f}ms fma body "
        f"{r['fma_ms']:.4f}ms plain {r['plain_ms']:.4f}ms bound {r['bound_ms']:.5f}ms "
        f"({r['bound_by']}, tensor cores; {nbytes} B, {flops} flop; the fma body's own at "
        f"67 TFLOP/s fp32 {r['fp32_rate_bound_ms']:.4f}ms)")
    for body in dict.fromkeys((route, "fma")):
        t = pass_times(torch, lambda n: bwd.launch(*args, dy, chunk=128, body=body, last_pass=n),
                       backward_passes(body, 64, 64))
        log(f"ssm_scan_backward {body} body by pass ({PASS_TIMING}): {launch_times(t)}")
    r["max_abs_err"] = max(errs[(torch.bfloat16, route)])
    r["max_abs_err_bf16_fma"] = max(errs[(torch.bfloat16, "fma")])
    r["max_abs_err_fp32"] = max(errs[(torch.float32, "fma")])
    return {"ssm_scan_backward": r}


def zamba_counts(cfg, micro: int) -> dict:
    """Launches by body of ``micro`` microbatches of zamba2 training under
    remat "full", from the config: K5 once a Mamba layer and again in the
    recompute of each checkpointed segment (the tail is not checkpointed),
    K4 once a shared-block application and again in its recompute, each
    backward once; K7 for every weight product, again in the recompute and
    twice in the backward (dX, dW).  bf16 compute puts K5 and K4 on their
    tensor-core bodies (both backward kernels too) and every block product on
    wgmma, the fp32 LM head (forward, dX, dW) on FMA; fp32 compute puts
    everything on FMA."""
    from repro_torch.models.hybrid import _segments
    n_seg, e, tail = _segments(cfg)
    layers = n_seg * e + tail
    fwd = MAMBA_PRODUCTS * layers + SHARED_PRODUCTS * n_seg + 1
    again = MAMBA_PRODUCTS * n_seg * e + SHARED_PRODUCTS * n_seg
    products = fwd + again + 2 * fwd
    bf16 = cfg.compute_dtype == "bfloat16"
    tc = "mma" if bf16 else "fma"
    return {"ssm_scan": {tc: (layers + n_seg * e) * micro},
            "ssm_scan_backward": {tc: layers * micro},
            "flash_attention": {tc: 2 * n_seg * micro},
            "flash_attention_backward": {tc: n_seg * micro},
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    bc = b.to(x.dtype).requires_grad_(True)   # cuDNN takes the bias in x's type
    y = F.conv2d(xc, wc, bc, stride=stride, padding=(pt, pl))
    dyc = dy.permute(0, 3, 1, 2).contiguous()
    inputs = (xc, wc, bc) if need_dx else (wc, bc)
    return lambda: torch.autograd.grad(y, inputs, dyc, retain_graph=True)


def conv_backward_phase(torch, table) -> dict:
    """Phase 22a: K6's backward against its plain version evaluated in fp32
    on the same values (``dispatch.grad_tolerance_ratio``) on every distinct
    conv shape of GoogLeNet's batch-8 forward at 224 and on
    ``CONV_BWD_EXTRA``, at fp32 and fp16, each pass on the body its route
    picks (``backward_body_for``); a case whose dgrad or wgrad splits K is
    launched twice and must give the same bits.  Then one batch-8 backward
    of the 57 convolutions (dx for every conv but stem1, as training asks)
    timed at fp32 beside its plain version, cuDNN's backward (measured,
    never used) and its bound, and at fp16 beside cuDNN's fp16 backward
    and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d.ops import backward_body_for, backward_splits
    from repro_torch.kernels.dispatch import GRAD_RTOL
    bwd = table["conv2d_backward"]
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: full fp32 products
    torch.backends.cudnn.allow_tf32 = False         # cuDNN at fp32: no TF32
    groups = conv_groups()
    cases = [(xs, ws, stride, names[0], names[0] != "stem1")
             for (xs, ws, stride), names in groups.items()]
    cases += [(xs, ws, stride, "extra", True) for xs, ws, stride in CONV_BWD_EXTRA]
    errs, split, served = {}, 0, {}
    for dtype in (torch.float32, torch.float16):
        for xs, ws, stride, name, need_dx in cases:
            x, w, b = conv_case(torch, xs, ws, dtype)
            dy = conv_grad_out(torch, xs, ws, stride, dtype)
            bodies = backward_body_for(x, w, dy, stride)
            sp = backward_splits(xs, ws, stride, bodies)
            label = (f"{name} x{xs} w{ws} /{stride} dx={need_dx} bodies (dgrad, wgrad) "
                     f"{bodies} K slices {sp} (limit {GRAD_RTOL[dtype]:.2e} of each "
                     f"gradient's max|ref|)")
            errs[dtype] = max(errs.get(dtype, 0.0), hold(
                torch, bwd, (x, w, b, dy), label, stride=stride, need_dx=need_dx))
            for tag in ([f"dgrad_{bodies[0]}"] if need_dx else []) + [f"wgrad_{bodies[1]}"]:
                served[tag] = served.get(tag, 0) + 1
            if max(sp) > 1:     # deterministic: the partials summed in slice order
                split += 1
                first = bwd.launch(x, w, b, dy, stride=stride, need_dx=need_dx)
                again = bwd.launch(x, w, b, dy, stride=stride, need_dx=need_dx)
                torch.cuda.synchronize()
                if not all(torch.equal(u, v) for u, v in zip(first, again) if u is not None):
                    raise AssertionError(f"conv2d_backward {label}: two launches differ")
    log(f"conv2d_backward: {2 * len(cases)} cases held, passes by body {served}, {split} of "
        f"them split and launched twice for the same bits")
    timer = Timer(torch, reps=10)
    tots = {}
    for dtype, elem, peak in ((torch.float32, 4, FP32_FLOPS), (torch.float16, 2, BF16_FLOPS)):
        tot = tots[dtype] = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
        tag = str(dtype)[6:]
        for (xs, ws, stride), names in groups.items():
            need_dx = names[0] != "stem1"
            x, w, b = conv_case(torch, xs, ws, dtype)
            dy = conv_grad_out(torch, xs, ws, stride, dtype)
            bodies = backward_body_for(x, w, dy, stride)
            n = len(names)
            ms = timer(lambda: bwd.launch(x, w, b, dy, stride=stride, need_dx=need_dx))
            plain_ms = (timer(lambda: bwd.plain(x, w, b, dy, stride=stride, need_dx=need_dx))
                        if dtype == torch.float32 else 0.0)
            lib_ms = timer(library_conv_backward(torch, F, x, w, b, dy, stride, need_dx))
            nbytes, flops = conv_backward_work(xs, ws, stride, need_dx, elem)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bytes", nbytes), ("flops", flops)):
                tot[key] += n * v
            log(f"conv2d_backward {tag} {','.join(names)}: x{xs} w{ws} /{stride} dx={need_dx} "
                f"bodies {bodies} K slices {backward_splits(xs, ws, stride, bodies)} kernel "
                f"{ms:.4f}ms" + (f" plain {plain_ms:.4f}ms" if plain_ms else "")
                + f" cuDNN {lib_ms:.4f}ms bound {bound(nbytes, flops, peak)[0]:.5f}ms "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
        tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["flops"], peak)
        log(f"conv2d_backward {tag}, the 57 convs of one batch-{CONV_BATCH} backward at "
            f"{CONV_SIZE} (dgrad 56, wgrad 57): kernel {tot['ms']:.4f}ms"
            + (f" plain {tot['plain_ms']:.4f}ms" if tot["plain_ms"] else "")
            + f" cuDNN {tot['library_ms']:.4f}ms (kernel / cuDNN "
            f"{tot['ms'] / tot['library_ms']:.2f}) bound {tot['bound_ms']:.4f}ms "
            f"({tot['bound_by']}; {tot['flops'] / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s, "
            f"{tot['bytes'] / 1e6:.1f} MB at 3.35 TB/s; {tot['flops'] / tot['ms'] / 1e9:.1f} "
            f"TFLOP/s)")
    tot, half = tots[torch.float32], tots[torch.float16]
    return {"conv2d_backward": dict(
        tot, max_abs_err=errs[torch.float32], max_abs_err_fp16=errs[torch.float16],
        fp16_ms=half["ms"], fp16_library_ms=half["library_ms"],
        fp16_bound_ms=half["bound_ms"],
        shape=f"the 57 convs of GoogLeNet's backward, batch {CONV_BATCH} at {CONV_SIZE}, "
              f"fp32, bodies dgrad_fma 56, wgrad_fma 57 (fp16: dgrad_mma, wgrad_mma)")}


def googlenet_counts(micro: int) -> dict:
    """Launches by body of ``micro`` fp32 GoogLeNet training microbatches:
    K6 once a conv (FMA), its backward's wgrad once a conv and dgrad once a
    conv but stem1 (the images need no gradient), both on the fp32 ring
    body (every dgrad asked for is at stride 1, every Cout a multiple of 4),
    K7 for the classifier's forward, dX and dW (FMA)."""
    return {"conv2d": {"fma": 57 * micro},
            "conv2d_backward": {"dgrad_fma": 56 * micro, "wgrad_fma": 57 * micro},
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        tr._step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    if not busy:
        raise AssertionError("googlenet training profile: the profiler saw no device time")
    by = {"K6 conv2d": ("conv2d_fma", "conv2d_mma", "conv2d_reduce"),
          "K6 backward": ("conv_dgrad", "conv_wgrad", "conv_bwd_"),
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
            "flash_attention_backward": {"mma": L * micro}}
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


def mlstm_case(torch, S, dtype, *, B=1, H=XLSTM_H, N=XLSTM_N, with_state=False, seed=0):
    """mLSTM-like scan operands at xlstm-125m's widths
    (``repro_torch/models/layers/xlstm.py``): q, k per head, k / sqrt(N);
    v with the normalizer's ones column (P = N + 1); log forget gates
    log_sigmoid of N(0, 1) plus the bias's linspace [3, 6]; log input gates
    N(0, 1) clipped to [-30, 15]; an fp32 initial state when asked."""
    import torch.nn.functional as F
    g = torch.Generator("cuda").manual_seed(seed)
    q = torch.randn((B, S, H, N), generator=g, device="cuda")
    k = torch.randn((B, S, H, N), generator=g, device="cuda") / N ** 0.5
    v = torch.cat([torch.randn((B, S, H, N), generator=g, device="cuda"),
                   torch.ones((B, S, H, 1), device="cuda")], dim=-1)
    f = torch.randn((B, S, H), generator=g, device="cuda") + torch.linspace(
        3.0, 6.0, H, device="cuda")
    log_i = torch.randn((B, S, H), generator=g, device="cuda").clamp(-30.0, 15.0)
    h0 = (torch.randn((B, H, N, N + 1), generator=g, device="cuda") if with_state
          else None)
    return (q.to(dtype), k.to(dtype), v.to(dtype), F.logsigmoid(f), log_i), h0


def xlstm_kernel_phase(torch, table) -> dict:
    """Phase 23a: K5 at xlstm-125m's mLSTM widths (B=1, H=4, N=384, P=385,
    per-head q/k, chunk 128) on the body its route takes (FMA, N staged in
    slices of 64) against the plain version, fp32 and bf16, each case
    launched twice for the same bits; then the prefill shape timed in bf16
    beside the plain version and its bound, and the sLSTM's recurrent
    product both ways (:func:`slstm_product_timing`)."""
    from repro_torch.kernels.dispatch import SSM_RTOL
    from repro_torch.kernels.ssm_scan.ops import body_for as ssm_body_for
    ssm = table["ssm_scan"]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        e = []
        for S, with_state in XLSTM_SCAN_CASES:
            args, h0 = mlstm_case(torch, S, dtype, with_state=with_state, seed=S)
            route = ssm_body_for(*args[:3])
            if route != "fma":
                raise AssertionError(f"ssm_scan at xlstm's widths, S={S} {dtype}: route "
                                     f"{route}, expected fma")
            label = (f"B=1 S={S} H={XLSTM_H} N={XLSTM_N} P={XLSTM_P} per-head q/k "
                     f"h0={with_state} (limit {SSM_RTOL} of max|ref|) body=fma")
            e.append(hold(torch, ssm, args, label, chunk=128, initial_state=h0))
            twice = [ssm.launch(*args, chunk=128, initial_state=h0) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*twice)):
                raise AssertionError(f"ssm_scan {label}: two launches of the FMA body "
                                     f"differ")
        log(f"ssm_scan fma at xlstm's widths {str(dtype)[6:]}: {len(XLSTM_SCAN_CASES)} cases "
            f"held, each launched twice for the same bits")
        errs[dtype] = max(e)
    timer = Timer(torch)
    args, _ = mlstm_case(torch, 1000, torch.bfloat16)
    nbytes, flops = ssm_work(1000, H=XLSTM_H, N=XLSTM_N, P=XLSTM_P, shared=False)
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
    shape = (f"B=1 S=1000 H={XLSTM_H} N={XLSTM_N} P={XLSTM_P} per-head q/k chunk 128, bf16 "
             f"in, fp32 out (one xlstm-125m mLSTM prefill) body={ssm_body_for(*args[:3])}")
    out = dict(xlstm_ms=timer(lambda: ssm.launch(*args, chunk=128)),
               xlstm_plain_ms=timer(lambda: ssm.plain(*args, chunk=128)),
               xlstm_bound_ms=bound_ms, xlstm_bound_by=bound_by,
               xlstm_fp32_bound_ms=bound(nbytes, flops, FP32_FLOPS)[0], xlstm_shape=shape,
               max_abs_err_xlstm=errs[torch.bfloat16],
               max_abs_err_xlstm_fp32=errs[torch.float32])
    log(f"ssm_scan timed {shape}: kernel {out['xlstm_ms']:.4f}ms plain "
        f"{out['xlstm_plain_ms']:.4f}ms library none bound {bound_ms:.5f}ms ({bound_by}; "
        f"{nbytes} B, {flops} flop; at the fp32 rate {out['xlstm_fp32_bound_ms']:.4f}ms)")
    host_us_, wall_us = host_us(torch, lambda: ssm.launch(*args, chunk=128))
    log(f"ssm_scan host per call, {shape}, {HOST_REPS} back to back: host "
        f"{host_us_:.2f} us wall {wall_us:.2f} us")
    slstm_product_timing(torch)
    return out


def slstm_product_timing(torch, steps=300) -> None:
    """Not gated: the sLSTM's head-block-diagonal recurrent product h_{t-1}
    @ r at xlstm-125m's widths (H = 4 heads of 192, fp32) two ways -- one
    K7 launch on the block-diagonal (768, 3072) weight, as the port makes
    it, and one launch a head on its (192, 768) block, the heads' outputs
    laid out as (M, 4, 768) -- at M = 1 (a prefill's step) and M = 4 (a
    decode step over 4 slots): the time a token of ``steps`` products
    issued back to back, between two CUDA events (the host's pace where it
    is the slower), and the wall time of a
    ``steps``-token loop of sLSTM cell steps (``xlstm._slstm_cell``), each
    step's product feeding the next, as a prefill issues them; every
    product through ``linear.matmul``, as the model calls K7.  The two
    give the same bits (the zeros add exactly)."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.models.layers import xlstm
    from repro_torch.models.layers.linear import matmul
    cfg = arch_registry.config("xlstm-125m")
    H, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    g = torch.Generator("cuda").manual_seed(4)
    r = 0.02 * torch.randn((H, dh, 4, dh), generator=g, device="cuda")
    r_bd = xlstm.recurrent_weight(r)
    r_h = [r[i].reshape(dh, 4 * dh) for i in range(H)]

    def diagonal(h):
        return matmul(h, r_bd).reshape(h.shape[0], 4, H * dh)

    def per_head(h):
        outs = [matmul(h[:, i * dh:(i + 1) * dh], r_h[i]) for i in range(H)]
        return torch.stack(outs, 1).reshape(h.shape[0], H, 4, dh).transpose(1, 2) \
            .reshape(h.shape[0], 4, H * dh)

    ways = {"block-diagonal, 1 launch": diagonal, "per head, 4 launches": per_head}
    for M in (1, 4):
        h = torch.randn((M, H * dh), generator=g, device="cuda")
        wx = torch.randn((steps, M, 4, H * dh), generator=g, device="cuda")
        same = torch.equal(diagonal(h), per_head(h))
        for way, product in ways.items():
            product(h)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(steps):
                product(h)
            end.record()
            torch.cuda.synchronize()
            device_us = start.elapsed_time(end) * 1e3 / steps
            st = xlstm.slstm_init_state(cfg, M)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for t in range(steps):
                st = xlstm._slstm_cell(wx[t] + product(st.h), st)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
            log(f"slstm recurrent product M={M} K={H * dh} N={4 * H * dh} fp32, {way}: "
                f"{device_us:.2f} us a token back to back; {steps} cell steps "
                f"{wall_ms:.2f} ms wall ({wall_ms * 1e3 / steps:.1f} us a step); the two "
                f"ways the same bits {same}")


def xlstm_counts(cfg, prefills, prompt_tokens, decode_steps):
    """K5 and K7 launches by body of an xlstm-125m serving run in bf16:
    per prefill each mLSTM block's scan on FMA (N = 384, P = 385) and
    its products (up, q k v and down on wgmma; w_i, w_f, whose 4 columns
    TMA cannot read, on FMA), each sLSTM block's w_in, up_gate, up, down
    on wgmma and its fp32 recurrent product once a token on FMA, the fp32
    LM head on FMA.  A decode step computes in fp32 from the first mLSTM
    block's conv on (the batched state's fp32 conv history promotes it, as
    the reference's): that block's up and v products on wgmma, the other
    77 on FMA."""
    n_s = sum(i % cfg.xlstm.slstm_every == 1 for i in range(cfg.num_layers))
    n_m = cfg.num_layers - n_s
    return {"ssm_scan": {"fma": n_m * prefills},
            "matmul": {"wgmma": (5 * n_m + 4 * n_s) * prefills + 2 * decode_steps,
                       "fma": (2 * n_m + 1) * prefills + n_s * prompt_tokens
                       + (XLSTM_PRODUCTS * n_m + 5 * n_s + 1 - 2) * decode_steps}}


def xlstm_serving_phase(torch, np, table) -> dict:
    """Phase 23b: xlstm-125m at full width through the contiguous engine."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    name, watts = card_name_and_power_limit()
    cfg = arch_registry.config("xlstm-125m")
    t0 = time.monotonic()
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    n_params = sum(t.numel() for b in params["blocks"] for t in b["core"].values()) \
        + params["embed"]["tok"].numel()
    eng = ServingEngine(cfg, params, max_len=ZAMBA_MAX_LEN, batch_slots=4, device="cuda")
    del params
    torch.cuda.synchronize()
    log(f"xlstm serving: L={cfg.num_layers} (block i an sLSTM where i % "
        f"{cfg.xlstm.slstm_every} == 1) d_model={cfg.d_model} H={cfg.num_heads} mLSTM "
        f"d_inner={int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)} (scan N={XLSTM_N} "
        f"P={XLSTM_P}) vocab={cfg.vocab_size} params={n_params} "
        f"({cfg.param_dtype}, compute {cfg.compute_dtype}); paged={eng.paged}; init "
        f"{time.monotonic() - t0:.1f}s")
    eng.serve(zamba_requests(cfg, np, Request, greedy, lens=(60,), new=4, seed=9))  # warm-up
    reqs = zamba_requests(cfg, np, Request, greedy)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    got = {n: dict(table[n].body_launches) for n in ("ssm_scan", "matmul")}
    plain = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
    others = {n: k.launches for n, k in table.items()
              if k.launches and n not in ("ssm_scan", "matmul")}
    for r in reqs:
        if r.state.value != "done" or len(r.output) != 32:
            raise AssertionError(f"xlstm request {r.rid}: state {r.state}, "
                                 f"{len(r.output)} tokens")
    want = xlstm_counts(cfg, stats.prefills, stats.prefill_tokens_total, stats.decode_steps)
    log(f"xlstm serving: requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s tok/s={stats.tokens_per_s:.2f} "
        f"ttft_p50={stats.ttft_p50_s * 1e3:.1f}ms ttft_p99={stats.ttft_p99_s * 1e3:.1f}ms "
        f"tpot={stats.mean_tpot_s * 1e3:.2f}ms occupancy={stats.slot_occupancy:.2f} "
        f"tok/s/W={stats.tokens_per_s / watts:.4f} at power.limit {watts:.0f} W ({name})")
    log(f"xlstm serving: prefills={stats.prefills} prefill_tokens={stats.prefill_tokens_total} "
        f"decode_steps={stats.decode_steps} launches by body {got} (expected {want}: K5 9 a "
        f"prefill) other kernels {others or 0} plain_calls={plain or 0} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    if got != want or plain or others or stats.prefills != len(reqs):
        raise AssertionError(f"xlstm launches {got}, expected {want}; plain calls {plain}; "
                             f"other kernels {others}; prefills {stats.prefills}")
    xlstm_profile(torch, np, eng, Request, greedy)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(c.values()) for n, c in got.items()}


def xlstm_profile(torch, np, eng, Request, greedy):
    """One profiled window: two prompts of 256 and 300 tokens prefilled,
    then 4 decode steps each."""
    from torch.profiler import ProfilerActivity, profile
    reqs = zamba_requests(eng.cfg, np, Request, greedy, lens=(256, 300), new=4, seed=2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    if not busy:
        raise AssertionError("xlstm profile: the profiler saw no device time")
    mine = {n: sum(r[0] for r in rows if n in r[2]) for n in
            ("ssm_scan_kernel", "matmul_wgmma_kernel", "matmul_kernel")}
    log(f"xlstm profile: wall={wall:.3f}s device_busy={busy:.3f}s "
        f"busy_share={busy / wall:.3f} idle_share={1 - busy / wall:.3f} "
        f"prefills={stats.prefills} decode_steps={stats.decode_steps}; device ms "
        + " ".join(f"{n}={v:.3f}" for n, v in mine.items()))
    for ms, count, key in rows[:12]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {key[:90]}")


def xlstm_path_rel(torch, np) -> dict:
    """The last-token logits of two prompts (333 and 1000 tokens) prefilled
    at full width in fp32 through the kernels and through the plain
    versions, at each depth of ``TOL_XLSTM_PATH_REL``: by depth, the
    largest difference relative to the largest plain logit, whether the
    kernels' logits are finite and agree on the top token, and whether the
    kernels' run launched K5 on FMA once per mLSTM block and prompt, K7,
    and no plain version."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import fns_for

    torch.backends.cuda.matmul.allow_tf32 = False
    full = arch_registry.config("xlstm-125m").replace(compute_dtype="float32")
    fns = fns_for(full)
    params = fns.init(full, torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(3)
    prompts = [torch.from_numpy(rng.integers(0, full.vocab_size, size=(1, n))
                                .astype(np.int64)).cuda() for n in (333, 1000)]
    table = dispatch.kernel_table()

    def run(cfg, p):
        with torch.no_grad():
            return torch.cat([fns.prefill(cfg, p, {"tokens": t})[0] for t in prompts])

    out = {}
    for depth in sorted(TOL_XLSTM_PATH_REL):
        cfg = full.replace(num_layers=depth)
        p = dict(params, blocks=params["blocks"][:depth])
        dispatch.reset_counts()
        kern = run(cfg, p)
        torch.cuda.synchronize()
        scans = dict(table["ssm_scan"].body_launches)
        n_m = sum(i % cfg.xlstm.slstm_every != 1 for i in range(depth))
        k7 = table["matmul"].launches
        clean = scans == {"fma": n_m * len(prompts)} and k7 > 0 and \
            not any(k.plain_calls for k in table.values())
        with dispatch.plain_versions():
            plain = run(cfg, p)
        out[depth] = dict(
            rel=((kern - plain).abs().max() / plain.abs().max()).item(),
            finite=bool(torch.isfinite(kern).all()),
            top1=bool((kern.argmax(-1) == plain.argmax(-1)).all()), scans=scans,
            k7=k7, clean=clean)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def xlstm_path_check(torch, np):
    """Phase 23c: :func:`xlstm_path_rel` at depths 4 and 12, each gated at
    ``TOL_XLSTM_PATH_REL``; the kernels' run launches K5 on FMA 9 times a
    prompt at depth 12 and calls no plain version."""
    for depth, r in xlstm_path_rel(torch, np).items():
        tol = TOL_XLSTM_PATH_REL[depth]
        log(f"xlstm path check (fp32, full width, depth {depth}, prompts 333 and 1000): "
            f"kernels vs plain rel {r['rel']:.3e} (tol {tol}) top1_agree={r['top1']}; "
            f"K5 {r['scans']}, K7 {r['k7']} launches")
        if not r["clean"]:
            raise AssertionError(f"xlstm path check: the kernels' run launched K5 "
                                 f"{r['scans']} or called a plain version")
        if not (r["finite"] and r["rel"] <= tol):
            raise AssertionError(f"xlstm path check, depth {depth}: kernels and plain "
                                 f"versions disagree ({r['rel']})")


# ---------------------------------------------------------------------------
# xlstm-125m training (phase 24)
# ---------------------------------------------------------------------------


def xlstm_scan_backward_phase(torch, table) -> dict:
    """Phase 24a: K5's backward at xlstm-125m's mLSTM widths (B=1, H=4,
    N=384, P=385, per-head q/k, chunk 128) on the body its route takes (FMA,
    N and P walked in slices of 64, the last P slice the normalizer's one
    column) against its plain version evaluated in fp32 on the same values,
    on ``XLSTM_BWD_CASES`` at fp32 and bf16, each case launched twice for
    the same bits; then the training shape timed in bf16 beside the plain
    version and the bound (no library call computes it), and its launches
    timed apart under the profiler."""
    from repro_torch.kernels.dispatch import GRAD_RTOL
    from repro_torch.kernels.ssm_scan.ops import (backward_body_for, backward_passes,
                                                  backward_sliced)
    bwd = table["ssm_scan_backward"]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for S, with_state in XLSTM_BWD_CASES:
            args, h0 = mlstm_case(torch, S, dtype, with_state=with_state, seed=S)
            g = torch.Generator("cuda").manual_seed(S + 7)
            dy = torch.randn((1, S, XLSTM_H, XLSTM_P), generator=g, device="cuda")
            df = (torch.randn((1, XLSTM_H, XLSTM_N, XLSTM_P), generator=g, device="cuda")
                  if with_state else None)
            route = backward_body_for(*args[:3])
            if route != "fma" or not backward_sliced(XLSTM_N, XLSTM_P):
                raise AssertionError(f"ssm_scan_backward at xlstm's widths: route {route}, "
                                     f"expected the sliced fma body")
            label = (f"B=1 S={S} H={XLSTM_H} N={XLSTM_N} P={XLSTM_P} per-head q/k chunk 128 "
                     f"h0/d_final={with_state} (limit {GRAD_RTOL[dtype]:.2e} of each "
                     f"gradient's max|ref|, fp32 gradients {GRAD_RTOL[torch.float32]:.2e}) "
                     f"body=fma, sliced")
            errs.setdefault(dtype, []).append(
                hold(torch, bwd, (*args, dy, df), label, chunk=128, initial_state=h0))
            first = bwd.launch(*args, dy, df, chunk=128, initial_state=h0)
            again = bwd.launch(*args, dy, df, chunk=128, initial_state=h0)
            torch.cuda.synchronize()
            if not all(torch.equal(u, w) for u, w in zip(first, again) if u is not None):
                raise AssertionError(f"ssm_scan_backward {label}: two launches differ")
        log(f"ssm_scan_backward sliced fma at xlstm's widths {str(dtype)[6:]}: "
            f"{len(XLSTM_BWD_CASES)} cases held, each launched twice for the same bits")
    timer = Timer(torch)
    args, _ = mlstm_case(torch, TRAIN_SEQ, torch.bfloat16)
    dy = torch.randn((1, TRAIN_SEQ, XLSTM_H, XLSTM_P), device="cuda")
    nbytes, flops = scan_backward_work(TRAIN_SEQ, H=XLSTM_H, N=XLSTM_N, P=XLSTM_P,
                                       shared=False)
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
    shape = (f"B=1 S={TRAIN_SEQ} H={XLSTM_H} N={XLSTM_N} P={XLSTM_P} per-head q/k chunk "
             f"128, bf16 q/k/v, fp32 dy (one xlstm-125m mLSTM block of a training "
             f"microbatch) body={backward_body_for(*args[:3])}, sliced")
    out = dict(xlstm_ms=timer(lambda: bwd.launch(*args, dy, chunk=128)),
               xlstm_plain_ms=timer(lambda: bwd.plain(*args, dy, chunk=128)),
               xlstm_bound_ms=bound_ms, xlstm_bound_by=bound_by,
               xlstm_fp32_bound_ms=bound(nbytes, flops, FP32_FLOPS)[0], xlstm_shape=shape,
               max_abs_err_xlstm=max(errs[torch.bfloat16]),
               max_abs_err_xlstm_fp32=max(errs[torch.float32]))
    log(f"ssm_scan_backward timed {shape}: kernel {out['xlstm_ms']:.4f}ms plain "
        f"{out['xlstm_plain_ms']:.4f}ms library none bound {bound_ms:.5f}ms ({bound_by}, "
        f"tensor cores; {nbytes} B, {flops} flop; at the 67 TFLOP/s fp32 rate "
        f"{out['xlstm_fp32_bound_ms']:.4f}ms)")
    t = pass_times(torch, lambda n: bwd.launch(*args, dy, chunk=128, last_pass=n),
                   backward_passes("fma", XLSTM_N, XLSTM_P))
    log(f"ssm_scan_backward sliced fma body by pass ({PASS_TIMING}): {launch_times(t)}")
    return out


def xlstm_train_counts(cfg, seq: int, micro: int) -> dict:
    """Launches by body of ``micro`` xlstm training microbatches of ``seq``
    tokens, from the config (``models.recurrent.training_launches``): K5
    and its backward on FMA (N = 384, P = 385; the backward's sliced
    layout); K7's wide products on wgmma at bf16 compute, forward and
    backward, its narrow ones (w_i and w_f, 4 columns: rows TMA cannot
    read; the fp32 recurrent products; the fp32 LM head) on FMA; fp32
    compute puts everything on FMA."""
    from repro_torch.models.recurrent import training_launches
    n = training_launches(cfg, seq)
    wide, narrow = (micro * n["matmul"][c] for c in ("wide", "narrow"))
    k7 = ({"wgmma": wide, "fma": narrow} if cfg.compute_dtype == "bfloat16"
          else {"fma": wide + narrow})
    return {"ssm_scan": {"fma": n["ssm_scan"] * micro},
            "ssm_scan_backward": {"fma": n["ssm_scan_backward"] * micro}, "matmul": k7}


def xlstm_train_rel(torch, np) -> dict:
    """xlstm-125m at full width cut to 2 blocks (an mLSTM, then an sLSTM),
    one 1 x ``XLSTM_CHECK_SEQ`` microbatch, at fp32 and at bf16 compute.
    On one forward graph through the kernels, the backward through the
    kernels (K5's sliced backward, K7's) and, from the same retained graph,
    through their plain versions: ``leaves``, the worst leaf but b_i
    against its own largest entry over 2^-14 (fp32) or
    ``TOL_XLSTM_BF16_GRAD_REL`` (bf16); ``b_i``, b_i's over
    ``TOL_XLSTM_BI_REL``; ``b_i_scan``, K5's backward launched again on the
    operands its launch in the graph received, its d log_gate summed over
    the sequence per head against the plain version's sums, over
    ``TOL_XLSTM_BI_SCAN_REL``; ``scan``, that launch's outputs'
    ``grad_tolerance_ratio``; ``graph``, the largest of the four (<= 1
    passes).  At fp32 also two whole runs, kernels and plain versions: the
    loss's and the leaves' relative differences.  By compute dtype, with
    the kernel run's launches by body, its plain calls and whether
    everything was finite."""
    from unittest import mock

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.models.registry import fns_for
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn

    def rel(a, b):
        return [((x - y).abs().max() / y.abs().max().clamp(min=1e-30)).item()
                for x, y in zip(a, b)]

    bwd = ssm_ops.BACKWARD
    launch, calls = bwd.launch, []

    def record(*args, **kw):        # K5's backward launched as it is, its operands kept
        calls.append((args, kw))
        return launch(*args, **kw)

    torch.backends.cuda.matmul.allow_tf32 = False
    table = dispatch.kernel_table()
    out = {}
    for compute in ("float32", "bfloat16"):
        cfg = arch_registry.config("xlstm-125m").replace(compute_dtype=compute, num_layers=2)
        params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
        batch = {k: torch.as_tensor(v).cuda() for k, v in
                 next(SyntheticTokens(cfg, 1, XLSTM_CHECK_SEQ, seed=5)).items()}
        ps = leaves(params)
        b_i = {id(b["core"]["b_i"]) for b in params["blocks"] if "b_i" in b["core"]}
        loss_fn = make_loss_fn(cfg)
        for p in ps:
            p.requires_grad_(True)
        dispatch.reset_counts()
        loss, _ = loss_fn(params, batch)
        calls.clear()
        with mock.patch.object(bwd, "launch", record):
            kern_g = torch.autograd.grad(loss, ps, retain_graph=True)
        torch.cuda.synchronize()
        r = dict(launches={n: dict(table[n].body_launches)
                           for n in xlstm_train_counts(cfg, XLSTM_CHECK_SEQ, 1)},
                 plain_calls={n: k.plain_calls for n, k in table.items() if k.plain_calls},
                 want=xlstm_train_counts(cfg, XLSTM_CHECK_SEQ, 1), loss=loss.item(),
                 n_leaves=len(ps))
        with dispatch.plain_versions():
            same_g = torch.autograd.grad(loss, ps)
        del loss
        each = rel(kern_g, same_g)
        limit = dispatch.GRAD_RTOL[torch.float32] if compute == "float32" \
            else TOL_XLSTM_BF16_GRAD_REL
        r["leaves"] = max(e for e, p in zip(each, ps) if id(p) not in b_i) / limit
        r["b_i"] = max(e for e, p in zip(each, ps) if id(p) in b_i) / TOL_XLSTM_BI_REL[compute]
        (args, kw), = calls
        with torch.no_grad():
            kern_s = bwd.launch(*args, **kw)
            plain_s = bwd.plain(*args, **kw)
        r["scan"] = dispatch.grad_tolerance_ratio(kern_s, plain_s)
        r["b_i_scan"] = rel([kern_s[4].double().sum((0, 1))],
                            [plain_s[4].double().sum((0, 1))])[0] / TOL_XLSTM_BI_SCAN_REL
        r["graph"] = max(r["leaves"], r["b_i"], r["scan"], r["b_i_scan"])
        r["finite"] = all(bool(torch.isfinite(g).all()) for g in kern_g)
        del calls[:], args, kw, kern_s, plain_s
        if compute == "float32":
            with dispatch.plain_versions():
                plain_loss, _ = loss_fn(params, batch)
                plain_g = torch.autograd.grad(plain_loss, ps)
            r["loss_rel"] = abs(r["loss"] - plain_loss.item()) / abs(plain_loss.item())
            r["grad_rel"] = max(rel(kern_g, plain_g))
            del plain_g, plain_loss
        for p in ps:
            p.requires_grad_(False)
        out[compute] = r
        del params, ps, kern_g, same_g, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def xlstm_train_fails(r: dict) -> bool:
    """Whether a run of :func:`xlstm_train_rel` fails phase 24b's limits."""
    return not all(v["finite"] and v["graph"] <= 1.0 for v in r.values()) or not (
        r["float32"]["loss_rel"] <= TOL_TRAIN_LOSS_REL
        and r["float32"]["grad_rel"] <= TOL_TRAIN_GRAD_REL)


def xlstm_train_path_check(torch, np) -> None:
    """Phase 24b: :func:`xlstm_train_rel`, gated: at each compute dtype the
    one-graph backward within its limit, at fp32 the whole runs within
    ``TOL_TRAIN_LOSS_REL`` (loss) and ``TOL_TRAIN_GRAD_REL`` (each leaf, of
    its largest entry); the kernels' runs launch exactly what
    :func:`xlstm_train_counts` derives and no plain version."""
    r = xlstm_train_rel(torch, np)
    for compute, v in r.items():
        limit = 2.0 ** -14 if compute == "float32" else TOL_XLSTM_BF16_GRAD_REL
        whole = (f"; whole runs: loss kernels vs plain rel={v['loss_rel']:.3e} (tol "
                 f"{TOL_TRAIN_LOSS_REL}), worst leaf rel={v['grad_rel']:.3e} (tol "
                 f"{TOL_TRAIN_GRAD_REL})" if "loss_rel" in v else "")
        log(f"xlstm training path check ({compute} compute, full width, 2 blocks, 1 x "
            f"{XLSTM_CHECK_SEQ} tokens, {v['n_leaves']} gradient leaves): loss {v['loss']:.6f}; "
            f"one forward graph, backward kernels vs plain versions, err/limit: worst leaf "
            f"but b_i {v['leaves']:.3f} ({limit:.2e} of its own max), b_i {v['b_i']:.3f} "
            f"({TOL_XLSTM_BI_REL[compute]:.2e} of its own max); K5's backward on the "
            f"graph's own operands: outputs {v['scan']:.3f} (grad_tolerance_ratio), d "
            f"log_gate's per-head sums {v['b_i_scan']:.3f} ({TOL_XLSTM_BI_SCAN_REL:.2e} of "
            f"their max){whole}; launches by body {v['launches']}; plain calls "
            f"{v['plain_calls'] or 0}")
        if v["launches"] != v["want"] or v["plain_calls"]:
            raise AssertionError(f"xlstm training path check ({compute}): launches "
                                 f"{v['launches']}, expected {v['want']}; plain calls "
                                 f"{v['plain_calls']}")
    if xlstm_train_fails(r):
        raise AssertionError(f"xlstm training path check: kernels and plain versions "
                             f"disagree: {r}")


def xlstm_training_phase(torch, np, table) -> dict:
    """Phase 24c: xlstm-125m at full width (12 blocks, 9 mLSTM and 3 sLSTM;
    fp32 master weights, bf16 compute, AdamW) trained for
    ``XLSTM_TRAIN_STEPS`` steps of ``XLSTM_TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens in ``XLSTM_TRAIN_ACCUM`` microbatches (1 x 512 each, as the 8 x
    512 / 8 recipe's) through ``python -m repro_torch.launch.train``'s entry
    point.  Every loss finite; K5, its backward and K7 launch exactly what
    :func:`xlstm_train_counts` derives, by body; no plain call.  Step time
    (the mean of the steps after the first), tokens/s, tokens/s/W against
    the power limit, peak memory; then one microbatch under the profiler
    (device activity only): device time by kernel and the busy share.
    Returns the launches by kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn

    name, watts = card_name_and_power_limit()
    cfg = arch_registry.config("xlstm-125m")
    want = xlstm_train_counts(cfg, TRAIN_SEQ, XLSTM_TRAIN_ACCUM * XLSTM_TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as d:
        args = train_launcher.parse(
            ["--arch", "xlstm-125m", "--steps", str(XLSTM_TRAIN_STEPS), "--batch",
             str(XLSTM_TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--accum",
             str(XLSTM_TRAIN_ACCUM), "--ckpt-dir", d])
        dispatch.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out = train_launcher.run(args)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        got = {n: dict(table[n].body_launches) for n in want}
        plain = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
    s = out["summary"]
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    tr = out["trainer"]
    n_params = sum(p.numel() for p in leaves(tr.params))
    log(f"xlstm training: L={cfg.num_layers} (9 mLSTM, 3 sLSTM) d_model={cfg.d_model} "
        f"H={cfg.num_heads} (scan N={XLSTM_N} P={XLSTM_P}) vocab={cfg.vocab_size} tied "
        f"params={n_params} fp32 master weights, {cfg.compute_dtype} compute, adamw; "
        f"{XLSTM_TRAIN_STEPS} steps of {XLSTM_TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{XLSTM_TRAIN_ACCUM} microbatches; wall {wall:.1f}s (init included)")
    log(f"xlstm training: losses={[round(v, 4) for v in losses]} "
        f"first_step={s['first_step_s']:.3f}s step={s['step_s']:.3f}s "
        f"tokens/s={s['tokens_per_s']:.1f} tokens/s/W={s['tokens_per_s'] / watts:.4f} at "
        f"power.limit {watts:.0f} W ({name}) max_memory_allocated="
        f"{s['peak_memory_bytes'] / 2**30:.2f}GiB (params+grads+adamw state "
        f"{16 * n_params / 2**30:.2f}GiB)")
    log(f"xlstm training: launches by body {got} (expected {want}); plain_calls="
        f"{plain or 0}")
    if len(losses) != XLSTM_TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"xlstm training: losses {losses}")
    if got != want or plain:
        raise AssertionError(f"xlstm training: launches {got}, expected {want}; plain "
                             f"calls {plain}")
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             next(SyntheticTokens(cfg, 1, TRAIN_SEQ, seed=9)).items()}
    ps = leaves(tr.params)
    for p in ps:
        p.requires_grad_(True)
    loss_fn = make_loss_fn(cfg)
    # device activity alone: a microbatch issues ~100,000 host ops, whose
    # records the profiler would read back for a minute
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        loss, _ = loss_fn(tr.params, batch)
        torch.autograd.grad(loss, ps)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    for p in ps:
        p.requires_grad_(False)
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    if not busy:
        raise AssertionError("xlstm training profile: the profiler saw no device time")
    by = {"K7 matmul": ("matmul_wgmma_kernel", "matmul_kernel"),
          "K5 ssm_scan": ("ssm_scan_kernel",), "K5 backward": ("ssm_bwd_",)}
    parts = {k: sum(r[0] for r in rows if any(n in r[2] for n in v)) / 1e3
             for k, v in by.items()}
    log(f"xlstm training profile (one 1 x {TRAIN_SEQ} microbatch, forward and backward): "
        f"wall={wall:.3f}s device_busy={busy:.3f}s busy_share={busy / wall:.3f} idle_share="
        f"{1 - busy / wall:.3f}; " + ", ".join(f"{k} {v:.3f}s ({v / busy:.3f} of device "
                                               f"time)" for k, v in parts.items()))
    for ms, count, key in rows[:12]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {key[:90]}")
    del out, tr, ps, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(c.values()) for n, c in got.items()}


def k7b_operands(torch, E, M, K, N, dtype, seed=0):
    """x (E, M, K), w (E, K, N) row-major, w scaled by 1/sqrt(K), as expert
    weights are."""
    g = torch.Generator("cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    x = torch.randn((E, M, K), generator=g, device="cuda").to(dt)
    w = (torch.randn((E, K, N), generator=g, device="cuda") / K ** 0.5).to(dt)
    return x, w


def moe_kernel_phase(torch, table) -> dict:
    """Phase 25a: K7's batched entry against its plain version (evaluated in
    fp32 on the same values, ``dispatch.matmul_tolerance_ratio``) on
    ``K7B_CASES``, each launched twice for the same bits; then each timed
    beside the plain version, one ``torch.bmm`` on the same operands
    (cuBLAS; TF32 off) and the bound: the expert weights' bytes (369 MB a
    deepseek product, 0.110 ms at 3.35 TB/s) and the inputs and outputs."""
    from repro_torch.kernels.matmul.ops import batched_body_for
    kern = table["matmul_batched"]
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(torch, reps=10)
    out = {}
    for label, E, M, K, N, dtype in K7B_CASES:
        x, w = k7b_operands(torch, E, M, K, N, dtype)
        body = batched_body_for(x, w)
        want = "fma" if dtype == "float32" else "wgmma"
        got = kern.launch(x, w)
        again = kern.launch(x, w)
        ref = kern.plain(x.float(), w.float())
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        ratio = kern.tolerance(got, ref, K)
        same = bool(torch.equal(got, again))
        nbytes = x.element_size() * E * (M * K + K * N + M * N)   # each read / written once
        flops = 2.0 * E * M * K * N
        r = dict(ms=timer(lambda: kern.launch(x, w)),
                 plain_ms=timer(lambda: kern.plain(x, w)),
                 library_ms=timer(lambda: torch.bmm(x, w)),
                 bytes=nbytes, flops=flops, max_abs_err=err,
                 shape=f"{label}: E={E} M={M} K={K} N={N} {dtype} body={body}")
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops,
                                             FP32_FLOPS if dtype == "float32" else BF16_FLOPS)
        log(f"matmul_batched {r['shape']}: max_abs_err={err:.3e} err/limit={ratio:.3f} "
            f"same bits twice={same}; kernel {r['ms']:.4f}ms plain {r['plain_ms']:.4f}ms "
            f"torch.bmm {r['library_ms']:.4f}ms bound {r['bound_ms']:.4f}ms "
            f"({r['bound_by']}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        if not (ratio <= 1.0 and same and body == want):
            raise AssertionError(f"matmul_batched {label}: err/limit {ratio}, same bits "
                                 f"{same}, body {body} (expected {want})")
        out[label] = r
        del x, w, got, again, ref
    res = out[K7B_CASES[0][0]]
    dec = out["decode gate/up"]
    res.update(decode_ms=dec["ms"], decode_plain_ms=dec["plain_ms"],
               decode_library_ms=dec["library_ms"], decode_bound_ms=dec["bound_ms"],
               decode_bound_by=dec["bound_by"], decode_shape=dec["shape"])
    gc.collect()
    torch.cuda.empty_cache()
    return {"matmul_batched": res}


def moe_serving_phase(torch, np, table) -> dict:
    """Phase 25b: deepseek-moe-16b at full width and depth (28 layers),
    bf16, through the paged engine: 4 slots, 256-row prefill chunks, phase
    4's 8 requests, 32 new tokens each.  Launches held exactly by body per
    model call (a prefill chunk or a decode step): K7 224 (196 wgmma; 28
    FMA: 27 routers and the fp32 LM head), its batched entry 81 (3 a MoE
    layer), K2 28 a prefill chunk, K1 28 a decode step; no plain call, no
    other kernel.  tok/s, TTFT, TPOT, tok/s/W, peak memory, the pool's
    bytes a token and a profiled window's busy share.  Random weights from
    seed 0, the product weights drawn a layer at a time and stored in bf16
    (``init(cast_products=True)``), as the serving launcher loads them."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import leaves
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    name, watts = card_name_and_power_limit()
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    cfg = arch_registry.config("deepseek-moe-16b")
    params = transformer.init(cfg, torch.Generator("cuda").manual_seed(0), cast_products=True)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    init_s, init_gib = time.monotonic() - t0, torch.cuda.max_memory_allocated() / 2**30
    eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, prefill_chunk=256,
                        device="cuda")
    del params
    m = cfg.moe
    log(f"moe serving: deepseek-moe-16b L={cfg.num_layers} (first {m.first_k_dense} dense, "
        f"d_ff {m.d_ff_dense}) d_model={cfg.d_model} H={cfg.num_heads} K={cfg.num_kv_heads} "
        f"D={cfg.resolved_head_dim} experts={m.num_experts} top-{m.top_k} d_ff_expert="
        f"{m.d_ff_expert} shared={m.num_shared_experts} x {m.d_ff_shared} vocab="
        f"{cfg.vocab_size} params={n_params} (products bf16, router / norms / embedding "
        f"fp32); init {init_s:.1f}s, peak {init_gib:.2f} GiB after the load")
    eng.serve([Request(100, np.arange(40, dtype=np.int32), max_new_tokens=4,
                       sampler=greedy())])                           # warm-up
    reqs = serving_requests(cfg, np, Request, greedy)
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
    bodies, plain = launched_bodies(table)
    calls = chunks[0] + stats.decode_steps
    L = cfg.num_layers
    want = {"paged_prefill_attention": {"mma": L * chunks[0]},
            "paged_decode_attention": {"mma": L * stats.decode_steps},
            "matmul": {b: n * calls for b, n in DEEPSEEK_K7.items()},
            "matmul_batched": {b: n * calls for b, n in DEEPSEEK_K7B.items()}}
    for r in reqs:
        if r.state.value != "done" or len(r.output) != 32:
            raise AssertionError(f"moe request {r.rid}: state {r.state}, "
                                 f"{len(r.output)} tokens")
    state = eng._state
    pool_bytes = sum(t.numel() * t.element_size() for t in state if t.dim() > 2)
    pool_rows = state.k.shape[1] * state.k.shape[2]
    leaks = eng.pool.leak_report()
    log(f"moe serving: requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s tok/s={stats.tokens_per_s:.2f} "
        f"ttft_p50={stats.ttft_p50_s * 1e3:.1f}ms ttft_p99={stats.ttft_p99_s * 1e3:.1f}ms "
        f"tpot={stats.mean_tpot_s * 1e3:.2f}ms occupancy={stats.slot_occupancy:.2f} "
        f"tok/s/W={stats.tokens_per_s / watts:.4f} at power.limit {watts:.0f} W ({name}); "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB; KV pool "
        f"{pool_bytes} B ({pool_rows} rows of {pool_bytes // pool_rows} B)")
    log(f"moe serving: {chunks[0]} prefill chunks, {stats.decode_steps} decode steps, "
        f"prefill_tokens={stats.prefill_tokens_computed}/{stats.prefill_tokens_total}; "
        f"launches by body {bodies} (expected {want}) plain_calls={plain or 0} leaks={leaks}")
    if bodies != want or plain or any(leaks.values()) \
            or pool_bytes // pool_rows != DEEPSEEK_KV_BYTES:
        raise AssertionError(f"moe serving: launches {bodies}, expected {want}; plain "
                             f"calls {plain}; leaks {leaks}; {pool_bytes // pool_rows} B a "
                             f"token (expected {DEEPSEEK_KV_BYTES})")
    profile_phase(torch, np, eng, Request, greedy, "moe serving", n=1, new=8)
    del eng, state
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(c.values()) for n, c in bodies.items()}


def poison_cached_memory(torch) -> None:
    """Fill every block the caching allocator holds free with 0xFF bytes
    (NaN in fp32, bf16 and fp16), so an output row that a kernel leaves
    unwritten reads NaN, not the values an earlier run of the same layer
    left in a block handed out again."""
    sizes = sorted((b["size"] for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
                    if b["state"] == "inactive"), reverse=True)
    held = [torch.full((n,), 255, dtype=torch.uint8, device="cuda") for n in sizes]
    torch.cuda.synchronize()
    del held


def moe_path_rel(torch, np) -> dict:
    """Phase 25c's measurements: phase 6's 300-token request (a 256-row
    chunk, 44 rows seeded past it, one decode step) served in fp32 at full
    width by ``ServingEngine``s cut to ``MOE_PATH_DEPTHS`` layers (1 dense
    + 1 and 3 MoE): through the plain versions, every MoE layer's routes
    and router logits recorded; through the kernels running free (printed:
    their route differences and logits); and through the kernels
    replaying the plain run's routes, each MoE layer routing on its own
    activations first (its router launched as served), so its decisions
    and router logits can be held against the plain run's on the same
    upstream routes.  A free run's one near-tie flip changes that token's
    activations by O(1), and with them later layers' routes of it and of
    every later token that attends to it, at margins no bound holds; under
    replay each layer decides on the plain run's upstream routes.  Before
    each run the allocator's free blocks are filled with NaN
    (:func:`poison_cached_memory`): an expert output the kernel never
    writes must not read the rows an earlier run of the layer left there.

    Returns, per depth: rel, the replayed run's logits against the plain
    run's (largest difference over the largest logit, prefill and
    decode); flips, for each token the replayed run's own decision routes
    otherwise than the plain run, the plain run's smallest log-probability
    gap between neighbours of its top k + 1; logit_diff, the largest
    router-logit difference between the two; experts, how many experts a
    layer call of the plain run routes to (least-most); missing, by MoE
    layer the experts with no kept row in any of its calls (a broken
    expert there would not show), and per_call, each call's rows and the
    experts it leaves without a kept row; ys_rel and ys_finite, the replayed run's
    MoE outputs (every row of every call, padding rows included) against
    the plain run's, relative to the largest; the free run's route
    differences and logits rel (printed); whether the replayed run
    launched only kernels."""
    from unittest import mock

    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
    from repro_torch.models.layers import moe as MOE
    from repro_torch.models.layers.module import tree_map
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import Sampler

    class Record(Sampler):
        def __init__(self):
            self.seen = []

        def sample(self, logits):
            self.seen.append(np.array(logits[0], copy=True))
            return np.full((len(logits),), 7)

    torch.backends.cuda.matmul.allow_tf32 = False
    full = arch_registry.config("deepseek-moe-16b").replace(
        compute_dtype="float32", num_layers=max(MOE_PATH_DEPTHS))
    params = transformer.init(full, torch.Generator("cuda").manual_seed(0))
    toks = np.random.default_rng(1).integers(0, full.vocab_size, size=300).astype(np.int32)
    route = MOE.route
    k = full.moe.top_k

    def serve(cfg, p):
        poison_cached_memory(torch)
        eng = ServingEngine(cfg, p, max_len=320, batch_slots=1, prefill_chunk=256,
                            cache_dtype="float32", device="cuda")
        rec = Record()
        eng.serve([Request(0, toks, max_new_tokens=2, sampler=rec)])
        if any(eng.pool.leak_report().values()) or len(rec.seen) != 2:
            raise AssertionError("moe path check: the request did not run clean")
        return np.stack(rec.seen)

    def router_logits(prm, x):      # the script's own fp32 product, never the port's
        return x.float() @ prm["router"].float()

    def recording(into):
        def wrapped(cfg_moe, prm, x, **kw):
            idx, prob, aux = route(cfg_moe, prm, x, **kw)
            into.append((idx, prob, router_logits(prm, x)))
            return idx, prob, aux
        return wrapped

    def replaying(routes, own):
        it = iter(routes)

        def wrapped(cfg_moe, prm, x, **kw):
            idx, _, aux = route(cfg_moe, prm, x, **kw)   # the router's launch, as served
            own.append((idx, router_logits(prm, x)))
            plain_idx, prob, _ = next(it)
            return plain_idx, prob, aux
        return wrapped

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    apply = MOE.moe_apply

    def keeping(into):
        def wrapped(*a, **kw):
            y = apply(*a, **kw)
            into.append(y.float())
            return y
        return wrapped

    out = {}
    for depth in MOE_PATH_DEPTHS:
        cfg = full.replace(num_layers=depth)
        n_moe = depth - full.moe.first_k_dense
        p = dict(params, blocks=tree_map(lambda t: t[:n_moe], params["blocks"]))
        plain_routes, free_routes, own, plain_ys, kern_ys = [], [], [], [], []
        with dispatch.plain_versions(), mock.patch.object(
                MOE, "route", recording(plain_routes)), \
                mock.patch.object(MOE, "moe_apply", keeping(plain_ys)):
            plain = serve(cfg, p)
        with mock.patch.object(MOE, "route", recording(free_routes)):
            free = serve(cfg, p)
        dispatch.reset_counts()
        with mock.patch.object(MOE, "route", replaying(plain_routes, own)), \
                mock.patch.object(MOE, "moe_apply", keeping(kern_ys)):
            kern = serve(cfg, p)
        table = dispatch.kernel_table()
        launched = all(table[n].launches > 0 for n in LM_KERNELS + ("matmul",
                                                                    "matmul_batched")) \
            and not any(t.plain_calls for t in table.values())
        flips, logit_diff = [], 0.0
        for (pi, _, pl), (oi, ol) in zip(plain_routes, own):
            logit_diff = max(logit_diff, (ol - pl).abs().max().item())
            differ = (pi != oi).any(-1)
            if bool(differ.any()):
                top = torch.topk(torch.log_softmax(pl, dim=-1), k + 1, dim=-1).values
                flips += (top[..., :-1] - top[..., 1:]).min(-1).values[differ].tolist()
        free_flips = sum(int((pi != fi).any(-1).sum())
                         for (pi, _, _), (fi, _, _) in zip(plain_routes, free_routes))
        experts = sorted({len(torch.unique(r[0])) for r in plain_routes})
        # the calls run layer by layer, n_moe a model call: the experts with
        # no kept row in all of a layer's calls
        kept, per_call = [set() for _ in range(n_moe)], []
        for i, r in enumerate(plain_routes):
            got = kept_experts(MOE, full.moe, r[0])
            kept[i % n_moe] |= got
            per_call.append((int(r[0].shape[1]),
                             sorted(set(range(full.moe.num_experts)) - got)))
        missing = [sorted(set(range(full.moe.num_experts)) - k) for k in kept]
        ys_rel = max(((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(kern_ys, plain_ys))
        out[depth] = dict(rel=max(rel(kern[i], plain[i]) for i in (0, 1)),
                          missing=missing, per_call=per_call, ys_rel=ys_rel,
                          ys_finite=all(bool(torch.isfinite(y).all()) for y in kern_ys),
                          experts=f"{experts[0]}-{experts[-1]} of {full.moe.num_experts} "
                                  f"a layer call",
                          top1=bool((kern.argmax(-1) == plain.argmax(-1)).all()),
                          finite=bool(np.isfinite(kern).all()), flips=flips,
                          logit_diff=logit_diff, free_flips=free_flips,
                          free_rel=max(rel(free[i], plain[i]) for i in (0, 1)),
                          routed=sum(int(r[0].numel()) // k for r in plain_routes),
                          launched=launched)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_path_fails(r: dict, depth: int, factor: float = 1.0) -> bool:
    """Whether phase 25c's check fails at ``depth`` (by ``factor`` past the
    limit): logits or MoE outputs not finite or past ``factor`` x
    ``TOL_PATH_REL``, a route decided otherwise (on the same upstream
    routes) where the plain run had no near-tie, or an expert that no
    token reaches in some layer (the check would not see it)."""
    return not (r["finite"] and r["rel"] <= factor * TOL_PATH_REL[depth]
                and r["ys_finite"] and r["ys_rel"] <= factor * TOL_MOE_OUT_REL[depth]
                and all(g < TOL_MOE_FLIP_GAP for g in r["flips"])
                and not any(r["missing"]))


def moe_path_check(torch, np) -> None:
    """Phase 25c: the gate on :func:`moe_path_rel`."""
    for depth, r in moe_path_rel(torch, np).items():
        tol = TOL_PATH_REL[depth]
        log(f"moe path check (fp32, full width, depth {depth}: 1 dense + {depth - 1} MoE): "
            f"kernels replaying the plain routes vs plain rel {r['rel']:.3e} (tol {tol}) "
            f"top1_agree={r['top1']} finite={r['finite']}; their own decisions on the same "
            f"upstream routes: {len(r['flips'])} of {r['routed']} routed tokens routed "
            f"otherwise, the plain run's smallest neighbouring top-(k+1) log-probability "
            f"gaps there {[f'{g:.2e}' for g in r['flips']]} (each must be < "
            f"{TOL_MOE_FLIP_GAP}), router logits at most {r['logit_diff']:.3e} apart; "
            f"free-running kernels (printed): {r['free_flips']} tokens routed otherwise, "
            f"logits rel {r['free_rel']:.3e}; experts routed to {r['experts']}; experts "
            f"with no kept row by MoE layer {r['missing']} (by call, its rows and the "
            f"experts it leaves without one: {r['per_call']}); the replayed MoE outputs "
            f"(every row of every call) vs plain rel {r['ys_rel']:.3e} (tol "
            f"{TOL_MOE_OUT_REL[depth]}) finite={r['ys_finite']}; only kernels launched="
            f"{r['launched']}")
        if not r["launched"]:
            raise AssertionError("moe path check: the kernel engine did not run through "
                                 "K1, K2, K7 and its batched entry alone")
        if moe_path_fails(r, depth):
            raise AssertionError(f"moe path check, depth {depth}: {r}")


# ---------------------------------------------------------------------------
# deepseek-moe-16b training (phase 26)
# ---------------------------------------------------------------------------


def backward_products(x, w, dy) -> dict:
    """The two launches of the batched entry in the backward of ``x @ w``
    (``linear._BatchedMatmul``), each as its (x, y) operands: dX = dY @ w^T
    and dW = x^T @ dY, on transposed views."""
    return {"dX": (dy, w.transpose(1, 2)), "dW": (x.transpose(1, 2), dy)}


def moe_backward_phase(torch, table) -> dict:
    """Phase 26a: the batched entry's two backward products
    (:func:`backward_products`) against the plain version (evaluated in
    fp32 on the same values, ``dispatch.matmul_tolerance_ratio``) on
    ``K7B_BWD_CASES``, each launched twice for the same bits and on the
    body its route takes (16-bit views TMA can read on a wgmma body: the
    persistent one where the product writes at least the elements it
    reads and the output row is a multiple of 16 bytes -- dW --, else
    "wgmma"; every other view on FMA); then each timed (CUDA events, L2 flushed) beside the
    plain version, one ``torch.bmm`` on the same views (TF32 off) and the
    bound: each operand read once and the output written once, or 2 E M
    K N operations.  The training shape's views also run on both wgmma
    bodies, timed in turns (route's, other, other, route's), the two
    bodies' outputs the same bits.  Returns the first case's numbers for
    the kernels line."""
    from repro_torch.kernels.matmul.ops import batched_body_for
    kern = table["matmul_batched"]
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(torch, reps=10)
    out = {}
    for label, E, C, D, F, dtype in K7B_BWD_CASES:
        x, w = k7b_operands(torch, E, C, D, F, dtype)
        dy = k7b_operands(torch, E, C, F, 1, dtype, seed=1)[0]
        tensor_cores = dtype != "float32" and D % 8 == 0 and F % 8 == 0
        for which, (a, b) in backward_products(x, w, dy).items():
            _, M, K = a.shape
            N = b.shape[2]
            body = batched_body_for(a, b)
            want = ("fma" if not tensor_cores else "wgmma_persistent"
                    if M * N >= K * (M + N) else "wgmma")
            got = kern.launch(a, b)
            again = kern.launch(a, b)
            ref = kern.plain(a.float(), b.float())
            torch.cuda.synchronize()
            err = (got.float() - ref).abs().max().item()
            ratio = kern.tolerance(got, ref, K)
            same = bool(torch.equal(got, again))
            nbytes = a.element_size() * E * (M * K + K * N + M * N)
            flops = 2.0 * E * M * K * N
            r = dict(ms=timer(lambda: kern.launch(a, b)),
                     plain_ms=timer(lambda: kern.plain(a, b)),
                     library_ms=timer(lambda: torch.bmm(a, b)),
                     bytes=nbytes, flops=flops, max_abs_err=err,
                     shape=f"{label} {which}: E={E} M={M} K={K} N={N} {dtype} body={body}")
            r["bound_ms"], r["bound_by"] = bound(
                nbytes, flops, FP32_FLOPS if dtype == "float32" else BF16_FLOPS)
            bodies = ""
            if label.startswith("train") and tensor_cores:
                other = "wgmma" if body == "wgmma_persistent" else "wgmma_persistent"
                same = same and bool(torch.equal(got, kern.launch(a, b, body=other)))
                t = {}
                for bd in (body, other, other, body):
                    t.setdefault(bd, []).append(timer(lambda bd=bd: kern.launch(a, b, body=bd)))
                r["wgmma_ms"], r["persistent_ms"] = (statistics.mean(t[bd]) for bd in (
                    "wgmma", "wgmma_persistent"))
                bodies = ("; both wgmma bodies in turns (the same bits), " + ", ".join(
                    f"{bd} " + " / ".join(f"{v:.4f}" for v in t[bd]) + "ms" for bd in t))
            log(f"matmul_batched backward {r['shape']}: max_abs_err={err:.3e} "
                f"err/limit={ratio:.3f} same bits twice{' and on both bodies' if bodies else ''}"
                f"={same}; kernel {r['ms']:.4f}ms plain {r['plain_ms']:.4f}ms torch.bmm "
                f"{r['library_ms']:.4f}ms bound {r['bound_ms']:.4f}ms ({r['bound_by']}; "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP){bodies}")
            if not (ratio <= 1.0 and same and body == want):
                raise AssertionError(f"matmul_batched backward {label} {which}: err/limit "
                                     f"{ratio}, same bits {same}, body {body} (expected "
                                     f"{want})")
            out[f"{label} {which}"] = r
            del got, again, ref
        del x, w, dy
    res = {}
    for which in ("dX", "dW"):
        r = out[f"{K7B_BWD_CASES[0][0]} {which}"]
        key = f"train_{which.lower()}"
        res.update({f"{key}_ms": r["ms"], f"{key}_plain_ms": r["plain_ms"],
                    f"{key}_library_ms": r["library_ms"], f"{key}_bound_ms": r["bound_ms"],
                    f"{key}_bound_by": r["bound_by"], f"{key}_shape": r["shape"],
                    f"{key}_wgmma_ms": r["wgmma_ms"],
                    f"{key}_persistent_ms": r["persistent_ms"]})
    gc.collect()
    torch.cuda.empty_cache()
    return res


def kept_experts(MOE, cfg_moe, idx) -> set:
    """The experts that receive at least one kept row from the choices
    ``idx`` (B, S, k) of one layer call, at the call's capacity."""
    slot, keep = MOE.dispatch_slots(cfg_moe, idx, MOE.capacity_of(cfg_moe, idx.shape[1]))
    return set(idx[keep].unique().tolist())


def moe_train_rel(torch, np) -> dict:
    """Phase 26b's measurements: one 1 x ``TRAIN_SEQ`` microbatch of
    deepseek-moe-16b in fp32 at full width cut to ``MOE_TRAIN_DEPTHS``
    layers (1 dense + 1 and + 3 MoE), remat "full", its loss and every
    gradient (``torch.autograd.grad`` of the train step's loss, aux loss
    included): through the plain versions, every router top-k recorded in
    call order (the forward's, then the recompute's); then twice through
    the kernels, each top-k replaced by the plain run's choices with their
    probabilities gathered from the kernels' own (so the router's gradient
    flows through them as through top-k's values), the kernels' own
    choices recorded.  Before each run the allocator's free blocks are
    filled with NaN (:func:`poison_cached_memory`).

    Then two more runs on the same routes, for the gate's yardstick: the
    plain versions with the plain attention's KV tile at 64 (another
    summation order), and the kernels with every weight product summed in
    fp64 and rounded once ("exact products", as phase 14).

    Returns, per depth: loss_rel and aux_rel (relative); grad_rel, the
    worst leaf's largest difference over its largest entry (and which
    leaf); expert_rel, the worst (layer, expert) slice of the experts'
    weights' gradients against its own largest entry; exact_ratio, the
    worst leaf's distance from the exact-products run over the plain
    run's (and which leaf; worst_ratios, the four worst); plain_spread, the two plain runs' worst leaf
    apart; exact_plain, the plain run's worst leaf from the exact one;
    absolute, whether the depth is also held to the absolute limits; missing, the
    experts with no kept row in some MoE layer; flips, the plain run's
    smallest neighbouring top-(k+1) log-probability gap of each token the
    kernels' own choice routes otherwise; same, whether the two kernel runs
    gave the same bits (loss and every gradient); finite; whether the
    kernel runs launched kernels only."""
    from unittest import mock

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer
    from repro_torch.models.layers import linear
    from repro_torch.models.layers import moe as MOE
    from repro_torch.models.layers.module import tree_map
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    full = arch_registry.config("deepseek-moe-16b").replace(
        compute_dtype="float32", num_layers=max(MOE_TRAIN_DEPTHS))
    m = full.moe
    params = transformer.init(full, torch.Generator("cuda").manual_seed(0))
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             next(SyntheticTokens(full, 1, TRAIN_SEQ, seed=5)).items()}
    topk = torch.topk

    def is_route(probs, k):
        return k == m.top_k and probs.shape[-1] == m.num_experts

    def recording(into):
        def wrapped(probs, k, *a, **kw):
            res = topk(probs, k, *a, **kw)
            if is_route(probs, k):
                into.append((res.indices, torch.log(probs.detach())))
            return res
        return wrapped

    def replaying(routes, own):
        it = iter(routes)

        def wrapped(probs, k, *a, **kw):
            if not is_route(probs, k):
                return topk(probs, k, *a, **kw)
            own.append(topk(probs.detach(), k, *a, **kw).indices)
            idx = next(it)[0]
            return torch.return_types.topk((probs.gather(-1, idx), idx))
        return wrapped

    def run(cfg, p, patch, chunk=4096):
        poison_cached_memory(torch)
        ps = leaves(p)
        for t in ps:
            t.requires_grad_(True)
        with mock.patch.object(torch, "topk", patch):
            total, metrics = make_loss_fn(cfg, chunk=chunk)(p, batch)
            grads = torch.autograd.grad(total, ps)
        for t in ps:
            t.requires_grad_(False)
        torch.cuda.synchronize()
        return total.detach(), metrics["aux_loss"].detach(), grads

    def rel(a, b):      # an expert no row reached has a zero gradient on both sides
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp(min=1e-30)).item()

    def exact(x, y):
        return (x.double() @ y.double()).to(x.dtype)

    def exact_batched(x, y):
        return torch.bmm(x.double(), y.double()).to(x.dtype)

    def slices(names, grads):
        """Every leaf, then every (layer, expert) slice of the experts' weights."""
        for n, g in zip(names, grads):
            yield n, g
        for n, g in zip(names, grads):
            if n in ("blocks.moe.w_gate", "blocks.moe.w_up", "blocks.moe.w_down"):
                for layer in range(g.shape[0]):
                    for e in range(g.shape[1]):
                        yield f"{n}[{layer}, {e}]", g[layer, e]

    out = {}
    for depth in MOE_TRAIN_DEPTHS:
        cfg = full.replace(num_layers=depth)
        n_moe = depth - m.first_k_dense
        p = dict(params, blocks=tree_map(lambda t: t[:n_moe].clone(), params["blocks"]))
        names = [".".join(map(str, k)) for k in flat_keys(p)]
        routes, own, own2 = [], [], []
        with dispatch.plain_versions():
            loss_p, aux_p, g_p = run(cfg, p, recording(routes))
        dispatch.reset_counts()
        loss_k, aux_k, g_k = run(cfg, p, replaying(routes, own))
        table = dispatch.kernel_table()
        launched = (all(table[n].launches > 0 for n in ("matmul", "matmul_batched",
                                                         "flash_attention",
                                                         "flash_attention_backward"))
                    and not any(t.plain_calls for t in table.values()))
        loss_k2, aux_k2, g_k2 = run(cfg, p, replaying(routes, own2))
        same = bool(torch.equal(loss_k, loss_k2) and torch.equal(aux_k, aux_k2)
                    and all(torch.equal(a, b) for a, b in zip(g_k, g_k2)))
        del g_k2
        with dispatch.plain_versions():       # the plain attention's KV tile 64, not 4096
            g_p64 = run(cfg, p, replaying(routes, []), chunk=64)[2]
        with mock.patch.object(linear, "_k7", exact), \
                mock.patch.object(linear, "_k7_batched", exact_batched):
            g_x = run(cfg, p, replaying(routes, []))[2]
        grad, expert, ratios = (0.0, ""), (0.0, ""), []
        for (n, a), (_, b), (_, x) in zip(slices(names, g_k), slices(names, g_p),
                                          slices(names, g_x)):
            r = (rel(a, b), n)
            if "[" in n:
                expert = max(expert, r)
                continue
            grad = max(grad, r)
            ratios.append((rel(a, x) / max(rel(b, x), 1e-7), n))
        ratio = max(ratios)
        plain_spread = max(rel(a, b) for a, b in zip(g_p64, g_p))
        exact_plain = max(rel(b, x) for b, x in zip(g_p, g_x))
        del g_p64, g_x
        # a layer's calls: the forward's n_moe, then the recompute's, last first
        missing = []
        for layer in range(n_moe):
            got = kept_experts(MOE, m, routes[layer][0])
            missing.append(sorted(set(range(m.num_experts)) - got))
        flips = []                                  # the forward's calls
        for (pi, plp), oi in zip(routes[:n_moe], own):
            differ = (pi != oi).any(-1)
            if bool(differ.any()):
                top = torch.topk(plp, m.top_k + 1, dim=-1).values
                flips += (top[..., :-1] - top[..., 1:]).min(-1).values[differ].tolist()
        recompute_same = all(torch.equal(routes[i][0], routes[2 * n_moe - 1 - i][0])
                             for i in range(n_moe))
        out[depth] = dict(
            loss_rel=abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()),
            aux_rel=abs(aux_k.item() - aux_p.item()) / abs(aux_p.item()),
            loss=loss_p.item(), aux=aux_p.item(), grad_rel=grad[0], grad_leaf=grad[1],
            depth=depth, expert_rel=expert[0], expert_slice=expert[1], exact_ratio=ratio[0],
            exact_ratio_at=ratio[1], worst_ratios=sorted(ratios, reverse=True)[:4],
            plain_spread=plain_spread, exact_plain=exact_plain,
            absolute=depth in MOE_TRAIN_ABSOLUTE, missing=missing, flips=flips,
            routed=TRAIN_SEQ * n_moe, calls=len(routes), recompute_same=recompute_same,
            same=same, launched=launched,
            finite=bool(torch.isfinite(loss_k) and all(torch.isfinite(g).all() for g in g_k)))
        del p, g_p, g_k
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flat_keys(tree, prefix=()) -> list:
    """The key paths of a tree's leaves, in ``leaves``' order."""
    if isinstance(tree, dict):
        return [k for key, v in tree.items() for k in flat_keys(v, prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [k for i, v in enumerate(tree) for k in flat_keys(v, prefix + (i,))]
    return [prefix]


def moe_train_fails(r: dict) -> bool:
    """Whether phase 26b's check fails at a depth: anything not finite, the
    loss or aux loss past ``TOL_TRAIN_LOSS_REL``, a leaf farther than
    ``TOL_MOE_EXACT_RATIO`` times the plain run's from the exact
    products, at the ``MOE_TRAIN_ABSOLUTE`` depths a leaf past
    ``TOL_TRAIN_GRAD_REL`` or an expert's slice past
    ``TOL_MOE_EXPERT_GRAD_REL``, a route decided otherwise where the plain
    run had no near-tie, an expert with no kept row, the recompute routing
    otherwise than the forward, or two kernel runs apart."""
    return not (r["finite"] and r["loss_rel"] <= TOL_TRAIN_LOSS_REL
                and r["aux_rel"] <= TOL_TRAIN_LOSS_REL
                and r["exact_ratio"] <= TOL_MOE_EXACT_RATIO[r["depth"]]
                and (not r["absolute"] or (r["grad_rel"] <= TOL_TRAIN_GRAD_REL
                                           and r["expert_rel"] <= TOL_MOE_EXPERT_GRAD_REL))
                and all(g < TOL_MOE_FLIP_GAP for g in r["flips"])
                and not any(r["missing"]) and r["recompute_same"] and r["same"])


def moe_train_path_check(torch, np) -> None:
    """Phase 26b: the gate on :func:`moe_train_rel`."""
    for depth, r in moe_train_rel(torch, np).items():
        log(f"moe training path check (fp32, full width, depth {depth}: 1 dense + "
            f"{depth - 1} MoE, 1 x {TRAIN_SEQ} tokens, remat full): kernels replaying the "
            f"plain routes vs plain: loss {r['loss']:.6f} rel {r['loss_rel']:.3e}, aux "
            f"{r['aux']:.6e} rel {r['aux_rel']:.3e} (tol {TOL_TRAIN_LOSS_REL}); worst leaf "
            f"{r['grad_leaf']} {r['grad_rel']:.3e} of its largest (tol "
            f"{TOL_TRAIN_GRAD_REL}{'' if r['absolute'] else ', not gated here'}); worst "
            f"expert slice {r['expert_slice']} {r['expert_rel']:.3e} of its own largest (tol "
            f"{TOL_MOE_EXPERT_GRAD_REL}{'' if r['absolute'] else ', not gated here'}); vs "
            f"exact products: plain's worst leaf {r['exact_plain']:.3e}, the kernels' "
            f"distance over the plain run's, worst leaves "
            f"{[(f'{v:.3f}', n) for v, n in r['worst_ratios']]} (tol "
            f"{TOL_MOE_EXACT_RATIO[depth]}); two plain runs (KV tile 64 / 4096) "
            f"{r['plain_spread']:.3e} apart; "
            f"their own decisions: {len(r['flips'])} of {r['routed']} routed tokens "
            f"otherwise, gaps {[f'{g:.2e}' for g in r['flips']]} (each must be < "
            f"{TOL_MOE_FLIP_GAP}); experts with no kept row by MoE layer {r['missing']}; "
            f"{r['calls']} router calls, the recompute's routes the forward's="
            f"{r['recompute_same']}; two kernel runs the same bits={r['same']}; "
            f"finite={r['finite']}; only kernels launched={r['launched']}")
        if not r["launched"]:
            raise AssertionError("moe training path check: the kernel run did not run "
                                 "through K7, its batched entry and K4 alone")
        if moe_train_fails(r):
            raise AssertionError(f"moe training path check, depth {depth}: {r}")


def moe_train_counts(cfg, micro: int) -> dict:
    """Launches by body of ``micro`` training microbatches of the MoE
    transformer at bf16 compute under remat "full", from the config: a
    dense block's 7 weight products and an MoE block's 4 attention
    products and its shared experts' 3 on wgmma, the router's fp32 product
    on FMA, each launched in the forward, again in the recompute and twice
    in the backward (dX, dW); the fp32 LM head on FMA in the forward and
    twice in the backward; the experts' 3 products a MoE layer on the
    batched entry, in the forward, the recompute and dX on its wgmma
    body, dW (contracting over the capacity) on its persistent one; K4 a
    layer in the forward and the recompute, its backward once, all on
    mma."""
    m = cfg.moe
    L, n_moe = cfg.num_layers, cfg.num_layers - m.first_k_dense
    blocks = 7 * m.first_k_dense + (4 + (3 if m.num_shared_experts else 0)) * n_moe
    return {"matmul": {"wgmma": 4 * blocks * micro, "fma": (4 * n_moe + 3) * micro},
            "matmul_batched": {"wgmma": 3 * 3 * n_moe * micro,
                               "wgmma_persistent": 3 * n_moe * micro},
            "flash_attention": {"mma": 2 * L * micro},
            "flash_attention_backward": {"mma": L * micro}}


def moe_training_phase(torch, np, table) -> dict:
    """Phase 26c: deepseek-moe-16b at full width cut to
    ``MOE_TRAIN_LAYERS`` layers (1 dense + 3 MoE: ~2.27 B parameters), fp32
    master weights, bf16 compute, AdamW with the launcher's recipe, remat
    "full", trained by the port's ``Trainer`` for ``MOE_TRAIN_STEPS`` steps
    of ``MOE_TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens in ``MOE_TRAIN_ACCUM``
    microbatches.  Every loss and aux loss finite; launches exact by body
    (:func:`moe_train_counts`), no plain call.  Step time (the mean of the
    steps after the first), tokens/s, tokens/s/W against the power limit,
    peak memory; then one microbatch under the profiler (device activity
    only) beside CUDA events around it: device time by kernel, the busy
    share, and the recompute's routes against the forward's.  Returns the
    launches by kernel."""
    import tempfile
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models.layers import moe as MOE
    from repro_torch.optim.optimizers import adamw, leaves, warmup_cosine
    from repro_torch.training.train_step import make_loss_fn
    from repro_torch.training.trainer import Trainer, TrainerConfig

    name, watts = card_name_and_power_limit()
    cfg = arch_registry.config("deepseek-moe-16b").replace(num_layers=MOE_TRAIN_LAYERS)
    want = moe_train_counts(cfg, MOE_TRAIN_ACCUM * MOE_TRAIN_STEPS)
    data = SyntheticTokens(cfg, MOE_TRAIN_BATCH, TRAIN_SEQ, seed=0)
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(num_steps=MOE_TRAIN_STEPS, ckpt_every=50, ckpt_dir=d,
                           device="cuda")
        tr = Trainer(cfg, iter(data), tc, accum=MOE_TRAIN_ACCUM,
                     optimizer=adamw(warmup_cosine(3e-3, 20, MOE_TRAIN_STEPS)))
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_counts()
        t0 = time.monotonic()
        hist = tr.train()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        got = {n: dict(table[n].body_launches) for n in want}
        plain = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
    peak = torch.cuda.max_memory_allocated()
    steps = [h for h in hist if "loss" in h]
    losses, aux = [h["loss"] for h in steps], [h["aux_loss"] for h in steps]
    times = [h["step_time_s"] for h in steps]
    step = statistics.mean(times[1:])
    tokens = MOE_TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in leaves(tr.params))
    m = cfg.moe
    log(f"moe training: deepseek-moe-16b cut to L={cfg.num_layers} (first {m.first_k_dense} "
        f"dense, d_ff {m.d_ff_dense}; {cfg.num_layers - m.first_k_dense} MoE of "
        f"{m.num_experts} experts top-{m.top_k} d_ff_expert {m.d_ff_expert} + "
        f"{m.num_shared_experts} shared) d_model={cfg.d_model} vocab={cfg.vocab_size} "
        f"params={n_params} fp32 master weights, {cfg.compute_dtype} compute, "
        f"remat={cfg.remat}, adamw; {MOE_TRAIN_STEPS} steps of {MOE_TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in {MOE_TRAIN_ACCUM} microbatches; wall {wall:.1f}s (init "
        f"included)")
    log(f"moe training: losses={[round(v, 4) for v in losses]} aux={[f'{v:.4e}' for v in aux]} "
        f"first_step={times[0]:.3f}s step={step:.3f}s tokens/s={tokens / step:.1f} "
        f"tokens/s/W={tokens / step / watts:.4f} at power.limit {watts:.0f} W ({name}) "
        f"max_memory_allocated={peak / 2**30:.2f}GiB (params+grads+adamw state "
        f"{16 * n_params / 2**30:.2f}GiB)")
    log(f"moe training: launches by body {got} (expected {want}: a microbatch "
        f"{moe_train_counts(cfg, 1)}); plain_calls={plain or 0}")
    if len(losses) != MOE_TRAIN_STEPS or not all(np.isfinite(losses + aux)):
        raise AssertionError(f"moe training: losses {losses}, aux {aux}")
    if got != want or plain:
        raise AssertionError(f"moe training: launches {got}, expected {want}; plain calls "
                             f"{plain}")
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             next(SyntheticTokens(cfg, 1, TRAIN_SEQ, seed=9)).items()}
    ps = leaves(tr.params)
    for p in ps:
        p.requires_grad_(True)
    loss_fn = make_loss_fn(cfg)
    route, routes = MOE.route, []

    def recording(cfg_moe, prm, x, **kw):
        idx, prob, a = route(cfg_moe, prm, x, **kw)
        routes.append(idx)
        return idx, prob, a
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with mock.patch.object(MOE, "route", recording), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        start.record()
        loss, _ = loss_fn(tr.params, batch)
        torch.autograd.grad(loss, ps)
        end.record()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    for p in ps:
        p.requires_grad_(False)
    n_moe = cfg.num_layers - m.first_k_dense
    recompute_same = len(routes) == 2 * n_moe and all(
        torch.equal(routes[i], routes[2 * n_moe - 1 - i]) for i in range(n_moe))
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    if not busy:
        raise AssertionError("moe training profile: the profiler saw no device time")
    by = {"K7 matmul": ("matmul_wgmma_kernel", "matmul_kernel", "matmul_persistent_kernel"),
          "of which K7's persistent body (dW)": ("matmul_persistent_kernel",),
          "K4": ("flash_kernel", "flash_mma_kernel"), "K4 backward": ("fa_bwd_",)}
    parts = {k: sum(r[0] for r in rows if any(n in r[2] for n in v)) / 1e3
             for k, v in by.items()}
    log(f"moe training profile (one 1 x {TRAIN_SEQ} microbatch, forward, recompute and "
        f"backward): wall={wall:.3f}s device_busy={busy:.3f}s (profiler; CUDA events from "
        f"the first launch to the last {start.elapsed_time(end) / 1e3:.3f}s) busy_share="
        f"{busy / wall:.3f} idle_share={1 - busy / wall:.3f}; "
        + ", ".join(f"{k} {v:.3f}s ({v / busy:.3f} of device time)" for k, v in parts.items())
        + f"; the recompute routed as the forward={recompute_same}")
    for ms, count, key in rows[:12]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {key[:90]}")
    if not recompute_same:
        raise AssertionError(f"moe training: the recompute routed otherwise than the "
                             f"forward ({len(routes)} router calls)")
    del tr, ps, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(c.values()) for n, c in got.items()}


# the kernels line's keys of K7's batched entry at phase 26a's training shape
def vlm_serving_phase(torch, np, table) -> dict:
    """Phase 27a: qwen2-vl-72b at full width cut to ``VLM_LAYERS`` layers,
    bf16, through the paged engine: 4 slots, 256-row prefill chunks, phase
    4's 8 requests, 32 new tokens each, M-RoPE on three equal streams (the
    vision frontend is a stub).  Launches held exactly by body per model
    call: K2 a layer a prefill chunk, K1 a layer a decode step, all
    ``mma``; K7 7 a layer on wgmma and the fp32 LM head on FMA; no plain
    call, no other kernel.  tok/s, TTFT, TPOT, tok/s/W, peak memory, the
    pool's bytes a token, a profiled window's busy share.  Random weights
    from seed 0, the product weights drawn a layer at a time and stored in
    bf16 (``init(cast_products=True)``), as the serving launcher loads
    them."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import leaves
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    name, watts = card_name_and_power_limit()
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    cfg = arch_registry.config("qwen2-vl-72b").replace(num_layers=VLM_LAYERS)
    params = transformer.init(cfg, torch.Generator("cuda").manual_seed(0), cast_products=True)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    init_s, init_gib = time.monotonic() - t0, torch.cuda.max_memory_allocated() / 2**30
    eng = ServingEngine(cfg, params, max_len=1024 + 32, batch_slots=4, prefill_chunk=256,
                        device="cuda")
    del params
    log(f"vlm serving: qwen2-vl-72b L={cfg.num_layers} of 80 d_model={cfg.d_model} "
        f"H={cfg.num_heads} K={cfg.num_kv_heads} D={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} M-RoPE sections {cfg.m_rope_sections} theta "
        f"{cfg.rope_theta:.0f} params={n_params} (products bf16, norms / embedding / head "
        f"fp32); init {init_s:.1f}s, peak {init_gib:.2f} GiB after the load")
    eng.serve([Request(100, np.arange(40, dtype=np.int32), max_new_tokens=4,
                       sampler=greedy())])                           # warm-up
    reqs = serving_requests(cfg, np, Request, greedy)
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
    bodies, plain = launched_bodies(table)
    calls = chunks[0] + stats.decode_steps
    L = cfg.num_layers
    want = {"paged_prefill_attention": {"mma": L * chunks[0]},
            "paged_decode_attention": {"mma": L * stats.decode_steps},
            "matmul": {"wgmma": QWEN_PRODUCTS * L * calls, "fma": calls}}
    for r in reqs:
        if r.state.value != "done" or len(r.output) != 32:
            raise AssertionError(f"vlm request {r.rid}: state {r.state}, "
                                 f"{len(r.output)} tokens")
    state = eng._state
    pool_bytes = sum(t.numel() * t.element_size() for t in state if t.dim() > 2)
    pool_rows = state.k.shape[1] * state.k.shape[2]
    leaks = eng.pool.leak_report()
    log(f"vlm serving: requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s tok/s={stats.tokens_per_s:.2f} "
        f"ttft_p50={stats.ttft_p50_s * 1e3:.1f}ms ttft_p99={stats.ttft_p99_s * 1e3:.1f}ms "
        f"tpot={stats.mean_tpot_s * 1e3:.2f}ms occupancy={stats.slot_occupancy:.2f} "
        f"tok/s/W={stats.tokens_per_s / watts:.4f} at power.limit {watts:.0f} W ({name}); "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB; KV pool "
        f"{pool_bytes} B ({pool_rows} rows of {pool_bytes // pool_rows} B)")
    log(f"vlm serving: {chunks[0]} prefill chunks, {stats.decode_steps} decode steps, "
        f"prefill_tokens={stats.prefill_tokens_computed}/{stats.prefill_tokens_total}; "
        f"launches by body {bodies} (expected {want}) plain_calls={plain or 0} leaks={leaks}")
    if bodies != want or plain or any(leaks.values()) \
            or pool_bytes // pool_rows != VLM_KV_BYTES:
        raise AssertionError(f"vlm serving: launches {bodies}, expected {want}; plain "
                             f"calls {plain}; leaks {leaks}; {pool_bytes // pool_rows} B a "
                             f"token (expected {VLM_KV_BYTES})")
    profile_phase(torch, np, eng, Request, greedy, "vlm serving", n=1, new=8)
    del eng, state
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(c.values()) for n, c in bodies.items()}


def vlm_path_check(torch, np) -> None:
    """Phase 27b: phase 6's engine-driven fp32 path check on qwen2-vl-72b's
    widths at depths ``VLM_PATH_DEPTHS``, and the M-RoPE prefill whose
    streams differ (:func:`streams_check`)."""
    path_check(torch, np, arch="qwen2-vl-72b", depths=VLM_PATH_DEPTHS,
               limits=VLM_PATH_LIMITS, seeds=PATH_SEEDS, layers=max(VLM_PATH_DEPTHS))


def cross_case(torch, S, S_kv, dtype, *, B=1, H=WHISPER_HEADS, K=WHISPER_HEADS,
               D=WHISPER_D, seed=0):
    """q (B, S, H, D) against k, v (B, S_kv, K, D) of their own length."""
    g = torch.Generator("cuda").manual_seed(seed + S + S_kv)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((B, S_kv, K, D), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def whisper_kernel_phase(torch, table) -> dict:
    """Phase 28a: K4 non-causal at whisper-medium's encoder and
    cross-attention shapes (``WHISPER_K4_CASES``: S = S_kv = 1500, S = 192
    against S_kv = 1500 and a ragged 1037, one query row, S_kv past a tile
    by one) and K3 at the cross-attention's decode shape (B = 4 slots
    against 1500 rows; ragged lengths, NaN in the rows past them) against
    their plain versions evaluated in fp32 on the same values, at fp32
    (FMA) and bf16 (``mma``; K4's K/V tiles staged only up to S_kv); then
    K4's encoder, cross and ragged cross shapes and K3's timed in bf16
    beside the plain version, SDPA on the same tensors and the bound.
    Returns the kernels line's whisper extras of K4 and K3."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import dense_body_for
    from repro_torch.kernels.flash_attention.ops import body_for as flash_body_for
    fla, dec = table["flash_attention"], table["decode_attention"]
    timer = Timer(torch)
    H, D = WHISPER_HEADS, WHISPER_D
    errs = {}

    def poison_cache(args):
        poison_cache_rows(torch, *args)

    for dtype in (torch.float32, torch.bfloat16):
        for S, S_kv in WHISPER_K4_CASES:
            args = cross_case(torch, S, S_kv, dtype)
            errs.setdefault(("flash_attention", dtype), []).append(hold(
                torch, fla, args, f"B=1 S={S} S_kv={S_kv} H=K={H} D={D} non-causal "
                f"body={flash_body_for(args[0])}", causal=False))
        for lengths in WHISPER_K3_LENGTHS:
            for poison in (None, poison_cache):
                args = dense_decode_case(torch, lengths, dtype, S=WHISPER_FRAMES, H=H, K=H,
                                         D=D)
                errs.setdefault(("decode_attention", dtype), []).append(hold(
                    torch, dec, args, f"B=4 S={WHISPER_FRAMES} H=K={H} D={D} lengths="
                    f"{lengths} body={dense_body_for(args[0], args[1])}"
                    f"{' NaN past the lengths' if poison else ''}", poison=poison))
    out = {"flash_attention": {}, "decode_attention": {}}

    def timed(kern, tag, args, lib, nbytes, flops, shape, **kw):
        r = out[kern.name]
        r[f"{tag}_ms"] = timer(lambda: kern.launch(*args, **kw))
        r[f"{tag}_plain_ms"] = timer(lambda: kern.plain(*args, **kw))
        r[f"{tag}_library_ms"] = timer(lib)
        r[f"{tag}_bound_ms"], r[f"{tag}_bound_by"] = bound(nbytes, flops, BF16_FLOPS)
        r[f"{tag}_shape"] = shape
        log(f"{kern.name} timed {shape}: kernel {r[f'{tag}_ms']:.4f}ms plain "
            f"{r[f'{tag}_plain_ms']:.4f}ms SDPA {r[f'{tag}_library_ms']:.4f}ms bound "
            f"{r[f'{tag}_bound_ms']:.5f}ms ({r[f'{tag}_bound_by']}; {nbytes} B, {flops} flop)")
    for tag, (S, S_kv) in (("whisper_encoder", (1500, 1500)), ("whisper_cross", (192, 1500)),
                           ("whisper_cross_ragged", (192, 1037))):
        q, k, v = cross_case(torch, S, S_kv, torch.bfloat16)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        timed(fla, tag, (q, k, v),
              lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh),
              2 * 2 * (S + S_kv) * H * D, 4 * H * D * S * S_kv,
              f"B=1 S={S} S_kv={S_kv} H=K={H} D={D} non-causal bf16 body={flash_body_for(q)}",
              causal=False)
    q, k, v, lens = dense_decode_case(torch, WHISPER_K3_LENGTHS[0], torch.bfloat16,
                                      S=WHISPER_FRAMES, H=H, K=H, D=D)
    kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
    B, rows = q.shape[0], sum(WHISPER_K3_LENGTHS[0])
    timed(dec, "whisper_cross_decode", (q, k, v, lens),
          lambda: F.scaled_dot_product_attention(q[:, :, None, :], kh, vh),
          2 * (2 * B * H * D + 2 * rows * H * D) + 4 * B, 4 * H * D * rows,
          f"B=4 S={WHISPER_FRAMES} H=K={H} D={D} lengths {WHISPER_FRAMES} bf16 "
          f"body={dense_body_for(q, k)} ({-(-WHISPER_FRAMES // 64)} splits)")
    for name in out:
        out[name]["max_abs_err_whisper"] = max(errs[(name, torch.bfloat16)])
        out[name]["max_abs_err_whisper_fp32"] = max(errs[(name, torch.float32)])
    return out


def whisper_config(arch_registry, depth=None, **kw):
    """whisper-medium, its encoder and decoder cut to ``depth`` layers each
    when given."""
    import dataclasses
    cfg = arch_registry.config("whisper-medium").replace(**kw)
    if depth is None:
        return cfg
    return cfg.replace(num_layers=depth,
                       encdec=dataclasses.replace(cfg.encdec, num_encoder_layers=depth))


def whisper_counts(cfg, prefills: int, decode_steps: int) -> dict:
    """Launches by body of ``prefills`` whisper prefills and
    ``decode_steps`` decode steps at bf16 compute: K4 (encoder, decoder
    self and cross) and K3 (self and cross) on ``mma``, K7's bf16 products
    on wgmma and the fp32 LM head on FMA."""
    L, E = cfg.num_layers, cfg.encdec.num_encoder_layers
    return {"flash_attention": {"mma": (E + 2 * L) * prefills},
            "decode_attention": {"mma": 2 * L * decode_steps},
            "matmul": {"wgmma": (6 * E + 10 * L) * prefills + 8 * L * decode_steps,
                       "fma": prefills + decode_steps}}


def whisper_path_check(torch, np) -> None:
    """Phase 28b: a request (a 100-token decoder prompt, the engine's zero
    frames, one decode step) served at whisper-medium's widths in fp32 by a
    contiguous ``ServingEngine`` through the kernels and by one through the
    plain versions, at (encoder, decoder) depths ``WHISPER_PATH_DEPTHS``,
    for each of ``PATH_SEEDS``' token draws; the prefill and decode logits
    held to ``WHISPER_PATH_LIMITS`` (the kernels within rel of the plain
    versions, where the depth has one, and no farther from an
    exact-products run than ratio times the plain run), and a plain run
    with a 64-row KV tile printed beside them."""
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
    deepest = max(WHISPER_PATH_DEPTHS)
    full = whisper_config(arch_registry, deepest, compute_dtype="float32")
    params = fns_for(full).init(full, torch.Generator("cuda").manual_seed(0))

    def serve(cfg, p, toks, chunk=1024):
        eng = ServingEngine(cfg, p, max_len=128, batch_slots=1, chunk=chunk,
                            cache_dtype="float32", device="cuda")
        rec = Record()
        eng.serve([Request(0, toks, max_new_tokens=2, sampler=rec)])
        if len(rec.seen) != 2:
            raise AssertionError("whisper path check: the request did not run clean")
        return np.stack(rec.seen)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    exact_product = lambda x, y: (x.double() @ y.double()).to(x.dtype)   # noqa: E731
    for seed, depth in ((s, d) for s in PATH_SEEDS for d in WHISPER_PATH_DEPTHS):
        toks = np.random.default_rng(seed).integers(0, full.vocab_size,
                                                    size=100).astype(np.int32)
        cfg = whisper_config(arch_registry, depth, compute_dtype="float32")
        p = dict(params, enc_blocks=tree_map(lambda t: t[:depth], params["enc_blocks"]),
                 dec_blocks=tree_map(lambda t: t[:depth], params["dec_blocks"]))
        dispatch.reset_counts()
        kern = serve(cfg, p, toks)
        bodies, plain_calls = launched_bodies(dispatch.kernel_table())
        want = {"flash_attention": {"fma": 3 * depth}, "decode_attention": {"fma": 2 * depth},
                "matmul": {"fma": 16 * depth + 1 + 8 * depth + 1}}
        with dispatch.plain_versions():
            plain = serve(cfg, p, toks)
            plain64 = serve(cfg, p, toks, chunk=64)
            with mock.patch.object(linear, "_k7", exact_product):
                exact = serve(cfg, p, toks)
        tol, max_ratio = WHISPER_PATH_LIMITS[depth]
        r_pre, r_dec = rel(kern[0], plain[0]), rel(kern[1], plain[1])
        to_exact = [(rel(kern[i], exact[i]), rel(plain[i], exact[i])) for i in (0, 1)]
        ratio = max(k / max(q, 1e-7) for k, q in to_exact)
        log(f"whisper path check (fp32, full width, encoder and decoder depth {depth}, "
            f"request seed {seed}): kernels vs plain rel prefill={r_pre:.3e} "
            f"decode={r_dec:.3e} top1_agree={bool((kern.argmax(-1) == plain.argmax(-1)).all())}"
            f" ({f'tol {tol}' if tol else 'not gated'}); "
            f"plain chunk 64 vs 1024 rel prefill={rel(plain64[0], plain[0]):.3e} "
            f"decode={rel(plain64[1], plain[1]):.3e}; vs exact products: kernels rel "
            f"prefill={to_exact[0][0]:.3e} decode={to_exact[1][0]:.3e}, plain rel "
            f"prefill={to_exact[0][1]:.3e} decode={to_exact[1][1]:.3e}, worst ratio "
            f"{ratio:.3f} (tol {max_ratio}); launches {bodies}")
        if bodies != want or plain_calls:
            raise AssertionError(f"whisper path check, depth {depth}: launches {bodies} "
                                 f"(expected {want}), plain calls {plain_calls}")
        if not (np.isfinite(kern).all() and ratio <= max_ratio
                and (tol is None or max(r_pre, r_dec) <= tol)):
            raise AssertionError(f"whisper path check, depth {depth}, request seed {seed}: "
                                 f"kernels and plain versions disagree ({r_pre}, {r_dec}; "
                                 f"ratio to the exact products' distance {ratio})")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def whisper_requests(cfg, np, Request, greedy, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = WHISPER_PROMPT_RANGE
    return [Request(i, rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
                    max_new_tokens=32, sampler=greedy())
            for i, n in enumerate(rng.integers(lo, hi + 1, size=8))]


def whisper_serving_phase(torch, np, table) -> dict:
    """Phase 28c: whisper-medium at its full config (nothing cut), random
    weights from seed 0 in fp32, bf16 compute and caches, through the
    contiguous engine: 4 slots, ``max_len`` 256, 8 requests of decoder
    prompts from ``WHISPER_PROMPT_RANGE`` (seed 0), 32 new tokens each, the
    engine's zero frames.  Launches held exactly by body
    (:func:`whisper_counts`: K4 72 a prefill, K3 48 a decode step, K7 by
    the code's count); no plain call, no other kernel.  tok/s, TTFT, TPOT,
    tok/s/W, peak memory, the cross caches' bytes a slot and a profiled
    window's busy share."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models.registry import fns_for
    from repro_torch.optim.optimizers import leaves
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    name, watts = card_name_and_power_limit()
    t0 = time.monotonic()
    cfg = whisper_config(arch_registry)
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    n_params = sum(t.numel() for t in leaves(params))
    eng = ServingEngine(cfg, params, max_len=WHISPER_MAX_LEN, batch_slots=4, device="cuda")
    del params
    gc.collect()
    torch.cuda.synchronize()
    log(f"whisper serving: whisper-medium encoder {cfg.encdec.num_encoder_layers} + decoder "
        f"{cfg.num_layers} layers d_model={cfg.d_model} H={cfg.num_heads} "
        f"D={cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} frames="
        f"{cfg.encdec.num_encoder_frames} params={n_params}; init {time.monotonic() - t0:.1f}s")
    eng.serve([Request(100, np.arange(40, dtype=np.int32), max_new_tokens=4,
                       sampler=greedy())])                           # warm-up
    reqs = whisper_requests(cfg, np, Request, greedy)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    bodies, plain = launched_bodies(table)
    want = whisper_counts(cfg, stats.prefills, stats.decode_steps)
    for r in reqs:
        if r.state.value != "done" or len(r.output) != 32:
            raise AssertionError(f"whisper request {r.rid}: state {r.state}, "
                                 f"{len(r.output)} tokens")
    st = eng._state
    cross = (st.cross_k.numel() + st.cross_v.numel()) * st.cross_k.element_size() \
        // st.cross_k.shape[1]
    log(f"whisper serving: requests={stats.requests} tokens={stats.tokens} "
        f"wall={stats.wall_s:.3f}s tok/s={stats.tokens_per_s:.2f} "
        f"ttft_p50={stats.ttft_p50_s * 1e3:.1f}ms ttft_p99={stats.ttft_p99_s * 1e3:.1f}ms "
        f"tpot={stats.mean_tpot_s * 1e3:.2f}ms occupancy={stats.slot_occupancy:.2f} "
        f"tok/s/W={stats.tokens_per_s / watts:.4f} at power.limit {watts:.0f} W ({name}); "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB; cross "
        f"K/V {cross} B a slot; prompts {[len(r.prompt) for r in reqs]}")
    log(f"whisper serving: {stats.prefills} prefills, {stats.decode_steps} decode steps; "
        f"launches by body {bodies} (expected {want}) plain_calls={plain or 0}")
    if bodies != want or plain:
        raise AssertionError(f"whisper serving: launches {bodies}, expected {want}; plain "
                             f"calls {plain}")
    profile_phase(torch, np, eng, Request, greedy, "whisper serving", n=1, new=8, prompt=128)
    del eng, st
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(c.values()) for n, c in bodies.items()}


# ---------------------------------------------------------------------------
# whisper-medium and qwen2-vl-72b training (phases 29 and 30)
# ---------------------------------------------------------------------------


def cross_grad_case(torch, S, S_kv, H, K, dtype, *, D=WHISPER_D, seed=0):
    """q and a random output gradient (1, S, H, D), and k, v (1, S_kv, K, D),
    each of k and v the first S_kv rows of a buffer 64 rows longer whose
    last 64 rows are NaN: rows no K/V tile may stage."""
    g = torch.Generator("cuda").manual_seed(seed + S + S_kv + H)
    q, do = (torch.randn((1, S, H, D), generator=g, device="cuda").to(dtype) for _ in range(2))
    kv = []
    for _ in range(2):
        buf = torch.full((1, S_kv + 64, K, D), float("nan"), device="cuda", dtype=dtype)
        buf[:, :S_kv] = torch.randn((1, S_kv, K, D), generator=g, device="cuda").to(dtype)
        kv.append(buf[:, :S_kv])
    return q, kv[0], kv[1], do


def whisper_backward_phase(torch, table) -> dict:
    """Phase 29a: K4 with its log-sum-exp, then its backward, non-causal at
    ``K4B_WHISPER_CASES`` (k and v of their own length, NaN right after
    them), fp32 and bf16, each against its plain version evaluated in fp32
    on the same values: the backward on the body its route picks and, for
    bf16, on "fma" too, the route's body launched twice for the same bits.
    Then both bodies timed at the encoder's (1500 x 1500) and the
    cross-attention's (448 x 1500) shapes, bf16, H = K = 16, D = 64, beside
    the plain version, SDPA's backward (autograd of
    ``scaled_dot_product_attention`` on the same tensors, measured only)
    and the bound.  Returns the kernels line's whisper extras of K4's
    backward."""
    import torch.nn.functional as F
    from repro_torch.kernels.dispatch import GRAD_RTOL
    from repro_torch.kernels.flash_attention.ops import backward_body_for
    fwd, bwd = table["flash_attention"], table["flash_attention_backward"]
    timer = Timer(torch)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for S, S_kv, H, K in K4B_WHISPER_CASES:
            q, k, v, do = cross_grad_case(torch, S, S_kv, H, K, dtype)
            out, lse = fwd.launch(q, k, v, causal=False, with_lse=True)
            ref_lse = fwd.plain(q.float(), k.float(), v.float(), causal=False,
                                with_lse=True)[1]
            lse_rel = ((lse - ref_lse).abs().max() / ref_lse.abs().max().clamp(min=1.0)).item()
            label = (f"B=1 S={S} S_kv={S_kv} H={H} K={K} D={WHISPER_D} non-causal, NaN past k "
                     f"and v (limit {GRAD_RTOL[dtype]:.2e} of each gradient's max|ref|)")
            if not lse_rel <= 1e-5:
                raise AssertionError(f"flash_attention {label}: lse off by {lse_rel}")
            args = (q, k, v, out, do, lse)
            route = backward_body_for(q)
            for body in dict.fromkeys((route, "fma")):
                errs.setdefault((dtype, body), []).append(
                    hold(torch, bwd, args, f"{label} body={body}", causal=False, body=body))
            first = bwd.launch(*args, causal=False)
            again = bwd.launch(*args, causal=False)
            torch.cuda.synchronize()
            if not all(torch.equal(u, w) for u, w in zip(first, again)):
                raise AssertionError(f"flash_attention_backward {label} body={route}: two "
                                     f"launches differ")
    r = {}
    H = K = WHISPER_HEADS
    for tag, S in (("whisper_encoder", WHISPER_FRAMES), ("whisper_cross", WHISPER_DECODER_CONTEXT)):
        q, k, v, do = cross_grad_case(torch, S, WHISPER_FRAMES, H, K, torch.bfloat16)
        out, lse = fwd.launch(q, k, v, causal=False, with_lse=True)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        y = F.scaled_dot_product_attention(qh, kh, vh)
        dyh = do.transpose(1, 2).contiguous()
        nbytes, flops, fma_flops = attention_backward_work(1, S, H, K, WHISPER_D, 2,
                                                           S_kv=WHISPER_FRAMES)
        args = (q, k, v, out, do, lse)
        r[f"{tag}_ms"] = timer(lambda: bwd.launch(*args, causal=False))
        r[f"{tag}_fma_ms"] = timer(lambda: bwd.launch(*args, causal=False, body="fma"))
        r[f"{tag}_plain_ms"] = timer(lambda: bwd.plain(*args, causal=False))
        r[f"{tag}_library_ms"] = timer(lambda: torch.autograd.grad(y, (qh, kh, vh), dyh,
                                                                   retain_graph=True))
        r[f"{tag}_bound_ms"], r[f"{tag}_bound_by"] = bound(nbytes, flops, BF16_FLOPS)
        r[f"{tag}_shape"] = (f"B=1 S={S} S_kv={WHISPER_FRAMES} H=K={H} D={WHISPER_D} "
                             f"non-causal bf16 body={backward_body_for(q)}")
        log(f"flash_attention_backward timed {r[f'{tag}_shape']}: mma body "
            f"{r[f'{tag}_ms']:.4f}ms fma body {r[f'{tag}_fma_ms']:.4f}ms plain "
            f"{r[f'{tag}_plain_ms']:.4f}ms SDPA backward {r[f'{tag}_library_ms']:.4f}ms (mma / "
            f"SDPA {r[f'{tag}_ms'] / r[f'{tag}_library_ms']:.2f}) bound "
            f"{r[f'{tag}_bound_ms']:.5f}ms ({r[f'{tag}_bound_by']}; {nbytes} B, {flops} flop; the "
            f"FMA body's own at 67 TFLOP/s fp32 {bound(nbytes, fma_flops, FP32_FLOPS)[0]:.4f}ms)")
        del y, qh, kh, vh
    r["max_abs_err_whisper"] = max(errs[(torch.bfloat16, "mma")])
    r["max_abs_err_whisper_bf16_fma"] = max(errs[(torch.bfloat16, "fma")])
    r["max_abs_err_whisper_fp32"] = max(errs[(torch.float32, "fma")])
    return r


def whisper_train_counts(cfg, micro: int) -> dict:
    """Launches by body of ``micro`` whisper training microbatches under
    remat "full", from the config: K4 once an encoder layer and twice a
    decoder layer (causal self, cross) and again in the recompute of each
    checkpointed block, its backward once each; K7 six products an encoder
    layer (q k v o, the MLP's two), eight a decoder layer (self q k v o,
    cross q and o, the MLP's two), the cross K/V two a decoder layer
    (projected once a forward, outside the checkpoints) and the LM head,
    the blocks' again in the recompute, every one twice in the backward
    (dX, dW).  bf16 compute: K4 and its backward on "mma", the products on
    wgmma but the fp32 head's three on FMA; fp32: everything on FMA."""
    E, L = cfg.encdec.num_encoder_layers, cfg.num_layers
    blocks = 6 * E + 8 * L
    fwd = blocks + 2 * L + 1
    return _train_counts(cfg, micro, E + 2 * L, fwd + blocks + 2 * fwd)


def vlm_train_counts(cfg, micro: int) -> dict:
    """Launches by body of ``micro`` qwen2-vl training microbatches under
    remat "full": K4 a layer and again in the recompute, its backward once;
    K7 seven products a layer, again in the recompute, and the LM head,
    every one twice in the backward.  Bodies as :func:`whisper_train_counts`."""
    L = cfg.num_layers
    fwd = QWEN_PRODUCTS * L + 1
    return _train_counts(cfg, micro, L, fwd + QWEN_PRODUCTS * L + 2 * fwd)


def _train_counts(cfg, micro, attentions, products) -> dict:
    tc = "mma" if cfg.compute_dtype == "bfloat16" else "fma"
    return {"flash_attention": {tc: 2 * attentions * micro},
            "flash_attention_backward": {tc: attentions * micro},
            "matmul": ({"wgmma": (products - 3) * micro, "fma": 3 * micro} if tc == "mma"
                       else {"fma": products * micro})}


def family_train_path_rel(torch, np, arch, seeds=PATH_SEEDS) -> list:
    """Phases 29b and 30a's measurements.  ``arch`` (whisper-medium, its
    encoder and decoder each cut to the depth; qwen2-vl-72b) in fp32 at full
    width, weights from seed 0, cut to each of ``TRAIN_PATH_DEPTHS``; for
    each of ``seeds`` one microbatch under remat "full" (whisper: 1 x
    448 tokens and 1500 frames; qwen2-vl: 1 x ``VLM_CHECK_SEQ``, position
    streams 1 and 2 drawn apart from stream 0): the loss and every gradient
    through the kernels, through the plain versions, and through the
    kernels with every weight product summed in fp64 and rounded once
    ("exact products").  The kernels' gradients wait on the host while the
    other two runs take the card (qwen2-vl's depth 2 holds 17 GB of fp32
    weights, and as much a set of gradients).

    Returns a dict per (seed, depth): loss_rel; grad_rel, the worst leaf's
    largest difference from the plain versions' over the leaf's scale, and
    that leaf; ratio, the worst leaf's distance from the exact run, the
    kernels' over the plain versions' (each over the leaf's scale, floored
    at 1e-7), and that leaf; exact_plain, the plain run's worst distance
    from the exact one; finite; got and want, the kernel run's launches by
    body and :func:`whisper_train_counts` / :func:`vlm_train_counts`';
    plain_calls.  A leaf's scale is its plain gradient's largest entry,
    but a whisper key bias's exact gradient is zero (without RoPE a bias on
    every key moves a row's scores by one constant, which the softmax
    ignores): its scale is the same attention's query bias's."""
    from unittest import mock

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.models.layers import linear
    from repro_torch.models.layers.module import tree_map
    from repro_torch.models.registry import fns_for
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    audio = arch == "whisper-medium"
    deepest = max(TRAIN_PATH_DEPTHS)

    def config(depth):
        if audio:
            return whisper_config(arch_registry, depth, compute_dtype="float32")
        return arch_registry.config(arch).replace(compute_dtype="float32", num_layers=depth)

    def cut(params, depth):
        stacks = ("enc_blocks", "dec_blocks") if audio else ("blocks",)
        return dict(params, **{n: tree_map(lambda t: t[:depth], params[n]) for n in stacks})
    full = config(deepest)
    params = fns_for(full).init(full, torch.Generator("cuda").manual_seed(0))
    seq = WHISPER_DECODER_CONTEXT if audio else VLM_CHECK_SEQ
    counts = whisper_train_counts if audio else vlm_train_counts
    exact = lambda x, y: (x.double() @ y.double()).to(x.dtype)   # noqa: E731
    out = []
    for seed in seeds:
        batch = next(SyntheticTokens(full, 1, seq, seed=seed))
        if full.m_rope:
            batch["positions"][1:] = np.random.default_rng(seed).integers(0, 4 * seq,
                                                                          (2, 1, seq))
        batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
        for depth in TRAIN_PATH_DEPTHS:
            cfg, p = config(depth), cut(params, depth)
            keys, ps = flat_keys(p), leaves(p)

            def run():
                for t in ps:
                    t.requires_grad_(True)
                loss, _ = make_loss_fn(cfg)(p, batch)
                grads = torch.autograd.grad(loss, ps)
                for t in ps:
                    t.requires_grad_(False)
                return loss.item(), grads
            dispatch.reset_counts()
            kern_loss, kern_g = run()
            table = dispatch.kernel_table()
            want = counts(cfg, 1)
            got = {n: dict(table[n].body_launches) for n in want}
            plain_calls = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
            finite = all(bool(torch.isfinite(g).all()) for g in kern_g)
            kern_g = [g.cpu() for g in kern_g]
            with dispatch.plain_versions():
                plain_loss, plain_g = run()
            with mock.patch.object(linear, "_k7", exact):
                exact_loss, exact_g = run()
            at = {k: i for i, k in enumerate(keys)}
            worst = {"grad_rel": (0.0, None), "ratio": (0.0, None), "exact_plain": (0.0, None)}
            for i, key in enumerate(keys):
                ref = plain_g[at[key[:-1] + ("bq",)]] if audio and key[-1] == "bk" else plain_g[i]
                scale = ref.abs().max().clamp(min=1e-30)
                kg, pg, eg = kern_g[i].cuda(), plain_g[i], exact_g[i]
                d_kern = ((kg - eg).abs().max() / scale).item()
                d_plain = ((pg - eg).abs().max() / scale).item()
                for name, v in (("grad_rel", ((kg - pg).abs().max() / scale).item()),
                                ("ratio", max(d_kern, 1e-7) / max(d_plain, 1e-7)),
                                ("exact_plain", d_plain)):
                    if worst[name][0] == worst[name][0] and not v <= worst[name][0]:
                        worst[name] = (v, "/".join(map(str, key)))   # a NaN stays
                del kg
            out.append({"seed": seed, "depth": depth, "loss": kern_loss,
                        "loss_rel": abs(kern_loss - plain_loss) / abs(plain_loss),
                        "exact_loss": exact_loss, "finite": finite, "got": got, "want": want,
                        "plain_calls": plain_calls, "leaves": len(ps),
                        **{k: v[0] for k, v in worst.items()},
                        **{f"{k}_leaf": v[1] for k, v in worst.items()}})
            del kern_g, plain_g, exact_g, ps, p
            gc.collect()
            torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_train_path_check(torch, np, arch, limits, seeds=PATH_SEEDS) -> None:
    """The gate on :func:`family_train_path_rel`: at each seed and depth the loss
    within ``limits[depth][0]`` of the plain versions' (relative), every
    gradient leaf within ``limits[depth][1]`` of its scale, no leaf of the
    kernels more than ``limits[depth][2]`` times as far from the exact
    products as the plain versions', every gradient finite, the launches
    exact by body and no plain call."""
    for r in family_train_path_rel(torch, np, arch, seeds):
        loss_tol, rel_tol, ratio_tol = limits[r["depth"]]
        log(f"{arch} training path check (fp32, full width, depth {r['depth']}, seed "
            f"{r['seed']}, remat full): loss kernels {r['loss']:.6f} exact products "
            f"{r['exact_loss']:.6f}, kernels vs plain rel {r['loss_rel']:.3e} (tol {loss_tol}); "
            f"worst of {r['leaves']} gradient leaves vs plain {r['grad_rel']:.3e} "
            f"({r['grad_rel_leaf']}; tol {rel_tol}); vs exact products: plain's worst "
            f"{r['exact_plain']:.3e} ({r['exact_plain_leaf']}), the kernels' distance over the "
            f"plain's worst {r['ratio']:.3f} ({r['ratio_leaf']}; tol {ratio_tol}); finite="
            f"{r['finite']}; launches by body {r['got']} (expected {r['want']}); plain calls "
            f"{r['plain_calls'] or 0}")
        if r["got"] != r["want"] or r["plain_calls"]:
            raise AssertionError(f"{arch} training path check: launches {r['got']}, expected "
                                 f"{r['want']}; plain calls {r['plain_calls']}")
        if not (r["finite"] and r["loss_rel"] <= loss_tol and r["grad_rel"] <= rel_tol
                and r["ratio"] <= ratio_tol):
            raise AssertionError(f"{arch} training path check, depth {r['depth']}, seed "
                                 f"{r['seed']}: kernels and plain versions disagree: {r}")


def whisper_train_path_check(torch, np) -> None:
    """Phase 29b: :func:`family_train_path_check` on whisper-medium."""
    family_train_path_check(torch, np, "whisper-medium", WHISPER_TRAIN_LIMITS)


def vlm_train_path_check(torch, np) -> None:
    """Phase 30a: :func:`family_train_path_check` on qwen2-vl-72b, at the
    first of ``PATH_SEEDS`` (its time pays for phase 32)."""
    family_train_path_check(torch, np, "qwen2-vl-72b", VLM_TRAIN_LIMITS, PATH_SEEDS[:1])


def training_cell(torch, np, table, tag, cfg, want, *, steps, batch, seq, accum,
                  optimizer=None) -> dict:
    """Train ``cfg`` with the port's ``Trainer`` (the card, ``optimizer``
    or the config's own) for ``steps`` steps of ``batch`` x ``seq`` tokens
    from ``SyntheticTokens`` (seed 0) in ``accum`` microbatches.  Every loss
    finite; launches exact by body (``want``), no plain call.  Step time
    (the mean of the steps after the first), tokens/s, tokens/s/W against
    the power limit, peak memory; then one 1 x ``seq`` microbatch (forward,
    recompute and backward) under the profiler (device activity only)
    beside CUDA events around it: device time by kernel and the busy share.
    Returns the launches by kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn
    from repro_torch.training.trainer import Trainer, TrainerConfig

    name, watts = card_name_and_power_limit()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = SyntheticTokens(cfg, batch, seq, seed=0)
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(num_steps=steps, ckpt_every=50, ckpt_dir=d, device="cuda")
        tr = Trainer(cfg, iter(data), tc, accum=accum, optimizer=optimizer)
        dispatch.reset_counts()
        t0 = time.monotonic()
        hist = tr.train()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        got = {n: dict(table[n].body_launches) for n in want}
        plain = {n: k.plain_calls for n, k in table.items() if k.plain_calls}
    peak = torch.cuda.max_memory_allocated()
    steps_run = [h for h in hist if "loss" in h]
    losses = [h["loss"] for h in steps_run]
    times = [h["step_time_s"] for h in steps_run]
    step = statistics.mean(times[1:])
    tokens = batch * seq
    n_params = sum(p.numel() for p in leaves(tr.params))
    log(f"{tag} training: {cfg.name} L={cfg.num_layers}"
        + (f" + {cfg.encdec.num_encoder_layers} encoder layers over "
           f"{cfg.encdec.num_encoder_frames} frames" if cfg.encdec else "")
        + f" d_model={cfg.d_model} H={cfg.num_heads} K={cfg.num_kv_heads} "
        f"D={cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} params={n_params} "
        f"fp32 master weights, {cfg.compute_dtype} compute, remat={cfg.remat}, "
        f"{'the config' if optimizer is None else 'the launcher'}'s optimizer "
        f"({cfg.optimizer if optimizer is None else 'adamw'}); {steps} steps of {batch} x "
        f"{seq} tokens in {accum} microbatches; wall {wall:.1f}s (init included)")
    log(f"{tag} training: losses={[round(v, 4) for v in losses]} first_step={times[0]:.3f}s "
        f"step={step:.3f}s tokens/s={tokens / step:.1f} tokens/s/W={tokens / step / watts:.4f} "
        f"at power.limit {watts:.0f} W ({name}) max_memory_allocated={peak / 2**30:.2f}GiB "
        f"(fp32 params {4 * n_params / 2**30:.2f}GiB)")
    log(f"{tag} training: launches by body {got} (expected {want}: a microbatch "
        f"{ {n: {b: c // (steps * accum) for b, c in v.items()} for n, v in want.items()} }); "
        f"plain_calls={plain or 0}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} training: losses {losses}")
    if got != want or plain:
        raise AssertionError(f"{tag} training: launches {got}, expected {want}; plain calls "
                             f"{plain}")
    mb = {k: torch.as_tensor(v).cuda() for k, v in
          next(SyntheticTokens(cfg, 1, seq, seed=9)).items()}
    ps = leaves(tr.params)
    for p in ps:
        p.requires_grad_(True)
    loss_fn = make_loss_fn(cfg)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        start.record()
        loss, _ = loss_fn(tr.params, mb)
        grads = torch.autograd.grad(loss, ps)
        end.record()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    for p in ps:
        p.requires_grad_(False)
    del grads
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    if not busy:
        raise AssertionError(f"{tag} training profile: the profiler saw no device time")
    by = {"K7 matmul": ("matmul_wgmma_kernel", "matmul_kernel"),
          "K4": ("flash_kernel", "flash_mma_kernel"), "K4 backward": ("fa_bwd_",)}
    parts = {k: sum(r[0] for r in rows if any(n in r[2] for n in v)) / 1e3
             for k, v in by.items()}
    log(f"{tag} training profile (one 1 x {seq} microbatch, forward, recompute and "
        f"backward): wall={wall:.3f}s device_busy={busy:.3f}s (profiler; CUDA events from "
        f"the first launch to the last {start.elapsed_time(end) / 1e3:.3f}s) busy_share="
        f"{busy / wall:.3f} idle_share={1 - busy / wall:.3f}; "
        + ", ".join(f"{k} {v:.3f}s ({v / busy:.3f} of device time)" for k, v in parts.items()))
    for ms, count, key in rows[:12]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {key[:90]}")
    del tr, ps, mb, loss
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(c.values()) for n, c in got.items()}


def whisper_training_phase(torch, np, table) -> dict:
    """Phase 29c: whisper-medium at its full config (nothing cut), random
    weights from seed 0, fp32 master weights, bf16 compute, remat "full",
    AdamW with the launcher's recipe: ``WHISPER_TRAIN_STEPS`` steps of
    ``WHISPER_TRAIN_BATCH`` x 448 tokens (the decoder's whole context, 1500
    frames a sequence) in the config's 8 microbatches, through
    :func:`training_cell`; launches by :func:`whisper_train_counts`."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.optim.optimizers import adamw, warmup_cosine
    cfg = whisper_config(arch_registry)
    return training_cell(
        torch, np, table, "whisper", cfg,
        whisper_train_counts(cfg, cfg.accum_steps * WHISPER_TRAIN_STEPS),
        steps=WHISPER_TRAIN_STEPS, batch=WHISPER_TRAIN_BATCH, seq=WHISPER_DECODER_CONTEXT,
        accum=cfg.accum_steps, optimizer=adamw(warmup_cosine(3e-3, 20, WHISPER_TRAIN_STEPS)))


def vlm_training_phase(torch, np, table) -> dict:
    """Phase 30b: qwen2-vl-72b at full width cut to ``VLM_TRAIN_LAYERS`` of
    its 80 layers, random weights from seed 0, fp32 master weights, bf16
    compute, remat "full", Adafactor (``make_optimizer``: the config's),
    ``VLM_TRAIN_STEPS`` steps of ``VLM_TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens in as many microbatches, three equal position streams, through
    :func:`training_cell`; launches by :func:`vlm_train_counts`."""
    from repro_torch.configs import registry as arch_registry
    cfg = arch_registry.config("qwen2-vl-72b").replace(num_layers=VLM_TRAIN_LAYERS)
    return training_cell(
        torch, np, table, "vlm", cfg,
        vlm_train_counts(cfg, VLM_TRAIN_BATCH * VLM_TRAIN_STEPS), steps=VLM_TRAIN_STEPS,
        batch=VLM_TRAIN_BATCH, seq=TRAIN_SEQ, accum=VLM_TRAIN_BATCH)


def shard_lengths(lengths, offset: int, s_loc: int) -> list:
    """K3's lengths (rows below the length live, past S all) of the
    slots ``[offset, offset + s_loc)`` of a cache cut into slices:
    ``clamp(n - offset, 0, s_loc)`` for each sequence."""
    return [max(0, min(n - offset, s_loc)) for n in lengths]


def lse_parts(torch, parts) -> list:
    """K3's per-shard results (out (B, H, D), m (B, H), l (B, H)) as the
    partials ``merge_lse`` takes: out (B, 1, H, D), m and l (B, H, 1)."""
    from repro_torch.models.layers.attention import AttnResiduals
    return [AttnResiduals(out=o[:, None], m=m[..., None], l=l[..., None]) for o, m, l in parts]


def lse_work(lengths, S, H, K, D, elem) -> tuple[float, float]:
    """(bytes, flops) of one K3 call with its log-sum-exp: q and out, each
    live K and V row once, the lengths, m and l (fp32); QK^T and PV over the
    live rows."""
    rows = sum(min(max(n, 0), S) for n in lengths)
    B = len(lengths)
    return elem * (2 * B * H * D + 2 * rows * K * D) + 4 * B + 8 * B * H, 4 * H * D * rows


def k3_digests(torch, cases=LSE_DECODE_CASES) -> dict:
    """sha1 of K3's outputs without the log-sum-exp on ``cases`` (as made,
    in order), by body and type: what ``K3_PARENT_BITS`` pins."""
    import hashlib
    from repro_torch.kernels import dispatch
    kern = dispatch.kernel_table()["decode_attention"]
    out = {}
    for dtype, body in ((torch.float32, "fma"), (torch.bfloat16, "mma"),
                        (torch.bfloat16, "fma")):
        h = hashlib.sha1()
        for lengths, S, H, K, D in cases:
            args = dense_decode_case(torch, lengths, dtype, S=S, H=H, K=K, D=D)
            got = kern.launch(*args, body=body)
            torch.cuda.synchronize()
            h.update(bits(torch, got).cpu().numpy().tobytes())
        out[f"{body} {str(dtype)[6:]}"] = h.hexdigest()
    return out


def lse_ratio(torch, kern, args, *, body, poison=None) -> tuple[float, float, bool]:
    """K3 with ``return_lse`` on ``body`` against its plain version evaluated
    in fp32 on the same values (``kern.tolerance``: out, and m and l where
    the plain l > 0; l 0 and m at most NEG_INF / 2 where it is 0), the
    allocator's free blocks filled with NaN just before the launch, after
    ``poison(args)`` where given.  Returns (err/limit, the largest absolute
    error of out, m and l, whether the same call without the log-sum-exp
    gives out's bits)."""
    ref = kern.plain(*(a.float() if a.is_floating_point() else a for a in args),
                     return_lse=True)
    if poison is not None:
        poison(args)
    poison_cached_memory(torch)
    got = kern.launch(*args, return_lse=True, body=body)
    alone = kern.launch(*args, body=body)
    torch.cuda.synchronize()
    ratio = kern.tolerance(got, ref)
    live = ref[2] > 0
    err = max((got[0].float() - ref[0]).abs().max().item(),
              (got[1] - ref[1])[live].abs().max().item() if live.any() else 0.0,
              (got[2] - ref[2]).abs().max().item())
    return ratio, err, bool(torch.equal(got[0], alone))


def hold_lse(torch, kern, args, label, *, body, poison=None) -> float:
    """:func:`lse_ratio`, raising past the limit or where the call without
    the log-sum-exp gives other bits.  Returns the largest absolute error."""
    ratio, err, same = lse_ratio(torch, kern, args, body=body, poison=poison)
    log(f"decode_attention lse {label} {str(args[0].dtype)[6:]} body={body}"
        f"{' NaN past the lengths' if poison else ''}: max_abs_err={err:.3e} "
        f"err/limit={ratio:.3f} out without the lse the same bits={same}")
    if not (ratio <= 1.0 and same):
        raise AssertionError(f"decode_attention lse {label} body={body}: err/limit {ratio}, "
                             f"same bits without the lse {same}")
    return err


def lse_kernel_phase(torch, table) -> dict:
    """Phase 31a: K3 with its row log-sum-exp on ``LSE_DECODE_CASES``, fp32
    (the FMA body) and bf16 (the route's split body and the FMA body), each
    as made and with NaN past the lengths (:func:`hold_lse`); without the
    log-sum-exp K3 keeps ``K3_PARENT_BITS``.  Then the timed case, bf16, on
    both bodies with and without the log-sum-exp (CUDA events, L2
    flushed), beside the plain version and its bound.  Returns the
    ``lse_*`` keys of K3's kernels-line entry."""
    from repro_torch.kernels.decode_attention.ops import dense_body_for
    kern = table["decode_attention"]

    def poison(args):
        torch.cuda.synchronize()
        poison_cache_rows(torch, *args)

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst = []
        for lengths, S, H, K, D in LSE_DECODE_CASES:
            label = f"B={len(lengths)} S={S} H={H} K={K} D={D} lengths={lengths}"
            made = dense_decode_case(torch, lengths, dtype, S=S, H=H, K=K, D=D)
            for body in dict.fromkeys((dense_body_for(*made[:2]), "fma")):
                for p in (None, poison):
                    args = dense_decode_case(torch, lengths, dtype, S=S, H=H, K=K, D=D)
                    worst.append(hold_lse(torch, kern, args, label, body=body, poison=p))
        errs[dtype] = max(worst)
    digests = k3_digests(torch)
    log(f"decode_attention without the lse: output digests {digests}; the build before "
        f"the lse {K3_PARENT_BITS}")
    if K3_PARENT_BITS and digests != K3_PARENT_BITS:
        raise AssertionError(f"decode_attention without the lse: bits {digests}, the build "
                             f"before it gave {K3_PARENT_BITS}")
    lengths, S, H, K, D = LSE_DECODE_CASES[3]
    q, k, v, lens = dense_decode_case(torch, lengths, torch.bfloat16, S=S, H=H, K=K, D=D)
    timer = Timer(torch)
    nbytes, flops = lse_work(lengths, S, H, K, D, 2)
    bms, by = bound(nbytes, flops, BF16_FLOPS)
    r = dict(lse_ms=timer(lambda: kern.launch(q, k, v, lens, return_lse=True)),
             lse_nolse_ms=timer(lambda: kern.launch(q, k, v, lens)),
             lse_fma_ms=timer(lambda: kern.launch(q, k, v, lens, return_lse=True, body="fma")),
             lse_fma_nolse_ms=timer(lambda: kern.launch(q, k, v, lens, body="fma")),
             lse_plain_ms=timer(lambda: kern.plain(q, k, v, lens, return_lse=True)),
             lse_library_ms=None, lse_bound_ms=bms, lse_bound_by=by,
             lse_shape=f"B={len(lengths)} S={S} H={H} K={K} D={D} lengths={lengths} bf16 "
                       f"body={dense_body_for(q, k)}",
             max_abs_err_lse=errs[torch.bfloat16], max_abs_err_lse_fp32=errs[torch.float32])
    log(f"decode_attention lse timed at {r['lse_shape']}: with the lse {r['lse_ms']:.4f}ms, "
        f"without {r['lse_nolse_ms']:.4f}ms (fma body {r['lse_fma_ms']:.4f}ms / "
        f"{r['lse_fma_nolse_ms']:.4f}ms), plain {r['lse_plain_ms']:.4f}ms, bound "
        f"{bms:.5f}ms ({by}; {nbytes} B, {flops} flop); no PyTorch call returns a decode "
        f"step's row log-sum-exp: library none")
    return r


def mesh_split_rel(torch, table) -> list:
    """Phase 31b's runs: a cache of ``MESH_MAX_LEN`` rows at qwen2.5-3b's
    heads cut into M = 2, 4 and 8 contiguous slices, K3 with its
    log-sum-exp on each slice at :func:`shard_lengths` (the allocator's free
    blocks filled with NaN before each launch), the partials merged by
    ``merge_lse``.  Returns (dtype, M, err/limit against one K3 call over
    the whole cache, against the plain version evaluated in fp32, the
    largest error against it, finite) for fp32 and bf16."""
    from repro_torch.kernels.dispatch import tolerance_ratio
    from repro_torch.models.layers.attention import merge_lse
    kern = table["decode_attention"]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, lens = dense_decode_case(torch, MESH_SPLIT_LENGTHS, dtype, S=MESH_MAX_LEN,
                                          H=16, K=2, D=128)
        whole = kern.launch(q, k, v, lens)
        ref = kern.plain(q.float(), k.float(), v.float(), lens)
        for M in MESH_SPLITS:
            s_loc = MESH_MAX_LEN // M
            parts = []
            for r in range(M):
                sl = slice(r * s_loc, (r + 1) * s_loc)
                local = torch.tensor(shard_lengths(MESH_SPLIT_LENGTHS, r * s_loc, s_loc),
                                     dtype=torch.int32, device="cuda")
                poison_cached_memory(torch)
                parts.append(kern.launch(q, k[:, sl].contiguous(), v[:, sl].contiguous(),
                                         local, return_lse=True))
            merged = merge_lse(lse_parts(torch, parts))[:, 0]
            torch.cuda.synchronize()
            rows.append((dtype, M, tolerance_ratio(merged, whole), tolerance_ratio(merged, ref),
                         (merged.float() - ref).abs().max().item(),
                         bool(torch.isfinite(merged.float()).all())))
    return rows


def mesh_split_phase(torch, table) -> None:
    """Phase 31b: the mesh branch's arithmetic with M > 1 on one card
    (:func:`mesh_split_rel`): the merged output within the limit of one
    call and of the plain version (``dispatch.tolerance_ratio``), fp32 and
    bf16, no NaN (shards with no live row among them)."""
    for dtype, M, vs_one, vs_plain, err, finite in mesh_split_rel(torch, table):
        log(f"decode_attention split into {M} shards of {MESH_MAX_LEN // M} rows "
            f"{str(dtype)[6:]} lengths={MESH_SPLIT_LENGTHS}: merged vs one call "
            f"err/limit={vs_one:.3f}, vs plain err/limit={vs_plain:.3f}, "
            f"max_abs_err={err:.3e} finite={finite}")
        if not (finite and vs_one <= 1.0 and vs_plain <= 1.0):
            raise AssertionError(f"decode_attention split into {M} {dtype}: vs one call "
                                 f"{vs_one}, vs plain {vs_plain}, finite {finite}")


def nccl_world(torch):
    """A torch.distributed world of one rank on NCCL (a ``HashStore``: no
    address) and a 1 x 1 DeviceMesh over it; raises if either fails."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    return make_host_mesh(1, 1)


def mesh_serving_phase(torch, np, table, mesh) -> dict:
    """Phase 31c: qwen2.5-3b at full width, bf16, random weights from seed
    0, through the contiguous engine (4 slots of ``MESH_MAX_LEN`` rows,
    phase 17's requests), first without a mesh and then under ``mesh`` (1 x
    1, NCCL) with ``rules_for``'s decode rules (``kv_seq`` on model).  The
    mesh run's counts zeroed just before and read just after, held
    exactly: K3 36 a decode step, every one with its log-sum-exp on the
    split body (``mma_lse``), one all-gather a layer a decode step, K4 36 a
    prefill, K7 by body, no plain call; its greedy tokens equal to the
    run's without the mesh.  TPOT, tok/s and peak memory printed beside
    each other.  Returns the mesh run's launches by kernel."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import rules_for, use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy

    card, watts = card_name_and_power_limit()
    cfg = arch_registry.config("qwen2.5-3b")
    rules = rules_for(cfg, ShapeConfig("serve", "decode", MESH_MAX_LEN, 4), mesh)
    params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
    L = cfg.num_layers
    runs = {}
    for tag in ("no mesh", "mesh"):
        if tag == "mesh":
            with use_rules(rules, mesh):
                eng = ServingEngine(cfg, params, paged=False, max_len=MESH_MAX_LEN,
                                    batch_slots=4, device="cuda")
        else:
            eng = ServingEngine(cfg, params, paged=False, max_len=MESH_MAX_LEN, batch_slots=4,
                                device="cuda")
        eng.serve([Request(100, np.arange(40, dtype=np.int32), max_new_tokens=4,
                           sampler=greedy())])
        reqs = serving_requests(cfg, np, Request, greedy)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_counts()
        collectives.reset_collective_counts()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        bodies, plain = launched_bodies(table)
        runs[tag] = dict(stats=stats, bodies=bodies, plain=plain,
                         gathers=collectives.collective_counts(),
                         outputs=[list(r.output) for r in reqs],
                         cache=tuple(eng._state.k.shape),
                         peak=torch.cuda.max_memory_allocated())
        log(f"mesh serving ({tag}{' 1 x 1 NCCL, kv_seq on ' + rules.rules['kv_seq'] if tag == 'mesh' else ''}): "
            f"requests={stats.requests} tokens={stats.tokens} wall={stats.wall_s:.3f}s "
            f"{serving_summary(stats)} tok/s/W={stats.tokens_per_s / watts:.4f} at power.limit "
            f"{watts:.0f} W ({card}) max_memory_allocated={runs[tag]['peak'] / 2**30:.2f}GiB "
            f"caches {runs[tag]['cache']}; launches by body {bodies} plain_calls={plain or 0} "
            f"collectives {runs[tag]['gathers']}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    m, base = runs["mesh"], runs["no mesh"]
    calls = m["stats"].prefills + m["stats"].decode_steps
    want = {"flash_attention": {"mma": L * m["stats"].prefills},
            "decode_attention": {"mma_lse": L * m["stats"].decode_steps},
            "matmul": {"wgmma": L * QWEN_PRODUCTS * calls, "fma": calls}}
    same = sum(a == b for a, b in zip(m["outputs"], base["outputs"]))
    log(f"mesh serving: greedy tokens equal to the run without the mesh in {same} of "
        f"{len(m['outputs'])} requests; TPOT {m['stats'].mean_tpot_s * 1e3:.2f}ms vs "
        f"{base['stats'].mean_tpot_s * 1e3:.2f}ms, tok/s {m['stats'].tokens_per_s:.2f} vs "
        f"{base['stats'].tokens_per_s:.2f} (mesh vs none, {card}, {watts:.0f} W)")
    if (m["bodies"] != want or m["plain"]
            or m["gathers"] != {"all_gather": L * m["stats"].decode_steps}
            or same != len(m["outputs"]) or m["cache"][2] != MESH_MAX_LEN):
        raise AssertionError(f"mesh serving: launches {m['bodies']} (expected {want}), plain "
                             f"{m['plain']}, collectives {m['gathers']}, {same} of "
                             f"{len(m['outputs'])} requests with the same tokens, caches "
                             f"{m['cache']}")
    mesh_attention_cost(torch, mesh, rules, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {n: sum(b.values()) for n, b in m["bodies"].items()}


def mesh_attention_cost(torch, mesh, rules, cfg) -> None:
    """The host's time per call of one layer's decode attention at 31c's
    shape (4 slots, ``MESH_MAX_LEN`` rows, bf16), 20 calls back to back,
    without the mesh and under it (K3 with its log-sum-exp, the
    all-gather, the merge), and the merge alone; printed with what the
    difference costs a decode step over the layers."""
    from repro_torch.distributed.collectives import seq_sharded_decode_attention
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models.layers.attention import AttnResiduals, merge_lse
    g = torch.Generator("cuda").manual_seed(0)
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.randn((4, 1, H, D), generator=g, device="cuda").bfloat16()
    ck, cv = (torch.randn((4, MESH_MAX_LEN, K, D), generator=g, device="cuda").bfloat16()
              for _ in range(2))
    nk, nv = (torch.randn((4, 1, K, D), generator=g, device="cuda").bfloat16() for _ in range(2))
    lens = torch.tensor((1033, 700, 0, MESH_MAX_LEN - 1), dtype=torch.int32, device="cuda")

    def call():
        seq_sharded_decode_attention(q, ck, cv, nk, nv, lens)
    alone, alone_wall = host_us(torch, call, reps=20)
    with use_rules(rules, mesh):
        meshed, meshed_wall = host_us(torch, call, reps=20)
    part = [AttnResiduals(out=q, m=torch.zeros((4, H, 1), device="cuda"),
                          l=torch.ones((4, H, 1), device="cuda"))]
    merge, _ = host_us(torch, lambda: merge_lse(part), reps=20)
    L = cfg.num_layers
    log(f"mesh serving: host per layer of a decode step's attention (4 slots, "
        f"{MESH_MAX_LEN} rows, bf16), 20 back to back: without the mesh {alone:.1f} us "
        f"(wall {alone_wall:.1f}), under it {meshed:.1f} us (wall {meshed_wall:.1f}), the "
        f"merge alone {merge:.1f} us; x {L} layers: {(meshed - alone) * L / 1e3:.2f} ms more "
        f"host a decode step")


def moe_ep_phase(torch, table, mesh) -> None:
    """Phase 31d: ``moe_ep`` at deepseek-moe-16b's MoE widths on a
    ``MOE_EP_ROWS``-row chunk, bf16, random weights and activations from
    seed 0, called directly on the mesh's model group of one rank (the
    engine keeps ``moe_einsum`` there, by the reference's rule): through
    the kernels against its plain versions (``TOL_MOE_EP_REL``), K7's
    batched entry 3 launches a call, each on ``wgmma`` at the two-level
    capacities' shapes; at capacity factor 8 against ``moe_dense`` (the
    oracle, on the plain versions)."""
    import dataclasses

    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.models.layers import moe as MOE
    m = arch_registry.config("deepseek-moe-16b").moe
    D = arch_registry.config("deepseek-moe-16b").d_model
    g = torch.Generator("cuda").manual_seed(0)
    E, F = m.num_experts, m.d_ff_expert
    params = {"router": torch.randn((D, E), generator=g, device="cuda") * 0.02,
              "w_gate": (torch.randn((E, D, F), generator=g, device="cuda") / D ** 0.5).bfloat16(),
              "w_up": (torch.randn((E, D, F), generator=g, device="cuda") / D ** 0.5).bfloat16(),
              "w_down": (torch.randn((E, F, D), generator=g, device="cuda") / F ** 0.5).bfloat16()}
    x = torch.randn((1, MOE_EP_ROWS, D), generator=g, device="cuda").bfloat16()
    kern = table["matmul_batched"]
    with torch.no_grad():
        for cf in (m.capacity_factor, 8.0):
            cfg = dataclasses.replace(m, capacity_factor=cf)
            idx, prob, _ = MOE.route(cfg, params, x)
            dispatch.reset_counts()
            y = MOE.moe_ep(cfg, params, x, idx, prob, mesh=mesh, model_axis="model")
            torch.cuda.synchronize()
            bodies = dict(kern.body_launches)
            with dispatch.plain_versions():
                ref = MOE.moe_ep(cfg, params, x, idx, prob, mesh=mesh, model_axis="model")
                dense = MOE.moe_dense(cfg, params, x, idx, prob)
            torch.cuda.synchronize()
            top = ref.float().abs().max().item()
            rel = (y.float() - ref.float()).abs().max().item() / top
            rel_dense = (y.float() - dense.float()).abs().max().item() / top
            log(f"moe_ep deepseek-moe-16b widths, {MOE_EP_ROWS} rows, capacity factor {cf}, "
                f"model group of 1: vs plain rel {rel:.3e} (limit {TOL_MOE_EP_REL}), vs "
                f"moe_dense rel {rel_dense:.3e}; K7 batched launches by body {bodies}; "
                f"finite={bool(torch.isfinite(y.float()).all())}")
            if not (rel <= TOL_MOE_EP_REL and bodies == {"wgmma": 3}
                    and (cf < 8.0 or rel_dense <= TOL_MOE_EP_REL)):
                raise AssertionError(f"moe_ep at capacity factor {cf}: rel {rel}, vs dense "
                                     f"{rel_dense}, launches {bodies}")
    del params, x
    gc.collect()
    torch.cuda.empty_cache()


def mesh_plan() -> None:
    """Planning numbers for serving on a 1 x 4 mesh of H100s (analytic, the
    policy's ``sharded_bytes_per_device``): bf16 weights and the decode
    state of qwen2-vl-72b and qwen3-moe-235b-a22b under ``rules_for``'s
    decode rules, at decode_32k (128 x 32768) and at 8 x 32768."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.specs import abstract_params, input_specs
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import MeshShape, rules_for
    mesh = MeshShape(("data", "model"), (1, 4))
    for arch in ("qwen2-vl-72b", "qwen3-moe-235b-a22b"):
        cfg = arch_registry.config(arch).replace(param_dtype="bfloat16")
        for B in (128, 8):
            shape = ShapeConfig(f"decode_32k x{B}", "decode", 32768, B)
            rules = rules_for(cfg, shape, mesh)
            w = policy.sharded_bytes_per_device(abstract_params(cfg), policy.param_axes(cfg),
                                                rules, mesh)
            _, state = input_specs(cfg, shape)
            kv = policy.sharded_bytes_per_device(state, policy.decode_state_axes(cfg), rules,
                                                 mesh)
            log(f"mesh plan 1 x 4: {arch} {B} x 32768 decode: bf16 weights {w / 2**30:.2f} "
                f"GiB a card, decode state (bf16 KV) {kv / 2**30:.2f} GiB a card; rules "
                f"kv_seq={rules.rules['kv_seq']} heads={rules.rules['heads']} "
                f"embed={rules.rules['embed']} experts={rules.rules['experts']}")


def mesh_phase(torch, np, table) -> tuple[dict, dict]:
    """Phase 31: 31a, 31b, then 31c and 31d inside an NCCL world of one
    rank, which is destroyed at the end (a failed init fails the phase).
    Returns (K3's ``lse_*`` keys, 31c's launches by kernel)."""
    import torch.distributed as dist
    gc.collect()
    torch.cuda.empty_cache()        # the NaN fill before each launch then fills little
    lse = lse_kernel_phase(torch, table)
    mesh_split_phase(torch, table)
    mesh_plan()
    mesh = nccl_world(torch)
    try:
        launches = mesh_serving_phase(torch, np, table, mesh)
        moe_ep_phase(torch, table, mesh)
    finally:
        dist.destroy_process_group()
    return lse, launches


# ---------------------------------------------------------------------------
# Phase 32: training under a device mesh
# ---------------------------------------------------------------------------

def mesh_training_run(torch, table, cfg, rules=None, mesh=None) -> dict:
    """``MESH_TRAIN_STEPS`` steps of ``MESH_TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens (``SyntheticTokens``, seed 0) in ``MESH_TRAIN_ACCUM``
    microbatches through the ``Trainer`` (weights from its seed 0, AdamW,
    remat "full"), without a mesh or under ``rules`` on ``mesh``; the
    counts zeroed once the state is made and read after the last step.
    Returns the history, the parameters, the launches by body, the plain
    calls, the collectives, the state's bytes after the init and the peak
    in the init and in the steps, each net of what the script held before
    the run (an earlier run's parameters)."""
    import tempfile

    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed import collectives
    from repro_torch.kernels import dispatch
    from repro_torch.training.trainer import Trainer, TrainerConfig
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # an earlier run's parameters, kept to compare
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(num_steps=MESH_TRAIN_STEPS, ckpt_every=50, ckpt_dir=d,
                           device="cuda")
        tr = Trainer(cfg, iter(SyntheticTokens(cfg, MESH_TRAIN_BATCH, TRAIN_SEQ, seed=0)),
                     tc, accum=MESH_TRAIN_ACCUM, rules=rules, mesh=mesh)
        tr.init_state()
        torch.cuda.synchronize()
        state = torch.cuda.memory_allocated() - held
        init_peak = torch.cuda.max_memory_allocated() - held
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_counts()
        collectives.reset_collective_counts()
        hist = tr.train()
        torch.cuda.synchronize()
    bodies, plain = launched_bodies(table)
    out = dict(history=hist, params=tr.params, bodies=bodies, plain=plain,
               collectives=collectives.collective_counts(), state=state,
               init_peak=init_peak, peak=torch.cuda.max_memory_allocated() - held)
    del tr
    return out


def mesh_layer_host_cost(torch, cfg, params, rules, mesh) -> None:
    """The host's time per call of one block's training forward (1 x
    ``TRAIN_SEQ`` rows, bf16 compute, grad off), 20 back to back, through
    ``block_apply`` without the mesh and under it (with the plan: two
    all-gathers and two reduce-scatters on the model group)."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models import transformer as T
    from repro_torch.models.layers.module import tree_map
    layer = T._layers(cfg, params)[0]
    axes = tree_map(lambda d: d.axes, T.block_table(cfg))
    g = torch.Generator("cuda").manual_seed(5)
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=g, device="cuda").bfloat16()
    pos = T.default_positions(cfg, torch.zeros((1, TRAIN_SEQ), dtype=torch.int32,
                                               device="cuda"))
    with torch.no_grad():
        alone, alone_wall = host_us(torch, lambda: T.block_apply(cfg, layer, x, pos),
                                    reps=20)
        with use_rules(rules, mesh):
            tp = TP.plan(cfg)
            meshed, meshed_wall = host_us(
                torch, lambda: T.block_apply(cfg, layer, x, pos, tp=tp, axes=axes),
                reps=20)
    log(f"mesh training: host per block forward (1 x {TRAIN_SEQ}, bf16, grad off), 20 back "
        f"to back: without the mesh {alone:.1f} us (wall {alone_wall:.1f}), under it "
        f"{meshed:.1f} us (wall {meshed_wall:.1f}); x {cfg.num_layers} layers "
        f"{(meshed - alone) * cfg.num_layers / 1e3:.2f} ms more host a forward")


def mesh_training_phase(torch, np, table, mesh) -> dict:
    """Phase 32a: qwen2.5-3b at full width cut to ``MESH_TRAIN_LAYERS``
    layers, bf16 compute, through the ``Trainer`` without a mesh and then
    on ``mesh`` (1 x 1, NCCL) under ``rules_for``'s training rules (heads,
    ``ff`` and the vocabulary on model, ``seq_sp``): every collective has
    one rank and the arithmetic is the same, so the losses, metrics, grad
    norms and updated parameters are held to the bit; launches by body
    equal to the run's without the mesh, no plain call; the mesh run's
    collectives held to the count the sharded path's structure gives (none
    without the mesh); step times and memory side by side; the host time of a
    block's forward with and without the mesh.  Returns the mesh run's
    launches by kernel."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.launch.serve import card_name_and_power_limit
    from repro_torch.optim.optimizers import leaves
    card, watts = card_name_and_power_limit()
    cfg = arch_registry.config("qwen2.5-3b").replace(num_layers=MESH_TRAIN_LAYERS)
    rules = rules_for(cfg, ShapeConfig("mesh_train", "train", TRAIN_SEQ, MESH_TRAIN_BATCH),
                      mesh)
    r = rules.rules
    if not (r["seq_sp"] == r["vocab"] == r["heads"] == r["ff"] == "model"):
        raise AssertionError(f"mesh training rules: {r}")
    runs = {"no mesh": mesh_training_run(torch, table, cfg)}
    runs["mesh"] = mesh_training_run(torch, table, cfg, rules, mesh)
    for tag, run in runs.items():
        times = [h["step_time_s"] for h in run["history"]]
        log(f"mesh training ({tag}{', 1 x 1 NCCL' if tag == 'mesh' else ''}): {cfg.name} "
            f"L={cfg.num_layers} full width, {MESH_TRAIN_STEPS} steps of {MESH_TRAIN_BATCH} x "
            f"{TRAIN_SEQ} in {MESH_TRAIN_ACCUM} microbatches: losses "
            f"{[h['loss'] for h in run['history']]} grad_norms "
            f"{[h['grad_norm'] for h in run['history']]} step times {times} s (first "
            f"{times[0]:.3f}s, then {statistics.mean(times[1:]):.3f}s; {card}, {watts:.0f} W) "
            f"state after init {run['state'] / 2**30:.2f}GiB, max_memory_allocated in the "
            f"init {run['init_peak'] / 2**30:.2f}GiB, in the steps "
            f"{run['peak'] / 2**30:.2f}GiB; launches by body "
            f"{run['bodies']} plain_calls={run['plain'] or 0} collectives "
            f"{run['collectives']}")
    m, base = runs["mesh"], runs["no mesh"]
    keys = ("loss", "nll", "accuracy", "aux_loss", "grad_norm", "lr")
    same_metrics = all(a[k] == b[k] for a, b in zip(m["history"], base["history"])
                       for k in keys)
    diffs = [(a.float() - b.float()).abs().max().item()
             for a, b in zip(leaves(m["params"]), leaves(base["params"]))]
    same_params = all(torch.equal(a, b) for a, b in zip(leaves(m["params"]),
                                                        leaves(base["params"])))
    log(f"mesh training: metrics of every step the same bits as without the mesh: "
        f"{same_metrics}; updated parameters the same bits: {same_params} (largest "
        f"difference {max(diffs):.3e} over {len(diffs)} leaves); launches by body the same: "
        f"{m['bodies'] == base['bodies']}")
    # the sharded path's collectives, all on one rank: a microbatch gathers
    # before each block's q / k / v and FFN (forward and recompute) and
    # reduce-scatters after o and the FFN (the recompute stops before the
    # last); the backward transposes each; the lookup reduce-scatters and
    # the LM head gathers, each with its backward; the vocabulary-parallel
    # cross-entropy all-reduces five times forward and two backward.  The
    # step adds none: a mesh axis of one rank sums no gradient or metric.
    n, L = MESH_TRAIN_STEPS * MESH_TRAIN_ACCUM, cfg.num_layers
    want = {"all_gather": n * (6 * L + 2), "reduce_scatter": n * (5 * L + 2),
            "all_reduce": n * 7}
    log(f"mesh training: collectives {m['collectives']}, by the path's structure {want}: "
        f"{m['collectives'] == want}")
    if not (same_metrics and same_params and m["bodies"] == base["bodies"]
            and not m["plain"] and not base["plain"] and m["collectives"] == want
            and not base["collectives"]):
        raise AssertionError(f"mesh training: metrics same {same_metrics}, params same "
                             f"{same_params} ({max(diffs)}), launches {m['bodies']} vs "
                             f"{base['bodies']}, plain {m['plain']} / {base['plain']}, "
                             f"collectives {m['collectives']} (want {want}) / "
                             f"{base['collectives']}")
    mesh_layer_host_cost(torch, cfg, m["params"], rules, mesh)
    out = {n: sum(b.values()) for n, b in m["bodies"].items()}
    del runs, m, base
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_shard_kernel_phase(torch, table) -> dict:
    """Phase 32b: the kernels at a rank's shapes of qwen2.5-3b on a 1 x 4
    mesh (``MESH_SHARD_*``), each against its plain version evaluated in
    fp32 on the same values, then timed beside the plain version, the
    library call and the bound: K4 and its backward on the rank's 4 query
    heads and the one KV head they read (a 2 x 512 microbatch, causal,
    bf16); K7 on the SwiGLU's ``ff`` slice of 2752 columns (gate / up,
    down, and the backward's dX and dW on transposed views), each on
    ``wgmma``, and on the LM head's vocabulary slice of 37984 columns,
    bf16 on ``wgmma`` and fp32 (the model's head) on FMA.  Returns the
    kernels line's ``tp4_*`` extras of K4, its backward and K7."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import backward_body_for
    from repro_torch.kernels.flash_attention.ops import body_for as flash_body_for
    from repro_torch.kernels.matmul.ops import body_for
    fwd, bwd, k7 = table["flash_attention"], table["flash_attention_backward"], table["matmul"]
    timer = Timer(torch)
    B, S, H, K, D = MESH_SHARD_ATTENTION
    q, k, v, do = attention_grad_case(torch, B, S, H, K, D, torch.bfloat16)
    shape = f"B={B} S={S} H={H} K={K} D={D} causal bf16"
    err_f = hold(torch, fwd, (q, k, v), f"{shape} (a 1 x 4 rank of qwen2.5-3b)", causal=True)
    out, lse = fwd.launch(q, k, v, causal=True, with_lse=True)
    args = (q, k, v, out, do, lse)
    err_b = hold(torch, bwd, args, f"{shape} body={backward_body_for(q)}", causal=True)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    y = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)
    dyh = do.transpose(1, 2).contiguous()
    res = {"flash_attention": {}, "flash_attention_backward": {}, "matmul": {}}

    def keep(name, tag, ms, plain_ms, library_ms, nbytes, flops, peak, shape, err):
        r = res[name]
        r[f"{tag}_ms"], r[f"{tag}_plain_ms"], r[f"{tag}_library_ms"] = ms, plain_ms, library_ms
        r[f"{tag}_bound_ms"], r[f"{tag}_bound_by"] = bound(nbytes, flops, peak)
        r[f"{tag}_shape"], r[f"max_abs_err_{tag}"] = shape, err
        log(f"{name} timed {shape} (a 1 x 4 rank): kernel {ms:.4f}ms plain {plain_ms:.4f}ms "
            f"library {library_ms:.4f}ms bound {r[f'{tag}_bound_ms']:.5f}ms "
            f"({r[f'{tag}_bound_by']}; {nbytes} B, {flops} flop)")
    pairs = B * S * (S + 1) // 2 * H * D
    keep("flash_attention", "tp4", timer(lambda: fwd.launch(q, k, v, causal=True)),
         timer(lambda: fwd.plain(q, k, v, causal=True)),
         timer(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                      enable_gqa=True)),
         2 * (2 * B * S * H * D + 2 * B * S * K * D), 4 * pairs, BF16_FLOPS,
         f"{shape} body={flash_body_for(q)}", err_f)
    nbytes, flops, _ = attention_backward_work(B, S, H, K, D, 2)
    keep("flash_attention_backward", "tp4", timer(lambda: bwd.launch(*args, causal=True)),
         timer(lambda: bwd.plain(*args, causal=True)),
         timer(lambda: torch.autograd.grad(y, (qh, kh, vh), dyh, retain_graph=True)),
         nbytes, flops, BF16_FLOPS, f"{shape} body={backward_body_for(q)}", err_b)
    del y, qh, kh, vh, q, k, v, do, out, lse, args
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag, M, Kd, N, layout, dtype, want in MESH_SHARD_K7:
        x, w = k7_operands(torch, M, Kd, N, layout, dtype)
        body = body_for(x, w)
        err = hold_matmul(torch, k7, x, w, f"{tag} ({layout}, a 1 x 4 rank)")
        if body != want:
            raise AssertionError(f"matmul {tag} {dtype} ({layout}): body {body}, expected "
                                 f"{want}")
        if tag in ("tp4_ff", "tp4_vocab"):
            nbytes, flops = k7_work(M, Kd, N, x.element_size())
            keep("matmul", f"{tag}_{dtype}" if tag == "tp4_vocab" else tag,
                 timer(lambda: k7.launch(x, w)), timer(lambda: k7.plain(x, w)),
                 timer(lambda: torch.matmul(x, w)), nbytes, flops,
                 FP32_FLOPS if dtype == "float32" else BF16_FLOPS,
                 f"M={M} K={Kd} N={N} {dtype} ({layout}) body={body}", err)
        del x, w
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moe_ep_backward_phase(torch, table, mesh) -> None:
    """Phase 32c: ``moe_ep`` forward and backward at deepseek-moe-16b's MoE
    widths on a ``MOE_EP_ROWS``-row chunk, bf16, on the mesh's model group
    of one rank: its output and the gradients of x, the combine weights
    and the three expert weights (the loss ``sum(y * dy)``, dy from seed
    1) through the kernels, each within ``TOL_MOE_EP_GRAD_REL`` of the
    plain versions' largest entry -- of ``moe_ep``'s own at the config's
    capacity factor and at 8, and at 8 also of ``moe_einsum``'s: the two
    dispatches are one function only where no choice drops (at 1.25 their
    capacities differ, the reference's as well); K7's batched entry 3
    launches forward and 6 backward a call, none on FMA."""
    import dataclasses

    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
    from repro_torch.models.layers import moe as MOE
    full = arch_registry.config("deepseek-moe-16b")
    D = full.d_model
    g = torch.Generator("cuda").manual_seed(0)
    E, Fd = full.moe.num_experts, full.moe.d_ff_expert
    params = {"router": torch.randn((D, E), generator=g, device="cuda") * 0.02,
              "w_gate": (torch.randn((E, D, Fd), generator=g, device="cuda") / D ** 0.5).bfloat16(),
              "w_up": (torch.randn((E, D, Fd), generator=g, device="cuda") / D ** 0.5).bfloat16(),
              "w_down": (torch.randn((E, Fd, D), generator=g, device="cuda") / Fd ** 0.5).bfloat16()}
    x = torch.randn((1, MOE_EP_ROWS, D), generator=g, device="cuda").bfloat16()
    dy = torch.randn((1, MOE_EP_ROWS, D), generator=torch.Generator("cuda").manual_seed(1),
                     device="cuda").bfloat16()
    names = ("y", "x", "prob", "w_gate", "w_up", "w_down")
    kern = table["matmul_batched"]
    for cf in (full.moe.capacity_factor, 8.0):
        m = dataclasses.replace(full.moe, capacity_factor=cf)
        with torch.no_grad():
            idx, prob, _ = MOE.route(m, params, x)

        def run(fn):
            leaves = {"x": x.clone().requires_grad_(), "prob": prob.clone().requires_grad_(),
                      **{n: params[n].clone().requires_grad_() for n in names[3:]}}
            y = fn({n: leaves[n] for n in names[3:]}, leaves["x"], leaves["prob"])
            grads = torch.autograd.grad((y.float() * dy.float()).sum(),
                                        [leaves[n] for n in names[1:]])
            return dict(zip(names, (y.detach(), *grads)))
        ep = lambda w, xx, pp: MOE.moe_ep(m, w, xx, idx, pp, mesh=mesh,  # noqa: E731
                                          model_axis="model")
        dispatch.reset_counts()
        got = run(ep)
        torch.cuda.synchronize()
        bodies = dict(kern.body_launches)
        with dispatch.plain_versions():
            refs = {"moe_ep": run(ep)}
            if cf == 8.0:
                refs["moe_einsum"] = run(lambda w, xx, pp: MOE.moe_einsum(m, w, xx, idx, pp))
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t.float()).all()) for t in got.values())
        bad = []
        for ref_name, ref in refs.items():
            rel = {n: ((got[n].float() - ref[n].float()).abs().max()
                       / ref[n].float().abs().max().clamp(min=1e-30)).item() for n in names}
            log(f"moe_ep backward, deepseek-moe-16b widths, {MOE_EP_ROWS} rows, capacity "
                f"factor {cf}, model group of 1: the kernels vs {ref_name}'s plain versions, "
                f"largest difference over the largest entry: "
                + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
                + f" (limit {TOL_MOE_EP_GRAD_REL}); K7 batched launches by body {bodies}; "
                f"finite={finite}")
            bad += [(ref_name, k, v) for k, v in rel.items() if not v <= TOL_MOE_EP_GRAD_REL]
        if bad or not finite or sum(bodies.values()) != 9 or "fma" in bodies:
            raise AssertionError(f"moe_ep backward at capacity factor {cf}: {bad}, "
                                 f"launches {bodies}, finite {finite}")
        del got, refs
    del params, x, dy
    gc.collect()
    torch.cuda.empty_cache()


def mesh_train_plan() -> None:
    """Per-card bytes of the parameters, their gradients and AdamW's or
    Adafactor's state (the config's optimizer) under ``rules_for``'s
    training rules (analytic: the policy's ``sharded_bytes_per_device`` on
    meta tensors; fp32 master weights and gradients), for qwen2-vl-72b at
    80 layers and qwen3-moe-235b-a22b, on the production 16 x 16 mesh and
    on 1 x 4 and 2 x 4 meshes of H100s, 4 x 4096 tokens; and the
    ``Trainer``'s peak in its init there: the parameters' and state's
    slices and the largest leaf it draws whole before it cuts it (one
    layer of a stacked leaf)."""
    import torch

    from repro_torch.common import dtype_of
    from repro_torch.configs import registry as arch_registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.specs import abstract_params
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import MeshShape, rules_for
    from repro_torch.models.registry import fns_for
    from repro_torch.optim.optimizers import leaves, make_optimizer
    for arch in ("qwen2-vl-72b", "qwen3-moe-235b-a22b"):
        cfg = arch_registry.config(arch)
        params = abstract_params(cfg)
        opt = make_optimizer(cfg)
        state = opt.init(params)
        axes = policy.param_axes(cfg)
        drawn = max(math.prod((d.layer or d).shape) for d in leaves(fns_for(cfg).table(cfg)))
        drawn *= torch.empty((), dtype=dtype_of(cfg.param_dtype)).element_size()
        for shape in ((16, 16), (1, 4), (2, 4)):
            mesh = MeshShape(("data", "model"), shape)
            rules = rules_for(cfg, ShapeConfig("train_4k", "train", 4096, 16 * shape[0]),
                              mesh)
            p = policy.sharded_bytes_per_device(params, axes, rules, mesh)
            s = policy.sharded_bytes_per_device(state, opt.state_axes(axes), rules, mesh)
            log(f"mesh train plan {shape[0]} x {shape[1]}: {arch} fp32 params "
                f"{p / 2**30:.2f} GiB + gradients {p / 2**30:.2f} GiB + {cfg.optimizer} state "
                f"{s / 2**30:.2f} GiB = {(2 * p + s) / 2**30:.2f} GiB a card (activations "
                f"aside); the Trainer's init peaks at {(p + s + drawn) / 2**30:.2f} GiB "
                f"(one leaf drawn whole, {drawn / 2**30:.2f} GiB); rules "
                f"embed={rules.rules['embed']} heads={rules.rules['heads']} "
                f"kv_heads={rules.rules['kv_heads']} ff={rules.rules['ff']} "
                f"experts={rules.rules['experts']}")
        del params, state
    del torch


def mesh_train_phase(torch, np, table) -> tuple[dict, dict]:
    """Phase 32: 32b, the training plan, then 32a and 32c inside an NCCL
    world of one rank, destroyed at the end.  Returns (32b's extras by
    kernel, 32a's mesh launches by kernel)."""
    import torch.distributed as dist
    extras = mesh_shard_kernel_phase(torch, table)
    mesh_train_plan()
    mesh = nccl_world(torch)
    try:
        launches = mesh_training_phase(torch, np, table, mesh)
        moe_ep_backward_phase(torch, table, mesh)
    finally:
        dist.destroy_process_group()
    return extras, launches


TRAIN_EXTRAS = tuple(f"train_{p}_{k}" for p in ("dx", "dw") for k in (
    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape", "wgmma_ms",
    "persistent_ms"))


LSE_EXTRAS = ("lse_ms", "lse_nolse_ms", "lse_fma_ms", "lse_fma_nolse_ms", "lse_plain_ms",
              "lse_library_ms", "lse_bound_ms", "lse_bound_by", "lse_shape", "max_abs_err_lse")


WHISPER_TAGS = ("whisper_encoder", "whisper_cross", "whisper_cross_ragged",
                "whisper_cross_decode")
WHISPER_EXTRAS = tuple(f"{t}_{k}" for t in WHISPER_TAGS for k in (
    "ms", "fma_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape"))


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
    timed("17 contiguous path check", path_check, torch, np, contiguous=True,
          depths=(1, 2, 4))
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
    results["ssm_scan"].update(timed("23a xlstm scan", xlstm_kernel_phase, torch, table))
    xlstm = timed("23b xlstm serving", xlstm_serving_phase, torch, np, table)
    timed("23c xlstm path check", xlstm_path_check, torch, np)
    results["ssm_scan_backward"].update(timed("24a xlstm scan backward",
                                              xlstm_scan_backward_phase, torch, table))
    timed("24b xlstm training path check", xlstm_train_path_check, torch, np)
    xlstm_trained = timed("24c xlstm training", xlstm_training_phase, torch, np, table)
    results.update(timed("25a moe kernels", moe_kernel_phase, torch, table))
    moe_served = timed("25b moe serving", moe_serving_phase, torch, np, table)
    timed("25c moe path check", moe_path_check, torch, np)
    results["matmul_batched"].update(timed("26a moe backward kernels", moe_backward_phase,
                                           torch, table))
    timed("26b moe training path check", moe_train_path_check, torch, np)
    moe_trained = timed("26c moe training", moe_training_phase, torch, np, table)
    vlm_served = timed("27a vlm serving", vlm_serving_phase, torch, np, table)
    timed("27b vlm path check", vlm_path_check, torch, np)
    for name, extra in timed("28a whisper kernels", whisper_kernel_phase, torch,
                             table).items():
        results[name].update(extra)
    timed("28b whisper path check", whisper_path_check, torch, np)
    whisper_served = timed("28c whisper serving", whisper_serving_phase, torch, np, table)
    results["flash_attention_backward"].update(timed(
        "29a whisper attention backward", whisper_backward_phase, torch, table))
    timed("29b whisper training path check", whisper_train_path_check, torch, np)
    whisper_trained = timed("29c whisper training", whisper_training_phase, torch, np, table)
    timed("30a vlm training path check", vlm_train_path_check, torch, np)
    vlm_trained = timed("30b vlm training", vlm_training_phase, torch, np, table)
    lse, mesh_served = timed("31 mesh serving", mesh_phase, torch, np, table)
    results["decode_attention"].update(lse)
    tp4, mesh_trained = timed("32 mesh training", mesh_train_phase, torch, np, table)
    for name, extra in tp4.items():
        results[name].update(extra)
    # the trained paths: qwen2.5-3b's K4 and its backward (phase 15), and
    # zamba2's K5, K4, their backward kernels and K7 (21d)
    launches["flash_attention"] += trained["flash_attention"]
    launches["flash_attention_backward"] = trained["flash_attention_backward"]
    launches["ssm_scan_backward"] = 0
    for name, count in zamba_trained.items():
        launches[name] += count
    # GoogLeNet training's K6, its backward and K7 (22c); remat "dots" (22d)
    launches["conv2d_backward"] = 0
    launches["matmul_batched"] = 0
    for name, count in (list(googlenet_trained.items()) + list(dots_trained.items())
                        + list(xlstm.items()) + list(xlstm_trained.items())
                        + list(moe_served.items()) + list(moe_trained.items())
                        + list(vlm_served.items()) + list(whisper_served.items())
                        + list(whisper_trained.items()) + list(vlm_trained.items())
                        + list(mesh_served.items()) + list(mesh_trained.items())):
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
                 "ssm_scan", "ssm_scan_backward", "conv2d", "conv2d_backward", "matmul",
                 "matmul_batched"):
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
        for extra in ("fma_ms", "bf16_body_ms", "sdpa_dequantized_ms", "fp16_ms",
                      "fp16_library_ms", "fp16_bound_ms", "xlstm_ms", "xlstm_plain_ms",
                      "xlstm_bound_ms", "xlstm_bound_by", "xlstm_shape", "decode_ms",
                      "decode_plain_ms", "decode_library_ms", "decode_bound_ms",
                      "decode_bound_by", "decode_shape") + TRAIN_EXTRAS + WHISPER_EXTRAS \
                + LSE_EXTRAS:
            # the FMA body, the bf16 body on the dequantized pool, SDPA on it;
            # K6's backward at fp16 beside cuDNN's and its bound; K5 at
            # xlstm-125m's widths; K7's batched entry at a decode step's shape
            # and its backward products at a training microbatch's; K4 and
            # K3 at whisper-medium's encoder, cross-attention and
            # cross-decode shapes; K3 with its row log-sum-exp
            if extra in r:
                kernels[-1][extra] = r[extra]
        for extra, v in r.items():
            # phase 32b: K4, its backward and K7 at a 1 x 4 rank's shapes
            if extra.startswith(("tp4", "max_abs_err_tp4")):
                kernels[-1][extra] = v
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}ms"
        if "sdpa_dequantized_ms" in r:
            lib += (f" (SDPA on the dequantized bf16 tensors, not the same function, "
                    f"{r['sdpa_dequantized_ms']:.4f}ms; the bf16 body on them "
                    f"{r['bf16_body_ms']:.4f}ms)")
        fma = f" (fma body {r['fma_ms']:.4f}ms)" if "fma_ms" in r else ""
        if "fma_bound_ms" in r:
            fma = f" (fma body {r['fma_ms']:.4f}ms, its bound {r['fma_bound_ms']:.4f}ms)"
        if "decode_ms" in r:
            fma += (f" (at {r['decode_shape']}: {r['decode_ms']:.4f}ms, plain "
                    f"{r['decode_plain_ms']:.4f}ms, torch.bmm {r['decode_library_ms']:.4f}ms, "
                    f"bound {r['decode_bound_ms']:.5f}ms ({r['decode_bound_by']}))")
        for key in ("train_dx", "train_dw"):
            if f"{key}_ms" in r:
                fma += (f" (at {r[f'{key}_shape']}: {r[f'{key}_ms']:.4f}ms -- the wgmma "
                        f"body {r[f'{key}_wgmma_ms']:.4f}ms, the persistent one "
                        f"{r[f'{key}_persistent_ms']:.4f}ms --, plain "
                        f"{r[f'{key}_plain_ms']:.4f}ms, torch.bmm "
                        f"{r[f'{key}_library_ms']:.4f}ms, bound {r[f'{key}_bound_ms']:.5f}ms "
                        f"({r[f'{key}_bound_by']}))")
        for tag in WHISPER_TAGS:
            if f"{tag}_ms" in r:
                tag_fma = (f" (fma body {r[f'{tag}_fma_ms']:.4f}ms)" if f"{tag}_fma_ms" in r
                           else "")
                fma += (f" (at {r[f'{tag}_shape']}: {r[f'{tag}_ms']:.4f}ms{tag_fma}, plain "
                        f"{r[f'{tag}_plain_ms']:.4f}ms, SDPA {r[f'{tag}_library_ms']:.4f}ms, "
                        f"bound {r[f'{tag}_bound_ms']:.5f}ms ({r[f'{tag}_bound_by']}))")
        if "lse_ms" in r:
            fma += (f" (with the row log-sum-exp at {r['lse_shape']}: {r['lse_ms']:.4f}ms, "
                    f"without {r['lse_nolse_ms']:.4f}ms, fma body {r['lse_fma_ms']:.4f}ms / "
                    f"{r['lse_fma_nolse_ms']:.4f}ms, plain {r['lse_plain_ms']:.4f}ms, library "
                    f"none, bound {r['lse_bound_ms']:.5f}ms ({r['lse_bound_by']}))")
        if "xlstm_ms" in r:
            fma += (f" (at {r['xlstm_shape']}: {r['xlstm_ms']:.4f}ms, plain "
                    f"{r['xlstm_plain_ms']:.4f}ms, bound {r['xlstm_bound_ms']:.5f}ms "
                    f"({r['xlstm_bound_by']}))")
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
