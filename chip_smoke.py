#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each one raises on failure; the script then exits non-zero):

1. Card: require CUDA, print the card's name and power limit.
2. Build: compile every kernel in ``src/repro_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, in parallel); print ``-Xptxas -v``.
3. Kernels: hold each kernel against its plain PyTorch version on the card
   at qwen2.5-3b widths (H=16, K=2, D=128, block 16), with fp32 and with
   bf16 pools (limits in ``repro_torch.kernels.dispatch``: fp32 1e-4; bf16
   2^-7 |ref| + 2^-6 rms(ref) per element, against the plain version
   evaluated in fp32 on the same bf16 values), and time the bf16 kernel,
   its plain version and one PyTorch library call on the same inputs,
   beside the least time the card could take.
4. Serving: qwen2.5-3b at full width (random weights from seed 0) through
   ``repro_torch``'s paged ``ServingEngine``: 4 slots, 256-token prefill
   chunks, 8 greedy requests of 256-1024 prompt tokens (half share a
   256-token prefix), 32 new tokens each.  The kernels' launch counts are
   zeroed just before and read just after; the run fails unless every
   kernel launched and no plain version ran.
5. Profile: a short serving run under ``torch.profiler``; device time by
   kernel and the device's busy share of the wall time.
6. Path check: one request served at full width in fp32 by an engine
   through the kernels and by one through the plain versions; its prefill
   and decode logits are compared at depths 1, 2 and 4 (gated) and 36
   (printed beside two plain runs that differ only in summation order).
7. K6 conv2d: the kernel held against its plain version (evaluated in fp32
   on the same values; limits ``CONV_RTOL`` / ``CONV_RMS_ATOL`` in
   ``repro_torch.kernels.dispatch``) on every distinct conv shape of
   GoogLeNet's batch-8 forward at 224, at fp32, fp16 and bf16; then each of
   the 57 convolutions timed at fp32 and fp16 beside its plain version, one
   ``F.conv2d`` call (cuDNN, channels_last, TF32 off) and its bound.
8. GoogLeNet: full width (224x224x3, 1000 classes, 9 inception modules),
   random weights from seed 0, ``SyntheticImages``, at fp32 and fp16:
   (a) batch-8 logits through the kernels vs through the plain versions
   (gated: largest difference over the largest logit, ``TOL_GOOGLENET``,
   and the same top-1); (b) img/s, time per batch and img/W against the
   power limit through ``OffloadEngine([TorchTarget])`` at batch 1 and 8,
   with (c) the conv kernel's counts zeroed before and read after each
   run: 57 launches per forward, no plain call; (d) the paper's fig 7
   estimators (fp16 and bf16 vs fp32 over 48 images); (e) one batch-8
   forward under ``torch.profiler``: device busy share and the conv
   kernel's share of device time.

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
# Kernel cases, qwen2.5-3b widths: K1 (lengths of 4 sequences, softcap)
# and K2 (chunk rows C, q_start).
DECODE_CASES = (((1, 15, 16, 17), 0.0), ((300, 1056, 16, 1), 0.0),
                ((1, 15, 300, 1056), 30.0))
PREFILL_CASES = ((16, 0), (16, 9), (16, 256), (256, 0), (256, 9), (256, 256))
# fp32 path check, kernels vs plain versions, by depth: limits on the
# largest logit difference relative to the largest logit (see path_check).
TOL_PATH_REL = {1: 1e-5, 2: 1e-4, 4: 1e-2}
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


def decode_case(torch, lengths, dtype, *, B=4, H=16, K=2, D=128, bs=16, seed=0):
    """Random pool, shuffled disjoint block tables, given lengths."""
    g = torch.Generator("cuda").manual_seed(seed)
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


def hold(torch, kern, args, label, **kw) -> float:
    """Launch ``kern`` on one case and hold it against its plain version
    evaluated in fp32 on the same values; raise past the kernel's limit
    (``kern.tolerance``).  Returns the largest absolute error."""
    out = kern.launch(*args, **kw)
    ref = kern.plain(*(a.float() if a.is_floating_point() else a for a in args), **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    ratio = kern.tolerance(out, ref)
    log(f"{kern.name} {label} {str(out.dtype)[6:]}: max_abs_err={err:.3e} "
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


def kernel_phase(torch, table):
    import torch.nn.functional as F
    dec = table["paged_decode_attention"]
    pre = table["paged_prefill_attention"]
    timer = Timer(torch)
    results = {}

    # --- K1 paged decode: boundary lengths, long lengths, softcap ---------
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in errs:
        for lengths, softcap in DECODE_CASES:
            errs[dtype] = max(errs[dtype], hold(
                torch, dec, decode_case(torch, lengths, dtype),
                f"lengths={lengths} softcap={softcap}", softcap=softcap))
    err_dec = errs[torch.bfloat16]
    # timed at a serving-like batch: 4 slots with long and short histories
    lengths = (1056, 800, 512, 300)
    q, kp, vp, tables, lens = decode_case(torch, lengths, torch.bfloat16)
    B, H, D = q.shape
    K = kp.shape[2]
    G = H // K
    ms = timer(lambda: dec.launch(q, kp, vp, tables, lens))
    plain_ms = timer(lambda: dec.plain(q, kp, vp, tables, lens))
    kg, vg = gathered(torch, kp, vp, tables, G)
    S = kg.shape[2]
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qh = q[:, :, None, :]
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask))
    rows = sum(lengths)
    nbytes = 2 * (2 * B * H * D + 2 * rows * K * D) + 4 * (B + sum(-(-n // 16) for n in lengths))
    flops = 4 * H * D * rows
    results["paged_decode_attention"] = dict(
        max_abs_err=err_dec, max_abs_err_fp32=errs[torch.float32], ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes, flops=flops,
        shape=f"B=4 lengths={lengths} bf16")

    # --- K2 paged prefill: chunk 16 / 256 at q_start 0, 9, 256 ---------------
    errs_pre = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in errs_pre:
        for C, q_start in PREFILL_CASES:
            args = prefill_case(torch, C, q_start, dtype,
                                seeded_blocks=-(-q_start // 16) + 3)
            errs_pre[dtype] = max(errs_pre[dtype], hold(
                torch, pre, args, f"C={C} q_start={q_start}"))
    err_pre = errs_pre[torch.bfloat16]
    args = prefill_case(torch, 256, 256, torch.bfloat16, seeded_blocks=16)
    q, kp, vp, tables, qs, lens = args
    ms = timer(lambda: pre.launch(*args))
    plain_ms = timer(lambda: pre.plain(*args))
    _, C, H, D = q.shape
    kg, vg = gathered(torch, kp, vp, tables, G)
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
    results["paged_prefill_attention"] = dict(
        max_abs_err=err_pre, max_abs_err_fp32=errs_pre[torch.float32], ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes, flops=flops,
        shape="C=256 q_start=256 bf16")
    for r in results.values():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"], BF16_FLOPS)
    return results


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
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    counts = {name: (table[name].launches, table[name].plain_calls)
              for name in LM_KERNELS}
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
    log(f"serving: launches={ {n: c[0] for n, c in counts.items()} } "
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
    for ms, count, name in rows[:12]:
        log(f"profile: {ms:10.3f} ms  {count:6d} calls  {name[:90]}")


def path_check(torch, np):
    """One 300-token request (a 256-row prefill chunk, then 44 rows seeded
    past it, then one decode step) served at full width in fp32 by a
    ``ServingEngine`` through the kernels and by one through the plain
    versions (``dispatch.plain_versions()``), at depths 1, 2, 4 and 36.
    The request's sampler records the prefill and the decode logits and
    answers a fixed token, so both engines decode the same token.

    Depths 1, 2 and 4 are gated (``TOL_PATH_REL``).  The reference's
    random init takes fan-in from the head axis, so attention logits have a
    std of several hundred and the softmax is near one-hot: every layer
    multiplies a rounding difference by a large factor.  So each depth also
    prints a second plain run that differs from the first only in its
    summation order (the plain versions' KV tile, ``chunk`` 64 against
    512): how far two correct fp32 paths drift apart at that depth.  Depth
    36 is printed, not gated."""
    from repro_torch.configs import registry as arch_registry
    from repro_torch.kernels import dispatch
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
        launched = all(table[n].launches > 0 and table[n].plain_calls == 0
                       for n in LM_KERNELS)
        with dispatch.plain_versions():
            plain = serve(cfg, p)
            plain64 = serve(cfg, p, chunk=64)
        tol = TOL_PATH_REL.get(depth)
        r_pre, r_dec = rel(kern[0], plain[0]), rel(kern[1], plain[1])
        log(f"path check (fp32, full width, depth {depth}): kernels vs plain "
            f"rel prefill={r_pre:.3e} decode={r_dec:.3e} "
            f"top1_agree={bool((kern.argmax(-1) == plain.argmax(-1)).all())} "
            + (f"(tol {tol}); " if tol else "(not gated); ")
            + f"plain chunk 64 vs 512 rel prefill={rel(plain64[0], plain[0]):.3e} "
            f"decode={rel(plain64[1], plain[1]):.3e} "
            f"top1_agree={bool((plain64.argmax(-1) == plain.argmax(-1)).all())}")
        if not launched:
            raise AssertionError("path check: the kernel engine did not run "
                                 "through both kernels alone")
        if tol and not (np.isfinite(kern).all() and max(r_pre, r_dec) <= tol):
            raise AssertionError(f"path check, depth {depth}: kernels and plain "
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


def conv_phase(torch, table) -> dict:
    """K6 against its plain version on every distinct conv shape of the
    batch-8 forward at 224 (fp32, fp16, bf16), then the 57 convolutions
    timed at fp32 and fp16: kernel, plain version, one F.conv2d call, bound.
    Sums are over the 57 launches of one forward."""
    import torch.nn.functional as F
    conv = table["conv2d"]
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: full fp32 products
    torch.backends.cudnn.allow_tf32 = False         # library call at fp32: no TF32
    groups = conv_groups()
    errs = {}
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        errs[dtype] = max(
            hold(torch, conv, conv_case(torch, xs, ws, dtype),
                 f"{names[0]} x{xs} w{ws} /{stride}", stride=stride)
            for (xs, ws, stride), names in groups.items())
    timer = Timer(torch, reps=10)
    out = {}
    for dtype in (torch.float32, torch.float16):
        dname = str(dtype)[6:]
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0, flops=0.0, bytes=0.0)
        for (xs, ws, stride), names in groups.items():
            x, w, b = conv_case(torch, xs, ws, dtype)
            n = len(names)
            ms = timer(lambda: conv.launch(x, w, b, stride=stride))
            plain_ms = timer(lambda: conv.plain(x, w, b, stride=stride))
            lib_ms = timer(library_conv(torch, F, x, w, b, stride))
            B, H, W, Cin = xs
            KH, KW, _, Cout = ws
            M = B * -(-H // stride) * -(-W // stride)
            flops = 2.0 * M * Cout * KH * KW * Cin
            nbytes = x.element_size() * (x.numel() + w.numel() + M * Cout) + 4 * Cout
            bms, by = bound(nbytes, flops, PEAK_FLOPS[dname])
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", bms), ("flops", flops), ("bytes", nbytes),
                           ("bytes_ms", nbytes / HBM_BYTES_PER_S * 1e3),
                           ("ops_ms", flops / PEAK_FLOPS[dname] * 1e3)):
                tot[key] += n * v
            log(f"conv2d {dname} {','.join(names)}: x{xs} w{ws} /{stride} "
                f"kernel {ms:.4f}ms plain {plain_ms:.4f}ms library {lib_ms:.4f}ms "
                f"bound {bms:.5f}ms ({by}) {flops / ms / 1e9:.1f} TFLOP/s")
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        log(f"conv2d {dname}, 57 launches of one batch-{CONV_BATCH} forward at "
            f"{CONV_SIZE}: kernel {tot['ms']:.4f}ms plain {tot['plain_ms']:.4f}ms "
            f"library {tot['library_ms']:.4f}ms bound {tot['bound_ms']:.4f}ms "
            f"({tot['bound_by']}, {tot['flops'] / 1e9:.2f} GFLOP, "
            f"{tot['bytes'] / 1e6:.1f} MB; peak {PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s)")
        out[dname] = tot
    r = dict(out["float32"], max_abs_err=errs[torch.float32],
             max_abs_err_fp16=errs[torch.float16], max_abs_err_bf16=errs[torch.bfloat16],
             shape=f"57 convs of GoogLeNet, batch {CONV_BATCH} at {CONV_SIZE}, fp32")
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
        n_kern = (conv.launches, conv.plain_calls)
        with dispatch.plain_versions():
            plain = googlenet.forward(cfg, params, x8)
        rel = ((kern - plain).abs().max() / plain.abs().max()).item()
        top1 = bool((kern.argmax(-1) == plain.argmax(-1)).all())
        log(f"googlenet {prec} path check (batch {CONV_BATCH}, {CONV_SIZE}x{CONV_SIZE}): "
            f"kernels vs plain rel={rel:.3e} (tol {TOL_GOOGLENET[prec]}) top1_agree={top1} "
            f"max|logit|={plain.abs().max().item():.4f} conv launches/plain={n_kern}")
        if not (bool(torch.isfinite(kern).all()) and rel <= TOL_GOOGLENET[prec]
                and top1 and n_kern == (57, 0)):
            raise AssertionError(f"googlenet {prec} path check failed: rel {rel}, "
                                 f"top1 {top1}, counts {n_kern}")
        # (b) + (c): through the offload engine at batch 1 and 8
        for B, nb in ((1, 32), (CONV_BATCH, 16)):
            batches = [src.sample(B)["images"] for _ in range(nb)]
            r = serve_batches(cfg, params, batches, dev)
            rep = report(name, 1, r["img_s"], per_device_watts=watts)
            log(f"googlenet {prec} batch {B} through OffloadEngine([TorchTarget]): "
                f"{r['img_s']:.2f} img/s, {r['batch_ms']:.3f} ms per batch over "
                f"{r['batches']} batches, {rep.items_per_watt:.4f} img/W at "
                f"power.limit {watts:.0f} W; conv launches {r['launches']} "
                f"plain calls {r['plain_calls']}")
            if r["launches"] != 57 * nb or r["plain_calls"] != 0:
                raise AssertionError(f"googlenet {prec} batch {B}: {r['launches']} conv "
                                     f"launches and {r['plain_calls']} plain calls "
                                     f"for {nb} forwards")
            launches += r["launches"]
        # (e) one batch-8 forward under the profiler
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            googlenet.forward(cfg, params, x8)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows) / 1e3
        k6 = sum(r[0] for r in rows if "conv2d_kernel" in r[2]) / 1e3
        if not busy:
            raise AssertionError("googlenet profile: the profiler saw no device time")
        log(f"googlenet {prec} profile (one batch-{CONV_BATCH} forward): wall "
            f"{wall * 1e3:.3f}ms device_busy {busy * 1e3:.3f}ms busy_share "
            f"{busy / wall:.3f} conv2d kernel {k6 * 1e3:.3f}ms = {k6 / busy:.3f} of "
            f"device time")
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
    results.update(conv_phase(torch, table))
    launches["conv2d"] = googlenet_phase(torch, np, table)

    kernels = []
    for name in ("paged_decode_attention", "paged_prefill_attention", "conv2d"):
        k, r = table[name], results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
        log(f"{name} at {r['shape']}: kernel {r['ms']:.4f}ms plain {r['plain_ms']:.4f}ms "
            f"library {r['library_ms']:.4f}ms bound {r['bound_ms']:.4f}ms "
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
