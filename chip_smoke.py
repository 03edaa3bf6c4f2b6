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
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
# Kernel cases, qwen2.5-3b widths: K1 (lengths of 4 sequences, softcap)
# and K2 (chunk rows C, q_start).
DECODE_CASES = (((1, 15, 16, 17), 0.0), ((300, 1056, 16, 1), 0.0),
                ((1, 15, 300, 1056), 30.0))
PREFILL_CASES = ((16, 0), (16, 9), (16, 256), (256, 0), (256, 9), (256, 256))
# fp32 path check, kernels vs plain versions, by depth: limits on the
# largest logit difference relative to the largest logit (see path_check).
TOL_PATH_REL = {1: 1e-5, 2: 1e-4, 4: 1e-2}


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of one call, L2 flushed before each call (the
    serving path reaches each layer's pools cold), CUDA events around the
    call alone."""

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
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / self.reps


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
    evaluated in fp32 on the same values; raise past the limit of
    ``dispatch.tolerance_ratio``.  Returns the largest absolute error."""
    from repro_torch.kernels import dispatch
    out = kern.launch(*args, **kw)
    ref = kern.plain(*(a.float() if a.is_floating_point() else a for a in args), **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    ratio = dispatch.tolerance_ratio(out, ref)
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
        shape=f"B=4 lengths={lengths}")

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
        shape="C=256 q_start=256")
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
    counts = {name: (k.launches, k.plain_calls) for name, k in table.items()}
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


def profile_phase(torch, np, eng, Request, greedy):
    """Where the time goes: 4 requests of 512 prompt tokens, 16 new tokens
    each, under torch.profiler; device time by kernel name and the device's
    busy share of the wall time (one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType
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
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue        # host-side ops: their kernels are listed themselves
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        rows.append((dev / 1e3, e.count, e.key))
    rows.sort(reverse=True)
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
        launched = all(k.launches > 0 and k.plain_calls == 0
                       for k in dispatch.kernel_table().values())
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

    kernels = []
    for name, k in table.items():
        r = results[name]
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["flops"] / BF16_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": r["library_ms"]})
        log(f"{name}: max_abs_err vs plain bf16 {r['max_abs_err']:.3e} "
            f"fp32 {r['max_abs_err_fp32']:.3e}")
        log(f"{name} at {r['shape']}: kernel {r['ms']:.4f}ms plain {r['plain_ms']:.4f}ms "
            f"library {r['library_ms']:.4f}ms bound {max(bytes_ms, ops_ms):.4f}ms "
            f"({r['bytes']} B, {r['flops']} flop) on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
