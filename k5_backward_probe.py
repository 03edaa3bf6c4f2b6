#!/usr/bin/env python3
"""Two measurements of K5's backward (``csrc/ssm_scan_backward.cu``) on an
NVIDIA card, each behind a design decision.  Run from the repository root:

    python3 k5_backward_probe.py layouts   # the FMA body's two layouts
    python3 k5_backward_probe.py b_i       # what moves xlstm's b_i gradient

``layouts``: the FMA body stages whole rows of N and P up to 128 and walks
wider widths in 64-column slices.  This copies ``src/`` into a temporary
directory, makes the copy walk every width in slices, and times both
layouts (``chip_smoke.Timer``: L2 flushed, CUDA events, three means of 20
calls) at zamba2-1.2b's training shape (B=1, S=512, H=64, N=P=64, chunk
128, B and C as stride-0 head views; bf16 forced onto FMA, fp32, and fp32
per head), each launch timed apart under the profiler, after holding each
layout against its plain version (S = 512, 1000, 300 with h0 / d_final,
7) and requiring the same bits twice.  The two trees run in alternation,
each in a process of its own: this tree, the copy, this tree, the copy.

``b_i``: xlstm-125m at full width cut to 1 and 2 blocks, 1 x 300 tokens,
at bf16 and fp32 compute.  On one forward graph through the kernels, the
backward three ways: through the kernels, through the plain versions, and
through the plain versions with K5's backward and K7 in fp64 (rounded back
to the operands' types), K5's backward's operands recorded in each.
Printed: on the kernel run's operands, K5's backward and its plain version
against the fp64 one (each output over its largest entry; d log_gate
summed over the sequence per head, the mLSTM's b_i gradient, over its
largest); those sums' cancellation (sum |d log_gate| over |sum|); the
entries of the scan's dy that differ between the runs; b_i's difference
between the kernel run and the fp64 run split into the scan's own part
and the part the runs' different dy bring (the fp64 scan on each); and
the 1536- and 4-entry leaves against the fp64 run.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SLICED = "bool sliced(int N, int P) { return N > 128 || P > 128; }"


def every_width_sliced(src: Path) -> None:
    """Make the copy ``src`` run the sliced layout at every width."""
    cu = src / "repro_torch" / "csrc" / "ssm_scan_backward.cu"
    ops = src / "repro_torch" / "kernels" / "ssm_scan" / "ops.py"
    text = cu.read_text()
    assert SLICED in text, "the layout rule moved: update k5_backward_probe.py"
    cu.write_text(text.replace(SLICED, "bool sliced(int, int) { return true; }"))
    text = ops.read_text()
    rule = "    return N > 128 or P > 128\n"
    assert rule in text, "the wrapper's layout rule moved: update k5_backward_probe.py"
    ops.write_text(text.replace(rule, "    return True\n"))


def layouts() -> None:
    with tempfile.TemporaryDirectory() as d:
        shutil.copytree(ROOT / "src", Path(d) / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        every_width_sliced(Path(d) / "src")
        for tag, src in (("whole rows", ROOT / "src"), ("sliced", Path(d) / "src")) * 2:
            subprocess.run([sys.executable, __file__, "time", str(src), tag], check=True)


def time_layout(src: str, tag: str) -> None:
    """One tree's FMA backward at zamba2's widths: held, then timed."""
    sys.path[:0] = [src, str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, dispatch
    build.build(["ssm_scan_backward"])
    bwd = dispatch.kernel_table()["ssm_scan_backward"]
    timer = cs.Timer(torch)
    for dt in (torch.bfloat16, torch.float32):
        for S, with_state in ((512, False), (1000, False), (300, True), (7, True)):
            args, h0 = cs.ssm_case(torch, S, dt, with_state=with_state)
            g = torch.Generator("cuda").manual_seed(S + 7)
            dy = torch.randn((1, S, 64, 64), generator=g, device="cuda")
            df = (torch.randn((1, 64, 64, 64), generator=g, device="cuda")
                  if with_state else None)
            cs.hold(torch, bwd, (*args, dy, df), f"[{tag}] S={S} h0/d_final={with_state}",
                    body="fma", chunk=128, initial_state=h0)
            a = bwd.launch(*args, dy, df, chunk=128, initial_state=h0, body="fma")
            b = bwd.launch(*args, dy, df, chunk=128, initial_state=h0, body="fma")
            torch.cuda.synchronize()
            assert all(torch.equal(u, w) for u, w in zip(a, b) if u is not None)
        cases = [("shared B/C", True)] + ([("per head", False)] if dt == torch.float32 else [])
        for what, shared in cases:
            args, _ = cs.ssm_case(torch, 512, dt, shared=shared)
            dy = torch.randn((1, 512, 64, 64), device="cuda")
            ms = [timer(lambda: bwd.launch(*args, dy, chunk=128, body="fma"))
                  for _ in range(3)]
            t = cs.pass_times(torch, lambda: bwd.launch(*args, dy, chunk=128, body="fma"),
                              "ssm_bwd_")
            print(f"[{tag}] {str(dt)[6:]} FMA backward B=1 S=512 H=64 N=P=64 {what}: "
                  + " ".join(f"{m:.4f}" for m in ms) + " ms; by launch: "
                  + cs.launch_times(t), flush=True)


def b_i() -> None:
    sys.path[:0] = [str(ROOT / "src")]
    from unittest import mock

    import torch

    from repro_torch.configs import registry as arch_registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_backward_ref
    from repro_torch.models.layers import linear
    from repro_torch.models.registry import fns_for
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn
    build.build(["ssm_scan", "ssm_scan_backward", "matmul"])
    torch.backends.cuda.matmul.allow_tf32 = False
    bwd = ssm_ops.BACKWARD
    calls = []

    def recorded(fn):               # fn as it is, its operands kept
        def call(*args, **kw):
            calls.append((args, kw))
            return fn(*args, **kw)
        return call

    def fp64(args, kw):
        d = [t.double() if isinstance(t, torch.Tensor) else t for t in args]
        h0 = kw.get("initial_state")
        return ssm_scan_backward_ref(*d, chunk=kw["chunk"],
                                     initial_state=None if h0 is None else h0.double())

    def exact_scan(q, k, v, ld, lg, dy, d_final=None, *, chunk=128, initial_state=None):
        out = fp64((q, k, v, ld, lg, dy, d_final), dict(chunk=chunk, initial_state=initial_state))
        return tuple(None if o is None else o.to(t.dtype if i < 3 else torch.float32)
                     for i, (o, t) in enumerate(zip(out, (q, k, v, ld, ld, ld))))

    def exact_k7(x, y):
        return (x.double() @ y.double()).to(x.dtype)

    def rel(x, y):
        return ((x.double() - y.double()).abs().max()
                / y.double().abs().max().clamp(min=1e-300)).item()

    for layers in (1, 2):
        for compute in ("bfloat16", "float32"):
            cfg = arch_registry.config("xlstm-125m").replace(compute_dtype=compute,
                                                             num_layers=layers)
            params = fns_for(cfg).init(cfg, torch.Generator("cuda").manual_seed(0))
            batch = {k: torch.as_tensor(v).cuda()
                     for k, v in next(SyntheticTokens(cfg, 1, 300, seed=5)).items()}
            ps = leaves(params)
            for p in ps:
                p.requires_grad_(True)
            loss, _ = make_loss_fn(cfg)(params, batch)
            calls.clear()
            with mock.patch.object(bwd, "launch", recorded(bwd.launch)):
                kern = torch.autograd.grad(loss, ps, retain_graph=True)
            with dispatch.plain_versions():
                with mock.patch.object(bwd, "plain", recorded(bwd.plain)):
                    plain = torch.autograd.grad(loss, ps, retain_graph=True)
                with mock.patch.object(linear, "_k7", exact_k7), \
                        mock.patch.object(bwd, "plain", recorded(exact_scan)):
                    exact = torch.autograd.grad(loss, ps)
            (ak, kwk), (ap, _), (ax, kwx) = calls
            print(f"=== xlstm-125m, {layers} block(s), {compute} compute, 1 x 300 tokens",
                  flush=True)
            with torch.no_grad():
                outk, outp, out64 = bwd.launch(*ak, **kwk), bwd.plain(*ak, **kwk), fp64(ak, kwk)
                torch.cuda.synchronize()
                for name, i in (("dq", 0), ("dk", 1), ("dv", 2), ("d log_decay", 3),
                                ("d log_gate", 4)):
                    print(f"  same operands, {name}: kernel~fp64 {rel(outk[i], out64[i]):.3e}"
                          f"  plain~fp64 {rel(outp[i], out64[i]):.3e}")
                s64 = out64[4].sum((0, 1))
                sk, sp = outk[4].double().sum((0, 1)), outp[4].double().sum((0, 1))
                top = s64.abs().max()
                print(f"  same operands, d log_gate summed per head (b_i's gradient): "
                      f"kernel~fp64 {((sk - s64).abs().max() / top).item():.3e}  plain~fp64 "
                      f"{((sp - s64).abs().max() / top).item():.3e}  kernel~plain "
                      f"{((sk - sp).abs().max() / sp.abs().max()).item():.3e}; cancellation "
                      f"sum|.|/|sum| per head "
                      + " ".join(f"{c:.3g}" for c in
                                 (out64[4].abs().sum((0, 1)) / s64.abs()).tolist()))
                for other, a in (("plain", ap), ("fp64", ax)):
                    print(f"  dy of the kernel run vs the {other} run: rel {rel(ak[5], a[5]):.3e},"
                          f" {int((ak[5] != a[5]).sum())} of {ak[5].numel()} entries differ")
                up = fp64(ax, kwx)[4].sum((0, 1))
                print(f"  b_i, kernel run vs fp64 run, over its largest: the scan's own part "
                      f"{((sk - s64).abs().max() / top).item():.3e}, its dy's part (fp64 scan "
                      f"on each run's dy) {((s64 - up).abs().max() / top).item():.3e}")
            bi = {id(b["core"]["b_i"]) for b in params["blocks"] if "b_i" in b["core"]}
            for p, k, pl, ex in zip(ps, kern, plain, exact):
                if p.numel() in (4, 1536):
                    name = "b_i" if id(p) in bi else f"{tuple(p.shape)}"
                    print(f"  leaf {name}: max|g| {pl.abs().max().item():.3e}  kernels~fp64 "
                          f"{rel(k, ex):.3e}  plain~fp64 {rel(pl, ex):.3e}  kernels~plain "
                          f"{rel(k, pl):.3e}")
            for p in ps:
                p.requires_grad_(False)
            del params, ps, kern, plain, exact, loss, ak, ap, ax, outk, outp, out64
            calls.clear()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k5_backward_probe.py needs an NVIDIA card")
    what = sys.argv[1:2]
    if what == ["time"]:
        time_layout(*sys.argv[2:4])
    elif what == ["layouts"]:
        layouts()
    elif what == ["b_i"]:
        b_i()
    else:
        raise SystemExit(__doc__)
