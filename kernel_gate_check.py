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
at bf16 (which also rounds scores and PV to bf16).  Then K6 conv2d on
chip_smoke's gate shapes at batch 1: the plain version at fp16 / bf16 --
the kernel's own round points, an fp32 sum rounded once -- against it at
fp32, and the same with one 16-deep chunk of K lost.

``--card``: copies ``src/`` into a temporary directory and changes one
kernel there: each attention kernel's block loop skips pool block 0 when
more than two blocks are live; the conv kernel's K loop skips its first
16-deep chunk, or its window loses the centre tap.  Builds that kernel
from the copy and runs chip_smoke's gate (``hold``) on its cases (fp32 and
bf16 for attention, fp32 / fp16 / bf16 on the gate shapes for conv),
printing err/limit for each; the gate must fail the long attention cases
and every conv case.  Once for each broken kernel.
"""
from __future__ import annotations

import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from chip_smoke import CONV_GATE_SHAPES, DECODE_CASES, PREFILL_CASES, conv_groups

ROOT = Path(__file__).resolve().parent
H, K, D, BS = 16, 2, 128, 16
LOOP = "for (int ib = 0; ib < nblk; ++ib) {"
SKIP_BLOCK_0 = "for (int ib = (nblk > 2); ib < nblk; ++ib) {"
CONV_LOOP = "for (int k0 = 0; k0 < K; k0 += BK) {"
CONV_SKIP_CHUNK = "for (int k0 = (K > 2 * BK) * BK; k0 < K; k0 += BK) {"
CONV_TAP = "  return true;  // every tap contributes"
CONV_SKIP_TAP = "  return tap != s.KH * s.KW / 2;  // the centre tap is lost"
# (kernel, text, replacement, what the broken copy does)
MUTANTS = (
    ("paged_decode_attention", LOOP, SKIP_BLOCK_0,
     "skips pool block 0 when more than two blocks are live"),
    ("paged_prefill_attention", LOOP, SKIP_BLOCK_0,
     "skips pool block 0 when more than two blocks are live"),
    ("conv2d", CONV_LOOP, CONV_SKIP_CHUNK,
     "skips its first 16-deep K chunk when K > 32"),
    ("conv2d", CONV_TAP, CONV_SKIP_TAP, "loses the centre tap of the window"),
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
    conv_cpu_check(torch)


def conv_cpu_check(torch) -> None:
    """K6 on chip_smoke's gate shapes at batch 1, CPU: the plain version at
    fp16 / bf16 (an fp32 sum rounded once, the kernel's round points)
    against it at fp32 on the same values, and at fp32 / fp16 / bf16 with
    K rows 0-15 (the first 16-deep chunk) of the weight zeroed."""
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
            w_lost[:16] = 0
            out_lost = conv2d_ref(x, w_lost.reshape(w.shape), b, stride=stride)
            key = str(dtype)[6:]
            right[key] = max(right.get(key, 0.0),
                             conv_tolerance_ratio(ref.to(dtype), ref))
            lost[key] = min(lost.get(key, float("inf")),
                            conv_tolerance_ratio(out_lost.to(dtype), ref))
    print("cpu, conv2d on " + ", ".join(CONV_GATE_SHAPES) + " at batch 1: "
          "worst err/limit of the kernel's round points "
          + ", ".join(f"{k} {v:.3f}" for k, v in right.items())
          + "; least err/limit with the first K chunk lost "
          + ", ".join(f"{k} {v:.1f}" for k, v in lost.items()))


def card_check() -> None:
    if sys.argv[2:3] == ["--mutant"]:
        return mutant_gate(sys.argv[3], sys.argv[4])
    for name, text, broken, what in MUTANTS:
        with tempfile.TemporaryDirectory() as d:
            shutil.copytree(ROOT / "src", Path(d) / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            cu = Path(d) / "src" / "repro_torch" / "csrc" / f"{name}.cu"
            source = cu.read_text()
            if source.count(text) != 1:
                raise SystemExit(f"{cu.name}: {text!r} not found once")
            cu.write_text(source.replace(text, broken))
            print(f"=== mutant: {name} {what}", flush=True)
            subprocess.run([sys.executable, __file__, "--card", "--mutant", d, name],
                           check=True)


def mutant_gate(d: str, name: str) -> None:
    sys.path.insert(0, d + "/src")
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, dispatch
    build.build([name])
    kern = dispatch.kernel_table()[name]
    if name == "conv2d":
        shapes = {names[0]: key for key, names in cs.conv_groups().items()}
        cases = [(label, lambda dt, xs=shapes[label][0], ws=shapes[label][1]:
                  cs.conv_case(torch, xs, ws, dt), {"stride": shapes[label][2]})
                 for label in CONV_GATE_SHAPES]
        dtypes = (torch.float32, torch.float16, torch.bfloat16)
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
    for dtype in dtypes:
        failed = []
        for label, make, kw in cases:
            args = make(dtype)
            out = kern.launch(*args, **kw)
            ref = kern.plain(*(a.float() if a.is_floating_point() else a
                               for a in args), **kw)
            torch.cuda.synchronize()
            ratio = kern.tolerance(out, ref)
            if ratio > 1:
                failed.append(ratio)
            print(f"  {label} {str(dtype)[6:]}: err/limit {ratio:.2f}"
                  f"{'' if ratio > 1 else '  (passes the gate)'}", flush=True)
        print(f"  {str(dtype)[6:]}: {len(failed)} of {len(cases)} cases fail the "
              f"gate, least err/limit among them {min(failed, default=0):.2f}",
              flush=True)


if __name__ == "__main__":
    card_check() if sys.argv[1:2] == ["--card"] else cpu_check()
