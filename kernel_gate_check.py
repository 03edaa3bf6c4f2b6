#!/usr/bin/env python3
"""How far ``chip_smoke.py``'s kernel gate (``dispatch.tolerance_ratio``)
sits from a right kernel and from a wrong one.  Run from the repository
root:

    python3 kernel_gate_check.py          # on any host, CPU only
    python3 kernel_gate_check.py --card   # on a host with an NVIDIA card

CPU: chip_smoke's kernel cases at qwen2.5-3b widths (H=16, K=2, D=128,
block 16) on bf16 values, six seeds.  The CUDA kernels' round points are
emulated in fp32 PyTorch (``p`` rounded to bf16 before the PV product, the
output rounded to bf16) and held against the plain version evaluated in
fp32; printed are the largest err/limit of that emulation, of the same
emulation with one 16-row pool block lost, and of the plain version run
at bf16 (which also rounds scores and PV to bf16).

``--card``: copies ``src/`` into a temporary directory and changes one
kernel there so that its block loop skips pool block 0 when more than two
blocks are live; builds both kernels from the copy and runs chip_smoke's
gate (``hold``) on every case at fp32 and bf16, printing err/limit for
each (the gate must fail the long cases).  Once for each kernel.
"""
from __future__ import annotations

import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from chip_smoke import DECODE_CASES, PREFILL_CASES

ROOT = Path(__file__).resolve().parent
H, K, D, BS = 16, 2, 128, 16
LOOP = "for (int ib = 0; ib < nblk; ++ib) {"
SKIP_BLOCK_0 = "for (int ib = (nblk > 2); ib < nblk; ++ib) {"


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


def card_check() -> None:
    if sys.argv[2:3] == ["--mutant"]:
        return mutant_gate(sys.argv[3])
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        with tempfile.TemporaryDirectory() as d:
            shutil.copytree(ROOT / "src", Path(d) / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            cu = Path(d) / "src" / "repro_torch" / "csrc" / f"{name}.cu"
            text = cu.read_text()
            if text.count(LOOP) != 1:
                raise SystemExit(f"{cu.name}: block loop not found")
            cu.write_text(text.replace(LOOP, SKIP_BLOCK_0))
            print(f"=== mutant: {name} skips pool block 0 when more than two "
                  f"blocks are live", flush=True)
            subprocess.run([sys.executable, __file__, "--card", "--mutant", d],
                           check=True)


def mutant_gate(d: str) -> None:
    sys.path.insert(0, d + "/src")
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, dispatch
    build.build()
    table = dispatch.kernel_table()
    cases = [("paged_decode_attention", f"lengths={lengths}",
              lambda dt, n=lengths: cs.decode_case(torch, n, dt), {"softcap": sc})
             for lengths, sc in DECODE_CASES]
    cases += [("paged_prefill_attention", f"C={C} q_start={qs}",
               lambda dt, C=C, qs=qs: cs.prefill_case(
                   torch, C, qs, dt, seeded_blocks=-(-qs // BS) + 3), {})
              for C, qs in PREFILL_CASES]
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, make, kw in cases:
            try:
                cs.hold(torch, table[name], make(dtype), label, **kw)
            except AssertionError as e:
                print(f"  failed the gate: {e}", flush=True)


if __name__ == "__main__":
    card_check() if sys.argv[1:2] == ["--card"] else cpu_check()
