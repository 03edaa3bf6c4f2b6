#!/usr/bin/env python3
"""K3's split-body merge pass (``csrc/decode_split.cuh``,
``decode_merge_kernel``) with and without its row log-sum-exp stores, on
an NVIDIA card.  Run from the repository root:

    python3 k3_merge_probe.py

Copies ``src/`` into directories under ``build/k3_merge_probe/``
(gitignored), edits each copy's merge as ``VARIANTS`` lists, builds every
tree at once (one ``nvcc`` each), then runs each tree in a process of its
own, in turns (this tree, the copies, the copies in reverse, this tree):

- "as is": this tree's merge, one loop over the splits a thread, the
  thread at d == 0 writing M and the denominator when asked;
- "no lse stores": the same loop without those stores (the merge before
  K3 returned its row log-sum-exp);
- "den loop": the denominator summed in a loop of its own before the
  output loop, each thread evaluating ``expf`` twice a split.

Each tree first checks that K3 without the log-sum-exp gives
``chip_smoke.K3_PARENT_BITS`` on both bodies (and, where it writes them,
that the log-sum-exp is within ``chip_smoke.hold_lse``'s limit), then
times bf16 K3 on the split body at the serving path's shape (B=4,
S=1088, H=K=32, D=64, 17 splits) and at phase 31a's timed shape (B=5,
S=1056, H=16, K=2, D=128), without and, where the tree writes it, with
the log-sum-exp.  Times: ``chip_smoke.Timer`` (L2 flushed, CUDA events,
the mean of 100 launches).  Each line names the card (``nvidia-smi``
name and power limit).
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "k3_merge_probe"
LSE_STORES = """    // den is the same in every thread: the one at d == 0 writes it
    if (m_out != nullptr && d == 0) {
      m_out[bh] = M;
      l_out[bh] = den;
    }
"""
ONE_LOOP = """  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int i = 0; i < ns; ++i) {
      const float w = expf(fminf(m[i] - M, 0.f));
      num = fmaf(acc[(size_t)i * D + d], w, num);
      den = fmaf(l[i], w, den);
    }
    out[bh * D + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-30f));
""" + LSE_STORES + "  }\n"
DEN_LOOP = """  float den = 0.f;
  for (int i = 0; i < ns; ++i) den = fmaf(l[i], expf(fminf(m[i] - M, 0.f)), den);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int i = 0; i < ns; ++i)
      num = fmaf(acc[(size_t)i * D + d], expf(fminf(m[i] - M, 0.f)), num);
    out[bh * D + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-30f));
  }
  if (m_out != nullptr && threadIdx.x == 0) {
    m_out[bh] = M;
    l_out[bh] = den;
  }
"""
# (name, [(text in decode_split.cuh, replacement)], whether it writes the lse)
VARIANTS = (("no lse stores", [(LSE_STORES, "")], False),
            ("den loop", [(ONE_LOOP, DEN_LOOP)], True))


def make_trees() -> list[tuple[str, Path, bool]]:
    trees = [("as is", ROOT / "src", True)]
    for name, edits, lse in VARIANTS:
        src = WORK / name.replace(" ", "_") / "src"
        shutil.rmtree(src.parent, ignore_errors=True)
        shutil.copytree(ROOT / "src", src, ignore=shutil.ignore_patterns("__pycache__"))
        cuh = src / "repro_torch" / "csrc" / "decode_split.cuh"
        code = cuh.read_text()
        for text, new in edits:
            if code.count(text) != 1:
                raise SystemExit(f"decode_split.cuh: {text!r} not found once: "
                                 f"update k3_merge_probe.py")
            code = code.replace(text, new)
        cuh.write_text(code)
        trees.append((name, src, lse))
    return trees


def main() -> None:
    trees = make_trees()
    builds = [subprocess.Popen([sys.executable, __file__, "build", str(src)])
              for _, src, _ in trees]
    if any(p.wait() for p in builds):
        raise SystemExit("a tree failed to build")
    for turn, order in enumerate((trees, trees[::-1])):
        for name, src, lse in order:
            subprocess.run([sys.executable, __file__, "run", str(src), name, str(int(lse)),
                            str(turn)], check=True)


def setup(src: str):
    sys.path[:0] = [src, str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, dispatch
    build.build(["decode_attention"])
    return torch, cs, dispatch


def run(src: str, name: str, lse: str, turn: str) -> None:
    torch, cs, dispatch = setup(src)
    from repro_torch.kernels.decode_attention.ops import num_splits
    card = cs.card_line()
    kern = dispatch.kernel_table()["decode_attention"]
    lse = lse == "1"
    if turn == "0":
        digests = cs.k3_digests(torch)
        print(f"{name}: without the lse the parent's bits "
              f"{digests == cs.K3_PARENT_BITS} | {card}", flush=True)
        if digests != cs.K3_PARENT_BITS:
            raise SystemExit(f"{name}: bits {digests}")
        if lse:
            for lengths, S, H, K, D in cs.LSE_DECODE_CASES:
                args = cs.dense_decode_case(torch, lengths, torch.bfloat16, S=S, H=H, K=K, D=D)
                cs.hold_lse(torch, kern, args, f"{name} lengths={lengths}", body="mma")
    timer = cs.Timer(torch, reps=100)
    for label, (lengths, S, H, K, D) in (("serving", cs.DENSE_DECODE_CASES[0]),
                                         ("31a", cs.LSE_DECODE_CASES[3])):
        q, k, v, lens = cs.dense_decode_case(torch, lengths, torch.bfloat16, S=S, H=H, K=K,
                                             D=D)
        r = {"ms": timer(lambda: kern.launch(q, k, v, lens, body="mma"))}
        if lse:
            r["lse_ms"] = timer(lambda: kern.launch(q, k, v, lens, return_lse=True, body="mma"))
        times = ", ".join(f"{a} {b:.5f}" for a, b in r.items())
        print(f"{name} ({turn}) | {label} B={len(lengths)} S={S} H={H} K={K} D={D} bf16 mma "
              f"({num_splits(1, S)} splits) | {times} | {card}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["build"]:
        setup(sys.argv[2])
    elif sys.argv[1:2] == ["run"]:
        run(*sys.argv[2:6])
    else:
        main()
