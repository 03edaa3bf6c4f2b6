#!/usr/bin/env python3
"""Measurements of K7's batched entry (``csrc/matmul.cu``,
``matmul_batched``) on an NVIDIA card, behind the design of its persistent
body.  Run from the repository root:

    python3 k7b_probe.py [VARIANT ...]   # default: every variant; "as is": none

Copies ``src/`` into directories under ``build/k7b_probe/`` (gitignored),
edits each copy's ``matmul.cu`` as ``VARIANTS`` lists, builds every tree
at once (one ``nvcc`` each; a copy that fails to build is reported and
left out), then runs each tree in a process of its own, twice, in turns
(this tree, the copies, the copies in reverse, this tree):

- this tree ("as is"): first the persistent body held on ``CHECKS`` -- the
  route's body, within K7's limit of the plain version (fp32 on the same
  values), the same bits twice, each expert the 2-D entry's bits on its
  own views -- and every view of ``VIEWS`` forced onto it, bit for bit
  the tile-per-block wgmma body's output.  Then each view of ``VIEWS`` (the MoE
  layer's expert products and their dX / dW at deepseek-moe-16b's widths,
  and the "rule" views: dW at deeper contractions C, forward views of a
  contraction of at most 128, where the route's switch between the bodies
  is set) timed on both wgmma bodies in turns (tile-per-block, persistent,
  persistent, tile-per-block) beside one ``torch.bmm`` on the same
  operands and the bound; at C = 60 the persistent body's dW on both
  tiles, dW on both bodies and ``torch.bmm`` again with L2 flushed by a
  read, not a write (``chip_smoke.Timer(flush="read")``), and a write of
  the same output alone (``zero_``, PyTorch's fill: what writing those
  bytes takes on this card);
- the copies: body 2 without its epilogue's stores, body 2's wide tile
  with one stage (the dW views on body 2), and the persistent body with
  one staging buffer (2 blocks an SM), one ring stage (2 blocks an SM),
  three stages, three staging buffers, its stores hinted to leave L2
  first, or no walk -- one tile a block, body 2's schedule with this
  body's TMA-stored epilogue, 2 or 3 blocks an SM (the dW views at C = 60,
  the prefill forward and dX on it).

Times: ``chip_smoke.Timer`` (L2 flushed, CUDA events, the mean of 20
launches).  Each line names the card (``nvidia-smi`` name and power
limit); the numbers also go to ``artifacts/k7b_probe.json`` (gitignored).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "k7b_probe"
OUT = ROOT / "artifacts" / "k7b_probe.json"
# (label, E, C, D, F, view): x (E, C, D) @ w (E, D, F) ("fwd"), or its
# backward's dX = dY @ w^T / dW = x^T @ dY
VIEWS = (("prefill gate/up", 64, 30, 2048, 1408, "fwd"),
         ("prefill down", 64, 30, 1408, 2048, "fwd"),
         ("decode gate/up", 64, 4, 2048, 1408, "fwd"),
         ("train gate/up", 64, 60, 2048, 1408, "dX"),
         ("train down", 64, 60, 1408, 2048, "dX"),
         ("train gate/up", 64, 60, 2048, 1408, "dW"),
         ("train down", 64, 60, 1408, 2048, "dW"),
         # where the two bodies cross: dW at deeper contractions (C = 128 at
         # 1,092 tokens a batch row, 480 at deepseek's 4096), and forward
         # views of a contraction of at most 128 (timed on this tree only)
         ("rule C=128", 64, 128, 2048, 1408, "dW"),
         ("rule C=129", 64, 129, 2048, 1408, "dW"),
         ("rule C=240", 64, 240, 2048, 1408, "dW"),
         ("rule C=480", 64, 480, 2048, 1408, "dW"),
         ("rule C=960", 64, 960, 2048, 1408, "dW"),
         ("rule C=1920", 64, 1920, 2048, 1408, "dW"),
         ("rule K=64", 64, 30, 64, 1408, "fwd"),
         ("rule K=128", 64, 256, 128, 1408, "fwd"))
# the persistent body's dW views held before anything is timed: the two
# training shapes (more tiles than resident blocks), E = 1, C = 1 and 61,
# ragged M and N at N % 8 == 0, the narrow tile
CHECKS = ((64, 60, 2048, 1408), (64, 60, 1408, 2048), (1, 60, 2048, 1408),
          (64, 1, 2048, 1408), (64, 61, 2048, 1408), (5, 13, 520, 1000), (8, 7, 264, 136))
# (name, [(text in matmul.cu, replacement)], what it times)
VARIANTS = (
    ("no stores", [("if (m >= M || n >= N) continue;",
                    "if (m >= 0) continue;  // the epilogue's stores removed")], "wgmma"),
    ("1 stage", [("return launch_wgmma<T, 2, 128, 3, A_MN, B_MN, RANK3>",
                  "return launch_wgmma<T, 2, 128, 1, A_MN, B_MN, RANK3>")], "wgmma"),
    ("1 staging buffer", [("constexpr int OUT_BUFS = 2;", "constexpr int OUT_BUFS = 1;")],
     "wgmma_persistent"),
    ("3 stages", [("constexpr int P_STAGES = 2;", "constexpr int P_STAGES = 3;")],
     "wgmma_persistent"),
    ("1 stage 2 blocks", [("constexpr int P_STAGES = 2;", "constexpr int P_STAGES = 1;")],
     "wgmma_persistent"),
    ("3 staging buffers", [("constexpr int OUT_BUFS = 2;", "constexpr int OUT_BUFS = 3;")],
     "wgmma_persistent"),
    # body 2's schedule with body 3's epilogue: one tile a block, stored
    # by TMA from one staging buffer, 2 blocks an SM as body 2 (3 with one
    # ring stage), no walk
    ("one tile a block", [("const int grid = (int)std::min<long long>(tiles, (long long)sms * per_sm);",
                           "const int grid = (int)tiles;  // one tile a block"),
                          ("constexpr int OUT_BUFS = 2;", "constexpr int OUT_BUFS = 1;")],
     "wgmma_persistent"),
    ("one tile a block 3 an SM", [
        ("const int grid = (int)std::min<long long>(tiles, (long long)sms * per_sm);",
         "const int grid = (int)tiles;  // one tile a block"),
        ("constexpr int OUT_BUFS = 2;", "constexpr int OUT_BUFS = 1;"),
        ("constexpr int P_STAGES = 2;", "constexpr int P_STAGES = 1;")],
     "wgmma_persistent"),
    ("evict-first stores", [
        ("                                          int outer, int e) {\n  asm volatile(",
         "                                          int outer, int e) {\n  uint64_t policy;\n"
         "  asm volatile(\"createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\" "
         ": \"=l\"(policy));\n  asm volatile("),
        ("shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\"",
         "shared::cta.bulk_group.L2::cache_hint [%0, {%2, %3, %4}], [%1], %5;\""),
        ("\"r\"(smem_u32(src)), \"r\"(inner), \"r\"(outer), \"r\"(e)",
         "\"r\"(smem_u32(src)), \"r\"(inner), \"r\"(outer), \"r\"(e), \"l\"(policy)")],
     "wgmma_persistent"))


def make_trees(names) -> list[tuple[str, Path, str]]:
    """This tree and one edited copy of ``src/`` for each variant named."""
    trees = [("as is", ROOT / "src", "")]
    for name, edits, body in VARIANTS:
        if names and name not in names:
            continue
        src = WORK / name.replace(" ", "_") / "src"
        shutil.rmtree(src.parent, ignore_errors=True)
        shutil.copytree(ROOT / "src", src, ignore=shutil.ignore_patterns("__pycache__"))
        cu = src / "repro_torch" / "csrc" / "matmul.cu"
        code = cu.read_text()
        for text, new in edits:
            if code.count(text) != 1:
                raise SystemExit(f"matmul.cu: {text!r} not found once: update k7b_probe.py")
            code = code.replace(text, new)
        cu.write_text(code)
        trees.append((name, src, body))
    return trees


def main(names) -> None:
    trees = make_trees(names)
    builds = [subprocess.Popen([sys.executable, __file__, "build", str(src)])
              for _, src, _ in trees]
    failed = [name for (name, _, _), p in zip(trees, builds) if p.wait()]
    if "as is" in failed:
        raise SystemExit("this tree failed to build")
    trees = [t for t in trees if t[0] not in failed]
    print(f"left out, their copies failed to build: {failed or 'none'}", flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text("{}")
    for turn, order in enumerate((trees, trees[::-1])):
        for name, src, body in order:
            subprocess.run([sys.executable, __file__, "run", str(src), name, body, str(turn)],
                           check=True)
    print(OUT.read_text())


def setup(src: str):
    sys.path[:0] = [src, str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, dispatch
    build.build(["matmul"])
    return torch, cs, dispatch


def operands(torch, cs, E, C, D, F, view):
    x, w = cs.k7b_operands(torch, E, C, D, F, "bfloat16")
    if view == "fwd":
        return x, w
    dy = cs.k7b_operands(torch, E, C, F, 1, "bfloat16", seed=1)[0]
    return cs.backward_products(x, w, dy)[view]


def check(torch, cs, dispatch) -> None:
    """The persistent body against the plain version, itself and the 2-D
    entry on ``CHECKS``; every view of ``VIEWS`` forced onto it against
    the tile-per-block body, bit for bit.  Raises on the first failure."""
    from repro_torch.kernels.matmul.ops import batched_body_for
    kern, k2 = dispatch.kernel_table()["matmul_batched"], dispatch.kernel_table()["matmul"]
    for E, C, D, F in CHECKS:
        a, b = operands(torch, cs, E, C, D, F, "dW")
        body = batched_body_for(a, b)
        got, again = kern.launch(a, b), kern.launch(a, b)
        ratio = kern.tolerance(got, kern.plain(a.float(), b.float()), C)
        same = bool(torch.equal(got, again))
        experts = all(torch.equal(got[e], k2.launch(a[e], b[e])) for e in range(E))
        torch.cuda.synchronize()
        print(f"check dW E={E} C={C} D={D} F={F}: body {body}, err/limit {ratio:.3f}, same "
              f"bits twice {same}, every expert the 2-D entry's bits {experts}", flush=True)
        if not (body == "wgmma_persistent" and ratio <= 1 and same and experts):
            raise SystemExit("the persistent body failed its check")
    for label, E, C, D, F, view in VIEWS:
        a, b = operands(torch, cs, E, C, D, F, view)
        same = bool(torch.equal(kern.launch(a, b, body="wgmma_persistent"),
                                kern.launch(a, b, body="wgmma")))
        torch.cuda.synchronize()
        print(f"check {label} {view}: the persistent body gives body 2's bits {same}",
              flush=True)
        if not same:
            raise SystemExit("the persistent body's bits differ from body 2's")


def run(src: str, name: str, body: str, turn: str) -> None:
    torch, cs, dispatch = setup(src)
    card = cs.card_line()
    kern = dispatch.kernel_table()["matmul_batched"]
    timer, clean = cs.Timer(torch), cs.Timer(torch, flush="read")
    if name == "as is" and turn == "0":
        check(torch, cs, dispatch)
    rows = {}
    for label, E, C, D, F, view in VIEWS:
        if name != "as is" and (label.startswith("rule") or view != "dW" and not (
                body == "wgmma_persistent" and label in ("prefill gate/up", "train gate/up"))):
            continue
        a, b = operands(torch, cs, E, C, D, F, view)
        _, M, K = a.shape
        N = b.shape[2]
        nbytes = 2 * E * (M * K + K * N + M * N)
        r = {"bound_ms": cs.bound(nbytes, 2.0 * E * M * K * N, cs.BF16_FLOPS)[0]}
        if name == "as is":
            order = ("wgmma", "wgmma_persistent", "wgmma_persistent", "wgmma")
            for i, bd in enumerate(order):
                r[f"{bd}_ms_{i // 2}"] = timer(lambda bd=bd: kern.launch(a, b, body=bd))
            r["bmm_ms"] = timer(lambda: torch.bmm(a, b))
            if view == "dW" and label.startswith("train"):
                for tile in ("wide", "narrow"):
                    r[f"wgmma_persistent_{tile}_ms"] = timer(
                        lambda tile=tile: kern.launch(a, b, body="wgmma_persistent", tile=tile))
                for bd in ("wgmma", "wgmma_persistent"):
                    r[f"{bd}_clean_l2_ms"] = clean(lambda bd=bd: kern.launch(a, b, body=bd))
                r["bmm_clean_l2_ms"] = clean(lambda: torch.bmm(a, b))
                dw = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
                r["zero_fill_ms"] = timer(dw.zero_)
        else:
            r[f"{body}_ms"] = timer(lambda: kern.launch(a, b, body=body))
            ratio = kern.tolerance(kern.launch(a, b, body=body),
                                   kern.plain(a.float(), b.float()), K)
            r["err_limit"] = ratio
        key = f"{label} {view}: E={E} M={M} K={K} N={N}"
        rows[key] = r
        print(f"{name} ({turn}) | {key} | " + ", ".join(f"{k} {v:.4f}" for k, v in r.items())
              + f" | {card}", flush=True)
        del a, b
    data = json.loads(OUT.read_text())
    data[f"{name} ({turn})"] = {"card": card, "rows": rows}
    OUT.write_text(json.dumps(data, indent=1))


if __name__ == "__main__":
    if sys.argv[1:2] == ["build"]:
        setup(sys.argv[2])
    elif sys.argv[1:2] == ["run"]:
        run(*sys.argv[2:6])
    else:
        main(sys.argv[1:])
