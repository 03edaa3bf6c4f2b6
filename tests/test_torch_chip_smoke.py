"""The pure helpers of ``chip_smoke.py`` that time a kernel's passes apart,
on the CPU (the script imports only the standard library at its top).

``pass_times`` times runs of K5's backward that stop after pass 1, 2, ..,
n (``last_pass``) with CUDA events; ``pass_deltas`` turns those
cumulative times into each pass's by differencing neighbouring runs, and
``launch_times`` prints the result.

``attention_backward_work`` counts the causal half of a square, and every
one of the S x S_kv pairs non-causal (the bounds of phase 29a's whisper
shapes); ``whisper_train_counts`` and ``vlm_train_counts``, which phases
29 and 30 hold the card's launches to, equal the plain calls of one smoke
microbatch's train step on the CPU.  Each of the card scripts defines a
top-level name once: a second ``def`` of a name would replace the first
phase's function for every caller.

Phase 31's helpers: ``shard_lengths`` (K3's lengths among one slice of a
cache) and ``lse_parts`` (K3's per-shard results as ``merge_lse``'s
partials) carry out phase 31b's split-and-merge here with K3's plain
version, which must equal one call over the whole cache; ``lse_work``
counts what a call with the log-sum-exp moves and does.
"""
import ast
import collections
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import dispatch
from repro_torch.models.registry import fns_for
from repro_torch.optim.optimizers import adamw, constant
from repro_torch.training.train_step import make_train_step

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

PASSES = ("sums", "pass", "rows", "cols", "finish")


@pytest.mark.parametrize("rows,want", [
    ([], {}),
    ([(1, 0.25)], {"sums": 0.25}),
    ([(3, 1.0), (1, 0.25), (2, 0.5)], {"sums": 0.25, "pass": 0.25, "rows": 0.5}),
    ([(1, 0.25), (2, 0.5), (3, 1.0), (4, 1.75), (5, 1.875)],
     {"sums": 0.25, "pass": 0.25, "rows": 0.5, "cols": 0.75, "finish": 0.125}),
], ids=["empty", "one_pass", "out_of_order", "full"])
def test_pass_deltas_difference_cumulative_times(rows, want):
    got = chip_smoke.pass_deltas(rows, PASSES)
    assert list(got) == list(want)
    for name, ms in want.items():
        assert got[name] == pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("rows", [[(2, 0.5)], [(1, 0.2), (3, 0.9)],
                                  [(n, float(n)) for n in range(1, 7)]],
                         ids=["no_first", "gap", "too_many"])
def test_pass_deltas_refuses_a_gap_in_the_passes(rows):
    with pytest.raises(ValueError, match="stopped after passes"):
        chip_smoke.pass_deltas(rows, PASSES)


@pytest.mark.parametrize("t,want", [
    ({}, "none"),
    ({"rows": 0.2}, "rows 0.2000ms; sum 0.2000ms"),
    ({"cols": 0.25, "rows": 0.125},
     "cols 0.2500ms, rows 0.1250ms; sum 0.3750ms"),
], ids=["empty", "partial", "full"])
def test_launch_times_prints_what_was_recorded(t, want):
    assert chip_smoke.launch_times(t) == want


@pytest.mark.parametrize("S,S_kv,H,K,D,nbytes,flops,bound_ms", [
    (512, None, 16, 2, 128, 9_469_952, 2_689_597_440, 0.0028),      # qwen2.5-3b, causal
    (1500, 1500, 16, 16, 64, 24_672_000, 23_040_000_000, 0.0233),   # whisper's encoder
    (448, 1500, 16, 16, 64, 15_986_688, 6_881_280_000, 0.0070),     # its cross-attention
], ids=["causal", "encoder", "cross"])
def test_attention_backward_work(S, S_kv, H, K, D, nbytes, flops, bound_ms):
    b, f, fma = chip_smoke.attention_backward_work(1, S, H, K, D, 2, S_kv=S_kv)
    assert (b, f, fma) == (nbytes, flops, flops // 10 * 14)
    ms, by = chip_smoke.bound(b, f, chip_smoke.BF16_FLOPS)
    assert round(ms, 4) == bound_ms and by == ("bytes" if S_kv is None else "operations")


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-72b"])
def test_train_counts_are_a_microbatchs_plain_calls(arch):
    torch.set_num_threads(1)
    cfg = TR.smoke(arch).replace(compute_dtype="float32")
    assert cfg.remat == "full"
    counts = (chip_smoke.whisper_train_counts if cfg.encdec else chip_smoke.vlm_train_counts)
    params = fns_for(cfg).init(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, adamw(constant(1e-3)), accum=2)
    dispatch.reset_counts()
    step(params, adamw(constant(1e-3)).init(params), next(SyntheticTokens(cfg, 2, 8)))
    table = dispatch.kernel_table()
    want = counts(cfg, 2)
    assert {n: table[n].plain_calls for n in want} == {n: sum(c.values())
                                                       for n, c in want.items()}
    assert want["matmul"] == {"fma": want["matmul"]["fma"]}
    bf16 = counts(cfg.replace(compute_dtype="bfloat16"), 2)
    assert bf16["matmul"]["fma"] == 6 and sum(bf16["matmul"].values()) == sum(
        want["matmul"].values())
    assert set(bf16["flash_attention"]) == {"mma"}


@pytest.mark.parametrize("lengths,offset,s_loc,want", [
    ((1033, 700, 0, 1056, 1200, 5), 0, 528, [528, 528, 0, 528, 528, 5]),
    ((1033, 700, 0, 1056, 1200, 5), 528, 528, [505, 172, 0, 528, 528, 0]),
    ((132, 0, 200, 57), 132, 132, [0, 0, 68, 0]),
    ((-3, 7), 4, 4, [0, 3]),
], ids=["first", "last", "third_of_eight", "negative"])
def test_shard_lengths(lengths, offset, s_loc, want):
    assert chip_smoke.shard_lengths(lengths, offset, s_loc) == want


@pytest.mark.parametrize("M", [2, 4, 8])
def test_split_and_merge_helpers_equal_one_call(M):
    """Phase 31b on the CPU with K3's plain version: the slices' results
    through ``lse_parts`` and ``merge_lse`` equal one call (fp32, 1e-6), and
    the lengths stay K3's (rows below the length, past S all)."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers.attention import merge_lse
    g = torch.Generator().manual_seed(0)
    S, lengths = 96, (95, 40, 0, 96, 130, 5)
    q = torch.randn((len(lengths), 16, 32), generator=g)
    k, v = (torch.randn((len(lengths), S, 2, 32), generator=g) for _ in range(2))
    s_loc = S // M
    parts = [decode_attention_ref(q, k[:, r * s_loc:(r + 1) * s_loc],
                                  v[:, r * s_loc:(r + 1) * s_loc],
                                  torch.tensor(chip_smoke.shard_lengths(lengths, r * s_loc,
                                                                        s_loc)),
                                  chunk=16, return_lse=True) for r in range(M)]
    merged = merge_lse(chip_smoke.lse_parts(torch, parts))
    assert merged.shape == (len(lengths), 1, 16, 32)
    want = decode_attention_ref(q, k, v, torch.tensor(lengths), chunk=16)
    assert torch.isfinite(merged).all()
    assert (merged[:, 0] - want).abs().max() <= 1e-6


def test_lse_work():
    nbytes, flops = chip_smoke.lse_work((1033, 700, 0, 1056, 1200), 1056, 16, 2, 128, 2)
    rows = 1033 + 700 + 1056 + 1056
    assert nbytes == 2 * (2 * 5 * 16 * 128 + 2 * rows * 2 * 128) + 4 * 5 + 8 * 5 * 16
    assert flops == 4 * 16 * 128 * rows


@pytest.mark.parametrize("script", ["chip_smoke.py", "kernel_gate_check.py"])
def test_card_scripts_define_each_name_once(script):
    tree = ast.parse((Path(__file__).resolve().parent.parent / script).read_text())
    names = collections.Counter(
        node.name for node in tree.body
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)))
    assert not [n for n, c in names.items() if c > 1]
