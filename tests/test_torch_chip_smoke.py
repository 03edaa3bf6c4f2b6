"""The pure helpers of ``chip_smoke.py`` that time a kernel's passes apart,
on the CPU (the script imports only the standard library at its top).

``pass_times`` times runs of K5's backward that stop after pass 1, 2, ..,
n (``last_pass``) with CUDA events; ``pass_deltas`` turns those
cumulative times into each pass's by differencing neighbouring runs, and
``launch_times`` prints the result.
"""
import importlib.util
from pathlib import Path

import pytest

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
