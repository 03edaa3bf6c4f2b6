"""The pure helpers of ``chip_smoke.py`` that read a profile, on the CPU
(the script imports only the standard library at its top).

``per_launch`` sums ``device_rows``' rows by kernel name and
``launch_times`` prints the result.  Late in the whole script the profiler
may record some or none of a kernel's launches: a kernel with no row is
left out (never counted as zero ms), and a result with none prints "not
measured".
"""
import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

# device_rows' rows: (device ms, calls, name), the largest first
ROWS = [(4.0, 10, "void (anonymous namespace)::ssm_bwd_cols_kernel<float, 64>(...)"),
        (2.0, 10, "void (anonymous namespace)::ssm_bwd_rows_kernel<float>(...)"),
        (1.0, 5, "void (anonymous namespace)::ssm_bwd_cols_kernel<float, 32>(...)"),
        (0.5, 3, "void at::native::vectorized_elementwise_kernel<4, ...>(...)")]


@pytest.mark.parametrize("rows,want", [
    ([], {}),
    (ROWS[1:2], {"ssm_bwd_rows_kernel": (0.2, 10)}),
    (ROWS, {"ssm_bwd_cols_kernel": (5.0 / 15, 15), "ssm_bwd_rows_kernel": (0.2, 10)}),
], ids=["empty", "partial", "full"])
def test_per_launch_sums_by_name_and_leaves_out_the_unrecorded(rows, want):
    got = chip_smoke.per_launch(rows, "ssm_bwd_")
    assert set(got) == set(want)
    for name, (ms, n) in want.items():
        assert got[name][1] == n and got[name][0] == pytest.approx(ms, rel=1e-12)


def test_per_launch_skips_a_row_of_no_launches():
    assert chip_smoke.per_launch([(0.0, 0, "ssm_bwd_state_kernel")], "ssm_bwd_") == {}


@pytest.mark.parametrize("t,want", [
    ({}, "not measured (the profiler recorded none of the launches)"),
    ({"ssm_bwd_rows_kernel": (0.2, 10)}, "ssm_bwd_rows_kernel 0.2000ms (10); sum 0.2000ms"),
    ({"ssm_bwd_cols_kernel": (0.25, 8), "ssm_bwd_rows_kernel": (0.125, 2)},
     "ssm_bwd_cols_kernel 0.2500ms (8), ssm_bwd_rows_kernel 0.1250ms (2); sum 0.3750ms"),
], ids=["empty", "partial", "full"])
def test_launch_times_prints_what_was_recorded(t, want):
    assert chip_smoke.launch_times(t) == want
