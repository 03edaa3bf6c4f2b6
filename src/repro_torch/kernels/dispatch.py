"""The kernel table: name -> (CUDA kernel, plain PyTorch version, counts).

A call with CUDA tensors launches the hand-written kernel or raises; a call
with CPU tensors takes the plain version.  Nothing falls back: a kernel that
fails to build or launch raises to the caller.  A kernel writes through raw
pointers, so its output has no ``grad_fn``: a call on the card with grad on
and an input that requires grad raises, naming the differentiable wrapper
that carries the kernel's gradient (K4, K5, K6, K7) or saying it has none.  The one way to run the plain
version on the card is to ask for it explicitly with :func:`plain_versions`
(used to hold the kernels against their plain versions on the same inputs).

Each :class:`Kernel` counts what ran: ``launches`` is bumped by the kernel's
launcher exactly where the CUDA kernel is enqueued, ``plain_calls`` wherever
the plain version runs instead, so a serving run can show that its path went
through the kernels.  Every kernel has more than one body (a tensor-core
body beside the FMA one, and K1/K2 one of each for int8 pools), and counts
each launch under its body's name in ``body_launches`` too.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch


class Kernel:
    """One kernel-table entry.  ``launch`` is the CUDA launcher (it raises on
    anything the kernel does not take and bumps :attr:`launches`), ``plain``
    the plain PyTorch version with the same signature."""

    def __init__(self, name: str, launch: Callable, plain: Callable, *,
                 source: str, replaces: str, tolerance: Callable,
                 note: str = "", gradient: str = ""):
        self.name = name
        self.launch = launch
        self.plain = plain
        self.tolerance = tolerance    # (out, fp32 ref[, K]) -> largest err/limit
        self.source = source          # CUDA source, relative to the repo
        self.replaces = replaces      # the TPU kernel it replaces, file:line
        self.note = note              # what ``replaces`` cannot say (a backward)
        self.gradient = gradient      # the differentiable wrapper, if any
        # the counts are bumped from every thread that runs a model (the
        # executors of a replica fleet launch at once): a read-modify-write
        # without the lock loses increments
        self._lock = threading.Lock()
        self.launches = 0                          # guarded-by: self._lock
        self.plain_calls = 0                       # guarded-by: self._lock
        self.body_launches: dict[str, int] = {}    # guarded-by: self._lock

    def count_launch(self, body: str) -> None:
        """One launch of the CUDA kernel, by ``body``."""
        with self._lock:
            self.launches += 1
            self.body_launches[body] = self.body_launches.get(body, 0) + 1

    def __call__(self, *args, **kw):
        device = args[0].device
        if device.type == "cuda" and not _MODE.plain:
            if torch.is_grad_enabled() and any(
                    isinstance(a, torch.Tensor) and a.requires_grad
                    for a in (*args, *kw.values())):
                # the kernel writes through raw pointers: its output has no
                # grad_fn, and the gradients upstream would be lost silently
                where = (f"its gradient comes through {self.gradient}"
                         if self.gradient else "it has no backward kernel")
                raise RuntimeError(
                    f"{self.name}: an input requires grad, and {where}; call "
                    f"it under torch.no_grad() or on inputs that do not")
            return self.launch(*args, **kw)
        if device.type in ("cpu", "cuda"):
            with self._lock:
                self.plain_calls += 1
            return self.plain(*args, **kw)
        raise RuntimeError(f"{self.name}: no kernel for device {device}")

    def reset_counts(self) -> None:
        with self._lock:
            self.launches = 0
            self.plain_calls = 0
            self.body_launches = {}


class _Mode:
    plain = False


_MODE = _Mode()
_TABLE: dict[str, Kernel] = {}


def register_kernel(name: str, launch: Callable, plain: Callable, *,
                    source: str, replaces: str,
                    tolerance: Callable | None = None, note: str = "",
                    gradient: str = "") -> Kernel:
    """Register a kernel's CUDA launcher and its plain version, with the
    limit it is held to on the card (default: :func:`tolerance_ratio`, the
    attention kernels').  ``gradient`` names the differentiable wrapper
    that carries the kernel's gradient; a direct call on the card with an
    input that requires grad raises."""
    entry = Kernel(name, launch, plain, source=source, replaces=replaces,
                   tolerance=tolerance or tolerance_ratio, note=note,
                   gradient=gradient)
    _TABLE[name] = entry
    return entry


def kernel_table() -> dict[str, Kernel]:
    """Every registered kernel (importing the ops modules registers them)."""
    import repro_torch.kernels.conv2d.ops  # noqa: F401
    import repro_torch.kernels.decode_attention.ops  # noqa: F401
    import repro_torch.kernels.flash_attention.ops  # noqa: F401
    import repro_torch.kernels.matmul.ops  # noqa: F401
    import repro_torch.kernels.prefill_attention.ops  # noqa: F401
    import repro_torch.kernels.ssm_scan.ops  # noqa: F401
    return dict(_TABLE)


def reset_counts() -> None:
    for entry in kernel_table().values():
        entry.reset_counts()


@contextlib.contextmanager
def plain_versions():
    """Run every kernel's plain version, on any device, inside the block.

    The switch is process-wide: it turns every thread to the plain versions
    at once, the executors of a running replica fleet included.  So a
    comparison enters it before a fleet starts and leaves it after the
    fleet's ``stop()``, never around one call while a fleet runs."""
    prev = _MODE.plain
    _MODE.plain = True
    try:
        yield
    finally:
        _MODE.plain = prev


def check_operand(t, name: str, *, device, dtypes, shape=None,
                  align: int = 1, broadcast_dim: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` with one of
    ``dtypes``, (when given) ``shape``, and a data pointer that is a
    multiple of ``align`` bytes -- what a launcher checks before handing
    raw pointers to a kernel (the attention kernels read q and pool rows
    with 16-byte loads, so a view at an odd element offset must not reach
    them).  With ``broadcast_dim``, that one dim may instead have stride 0
    (a view made by ``expand``) over a tensor that is contiguous in the
    other dims; no other non-contiguous layout passes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{list(dtypes)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if broadcast_dim is not None and t.stride(broadcast_dim) == 0:
        if not t.select(broadcast_dim, 0).is_contiguous():
            raise ValueError(f"{name}: a stride-0 dim {broadcast_dim} needs "
                             f"the other dims contiguous")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} starts at an address that is not a "
                         f"multiple of {align} bytes")


def check_scales(k_pool, k_scale, v_scale) -> bool:
    """Whether a paged attention call reads an int8 pool: an int8 pool
    comes with both fp32 scale arrays, any other pool with neither (the
    reference tells the two apart by ``k_scale is not None`` alone, so a
    mismatch would dequantize the wrong rows or none).  Raises on a
    mismatch."""
    quant = k_pool.dtype == torch.int8
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if quant and k_scale is None:
        raise ValueError("an int8 pool needs its k_scale and v_scale")
    if not quant and k_scale is not None:
        raise ValueError(f"k_scale / v_scale are for an int8 pool, not a "
                         f"{k_pool.dtype} one")
    return quant


# Kernel vs plain version on the card (chip_smoke.py, tests/test_torch_gpu.py).
# fp32: the two sum in other orders; ~1e-6 is expected, 1e-4 allowed.
FP32_ATOL = 1e-4
# bf16: the kernel is held against the plain version evaluated in fp32 on
# the same bf16 values (the plain version at bf16 rounds the QK^T scores
# and each PV chunk to bf16 as well, which would swamp what is checked).
# The kernel rounds p to bf16 before the PV product (as the Pallas kernel
# does; <= 2^-8 relative per term, random in sign) and its output to bf16
# (<= 2^-8 |out|).  Limit per element: 2^-7 |ref| + 2^-6 * rms(ref), the
# rms over the (heads, head_dim) of that query token, so a row over 1056
# keys (|out| ~ 0.05) is held as tightly as a row over one key (|out| ~ 1).
BF16_RTOL = 2.0 ** -7
BF16_RMS_ATOL = 2.0 ** -6


def tolerance_ratio(out, ref) -> float:
    """Largest ``|out - ref| / limit`` over all elements (<= 1 passes).
    ``ref`` is the plain version in fp32; ``out`` the kernel's output of
    shape (..., H, D), fp32 (limit ``FP32_ATOL``) or bf16 (limit above)."""
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        return (err.max() / FP32_ATOL).item()
    ref = ref.float()
    rms = ref.pow(2).mean(dim=(-2, -1), keepdim=True).sqrt()
    limit = BF16_RTOL * ref.abs() + BF16_RMS_ATOL * rms
    return (err / limit.clamp(min=1e-30)).max().item()


# K3's row log-sum-exp (``decode_attention(..., return_lse=True)``), each
# of m and l against the plain version evaluated in fp32 on the same values:
# both take the scores as fp32 sums of exact products (in other orders) and
# sum p = exp(s - m) in fp32 before any rounding of p, so the two differ by
# fp32 rounding alone: a few 2^-24 of |m|, and for l the split body's fast
# exponential, whose argument rounds to ~2^-24 |s - m| (under 5e-6 of l for
# every term that does not underflow).  Limit LSE_RTOL: |dm| <= LSE_RTOL
# max(|m|, 1) and |dl| <= LSE_RTOL l, held where l > 0; where no row is live
# (l = 0) the kernel's l must be 0 and its m at most NEG_INF / 2, as the
# plain version's (a merge across shards reads them; NaN there fails).  A
# partial that loses a 64-key split or is left unrescaled moves l by O(1).
LSE_RTOL = 2.0 ** -14
LSE_DEAD_M = -1e30 / 2


def lse_tolerance_ratio(out, ref) -> float:
    """:func:`tolerance_ratio` of the output; with the row log-sum-exp
    (``out`` and ``ref`` each (out, m, l)) also m and l against
    ``LSE_RTOL`` where the plain version's l > 0, and infinity where it is
    0 and the kernel's l is not 0 or its m above ``LSE_DEAD_M``.  The
    largest (<= 1 passes; NaN fails)."""
    if not isinstance(out, tuple):
        return tolerance_ratio(out, ref)
    (o, m, l), (ro, rm, rl) = out, (r.float() for r in ref)
    ratios = [tolerance_ratio(o, ro)]
    live = rl > 0
    if live.any():
        ratios.append(((m - rm).abs() / (LSE_RTOL * rm.abs().clamp(min=1.0)))[live].max().item())
        ratios.append(((l - rl).abs() / (LSE_RTOL * rl))[live].max().item())
    dead = ~live
    if dead.any() and not (bool((l[dead] == 0).all()) and bool((m[dead] <= LSE_DEAD_M).all())):
        ratios.append(float("inf"))
    if any(r != r for r in ratios):
        return float("nan")
    return max(ratios)


# K6 conv2d, kernel vs plain version evaluated in fp32 on the same values.
# The kernel sums in fp32 and rounds once to the output type, so the
# difference is the rounding of the output (<= 2^-11 |ref| at fp16, 2^-8 at
# bf16, none at fp32) plus the fp32 sum taken in another order (std about
# 2^-24 sqrt(K / 6) rms(ref) for K = KH*KW*Cin terms: ~1e-6 rms at GoogLeNet's
# largest K = 1728).  Limit per element: CONV_RTOL |ref| + CONV_RMS_ATOL *
# rms(ref), rms over the whole output; the relative term is twice the
# rounding bound, the rms term holds outputs near zero at the fp32 floor
# (fp32: both 2^-14, ~10x above the order noise at 5 sigma).  A sum that
# loses one 16-deep chunk of K moves outputs by ~sqrt(16/K) rms(ref), 0.1
# rms or more: hundreds of limits.
CONV_RTOL = {torch.float32: 2.0 ** -14, torch.float16: 2.0 ** -10,
             torch.bfloat16: 2.0 ** -7}
CONV_RMS_ATOL = {torch.float32: 2.0 ** -14, torch.float16: 2.0 ** -12,
                 torch.bfloat16: 2.0 ** -12}


def conv_tolerance_ratio(out, ref) -> float:
    """Largest ``|out - ref| / limit`` over all elements (<= 1 passes) for
    the conv kernel's output ``out`` (fp32, fp16 or bf16) against the plain
    version in fp32 ``ref``."""
    err = (out.float() - ref.float()).abs()
    ref = ref.float()
    rms = ref.pow(2).mean().sqrt()
    limit = CONV_RTOL[out.dtype] * ref.abs() + CONV_RMS_ATOL[out.dtype] * rms
    return (err / limit.clamp(min=1e-30)).max().item()


# K5 ssm_scan, kernel vs plain version evaluated in fp32 on the same values,
# each of y and the final state: the largest |out - ref| within SSM_RTOL of
# the largest |ref| of that output.  Relative to the largest, because the
# scan's outputs scale with its inputs, decay and gate (|y| near 8 on
# Mamba-2-like operands at zamba2's widths), and the kernel's only
# difference from the plain version is its order of summation: both read
# the inputs as fp32 (bf16 values convert exactly) and return fp32, so bf16
# inputs take the fp32 limit.  On an H100 the FMA body's order moves results
# by ~3e-6 of the largest; the tensor-core body, which also splits each of
# its three fp32 operands into bf16 hi + lo (2^-18 a term), by ~6e-6 (err /
# limit 0.061 at zamba2's widths; one bf16 rounding of those operands would
# read ~20).  Dropping the state carried into a chunk moves them by 9e-4 to
# 6e-2 of the largest, and the lo half of the weighted scores by 2e-3 to
# 3e-3 (kernel_gate_check.py --card).
SSM_RTOL = 1e-4


def ssm_tolerance_ratio(out, ref) -> float:
    """``max |out - ref| / (SSM_RTOL * max |ref|)`` over each of the
    (y, final_state) pairs; the larger (<= 1 passes)."""
    return max(((o.float() - r.float()).abs().max()
                / (SSM_RTOL * r.float().abs().max().clamp(min=1e-30))).item()
               for o, r in zip(out, ref))


# K7 matmul, kernel vs plain version evaluated in fp32 on the same values.
# Both sum the K products of an output in fp32, in other orders: each order
# is a chain of roundings whose error grows like 2^-24 sqrt(K) times the
# partial sums, which are of the order of max|ref| (on an H100 the two
# differ by 1.2e-6 of max|ref| on random operands at K = 2048, against
# cuBLAS's fp32 product).  A low-precision output adds its one
# rounding, at most 2^-8 |ref| (bf16) or 2^-11 |ref| (fp16).  Limit per
# element: MATMUL_RTOL |ref| + MATMUL_K_ATOL sqrt(K) max|ref|: twice the
# rounding bound (none at fp32), and 16x the order scale (4.3e-5 of
# max|ref| at K = 2048, 1.0e-4 at K = 11008).  A sum that loses one
# 32-deep slice of K moves outputs by ~sqrt(32 / K) rms(ref): 0.02 of
# max|ref| at K = 2048, hundreds of limits.
MATMUL_RTOL = {torch.float32: 0.0, torch.float16: 2.0 ** -10,
               torch.bfloat16: 2.0 ** -7}
MATMUL_K_ATOL = 2.0 ** -20


def matmul_tolerance_ratio(out, ref, k: int) -> float:
    """Largest ``|out - ref| / limit`` over all elements (<= 1 passes) for
    the matmul kernel's output ``out`` (fp32, fp16 or bf16) against the
    plain version in fp32 ``ref``, for a product over ``k`` terms."""
    err = (out.float() - ref.float()).abs()
    ref = ref.float()
    floor = MATMUL_K_ATOL * max(k, 1) ** 0.5 * ref.abs().max()
    limit = MATMUL_RTOL[out.dtype] * ref.abs() + floor
    return (err / limit.clamp(min=1e-30)).max().item()


# The backward kernels (K4's, K5's) against their plain versions evaluated
# in fp32 on the same values, each gradient: the largest |out - ref| within
# GRAD_RTOL of the largest |ref| of that gradient (a gradient's entries
# span orders of magnitude, and what is checked is the sums, which both
# take in fp32 in other orders).  The plain versions' own fp32 rounding,
# measured against the same formulas in fp64 on the CPU at the card's
# shapes (K4 at qwen2.5-3b's and zamba2-1.2b's heads, S 512 and 333; K5
# at zamba2's widths, S 512 and 1000; tests/test_torch_backward.py), is
# 2.6e-7 to 1.4e-6 of the largest, so two right fp32 sums differ by a few
# 1e-6: the fp32 limit 2^-14 (6.1e-5) is ~20x that.  A bf16 gradient adds
# its one rounding: bf16 keeps 8 significant bits, so that rounding can
# reach 2^-8 of the largest, the whole limit 2^-8, and the margin is thin
# (K4's backward reads 0.68 to 0.78 of it on the card; modelled on the CPU
# against fp64, exact products read up to 0.79 and K4's "mma" body, P and
# dS carried as bf16 hi + lo pairs, 0.56 to 0.73, while P and dS rounded to
# bf16 alone read up to 1.16; tests/test_torch_backward.py).  A lost kv
# or q tile, chunk or state moves a gradient by a large share of its
# largest.  A gradient that is 0 in exact arithmetic (attention over one
# key: dq = dk = 0, since dP = D there) is left with the rounding of dP -
# D alone, of the scale of the
# call's other gradients: each gradient's largest is floored at
# GRAD_FLOOR of the largest gradient of the call.  K6's backward
# takes fp16 too: at GoogLeNet's shapes the plain backward's fp32 sums sit
# 1.1e-7 to 6.1e-7 of the largest from the same formulas in fp64, and its
# fp16 gradients, rounded once, 2.9e-4 to 3.7e-4 (at most 2^-11 of the
# largest; tests/test_torch_conv_backward.py): the fp16 limit 2^-10.
GRAD_RTOL = {torch.float32: 2.0 ** -14, torch.bfloat16: 2.0 ** -8,
             torch.float16: 2.0 ** -10}
GRAD_FLOOR = 2.0 ** -6


def grad_tolerance_ratio(outs, refs) -> float:
    """``max |out - ref| / (GRAD_RTOL[out.dtype] * max(max |ref|,
    GRAD_FLOOR * the call's largest |ref|))`` over each pair of gradients
    (None where the call returns none); the largest (<= 1 passes)."""
    pairs = [(o, r.float()) for o, r in zip(outs, refs) if o is not None]
    top = max(r.abs().max() for _, r in pairs)
    return max(((o.float() - r).abs().max()
                / (GRAD_RTOL[o.dtype] * torch.maximum(r.abs().max(), GRAD_FLOOR * top)
                   .clamp(min=1e-30))).item()
               for o, r in pairs)
