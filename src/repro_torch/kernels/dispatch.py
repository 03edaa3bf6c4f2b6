"""The kernel table: name -> (CUDA kernel, plain PyTorch version, counts).

A call with CUDA tensors launches the hand-written kernel or raises; a call
with CPU tensors takes the plain version.  Nothing falls back: a kernel that
fails to build or launch raises to the caller.  The one way to run the plain
version on the card is to ask for it explicitly with :func:`plain_versions`
(used to hold the kernels against their plain versions on the same inputs).

Each :class:`Kernel` counts what ran: ``launches`` is bumped by the kernel's
launcher exactly where the CUDA kernel is enqueued, ``plain_calls`` wherever
the plain version runs instead, so a serving run can show that its path went
through the kernels.  A kernel with more than one body (all but K5: a
tensor-core body beside the FMA one) also counts each launch under its
body's name in ``body_launches``.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch


class Kernel:
    """One kernel-table entry.  ``launch`` is the CUDA launcher (it raises on
    anything the kernel does not take and bumps :attr:`launches`), ``plain``
    the plain PyTorch version with the same signature."""

    def __init__(self, name: str, launch: Callable, plain: Callable, *,
                 source: str, replaces: str, tolerance: Callable):
        self.name = name
        self.launch = launch
        self.plain = plain
        self.tolerance = tolerance    # (out, fp32 ref[, K]) -> largest err/limit
        self.source = source          # CUDA source, relative to the repo
        self.replaces = replaces      # the TPU kernel it replaces, file:line
        self.launches = 0
        self.plain_calls = 0
        self.body_launches: dict[str, int] = {}

    def count_launch(self, body: str) -> None:
        """One launch of the CUDA kernel, by ``body``."""
        self.launches += 1
        self.body_launches[body] = self.body_launches.get(body, 0) + 1

    def __call__(self, *args, **kw):
        device = args[0].device
        if device.type == "cuda" and not _MODE.plain:
            return self.launch(*args, **kw)
        if device.type in ("cpu", "cuda"):
            self.plain_calls += 1
            return self.plain(*args, **kw)
        raise RuntimeError(f"{self.name}: no kernel for device {device}")

    def reset_counts(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.body_launches = {}


class _Mode:
    plain = False


_MODE = _Mode()
_TABLE: dict[str, Kernel] = {}


def register_kernel(name: str, launch: Callable, plain: Callable, *,
                    source: str, replaces: str,
                    tolerance: Callable | None = None) -> Kernel:
    """Register a kernel's CUDA launcher and its plain version, with the
    limit it is held to on the card (default: :func:`tolerance_ratio`, the
    attention kernels')."""
    entry = Kernel(name, launch, plain, source=source, replaces=replaces,
                   tolerance=tolerance or tolerance_ratio)
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
    """Run every kernel's plain version, on any device, inside the block."""
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
# inputs take the fp32 limit.  On an H100 that order moves results by ~3e-6
# of the largest; dropping the state carried into a chunk moves them by
# 1e-3 to 5e-2 of it (kernel_gate_check.py --card).
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
