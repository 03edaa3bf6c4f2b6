"""Block GEMM: the CUDA kernel ``csrc/matmul.cu`` beside its plain version,
behind one wrapper with the reference's signature (counterpart of
``repro/kernels/matmul/ops.py``).

The kernel takes any M, N and K and strided operands: each operand needs a
unit stride in one of its two dims, so a transposed view (``w.T``) reaches
the kernel as it is.  The plain version multiplies in fp32 and rounds
once, as the kernel does."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import matmul_tolerance_ratio, register_kernel
from repro_torch.kernels.matmul.ref import matmul_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
NARROW_M = 16          # at most this many rows: the 16 x 32 tile (decode)
_INT_MAX = 2**31 - 1


def operand_strides(t: torch.Tensor, name: str, *, device, dtypes) -> tuple[int, int]:
    """Raise unless ``t`` is a 2-D tensor on ``device`` with one of
    ``dtypes`` and a unit stride in one of its dims (a row-major matrix or
    a transposed view of one); return its two strides in elements, a
    size-1 dim's stride read as 1 (its one index is 0).  What the K7
    launcher checks before handing raw pointers and strides to the kernel:
    unlike :func:`~repro_torch.kernels.dispatch.check_operand`, a view that
    is not contiguous passes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {list(dtypes)}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, not of shape {tuple(t.shape)}")
    strides = tuple(1 if n == 1 else s for n, s in zip(t.shape, t.stride()))
    if 1 not in strides:
        raise ValueError(f"{name} has strides {t.stride()}: one dim needs a unit stride")
    if max(strides) > _INT_MAX:
        raise ValueError(f"{name}: the kernel takes strides below 2**31")
    return strides


def _launch(x, y, *, tile: str | None = None):
    """Check the operands, allocate the output and launch the kernel on the
    current stream.  ``tile`` forces ``"wide"`` (128 x 128) or ``"narrow"``
    (16 x 32); by default M <= ``NARROW_M`` takes the narrow one."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    sxm, sxk = operand_strides(x, "x", device=dev, dtypes=tuple(_DTYPE_CODE))
    syk, syn = operand_strides(y, "y", device=dev, dtypes=(x.dtype,))
    M, K = x.shape
    K2, N = y.shape
    if K != K2:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} do not chain")
    if not (0 < M <= _INT_MAX and 0 < N <= _INT_MAX and K <= _INT_MAX):
        raise ValueError(f"the kernel takes 0 < M, N and K < 2**31, not "
                         f"M={M} N={N} K={K}")
    if tile not in (None, "wide", "narrow"):
        raise ValueError(f"tile {tile!r}: 'wide', 'narrow' or None")
    narrow = M <= NARROW_M if tile is None else tile == "narrow"
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    lib = build.load("matmul", _ARGTYPES)
    KERNEL.launches += 1
    err = lib.matmul(x.data_ptr(), y.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
                     M, N, K, sxm, sxk, syk, syn, int(narrow),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"matmul: CUDA error {err}")
    return out


KERNEL = register_kernel(
    "matmul", _launch, matmul_ref,
    source="src/repro_torch/csrc/matmul.cu",
    replaces="src/repro/kernels/matmul/kernel.py:36",
    tolerance=matmul_tolerance_ratio)


def matmul(x, y):
    """x: (M, K) @ y: (K, N) -> (M, N) in x's type, summed in fp32 and
    rounded once.  CUDA tensors run the kernel, CPU tensors the plain
    version."""
    return KERNEL(x, y)
