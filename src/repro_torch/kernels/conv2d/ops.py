"""SAME 2-D convolution: the CUDA kernel ``csrc/conv2d.cu`` beside its
plain version, behind one wrapper with the reference's signature
(counterpart of ``repro/kernels/conv2d/ops.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv2d.ref import conv2d_ref
from repro_torch.kernels.dispatch import (check_operand, conv_tolerance_ratio,
                                          register_kernel)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_WIDE = 16        # Cin a multiple of this: rows of x staged with 16-byte loads


def _launch(x, w, b, *, stride: int = 1):
    """Check the operands, allocate the output and launch the kernel on the
    current stream."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin) and w (KH, KW, Cin, Cout), "
                         f"not {tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    wide = Cin % _WIDE == 0
    check_operand(x, "x", device=dev, dtypes=tuple(_DTYPE_CODE),
                  align=16 if wide else 1)
    check_operand(w, "w", device=dev, dtypes=(x.dtype,), shape=(KH, KW, Cin, Cout))
    check_operand(b, "b", device=dev, dtypes=(torch.float32, x.dtype), shape=(Cout,))
    if stride < 1:
        raise ValueError(f"stride {stride} must be at least 1")
    hout, wout = -(-H // stride), -(-W // stride)
    if B * hout * wout >= 2**31 or KH * KW * Cin >= 2**31:
        raise ValueError("the kernel indexes output pixels and K with int32")
    out = torch.empty((B, hout, wout, Cout), dtype=x.dtype, device=dev)
    lib = build.load("conv2d", _ARGTYPES)
    KERNEL.launches += 1
    err = lib.conv2d(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[x.dtype], int(b.dtype == torch.float32), int(wide),
        B, H, W, Cin, KH, KW, Cout, stride,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"conv2d: CUDA error {err}")
    return out


KERNEL = register_kernel(
    "conv2d", _launch, conv2d_ref,
    source="src/repro_torch/csrc/conv2d.cu",
    replaces="src/repro/kernels/conv2d/kernel.py:43",
    tolerance=conv_tolerance_ratio)


def conv2d(x, w, b, *, stride: int = 1):
    """SAME conv.  x: (B, H, W, Cin) NHWC; w: (KH, KW, Cin, Cout) HWIO in
    x's type; b: (Cout,) fp32 or x's type.  Returns (B, ceil(H/stride),
    ceil(W/stride), Cout) in x's type, summed in fp32 with the bias added
    before the one rounding.  CUDA tensors run the kernel, CPU tensors the
    plain version."""
    return KERNEL(x, w, b, stride=stride)
