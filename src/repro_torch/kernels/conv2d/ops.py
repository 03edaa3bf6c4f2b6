"""SAME 2-D convolution: the CUDA kernel ``csrc/conv2d.cu`` beside its
plain version, behind one wrapper with the reference's signature
(counterpart of ``repro/kernels/conv2d/ops.py``).

The kernel has two bodies, and :func:`body_for` picks one before the
launch from the type, Cout and alignment alone: ``"mma"`` (the tensor
cores) for fp16 / bf16 with Cout a multiple of 8 and w 16-byte aligned --
every GoogLeNet conv, ``stem1``'s 3-channel pixels gathered element by
element -- ``"fma"`` for everything else, every fp32 call among them.
:func:`conv_tile` picks the mma body's tile from M and N, and
:func:`conv_splits` cuts K into slices where the output tiles are fewer
than the card's SMs (split-K: each slice's fp32 partial goes to scratch,
and a second launch of the same call sums them in slice order).

Its backward, the CUDA kernel ``csrc/conv2d_backward.cu`` beside its
plain version, has one body, FMA, launched per pass: ``"dgrad"`` (dx)
and ``"wgrad"`` (dw, and db from the same dy tiles), each with split-K by
the same rule.  :func:`conv2d` is differentiable: a call whose inputs
require grad goes through :class:`_Conv2d`; every other call -- the
serving and offload paths -- launches the forward as it is."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv2d.ref import conv2d_backward_ref, conv2d_ref
from repro_torch.kernels.dispatch import (check_operand, conv_tolerance_ratio,
                                          grad_tolerance_ratio, register_kernel)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
SMS = 132                     # the H100's SMs: one block each fills the card
MMA_BK, FMA_BK = 64, 32       # K depth of one chunk, by body
BWD_TILE, BWD_BK = 64, 32     # the backward's output tile (both passes) and chunk
MIN_SLICE_CHUNKS = 2          # chunks each K slice keeps at the least


def body_for(x: torch.Tensor, w: torch.Tensor) -> str:
    """The body a call runs, decided before the launch from the type, Cout
    and w's alignment alone: ``"mma"`` for fp16 / bf16 where Cout is a
    multiple of 8 and w starts 16-byte aligned (a 16-byte piece of w lies
    inside a row), ``"fma"`` for the rest.  Either body reads x in 16-byte
    pieces where Cin is a multiple of the piece and x is aligned
    (:func:`x_in_pieces`), else element by element."""
    if (x.dtype in (torch.float16, torch.bfloat16) and w.shape[3] % 8 == 0
            and w.data_ptr() % 16 == 0):
        return "mma"
    return "fma"


def x_in_pieces(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the kernel reads x in 16-byte pieces: Cin a multiple of the
    piece's elements (a piece then lies inside one tap) and x 16-byte
    aligned."""
    return w.shape[2] % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0


def conv_tile(body: str, M: int, N: int) -> tuple[int, int]:
    """(rows, columns) of a block's output tile: the mma body takes 128 x 64
    where that still gives every SM a tile, else 64 x 64; the FMA body
    always 64 x 64."""
    if body == "mma" and -(-M // 128) * -(-N // 64) >= SMS:
        return 128, 64
    return 64, 64


def conv_splits(M: int, N: int, K: int, bm: int, bn: int, bk: int) -> int:
    """Slices of K (1: no split), from the tile count and K alone: where the
    cdiv(M, bm) x cdiv(N, bn) output tiles are fewer than the SMs, enough
    slices to give each SM a block, as long as each keeps at least
    ``MIN_SLICE_CHUNKS`` of the cdiv(K, bk) chunks (the kernel deals slice
    z the chunks z * nk // splits up to (z + 1) * nk // splits)."""
    tiles = -(-M // bm) * -(-N // bn)
    if tiles >= SMS:
        return 1
    return max(1, min(-(-SMS // tiles), -(-K // bk) // MIN_SLICE_CHUNKS))


def _launch(x, w, b, *, stride: int = 1, body=None):
    """Check the operands, allocate the output (and, where K is split, the
    fp32 scratch of the partials) and launch the kernel on the current
    stream, on the body :func:`body_for` names; ``body`` overrides that
    route, to time one body against the other on the same inputs."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin) and w (KH, KW, Cin, Cout), "
                         f"not {tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    check_operand(x, "x", device=dev, dtypes=tuple(_DTYPE_CODE))
    check_operand(w, "w", device=dev, dtypes=(x.dtype,), shape=(KH, KW, Cin, Cout))
    check_operand(b, "b", device=dev, dtypes=(torch.float32, x.dtype), shape=(Cout,))
    if stride < 1:
        raise ValueError(f"stride {stride} must be at least 1")
    hout, wout = -(-H // stride), -(-W // stride)
    M, K = B * hout * wout, KH * KW * Cin
    if M >= 2**31 or K >= 2**31:
        raise ValueError("the kernel indexes output pixels and K with int32")
    route = body_for(x, w)
    body = body or route
    if body not in ("mma", "fma") or (body == "mma" and route != "mma"):
        raise ValueError(f"conv2d: no {body!r} body for {x.dtype} at Cin {Cin}, "
                         f"Cout {Cout}")
    bm, bn = conv_tile(body, M, Cout)
    splits = conv_splits(M, Cout, K, bm, bn, MMA_BK if body == "mma" else FMA_BK)
    a_vec = x_in_pieces(x, w)
    b_vec = Cout % (16 // x.element_size()) == 0 and w.data_ptr() % 16 == 0
    out = torch.empty((B, hout, wout, Cout), dtype=x.dtype, device=dev)
    scratch = (torch.empty(splits * M * Cout, dtype=torch.float32, device=dev)
               if splits > 1 else None)
    lib = build.load("conv2d", _ARGTYPES)
    KERNEL.count_launch(body)
    err = lib.conv2d(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        _DTYPE_CODE[x.dtype], int(b.dtype == torch.float32), int(body == "mma"),
        int(a_vec), int(b_vec), bm, splits, B, H, W, Cin, KH, KW, Cout, stride,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"conv2d: CUDA error {err}")
    return out


KERNEL = register_kernel(
    "conv2d", _launch, conv2d_ref,
    source="src/repro_torch/csrc/conv2d.cu",
    replaces="src/repro/kernels/conv2d/kernel.py:43",
    tolerance=conv_tolerance_ratio,
    gradient="repro_torch.kernels.conv2d.ops.conv2d")


def backward_splits(x_shape, w_shape, stride: int) -> tuple[int, int]:
    """(dgrad's, wgrad's) K slices, by :func:`conv_splits` on each pass's
    GEMM: dgrad M = B*H*W, N = Cin, K = KH*KW*Cout; wgrad M = KH*KW*Cin,
    N = Cout, K = B*Hout*Wout."""
    B, H, W, Cin = x_shape
    KH, KW, _, Cout = w_shape
    pixels = B * -(-H // stride) * -(-W // stride)
    t, bk = BWD_TILE, BWD_BK
    return (conv_splits(B * H * W, Cin, KH * KW * Cout, t, t, bk),
            conv_splits(KH * KW * Cin, Cout, pixels, t, t, bk))


def _launch_backward(x, w, b, dy, *, stride: int = 1, need_dx: bool = True):
    """Check the operands, allocate dx (with ``need_dx``), dw, db and the
    fp32 scratch of the split passes' partials, and launch the backward on
    the current stream: dgrad (with ``need_dx``) then wgrad, each counted
    under its pass's name."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin) and w (KH, KW, Cin, Cout), "
                         f"not {tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    if stride < 1:
        raise ValueError(f"stride {stride} must be at least 1")
    hout, wout = -(-H // stride), -(-W // stride)
    check_operand(x, "x", device=dev, dtypes=tuple(_DTYPE_CODE))
    check_operand(w, "w", device=dev, dtypes=(x.dtype,), shape=(KH, KW, Cin, Cout))
    check_operand(b, "b", device=dev, dtypes=(torch.float32, x.dtype), shape=(Cout,))
    check_operand(dy, "dy", device=dev, dtypes=(x.dtype,), shape=(B, hout, wout, Cout))
    if max(B * H * W * Cin, B * hout * wout * Cout, KH * KW * Cin * Cout) >= 2**31:
        raise ValueError("the kernel indexes pixels and K with int32")
    dx_splits, dw_splits = backward_splits(x.shape, w.shape, stride)
    dx = torch.empty_like(x) if need_dx else None
    dw, db = torch.empty_like(w), torch.empty_like(b)
    dx_part = (torch.empty(dx_splits * B * H * W * Cin, dtype=torch.float32, device=dev)
               if need_dx and dx_splits > 1 else None)
    dw_part = (torch.empty(dw_splits * (KH * KW * Cin + 1) * Cout, dtype=torch.float32,
                           device=dev) if dw_splits > 1 else None)
    lib = build.load("conv2d_backward", _BWD_ARGTYPES)
    if need_dx:
        BACKWARD.count_launch("dgrad")
    BACKWARD.count_launch("wgrad")
    err = lib.conv2d_backward(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), None if dx is None else dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), None if dx_part is None else dx_part.data_ptr(),
        None if dw_part is None else dw_part.data_ptr(), _DTYPE_CODE[x.dtype],
        int(b.dtype == torch.float32), dx_splits, dw_splits, B, H, W, Cin, KH, KW, Cout,
        stride, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"conv2d_backward: CUDA error {err}")
    return dx, dw, db


BACKWARD = register_kernel(
    "conv2d_backward", _launch_backward, conv2d_backward_ref,
    source="src/repro_torch/csrc/conv2d_backward.cu",
    replaces="src/repro/kernels/conv2d/kernel.py:43",
    note="backward, no Pallas counterpart: the reference differentiates "
         "lax.conv_general_dilated, src/repro/models/layers/conv.py:30",
    tolerance=grad_tolerance_ratio)


class _Conv2d(torch.autograd.Function):
    """K6 with its gradient: the forward is :data:`KERNEL`, the backward
    :data:`BACKWARD` (the kernels on the card, their plain versions on the
    CPU), dgrad only where x needs a gradient."""

    @staticmethod
    def forward(ctx, x, w, b, stride):
        ctx.save_for_backward(x, w, b)
        ctx.stride = stride
        return KERNEL(x, w, b, stride=stride)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dx, dw, db = BACKWARD(x, w, b, dy.contiguous(), stride=ctx.stride,
                              need_dx=ctx.needs_input_grad[0])
        return dx, dw, db, None


def conv2d(x, w, b, *, stride: int = 1):
    """SAME conv.  x: (B, H, W, Cin) NHWC; w: (KH, KW, Cin, Cout) HWIO in
    x's type; b: (Cout,) fp32 or x's type.  Returns (B, ceil(H/stride),
    ceil(W/stride), Cout) in x's type, summed in fp32 with the bias added
    before the one rounding.  CUDA tensors run the kernel, CPU tensors the
    plain version.  Differentiable: where grad is on and an input requires
    it, through :class:`_Conv2d`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return _Conv2d.apply(x, w, b, stride)
    return KERNEL(x, w, b, stride=stride)
