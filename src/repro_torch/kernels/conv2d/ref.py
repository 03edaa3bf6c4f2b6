"""Plain PyTorch version of the SAME 2-D convolution (counterpart of
``repro/kernels/conv2d/ref.py``, with the arithmetic of the Pallas body
``repro/kernels/conv2d/kernel.py:22-39``): pad the map as SAME does (the
odd pixel after), then sum the KH x KW shifted ``(Hout*Wout, Cin) @ (Cin,
Cout)`` products in fp32, add the bias in fp32 and round once to
``x.dtype``.  Beside it, the plain version of the hand-written backward
(``csrc/conv2d_backward.cu``), written out as the same tap loop."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def same_padding(size: int, window: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of one spatial axis for a SAME window:
    ``total // 2`` before and the rest after, as XLA and the Pallas kernel
    pad."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _wide(t):
    """t in fp32, or as it is when wider (fp64: to measure fp32's rounding)."""
    return t if t.dtype == torch.float64 else t.float()


def conv2d_ref(x, w, b, *, stride: int = 1):
    """x: (B, H, W, Cin) NHWC; w: (KH, KW, Cin, Cout) HWIO; b: (Cout,).
    Returns (B, ceil(H/stride), ceil(W/stride), Cout) in ``x.dtype``,
    summed in fp32 (fp64 for fp64 inputs)."""
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    hout, wout = -(-H // stride), -(-W // stride)
    (pt, pb), (pl, pr) = same_padding(H, KH, stride), same_padding(W, KW, stride)
    xp = F.pad(_wide(x), (0, 0, pl, pr, pt, pb))         # (B, Hp, Wp, Cin)
    wf = _wide(w)
    acc = torch.zeros((B, hout * wout, Cout), dtype=xp.dtype, device=x.device)
    for i in range(KH):
        for j in range(KW):
            xs = xp[:, i:i + (hout - 1) * stride + 1:stride,
                    j:j + (wout - 1) * stride + 1:stride, :]
            acc += xs.reshape(B, hout * wout, Cin) @ wf[i, j]
    acc += _wide(b)
    return acc.reshape(B, hout, wout, Cout).to(x.dtype)


def conv2d_backward_ref(x, w, b, dy, *, stride: int = 1, need_dx: bool = True):
    """Gradients of :func:`conv2d_ref` for the output gradient ``dy`` (B,
    Hout, Wout, Cout), as explicit formulas over the KH x KW taps (not
    autograd of the forward): tap (i, j) reads the padded map at the
    strided slice ``xs`` the forward reads, and adds ``xs^T dy`` to
    ``dw[i, j]`` and ``dy w[i, j]^T`` into that slice of the padded ``dx``,
    whose SAME border is then cut off; ``db`` is ``dy`` summed over every
    pixel.  Every sum in fp32 (fp64 for fp64 inputs); returns (dx or None
    without ``need_dx``, dw, db) in the types of x, w and b."""
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    hout, wout = dy.shape[1], dy.shape[2]
    (pt, pb), (pl, pr) = same_padding(H, KH, stride), same_padding(W, KW, stride)
    xp = F.pad(_wide(x), (0, 0, pl, pr, pt, pb))           # (B, Hp, Wp, Cin)
    wf = _wide(w)
    g = _wide(dy).reshape(B * hout * wout, Cout)
    dxp = torch.zeros_like(xp) if need_dx else None
    dw = torch.zeros(w.shape, dtype=g.dtype, device=x.device)
    for i in range(KH):
        for j in range(KW):
            rows = slice(i, i + (hout - 1) * stride + 1, stride)
            cols = slice(j, j + (wout - 1) * stride + 1, stride)
            dw[i, j] = xp[:, rows, cols, :].reshape(-1, Cin).T @ g
            if need_dx:
                dxp[:, rows, cols, :] += (g @ wf[i, j].T).reshape(B, hout, wout, Cin)
    dx = dxp[:, pt:pt + H, pl:pl + W, :].to(x.dtype) if need_dx else None
    return dx, dw.to(w.dtype), g.sum(0).to(b.dtype)
