"""Plain PyTorch version of the SAME 2-D convolution (counterpart of
``repro/kernels/conv2d/ref.py``, with the arithmetic of the Pallas body
``repro/kernels/conv2d/kernel.py:22-39``): pad the map as SAME does (the
odd pixel after), then sum the KH x KW shifted ``(Hout*Wout, Cin) @ (Cin,
Cout)`` products in fp32, add the bias in fp32 and round once to
``x.dtype``."""
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


def conv2d_ref(x, w, b, *, stride: int = 1):
    """x: (B, H, W, Cin) NHWC; w: (KH, KW, Cin, Cout) HWIO; b: (Cout,).
    Returns (B, ceil(H/stride), ceil(W/stride), Cout) in ``x.dtype``."""
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    hout, wout = -(-H // stride), -(-W // stride)
    (pt, pb), (pl, pr) = same_padding(H, KH, stride), same_padding(W, KW, stride)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))        # (B, Hp, Wp, Cin)
    wf = w.float()
    acc = torch.zeros((B, hout * wout, Cout), dtype=torch.float32,
                      device=x.device)
    for i in range(KH):
        for j in range(KW):
            xs = xp[:, i:i + (hout - 1) * stride + 1:stride,
                    j:j + (wout - 1) * stride + 1:stride, :]
            acc += xs.reshape(B, hout * wout, Cin) @ wf[i, j]
    acc += b.float()
    return acc.reshape(B, hout, wout, Cout).to(x.dtype)
