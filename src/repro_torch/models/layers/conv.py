"""2-D conv layers for the paper's own model (GoogLeNet / Inception-v1)
(counterpart of ``repro/models/layers/conv.py``).

NHWC layout and HWIO kernels at every public function, as in the
reference.  Every convolution goes through the conv2d kernel
(:mod:`repro_torch.kernels.conv2d.ops`), and in training through its
backward kernel; pooling and LRN are plain PyTorch, differentiated by
autograd, as the reference computes them outside any Pallas kernel and
XLA differentiates them.  SAME pooling
pads explicitly (``-inf`` for max, 0 for average) with the odd pixel after,
because ``F.max_pool2d`` pads symmetrically.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import truncated_normal_init
from repro_torch.kernels.conv2d.ops import conv2d as conv2d_op
from repro_torch.kernels.conv2d.ref import same_padding
from repro_torch.models.layers.module import ParamDef, bias


def conv_table(kh: int, kw: int, cin: int, cout: int):
    def init(gen, shape, dtype):
        fan_in = kh * kw * cin
        return truncated_normal_init(gen, shape, dtype,
                                     stddev=(2.0 / fan_in) ** 0.5)
    return {
        "w": ParamDef((kh, kw, cin, cout), ("conv", "conv", None, "ff"), init),
        "b": bias((cout,), ("ff",)),
    }


def conv2d(params, x: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """x: (B, H, W, Cin) -> (B, H', W', Cout), SAME.  The weight is cast to
    x's type; the bias stays fp32 (or x's type) and is added in fp32 before
    the output's one rounding."""
    b = params["b"]
    if b.dtype not in (torch.float32, x.dtype):
        b = b.float()
    return conv2d_op(x, params["w"].to(x.dtype), b, stride=stride)


def relu_conv(params, x, *, stride=1):
    return torch.relu(conv2d(params, x, stride=stride))


def _pad_same(x: torch.Tensor, window: int, stride: int, value: float):
    (pt, pb), (pl, pr) = (same_padding(x.shape[1], window, stride),
                          same_padding(x.shape[2], window, stride))
    return F.pad(x, (0, 0, pl, pr, pt, pb), value=value)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "SAME") -> torch.Tensor:
    if padding == "SAME":
        x = _pad_same(x, window, stride, float("-inf"))
    out = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return out.permute(0, 2, 3, 1).contiguous()


def avg_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """Window sum over ``window * window`` (padding counts as 0)."""
    if padding == "SAME":
        x = _pad_same(x, window, stride, 0.0)
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return out.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.float().mean(dim=(1, 2)).to(x.dtype)


def lrn(x: torch.Tensor, *, radius: int = 2, alpha: float = 1e-4,
        beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """Local response normalization across channels (AlexNet/GoogLeNet)."""
    xf = x.float()
    pad = F.pad(xf.square(), (radius, radius))
    C = x.shape[-1]
    n = sum(pad[..., i:i + C] for i in range(2 * radius + 1))
    return (xf / torch.pow(k + alpha * n, beta)).to(x.dtype)
