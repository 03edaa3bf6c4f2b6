"""GoogLeNet (Inception-v1) -- the paper's evaluation network (BVLC
GoogLeNet, Szegedy et al. CVPR'15), in PyTorch, NHWC (counterpart of
``repro/models/googlenet.py``).

Parameters have the reference's names and shapes leaf for leaf, so a JAX
parameter tree crosses with :func:`repro_torch.interop.params_from_numpy`.
Auxiliary classifier heads are training-time only in the original and are
omitted, as in the reference.  All 57 convolutions run the conv2d kernel.
"""
from __future__ import annotations

import torch

from repro_torch.common import dtype_of
from repro_torch.models.layers.conv import (conv_table, global_avg_pool, lrn,
                                            max_pool, relu_conv)
from repro_torch.models.layers.linear import matmul
from repro_torch.models.layers.module import bias, init_table, weight

# (1x1, 3x3reduce, 3x3, 5x5reduce, 5x5, pool-proj) per inception module
INCEPTION_SPECS = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}
_STAGE_INPUT = {
    "3a": 192, "3b": 256, "4a": 480, "4b": 512, "4c": 512, "4d": 512,
    "4e": 528, "5a": 832, "5b": 832,
}


def inception_table(cin: int, spec):
    c1, c3r, c3, c5r, c5, pp = spec
    return {
        "b1": conv_table(1, 1, cin, c1),
        "b2r": conv_table(1, 1, cin, c3r),
        "b2": conv_table(3, 3, c3r, c3),
        "b3r": conv_table(1, 1, cin, c5r),
        "b3": conv_table(5, 5, c5r, c5),
        "b4": conv_table(1, 1, cin, pp),
    }


def inception(params, x: torch.Tensor) -> torch.Tensor:
    b1 = relu_conv(params["b1"], x)
    b2 = relu_conv(params["b2"], relu_conv(params["b2r"], x))
    b3 = relu_conv(params["b3"], relu_conv(params["b3r"], x))
    b4 = relu_conv(params["b4"], max_pool(x, 3, 1, "SAME"))
    return torch.cat([b1, b2, b3, b4], dim=-1)


def model_table(cfg):
    num_classes = cfg.vocab_size   # 1000 for ILSVRC
    t = {
        "stem1": conv_table(7, 7, 3, 64),
        "stem2r": conv_table(1, 1, 64, 64),
        "stem2": conv_table(3, 3, 64, 192),
        "fc_w": weight((1024, num_classes), (None, "vocab"), stddev=0.01),
        "fc_b": bias((num_classes,), ("vocab",)),
    }
    for name, spec in INCEPTION_SPECS.items():
        t[f"inc{name}"] = inception_table(_STAGE_INPUT[name], spec)
    return t


def init(cfg, gen: torch.Generator):
    return init_table(gen, model_table(cfg), cfg.param_dtype)


def forward(cfg, params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 224, 224, 3) -> logits (B, num_classes) fp32."""
    x = images.to(dtype_of(cfg.compute_dtype))
    x = relu_conv(params["stem1"], x, stride=2)          # 112x112x64
    x = max_pool(x, 3, 2)                                # 56x56
    x = lrn(x)
    x = relu_conv(params["stem2r"], x)
    x = relu_conv(params["stem2"], x)                    # 56x56x192
    x = lrn(x)
    x = max_pool(x, 3, 2)                                # 28x28
    x = inception(params["inc3a"], x)
    x = inception(params["inc3b"], x)
    x = max_pool(x, 3, 2)                                # 14x14
    for name in ("4a", "4b", "4c", "4d", "4e"):
        x = inception(params[f"inc{name}"], x)
    x = max_pool(x, 3, 2)                                # 7x7
    x = inception(params["inc5a"], x)
    x = inception(params["inc5b"], x)                    # 7x7x1024
    x = global_avg_pool(x)                               # (B, 1024)
    return matmul(x.float(), params["fc_w"].float()) + params["fc_b"].float()


def predict(cfg, params, images: torch.Tensor):
    """Paper-style inference output: (top1 label, confidence, probs) per
    image."""
    probs = torch.softmax(forward(cfg, params, images), dim=-1)
    conf, label = probs.max(dim=-1)
    return label, conf, probs


def conv_shapes(batch: int, size: int):
    """The 57 convolutions of one forward at ``size`` x ``size`` inputs, in
    order: (name, x shape (B, H, W, Cin), w shape (KH, KW, Cin, Cout),
    stride)."""
    shapes = []

    def add(name, h, cin, k, cout, stride=1):
        shapes.append((name, (batch, h, h, cin), (k, k, cin, cout), stride))
        return -(-h // stride)

    h = add("stem1", size, 3, 7, 64, 2)
    h = -(-h // 2)
    add("stem2r", h, 64, 1, 64)
    add("stem2", h, 64, 3, 192)
    h = -(-h // 2)
    for name, spec in INCEPTION_SPECS.items():
        if name in ("4a", "5a"):
            h = -(-h // 2)
        cin = _STAGE_INPUT[name]
        c1, c3r, c3, c5r, c5, pp = spec
        add(f"{name}.b1", h, cin, 1, c1)
        add(f"{name}.b2r", h, cin, 1, c3r)
        add(f"{name}.b2", h, c3r, 3, c3)
        add(f"{name}.b3r", h, cin, 1, c5r)
        add(f"{name}.b3", h, c5r, 5, c5)
        add(f"{name}.b4", h, cin, 1, pp)
    return shapes
