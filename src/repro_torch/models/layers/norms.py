"""Normalization layers (counterpart of ``repro/models/layers/norms.py``)."""
from __future__ import annotations

import torch

from repro_torch.models.layers.module import bias, scale


def rmsnorm_table(dim: int, axes=("embed",)):
    return {"scale": scale((dim,), axes)}


def layernorm_table(dim: int, axes=("embed",)):
    return {"scale": scale((dim,), axes), "bias": bias((dim,), axes)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)


def norm_table(cfg, dim: int | None = None, axes=("embed",)):
    dim = dim or cfg.d_model
    return layernorm_table(dim, axes) if cfg.use_layernorm else rmsnorm_table(dim, axes)


def apply_norm(cfg, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.use_layernorm:
        return layernorm(params, x, cfg.norm_eps)
    return rmsnorm(params, x, cfg.norm_eps)


def head_rmsnorm(scale_param, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """QK-norm: RMS-normalize the last (head) dim with a learned scale."""
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale_param.float()).to(dtype)
