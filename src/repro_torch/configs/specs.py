"""Shape-and-type stand-ins for every (arch x shape) cell (counterpart of
``repro/configs/specs.py``).

``input_specs(cfg, shape)`` gives the *data* arguments of the step that
``shape.kind`` selects (train / prefill / decode), and ``abstract_params``
the parameters, as tensors on the ``meta`` device: shapes and types with no
storage.  Nothing here allocates memory on any device.
"""
from __future__ import annotations

import torch

from repro_torch.common import dtype_of
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.layers.module import tree_map
from repro_torch.models.registry import fns_for


def shape_dtype(shape: tuple[int, ...], dtype) -> torch.Tensor:
    """A ``meta`` tensor: the shape and type of an array, no storage."""
    return torch.empty(tuple(shape), dtype=dtype_of(dtype), device="meta")


def _lm_batch(cfg: ModelConfig, B: int, S: int, *, labels: bool) -> dict:
    d = {"tokens": shape_dtype((B, S), "int32")}
    if labels:
        d["labels"] = shape_dtype((B, S), "int32")
    if cfg.m_rope:
        d["positions"] = shape_dtype((3, B, S), "int32")
    if cfg.family == "audio":
        d["frames"] = shape_dtype(
            (B, cfg.encdec.num_encoder_frames, cfg.d_model), "bfloat16")
    return d


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                cache_dtype: str = "bfloat16"):
    """Returns (batch specs, extra): ``extra`` the decode state's specs for
    a decode cell, else None."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "cnn":
        d = {"images": shape_dtype((B, 224, 224, 3), "float32")}
        if shape.kind == "train":
            d["labels"] = shape_dtype((B,), "int32")
        return d, None
    if shape.kind == "train":
        return _lm_batch(cfg, B, S, labels=True), None
    if shape.kind == "prefill":
        return _lm_batch(cfg, B, S, labels=False), None
    if shape.kind == "decode":
        state = fns_for(cfg).init_decode_state(cfg, B, S, cache_dtype, device="meta")
        return {"tokens": shape_dtype((B, 1), "int32")}, state
    raise ValueError(shape.kind)


def abstract_params(cfg: ModelConfig):
    """The parameters' shapes and types, leaf for leaf as ``init`` gives
    them (``cfg.param_dtype``), on the ``meta`` device."""
    dt = dtype_of(cfg.param_dtype)
    return tree_map(lambda d: shape_dtype(d.shape, dt), fns_for(cfg).table(cfg))
