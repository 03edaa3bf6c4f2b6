"""Feed-forward layers: SwiGLU (the LLaMA / Qwen families) and the GELU
MLP (Whisper) (counterpart of ``repro/models/layers/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.linear import matmul
from repro_torch.models.layers.module import bias, weight


def swiglu_table(d_model: int, d_ff: int):
    return {
        "w_gate": weight((d_model, d_ff), ("embed", "ff")),
        "w_up": weight((d_model, d_ff), ("embed", "ff")),
        "w_down": weight((d_ff, d_model), ("ff", "embed")),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_model) -> (..., d_model).  ``.to(x.dtype)`` is a no-op
    for weights already cast at load (:func:`transformer.prepare_params`)."""
    gate = matmul(x, params["w_gate"].to(x.dtype))
    up = matmul(x, params["w_up"].to(x.dtype))
    h = F.silu(gate) * up
    return matmul(h, params["w_down"].to(x.dtype))


def gelu_mlp_table(d_model: int, d_ff: int):
    return {
        "w_in": weight((d_model, d_ff), ("embed", "ff")),
        "b_in": bias((d_ff,), ("ff",)),
        "w_out": weight((d_ff, d_model), ("ff", "embed")),
        "b_out": bias((d_model,), ("embed",)),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_model) -> (..., d_model): both products on K7, the biases
    added in x's type, tanh GELU between, as the reference's
    ``jax.nn.gelu(approximate=True)``."""
    h = matmul(x, params["w_in"].to(x.dtype)) + params["b_in"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return matmul(h, params["w_out"].to(x.dtype)) + params["b_out"].to(x.dtype)
