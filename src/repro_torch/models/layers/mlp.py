"""Feed-forward layers (counterpart of ``repro/models/layers/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.linear import matmul
from repro_torch.models.layers.module import weight


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
