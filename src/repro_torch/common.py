"""Small shared utilities: dtype resolution and initializers on an explicit
``torch.Generator`` (counterpart of ``repro/common.py``)."""
from __future__ import annotations

import math

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int8": torch.int8,
}


def dtype_of(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, str):
        return _DTYPES[name]
    return name


def truncated_normal_init(gen: torch.Generator, shape: tuple[int, ...], dtype,
                          stddev: float | None = None,
                          fan_in_axis: int = -2) -> torch.Tensor:
    """Truncated-normal init in [-2, 2] sigma with 1/sqrt(fan_in) default
    stddev, on ``gen``'s device (same fan-in rule as the reference)."""
    if stddev is None:
        fan_in = shape[fan_in_axis] if len(shape) >= 2 else shape[0]
        stddev = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * stddev).to(dtype_of(dtype))


def zeros_init(gen: torch.Generator, shape: tuple[int, ...], dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype_of(dtype), device=gen.device)


def ones_init(gen: torch.Generator, shape: tuple[int, ...], dtype) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype_of(dtype), device=gen.device)
