"""Plain PyTorch version of the block GEMM (counterpart of
``repro/kernels/matmul/ref.py:8-11``): the product of the two operands in
fp32, rounded once to ``x.dtype``."""
from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x: (M, K) @ y: (K, N) -> (M, N) in ``x.dtype``."""
    return (x.float() @ y.float()).to(x.dtype)
