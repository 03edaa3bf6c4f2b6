"""Plain PyTorch versions of the block GEMM (counterpart of
``repro/kernels/matmul/ref.py:8-11``) and of its batched entry: the
product of the two operands in fp32, rounded once to ``x.dtype``."""
from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x: (M, K) @ y: (K, N) -> (M, N) in ``x.dtype``."""
    return (x.float() @ y.float()).to(x.dtype)


def matmul_batched_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x: (E, M, K) @ y: (E, K, N) -> (E, M, N) in ``x.dtype``, expert by
    expert: an fp32 bmm rounded once (the reference's ``"ecd,edf->ecf"``
    einsums, ``repro/models/layers/moe.py:67-77``)."""
    return torch.bmm(x.float(), y.float()).to(x.dtype)
