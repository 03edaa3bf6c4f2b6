"""Weight products through the K7 matmul kernel, with their gradients.

Every weight product of the port's models (attention projections, MLPs,
the LM head, the Mamba-2 projections, the hybrid's shared-block input and
GoogLeNet's classifier) goes through :func:`matmul`.  The Pallas K7 has no
backward (nothing in the reference wraps it in a ``custom_vjp``: JAX
differentiates its einsums), so the backward here is two more launches of
the same kernel, each on strided views: ``dX = dY @ W^T`` and
``dW = X^T @ dY``.  On the CPU the same Function calls the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.matmul.ops import matmul as _k7


def _unit_strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is when one of its dims has a unit stride (what K7
    reads); a contiguous copy otherwise (an incoming gradient that autograd
    made by expanding a scalar has strides (0, 0))."""
    if 1 in t.stride() or 1 in t.shape:
        return t
    return t.contiguous()


class _Matmul(torch.autograd.Function):
    """(M, K) @ (K, N) -> (M, N) in x's type, fp32-accumulated, forward and
    backward through K7."""

    @staticmethod
    def forward(ctx, x, w):
        out = _k7(x, w)
        ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = _unit_strided(dy)
        dx = _k7(dy, w.T) if ctx.needs_input_grad[0] else None
        dw = _k7(x.T, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) -> (..., N) in x's type; the leading dims
    flatten into the kernel's M.  ``w`` may be any view with a unit stride
    in one dim (``tok.T`` for the tied LM head is read in place)."""
    lead = x.shape[:-1]
    out = _Matmul.apply(_unit_strided(x.reshape(-1, x.shape[-1])), w)
    return out.reshape(*lead, w.shape[-1])
