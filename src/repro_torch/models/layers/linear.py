"""Weight products through the K7 matmul kernel, with their gradients.

Every weight product of the port's models (attention projections, MLPs,
the LM head, the Mamba-2 projections, the hybrid's shared-block input and
GoogLeNet's classifier) goes through :func:`matmul`; the experts' products
of a mixture-of-experts layer go through :func:`batched_matmul`, K7's
batched entry.  The Pallas K7 has no backward (nothing in the reference
wraps it in a ``custom_vjp``: JAX differentiates its einsums), so the
backward here is two more launches of the same entry, each on strided
views: ``dX = dY @ W^T`` and ``dW = X^T @ dY`` (per expert, for the
batched entry).  On the CPU the same Functions call the plain versions.

Under :func:`keep_products` (``remat="dots"``: the reference's
``dots_with_no_batch_dims_saveable``, which keeps the outputs of the
products without batch dimensions -- the weight products) each product
keeps its output in a :class:`KeptProducts`, and when
``torch.utils.checkpoint`` runs the block again in the backward, the
products hand those outputs back in order instead of launching K7 again.
A selective-checkpoint policy cannot do this: it sees dispatcher ops, and
K7 is a ctypes launch inside an autograd Function.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels.matmul.ops import matmul as _k7
from repro_torch.kernels.matmul.ops import matmul_batched as _k7_batched

# the store of the block running on this thread (the recompute of a
# checkpointed block runs on autograd's thread, and enters it there)
_ACTIVE = threading.local()


class KeptProducts:
    """The outputs of one block's weight products, in the order the block
    makes them: recorded by the block's first run, handed back to each
    later run (the checkpoint's recompute)."""

    def __init__(self):
        self.outputs: list[torch.Tensor] = []
        self.recorded = False
        self.next = 0


@contextlib.contextmanager
def keep_products(kept: KeptProducts):
    """Inside the block, every :func:`matmul` records its output in
    ``kept`` (the first run) or returns the next recorded one without a
    launch (every later run)."""
    prev = getattr(_ACTIVE, "kept", None)
    kept.next = 0
    _ACTIVE.kept = kept
    try:
        yield
    finally:
        _ACTIVE.kept = prev
        kept.recorded = True


def _unit_strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is when one of its matrix dims (the last two) has a unit
    stride (what K7 reads); a contiguous copy otherwise (an incoming
    gradient that autograd made by expanding a scalar has zero strides)."""
    if 1 in t.stride()[-2:] or 1 in t.shape[-2:]:
        return t
    return t.contiguous()


class _Matmul(torch.autograd.Function):
    """(M, K) @ (K, N) -> (M, N) in x's type, fp32-accumulated, forward and
    backward through K7."""

    @staticmethod
    def forward(ctx, x, w):
        kept = getattr(_ACTIVE, "kept", None)
        if kept is not None and kept.recorded:      # the recompute: no launch
            out = kept.outputs[kept.next].detach()
            kept.next += 1
        else:
            out = _k7(x, w)
            if kept is not None:
                kept.outputs.append(out.detach())
        ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = _unit_strided(dy)
        dx = _k7(dy, w.T) if ctx.needs_input_grad[0] else None
        dw = _k7(x.T, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


class _BatchedMatmul(torch.autograd.Function):
    """(E, M, K) @ (E, K, N) -> (E, M, N) in x's type, each expert's product
    fp32-accumulated, forward and backward through K7's batched entry: the
    backward's ``dX[e] = dY[e] @ W[e]^T`` and ``dW[e] = X[e]^T @ dY[e]``
    are one launch each, on transposed views.  Never kept under
    ``remat="dots"``: the recompute launches it again."""

    @staticmethod
    def forward(ctx, xs, w):
        ctx.save_for_backward(xs, w)
        return _k7_batched(xs, w)

    @staticmethod
    def backward(ctx, dy):
        xs, w = ctx.saved_tensors
        dy = _unit_strided(dy)
        dx = _k7_batched(dy, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        dw = _k7_batched(xs.transpose(1, 2), dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) -> (..., N) in x's type; the leading dims
    flatten into the kernel's M.  ``w`` may be any view with a unit stride
    in one dim (``tok.T`` for the tied LM head is read in place)."""
    lead = x.shape[:-1]
    out = _Matmul.apply(_unit_strided(x.reshape(-1, x.shape[-1])), w)
    return out.reshape(*lead, w.shape[-1])


def batched_matmul(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xs: (E, M, K) @ w: (E, K, N) -> (E, M, N) in xs's type, each expert's
    product summed in fp32 and rounded once: one launch of K7's batched
    entry for all E experts on the card, its plain version on the CPU.
    Differentiable: the gradients are two more launches of the same entry
    (:class:`_BatchedMatmul`)."""
    return _BatchedMatmul.apply(_unit_strided(xs), w)
