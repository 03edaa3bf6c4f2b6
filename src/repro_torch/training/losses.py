"""Loss functions (counterpart of ``repro/training/losses.py``).

Cross-entropy picks the label's logit with a gather, so no one-hot target
of the logits' size is made; a small z-loss keeps the softmax normalizer
bounded.  On a rank of a training mesh :func:`lm_cross_entropy` takes the
rank's rows or its slice of the vocabulary.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C


class _VocabLogSumExp(torch.autograd.Function):
    """Row log-sum-exp of logits whose last dim is sliced over ``group``:
    the max and the sum of exponentials all-reduced, in
    ``torch.logsumexp``'s own steps (so on a group of one it gives its
    bits).  Backward: each rank's rows of the gradient hold its own share
    of the loss, so they are summed over the group first, then
    ``g exp(x - lse)``, ``torch.logsumexp``'s formula."""

    @staticmethod
    def forward(ctx, x, group):
        m = C.all_reduce(torch.amax(x, dim=-1, keepdim=True), group, op="max")
        m.masked_fill_(m.abs() == float("inf"), 0)
        s = C.all_reduce(torch.sum(torch.exp(x - m), dim=-1), group)
        lse = torch.log(s).add_(m[..., 0])
        ctx.save_for_backward(x, lse)
        ctx.group = group
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        g = C.all_reduce(g.contiguous(), ctx.group)
        return g[..., None] * torch.exp(x - lse[..., None]), None


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor | None = None, *,
                     z_loss: float = 1e-4, tp=None):
    """logits: (B, S, V) fp32; labels: (B, S) int.  Returns (loss, metrics)
    with metrics ``nll`` and ``accuracy``.

    ``tp``: a rank of a training mesh (the plan of
    :mod:`repro_torch.distributed.tensor_parallel`); labels and mask are
    the data shard's whole rows, and logits are (B, S, V / M), every row on
    the rank's slice of the vocabulary, where the rules slice it on the
    model axis; (B, S / M, V), the rank's own rows, under ``seq_sp`` with
    the vocabulary whole; (B, S, V) otherwise.  The log-sum-exp and the
    label's logit are all-reduced over the model axis (the label's logit
    comes from the rank whose slice holds it), so the z-loss reads the
    global log-sum-exp; accuracy takes the global argmax, ties at the
    lowest index as ``argmax`` breaks them.  The loss and metrics are then
    the rank's shares of the data shard's means: its own rows
    (:meth:`~repro_torch.distributed.tensor_parallel.Plan.own_rows`) over
    the shard's count, so the shares sum to the means over the model
    axis."""
    logits = logits.float()
    own = slice(None) if tp is None else tp.own_rows(labels.shape[1])
    mask = (torch.ones(labels.shape, dtype=logits.dtype, device=logits.device)
            if mask is None else mask.float())
    denom = torch.clamp(mask.sum(), min=1.0)
    if logits.shape[1] != labels.shape[1]:     # the rank's own rows already
        labels, mask, own = labels[:, own], mask[:, own], slice(None)
    group = tp.group if tp is not None and tp.vocab else None
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)                        # (B, S)
        picked = logits.gather(-1, labels.long()[..., None])[..., 0]  # (B, S)
    else:
        v0 = tp.model_rank * logits.shape[-1]
        lse = _VocabLogSumExp.apply(logits, group)
        local = labels.long() - v0
        inside = (local >= 0) & (local < logits.shape[-1])
        picked = logits.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
        picked = C.all_reduce(torch.where(inside, picked, 0), group)
    nll = (lse - picked)[:, own]
    zl = z_loss * lse[:, own].square()
    mask = mask[:, own]
    loss = ((nll + zl) * mask).sum() / denom
    with torch.no_grad():
        if group is None:
            arg = logits.argmax(-1)
        else:
            vmax, arg = logits.max(-1)
            best = C.all_reduce(vmax, group, op="max")
            cand = torch.where(vmax == best, arg + v0, torch.iinfo(torch.int64).max)
            arg = -C.all_reduce(-cand, group, op="max")
        acc = ((arg == labels)[:, own].float() * mask).sum() / denom
    return loss, {"nll": (nll * mask).sum() / denom, "accuracy": acc}


def classification_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """logits: (B, C) fp32; labels: (B,) int (GoogLeNet training)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[:, None])[:, 0]
    loss = (lse - picked).mean()
    with torch.no_grad():
        acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc}
