"""Loss functions (counterpart of ``repro/training/losses.py``).

Cross-entropy picks the label's logit with a gather, so no one-hot target
of the logits' size is made; a small z-loss keeps the softmax normalizer
bounded.
"""
from __future__ import annotations

import torch


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor | None = None, *,
                     z_loss: float = 1e-4):
    """logits: (B, S, V) fp32; labels: (B, S) int.  Returns (loss, metrics)
    with metrics ``nll`` and ``accuracy``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)                        # (B, S)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]  # (B, S)
    nll = lse - picked
    zl = z_loss * lse.square()
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = ((nll + zl) * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == labels).float() * mask).sum() / denom
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
