"""Token embeddings and LM heads (counterpart of
``repro/models/layers/embedding.py``)."""
from __future__ import annotations

import torch

from repro_torch.models.layers.linear import matmul
from repro_torch.models.layers.module import weight


def embedding_table(vocab_size: int, d_model: int, tie: bool):
    t = {"tok": weight((vocab_size, d_model), ("vocab", "embed"), stddev=1.0)}
    if not tie:
        t["lm_head"] = weight((d_model, vocab_size), ("embed", "vocab"))
    return t


def embed(params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """tokens: (B, S) int -> (B, S, D).  Gathering then casting equals the
    reference's cast-the-table-then-gather."""
    return params["tok"][tokens].to(compute_dtype)


def logits(params, x: torch.Tensor, tie: bool,
           softcap: float = 0.0) -> torch.Tensor:
    """x: (..., D) -> (..., V). Computed in fp32 for numerics; the tied
    table's transpose reaches the kernel as a view, not a copy."""
    if tie:
        w = params["tok"].float().T
    else:
        w = params["lm_head"].float()
    out = matmul(x.float(), w)
    if softcap:
        out = softcap * torch.tanh(out / softcap)
    return out
