"""Token embeddings and LM heads (counterpart of
``repro/models/layers/embedding.py``).  Under tensor parallelism the table
holds the rank's slice of the vocabulary (:func:`embed`'s ``tp``); the LM
head then gives the rank's slice of the logits."""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
from repro_torch.models.layers.linear import matmul
from repro_torch.models.layers.module import weight


def embedding_table(vocab_size: int, d_model: int, tie: bool):
    t = {"tok": weight((vocab_size, d_model), ("vocab", "embed"), stddev=1.0)}
    if not tie:
        t["lm_head"] = weight((d_model, vocab_size), ("embed", "vocab"))
    return t


def embed(params, tokens: torch.Tensor, compute_dtype, tp=None) -> torch.Tensor:
    """tokens: (B, S) int -> (B, S, D).  Gathering then casting equals the
    reference's cast-the-table-then-gather.

    Under a training plan ``tp`` (:mod:`repro_torch.distributed.
    tensor_parallel`) tokens are the data shard's whole rows.  With the
    vocabulary sliced on ``model``, each rank looks up the tokens its
    rows hold (zeros for the rest, so the sum over ranks is exact in any
    type) and the rows are summed over the axis: reduce-scattered onto the
    rank's S / M rows under ``seq_sp``, all-reduced otherwise.  With the
    table whole, the rank looks up its own rows."""
    tok = params["tok"]
    if tp is None or not tp.vocab:
        if tp is not None and tp.seq_sp:
            tokens = tokens[:, tp.own_rows(tokens.shape[1])]
        return tok[tokens].to(compute_dtype)
    local = tokens.long() - tp.model_rank * tok.shape[0]
    inside = (local >= 0) & (local < tok.shape[0])
    e = tok[torch.where(inside, local, 0)]
    e = torch.where(inside[..., None], e, 0).to(compute_dtype)
    if tp.seq_sp:
        return C.reduce_scatter_dim(e, 1, tp.group)
    return C.all_reduce(e, tp.group)


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
