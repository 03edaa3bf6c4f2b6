"""Plain PyTorch versions of decode attention (counterpart of
``repro/kernels/decode_attention/ref.py``): dense decode attention over a
contiguous cache, and the paged one, which gathers the pool blocks into
logical order through the block table first."""
from __future__ import annotations

import torch

from repro_torch.models.layers.attention import chunked_attention


def decode_attention_ref(q, k, v, lengths, *, chunk=1024):
    """q: (B, H, D); k/v: (B, S, K, D); lengths: (B,) valid rows per
    sequence (past S: every row).  Returns (B, H, D)."""
    B, H, D = q.shape
    S = k.shape[1]
    out = chunked_attention(
        q[:, None], k, v, causal=False,
        q_positions=torch.zeros((B, 1), dtype=torch.int32, device=q.device),
        kv_positions=torch.arange(S, dtype=torch.int32, device=q.device),
        kv_len=lengths, chunk=chunk)
    return out[:, 0]


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                               softcap=0.0, chunk=1024):
    """q: (B, H, D); k_pool/v_pool: (N, bs, K, D) global pool; block_tables:
    (B, max_blocks) physical block per logical block; lengths: (B,) valid
    rows per sequence.  Returns (B, H, D)."""
    B, H, D = q.shape
    N, bs, K, _ = k_pool.shape
    mb = block_tables.shape[1]
    idx = block_tables.long()
    S = mb * bs
    k = k_pool[idx].reshape(B, S, K, D).to(q.dtype)    # (B, mb*bs, K, D)
    v = v_pool[idx].reshape(B, S, K, D).to(q.dtype)
    out = chunked_attention(
        q[:, None], k, v, causal=False,
        q_positions=torch.zeros((B, 1), dtype=torch.int32, device=q.device),
        kv_positions=torch.arange(S, dtype=torch.int32, device=q.device),
        kv_len=lengths, softcap=softcap, chunk=chunk)
    return out[:, 0]
