"""Plain PyTorch version of paged prefill attention (counterpart of
``repro/kernels/prefill_attention/ref.py``): gather pool blocks through the
block table, then causal chunked attention with the query chunk offset to
``q_start``."""
from __future__ import annotations

import torch

from repro_torch.models.layers.attention import chunked_attention


def paged_prefill_attention_ref(q, k_pool, v_pool, block_tables, q_start,
                                lengths, *, softcap=0.0, chunk=1024):
    """q: (B, C, H, D), row ``o`` at absolute position ``q_start[b] + o``;
    k_pool/v_pool: (N, bs, K, D); block_tables: (B, max_blocks); q_start:
    (B,); lengths: (B,) valid rows including this chunk's.  Causality
    against absolute positions lets row ``o`` see every seeded row and the
    chunk rows at or before it.  Returns (B, C, H, D)."""
    B, C, H, D = q.shape
    N, bs, K, _ = k_pool.shape
    mb = block_tables.shape[1]
    idx = block_tables.long()
    S = mb * bs
    k = k_pool[idx].reshape(B, S, K, D).to(q.dtype)
    v = v_pool[idx].reshape(B, S, K, D).to(q.dtype)
    q_pos = q_start[:, None] + torch.arange(C, dtype=torch.int32,
                                            device=q.device)[None]
    return chunked_attention(
        q, k, v, causal=True, q_positions=q_pos,
        kv_positions=torch.arange(S, dtype=torch.int32, device=q.device),
        kv_len=lengths, softcap=softcap, chunk=chunk)
