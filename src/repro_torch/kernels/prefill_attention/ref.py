"""Plain PyTorch version of paged prefill attention (counterpart of
``repro/kernels/prefill_attention/ref.py``): gather pool blocks through the
block table, then causal chunked attention with the query chunk offset to
``q_start``."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import gather_pool
from repro_torch.models.layers.attention import chunked_attention


def paged_prefill_attention_ref(q, k_pool, v_pool, block_tables, q_start,
                                lengths, *, k_scale=None, v_scale=None,
                                softcap=0.0, chunk=1024):
    """q: (B, C, H, D), row ``o`` at absolute position ``q_start[b] + o``;
    k_pool/v_pool: (N, bs, K, D); block_tables: (B, max_blocks); q_start:
    (B,); lengths: (B,) valid rows including this chunk's.  Causality
    against absolute positions lets row ``o`` see every seeded row and the
    chunk rows at or before it.  k_scale/v_scale: (N, bs, K) fp32 for an
    int8 pool (dequantized to q's type before attending, as in the decode
    version).  Returns (B, C, H, D)."""
    C = q.shape[1]
    k, v = gather_pool(q, k_pool, v_pool, block_tables, k_scale, v_scale)
    S = k.shape[1]
    q_pos = q_start[:, None] + torch.arange(C, dtype=torch.int32,
                                            device=q.device)[None]
    return chunked_attention(
        q, k, v, causal=True, q_positions=q_pos,
        kv_positions=torch.arange(S, dtype=torch.int32, device=q.device),
        kv_len=lengths, softcap=softcap, chunk=chunk)
