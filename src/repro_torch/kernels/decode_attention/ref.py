"""Plain PyTorch versions of decode attention (counterpart of
``repro/kernels/decode_attention/ref.py``): dense decode attention over a
contiguous cache, and the paged one, which gathers the pool blocks into
logical order through the block table first."""
from __future__ import annotations

import torch

from repro_torch.models.layers.attention import chunked_attention


def decode_attention_ref(q, k, v, lengths, *, chunk=1024, return_lse=False):
    """q: (B, H, D); k/v: (B, S, K, D); lengths: (B,) valid rows per
    sequence (past S: every row).  Returns (B, H, D); with ``return_lse``
    (out, m, l), m and l the reference's residuals, fp32 (B, H)."""
    B, H, D = q.shape
    S = k.shape[1]
    out = chunked_attention(
        q[:, None], k, v, causal=False,
        q_positions=torch.zeros((B, 1), dtype=torch.int32, device=q.device),
        kv_positions=torch.arange(S, dtype=torch.int32, device=q.device),
        kv_len=lengths, chunk=chunk, return_residuals=return_lse)
    if return_lse:
        out, res = out
        return out[:, 0], res.m[..., 0], res.l[..., 0]
    return out[:, 0]


def gather_pool(q, k_pool, v_pool, block_tables, k_scale=None,
                v_scale=None):
    """The pool's rows in logical order, in q's type: (B, mb * bs, K, D)
    each.  An int8 pool is dequantized first, as the reference does: one
    fp32 multiply by the row's scale (k_scale/v_scale: (N, bs, K)), then one
    rounding to q's type."""
    B, D = q.shape[0], q.shape[-1]
    _, bs, K, _ = k_pool.shape
    idx = block_tables.long()
    k, v = k_pool[idx], v_pool[idx]                  # (B, mb, bs, K, D)
    if k_scale is not None:
        k = (k.float() * k_scale[idx][..., None]).to(q.dtype)
        v = (v.float() * v_scale[idx][..., None]).to(q.dtype)
    S = idx.shape[1] * bs
    return (k.reshape(B, S, K, D).to(q.dtype), v.reshape(B, S, K, D).to(q.dtype))


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                               k_scale=None, v_scale=None, softcap=0.0,
                               chunk=1024):
    """q: (B, H, D); k_pool/v_pool: (N, bs, K, D) global pool; block_tables:
    (B, max_blocks) physical block per logical block; lengths: (B,) valid
    rows per sequence; k_scale/v_scale: (N, bs, K) fp32 for an int8 pool.
    Returns (B, H, D)."""
    B = q.shape[0]
    k, v = gather_pool(q, k_pool, v_pool, block_tables, k_scale, v_scale)
    S = k.shape[1]
    out = chunked_attention(
        q[:, None], k, v, causal=False,
        q_positions=torch.zeros((B, 1), dtype=torch.int32, device=q.device),
        kv_positions=torch.arange(S, dtype=torch.int32, device=q.device),
        kv_len=lengths, softcap=softcap, chunk=chunk)
    return out[:, 0]
