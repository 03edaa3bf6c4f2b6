"""Decode attention over a contiguous KV cache (counterpart of
``repro/distributed/collectives.py``): the single-device branch of
``seq_sharded_decode_attention`` (``:97-120``) and its ``_write_row``
(``:26-34``), bf16, fp32 and int8 caches.

The new token's row (and, int8, its scales) is written **in place** (the
reference's ``.at[].set`` returns new caches); the function still returns
the caches, which hold the updated rows.  Attention runs through the dense
decode kernel
(:func:`repro_torch.kernels.decode_attention.ops.decode_attention`) where
the reference calls ``chunked_attention``; an int8 cache is dequantized
whole to q's type first, as the reference does.  Not ported yet: the
sequence-sharded branch with its log-sum-exp merge across a mesh.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.dispatch import check_scales


def _write_row(buf, row, lengths, offset: int, s_loc: int):
    """Write one new (B, ...) row at slot ``lengths - offset`` of each
    sequence where that slot lies in [0, s_loc), in place; sequences whose
    slot lies outside (an idle slot counting past the cache) keep their
    rows.  No host sync: out-of-range sequences rewrite a clamped slot with
    its own value, as the reference's select keeps it."""
    B = buf.shape[0]
    widx = lengths - offset
    in_range = (widx >= 0) & (widx < s_loc)
    widx_c = torch.clamp(widx, 0, s_loc - 1).long()
    b = torch.arange(B, device=buf.device)
    sel = in_range.reshape((B,) + (1,) * (buf.ndim - 2))
    buf[b, widx_c] = torch.where(sel, row.to(buf.dtype), buf[b, widx_c])
    return buf


def seq_sharded_decode_attention(q, cache_k, cache_v, k_new, v_new, lengths,
                                 *, k_scale=None, v_scale=None,
                                 softcap: float = 0.0, chunk: int = 2048,
                                 mesh=None):
    """Decode attention against a contiguous cache, on one device.

    q: (B, 1, H, D); cache_k/v: (B, S, K, D) bf16 or fp32, or int8 with
    k_scale/v_scale (B, S, K) fp32; k_new/v_new: (B, 1, K, D); lengths:
    (B,) current fill (the new row is written at ``lengths`` and attention
    covers ``lengths + 1`` rows).  An int8 cache takes the row quantized
    (``quantize_kv``) with its scales, and is dequantized to q's type for
    the kernel.  Returns (attn_out (B, 1, H, D), cache_k, cache_v[,
    k_scale, v_scale]), the caches updated in place.  An int8 cache without
    its scales (or scales beside another cache), a softcap (the dense
    decode kernel has none, as the Pallas one) and a mesh raise.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sequence-sharded decode (a mesh) is ported with the "
            "distributed slice; the port decodes on one device")
    if softcap:
        raise NotImplementedError(
            "softcap: the dense decode kernel has none, as the Pallas "
            "kernel it ports")
    S = cache_k.shape[1]
    if check_scales(cache_k, k_scale, v_scale):
        from repro_torch.models.transformer import dequantize_kv, quantize_kv
        kq, ks = quantize_kv(k_new[:, 0])
        vq, vs = quantize_kv(v_new[:, 0])
        nk = _write_row(cache_k, kq, lengths, 0, S)
        nv = _write_row(cache_v, vq, lengths, 0, S)
        extra = (_write_row(k_scale, ks, lengths, 0, S),
                 _write_row(v_scale, vs, lengths, 0, S))
        att_k = dequantize_kv(nk, extra[0], q.dtype)
        att_v = dequantize_kv(nv, extra[1], q.dtype)
    else:
        nk = _write_row(cache_k, k_new[:, 0], lengths, 0, S)
        nv = _write_row(cache_v, v_new[:, 0], lengths, 0, S)
        att_k, att_v, extra = nk, nv, ()
    out = decode_attention(q[:, 0].contiguous(), att_k, att_v, lengths + 1,
                           chunk=chunk)
    return (out[:, None], nk, nv, *extra)
