"""Attention: GQA with RoPE / M-RoPE, qk-norm and bias options, the
encoder-decoder's cross-attention table, plus the chunked online-softmax
core (counterpart of ``repro/models/layers/attention.py``).

`chunked_attention` is the plain PyTorch version that the paged kernels'
plain versions (`repro_torch.kernels.*.ref`) gather into; it mirrors the
reference step for step, including where bf16 rounds, and returns, when
asked, the log-sum-exp residuals that `merge_lse` combines across the
shards of a sequence-sharded cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.layers.linear import matmul
from repro_torch.models.layers.module import bias, scale, weight
from repro_torch.models.layers.norms import head_rmsnorm
from repro_torch.models.layers.rope import apply_m_rope, apply_rope

NEG_INF = -1e30


def attention_table(cfg, d_model: int | None = None):
    """Parameter table for one attention block."""
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    t = {
        "wq": weight((d, cfg.num_heads, hd), ("embed", "heads", None)),
        "wk": weight((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", None)),
        "wv": weight((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", None)),
        "wo": weight((cfg.num_heads, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = bias((cfg.num_heads, hd), ("heads", None))
        t["bk"] = bias((cfg.num_kv_heads, hd), ("kv_heads", None))
        t["bv"] = bias((cfg.num_kv_heads, hd), ("kv_heads", None))
    if cfg.qk_norm:
        t["q_norm"] = scale((hd,), (None,))
        t["k_norm"] = scale((hd,), (None,))
    return t


def cross_attention_table(cfg, d_model: int | None = None):
    """Cross-attention (encoder-decoder): the same shapes as
    :func:`attention_table`, its K/V read from the encoder's output."""
    return attention_table(cfg, d_model)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsd,dhk->bshk' as one matrix product."""
    d, h, k = w.shape
    return matmul(x, w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def qkv_project(cfg, params, x: torch.Tensor, positions: torch.Tensor | None,
                kv_span: slice | None = None):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, K, hd), RoPE applied:
    M-RoPE when ``cfg.m_rope`` (positions (3, B, S)), else positions (B, S).
    Under tensor parallelism ``params`` hold the rank's heads; where the
    KV heads are replicated, ``kv_span`` names those the rank's query heads
    read (their GQA group), and only they are projected.

    The reference casts each fp32 weight to the compute dtype before every
    product; the engine casts once at load instead
    (:func:`repro_torch.models.transformer.prepare_params`), which gives the
    same numbers, and ``.to`` here is then a no-op."""
    dt = x.dtype
    kv = slice(None) if kv_span is None else kv_span
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"][:, kv])
    v = _proj(x, params["wv"][:, kv])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"][kv].to(dt)
        v = v + params["bv"][kv].to(dt)
    if cfg.qk_norm:
        q = head_rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if positions is not None and cfg.m_rope:
        q = apply_m_rope(q, positions, cfg.rope_theta, cfg.m_rope_sections)
        k = apply_m_rope(k, positions, cfg.rope_theta, cfg.m_rope_sections)
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


class AttnResiduals(NamedTuple):
    """Per-query-row log-sum-exp residuals for distributed (LSE) merging."""
    out: torch.Tensor   # (B, Sq, H, D), normalized by its own l
    m: torch.Tensor     # (B, H, Sq) running max
    l: torch.Tensor     # (B, H, Sq) running sum


def _mask_bias(q_pos, kv_pos, *, causal: bool, window: int,
               kv_len=None) -> torch.Tensor:
    """Additive mask bias (B, Sq, C) in fp32; 0 where attended."""
    kv = kv_pos[None, None, :] if kv_pos.ndim == 1 else kv_pos[:, None, :]
    qp = q_pos[:, :, None]
    allowed = torch.ones(torch.broadcast_shapes(qp.shape, kv.shape),
                         dtype=torch.bool, device=qp.device)
    if causal:
        allowed &= kv <= qp
    if window:
        allowed &= kv > qp - window
    if kv_len is not None:
        allowed &= kv < kv_len[:, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=qp.device)
    return torch.where(allowed, zero, torch.full_like(zero, NEG_INF))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      q_positions: torch.Tensor | None = None,
                      kv_positions: torch.Tensor | None = None,
                      kv_len: torch.Tensor | None = None,
                      softcap: float = 0.0,
                      window: int = 0,
                      chunk: int = 1024,
                      return_residuals: bool = False):
    """Online-softmax attention, scanning KV in chunks.

    q: (B, Sq, H, D); k/v: (B, Skv, K, D) with H % K == 0 (GQA: query head
    h reads kv head h // G).  q_positions: (B, Sq) absolute positions;
    kv_positions: (Skv,) or (B, Skv); kv_len: (B,) valid cache rows.
    Fully masked rows give 0 (the ``m_safe`` guard and the ``l`` floor).
    Returns (B, Sq, H, D) in q.dtype; with ``return_residuals`` also
    :class:`AttnResiduals` (m: the running max of the masked scores, l: the
    sum of exp(s - m_safe), fp32 (B, H, Sq) each).
    """
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    dev = q.device
    scale_ = 1.0 / math.sqrt(D)
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=dev).expand(B, Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, dtype=torch.int32, device=dev)

    chunk = min(chunk, Skv)
    n_chunks = math.ceil(Skv / chunk)
    pad = n_chunks * chunk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        # padded slots get a huge position: masked by causality or kv_len
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=10**9)
        if kv_len is None and not causal:
            kv_len = torch.full((B,), Skv, dtype=torch.int32, device=dev)

    qg = q.reshape(B, Sq, K, G, D)
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, G, Sq, D), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_c, v_c = k[:, sl], v[:, sl]
        kp_c = kv_positions[..., sl]
        # q and k of two types (an fp32 query against a bf16 cache) meet
        # in the wider one, as the reference's einsum promotes them
        dt = torch.promote_types(qg.dtype, k_c.dtype)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg.to(dt), k_c.to(dt)).float()
        s = s * scale_
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mb = _mask_bias(q_positions, kp_c, causal=causal, window=window,
                        kv_len=kv_len)                    # (B, Sq, C)
        s = s + mb[:, None, None, :, :]
        m_new = torch.maximum(m, s.amax(dim=-1))          # (B, K, G, Sq)
        m_safe = torch.clamp(m_new, min=NEG_INF / 2)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(torch.clamp(m - m_new, max=0.0))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(v_c.dtype), v_c)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, K * G, Sq, D).transpose(1, 2).to(q.dtype)
    if return_residuals:
        return out, AttnResiduals(out=out, m=m.reshape(B, H, Sq),
                                  l=l.reshape(B, H, Sq))
    return out


def merge_lse(parts: list[AttnResiduals]) -> torch.Tensor:
    """Merge attention partials computed over disjoint KV shards (the
    reference's ``merge_lse``).  Each part's ``out`` (in q's type) is
    normalized by its own ``l``; in fp32 each is weighted by w_i = l_i
    exp(min(m_i - m*, 0)) with m* the largest m, and the sum divided by
    max(sum w_i, 1e-30): a shard with no live row (l = 0) adds nothing.
    Returns (B, Sq, H, D) in the parts' type."""
    m_star = parts[0].m
    for p in parts[1:]:
        m_star = torch.maximum(m_star, p.m)
    num = 0.0
    den = 0.0
    for p in parts:
        w = p.l * torch.exp(torch.clamp(p.m - m_star, max=0.0))   # (B, H, Sq)
        w = w.transpose(1, 2)[..., None]
        num = num + p.out.float() * w
        den = den + w
    return (num / torch.clamp(den, min=1e-30)).to(parts[0].out.dtype)


def attn_output(cfg, params, attn: torch.Tensor) -> torch.Tensor:
    """attn: (B, S, H, hd) -> (B, S, D)."""
    h, k, d = params["wo"].shape
    return matmul(attn.flatten(-2), params["wo"].to(attn.dtype).reshape(h * k, d))
