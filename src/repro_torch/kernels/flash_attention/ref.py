"""Plain PyTorch versions of dense flash attention (counterpart of
``repro/kernels/flash_attention/ref.py``): the chunked online-softmax
attention, queries at positions 0 .. S-1 and keys at 0 .. S_kv-1 (S_kv = S
when causal), with each row's log-sum-exp when asked; and its backward, as
explicit formulas in fp32, at the same lengths."""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers.attention import NEG_INF, chunked_attention


def check_kv_length(q, k, *, causal: bool, what: str = "flash_attention") -> int:
    """k's length ``S_kv``; raise where the kernel (forward or backward)
    cannot take it: at ``S_kv != S`` when causal (the reference never asks
    for it), or zero rows for queries to attend."""
    S, S_kv = q.shape[1], k.shape[1]
    if causal and S_kv != S:
        raise ValueError(f"{what}: causal attention takes k and v at q's length "
                         f"{S}, not {S_kv}")
    if S and not S_kv:
        raise ValueError(f"{what}: no key rows for {S} queries")
    return S_kv


def _wide(t):
    """t in fp32, or as it is when wider (fp64: to measure fp32's rounding)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q, k, causal):
    """(B, H, S, S_kv) scaled scores, fp32 (fp64 for fp64 inputs), of q
    (B, S, H, D) against k (B, S_kv, K, D) read by GQA (query head h on kv
    head h // G), masked to NEG_INF past the diagonal when causal (S_kv =
    S)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kf = _wide(k).repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), kf) / math.sqrt(D)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    return s


def attention_lse(q, k, *, causal=True):
    """Each query row's log-sum-exp of its scaled, masked scores: (B, H, S)
    fp32, what the kernel writes beside its output."""
    return torch.logsumexp(_scores(q, k, causal), dim=-1)


def flash_attention_ref(q, k, v, *, causal=True, chunk=512, with_lse=False):
    """q: (B, S, H, D); k/v: (B, S_kv, K, D), H % K == 0, S_kv = S when
    causal.  Returns (B, S, H, D) and, ``with_lse``, the (B, H, S) fp32
    log-sum-exp of each row."""
    check_kv_length(q, k, causal=causal)
    out = chunked_attention(q, k, v, causal=causal, chunk=chunk)
    if with_lse:
        return out, attention_lse(q, k, causal=causal)
    return out


def flash_attention_backward_ref(q, k, v, out, dout, lse, *, causal=True):
    """The gradient of :func:`flash_attention_ref`'s output with respect to
    q, k and v, given ``dout`` (the output's gradient) and the forward's
    ``out`` and ``lse``, in the flash-attention-2 form the kernel computes:
    P rebuilt from q, k and lse, D = rowsum(dO o O), dS = P o (dP - D), the
    G query heads of a group summed into their kv head.  Every product in
    fp32 (fp64 for fp64 inputs); returns (dq, dk, dv) in the inputs'
    dtype.  k and v (B, S_kv, K, D): ``S_kv != S`` only when not causal,
    as the forward."""
    S_kv = check_kv_length(q, k, causal=causal, what="flash_attention_backward")
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    p = torch.exp(_scores(q, k, causal) - _wide(lse)[..., None])     # (B, H, S, S_kv)
    do = _wide(dout).transpose(1, 2)                                 # (B, H, S, D)
    vf = _wide(v).repeat_interleave(G, dim=2).transpose(1, 2)
    kf = _wide(k).repeat_interleave(G, dim=2).transpose(1, 2)
    qf = _wide(q).transpose(1, 2)
    delta = (do * _wide(out).transpose(1, 2)).sum(-1)                # (B, H, S)
    ds = p * (do @ vf.transpose(-1, -2) - delta[..., None])
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p.transpose(-1, -2) @ do

    def per_kv(t):        # (B, H, S_kv, D) -> (B, S_kv, K, D), the group summed
        return t.transpose(1, 2).reshape(B, S_kv, K, G, D).sum(3)
    return (dq.transpose(1, 2).to(q.dtype), per_kv(dk).to(k.dtype),
            per_kv(dv).to(v.dtype))
