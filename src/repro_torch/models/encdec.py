"""Whisper-style encoder-decoder backbone (counterpart of
``repro/models/encdec.py``), served from contiguous caches and trained.

The audio frontend (log-mel and the conv stem) is a stub, as in the
reference: ``frames`` are precomputed frame embeddings (B, F, D).
Positions are sinusoidal additive embeddings (:func:`sinusoid`).

Decode state (:class:`EncDecState`): each decoder layer's self-attention
KV cache, grown a row a step, and its cross-attention K/V, projected once
from the encoder's output at prefill.

Kernels on the path (the CUDA kernels on the card, their plain versions on
the CPU): the encoder's non-causal self-attention over the F frames, the
decoder's causal self-attention and its cross-attention (S prompt rows
against F encoder rows, K4 taking a KV length of its own) through
``flash_attention`` (K4) at prefill; at decode the self-attention through
``seq_sharded_decode_attention`` (its row write, then K3) and the
cross-attention through K3 directly, one query row against the F fixed
rows.  Every weight product goes through K7
(:mod:`repro_torch.models.layers.linear`).

Differences from the reference: ``lax.scan`` over the stacked layers is a
Python loop, and the decode step writes the self-attention rows **in
place** (the reference returns new caches).  At prefill the reference
projects the encoder output through each layer's cross-attention wq, wk
and wv twice, in ``cross_kv`` and again in ``_dec_block`` (whose q it
discards); the port projects K and V once (:func:`cross_kv`) and reuses
them, and never makes the discarded q: the same numbers, since K7 gives
the same bits for the same operands.

Training (:func:`forward` with ``remat``): every K4 call is differentiable
through its backward kernel -- the encoder's at S = S_kv = F, the
decoder's causal self-attention, its cross-attention at S against S_kv =
F.  Under any ``cfg.remat`` but ``"none"`` each encoder block and each
decoder block runs under ``torch.utils.checkpoint`` (non-reentrant): only
its input is kept, and the backward runs it again.  The reference
checkpoints both with ``nothing_saveable`` whatever the policy's name, so
``"dots"`` trains exactly as ``"full"`` does, there and here.  The
reference projects each layer's cross K/V from the encoder output inside
its checkpointed decoder block, so its recompute projects them again; the
port projects them once a forward, outside the checkpoints
(:func:`cross_kv`), and keeps them for the backward (2 x L x F x K x D in
the compute dtype a sequence: 147 MB at whisper-medium's widths in bf16):
the same numbers, and 2 L fewer K7 launches in the recompute.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.common import dtype_of
from repro_torch.distributed.collectives import seq_sharded_decode_attention
from repro_torch.distributed.sharding import require_whole
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import attention as A
from repro_torch.models.layers.embedding import embed, embedding_table
from repro_torch.models.layers.embedding import logits as lm_logits
from repro_torch.models.layers.mlp import gelu_mlp, gelu_mlp_table
from repro_torch.models.layers.module import (cast_product_weights, init_table,
                                              stack_table)
from repro_torch.models.layers.norms import apply_norm, head_rmsnorm, norm_table
from repro_torch.models.transformer import _unstack_layers


class EncDecState(NamedTuple):
    """Decode state: self_k/self_v (L, B, S, K, D) the decoder's caches;
    cross_k/cross_v (L, B, F, K, D) its cross-attention K/V; length (B,)
    int32 valid self-attention rows (the next row is written there)."""
    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    length: torch.Tensor


def sinusoid(seq: int, d: int, offset=0, device=None) -> torch.Tensor:
    """Sinusoidal position embedding, fp32: (seq, d) at positions
    offset + [0, seq) for an int offset, (B, seq, d) for a (B,) tensor of
    per-row offsets (the reference's ``vmap`` at decode).  Computed in
    fp32 as the reference does: the frequencies ``exp(-log(1e4) * i /
    max(d/2 - 1, 1))``, then sin and cos of position times frequency."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    freqs = torch.exp(torch.tensor(-np.log(10_000.0), dtype=torch.float32,
                                   device=device) * i / max(half - 1, 1))
    pos = torch.arange(seq, dtype=torch.float32, device=device)
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        pos = pos[None] + offset.to(device=device, dtype=torch.float32)[:, None]
    else:
        pos = pos + torch.as_tensor(offset, dtype=torch.float32, device=device)
    ang = pos[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def enc_block_table(cfg):
    return {"ln1": norm_table(cfg), "attn": A.attention_table(cfg),
            "ln2": norm_table(cfg), "mlp": gelu_mlp_table(cfg.d_model, cfg.d_ff)}


def dec_block_table(cfg):
    return {"ln1": norm_table(cfg), "self_attn": A.attention_table(cfg),
            "ln2": norm_table(cfg), "cross_attn": A.cross_attention_table(cfg),
            "ln3": norm_table(cfg), "mlp": gelu_mlp_table(cfg.d_model, cfg.d_ff)}


def lm_table(cfg):
    return {
        "embed": embedding_table(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings),
        "enc_blocks": stack_table(enc_block_table(cfg),
                                  cfg.encdec.num_encoder_layers),
        "enc_ln_f": norm_table(cfg),
        "dec_blocks": stack_table(dec_block_table(cfg), cfg.num_layers),
        "dec_ln_f": norm_table(cfg),
    }


def init(cfg, generator: torch.Generator):
    """Parameters in ``cfg.param_dtype`` on ``generator``'s device, with the
    reference's names and stacked ``(L, ...)`` shapes."""
    return init_table(generator, lm_table(cfg), cfg.param_dtype)


# the weights the reference casts to the compute dtype before each product
# (and the biases it adds to their results)
_PRODUCT_WEIGHTS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv",
                    "w_in", "b_in", "w_out", "b_out")


def prepare_params(cfg, params, device=None):
    """Move ``params`` to ``device`` and cast every weight that enters a
    product (and the biases added to its result) to the compute dtype,
    once; the norms and the embedding stay in ``param_dtype``, as the
    reference computes them in fp32."""
    return cast_product_weights(params, _PRODUCT_WEIGHTS, cfg.compute_dtype,
                                device)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _checkpointed(cfg, remat) -> bool:
    """Whether the training forward checkpoints its blocks: ``remat`` asked
    and any policy but ``"none"`` (``"dots"`` as ``"full"``, as the
    reference)."""
    return bool(remat) and cfg.remat != "none"


def _enc_block(cfg, p, x, chunk):
    """One encoder block: non-causal self-attention over the F frames
    through K4, no RoPE, then the GELU MLP."""
    a = apply_norm(cfg, p["ln1"], x)
    q, k, v = A.qkv_project(cfg, p["attn"], a, None)
    attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=False, chunk=chunk)
    x = x + A.attn_output(cfg, p["attn"], attn)
    return x + gelu_mlp(p["mlp"], apply_norm(cfg, p["ln2"], x))


def encode(cfg, params, frames: torch.Tensor, *, remat=False,
           chunk=1024) -> torch.Tensor:
    """frames: (B, F, D) precomputed embeddings -> (B, F, D) in the compute
    dtype: each layer's non-causal self-attention over the F frames through
    K4, no RoPE; each block checkpointed where ``remat`` asks for it."""
    B, F, D = frames.shape
    x = frames.to(dtype_of(cfg.compute_dtype))
    x = x + sinusoid(F, D, device=x.device).to(x.dtype)[None]
    ckpt = _checkpointed(cfg, remat)
    for p in _unstack_layers(params["enc_blocks"], cfg.encdec.num_encoder_layers):
        x = (checkpoint(_enc_block, cfg, p, x, chunk, use_reentrant=False) if ckpt
             else _enc_block(cfg, p, x, chunk))
    return apply_norm(cfg, params["enc_ln_f"], x)


def _kv_project(cfg, p, x):
    """k and v of ``qkv_project`` (bias, k's qk-norm), without its q."""
    dt = x.dtype
    k = A._proj(x, p["wk"])
    v = A._proj(x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        k = head_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def cross_kv(cfg, params, enc_out: torch.Tensor):
    """Each decoder layer's cross-attention K/V from the encoder output:
    (L, B, F, K, D) each, in enc_out's type."""
    kv = [_kv_project(cfg, p["cross_attn"], enc_out)
          for p in _unstack_layers(params["dec_blocks"], cfg.num_layers)]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _dec_block(cfg, p, x, cross, *, cache=None, cross_len=None, chunk=1024):
    """One decoder block.  cross: this layer's (k, v) (B, F, K, D).

    Without ``cache`` (the whole prompt from position 0): causal
    self-attention through K4, the cross-attention through K4 at S_kv = F;
    returns (x, k, v), this layer's fresh self-attention K/V.  With
    ``cache`` (ck, cv, kv_len) (decode, x (B, 1, D)): the new row written
    at ``kv_len`` and attention over the cache through
    ``seq_sharded_decode_attention`` (K3), the cross-attention through K3
    with ``cross_len`` (B,) = F rows; returns (x, None, None)."""
    dt = x.dtype
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = A.qkv_project(cfg, p["self_attn"], h, None)
    if cache is None:
        attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True, chunk=chunk)
    else:
        ck, cv, kv_len = cache
        attn = seq_sharded_decode_attention(q, ck, cv, k, v, kv_len, chunk=chunk)[0]
        k = v = None
    x = x + A.attn_output(cfg, p["self_attn"], attn)

    h2 = apply_norm(cfg, p["ln2"], x)
    pc = p["cross_attn"]
    q2 = A._proj(h2, pc["wq"])
    if cfg.qkv_bias:
        q2 = q2 + pc["bq"].to(dt)
    xk, xv = cross[0].to(dt), cross[1].to(dt)
    if cache is None:
        cattn = flash_attention(q2.contiguous(), xk.contiguous(), xv.contiguous(),
                                causal=False, chunk=chunk)
    else:
        cattn = decode_attention(q2[:, 0].contiguous(), xk, xv, cross_len,
                                 chunk=chunk)[:, None]
    x = x + A.attn_output(cfg, pc, cattn)
    x = x + gelu_mlp(p["mlp"], apply_norm(cfg, p["ln3"], x))
    return x, k, v


def _decoder(cfg, params, tokens, cross_k, cross_v, *, state=None, remat=False,
             chunk=1024):
    """Embed, add the sinusoid at each row's position (from 0, or from
    ``state.length`` per row at decode), run every decoder layer and the
    final norm.  Returns (x, [(k, v)] of each layer without a state; with
    ``remat`` -- training, each block checkpointed -- no (k, v))."""
    B, Sq = tokens.shape
    x = embed(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    off = state.length if state is not None else 0
    x = x + sinusoid(Sq, cfg.d_model, off, device=x.device).to(x.dtype)
    layers = _unstack_layers(params["dec_blocks"], cfg.num_layers)
    kv = []
    cross_len = None
    if state is not None:
        cross_len = torch.full((B,), cross_k.shape[2], dtype=torch.int32,
                               device=x.device)
    ckpt = state is None and _checkpointed(cfg, remat)
    for i, p in enumerate(layers):
        cross = (cross_k[i], cross_v[i])
        if ckpt:      # training: the block's output alone, its K/V recomputed
            x = checkpoint(_dec_block, cfg, p, x, cross, chunk=chunk, use_reentrant=False)[0]
            continue
        cache = (None if state is None
                 else (state.self_k[i], state.self_v[i], state.length))
        x, k, v = _dec_block(cfg, p, x, cross, cache=cache, cross_len=cross_len, chunk=chunk)
        kv.append((k, v))
    return apply_norm(cfg, params["dec_ln_f"], x), kv


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward(cfg, params, tokens, frames, *, remat=True, chunk=1024):
    """Training: the encoder on ``frames`` (B, F, D) and the decoder's full
    logits (B, S, V) fp32 for ``tokens`` (B, S), and a zero aux loss.
    Differentiable (``params`` may be fp32 master weights, each product
    weight cast to the compute dtype at use); ``remat`` checkpoints every
    encoder and decoder block unless ``cfg.remat`` is ``"none"``, the
    cross K/V projected once outside them."""
    enc_out = encode(cfg, params, frames, remat=remat, chunk=chunk)
    xk, xv = cross_kv(cfg, params, enc_out)
    x, _ = _decoder(cfg, params, tokens, xk, xv, remat=remat, chunk=chunk)
    lg = lm_logits(params["embed"], x, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg, torch.zeros((), dtype=torch.float32, device=lg.device)


def prefill(cfg, params, tokens, frames, *, cache_dtype="bfloat16",
            max_len=None, chunk=1024):
    """Encode ``frames`` (B, F, D), project each layer's cross K/V once and
    run the prompts ``tokens`` (B, S) from position 0: logits (B, V) fp32
    at the last position, and an :class:`EncDecState` in ``cache_dtype``
    whose self caches are grown to ``max_len`` rows (default S), with
    ``length`` S.  The cross-attention reads K/V in the compute dtype here,
    the state's ``cache_dtype`` copies at decode, as the reference's."""
    B, Sq = tokens.shape
    require_whole("kv_seq", "the decoder's self-attention cache")
    cdt = dtype_of(cache_dtype)
    enc_out = encode(cfg, params, frames, chunk=chunk)
    xk, xv = cross_kv(cfg, params, enc_out)
    x, kv = _decoder(cfg, params, tokens, xk, xv, chunk=chunk)
    max_len = max_len or Sq

    def grow(rows):
        out = torch.zeros((len(rows), B, max_len, *rows[0].shape[2:]),
                          dtype=cdt, device=x.device)
        for i, r in enumerate(rows):
            out[i, :, :Sq] = r
        return out
    st = EncDecState(self_k=grow([k for k, _ in kv]), self_v=grow([v for _, v in kv]),
                     cross_k=xk.to(cdt), cross_v=xv.to(cdt),
                     length=torch.full((B,), Sq, dtype=torch.int32, device=x.device))
    lg = lm_logits(params["embed"], x[:, -1:], cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg[:, 0], st


def decode_step(cfg, params, tokens, state: EncDecState, *, chunk=2048):
    """One decode step.  tokens: (B, 1) -> logits (B, V) fp32, and the state
    with the new self-attention rows written in place and ``length``
    advanced by one."""
    x, _ = _decoder(cfg, params, tokens, state.cross_k, state.cross_v,
                    state=state, chunk=chunk)
    lg = lm_logits(params["embed"], x, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg[:, 0], state._replace(length=state.length + 1)


def init_decode_state(cfg, batch: int, max_len: int, cache_dtype="bfloat16", *,
                      device="cuda") -> EncDecState:
    """Zero caches for ``batch`` slots: self caches of ``max_len`` rows,
    cross K/V of the config's F encoder frames, ``length`` 0."""
    require_whole("kv_seq", "the decoder's self-attention cache")
    cdt = dtype_of(cache_dtype)
    hd = cfg.resolved_head_dim
    L, F, K = cfg.num_layers, cfg.encdec.num_encoder_frames, cfg.num_kv_heads

    def zeros(rows):
        return torch.zeros((L, batch, rows, K, hd), dtype=cdt, device=device)
    return EncDecState(self_k=zeros(max_len), self_v=zeros(max_len),
                       cross_k=zeros(F), cross_v=zeros(F),
                       length=torch.zeros((batch,), dtype=torch.int32, device=device))
