"""Zamba2-style hybrid: a Mamba-2 backbone with one weight-shared attention
block applied every ``shared_attn_every`` layers (counterpart of
``repro/models/hybrid.py``, serving path).

Structure (L layers, e = shared_attn_every):
  [e mamba layers -> shared attn+MLP block] x (L // e)  +  (L % e) mamba tail

The shared block's weights exist once; each application has its own
contiguous KV cache.  Decode state: per-layer Mamba states plus one KV
cache per shared-block application.

Kernels on the path (the CUDA kernels on the card, their plain versions on
the CPU): the Mamba-2 scan through ``ssm_scan`` (K5, one launch per Mamba
layer), the shared block's causal attention through ``flash_attention``
(K4, one per application) and its decode attention through the dense
``decode_attention`` (K3, one per application and step).  The reference
computes all three with its plain functions (``chunked_linear_attn``,
``chunked_attention``).  Training (:func:`forward`) runs K5 and K4 through
their differentiable wrappers, whose backward is a hand-written kernel
each, where the reference differentiates its plain functions.

Differences from the reference: ``lax.scan`` over the stacked layers is a
Python loop; decode writes the KV rows and the SSM states **in place**
(the reference returns new arrays) and returns the state, which holds the
updated tensors.  The conv histories come back as new tensors in the type
the step computes them in, as the reference's scan returns them.  Under
``remat`` each segment (its Mamba layers and the shared block) runs under
``torch.utils.checkpoint`` where the reference ``jax.checkpoint``s its
``seg_body``; the tail layers do not, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import dtype_of
from repro_torch.distributed.collectives import seq_sharded_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import attention as A
from repro_torch.models.layers import ssm as S
from repro_torch.models.layers.embedding import embed, embedding_table
from repro_torch.models.layers.embedding import logits as lm_logits
from repro_torch.models.layers.linear import matmul
from repro_torch.models.layers.mlp import swiglu, swiglu_table
from repro_torch.models.layers.module import (cast_product_weights,
                                              init_table, stack_table,
                                              tree_map, weight)
from repro_torch.models.layers.norms import apply_norm, norm_table
from repro_torch.models.transformer import _PRODUCT_WEIGHTS as _TF_WEIGHTS
from repro_torch.models.transformer import _unstack_layers, check_row_positions


class HybridState(NamedTuple):
    """Decode state: stacked Mamba states + per-application KV caches."""
    conv_seg: torch.Tensor    # (n_seg, e, B, K-1, ch)
    ssm_seg: torch.Tensor     # (n_seg, e, B, H, N, P) fp32
    conv_tail: torch.Tensor   # (tail, B, K-1, ch)
    ssm_tail: torch.Tensor    # (tail, B, H, N, P) fp32
    kv_k: torch.Tensor        # (n_seg, B, S, Kh, D)
    kv_v: torch.Tensor
    length: torch.Tensor      # (B,) int32


def _segments(cfg) -> tuple[int, int, int]:
    e = cfg.shared_attn_every
    n_seg = cfg.num_layers // e
    tail = cfg.num_layers - n_seg * e
    return n_seg, e, tail


def mamba_layer_table(cfg):
    return {"norm": norm_table(cfg), "mamba": S.mamba_table(cfg)}


def shared_block_table(cfg):
    return {
        "in_proj": weight((2 * cfg.d_model, cfg.d_model), ("embed", None)),
        "ln1": norm_table(cfg),
        "attn": A.attention_table(cfg),
        "ln2": norm_table(cfg),
        "mlp": swiglu_table(cfg.d_model, cfg.d_ff),
    }


def lm_table(cfg):
    n_seg, e, tail = _segments(cfg)
    t = {
        "embed": embedding_table(cfg.vocab_size, cfg.d_model,
                                 cfg.tie_embeddings),
        "seg_blocks": stack_table(stack_table(mamba_layer_table(cfg), e),
                                  n_seg),
        "shared": shared_block_table(cfg),
        "ln_f": norm_table(cfg),
    }
    if tail:
        t["tail_blocks"] = stack_table(mamba_layer_table(cfg), tail)
    return t


def init(cfg, generator: torch.Generator):
    """Parameters in ``cfg.param_dtype`` on ``generator``'s device, with the
    reference's names and stacked ``(n_seg, e, ...)`` / ``(tail, ...)``
    shapes."""
    return init_table(generator, lm_table(cfg), cfg.param_dtype)


# weights the reference casts to the compute dtype before each product:
# the attention and MLP ones, the shared block's and each Mamba layer's
# in_proj, the Mamba out_proj and the depthwise conv's weight and bias
_PRODUCT_WEIGHTS = _TF_WEIGHTS + ("in_proj", "out_proj", "conv_w", "conv_b")


def prepare_params(cfg, params, device=None):
    """Move ``params`` to ``device`` and cast every weight that the
    reference casts to the compute dtype before a product, once.  Norm
    scales, ``a_log``, ``d_skip``, ``dt_bias`` and the embedding stay in
    ``param_dtype``: the reference computes with them in fp32."""
    return cast_product_weights(params, _PRODUCT_WEIGHTS, cfg.compute_dtype,
                                device)


def _mamba_residual(cfg, p, x, state=None, step=False, want_state=False):
    h = apply_norm(cfg, p["norm"], x)
    if step:
        out, new_state = S.mamba_step(cfg, p["mamba"], h, state)
        return x + out, new_state
    if want_state:
        out, new_state = S.mamba_forward(cfg, p["mamba"], h, state,
                                         return_state=True)
        return x + out, new_state
    return x + S.mamba_forward(cfg, p["mamba"], h), None


def _shared_attn(cfg, p, x, e0, positions, *, cache_k=None, cache_v=None,
                 kv_len=None, chunk=1024):
    """Apply the shared attention+MLP block.  Returns (x, new_k, new_v).

    Prefill (no cache): causal attention over the whole prompt through
    ``flash_attention``, whose queries and keys sit at positions 0..S-1
    -- the prefill's ``positions``.  Decode: the new row is written into
    the contiguous cache and attended through the dense decode kernel."""
    z = matmul(torch.cat([x, e0], dim=-1), p["in_proj"].to(x.dtype))
    h = apply_norm(cfg, p["ln1"], z)
    q, k, v = A.qkv_project(cfg, p["attn"], h, positions)
    if cache_k is None:
        attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True, chunk=chunk)
        nk, nv = k, v
    else:
        attn, nk, nv = seq_sharded_decode_attention(
            q, cache_k, cache_v, k, v, kv_len, chunk=chunk)
    x = x + A.attn_output(cfg, p["attn"], attn)
    h2 = apply_norm(cfg, p["ln2"], x)
    return x + swiglu(p["mlp"], h2), nk, nv


def _layer(blocks, *idx):
    return tree_map(lambda leaf: leaf[idx], blocks)


def _stacked(leaves, lead, empty):
    """Per-layer tensors stacked into the ``(*lead, ...)`` layout of the
    state; ``empty`` when there are none (no tail)."""
    if not leaves:
        return empty
    return torch.stack(leaves).reshape(*lead, *leaves[0].shape)


def _segment(cfg, layers, shared_p, x, e0, positions, chunk):
    """One segment of the training forward: its Mamba layers, then the
    shared block (the reference's ``seg_body`` without the states)."""
    for p in layers:
        x, _ = _mamba_residual(cfg, p, x)
    return _shared_attn(cfg, shared_p, x, e0, positions, chunk=chunk)[0]


def _forward_core(cfg, params, tokens, positions, *, remat=False,
                  collect=False, chunk=1024):
    """Embed, the segments (Mamba layers then the shared block), the tail,
    the final norm.  Returns (x, HybridState or None); the state's KV
    caches are the prompt's rows only (:func:`prefill` grows them).

    ``remat`` (training) with any ``cfg.remat`` but ``"none"`` runs each
    segment under ``torch.utils.checkpoint`` (non-reentrant): only its
    input is kept, and the backward runs it again, K5 and K4 included.
    The reference checkpoints its segments with ``nothing_saveable``
    whatever the policy's name, so ``"dots"`` trains exactly as ``"full"``
    does there, and here."""
    policy = cfg.remat if remat else "none"
    if collect and policy != "none":
        raise ValueError("the decode state is collected without remat")
    n_seg, e, tail = _segments(cfg)
    x = embed(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    e0 = x
    shared_p = params["shared"]
    states, ks, vs = [], [], []
    for seg in _unstack_layers(params["seg_blocks"], n_seg):
        layers = _unstack_layers(seg, e)
        if policy != "none":
            x = checkpoint(_segment, cfg, layers, shared_p, x, e0, positions,
                           chunk, use_reentrant=False)
            continue
        for p in layers:
            x, st = _mamba_residual(cfg, p, x, want_state=collect)
            states.append(st)
        x, nk, nv = _shared_attn(cfg, shared_p, x, e0, positions,
                                 chunk=chunk)
        ks.append(nk)
        vs.append(nv)
    tail_states = []
    for p in (_unstack_layers(params["tail_blocks"], tail) if tail else []):
        x, st = _mamba_residual(cfg, p, x, want_state=collect)
        tail_states.append(st)
    x = apply_norm(cfg, params["ln_f"], x)
    if not collect:
        return x, None
    B = tokens.shape[0]

    def field(sts, name, lead):
        ref = getattr(states[0], name)
        return _stacked([getattr(s, name) for s in sts], lead,
                        ref.new_zeros((0, *ref.shape)))

    return x, HybridState(
        conv_seg=field(states, "conv", (n_seg, e)),
        ssm_seg=field(states, "ssm", (n_seg, e)),
        conv_tail=field(tail_states, "conv", (tail,)),
        ssm_tail=field(tail_states, "ssm", (tail,)),
        kv_k=torch.stack(ks), kv_v=torch.stack(vs),
        length=torch.full((B,), tokens.shape[1], dtype=torch.int32,
                          device=tokens.device))


def forward(cfg, params, tokens, positions=None, *, remat=True, chunk=1024):
    """Training forward.  tokens: (B, S) -> full logits (B, S, V) fp32 and
    the aux loss (0, as the reference's).  ``params`` are the fp32 master
    weights, each product weight cast to the compute dtype at use; the
    Mamba scans run K5 and the shared block's attention K4, both with
    their backward kernels.  Given ``positions`` must be 0..S-1 (K4 masks
    by row)."""
    if positions is None:
        B, Sq = tokens.shape
        positions = torch.arange(Sq, dtype=torch.int32,
                                 device=tokens.device).expand(B, Sq)
    else:
        check_row_positions(positions)
    x, _ = _forward_core(cfg, params, tokens, positions, remat=remat,
                         chunk=chunk)
    lg = lm_logits(params["embed"], x, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg, torch.zeros((), dtype=torch.float32, device=lg.device)


def prefill(cfg, params, tokens, positions=None, *, cache_dtype="bfloat16",
            max_len: int | None = None, chunk=1024):
    """Prefill the prompt ``tokens`` (B, S) from position 0.  Returns ((B, V)
    fp32 logits of the last token, HybridState) with KV caches of
    ``cache_dtype`` grown to ``max_len`` rows (default S)."""
    B, Sq = tokens.shape
    if positions is None:
        positions = torch.arange(Sq, dtype=torch.int32,
                                 device=tokens.device).expand(B, Sq)
    x, st = _forward_core(cfg, params, tokens, positions, collect=True,
                          chunk=chunk)
    cdt = dtype_of(cache_dtype)
    max_len = max_len or Sq

    def grow(c):
        out = torch.zeros((*c.shape[:2], max_len, *c.shape[3:]), dtype=cdt,
                          device=c.device)
        out[:, :, :Sq] = c
        return out
    st = st._replace(kv_k=grow(st.kv_k), kv_v=grow(st.kv_v))
    lg = lm_logits(params["embed"], x[:, -1:], cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg[:, 0], st


def decode_step(cfg, params, tokens, state: HybridState, *, chunk=2048):
    """tokens: (B, 1).  One step through the whole stack: logits (B, V)
    fp32 and the state, KV rows and SSM states written in place, conv
    histories new, ``length`` advanced by one."""
    n_seg, e, tail = _segments(cfg)
    x = embed(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    e0 = x
    positions = state.length[:, None]
    shared_p = params["shared"]
    conv_seg = []
    for i in range(n_seg):
        for j in range(e):
            x, nst = _mamba_residual(
                cfg, _layer(params["seg_blocks"], i, j), x,
                state=S.MambaState(state.conv_seg[i, j], state.ssm_seg[i, j]),
                step=True)
            conv_seg.append(nst.conv)
            state.ssm_seg[i, j] = nst.ssm
        x, _, _ = _shared_attn(cfg, shared_p, x, e0, positions,
                               cache_k=state.kv_k[i], cache_v=state.kv_v[i],
                               kv_len=state.length, chunk=chunk)
    conv_tail = []
    for j in range(tail):
        x, nst = _mamba_residual(
            cfg, _layer(params["tail_blocks"], j), x,
            state=S.MambaState(state.conv_tail[j], state.ssm_tail[j]),
            step=True)
        conv_tail.append(nst.conv)
        state.ssm_tail[j] = nst.ssm
    x = apply_norm(cfg, params["ln_f"], x)
    lg = lm_logits(params["embed"], x, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg[:, 0], state._replace(
        conv_seg=_stacked(conv_seg, (n_seg, e), state.conv_seg),
        conv_tail=_stacked(conv_tail, (tail,), state.conv_tail),
        length=state.length + 1)


def init_decode_state(cfg, batch: int, max_len: int, cache_dtype="bfloat16",
                      *, device="cuda") -> HybridState:
    n_seg, e, tail = _segments(cfg)
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    h = s.num_heads(cfg.d_model)
    ch = d_in + 2 * s.d_state
    cdt = dtype_of(cache_dtype)
    hd = cfg.resolved_head_dim

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)
    return HybridState(
        conv_seg=zeros((n_seg, e, batch, s.d_conv - 1, ch), cdt),
        ssm_seg=zeros((n_seg, e, batch, h, s.d_state, s.head_dim),
                      torch.float32),
        conv_tail=zeros((tail, batch, s.d_conv - 1, ch), cdt),
        ssm_tail=zeros((tail, batch, h, s.d_state, s.head_dim),
                       torch.float32),
        kv_k=zeros((n_seg, batch, max_len, cfg.num_kv_heads, hd), cdt),
        kv_v=zeros((n_seg, batch, max_len, cfg.num_kv_heads, hd), cdt),
        length=zeros((batch,), torch.int32))
