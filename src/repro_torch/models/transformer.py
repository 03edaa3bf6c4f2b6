"""Decoder-only transformer LM: the training forward and serving from
contiguous caches or a paged KV pool (counterpart of
``repro/models/transformer.py``, dense, MoE and vlm families).

Entry points:
  * ``init``          -- parameters from a seeded ``torch.Generator``, with
    the reference's names and stacked ``(L, ...)`` shapes.
  * ``forward``       -- training forward: full (B, S, V) fp32 logits, every
    block under ``torch.utils.checkpoint`` when ``cfg.remat`` asks for it.
  * ``prefill``       -- the whole prompt from position 0: last-position
    logits and a contiguous :class:`KVCache` grown to ``max_len`` rows.
  * ``prefill_paged`` -- one prompt chunk written *directly* into paged pool
    blocks, attending over already-seeded blocks, so shared prefixes and
    resumed histories are never recomputed.
  * ``verify_paged``  -- the speculative-decoding verify pass: ``k + 1``
    candidate rows per sequence scored in one call, logits at every row.
  * ``decode_step``   -- one token per slot against any of the four caches.

Contiguous caches are bf16 / fp32 (:class:`KVCache`, ``(L, B, S, K, D)``)
or int8 with one fp32 absmax scale per (slot, row, kv head)
(:class:`QuantKVCache`).  The paged pool is bf16 / fp32
(:class:`PagedKVCache`) or int8 with one scale per (block, row, kv head)
(:class:`QuantPagedKVCache`).  int8 rows are quantized on write
(:func:`quantize_kv`) and dequantized to the compute dtype before the
attention, as the reference does.

Serving attends through the hand-written CUDA kernels
(:mod:`repro_torch.kernels`) when the tensors are on the card, and through
their plain PyTorch versions on the CPU: ``prefill`` through the dense
flash kernel (K4), a contiguous decode through the dense decode kernel
(K3), the paged paths through K1 and K2.  Every weight product, in serving
and in training, goes through the K7 matmul kernel
(:mod:`repro_torch.models.layers.linear`); a mixture-of-experts block's
experts run K7's batched entry, all experts in one launch a product
(:mod:`repro_torch.models.layers.moe`), and DeepSeekMoE's first
``first_k_dense`` layers are dense blocks of their own (``dense_blocks``)
ahead of the stack, as the reference's.  Training attention goes
through K4 as well, differentiable: its backward is a hand-written kernel
(``csrc/flash_attention_backward.cu``), where the reference differentiates
its plain ``chunked_attention``.  The caller picks the kernel by the
branch of ``_apply_backbone`` it takes, never by the device.

The vlm family (qwen2-vl) rotates q and k by M-RoPE: every entry point
builds (3, B, S) positions, three equal streams for text, as the
reference's m_rope branches do.  The reference masks attention by stream 0
(the temporal ids); K4 and K2 mask by row index and by ``q_start``, which
agree with it where stream 0 is each row's position -- the streams the
engine builds.  A caller's positions whose stream 0 is not each row's
index raise (:func:`check_row_positions`); streams 1 and 2 are free (the
vision frontend that sets them is a stub).

Differences from the reference: ``lax.scan`` over the stacked layers is a
Python loop, and cache and pool writes happen **in place** (the
reference's ``.at[].set`` returns new arrays).  The functions still return
the cache, which holds the same (updated) tensors.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import dtype_of
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.collectives import seq_sharded_decode_attention
from repro_torch.distributed.sharding import current_mesh, current_rules, seq_rows
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.dispatch import check_scales
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.prefill_attention.ops import paged_prefill_attention
from repro_torch.models.layers import attention as A
from repro_torch.models.layers import linear
from repro_torch.models.layers import moe as MOE
from repro_torch.models.layers.embedding import embed, embedding_table
from repro_torch.models.layers.embedding import logits as lm_logits
from repro_torch.models.layers.mlp import swiglu, swiglu_table
from repro_torch.models.layers.module import (cast_product_weights, init_table,
                                              stack_table, tree_map)
from repro_torch.models.layers.norms import apply_norm, norm_table


class KVCache(NamedTuple):
    """Stacked per-layer contiguous KV cache.  k/v: (L, B, S, K, D);
    length: (B,) int32 valid rows (the next row is written there)."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


class QuantKVCache(NamedTuple):
    """int8 variant of :class:`KVCache`, quantized per (slot, row, kv head)
    with absmax scales.  k/v: (L, B, S, K, D) int8; k_scale/v_scale: (L, B,
    S, K) fp32."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    length: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


class PagedKVCache(NamedTuple):
    """Paged KV cache: one global pool of fixed-size blocks shared by every
    decode slot, indexed through per-slot block tables.

    k/v: (L, N_blocks, block_size, K, D) -- block 0 is the trash block that
    retired slots write into; block_tables: (B, max_blocks) int32 physical
    block id per logical block, 0 where unassigned; length: (B,) int32
    valid KV rows.
    """
    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    length: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_len(self) -> int:
        """Max addressable rows per sequence (table width x block size)."""
        return self.block_tables.shape[1] * self.k.shape[2]


class QuantPagedKVCache(NamedTuple):
    """int8 variant of :class:`PagedKVCache`: the pools are int8 with absmax
    scales per (block, row, kv head).  k/v: (L, N, bs, K, D) int8;
    k_scale/v_scale: (L, N, bs, K) fp32."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    block_tables: torch.Tensor
    length: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_len(self) -> int:
        return self.block_tables.shape[1] * self.k.shape[2]


def quantize_kv(x: torch.Tensor):
    """x: (..., D) -> (int8 (..., D), scale (...,) fp32), the reference's
    bits: scale = max(amax, 1e-6) / 127 in fp32, round(x / scale) half to
    even, clipped to +-127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """int8 (..., D) and its scales (...,) -> ``dtype``: one fp32 multiply,
    then one rounding."""
    return (q.float() * scale[..., None]).to(dtype)


def make_cache(cfg, batch: int, max_len: int, dtype="bfloat16",
               num_layers: int | None = None,
               length: torch.Tensor | None = None, *, device="cuda"):
    """Contiguous caches of ``max_len`` rows for ``batch`` slots, zeros;
    ``length`` (B,) int32 (default 0); ``dtype`` "int8" gives a
    :class:`QuantKVCache`.  Under rules that put ``kv_seq`` on a mesh axis
    of M ranks (:func:`~repro_torch.distributed.sharding.use_rules`) each
    rank allocates its slots alone: ``max_len / M`` rows (M must divide
    ``max_len``)."""
    L = num_layers if num_layers is not None else cfg.num_layers
    rows, _ = seq_rows(max_len)
    shape = (L, batch, rows, cfg.num_kv_heads, cfg.resolved_head_dim)
    ln = (torch.zeros((batch,), dtype=torch.int32, device=device)
          if length is None else length)
    if dtype == "int8":
        return QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            length=ln)
    dt = dtype_of(dtype)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device), length=ln)


def make_paged_cache(cfg, num_blocks: int, block_size: int, batch: int,
                     max_blocks: int, dtype="bfloat16",
                     num_layers: int | None = None, *, device="cuda"):
    """Paged cache sized to ``num_blocks`` pool blocks (incl. trash block 0)
    with ``batch`` block tables of ``max_blocks`` entries each; ``dtype``
    "int8" gives a :class:`QuantPagedKVCache`."""
    L = num_layers if num_layers is not None else cfg.num_layers
    shape = (L, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    tables = torch.zeros((batch, max_blocks), dtype=torch.int32,
                         device=device)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if dtype == "int8":
        return QuantPagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            block_tables=tables, length=length)
    dt = dtype_of(dtype)
    return PagedKVCache(k=torch.zeros(shape, dtype=dt, device=device),
                        v=torch.zeros(shape, dtype=dt, device=device),
                        block_tables=tables, length=length)


# ---------------------------------------------------------------------------
# parameter tables
# ---------------------------------------------------------------------------

def _ffn_table(cfg):
    """Dense FFN, or the MoE table and the shared experts' SwiGLU (all
    ``num_shared_experts`` fused into one of their summed width)."""
    if cfg.moe is None:
        return {"mlp": swiglu_table(cfg.d_model, cfg.d_ff)}
    m = cfg.moe
    t = {"moe": MOE.moe_table(cfg.d_model, m.num_experts, m.d_ff_expert)}
    if m.num_shared_experts:
        t["shared"] = swiglu_table(cfg.d_model,
                                   m.num_shared_experts * m.d_ff_shared)
    return t


def block_table(cfg, *, dense_ffn: bool = False):
    """One block's table; ``dense_ffn``: an MoE config's leading dense
    layer, a SwiGLU of ``d_ff_dense`` (or ``d_ff``)."""
    t = {"ln1": norm_table(cfg), "attn": A.attention_table(cfg)}
    if dense_ffn:
        t["mlp"] = swiglu_table(cfg.d_model, (cfg.moe.d_ff_dense or cfg.d_ff)
                                if cfg.moe else cfg.d_ff)
    else:
        t.update(_ffn_table(cfg))
    if not cfg.parallel_block:
        t["ln2"] = norm_table(cfg)
    return t


def lm_table(cfg):
    first_k = cfg.moe.first_k_dense if cfg.moe else 0
    t = {
        "embed": embedding_table(cfg.vocab_size, cfg.d_model,
                                 cfg.tie_embeddings),
        "blocks": stack_table(block_table(cfg), cfg.num_layers - first_k),
        "ln_f": norm_table(cfg),
    }
    if first_k:
        t["dense_blocks"] = [block_table(cfg, dense_ffn=True)
                             for _ in range(first_k)]
    return t


_PRODUCT_WEIGHTS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv",
                    "w_gate", "w_up", "w_down")


def init(cfg, generator: torch.Generator, *, cast_products: bool = False):
    """Parameters in ``cfg.param_dtype`` on ``generator``'s device.
    ``cast_products``: the leaves :func:`prepare_params` casts are stored in
    the compute dtype already, each drawn in ``param_dtype`` a layer at a
    time and cast before the next draw -- the numbers of ``prepare_params``
    after a plain init, without the ``param_dtype`` tree ever resident
    (deepseek-moe-16b: 65.5 GB in fp32, 31.9 GB in bf16 for its products)."""
    cast = (_PRODUCT_WEIGHTS, cfg.compute_dtype) if cast_products else None
    return init_table(generator, lm_table(cfg), cfg.param_dtype, cast=cast)


def prepare_params(cfg, params, device=None):
    """Move ``params`` to ``device`` and cast every weight that enters a
    matrix product (and the QKV biases added to its result) to the compute
    dtype, once: the experts' stacked products too, the MoE router not (the
    reference computes its logits in fp32).  The reference casts these fp32
    weights to the compute dtype before every product; casting once at load
    gives the same numbers.  Norm scales and the (tied) embedding stay in
    ``param_dtype``: the reference computes norms and the LM head in fp32."""
    return cast_product_weights(params, _PRODUCT_WEIGHTS, cfg.compute_dtype,
                                device)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _paged_attend(cfg, q, k_new, v_new, pool_k, pool_v, scales,
                  block_tables, length, chunk):
    """Paged decode attention for one layer: write the new KV row into the
    block-table-addressed pool slot (in place), then attend over live
    blocks only.

    q/k_new/v_new: (B, 1, H|K, D); pool_k/pool_v: (N, bs, K, D) this
    layer's pools; scales: None, or this layer's (k_scale, v_scale) of
    shape (N, bs, K) for int8 pools (the row is quantized, written with
    its scales, and dequantized inside the kernel); block_tables: (B,
    max_blocks); length: (B,) rows already valid (the new row is written at
    ``length``).  The write index is clipped to the table as in the
    reference: retired slots (all-zero tables, length 0) write into the
    trash block every step.
    """
    N, bs, K, D = pool_k.shape
    B = q.shape[0]
    mb = block_tables.shape[1]
    bi = torch.clamp(length // bs, 0, mb - 1).long()
    bt = block_tables[torch.arange(B, device=q.device), bi].long()
    off = (length % bs).long()
    k_scale, v_scale = scales if scales is not None else (None, None)
    if check_scales(pool_k, k_scale, v_scale):
        kq, ks = quantize_kv(k_new[:, 0])
        vq, vs = quantize_kv(v_new[:, 0])
        pool_k[bt, off], k_scale[bt, off] = kq, ks
        pool_v[bt, off], v_scale[bt, off] = vq, vs
    else:
        pool_k[bt, off] = k_new[:, 0].to(pool_k.dtype)
        pool_v[bt, off] = v_new[:, 0].to(pool_v.dtype)
    out = paged_decode_attention(q[:, 0].contiguous(), pool_k, pool_v,
                                 block_tables, length + 1, k_scale=k_scale,
                                 v_scale=v_scale,
                                 softcap=cfg.attn_logit_softcap, chunk=chunk)
    return out[:, None]


def _paged_prefill_attend(cfg, q, k_new, v_new, pool_k, pool_v, scales,
                          write_ids, table, q_start, kv_len, chunk):
    """Paged prefill for one layer: write the chunk's KV rows straight into
    pool blocks (in place), then attend causally over the table's blocks.

    q/k_new/v_new: (1, C, H|K, D) with C a multiple of the pool block size;
    scales: None, or this layer's (k_scale, v_scale) (N, bs, K) for int8
    pools (the rows quantized and written with their scales);
    write_ids: (C // bs,) physical block per chunk block (trash 0 for rows
    that must not land anywhere -- bucket padding, and the
    recompute-baseline's shared prefix; duplicate trash writes race, which
    is harmless because no kernel reads a row at or past ``kv_len``);
    table: (1, max_blocks) read table; q_start: (1,) absolute position of
    the chunk's first row; kv_len: (1,) valid rows incl. this chunk.

    ``write_ids=None`` is the *verify* write layout (speculative decoding):
    q/k_new/v_new are (B, C) candidate rows starting at any in-block offset
    ``q_start`` per sequence, so each row is scattered on its own through
    ``table`` -- row ``q_start + j`` lands at block ``table[b, pos // bs]``,
    offset ``pos % bs``.  Padding sequences carry all-trash tables, so
    their rows (and any duplicate trash hits) are harmless garbage.
    """
    N, bs, K, D = pool_k.shape
    C = q.shape[1]
    if write_ids is None:
        pos = q_start[:, None] + torch.arange(C, dtype=torch.int32,
                                              device=q.device)[None]
        bi = torch.clamp(pos // bs, 0, table.shape[1] - 1).long()
        idx = (torch.gather(table, 1, bi).long(), (pos % bs).long())
        rows_k, rows_v = k_new, v_new                # (B, C, K, D)
    else:
        idx = (write_ids.long(),)
        rows_k = k_new[0].reshape(C // bs, bs, K, D)
        rows_v = v_new[0].reshape(C // bs, bs, K, D)
    k_scale, v_scale = scales if scales is not None else (None, None)
    if check_scales(pool_k, k_scale, v_scale):
        kq, ks = quantize_kv(rows_k)
        vq, vs = quantize_kv(rows_v)
        pool_k[idx], k_scale[idx] = kq, ks
        pool_v[idx], v_scale[idx] = vq, vs
    else:
        pool_k[idx] = rows_k.to(pool_k.dtype)
        pool_v[idx] = rows_v.to(pool_v.dtype)
    return paged_prefill_attention(q, pool_k, pool_v, table, q_start, kv_len,
                                   k_scale=k_scale, v_scale=v_scale,
                                   softcap=cfg.attn_logit_softcap,
                                   chunk=chunk)


def _flash_attend(cfg, q, k, v, chunk):
    """Causal self-attention through the dense flash kernel (K4) -- the
    prompt's in prefill, the whole sequence's in training -- queries and
    keys at rows 0..S-1.  K4 has neither a window nor a softcap, as the
    Pallas kernel it ports."""
    if cfg.sliding_window or cfg.attn_logit_softcap:
        raise NotImplementedError(
            "attention through the flash kernel: no sliding window or softcap")
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True, chunk=chunk)


def _ffn_apply(cfg, p, h, aux_out, tp=None):
    """The FFN half of a block: the dense SwiGLU, or the routed experts
    (their capacity dispatch) plus the shared experts' SwiGLU, added after.
    A routed block appends its aux loss to ``aux_out`` when it is a list.
    Under a training plan ``tp`` (``h`` in the stream's layout) the SwiGLU
    reads the whole sequence (:func:`TP.enter`) on the rank's ``ff``
    columns and leaves its partial sums in the stream's layout; the router
    reads the rank's own rows with the load-balance sums taken over every
    rank's rows, and on a model axis of more than one rank the routed
    experts run expert-parallel on those rows (``moe_ep``)."""
    if "moe" not in p:
        return TP.leave(tp, swiglu(p["mlp"], TP.enter(tp, h)))
    m = cfg.moe
    idx, prob, aux = MOE.route(m, p["moe"], h, tp=tp)
    if aux_out is not None:
        aux_out.append(aux)
    if tp is not None and tp.model_size > 1:
        out = MOE.moe_ep(m, p["moe"], h, idx, prob, mesh=tp.mesh, model_axis=tp.model,
                         local_rows=True)
    else:
        out = MOE.moe_apply(m, p["moe"], h, idx, prob)
    if m.num_shared_experts:
        out = out + TP.leave(tp, swiglu(p["shared"], TP.enter(tp, h)))
    return out


def block_apply(cfg, p, x, positions, *, cache_k=None, cache_v=None,
                cache_scales=None, kv_len=None, block_tables=None,
                paged_prefill=None, kv_out=None, aux_out=None, chunk=1024,
                tp=None, axes=None):
    """One transformer block.

    Without a cache: causal self-attention over the whole of x (B, S, D)
    through the flash kernel (K4; differentiable, so training's backward
    runs K4's backward kernel where the reference differentiates its plain
    ``chunked_attention``), and when ``kv_out`` is a list (prefill) this
    layer's (k, v) appended to it.  K4 masks by row index: ``positions``
    must be 0..S-1 (:func:`forward` checks it).  With this layer's paged pools
    (``block_tables`` given): decode (``paged_prefill`` None) takes x of
    (B, 1, D) and writes the new KV row at ``kv_len``; prefill and verify
    (``paged_prefill`` a dict of write_ids/table/q_start/kv_len) write the
    chunk's KV rows straight into pool blocks and attend causally over the
    table's blocks.  With this layer's contiguous caches (no
    ``block_tables``): decode through ``seq_sharded_decode_attention``
    (under the current mesh, its rank's slots of a sequence-sharded cache).
    ``cache_scales``: this layer's (k_scale, v_scale) when the cache or
    pool is int8.  ``aux_out``: a list that an MoE block's router appends
    its aux loss to.

    ``tp``: a training plan (no cache), ``x`` the stream in its layout (the
    rank's S / M rows under ``seq_sp``), ``p`` the rank's slices of the
    block's parameters, whose logical ``axes`` FSDP gathers here (so a
    checkpointed block gathers again in its recompute).  The normed rows
    are gathered before the q / k / v products, K4 runs on the rank's
    heads (and, where the KV heads are whole, on those its heads read),
    and the output product's partial sums go back to the stream's layout.
    """
    p = TP.gather_params(tp, p, axes)
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = A.qkv_project(cfg, p["attn"], TP.enter(tp, h), positions,
                            kv_span=TP.kv_head_span(cfg, tp))
    if cache_k is None:
        attn = _flash_attend(cfg, q, k, v, chunk)
        if kv_out is not None:
            kv_out.append((k, v))
    elif block_tables is None:
        ks, vs = cache_scales if cache_scales is not None else (None, None)
        attn = seq_sharded_decode_attention(
            q, cache_k, cache_v, k, v, kv_len, k_scale=ks, v_scale=vs,
            softcap=cfg.attn_logit_softcap, chunk=chunk)[0]
    elif paged_prefill is not None:
        attn = _paged_prefill_attend(cfg, q, k, v, cache_k, cache_v,
                                     cache_scales, chunk=chunk,
                                     **paged_prefill)
    else:
        attn = _paged_attend(cfg, q, k, v, cache_k, cache_v, cache_scales,
                             block_tables, kv_len, chunk)
    attn = TP.leave(tp, A.attn_output(cfg, p["attn"], attn))
    if cfg.parallel_block:
        return x + attn + _ffn_apply(cfg, p, h, aux_out, tp)
    x = x + attn
    return x + _ffn_apply(cfg, p, apply_norm(cfg, p["ln2"], x), aux_out, tp)


def _unstack_layers(tree: Any, num: int) -> list:
    """Per-layer views of the stacked ``(L, ...)`` leaves, by ``unbind``.
    Under autograd its backward stacks the L slice gradients once, where
    indexing each layer (``leaf[i]``) would scatter every slice into a
    zero tensor of the whole stack: L times the bytes, and one more
    stack-sized buffer per leaf held through the backward."""
    if isinstance(tree, Mapping):
        sub = {k: _unstack_layers(v, num) for k, v in tree.items()}
        return [{k: v[i] for k, v in sub.items()} for i in range(num)]
    return list(tree.unbind(0))


def _layers(cfg, params) -> list:
    """Every layer's parameters in depth order: an MoE config's
    ``dense_blocks`` (cache layers ``[0, first_k)``), then the stack's
    ``num_layers - first_k`` layers."""
    dense = list(params.get("dense_blocks", ()))
    return dense + _unstack_layers(params["blocks"], cfg.num_layers - len(dense))


def _scan_blocks(cfg, layers, x, positions, *, remat, aux_out=None, chunk=1024,
                 tp=None, axes=None):
    """Every layer without a cache (training; the reference's unrolled
    dense blocks and its ``lax.scan``, ``:411-462``).  ``cfg.remat``: ``"none"`` runs
    the blocks as they are; ``"full"`` keeps only each block's input and
    recomputes the block in the backward (``jax.checkpoint`` with
    ``nothing_saveable``: here ``torch.utils.checkpoint``, non-reentrant);
    ``"dots"`` (``dots_with_no_batch_dims_saveable``) keeps each weight
    product's output as well (:func:`linear.keep_products`): the recompute
    runs the norms, RoPE, activations and K4 again but launches no K7.  A
    value the reference does not know runs as ``"full"``, as its
    ``_REMAT_POLICIES.get(cfg.remat, full)`` does.  A recomputed MoE block
    appends its aux loss to ``aux_out`` again in the backward, after the
    forward has summed it.  ``tp`` / ``axes``: a training plan and each
    layer's parameter axes (:func:`block_apply`)."""
    policy = cfg.remat if remat else "none"
    for p, ax in zip(layers, axes or [None] * len(layers)):
        if policy == "none":
            x = block_apply(cfg, p, x, positions, aux_out=aux_out, chunk=chunk, tp=tp,
                            axes=ax)
        elif policy == "dots":
            x = checkpoint(_block_keeping_products, linear.KeptProducts(), cfg, p, x,
                           positions, chunk, aux_out, tp, ax, use_reentrant=False)
        else:
            x = checkpoint(block_apply, cfg, p, x, positions, aux_out=aux_out,
                           chunk=chunk, tp=tp, axes=ax, use_reentrant=False)
    return x


def _block_keeping_products(kept, cfg, p, x, positions, chunk, aux_out=None, tp=None,
                            axes=None):
    """``block_apply`` with its weight products' outputs kept in ``kept``
    (``remat="dots"``)."""
    with linear.keep_products(kept):
        return block_apply(cfg, p, x, positions, aux_out=aux_out, chunk=chunk, tp=tp,
                           axes=axes)


def _apply_backbone(cfg, params, tokens, positions, *, cache=None,
                    remat=False, collect_kv=False, paged_prefill=None,
                    chunk=1024, tp=None):
    """Embed, run every layer, and the final norm.  Returns (x, the summed
    aux loss of the MoE blocks (0 without any), KVCache or None).

    Without a cache the layers run over the whole sequence: the training
    stack, or with ``collect_kv`` the prefill, whose attention runs the
    flash kernel and whose layers' fresh K/V come back stacked as a
    :class:`KVCache` of the prompt's rows.  With a cache each layer runs
    against its slice of the contiguous caches or paged pools and, int8,
    of their scales (the reference's ``lax.scan`` over stacked layers).
    An MoE config's dense blocks take cache layers ``[0, first_k)`` and the
    stack ``[first_k, num_layers)``.  ``tp``: a training plan (no cache),
    ``params`` the rank's slices with the embedding and final norm whole
    for this forward (:func:`forward`); ``x`` comes back in the stream's
    layout."""
    x = embed(params["embed"], tokens, dtype_of(cfg.compute_dtype), tp)
    layers = _layers(cfg, params)
    aux: list = []

    def aux_sum():
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for a in aux:                     # in depth order, as the reference
            total = total + a
        return total

    if cache is None and not collect_kv:
        x = _scan_blocks(cfg, layers, x, positions, remat=remat, aux_out=aux,
                         chunk=chunk, tp=tp, axes=_layer_axes(cfg) if tp else None)
        return apply_norm(cfg, params["ln_f"], x), aux_sum(), None
    if cache is None:
        kv: list = []
        for p in layers:
            x = block_apply(cfg, p, x, positions, kv_out=kv, aux_out=aux, chunk=chunk)
        B, S = tokens.shape
        return apply_norm(cfg, params["ln_f"], x), aux_sum(), KVCache(
            k=torch.stack([k for k, _ in kv]),
            v=torch.stack([v for _, v in kv]),
            length=torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device))
    quant = isinstance(cache, (QuantKVCache, QuantPagedKVCache))
    tables = getattr(cache, "block_tables", None)
    rules = current_rules()
    if (tables is not None and current_mesh() is not None and rules
            and rules.rules.get("kv_seq")):
        raise NotImplementedError("the paged pool is not sequence-sharded: under rules "
                                  "that shard kv_seq the dense transformer decodes from "
                                  "contiguous caches")
    for i, p in enumerate(layers):
        scales = (cache.k_scale[i], cache.v_scale[i]) if quant else None
        x = block_apply(cfg, p, x, positions, cache_k=cache.k[i],
                        cache_v=cache.v[i], cache_scales=scales,
                        kv_len=cache.length, block_tables=tables,
                        paged_prefill=paged_prefill, aux_out=aux, chunk=chunk)
    return apply_norm(cfg, params["ln_f"], x), aux_sum(), cache


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def default_positions(cfg, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 positions 0..S-1 of each row ((3, B, S) for M-RoPE)."""
    B, S = tokens.shape[0], tokens.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    if cfg.m_rope:
        pos = pos[None].expand(3, B, S)
    return pos


def _row_positions(cfg, pos: torch.Tensor) -> torch.Tensor:
    """(B, S) positions -> what the model takes: (3, B, S), three equal
    streams, under M-RoPE; as they are otherwise."""
    return pos[None].expand(3, *pos.shape) if cfg.m_rope else pos


def check_row_positions(positions: torch.Tensor, cfg=None) -> None:
    """Raise unless ``positions`` (..., S) holds each row's index 0..S-1:
    the flash kernel masks by row index, not by position.  Under M-RoPE
    (``cfg.m_rope``; positions (3, B, S)) only stream 0, the temporal ids
    the reference masks by, is held; streams 1 and 2 are free."""
    if cfg is not None and cfg.m_rope:
        positions = positions[0]
    S = positions.shape[-1]
    rows = torch.arange(S, dtype=positions.dtype, device=positions.device)
    if not bool((positions == rows).all()):
        raise ValueError("attention runs the flash kernel, which masks by row: "
                         "positions (under M-RoPE their stream 0) must be 0..S-1 "
                         "in every row")


def _layer_axes(cfg) -> list:
    """Every layer's parameter axes, in :func:`_layers`' order."""
    axes = tree_map(lambda d: d.axes, lm_table(cfg))
    dense = list(axes.get("dense_blocks", ()))
    return dense + [tree_map(lambda d: d.axes, block_table(cfg))] * (cfg.num_layers
                                                                      - len(dense))


def forward(cfg, params, tokens, positions=None, *, remat=True, chunk=1024):
    """Training forward.  tokens: (B, S) -> full logits (B, S, V) fp32 and
    the aux loss: the MoE blocks' router losses summed in depth order (0
    for the dense family, which has no router).  ``params`` are the
    fp32 master weights: each product casts its weight to the compute
    dtype at use, as the reference does (under ``remat="full"`` the block's
    casts run again in the recompute; nothing is cached across steps).
    Attention runs K4 and its backward kernel; given ``positions`` must be
    0..S-1, as every training batch's are.

    Under the current mesh and rules (a training plan,
    :mod:`repro_torch.distributed.tensor_parallel`) ``params`` are the
    rank's slices, ``tokens`` / ``positions`` the data shard's whole rows,
    and the logits come in the layout
    :func:`~repro_torch.training.losses.lm_cross_entropy` takes with the
    plan: every row on the rank's vocabulary slice where the rules slice
    the vocabulary, else the stream's rows.  The aux loss is the same on
    every rank."""
    if positions is None:
        positions = default_positions(cfg, tokens)
    else:
        check_row_positions(positions, cfg)
    tp = TP.plan(cfg)
    if tp is not None:             # FSDP: the embedding and final norm whole here
        axes = tree_map(lambda d: d.axes, lm_table(cfg))
        params = {**params, **{k: TP.gather_params(tp, params[k], axes[k])
                               for k in ("embed", "ln_f")}}
    x, aux, _ = _apply_backbone(cfg, params, tokens, positions, remat=remat,
                                chunk=chunk, tp=tp)
    if tp is not None and tp.vocab:
        x = TP.enter(tp, x)
    lg = lm_logits(params["embed"], x, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg, aux


def prefill(cfg, params, tokens, positions=None, *, cache_dtype="bfloat16",
            max_len: int | None = None, chunk=1024, last_pos=None):
    """Prefill the prompts ``tokens`` (B, S) from position 0: logits (B, V)
    fp32 at the last position, or at ``last_pos`` (B,) (a prompt
    right-padded to a bucket has its last real token there; causality keeps
    its logits independent of the padding), and a :class:`KVCache` in
    ``cache_dtype`` grown to ``max_len`` rows (default S) with ``length``
    S.  The causal attention is the flash kernel's, which masks by row:
    given ``positions`` (RoPE's; under M-RoPE (3, B, S), their stream 0)
    must be each row's index, as the default is, or the call raises."""
    if positions is None:
        positions = default_positions(cfg, tokens)
    else:
        check_row_positions(positions, cfg)
    x, _, cache = _apply_backbone(cfg, params, tokens, positions,
                                  collect_kv=True, chunk=chunk)
    B, Sq = tokens.shape
    max_len = max_len or Sq
    cdt = dtype_of(cache_dtype)
    rows, offset = seq_rows(max_len)
    live = max(0, min(Sq - offset, rows))       # the prompt's rows among this rank's

    def grow(c):
        out = torch.zeros((*c.shape[:2], rows, *c.shape[3:]), dtype=cdt,
                          device=c.device)
        out[:, :, :live] = c[:, :, offset:offset + live]
        return out
    cache = cache._replace(k=grow(cache.k), v=grow(cache.v))
    last = (x[:, -1:] if last_pos is None
            else x[torch.arange(B, device=x.device), last_pos][:, None])
    lg = lm_logits(params["embed"], last, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg[:, 0], cache


def prefill_paged(cfg, params, tokens, cache, write_ids, table, *,
                  q_start, kv_len, last_idx, chunk=1024):
    """Cache-seeded chunked prefill: write one prompt chunk straight into
    paged pool blocks and attend over everything already seeded.

    tokens: (1, C) chunk (C a multiple of the pool block size; rows past
    the real prompt are padding whose writes land in the trash block via
    ``write_ids``); cache: :class:`PagedKVCache` or
    :class:`QuantPagedKVCache`; write_ids: (C //
    block_size,) physical block per chunk block; table: (1, max_blocks)
    the request's read table; q_start: (1,) absolute position of the
    chunk's first token; kv_len: (1,) valid KV rows including this chunk's
    real tokens; last_idx: row whose logits to return.  Returns ((1, V)
    fp32 logits at ``last_idx``, the cache with its pools updated in place).
    """
    B, C = tokens.shape
    pos = q_start[:, None] + torch.arange(C, dtype=torch.int32,
                                          device=tokens.device)[None]
    x, _, _ = _apply_backbone(cfg, params, tokens,
                              _row_positions(cfg, pos.expand(B, C)),
                              cache=cache, chunk=chunk,
                              paged_prefill=dict(write_ids=write_ids,
                                                 table=table, q_start=q_start,
                                                 kv_len=kv_len))
    last = x[torch.arange(B, device=x.device), last_idx][:, None]
    lg = lm_logits(params["embed"], last, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg[:, 0], cache


def verify_paged(cfg, params, tokens, cache, table, *, q_start, kv_len,
                 chunk=1024):
    """Speculative-decode verify pass: score ``k + 1`` candidate tokens per
    sequence in one batched call.

    tokens: (B, C) per slot ``[t_0, d_1 .. d_k]`` -- the pending greedy
    token and the drafter's proposals; cache: :class:`PagedKVCache` or
    :class:`QuantPagedKVCache`; table: (B, max_blocks) per-slot read tables
    (grown to cover the candidate rows; padding slots all trash); q_start:
    (B,) committed rows per slot (candidate row ``j`` sits at position
    ``q_start + j``); kv_len: (B,) ``q_start + C``.

    Returns logits at *every* candidate row, (B, C, V) fp32: row ``j`` is
    the target's distribution after ``t_0, d_1 .. d_j``.  The candidates'
    KV rows are scattered through ``table`` in place (the ``write_ids=None``
    layout of :func:`_paged_prefill_attend`), so accepted rows are already
    where they belong; the rejected tail's rows are overwritten later.
    """
    B, C = tokens.shape
    pos = q_start[:, None] + torch.arange(C, dtype=torch.int32,
                                          device=tokens.device)[None]
    x, _, _ = _apply_backbone(cfg, params, tokens, _row_positions(cfg, pos),
                              cache=cache, chunk=chunk,
                              paged_prefill=dict(write_ids=None, table=table,
                                                 q_start=q_start,
                                                 kv_len=kv_len))
    lg = lm_logits(params["embed"], x, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg, cache


def decode_step(cfg, params, tokens, cache, *, chunk=2048):
    """One decode step against any of the four caches.  tokens: (B, 1) ->
    logits (B, V) fp32, and the cache with the new rows written in place
    and ``length`` advanced by one.  Under a mesh (the current one,
    :func:`~repro_torch.distributed.sharding.use_rules`) each layer's
    attention runs the sequence-sharded decode over it, on this rank's
    slots of contiguous caches (the paged pools raise)."""
    pos = _row_positions(cfg, cache.length[:, None])
    x, _, _ = _apply_backbone(cfg, params, tokens, pos, cache=cache,
                              chunk=chunk)
    lg = lm_logits(params["embed"], x, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg[:, 0], cache._replace(length=cache.length + 1)
