"""Explicit collectives: the differentiable ones the sharded train step is
built from, and distributed flash-decode (log-sum-exp merge) over a
sequence-sharded KV cache (counterpart of ``repro/distributed/collectives.py``).

The reference's GSPMD inserts and differentiates its collectives itself.
Here each is a ``torch.autograd.Function`` whose backward is the
transpose of its forward: :func:`all_reduce` (sum) is its own,
:func:`all_gather_dim` and :func:`reduce_scatter_dim` are each other's,
and :func:`all_to_all` is its own.  A gather whose consumer runs the same
arithmetic on every rank (``consumer="replicated"``) holds the whole
gradient on every rank already, and its backward is the rank's slice; a
reduce-scatter there would count it once a rank.

During decode the KV cache dominates memory.  Under rules that put the
logical ``kv_seq`` axis on a mesh axis of M ranks, each rank holds a
(B, S / M, K, D) slice of every cache: the slots ``[offset, offset + S /
M)``, ``offset = rank * S / M``.  Each rank attends over its own slots
through the dense decode kernel (K3), which returns its output and its row
log-sum-exp, the partials (out, m, l) are all-gathered across the mesh
axis's group -- O(B H D) bytes, tiny next to the cache -- and
:func:`~repro_torch.models.layers.attention.merge_lse` combines them.  This
is flash-decoding's split of the KV length, with the splits on other ranks,
and the analogue of the paper's result collection from several devices.
The new token's row is written only by the rank that owns its slot.

The reference runs the per-rank body under ``shard_map``; here every rank
runs it on its local tensors, and :func:`collective_counts` counts the
collectives it issues.  The caches are updated **in place** (the
reference's ``.at[].set`` returns new ones); the function still returns
them.
"""
from __future__ import annotations

import threading
from collections import Counter

import torch

from repro_torch.distributed.sharding import current_mesh, current_rules
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.dispatch import check_scales
from repro_torch.models.layers.attention import AttnResiduals, merge_lse


class _Counts:
    """Collectives issued, by name, from every thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Counter = Counter()        # guarded-by: self._lock

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


_COUNTS = _Counts()


def collective_counts() -> dict[str, int]:
    """Collectives issued since the last :func:`reset_collective_counts`,
    by name ("all_gather", "all_reduce", "reduce_scatter", "all_to_all"),
    backward passes' included."""
    return _COUNTS.snapshot()


def reset_collective_counts() -> None:
    _COUNTS.reset()


def require_process_group() -> None:
    """Raise unless a ``torch.distributed`` process group is initialised:
    a mesh's collectives need one, and nothing runs in its place."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised torch.distributed process "
                           "group; none is")


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` of ``group``, in group-rank order (one
    ``all_gather``, counted)."""
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _COUNTS.add("all_gather")
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    out = torch.empty_like(t)
    _COUNTS.add("all_to_all")
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def _all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    import torch.distributed as dist
    out = t.contiguous().clone()
    _COUNTS.add("all_reduce")
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return out


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum the contiguous ``t`` over ``group`` in place, no gradient (one
    ``all_reduce``, counted): the step's gradient sums."""
    import torch.distributed as dist
    _COUNTS.add("all_reduce")
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    _COUNTS.add("all_gather")
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide into {n} ranks")
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    _COUNTS.add("reduce_scatter")
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _rank_slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist
    n, r = dist.get_world_size(group), dist.get_rank(group)
    step = t.shape[dim] // n
    return t.narrow(dim, r * step, step).contiguous()


class _AllToAll(torch.autograd.Function):
    """Equal blocks along dim 0 swapped across the group; the backward
    sends each block's gradient back the way it came: the same swap."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    """Sum over the group; the backward sums the gradient over it too
    (each rank's input reaches every rank's output)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """The group's slices concatenated along ``dim``.  Backward: a
    reduce-scatter where each rank's consumer holds a partial sum of the
    gradient, the rank's own slice where the consumer is replicated."""

    @staticmethod
    def forward(ctx, t, dim, group, replicated):
        ctx.dim, ctx.group, ctx.replicated = dim, group, replicated
        return _gather_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return _rank_slice(g, ctx.dim, ctx.group), None, None, None
        return _scatter_dim(g, ctx.dim, ctx.group), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over the group, each rank keeping its slice along ``dim``;
    backward: the slices' gradients all-gathered."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_dim(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s equal blocks along dim 0 sent one to each rank of ``group``,
    in group-rank order; returns the blocks received, in the same order
    (one ``all_to_all_single``, counted).  Differentiable: the backward is
    the same swap of the gradient."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllToAll.apply(t, group)
    return _all_to_all(t, group)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or, ``op="max"``, the maximum, no gradient) of ``t`` over
    ``group``, on every rank (one ``all_reduce``, counted).  The sum is
    differentiable: its backward all-reduces the gradient."""
    if op == "sum" and torch.is_grad_enabled() and t.requires_grad:
        return _AllReduce.apply(t, group)
    return _all_reduce(t.detach() if op == "max" else t, group, op)


def all_gather_dim(t: torch.Tensor, dim: int, group, *,
                   consumer: str = "partial") -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` in
    group-rank order (one ``all_gather``, counted).  ``consumer`` says what
    the backward gets: "partial" -- each rank's gradient is its share of a
    sum (the products that follow run on the rank's heads, columns or
    vocabulary), so the backward reduce-scatters it; "replicated" -- every
    rank computes the same thing from the whole, holds the whole gradient,
    and the backward takes its slice."""
    if consumer not in ("partial", "replicated"):
        raise ValueError(f"consumer {consumer!r}")
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllGather.apply(t, dim, group, consumer == "replicated")
    return _gather_dim(t, dim, group)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, each rank keeping its slice along
    ``dim`` (one ``reduce_scatter``, counted); the backward all-gathers."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _ReduceScatter.apply(t, dim, group)
    return _scatter_dim(t, dim, group)


def gather_whole(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t``'s slices along ``dim`` from every rank of ``group``, without a
    gradient (checkpoints and tests gather a sharded tree back so)."""
    with torch.no_grad():
        return _gather_dim(t.detach(), dim, group)


def _write_row(buf, row, lengths, offset: int, s_loc: int):
    """Write one new (B, ...) row at slot ``lengths - offset`` of each
    sequence where that slot lies in [0, s_loc), in place; sequences whose
    slot lies outside (on another rank, or an idle slot counting past the
    cache) keep their rows.  No host sync: out-of-range sequences rewrite a
    clamped slot with its own value, as the reference's select keeps it."""
    B = buf.shape[0]
    widx = lengths - offset
    in_range = (widx >= 0) & (widx < s_loc)
    widx_c = torch.clamp(widx, 0, s_loc - 1).long()
    b = torch.arange(B, device=buf.device)
    sel = in_range.reshape((B,) + (1,) * (buf.ndim - 2))
    buf[b, widx_c] = torch.where(sel, row.to(buf.dtype), buf[b, widx_c])
    return buf


def _write(q, cache_k, cache_v, k_new, v_new, lengths, scales, offset: int):
    """The new rows written into this rank's slots (int8: quantized, with
    their scales); returns (K and V in q's type for the kernel, the updated
    caches and scales)."""
    s_loc = cache_k.shape[1]
    if scales:
        from repro_torch.models.transformer import dequantize_kv, quantize_kv
        k_scale, v_scale = scales
        kq, ks = quantize_kv(k_new[:, 0])
        vq, vs = quantize_kv(v_new[:, 0])
        nk = _write_row(cache_k, kq, lengths, offset, s_loc)
        nv = _write_row(cache_v, vq, lengths, offset, s_loc)
        extra = (_write_row(k_scale, ks, lengths, offset, s_loc),
                 _write_row(v_scale, vs, lengths, offset, s_loc))
        return (dequantize_kv(nk, extra[0], q.dtype), dequantize_kv(nv, extra[1], q.dtype),
                (nk, nv, *extra))
    nk = _write_row(cache_k, k_new[:, 0], lengths, offset, s_loc)
    nv = _write_row(cache_v, v_new[:, 0], lengths, offset, s_loc)
    return nk, nv, (nk, nv)


def local_lengths(lengths: torch.Tensor, offset: int, s_loc: int) -> torch.Tensor:
    """Live rows of each sequence among a rank's slots ``[offset, offset +
    s_loc)`` once the new row is written: ``clamp(lengths + 1 - offset, 0,
    s_loc)``, int32 (the reference's ``kv_len = lengths + 1`` over the
    rank's slot positions)."""
    return torch.clamp(lengths + 1 - offset, 0, s_loc).to(torch.int32)


def _local_decode(q, cache_k, cache_v, k_new, v_new, lengths, scales, *, mesh,
                  seq_axis: str, chunk: int):
    """One rank's body: write its rows, K3 with the row log-sum-exp over its
    slots, the partials gathered across ``seq_axis``'s group, merged."""
    require_process_group()
    s_loc = cache_k.shape[1]
    offset = mesh.get_local_rank(seq_axis) * s_loc
    att_k, att_v, caches = _write(q, cache_k, cache_v, k_new, v_new, lengths, scales, offset)
    out, m, l = decode_attention(q[:, 0].contiguous(), att_k, att_v,
                                 local_lengths(lengths, offset, s_loc), chunk=chunk,
                                 return_lse=True)
    # one all_gather of (out, m, l): out in q's type widened to fp32 exactly
    D = out.shape[-1]
    parts = all_gather(torch.cat([out.float(), m[..., None], l[..., None]], dim=-1),
                       mesh.get_group(seq_axis))
    merged = merge_lse([AttnResiduals(out=p[:, None, :, :D].to(q.dtype),
                                      m=p[..., D, None], l=p[..., D + 1, None])
                        for p in parts])                          # (B, 1, H, D)
    return (merged, *caches)


def seq_sharded_decode_attention(q, cache_k, cache_v, k_new, v_new, lengths,
                                 *, k_scale=None, v_scale=None,
                                 softcap: float = 0.0, chunk: int = 2048):
    """Decode attention against a contiguous cache, sequence-sharded over a
    mesh or on one device.

    q: (B, 1, H, D); cache_k/v: (B, S_loc, K, D) bf16 or fp32, or int8 with
    k_scale/v_scale (B, S_loc, K) fp32; k_new/v_new: (B, 1, K, D); lengths:
    (B,) current fill (the new row is written at ``lengths`` and attention
    covers ``lengths + 1`` rows).  All are this rank's **local** tensors:
    its batch slice, and under rules that put ``kv_seq`` on a mesh axis its
    S / M slots of each cache (S_loc = S / M).  Under the current mesh
    and rules (:func:`~repro_torch.distributed.sharding.use_rules`): with
    the rules' ``kv_seq`` on one of its axes, the mesh branch runs -- K3's
    partials with their log-sum-exp, one all-gather on that axis's group,
    the merge -- on every rank of the group, which must all call it; with
    ``kv_seq`` unsharded, or without a mesh, the cache is whole and K3 runs
    alone.  An int8 cache takes the row quantized (``quantize_kv``) with
    its scales, and its local slice is dequantized to q's type for the
    kernel.  Returns (attn_out (B, 1, H, D), cache_k, cache_v[, k_scale,
    v_scale]), the caches updated in place.  An int8 cache without its
    scales (or scales beside another cache), a softcap (the dense decode
    kernel has none, as the Pallas one), a mesh without rules or with
    ``kv_seq`` on several axes, and a mesh with no initialised process
    group raise.
    """
    if softcap:
        raise NotImplementedError(
            "softcap: the dense decode kernel has none, as the Pallas "
            "kernel it ports")
    mesh = current_mesh()
    rules = current_rules()
    quant = check_scales(cache_k, k_scale, v_scale)
    scales = (k_scale, v_scale) if quant else ()
    if mesh is not None:
        if rules is None:
            raise ValueError("a mesh without sharding rules: enter use_rules(rules, mesh)")
        seq_axis = rules.rules.get("kv_seq")
        if seq_axis is not None:
            if not isinstance(seq_axis, str):
                raise ValueError(f"kv_seq on {seq_axis!r}: the sequence-sharded decode "
                                 f"takes one mesh axis")
            return _local_decode(q, cache_k, cache_v, k_new, v_new, lengths, scales,
                                 mesh=mesh, seq_axis=seq_axis, chunk=chunk)
    att_k, att_v, caches = _write(q, cache_k, cache_v, k_new, v_new, lengths, scales, 0)
    out = decode_attention(q[:, 0].contiguous(), att_k, att_v, lengths + 1, chunk=chunk)
    return (out[:, None], *caches)
