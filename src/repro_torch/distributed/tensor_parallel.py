"""Tensor, sequence and data parallelism for the training forward, by the
sharding rules (what the reference's GSPMD does for its jitted step under
``in_shardings``, done by hand).

Every rank holds the slices :func:`~repro_torch.distributed.sharding.shard_tree`
gives it and runs the same program on them; the layers call the
collectives here where a layout changes.  The convention that makes the
gradients come out right: **every rank computes its own share of the loss,
the global loss is the sum of the shares, and every collective is
differentiated by its transpose** (:mod:`repro_torch.distributed.collectives`).
A parameter's gradient on a rank is then its share of the whole gradient,
and the whole is the sum over every mesh axis the parameter is replicated
on (:meth:`~repro_torch.optim.optimizers.ShardLayout.sum_axes`); a
parameter sliced on an axis is used only on the rank that holds the
slice, and an FSDP gather's backward has reduce-scattered already, so
that axis adds nothing.

A :class:`Plan` is read off the current rules and mesh once per forward:

* ``model`` -- the mesh axis of ``heads`` / ``ff`` / ``vocab`` /
  ``experts`` (tensor and expert parallelism), and of ``seq_sp``.
* ``seq_sp`` -- the residual stream between blocks holds the rank's S / M
  rows (sequence parallelism).  A block all-gathers its normed rows over
  ``model`` before the column-parallel products (q / k / v, gate / up) and
  reduce-scatters the row-parallel sums (o, down) back onto the rows.
  Where M does not divide S the rules leave ``seq_sp`` unsharded: the
  stream is whole on every rank, the products read it as it is, and the
  row-parallel sums are all-reduced.
* ``batch`` -- the mesh axes of the batch (data parallelism); the loss is
  each data shard's mean, and the step sums the gradients over every axis
  but ``model`` and divides by the product of their sizes (``dp``).
* ``fsdp`` -- the mesh axes of ``embed``: a parameter sliced on them is
  all-gathered where it is used (inside the block, so a checkpointed
  block gathers again in the recompute) and its gradient reduce-scattered.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (_mesh_axes, axis_sizes, current_mesh,
                                              current_rules, map_with_axes)

# families whose layers are ported to a model axis; the others train under
# a mesh whose model axis is 1, by data parallelism alone
TP_FAMILIES = ("dense", "moe", "vlm")


@dataclass(frozen=True)
class Plan:
    """What the current rules and mesh ask of one training forward."""
    mesh: object
    rules: object
    model: str | None          # the model axis (None: no tensor parallelism)
    model_size: int
    model_rank: int
    seq_sp: bool               # the stream holds S / M rows a rank
    heads: bool                # q heads sliced on ``model``
    kv_heads: bool             # kv heads sliced on ``model``
    vocab: bool                # the vocabulary sliced on ``model``
    batch_axes: tuple          # mesh axes of the batch
    dp: int                    # the sizes of every axis but ``model``, multiplied

    @property
    def group(self):
        return self.mesh.get_group(self.model)

    def row_axes(self) -> tuple[str, ...]:
        """The mesh axes that cut the rows a rank computes the loss and the
        routers on: the batch's, and ``model`` under ``seq_sp``."""
        return self.batch_axes + ((self.model,) if self.seq_sp else ())

    def own_rows(self, S: int) -> slice:
        """The rows of the whole sequence whose loss this rank counts: its
        S / M under ``seq_sp``; all on model rank 0 (none elsewhere) when
        the stream is whole."""
        if self.seq_sp:
            n = S // self.model_size
            return slice(self.model_rank * n, (self.model_rank + 1) * n)
        return slice(0, S if self.model_rank == 0 else 0)


def plan(cfg=None) -> Plan | None:
    """The current rules' plan, or None without a mesh.  ``cfg``: refuse
    what the port does not cut yet (tensor parallelism of the families
    that :data:`TP_FAMILIES` leaves out, heads that the model axis does not
    divide, a replicated KV head that straddles two ranks' query heads,
    expert parallelism where ``seq_sp`` is off)."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None:
        return None
    if rules is None:
        raise ValueError("a mesh without sharding rules: enter use_rules(rules, mesh)")
    sizes = axis_sizes(mesh)
    r = rules.rules
    model = r.get("heads") or r.get("ff") or r.get("vocab") or r.get("experts")
    if model is not None and not isinstance(model, str):
        raise ValueError(f"tensor parallelism on {model!r}: one mesh axis is taken")
    msize = sizes.get(model, 1) if model else 1
    if cfg is not None and msize > 1 and cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family's layers are not cut on a model axis yet "
            f"(ROADMAP item 11b'): train it on a mesh whose model axis is 1")
    batch_axes = tuple(_mesh_axes(r.get("batch")))
    dp = 1
    for ax, n in sizes.items():
        dp *= n if ax != model else 1
    p = Plan(mesh=mesh, rules=rules, model=model, model_size=msize,
             model_rank=mesh.get_local_rank(model) if msize > 1 else 0,
             seq_sp=r.get("seq_sp") is not None and r.get("seq_sp") == model,
             heads=r.get("heads") is not None, kv_heads=r.get("kv_heads") is not None,
             vocab=r.get("vocab") is not None, batch_axes=batch_axes, dp=dp)
    if cfg is not None and msize > 1:
        if not p.heads:
            raise NotImplementedError(f"{cfg.num_heads} heads do not divide into "
                                      f"{msize} ranks: attention is cut by heads only")
        if not p.kv_heads:
            kv_head_span(cfg, p)         # raises where a kv head straddles ranks
        if cfg.moe is not None and not p.seq_sp:
            raise NotImplementedError("experts on a model axis of more than one rank "
                                      "need seq_sp (S divisible by the axis)")
    return p


def kv_head_span(cfg, p: Plan | None) -> slice | None:
    """The replicated KV head the rank's query heads read (GQA group size
    G = H / K): where the model axis M does not divide K, the rank's H / M
    heads sit in one group when H / M divides G, and K4 then takes them
    against that one head.  None where the rank's KV heads are its own
    slice, or whole for whole query heads (no plan, a model axis of one
    rank)."""
    if p is None or p.kv_heads or p.model_size == 1:
        return None
    H, K, M = cfg.num_heads, cfg.num_kv_heads, p.model_size
    hl, G = H // M, H // K
    if G % hl:
        raise NotImplementedError(f"{hl} query heads a rank straddle KV groups of {G}")
    k0 = p.model_rank * hl // G
    return slice(k0, k0 + 1)


# ---------------------------------------------------------------------------
# the layout changes a block makes
# ---------------------------------------------------------------------------

def enter(p: Plan | None, h: torch.Tensor) -> torch.Tensor:
    """The normed rows (B, S_loc, D) -> the whole sequence every
    column-parallel product reads: an all-gather over ``model`` under
    ``seq_sp`` (its backward a reduce-scatter: each rank's products hold a
    part of the gradient), ``h`` itself otherwise."""
    if p is None or p.model is None or not p.seq_sp:
        return h
    return C.all_gather_dim(h, 1, p.group)


def leave(p: Plan | None, y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums (B, S, D) -> the stream's
    layout: reduce-scattered onto the rank's rows under ``seq_sp``,
    all-reduced otherwise."""
    if p is None or p.model is None:
        return y
    if p.seq_sp:
        return C.reduce_scatter_dim(y, 1, p.group)
    return C.all_reduce(y, p.group)


def sum_over(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``t`` summed over every mesh axis in ``axes`` (one all-reduce each;
    differentiable)."""
    for ax in axes:
        t = C.all_reduce(t, mesh.get_group(ax))
    return t


# ---------------------------------------------------------------------------
# parameters: FSDP gathers and the gradient rule
# ---------------------------------------------------------------------------

def _fsdp_dims(spec: tuple, model: str | None) -> list[tuple[int, tuple[str, ...]]]:
    """(dim, mesh axes other than ``model``) of each dim a spec shards over
    a data axis."""
    out = []
    for dim, entry in enumerate(spec):
        axes = tuple(ax for ax in _mesh_axes(entry) if ax != model)
        if axes:
            out.append((dim, axes))
    return out


def gather_params(p: Plan | None, params, axes_tree):
    """FSDP: every leaf of ``params`` that its spec slices on a data axis,
    all-gathered along that dim (minor axis first), its backward a
    reduce-scatter (every data rank's rows make a part of its gradient).
    Leaves sliced on ``model`` alone stay the rank's slices."""
    if p is None:
        return params

    def whole(t, ax):
        for dim, axes in _fsdp_dims(p.rules.spec(list(ax)), p.model):
            for name in reversed(axes):
                t = C.all_gather_dim(t, dim, p.mesh.get_group(name))
        return t
    return map_with_axes(whole, params, axes_tree)
