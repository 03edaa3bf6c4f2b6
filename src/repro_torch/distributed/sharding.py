"""Logical-axis sharding: rules, the rank's slices, and per-arch policies
(counterpart of ``repro/distributed/sharding.py``).

Model code names the axes of its tensors *logically* ("batch", "heads",
"embed", ...).  A :class:`ShardingRules` maps logical names to mesh axes;
:func:`rules_for` picks the mapping per (arch x shape x mesh) with the
reference's decisions.

The reference hands its specs to GSPMD, which places every array.  The port
runs explicit SPMD over ``torch.distributed``: every rank runs the same
program on its local slice of whatever the rules shard (:func:`local_slice`,
:func:`shard_tree`, :func:`placements` for DTensor), and the code that
crosses ranks calls the collectives itself
(:mod:`repro_torch.distributed.collectives`,
:mod:`repro_torch.distributed.tensor_parallel`,
:func:`repro_torch.models.layers.moe.moe_ep`).  :func:`constrain` is the
identity: a layout change is an explicit collective in the layer that
needs it.  Serving keeps the weights whole on every rank; training cuts
them, their gradients and the optimizer state into each rank's slices.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over an
initialised world (:func:`repro_torch.launch.mesh.make_host_mesh`), or, for
the policy's accounting alone, a :class:`MeshShape`: axis names and sizes
with no ranks behind them (the production 16 x 16 and 2 x 16 x 16 meshes).
Both answer ``mesh_dim_names`` and ``shape``.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

# Logical axis vocabulary (the reference's):
#   batch      activation batch dim
#   seq        activation sequence dim
#   kv_seq     KV-cache sequence dim (context parallelism during decode)
#   embed      model dim of params (FSDP shard axis)
#   embed_act  model dim of activations (sequence-parallel regions only)
#   heads      attention query heads (TP)
#   kv_heads   attention KV heads (TP when divisible, else replicated)
#   ff         feed-forward hidden (TP)
#   vocab      vocabulary dim (TP)
#   experts    MoE expert dim (EP)
#   ff_expert  per-expert hidden dim
#   layers     stacked-layer dim (never sharded)
#   state      SSM/xLSTM recurrent state dims (never sharded)
#   conv       conv kernel spatial dims (never sharded)

Axis = Any  # str | tuple[str, ...] | None


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no ranks behind it: what the
    policy reads of a mesh.  ``MeshShape(("data", "model"), (16, 16))`` is
    the reference's single-pod production mesh."""
    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.mesh_dim_names) != len(self.shape):
            raise ValueError(f"axis names {self.mesh_dim_names} and sizes "
                             f"{self.shape} differ in length")


def axis_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> size, of a DeviceMesh or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclass(frozen=True)
class ShardingRules:
    rules: Mapping[str, Axis] = field(default_factory=dict)

    def spec(self, axes: Sequence[str | None]) -> tuple:
        """The mesh-axis entry of each logical axis (the reference's
        ``PartitionSpec``): None, a mesh axis name, or a tuple of them;
        trailing Nones trimmed."""
        parts = [None if ax is None else self.rules.get(ax) for ax in axes]
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)


_STATE = threading.local()


def current_rules() -> ShardingRules | None:
    return getattr(_STATE, "rules", None)


def current_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_rules(rules: ShardingRules, mesh=None):
    """Make ``rules`` (and ``mesh``) current on this thread inside the
    block, as the reference's context does."""
    prev_r = getattr(_STATE, "rules", None)
    prev_m = getattr(_STATE, "mesh", None)
    _STATE.rules, _STATE.mesh = rules, mesh
    try:
        yield rules
    finally:
        _STATE.rules, _STATE.mesh = prev_r, prev_m


def logical_to_spec(axes: Sequence[str | None],
                    rules: ShardingRules | None = None) -> tuple:
    rules = rules or current_rules()
    if rules is None:
        return ()
    return rules.spec(axes)


def constrain(x, *axes: str | None):
    """The reference's sharding annotation.  Every port tensor is already
    the rank's local slice, and the code that changes a layout calls its
    collective itself (the sequence-sharded decode, tensor and sequence
    parallelism, expert parallelism), so this is the identity: the
    numbers the reference computes under GSPMD are the same numbers."""
    del axes
    return x


def _mesh_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_slice(shape: Sequence[int], spec: tuple, mesh,
                coordinate: Sequence[int] | None = None) -> tuple[slice, ...]:
    """The slice of a tensor of global ``shape`` that the rank at
    ``coordinate`` (its index along each mesh axis; default the calling
    rank's, ``mesh.get_coordinate()``) holds under ``spec``.  An entry
    that names several mesh axes, such as ``("pod", "data")``, cuts its
    dim major to minor in the order named, as JAX does.  A dim that its
    mesh axes do not divide raises."""
    if coordinate is None:
        coordinate = mesh.get_coordinate()
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        parts, index = 1, 0
        for ax in _mesh_axes(entry):
            parts, index = parts * sizes[ax], index * sizes[ax] + coordinate[names.index(ax)]
        if n % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} is not divisible by "
                             f"the {parts} shards of {entry!r}")
        step = n // parts
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def placements(spec: tuple, mesh) -> list:
    """``spec`` as DTensor placements on ``mesh``: each mesh axis that
    shards tensor dim i gives ``Shard(i)``, the rest ``Replicate()``.  An
    entry that names several mesh axes shards its dim major to minor in
    the order named (JAX's order); DTensor nests ``Shard`` placements of
    one dim in mesh-axis order, so the names must come in the mesh's own
    order, or this raises.  The slices DTensor gives each rank are then
    :func:`local_slice`'s."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _mesh_axes(entry)
        idx = [names.index(ax) for ax in axes]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry!r} names mesh axes against the mesh's "
                             f"order {names}: DTensor cannot shard dim {dim} so")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return out


def _is_axes(a) -> bool:
    """A leaf's logical axes: a plain tuple of names (NamedTuples and lists
    are containers)."""
    return (isinstance(a, tuple) and not hasattr(a, "_fields")
            and all(x is None or isinstance(x, (str, tuple)) for x in a))


def map_with_axes(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over a tree of tensors beside its axes tree."""
    if _is_axes(axes_tree):
        return fn(tree, axes_tree)
    if isinstance(axes_tree, Mapping):
        if set(tree) != set(axes_tree):
            raise ValueError(f"keys {sorted(tree)} against axes {sorted(axes_tree)}")
        return {k: map_with_axes(fn, tree[k], axes_tree[k]) for k in tree}
    return type(tree)(map_with_axes(fn, t, a) for t, a in zip(tree, axes_tree, strict=True))


def shard_tree(tree, axes_tree, rules: ShardingRules, mesh,
               coordinate: Sequence[int] | None = None):
    """The calling rank's slices of ``tree`` (tensors beside their logical
    axes), each a contiguous clone: a view would keep the whole tensor's
    storage alive, and the rank's bytes would not fall."""
    return map_with_axes(lambda t, ax: local_part(t, ax, rules, mesh, coordinate),
                         tree, axes_tree)


def local_part(t: torch.Tensor, axes, rules: ShardingRules, mesh,
               coordinate: Sequence[int] | None = None) -> torch.Tensor:
    """The calling rank's slice of ``t`` (logical ``axes``), a contiguous
    copy (:func:`shard_tree`'s leaf)."""
    part = t[local_slice(t.shape, rules.spec(list(axes)), mesh, coordinate)]
    return part.clone(memory_format=torch.contiguous_format)


def gather_tree(tree, axes_tree, rules: ShardingRules, mesh):
    """Undo :func:`shard_tree` on every rank: each leaf all-gathered along
    every dim its spec shards, minor mesh axis first, so the whole tensor
    comes back on every rank (one ``all_gather`` a sharded dim and mesh
    axis; every rank of the mesh must call it)."""
    from repro_torch.distributed.collectives import gather_whole

    def whole(t, ax):
        for dim, entry in enumerate(rules.spec(list(ax))):
            for name in reversed(_mesh_axes(entry)):
                t = gather_whole(t, dim, mesh.get_group(name))
        return t
    return map_with_axes(whole, tree, axes_tree)


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def _mesh_axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def param_count(cfg: ModelConfig) -> int:
    """Closed-form parameter-count estimate used for policy decisions."""
    d, L = cfg.d_model, cfg.num_layers
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.moe is not None:
        m = cfg.moe
        routed = m.num_experts * 3 * d * m.d_ff_expert
        shared = m.num_shared_experts * 3 * d * m.d_ff_shared
        router = d * m.num_experts
        moe_layers = L - m.first_k_dense
        ffn = moe_layers * (routed + shared + router)
        ffn += m.first_k_dense * 3 * d * (m.d_ff_dense or cfg.d_ff)
    else:
        ffn = L * 3 * d * cfg.d_ff
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return L * attn + ffn + embed


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top-k + shared experts count)."""
    if cfg.moe is None:
        return param_count(cfg)
    d, L, m = cfg.d_model, cfg.num_layers, cfg.moe
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    routed = m.top_k * 3 * d * m.d_ff_expert
    shared = m.num_shared_experts * 3 * d * m.d_ff_shared
    moe_layers = L - m.first_k_dense
    ffn = moe_layers * (routed + shared + d * m.num_experts)
    ffn += m.first_k_dense * 3 * d * (m.d_ff_dense or cfg.d_ff)
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return L * attn + ffn + embed


# Models above this size get FSDP (params sharded on the data axis too).
FSDP_THRESHOLD_PARAMS = 8e9


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh,
              *, fsdp: bool | None = None,
              seq_shard_kv: bool | None = None) -> ShardingRules:
    """Pick the sharding policy for one (arch x shape x mesh) cell, by the
    reference's decisions; ``mesh`` is read for its axis names and sizes
    only (a DeviceMesh or a :class:`MeshShape`)."""
    names = tuple(mesh.mesh_dim_names)
    model_sz = _mesh_axis_size(mesh, "model")
    data_sz = _mesh_axis_size(mesh, "data")
    pod_sz = _mesh_axis_size(mesh, "pod")
    has_pod = "pod" in names

    n_params = param_count(cfg)
    if fsdp is None:
        fsdp = n_params >= FSDP_THRESHOLD_PARAMS and shape.kind == "train"
        # Serving giant models: weights must still be spread beyond TP to fit
        # (bf16 serving params; keep per-chip weight share under ~2 GB).
        if shape.kind != "train":
            fsdp = n_params * 2 / (model_sz or 1) > 2e9
    if seq_shard_kv is None:
        # Context-parallel KV cache: decode runs the LSE-merge path; prefill
        # lays its returned cache out the same way.
        seq_shard_kv = shape.kind in ("decode", "prefill")

    batch_axes: Axis = ("pod", "data") if has_pod else ("data",)
    dp_total = data_sz * (pod_sz if has_pod else 1)
    if shape.global_batch % dp_total != 0 or shape.global_batch < dp_total:
        # e.g. long_500k batch=1: replicate batch rather than pad.
        batch_axes = None

    heads_axis: Axis = "model" if cfg.num_heads % max(model_sz, 1) == 0 else None
    kv_heads_axis: Axis = "model" if cfg.num_kv_heads % max(model_sz, 1) == 0 else None
    # Odd vocabularies (e.g. whisper's 51865) cannot shard across the model
    # axis; replicate the embedding/LM head instead of padding the table.
    vocab_axis: Axis = "model" if cfg.vocab_size % max(model_sz, 1) == 0 else None

    rules: dict[str, Axis] = {
        "batch": batch_axes,
        "seq": None,
        # MoE dispatch region: sequence sharded over the model axis so every
        # device owns a disjoint token slice before the EP all-to-all.
        "seq_model": "model",
        # Sequence-parallel residual stream (training).
        "seq_sp": "model" if (shape.kind == "train"
                              and shape.seq_len % max(model_sz, 1) == 0)
                  else None,
        "kv_seq": "model" if seq_shard_kv else None,
        "embed": "data" if fsdp else None,
        "embed_act": None,
        "heads": heads_axis,
        "kv_heads": kv_heads_axis,
        "ff": "model",
        "vocab": vocab_axis,
        "experts": "model",
        "ff_expert": None,
        "layers": None,
        "state": None,
        "conv": None,
    }
    # When decode KV is sequence-sharded, attention runs distributed over
    # kv_seq; KV heads stay local to avoid double-sharding the cache.
    if seq_shard_kv:
        rules["kv_heads"] = None
    return ShardingRules(rules)


def shard_of(mesh, rules: ShardingRules | None, logical: str) -> tuple[int, int]:
    """(number of shards, this rank's index) of the logical axis
    ``logical`` on ``mesh`` under ``rules``: (1, 0) without a mesh or where
    the rules leave it unsharded.  An entry that names several mesh axes,
    such as ``("pod", "data")``, counts their shards together, major to
    minor in the order named (:func:`local_slice`'s order)."""
    if mesh is None or rules is None:
        return 1, 0
    parts, index = 1, 0
    for ax in _mesh_axes(rules.rules.get(logical)):
        size = _mesh_axis_size(mesh, ax)
        parts, index = parts * size, index * size + (mesh.get_local_rank(ax)
                                                     if size > 1 else 0)
    return parts, index


def seq_rows(n: int, logical: str = "kv_seq") -> tuple[int, int]:
    """(rows, first row) that the calling rank holds of a dim of ``n`` rows
    whose logical axis is ``logical``, under the current rules and mesh:
    (n, 0) where it is unsharded; (n / M, rank * n / M) on a mesh axis of M
    ranks.  Raises where M does not divide n."""
    parts, index = shard_of(current_mesh(), current_rules(), logical)
    if n % parts:
        raise ValueError(f"{logical} of {n} rows does not divide into {parts} shards")
    return n // parts, index * (n // parts)


def require_whole(logical: str, what: str) -> None:
    """Raise where the current rules split ``logical`` over more than one
    rank: ``what`` allocates or writes that dim whole."""
    parts, _ = shard_of(current_mesh(), current_rules(), logical)
    if parts > 1:
        raise NotImplementedError(
            f"{what} holds its {logical} dim whole, and the rules split it over {parts} "
            f"ranks: serving under a mesh cuts only the dense transformer's contiguous "
            f"caches into rank slices so far")
