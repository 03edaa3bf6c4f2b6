"""Sharding policy glue: the logical axes, and from them the specs, of every
tree a step touches (counterpart of ``repro/distributed/policy.py``).

Per (arch x shape x mesh) cell: the parameters' axes (from the tables'
``ParamDef.axes``), the optimizer state's (derived by the optimizer), the
decode state's (per family) and the input batch's.  Where the reference
turns each into a ``NamedSharding`` for GSPMD, the port turns a leaf's
axes into a spec (:meth:`ShardingRules.spec`), which gives each rank its
slice (:func:`~repro_torch.distributed.sharding.local_slice`) or its
DTensor placements (:func:`~repro_torch.distributed.sharding.placements`),
and counts the bytes each device holds (:func:`sharded_bytes_per_device`).
"""
from __future__ import annotations

from typing import Mapping

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import ShardingRules, axis_sizes, rules_for
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models.layers.module import tree_map
from repro_torch.models.layers.xlstm import MLSTMState, SLSTMState
from repro_torch.models.registry import fns_for


def _is_axes_leaf(t) -> bool:
    """A plain tuple of axis names (NamedTuples are containers, not leaves)."""
    return (isinstance(t, tuple) and not hasattr(t, "_fields")
            and all(x is None or isinstance(x, (str, tuple)) for x in t))


def _pairs(tree, axes_tree):
    """(leaf, its axes) of a tree of tensors beside its axes tree."""
    if _is_axes_leaf(axes_tree):
        yield tree, axes_tree
    elif isinstance(axes_tree, Mapping):
        if set(tree) != set(axes_tree):
            raise ValueError(f"keys {sorted(tree)} against axes {sorted(axes_tree)}")
        for k in axes_tree:
            yield from _pairs(tree[k], axes_tree[k])
    else:
        for t, a in zip(tree, axes_tree, strict=True):
            yield from _pairs(t, a)


def param_axes(cfg: ModelConfig):
    return tree_map(lambda d: d.axes, fns_for(cfg).table(cfg))


def opt_state_axes(cfg: ModelConfig, optimizer):
    return optimizer.state_axes(param_axes(cfg))


# --- decode state -----------------------------------------------------------

def decode_state_axes(cfg: ModelConfig, cache_dtype: str = "bfloat16"):
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        if cache_dtype == "int8":
            sc = ("layers", "batch", "kv_seq", "kv_heads")
            return transformer.QuantKVCache(k=kv, v=kv, k_scale=sc, v_scale=sc,
                                            length=("batch",))
        return transformer.KVCache(k=kv, v=kv, length=("batch",))
    if fam == "hybrid":
        return hybrid.HybridState(
            conv_seg=(None, None, "batch", None, "ff"),
            ssm_seg=(None, None, "batch", "heads", None, None),
            conv_tail=(None, "batch", None, "ff"),
            ssm_tail=(None, "batch", "heads", None, None),
            kv_k=(None, "batch", "kv_seq", "kv_heads", None),
            kv_v=(None, "batch", "kv_seq", "kv_heads", None),
            length=("batch",))
    if fam == "ssm":
        states = []
        for i in range(cfg.num_layers):
            if i % cfg.xlstm.slstm_every == 1:
                states.append(SLSTMState(h=("batch", None), c=("batch", None),
                                         n=("batch", None), m=("batch", None)))
            else:
                states.append(MLSTMState(conv=("batch", None, "ff"),
                                         mem=("batch", "heads", None, None)))
        return {"states": states, "length": ("batch",)}
    if fam == "audio":
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        return encdec.EncDecState(
            self_k=kv, self_v=kv,
            cross_k=("layers", "batch", None, "kv_heads", None),
            cross_v=("layers", "batch", None, "kv_heads", None),
            length=("batch",))
    raise ValueError(fam)


# --- inputs -------------------------------------------------------------------

def batch_axes_for(name: str, ndim: int):
    if name == "positions":
        return (None, "batch", "seq")
    if name == "frames":
        return ("batch", None, None)
    if name == "images":
        return ("batch", None, None, None)
    if ndim == 1:
        return ("batch",)
    return ("batch", "seq")[:ndim] if ndim <= 2 else \
        ("batch",) + (None,) * (ndim - 1)


def sharded_bytes_per_device(tree, axes_tree, rules: ShardingRules, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, ``meta`` ones too)
    under ``rules`` on ``mesh`` (a DeviceMesh or a ``MeshShape``), each
    leaf's bytes divided by the product of the mesh axes its spec names,
    rounded up: analytic, the reference's count."""
    sizes = axis_sizes(mesh)
    total = 0
    for leaf, axes in _pairs(tree, axes_tree):
        n = leaf.numel() * leaf.element_size()
        denom = 1
        for entry in rules.spec(list(axes)):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    denom *= sizes.get(ax, 1)
        total += -(-n // denom)
    return total


# --- cell bundle ----------------------------------------------------------------

def cell_policy(cfg: ModelConfig, shape: ShapeConfig, mesh, **overrides) -> ShardingRules:
    """Everything a launcher needs for one cell: its rules."""
    return rules_for(cfg, shape, mesh, **overrides)
