"""Single-source-of-truth parameter tables (counterpart of
``repro/models/layers/module.py``).

A *table* is a nested dict whose leaves are :class:`ParamDef` -- (shape,
logical axes, init).  The initialized parameters have the reference's names
and shapes leaf for leaf, including the stacked ``(L, ...)`` layer layout of
:func:`stack_table`, so a JAX parameter pytree converts one to one
(:mod:`repro_torch.interop`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch

from repro_torch.common import (dtype_of, ones_init, truncated_normal_init,
                                zeros_init)

InitFn = Callable[[torch.Generator, tuple[int, ...], Any], torch.Tensor]


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: InitFn = truncated_normal_init
    layer: "ParamDef | None" = None    # a stacked leaf's one-layer def

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def weight(shape: tuple[int, ...], axes: tuple[str | None, ...],
           stddev: float | None = None) -> ParamDef:
    if stddev is None:
        return ParamDef(tuple(shape), tuple(axes), truncated_normal_init)

    def init(gen, shp, dtype, _s=stddev):
        return truncated_normal_init(gen, shp, dtype, stddev=_s)
    return ParamDef(tuple(shape), tuple(axes), init)


def bias(shape: tuple[int, ...], axes: tuple[str | None, ...]) -> ParamDef:
    return ParamDef(tuple(shape), tuple(axes), zeros_init)


def scale(shape: tuple[int, ...], axes: tuple[str | None, ...]) -> ParamDef:
    return ParamDef(tuple(shape), tuple(axes), ones_init)


Table = Mapping[str, Any]  # nested dict of ParamDef


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Map ``fn`` over the leaves of a nested dict/list/tuple."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def stack_table(table: Table, num: int) -> Table:
    """Prepend a stacked 'layers' dim to every leaf; each layer's slice is
    initialized by the leaf's own init, as the reference's vmap does."""
    def _stack(d: ParamDef) -> ParamDef:
        def init(gen, shape, dtype, _d=d):
            return torch.stack([_d.init(gen, _d.shape, dtype)
                                for _ in range(num)])
        return ParamDef((num, *d.shape), ("layers", *d.axes), init, layer=d)
    return tree_map(_stack, table)


def cast_product_weights(params: Any, names: tuple[str, ...], dtype,
                         device=None) -> Any:
    """Move ``params`` to ``device`` and cast every leaf whose name is in
    ``names`` to ``dtype``, once.  The reference casts those fp32 weights
    to the compute dtype before every product; casting once at load gives
    the same numbers."""
    dt = dtype_of(dtype)

    def walk(tree, name=None):
        if isinstance(tree, Mapping):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        t = tree.to(device) if device is not None else tree
        return t.to(dt) if name in names else t
    return walk(params)


def _draw(gen: torch.Generator, d: ParamDef, dtype, out_dtype,
          place=None) -> torch.Tensor:
    """Leaf ``d`` drawn in ``dtype`` and stored in ``out_dtype``, and cut by
    ``place``: a stacked leaf a layer at a time, each layer cast and cut
    before the next is drawn."""
    if d.layer is None or (out_dtype == dtype and place is None):
        t = d.init(gen, d.shape, dtype).to(out_dtype)
        return t if place is None else place(t, d.axes)
    out = None
    for i in range(d.shape[0]):
        t = _draw(gen, d.layer, dtype, out_dtype, place)
        if out is None:
            out = torch.empty((d.shape[0], *t.shape), dtype=out_dtype, device=t.device)
        out[i] = t
    return out


def init_table(gen: torch.Generator, table: Table, dtype, cast=None,
               place=None) -> Any:
    """Initialize every leaf on ``gen``'s device, in table order.  ``cast``
    (names, dtype): the leaves of those names are stored in that dtype --
    the numbers of :func:`cast_product_weights` after a plain init, drawn
    from the generator in the same order, but a layer at a time, so the
    whole tree is never resident in ``dtype``.  ``place(leaf, axes)``: what
    is kept of each drawn leaf, of a stacked leaf each layer (a mesh rank's
    slice: then only one layer of one leaf is ever resident whole)."""
    dt = dtype_of(dtype)
    names, out_dt = (cast[0], dtype_of(cast[1])) if cast else ((), dt)

    def walk(tree, name=None):
        if isinstance(tree, Mapping):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        return _draw(gen, tree, dt, out_dt if name in names else dt, place)
    return walk(table)
