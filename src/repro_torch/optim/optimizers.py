"""Optimizers (counterpart of ``repro/optim/optimizers.py``): AdamW and
Adafactor, hand-rolled, with the reference's schedules.

The reference returns new parameters and state; here ``update`` writes
both in place, under ``torch.no_grad()``, so a 3B-parameter model holds one
copy of each (fp32 master weights, fp32 moments) and a few leaf-sized
temporaries.  Each update keeps the reference's order of operations, so
the two round alike.  Each optimizer also derives the logical axes of its
state from the parameters' (``state_axes``, the reference's trees), for
the sharding policy (:mod:`repro_torch.distributed.policy`).

On a training mesh the parameters, gradients and state are each rank's
slices, and ``update`` takes their :class:`ShardLayout`: the global norm
sums each leaf's squares over the mesh axes that slice it (a replicated
leaf once), and Adafactor's factored row and column means and its update
RMS are summed over the axes that slice the dims they average, so the
clip and every step are the same on every rank and the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch

from repro_torch.models.layers.module import tree_map

Pytree = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Pytree], Pytree]
    # (grads, state, params) -> (params, state, metrics), params and state
    # updated in place
    update: Callable[[Pytree, Pytree, Pytree], tuple[Pytree, Pytree, dict]]
    # param axes tree -> the state's axes tree (leaves: tuples of axis names)
    state_axes: Callable[[Pytree], Pytree]


def _map_axes(fn: Callable[[tuple], Any], axes_tree: Pytree) -> Pytree:
    """Map ``fn`` over an axes tree, whose leaves are tuples of axis
    names (dicts and lists are its containers)."""
    if isinstance(axes_tree, Mapping):
        return {k: _map_axes(fn, v) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [_map_axes(fn, v) for v in axes_tree]
    return fn(tuple(axes_tree))


def leaves(tree: Pytree) -> list[torch.Tensor]:
    """The tensors of a nested dict / list, in the tree's own order."""
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


@dataclass(frozen=True)
class ShardLayout:
    """Where each leaf of a parameter tree lies on a training mesh: the
    spec of each leaf, in :func:`leaves` order, and the mesh.  Only mesh
    axes of more than one rank count here.  Without a mesh (the default)
    every leaf is whole and every mean the plain one."""
    specs: tuple = ()
    mesh: Any = None

    @staticmethod
    def of(params: Pytree, table: Pytree, rules, mesh) -> "ShardLayout":
        """The layout of ``params`` from its ParamDef table under ``rules``."""
        from repro_torch.distributed.sharding import map_with_axes
        specs: list = []
        map_with_axes(lambda t, ax: specs.append(rules.spec(list(ax))), params,
                      tree_map(lambda d: d.axes, table))
        return ShardLayout(tuple(specs), mesh)

    def _sizes(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names, tuple(self.mesh.shape)))

    def _split(self, entry) -> tuple[str, ...]:
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        return tuple(ax for ax in names if self._sizes()[ax] > 1)

    def dim_axes(self, i: int, dim: int, ndim: int) -> tuple[str, ...]:
        """The mesh axes that slice dim ``dim`` of leaf ``i`` (``ndim`` dims)."""
        if self.mesh is None:
            return ()
        spec, dim = self.specs[i], dim % ndim
        return self._split(spec[dim] if dim < len(spec) else None)

    def leaf_axes(self, i: int) -> tuple[str, ...]:
        """The mesh axes that slice leaf ``i``."""
        if self.mesh is None:
            return ()
        return tuple(ax for entry in self.specs[i] for ax in self._split(entry))

    def sum_axes(self, i: int) -> tuple[str, ...]:
        """The mesh axes leaf ``i``'s gradient is summed over: every one
        that does not slice it (its copies there each hold a share)."""
        if self.mesh is None:
            return ()
        named = self.leaf_axes(i)
        return tuple(ax for ax, n in self._sizes().items() if n > 1 and ax not in named)

    def mean(self, t: torch.Tensor, dim: int | None, axes, keepdim: bool = False):
        """``t.mean(dim)`` (every dim for None) where the dims averaged are
        sliced over ``axes``: the slices are equal, so the mean of the
        ranks' means."""
        m = t.mean() if dim is None else t.mean(dim, keepdim=keepdim)
        if not axes:
            return m
        from repro_torch.distributed.tensor_parallel import sum_over
        n = math.prod(self._sizes()[ax] for ax in axes)
        return sum_over(m, axes, self.mesh) / n

    def sum_leaves(self, values: list) -> list:
        """Per-leaf 0-d values, each summed over the axes that slice its leaf
        (one all-reduce a mesh axis, the leaves it does not slice masked
        out of it)."""
        if self.mesh is None:
            return values
        from repro_torch.distributed.tensor_parallel import sum_over
        v = torch.stack(values)
        for ax in self.mesh.mesh_dim_names:
            on = [ax in self.leaf_axes(i) for i in range(len(self.specs))]
            if not any(on):
                continue
            on = torch.tensor(on, device=v.device)
            v = torch.where(on, sum_over(torch.where(on, v, 0), (ax,), self.mesh), v)
        return list(v.unbind())


_WHOLE = ShardLayout()


def global_norm(tree: Pytree, layout: ShardLayout = _WHOLE) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    return torch.sqrt(sum(layout.sum_leaves(sq)))


@torch.no_grad()
def clip_by_global_norm(grads: Pytree, max_norm: float,
                        layout: ShardLayout = _WHOLE):
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping)."""
    norm = global_norm(grads, layout)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _next_step(state, params):
    """Advance the host-side int32 step; returns it as float32 and the
    device of the parameters (the per-step scalars are computed on the
    host, in float32 as the reference does, and moved there once)."""
    state["step"].add_(1)
    return state["step"].float(), leaves(params)[0].device


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(schedule: Callable[[torch.Tensor], torch.Tensor], *,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: float = 1.0) -> Optimizer:

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, layout: ShardLayout = _WHOLE):
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, layout)
        s, dev = _next_step(state, params)
        lr = schedule(s).to(dev)
        c1, c2 = (1.0 - b1 ** s).to(dev), (1.0 - b2 ** s).to(dev)
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["mu"]),
                              leaves(state["nu"])):
            g = g.float()               # per-leaf cast: no full fp32 copy
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square().mul_(1 - b2))
            delta = (m / c1).div_((v / c2).sqrt_().add_(eps))
            p32 = p.float()
            p.copy_(p32 - delta.add_(p32 * weight_decay).mul_(lr))
        return params, state, {"grad_norm": gnorm, "lr": lr}

    def state_axes(param_axes):
        return {"mu": param_axes, "nu": param_axes, "step": ()}

    return Optimizer(init=init, update=update, state_axes=state_axes)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment over the last two dims; no momentum)
# ---------------------------------------------------------------------------

def _factored(p_shape) -> bool:
    return len(p_shape) >= 2 and p_shape[-1] > 1 and p_shape[-2] > 1


def adafactor(schedule: Callable[[torch.Tensor], torch.Tensor], *,
              decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0,
              max_grad_norm: float = 1.0) -> Optimizer:

    def init(params):
        def mk(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"v": tree_map(mk, params), "step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, layout: ShardLayout = _WHOLE):
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, layout)
        s, dev = _next_step(state, params)
        lr = schedule(s).to(dev)
        # time-dependent decay (Adafactor beta2 schedule)
        beta2 = (1.0 - s ** (-decay)).to(dev)
        v_state = [leaves(v) for v in _per_param(state["v"], params)]
        for i, (p, g, v) in enumerate(zip(leaves(params), leaves(grads), v_state)):
            g = g.float()               # per-leaf cast: no full fp32 copy
            g2 = g.square().add_(eps)
            nd = p.ndim
            if len(v) == 2:             # factored by the whole leaf's shape at init
                vr, vc = v
                row, col = layout.dim_axes(i, -2, nd), layout.dim_axes(i, -1, nd)
                vr.copy_(beta2 * vr + (1 - beta2) * layout.mean(g2, -1, col))
                vc.copy_(beta2 * vc + (1 - beta2) * layout.mean(g2, -2, row))
                rmean = layout.mean(vr, -1, row, keepdim=True)
                rfac = torch.rsqrt(vr / torch.clamp(rmean, min=eps) + eps)
                cfac = torch.rsqrt(vc + eps)
                delta = g * rfac[..., None] * cfac[..., None, :]
            else:
                (vv,) = v
                vv.copy_(beta2 * vv + (1 - beta2) * g2)
                delta = g * torch.rsqrt(vv + eps)
            # update clipping by RMS
            rms = torch.sqrt(layout.mean(delta.square(), None, layout.leaf_axes(i)) + 1e-30)
            delta = delta / torch.clamp(rms / clip_threshold, min=1.0)
            p32 = p.float()
            p.copy_(p32 - lr * (delta + weight_decay * p32))
        return params, state, {"grad_norm": gnorm, "lr": lr}

    def state_axes(param_axes):
        # the reference's rule: factored by the number of axes alone
        def mk(ax):
            if len(ax) >= 2:
                return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
            return {"v": ax}
        return {"v": _map_axes(mk, param_axes), "step": ()}

    return Optimizer(init=init, update=update, state_axes=state_axes)


def _per_param(v_tree: Pytree, params: Pytree) -> list[Pytree]:
    """Adafactor's state dict of each parameter, in the parameters' order
    (each is {"vr", "vc"} or {"v"}: a dict, not a subtree to walk)."""
    if isinstance(params, Mapping):
        return [s for k in params for s in _per_param(v_tree[k], params[k])]
    return [v_tree]


# ---------------------------------------------------------------------------
# schedules: step (int or 0-d tensor) -> 0-d float32 learning rate
# ---------------------------------------------------------------------------

def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    def schedule(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return peak_lr * torch.where(s < warmup, warm, cos)
    return schedule


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32)


def make_optimizer(cfg, *, peak_lr: float = 3e-4, warmup: int = 200,
                   total: int = 10_000) -> Optimizer:
    sched = warmup_cosine(peak_lr, warmup, total)
    if cfg.optimizer == "adafactor":
        return adafactor(sched)
    return adamw(sched)
