"""Train-step factory (counterpart of ``repro/training/train_step.py``):
forward and backward of each microbatch (the blocks recomputed in the
backward under ``remat="full"``), gradients accumulated across
microbatches, then the optimizer's in-place update.

The reference sums per-microbatch gradient trees in a ``lax.scan``; here
each parameter's ``.grad`` is the accumulator: autograd adds every
microbatch's gradient into it in place (``0 + g1 + g2 + ...``, the
reference's order), in the parameter's dtype -- fp32, or bf16 for bf16
parameters, as the reference's ``acc_dt`` -- and the sum is divided by
the number of microbatches.

Under the current mesh and rules (:func:`~repro_torch.distributed.sharding.
use_rules`: the reference's ``jax.jit(step, in_shardings=...)`` under
``use_rules(rules, mesh)``) the step runs explicit SPMD on the rank's
slices of the parameters and optimizer state (:func:`~repro_torch.
distributed.sharding.shard_tree`).  The global batch is split into
microbatches first, as the reference splits it, and each microbatch then
cut to the rank's rows (``pipeline.shard_batch``).  Each rank's loss is its
share (:mod:`repro_torch.distributed.tensor_parallel`); after the last
microbatch every gradient is summed over the mesh axes its parameter is
replicated on -- the mean over ``data`` (and ``pod``), the sum over
``model`` of a replicated parameter read on the rank's rows or heads --
while an FSDP parameter's gather has reduce-scattered it over ``data``
already; and the metrics are summed to the global means, the same on every
rank.  The optimizer reads the leaves' layout for its global norm and
Adafactor's factored means (:class:`~repro_torch.optim.optimizers.ShardLayout`).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import collectives as C
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.layers.module import tree_map
from repro_torch.models.registry import fns_for
from repro_torch.optim.optimizers import ShardLayout, leaves
from repro_torch.training.losses import classification_cross_entropy, lm_cross_entropy

_METRIC_KEYS = ("loss", "nll", "accuracy", "aux_loss")


def make_loss_fn(cfg, *, chunk: int = 4096) -> Callable:
    """(params, batch of tensors[, plan]) -> (loss + aux, metrics).  Under
    a training plan each is the rank's share: the transformer families'
    loss by :func:`lm_cross_entropy` with the plan, and the aux loss (the whole
    batch's on every rank) divided among the model axis's ranks; the
    other families run whole on a model axis of one rank, and their loss
    is the data shard's mean."""
    fns = fns_for(cfg)

    def loss_fn(params, batch, tp=None):
        if cfg.family == "cnn":
            logits, aux = fns.forward(cfg, params, batch)
            loss, m = classification_cross_entropy(logits, batch["labels"])
            metrics = {"loss": loss, "nll": loss, "accuracy": m["accuracy"],
                       "aux_loss": aux}
        else:
            logits, aux = fns.forward(cfg, params, batch, chunk=chunk)
            if tp is not None and cfg.family not in TP.TP_FAMILIES:
                tp = None                # whole logits of the data shard's rows
            loss, m = lm_cross_entropy(logits, batch["labels"], tp=tp)
            if tp is not None and tp.model_size > 1:
                aux = aux / tp.model_size
            metrics = {"loss": loss, "nll": m["nll"],
                       "accuracy": m["accuracy"], "aux_loss": aux}
        return loss + aux, metrics

    return loss_fn


def _split_microbatches(batch: dict, accum: int) -> dict:
    """(B, ...) -> (A, B/A, ...) along the batch axis of every input (numpy
    arrays or tensors).  The batch axis is the first but in M-RoPE's
    positions, ``batch["positions"]`` of shape (3, B, S), known by its key
    and rank: a batch of 3 whisper ``frames`` (B, F, D) or GoogLeNet
    ``images`` (B, H, W, 3) is split along its first axis like the rest
    (the reference takes any input of rank 3 or more with a first axis of
    3 for positions)."""
    def split(k, x):
        if k == "positions" and x.ndim == 3:   # M-RoPE positions (3, B, S)
            return x.reshape(3, accum, x.shape[1] // accum,
                             *x.shape[2:]).swapaxes(0, 1)
        return x.reshape(accum, x.shape[0] // accum, *x.shape[1:])
    return {k: split(k, v) for k, v in batch.items()}


def make_train_step(cfg, optimizer, *, accum: int | None = None,
                    chunk: int = 4096,
                    grad_transform: Callable | None = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); params and opt state are updated in place.  ``batch`` holds
    numpy arrays or tensors; they are moved to the parameters' device.

    ``grad_transform`` hooks the accumulated gradients before the update
    (the reference's cross-pod compression plugs in there).
    """
    if cfg.param_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(f"param_dtype {cfg.param_dtype!r}: gradients "
                                  "accumulate in fp32 or bf16 parameters' .grad")
    loss_fn = make_loss_fn(cfg, chunk=chunk)
    accum = accum if accum is not None else cfg.accum_steps

    def train_step(params, opt_state, batch):
        tp = TP.plan(cfg)
        ps = leaves(params)
        dev = ps[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if accum > 1:
            split = _split_microbatches(batch, accum)
            micro = [{k: v[i] for k, v in split.items()} for i in range(accum)]
        else:
            micro = [batch]
        if tp is not None:
            micro = [shard_batch(mb, tp.mesh, tp.rules) for mb in micro]
        msum = {k: torch.zeros((), dtype=torch.float32, device=dev)
                for k in _METRIC_KEYS}
        for p in ps:
            p.grad = None
            p.requires_grad_(True)
        try:
            for mb in micro:
                total, metrics = loss_fn(params, mb, tp)
                total.backward()
                for k in _METRIC_KEYS:
                    msum[k] += metrics[k].detach().float()
        finally:
            for p in ps:
                p.requires_grad_(False)
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         params)
        for p in ps:
            p.grad = None
        layout = ShardLayout()
        if tp is not None:
            layout = ShardLayout.of(params, fns_for(cfg).table(cfg), tp.rules, tp.mesh)
            _sum_grads(leaves(grads), layout, tp)
            msum = _sum_metrics(msum, tp)
        if accum > 1:
            for g in leaves(grads):
                g.div_(accum)
            msum = {k: v / accum for k, v in msum.items()}
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = optimizer.update(grads, opt_state, params,
                                                          layout=layout)
        return params, opt_state, {**msum, **opt_metrics}

    return train_step


# the most bytes of gradients copied into one buffer for a sum (DDP's
# default bucket); a larger gradient is summed where it lies
BUCKET_BYTES = 25 * 2**20


@torch.no_grad()
def _sum_grads(grads: list, layout, tp) -> None:
    """Each gradient summed over the mesh axes its parameter is replicated
    on (:meth:`ShardLayout.sum_axes`), in place, then divided by
    ``tp.dp``.  The leaves that share those axes and a dtype go in
    buckets of at most :data:`BUCKET_BYTES`, each copied into one buffer
    and summed there, one all-reduce an axis; a leaf of more bytes is
    summed in place."""
    groups: dict = {}
    for i, g in enumerate(grads):
        axes = layout.sum_axes(i)
        if axes:
            groups.setdefault((axes, g.dtype), []).append(g)
    for (axes, _), gs in groups.items():
        for bucket in _buckets(gs):
            alone = len(bucket) == 1 and bucket[0].is_contiguous()
            flat = bucket[0] if alone else torch.cat([g.reshape(-1) for g in bucket])
            for ax in axes:
                C.all_reduce_(flat, tp.mesh.get_group(ax))
            if not alone:
                for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                    g.copy_(part.view_as(g))
    if tp.dp > 1:
        for g in grads:
            g.div_(tp.dp)


def _buckets(gs: list) -> list[list]:
    """``gs`` in order, cut into runs of at most :data:`BUCKET_BYTES`
    (a larger leaf alone)."""
    out: list = []
    size = BUCKET_BYTES
    for g in gs:
        n = g.numel() * g.element_size()
        if size + n > BUCKET_BYTES:
            out.append([])
            size = 0
        out[-1].append(g)
        size += n
    return out


@torch.no_grad()
def _sum_metrics(msum: dict, tp) -> dict:
    """The ranks' metric shares summed over every mesh axis of more than
    one rank (one all-reduce each) and divided by ``tp.dp``: the global
    means."""
    axes = [ax for ax, n in zip(tp.mesh.mesh_dim_names, tp.mesh.shape) if n > 1]
    total = TP.sum_over(torch.stack([msum[k] for k in _METRIC_KEYS]), axes, tp.mesh)
    if tp.dp > 1:
        total = total / tp.dp
    return dict(zip(_METRIC_KEYS, total.unbind()))

