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
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.layers.module import tree_map
from repro_torch.models.registry import fns_for
from repro_torch.optim.optimizers import leaves
from repro_torch.training.losses import classification_cross_entropy, lm_cross_entropy

_METRIC_KEYS = ("loss", "nll", "accuracy", "aux_loss")


def make_loss_fn(cfg, *, chunk: int = 4096) -> Callable:
    """(params, batch of tensors) -> (loss + aux, metrics)."""
    fns = fns_for(cfg)

    def loss_fn(params, batch):
        if cfg.family == "cnn":
            logits, aux = fns.forward(cfg, params, batch)
            loss, m = classification_cross_entropy(logits, batch["labels"])
            metrics = {"loss": loss, "nll": loss, "accuracy": m["accuracy"],
                       "aux_loss": aux}
        else:
            logits, aux = fns.forward(cfg, params, batch, chunk=chunk)
            loss, m = lm_cross_entropy(logits, batch["labels"])
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
        ps = leaves(params)
        dev = ps[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if accum > 1:
            split = _split_microbatches(batch, accum)
            micro = [{k: v[i] for k, v in split.items()} for i in range(accum)]
        else:
            micro = [batch]
        msum = {k: torch.zeros((), dtype=torch.float32, device=dev)
                for k in _METRIC_KEYS}
        for p in ps:
            p.grad = None
            p.requires_grad_(True)
        try:
            for mb in micro:
                total, metrics = loss_fn(params, mb)
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
        if accum > 1:
            for g in leaves(grads):
                g.div_(accum)
            msum = {k: v / accum for k, v in msum.items()}
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = optimizer.update(grads, opt_state, params)
        return params, opt_state, {**msum, **opt_metrics}

    return train_step

