"""Model API for the ported families (counterpart of
``repro/models/registry.py``: the dense transformer, ``:55-97``, with the
training forward, the hybrid family, ``:100-118``, and the cnn family,
``:164-173``).

  init(cfg, generator)                          -> params
  prepare_params(cfg, params, device)           -> params on the device,
                                                   product weights cast
  init_paged_state(cfg, num_blocks, block_size, batch, max_blocks, dtype,
                   device=...)                  -> PagedKVCache, or
                                                   QuantPagedKVCache for
                                                   dtype "int8"
  prefill_paged(cfg, params, tokens, state, write_ids, table, *, q_start,
                kv_len, last_idx, chunk)        -> (logits, state)
  verify_paged(cfg, params, tokens, state, table, *, q_start, kv_len,
               chunk)                           -> ((B, C, V) logits, state)
  prefill(cfg, params, batch, max_len, chunk, cache_dtype)
                                                -> (last_logits, state)
  decode(cfg, params, tokens, state, chunk)     -> (logits, state)
  init_decode_state(cfg, batch, max_len, cache_dtype, device=...)
                                                -> contiguous decode state
  forward(cfg, params, batch, ...)              -> (logits, aux_loss)
    (dense and hybrid: ``batch`` holds ``tokens`` [and ``positions``],
    logits (B, S, V); cnn: ``batch`` holds ``images``, logits (B,
    classes))

A family serves from the paged pool when it has ``init_paged_state``, and
from contiguous caches when it has ``init_decode_state``; the dense family
has both, and ``verify_paged`` (speculative decoding) besides.  The dense
``prefill`` reads logits at ``batch["last_pos"]`` when the batch has it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import googlenet, hybrid, transformer


@dataclass(frozen=True)
class ModelFns:
    family: str
    init: Callable[..., Any]
    decode: Callable[..., Any]
    init_paged_state: Callable[..., Any]
    prefill_paged: Callable[..., Any]
    forward: Callable[..., Any] | None = None
    prefill: Callable[..., Any] | None = None
    init_decode_state: Callable[..., Any] | None = None
    prepare_params: Callable[..., Any] | None = None
    verify_paged: Callable[..., Any] | None = None


def _tf_decode(cfg, params, tokens, state, chunk=2048):
    return transformer.decode_step(cfg, params, tokens, state, chunk=chunk)


def _tf_forward(cfg, params, batch, *, remat=True, chunk=1024):
    return transformer.forward(cfg, params, batch["tokens"],
                               batch.get("positions"), remat=remat,
                               chunk=chunk)


def _tf_prefill(cfg, params, batch, max_len=None, chunk=1024,
                cache_dtype="bfloat16"):
    return transformer.prefill(cfg, params, batch["tokens"],
                               batch.get("positions"), max_len=max_len,
                               chunk=chunk, cache_dtype=cache_dtype,
                               last_pos=batch.get("last_pos"))


def _tf_state(cfg, batch, max_len, cache_dtype="bfloat16", *, device="cuda"):
    """Batched contiguous caches; every slot starts idle at ``max_len - 1``,
    so an idle slot's decode writes at most one row and then runs past the
    cache, never over a live one."""
    return transformer.make_cache(
        cfg, batch, max_len, cache_dtype,
        length=torch.full((batch,), max_len - 1, dtype=torch.int32,
                          device=device), device=device)


TRANSFORMER_FNS = ModelFns("dense", transformer.init, _tf_decode,
                           transformer.make_paged_cache,
                           transformer.prefill_paged, forward=_tf_forward,
                           prefill=_tf_prefill, init_decode_state=_tf_state,
                           prepare_params=transformer.prepare_params,
                           verify_paged=transformer.verify_paged)


def _hy_forward(cfg, params, batch, *, remat=True, chunk=1024):
    return hybrid.forward(cfg, params, batch["tokens"], batch.get("positions"),
                          remat=remat, chunk=chunk)


def _hy_prefill(cfg, params, batch, max_len=None, chunk=1024,
                cache_dtype="bfloat16"):
    return hybrid.prefill(cfg, params, batch["tokens"], max_len=max_len,
                          chunk=chunk, cache_dtype=cache_dtype)


def _hy_decode(cfg, params, tokens, state, chunk=2048):
    return hybrid.decode_step(cfg, params, tokens, state, chunk=chunk)


def _hy_state(cfg, batch, max_len, cache_dtype="bfloat16", *, device="cuda"):
    """Batched decode state; every slot starts idle at ``max_len - 1``, so
    an idle slot's decode writes at most one row and then runs past the
    cache, never over a live one."""
    st = hybrid.init_decode_state(cfg, batch, max_len, cache_dtype,
                                  device=device)
    return st._replace(length=torch.full((batch,), max_len - 1,
                                         dtype=torch.int32, device=device))


HYBRID_FNS = ModelFns("hybrid", hybrid.init, _hy_decode, None, None,
                      forward=_hy_forward, prefill=_hy_prefill,
                      init_decode_state=_hy_state,
                      prepare_params=hybrid.prepare_params)


def _gn_forward(cfg, params, batch, *, remat=True, chunk=1024):
    del remat, chunk            # the reference's takes and ignores them too
    logits = googlenet.forward(cfg, params, batch["images"])
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


GOOGLENET_FNS = ModelFns("cnn", googlenet.init, None, None, None,
                         forward=_gn_forward)

_BY_FAMILY = {"dense": TRANSFORMER_FNS, "hybrid": HYBRID_FNS,
              "cnn": GOOGLENET_FNS}


def fns_for(cfg) -> ModelFns:
    """The ported model functions: the dense, hybrid and cnn families."""
    if cfg.family not in _BY_FAMILY:
        raise ValueError(f"family {cfg.family!r} is not ported yet; "
                         f"repro_torch runs {sorted(_BY_FAMILY)}")
    return _BY_FAMILY[cfg.family]
