"""Model API for the ported families (counterpart of
``repro/models/registry.py``: the dense transformer, ``:55-97``, with the
training forward, which serves the MoE and vlm families too, the hybrid
family, ``:100-118``, the recurrent (ssm) family, ``:121-140``, the
encoder-decoder (audio) family, ``:143-161``, and the cnn family,
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
  table(cfg)                                    -> the ParamDef table
                                                   (the sharding policy's)
    (dense, vlm, hybrid and ssm: ``batch`` holds ``tokens`` [and
    ``positions``, (3, B, S) under M-RoPE], logits (B, S, V); audio:
    ``tokens`` and ``frames`` (B, F, d_model); cnn: ``batch`` holds
    ``images``, logits (B, classes)); the training forward of every family

A family serves from the paged pool when it has ``init_paged_state``, and
from contiguous caches when it has ``init_decode_state``; the dense family
(and the moe and vlm families on its functions) has both, and
``verify_paged`` (speculative decoding) besides; the hybrid, ssm and audio
families only the contiguous state.  The dense ``prefill`` reads logits at
``batch["last_pos"]`` when the batch has it; the audio ``prefill`` encodes
``batch["frames"]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import encdec, googlenet, hybrid, recurrent, transformer


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
    table: Callable[..., Any] | None = None    # cfg -> ParamDef table (the policy's)


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
                           verify_paged=transformer.verify_paged,
                           table=transformer.lm_table)


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
                      prepare_params=hybrid.prepare_params,
                      table=hybrid.lm_table)


def _rc_forward(cfg, params, batch, *, remat=True, chunk=1024):
    """The ssm family's training forward; ``remat`` and ``chunk`` are
    ignored, as the reference's ``_rc_forward`` ignores them."""
    del remat, chunk
    return recurrent.forward(cfg, params, batch["tokens"])


def _rc_prefill(cfg, params, batch, max_len=None, chunk=1024,
                cache_dtype="bfloat16"):
    return recurrent.prefill(cfg, params, batch["tokens"], max_len=max_len,
                             cache_dtype=cache_dtype)


def _rc_decode(cfg, params, tokens, state, chunk=2048):
    return recurrent.decode_step(cfg, params, tokens, state, chunk=chunk)


def _rc_state(cfg, batch, max_len, cache_dtype="bfloat16", *, device="cuda"):
    """Batched decode state; every slot starts idle at ``max_len - 1``, as
    the reference's."""
    st = recurrent.init_decode_state(cfg, batch, max_len, cache_dtype,
                                     device=device)
    st["length"] = torch.full((batch,), max_len - 1, dtype=torch.int32,
                              device=device)
    return st


RECURRENT_FNS = ModelFns("ssm", recurrent.init, _rc_decode, None, None,
                         forward=_rc_forward, prefill=_rc_prefill,
                         init_decode_state=_rc_state,
                         prepare_params=recurrent.prepare_params,
                         table=recurrent.lm_table)


def _ed_forward(cfg, params, batch, *, remat=True, chunk=1024):
    """The audio family's training forward (:func:`encdec.forward`):
    ``remat`` checkpoints each encoder and decoder block, as the
    reference's ``_ed_forward`` asks its model to."""
    return encdec.forward(cfg, params, batch["tokens"], batch["frames"],
                          remat=remat, chunk=chunk)


def _ed_prefill(cfg, params, batch, max_len=None, chunk=1024,
                cache_dtype="bfloat16"):
    return encdec.prefill(cfg, params, batch["tokens"], batch["frames"],
                          max_len=max_len, chunk=chunk, cache_dtype=cache_dtype)


def _ed_decode(cfg, params, tokens, state, chunk=2048):
    return encdec.decode_step(cfg, params, tokens, state, chunk=chunk)


def _ed_state(cfg, batch, max_len, cache_dtype="bfloat16", *, device="cuda"):
    """Batched decode state; every slot starts idle at ``max_len - 1``, as
    the reference's."""
    st = encdec.init_decode_state(cfg, batch, max_len, cache_dtype,
                                  device=device)
    return st._replace(length=torch.full((batch,), max_len - 1,
                                         dtype=torch.int32, device=device))


ENCDEC_FNS = ModelFns("audio", encdec.init, _ed_decode, None, None,
                      forward=_ed_forward, prefill=_ed_prefill,
                      init_decode_state=_ed_state,
                      prepare_params=encdec.prepare_params,
                      table=encdec.lm_table)


def _gn_forward(cfg, params, batch, *, remat=True, chunk=1024):
    del remat, chunk            # the reference's takes and ignores them too
    logits = googlenet.forward(cfg, params, batch["images"])
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


GOOGLENET_FNS = ModelFns("cnn", googlenet.init, None, None, None,
                         forward=_gn_forward, table=googlenet.model_table)

_BY_FAMILY = {"dense": TRANSFORMER_FNS, "moe": TRANSFORMER_FNS,
              "vlm": TRANSFORMER_FNS, "hybrid": HYBRID_FNS, "ssm": RECURRENT_FNS,
              "audio": ENCDEC_FNS, "cnn": GOOGLENET_FNS}


def fns_for(cfg) -> ModelFns:
    """The ported model functions of every family: moe and vlm through the
    transformer's, as the reference's."""
    if cfg.family not in _BY_FAMILY:
        raise ValueError(f"family {cfg.family!r} is not ported yet; "
                         f"repro_torch runs {sorted(_BY_FAMILY)}")
    return _BY_FAMILY[cfg.family]
