"""Model API for the ported families (counterpart of
``repro/models/registry.py``: the dense transformer's paged entries,
``:55-97``, and the cnn family, ``:164-173``).

  init(cfg, generator)                          -> params
  init_paged_state(cfg, num_blocks, block_size, batch, max_blocks, dtype,
                   device=...)                  -> PagedKVCache
  prefill_paged(cfg, params, tokens, state, write_ids, table, *, q_start,
                kv_len, last_idx, chunk)        -> (logits, state)
  decode(cfg, params, tokens, state, chunk)     -> (logits, state)
  forward(cfg, params, batch)                   -> (logits, aux_loss)
    (cnn only; ``batch`` holds ``images``)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import googlenet, transformer


@dataclass(frozen=True)
class ModelFns:
    family: str
    init: Callable[..., Any]
    decode: Callable[..., Any]
    init_paged_state: Callable[..., Any]
    prefill_paged: Callable[..., Any]
    forward: Callable[..., Any] | None = None


def _tf_decode(cfg, params, tokens, state, chunk=2048):
    return transformer.decode_step(cfg, params, tokens, state, chunk=chunk)


TRANSFORMER_FNS = ModelFns("dense", transformer.init, _tf_decode,
                           transformer.make_paged_cache,
                           transformer.prefill_paged)


def _gn_forward(cfg, params, batch):
    logits = googlenet.forward(cfg, params, batch["images"])
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


GOOGLENET_FNS = ModelFns("cnn", googlenet.init, None, None, None,
                         forward=_gn_forward)

_BY_FAMILY = {"dense": TRANSFORMER_FNS, "cnn": GOOGLENET_FNS}


def fns_for(cfg) -> ModelFns:
    """The ported model functions: the dense and cnn families."""
    if cfg.family not in _BY_FAMILY:
        raise ValueError(f"family {cfg.family!r} is not ported yet; "
                         f"repro_torch runs {sorted(_BY_FAMILY)}")
    return _BY_FAMILY[cfg.family]
