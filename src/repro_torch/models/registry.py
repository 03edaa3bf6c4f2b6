"""Model API for the ported families (counterpart of
``repro/models/registry.py:55-97``, the dense transformer's paged entries).

  init(cfg, generator)                          -> params
  init_paged_state(cfg, num_blocks, block_size, batch, max_blocks, dtype,
                   device=...)                  -> PagedKVCache
  prefill_paged(cfg, params, tokens, state, write_ids, table, *, q_start,
                kv_len, last_idx, chunk)        -> (logits, state)
  decode(cfg, params, tokens, state, chunk)     -> (logits, state)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.models import transformer


@dataclass(frozen=True)
class ModelFns:
    family: str
    init: Callable[..., Any]
    decode: Callable[..., Any]
    init_paged_state: Callable[..., Any]
    prefill_paged: Callable[..., Any]


def _tf_decode(cfg, params, tokens, state, chunk=2048):
    return transformer.decode_step(cfg, params, tokens, state, chunk=chunk)


TRANSFORMER_FNS = ModelFns("dense", transformer.init, _tf_decode,
                           transformer.make_paged_cache,
                           transformer.prefill_paged)


def fns_for(cfg) -> ModelFns:
    """The ported model functions; only the dense family is ported."""
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not ported yet; only "
                         f"'dense' serves through repro_torch")
    return TRANSFORMER_FNS
