"""Token samplers (host-side, numpy) -- a copy of ``repro/serving/sampler.py``,
with its speculative-decoding acceptance helper.

Samplers are small objects with two entry points:

  * ``sampler(logits_1d) -> int`` — single-request call (back-compat).
  * ``sampler.sample(logits_2d) -> (B,) int64`` — vectorized batch call;
    this is what the continuous-batching engine uses, so the per-step
    sampling cost is a couple of numpy array ops for the whole decode
    batch instead of a Python loop per request.

``batch_key`` groups decode slots that can share one vectorized call:
stateless samplers (greedy) group globally; stateful ones (temperature,
which owns an rng for per-request determinism) group per instance.
"""
from __future__ import annotations

import numpy as np


class Sampler:
    """Base sampler: implement `sample` (vectorized); `__call__` wraps it."""

    def __call__(self, logits: np.ndarray) -> int:
        return int(self.sample(np.asarray(logits)[None])[0])

    def sample(self, logits: np.ndarray) -> np.ndarray:
        """logits: (B, V) -> (B,) sampled token ids."""
        raise NotImplementedError

    @property
    def batch_key(self):
        """Slots whose samplers share a key are sampled in one batch call."""
        return id(self)


class Greedy(Sampler):
    batch_key = "greedy"    # stateless: all greedy slots share one argmax

    def sample(self, logits: np.ndarray) -> np.ndarray:
        return np.argmax(logits, axis=-1)


class Temperature(Sampler):
    """Temperature + top-k via the Gumbel-max trick (one vectorized argmax
    instead of per-row softmax/choice)."""

    def __init__(self, t: float = 1.0, *, top_k: int = 0, seed: int = 0):
        self.t = t
        self.top_k = top_k
        self.rng = np.random.default_rng(seed)

    def sample(self, logits: np.ndarray) -> np.ndarray:
        x = logits.astype(np.float64) / max(self.t, 1e-6)
        if self.top_k:
            kth = np.partition(x, -self.top_k, axis=-1)[:, -self.top_k, None]
            x = np.where(x < kth, -np.inf, x)
        g = self.rng.gumbel(size=x.shape)
        return np.argmax(x + g, axis=-1)


def greedy_accept_prefix(verify_logits: np.ndarray, drafts: np.ndarray):
    """Vectorized longest-prefix greedy acceptance for speculative decoding.

    verify_logits: (B, k+1, V) target logits after feeding ``[t_0,
    d_1 .. d_k]`` per slot -- row ``j`` is the target distribution given
    the context plus ``t_0, d_1 .. d_j``.  drafts: (B, k) the drafter's
    proposals.  Draft ``d_{j+1}`` is accepted iff it equals the target's
    argmax at row ``j`` *and* every earlier draft was accepted -- exactly
    the tokens vanilla greedy decode would have produced.

    Returns ``(accepted, targets)``: accepted (B,) counts of accepted
    drafts in [0, k]; targets (B, k+1) the target argmax chain.
    """
    targets = np.argmax(verify_logits, axis=-1)
    match = drafts == targets[:, :-1]
    k = drafts.shape[1]
    accepted = np.where(match.all(axis=1), k, np.argmax(~match, axis=1))
    return accepted.astype(np.int64), targets


def greedy() -> Sampler:
    return Greedy()


def temperature(t: float = 1.0, *, top_k: int = 0, seed: int = 0) -> Sampler:
    return Temperature(t, top_k=top_k, seed=seed)
