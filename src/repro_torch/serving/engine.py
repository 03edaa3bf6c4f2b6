"""Continuous-batching LM serving engine (counterpart of
``repro/serving/engine.py``): the paged KV pool, and contiguous per-slot
caches for families without one.

:class:`ServingEngine` is the executor for a
:class:`~repro_torch.serving.scheduler.ContinuousScheduler`: it keeps a
fixed-slot decode batch alive and refills a slot the moment its request
finishes.  KV state is one global :class:`~repro_torch.serving.kv_pool.
KVBlockPool` of fixed-size blocks shared by every slot, with per-request
block tables and block-aware admission.  On top of the pool:

  * SLO-aware scheduling -- priority admission with recompute-style
    preemption of lower-priority decodes under block pressure;
  * prefix sharing -- a prefix index maps the token content of full leading
    prompt blocks to refcounted pool blocks;
  * cache-seeded chunked prefill -- prompt KV is written straight into pool
    blocks by ``prefill_paged`` and computation starts at the first
    unseeded token; a ``prefill_chunk`` budget interleaves long prompts
    with decode steps.

The pool is in ``cache_dtype``: bf16, fp32, or int8 with fp32 scales per
(block, row, kv head) (``QuantPagedKVCache``).  Families with no paged
state (the hybrid) serve from **contiguous** caches (``paged=False``, the
default for them), and so does the dense family with ``paged=False``: each
admitted prompt is prefilled whole into a batch-1 state that is written
into its slot of the batched decode state (:func:`_merge_slot`), as the
reference's contiguous path.  Contiguous caches are never int8:
``cache_dtype="int8"`` gives them in bf16, as the reference's contiguous
engine builds them whatever ``cache_dtype`` says.

Speculative decoding (``draft_cfg``, paged only): greedy slots run a
draft-and-verify round instead of the vanilla decode step.  A
:class:`_Drafter` with its own worst-case paged pool proposes ``spec_k``
tokens per slot; the target scores the pending token and every draft in
one batched ``verify_paged`` pass and commits the longest prefix of drafts
that matches its own argmax chain, so the output is vanilla greedy's.
Under self-speculation (``draft_cfg is cfg``) the drafter shares the
engine's prepared weights.

Every attention call runs the hand-written CUDA kernels when the engine's
device is the card (:mod:`repro_torch.kernels`).  The engine runs on
``device="cuda"`` unless the caller passes another device; it raises when
no card is present rather than carry on on the CPU.

Not ported yet, and refused by the constructor: the host KV tier
(``host_blocks``), disaggregated roles and fault injection; refused as
the reference refuses them: ``prefill_chunk`` and speculative decoding
without paging.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field, fields
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models.registry import fns_for
from repro_torch.serving.kv_pool import CapacityError, KVBlockPool
from repro_torch.serving.sampler import Sampler  # noqa: F401 (re-export)
from repro_torch.serving.sampler import greedy_accept_prefix
from repro_torch.serving.scheduler import (ContinuousScheduler, Request,
                                           RequestState)


# Declarative multi-replica merge spec (copied from the reference): every
# ServeStats field MUST have a rule here — tests enforce the bijection — so
# a new field can never silently vanish from fleet aggregation.
#   sum      — additive counter
#   max      — window-level maximum (wall clock)
#   extend   — per-request / per-step sample lists, concatenated
#   opt_sum  — None-aware sum: stays None only when every input is None
#   derived  — a ratio recomputed inside merge_from from already-merged
#              numerators/denominators via _DERIVED (never copied or
#              averaged across: a ratio of sums is not a sum of ratios)
MERGE_RULES: dict[str, str] = {
    "requests": "sum",
    "tokens": "sum",
    "wall_s": "max",
    "prefills": "sum",
    "decode_steps": "sum",
    "verify_steps": "sum",
    "occupancy_sum": "sum",
    "prefill_compiles": "sum",
    "preemptions": "sum",
    "prefix_shared_blocks": "sum",
    "slo_tracked": "sum",
    "slo_misses": "sum",
    "prefill_tokens_total": "sum",
    "prefill_tokens_computed": "sum",
    "router_steals": "sum",
    "router_affinity_hits": "sum",
    "spec_proposed": "sum",
    "spec_accepted": "sum",
    "accept_rate": "derived",       # merged accepted / merged proposed
    "kv_spills": "sum",
    "kv_fetches": "sum",
    "prefix_hits_host": "sum",
    "prefix_lookups": "sum",
    "spill_bytes": "sum",
    "kv_hit_rate": "derived",       # merged (device + host hits) / lookups
    "kv_blocks_peak": "opt_sum",
    "kv_pool_capacity": "opt_sum",
    "kv_pool_util": "derived",      # merged peak / combined capacity
    "requests_failed": "sum",
    "requests_retried": "sum",
    "replica_failures": "sum",
    "shed_rejections": "sum",
    "faults_injected": "sum",
    "kv_migrations": "sum",
    "migrated_blocks": "sum",
    "ttft": "extend",
    "tpot": "extend",
    "decode_gaps": "extend",
}

# Recompute functions for every "derived" rule above, applied by
# merge_from after the field-by-field fold (tests enforce the bijection
# with MERGE_RULES): a ratio of sums, never a copied or averaged ratio.
_DERIVED: dict[str, Callable[["ServeStats"], float | None]] = {
    "kv_pool_util": lambda s: (
        s.kv_blocks_peak / s.kv_pool_capacity
        if s.kv_blocks_peak is not None and s.kv_pool_capacity else None),
    "accept_rate": lambda s: (
        s.spec_accepted / s.spec_proposed if s.spec_proposed else None),
    "kv_hit_rate": lambda s: (
        (s.prefix_shared_blocks + s.prefix_hits_host) / s.prefix_lookups
        if s.prefix_lookups else None),
}


@dataclass
class ServeStats:
    requests: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    prefills: int = 0
    decode_steps: int = 0
    verify_steps: int = 0               # speculative multi-token target passes
    occupancy_sum: float = 0.0          # sum over decode-cadence steps
                                        # (decode + verify) of active/slots
    prefill_compiles: int = 0           # distinct padded prefill shapes
    preemptions: int = 0                # decode evictions under queue pressure
    prefix_shared_blocks: int = 0       # table entries mapped to shared blocks
    slo_tracked: int = 0                # requests carrying a TTFT SLO
    slo_misses: int = 0                 # ... whose TTFT exceeded it
    prefill_tokens_total: int = 0       # tokens a full recompute would run
    prefill_tokens_computed: int = 0    # tokens actually run (rest seeded)
    router_steals: int = 0              # requests migrated to an idle replica
    router_affinity_hits: int = 0       # requests routed onto their prefix
    spec_proposed: int = 0              # drafter tokens offered to verify
    spec_accepted: int = 0              # ... committed (matched target argmax)
    accept_rate: float | None = None    # spec only: accepted / proposed
    kv_spills: int = 0                  # tiered: blocks demoted to host tier
    kv_fetches: int = 0                 # tiered: host blocks restored to pool
    prefix_hits_host: int = 0           # tiered: prefix blocks seeded via fetch
    prefix_lookups: int = 0             # full prompt blocks probed in the index
    spill_bytes: int = 0                # tiered: bytes moved device -> host
    kv_hit_rate: float | None = None    # (device + host prefix hits) / lookups
    kv_blocks_peak: int | None = None   # paged only: peak pool blocks in use
    kv_pool_capacity: int | None = None  # paged only: pool size in blocks
    kv_pool_util: float | None = None   # paged only: peak / capacity
    requests_failed: int = 0            # terminal FAILED (poison/deadline/
                                        # retries exhausted)
    requests_retried: int = 0           # reissued to a survivor replica
    replica_failures: int = 0           # request failures charged to replicas
    shed_rejections: int = 0            # admissions refused (queue too deep)
    faults_injected: int = 0            # fault-plan probes that fired here
    kv_migrations: int = 0              # disagg: prefills adopted from a peer
    migrated_blocks: int = 0            # disagg: pool blocks landed via adopt
    ttft: list = field(default_factory=list)    # per-request seconds
    tpot: list = field(default_factory=list)    # per-request seconds/token
    decode_gaps: list = field(default_factory=list)  # s between decode steps

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s else 0.0

    @property
    def slot_occupancy(self) -> float:
        """Mean fraction of decode slots doing useful work per decode-
        cadence step (vanilla decode or speculative verify)."""
        steps = self.decode_steps + self.verify_steps
        return self.occupancy_sum / steps if steps else 0.0

    @property
    def steps_per_token(self) -> float | None:
        """Batched target-model passes (decode + verify) per generated
        token — the raw-speed number speculative decoding moves: a verify
        pass can commit several tokens per slot, so spec pushes this below
        the vanilla value for the same workload."""
        steps = self.decode_steps + self.verify_steps
        return steps / self.tokens if self.tokens else None

    @property
    def ttft_p50_s(self) -> float | None:
        return float(np.percentile(self.ttft, 50)) if self.ttft else None

    @property
    def ttft_p99_s(self) -> float | None:
        return float(np.percentile(self.ttft, 99)) if self.ttft else None

    @property
    def mean_tpot_s(self) -> float | None:
        return float(np.mean(self.tpot)) if self.tpot else None

    @property
    def prefill_compute_frac(self) -> float | None:
        """Fraction of prefill tokens actually computed (1.0 = nothing was
        seeded from the cache); None when no prefill happened."""
        return (self.prefill_tokens_computed / self.prefill_tokens_total
                if self.prefill_tokens_total else None)

    @property
    def decode_stall_p99_s(self) -> float | None:
        """p99 wall-clock gap between consecutive decode steps while
        decodes were active — a long un-chunked prefill of a newly
        admitted prompt shows up here as one giant gap."""
        return (float(np.percentile(self.decode_gaps, 99))
                if self.decode_gaps else None)

    @property
    def slo_miss_rate(self) -> float | None:
        """Fraction of SLO-carrying requests whose TTFT missed; None when
        the workload carries no SLOs."""
        return self.slo_misses / self.slo_tracked if self.slo_tracked \
            else None

    def merge_from(self, sub: "ServeStats") -> "ServeStats":
        """Fold another window's stats into this one, field by field, under
        :data:`MERGE_RULES`.  Raises on a field without a rule, so adding a
        ``ServeStats`` field without deciding its fleet semantics fails the
        first multi-replica aggregation (and the rule-coverage test)
        instead of silently dropping the field."""
        for f in fields(self):
            rule = MERGE_RULES.get(f.name)
            if rule is None:
                raise ValueError(
                    f"ServeStats field {f.name!r} has no merge rule; add "
                    f"it to MERGE_RULES (sum/max/extend/opt_sum/derived)")
            a, b = getattr(self, f.name), getattr(sub, f.name)
            if rule == "sum":
                setattr(self, f.name, a + b)
            elif rule == "max":
                setattr(self, f.name, max(a, b))
            elif rule == "extend":
                a.extend(b)
            elif rule == "opt_sum":
                if b is not None:
                    setattr(self, f.name, (a or 0) + b)
            elif rule == "derived":
                pass                     # recomputed below from merged parts
            else:
                raise ValueError(f"unknown merge rule {rule!r} "
                                 f"for ServeStats.{f.name}")
        # derived ratios recompute from the merged numerators/denominators
        # (copying or averaging per-window ratios would weight every window
        # equally regardless of size)
        for name, fn in _DERIVED.items():
            setattr(self, name, fn(self))
        return self

    def fill_request_metrics(self, requests: list[Request]) -> None:
        for r in requests:
            if r.ttft_s is not None:
                self.ttft.append(r.ttft_s)
            if r.tpot_s is not None:
                self.tpot.append(r.tpot_s)
            if r.slo_ttft_s is not None:
                # an SLO request that never produced a token inside the
                # window missed by definition — excluding it would let the
                # worst outcomes deflate the miss rate
                self.slo_tracked += 1
                self.slo_misses += int(r.slo_miss is not False)



def _merge_slot(state, slot_state, slot: int):
    """Write a single-request decode state into slot ``slot`` of the batched
    state, **in place** (the reference's returns a new pytree), casting each
    leaf to the batched leaf's type.  Both come from the same model fns
    with the same ``max_len`` and differ only in batch size, so for every
    leaf the batch axis is the unique axis where the shapes differ.
    Returns ``state``."""
    for big, small in zip(state, slot_state):
        if big.shape == small.shape:        # num_slots == 1
            big.copy_(small)
            continue
        axis = next(a for a in range(big.ndim)
                    if big.shape[a] != small.shape[a])
        big.narrow(axis, slot, 1).copy_(small)
    return state


class WindowBase(NamedTuple):
    """Lifetime-counter snapshot anchoring a serving measurement window
    (:meth:`ServingEngine.begin_window` / ``collect_window``)."""
    tokens: int
    prefills: int
    decode_steps: int
    verify_steps: int
    spec_proposed: int
    spec_accepted: int
    occupancy_sum: float
    prefill_compiles: int
    preemptions: int
    prefix_shared: int
    prefill_tokens_total: int
    prefill_tokens_computed: int
    prefix_lookups: int
    decode_gap_n: int           # lifetime decode-gap count at window start
                                # (incl. entries trimmed from the bounded
                                # totals.decode_gaps list)

def prefix_digests(tokens: np.ndarray, block_size: int) -> list[bytes]:
    """One chained digest per *full* leading block of ``tokens``: digest
    ``j`` covers the tokens of blocks 0..j.  Chaining keeps the whole key
    list O(prompt) — slicing ``tokens[:(j+1)*bs]`` fresh per key would be
    O(prompt^2) bytes hashed on the executor hot path.

    The same digests as the reference's ``prefix_digests``, which its
    replica router keys on too."""
    bs = block_size
    h = hashlib.sha1()
    keys: list[bytes] = []
    for j in range(len(tokens) // bs):
        h.update(np.ascontiguousarray(tokens[j * bs:(j + 1) * bs],
                                      dtype=np.int32).tobytes())
        keys.append(h.digest())
    return keys


@dataclass
class _PrefillJob:
    """One slot's in-progress cache-seeded chunked prefill.  Blocks are
    *materialized* (prefix lookup + share + alloc) lazily at the first
    chunk, not at admission: jobs advance strictly oldest-first, so by
    the time a job starts computing, every earlier same-step admission
    has completed and published its prefix blocks."""
    req: Request
    tokens: np.ndarray          # prefill_tokens snapshot (prompt + resume)
    nb: int                     # prompt blocks in the request's table
    keys: list                  # prefix digests, published at completion
    pos: int = -1               # rows already in the pool; -1 = blocks
                                # not yet materialized
    slot: int = -1              # engine slot


class _Drafter:
    """The drafter side of speculative decoding: a model with its own paged
    KV pool, mirrored per engine slot (the reference's ``_Drafter``).

    The pool is sized worst-case (every slot at ``max_len`` plus the
    speculative overhang), so drafter allocation never fails and never
    meets the target pool's admission control.  Per-slot host block tables
    and valid-row counts are re-injected before every batched drafter
    step.  The drafter lags the target by at most one committed token (only
    after a round that accepted all ``k`` drafts was the last committed
    token never fed to it), and :meth:`propose` feeds that gap before the
    pending token, so its KV stays a prefix of the committed stream.

    ``params`` are already prepared for ``device`` (under self-speculation
    the engine's own).  Its decode steps run K1, its seeds K2.
    """

    def __init__(self, cfg, params, *, slots: int, max_len: int,
                 block_size: int, spec_k: int, chunk: int, cache_dtype: str,
                 device):
        self.cfg = cfg
        self.params = params
        self.fns = fns_for(cfg)
        if self.fns.init_paged_state is None or self.fns.prefill_paged is None:
            raise ValueError(f"draft family {cfg.family!r} has no paged-KV "
                             f"support; speculative decoding needs it")
        self.device = device
        self.slots = slots
        self.block_size = block_size
        self.spec_k = spec_k
        self.max_blocks = -(-(max_len + spec_k + 1) // block_size)
        self.pool = KVBlockPool(slots * self.max_blocks, block_size)
        self._tables = np.zeros((slots, self.max_blocks), np.int32)
        self._lens = np.zeros((slots,), np.int32)
        self._blocks: dict[int, list[int]] = {}
        self._state = self.fns.init_paged_state(
            cfg, self.pool.total_blocks, block_size, slots, self.max_blocks,
            cache_dtype, device=device)
        self._decode = lambda p, t, s: self.fns.decode(cfg, p, t, s,
                                                       chunk=chunk)
        self._prefill = (
            lambda p, t, s, w, tb, qs, kl, li: self.fns.prefill_paged(
                cfg, p, t, s, w, tb, q_start=qs, kv_len=kl, last_idx=li,
                chunk=chunk))

    def _to_device(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    def seed(self, slot: int, tokens: np.ndarray, rows: int) -> None:
        """(Re-)prefill the drafter's mirror of a slot: allocate blocks for
        ``rows`` worst-case KV rows (committed budget + overhang) and run
        the prompt in one call -- when the target's prefill completes, also
        after a preemption resume (``tokens`` then carries the folded
        output, as the target's re-prefill does)."""
        self.drop(slot)
        bs = self.block_size
        nb = self.pool.blocks_for(rows)
        took = self.pool.reserve(nb)
        assert took, "drafter pool is sized worst-case; reserve cannot fail"
        ids = self.pool.alloc_reserved(nb)
        self._blocks[slot] = ids
        self._tables[slot] = 0
        self._tables[slot, :nb] = ids
        P = len(tokens)
        bucket = bs
        while bucket < P:
            bucket *= 2
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :P] = tokens
        nbp = self.pool.blocks_for(P)
        wids = np.zeros((bucket // bs,), np.int32)
        wids[:nbp] = ids[:nbp]              # padding blocks write to trash
        mb_eff = 1
        while mb_eff < nbp:
            mb_eff *= 2
        mb_eff = min(mb_eff, self.max_blocks)
        tbl = np.zeros((1, mb_eff), np.int32)
        tbl[0, :min(nbp, mb_eff)] = ids[:min(nbp, mb_eff)]
        _, self._state = self._prefill(
            self.params, self._to_device(toks), self._state,
            self._to_device(wids), self._to_device(tbl),
            self._to_device(np.array([0], np.int32)),
            self._to_device(np.array([P], np.int32)), P - 1)
        self._lens[slot] = P

    def drop(self, slot: int) -> None:
        """Release a slot's drafter blocks (finish, preemption, re-seed).
        Idempotent: a slot preempted while the target was still prefilling
        was never seeded."""
        ids = self._blocks.pop(slot, None)
        if ids:
            self.pool.free(ids)
        self._tables[slot] = 0   # trash redirect before the next write
        self._lens[slot] = 0

    def set_len(self, slot: int, rows: int) -> None:
        """After acceptance: ``rows`` drafter KV rows hold committed-stream
        tokens (the rejected tail past them is overwritten by the next
        round)."""
        self._lens[slot] = rows

    def length(self, slot: int) -> int:
        return int(self._lens[slot])

    def propose(self, jobs: list[tuple[int, list[int]]]) -> dict[int, list[int]]:
        """Batched greedy proposal: for each ``(slot, queue)`` job -- the
        committed tokens the drafter has not seen yet plus the slot's
        pending token ``t_0`` -- feed the queue, then the drafter's own
        argmax continuations until ``k`` proposals exist.  All jobs advance
        in lock-step batched (slots, 1) decode steps; slots done early (or
        not in ``jobs``) write to the trash block.  The argmax is taken on
        the device: only (slots,) token ids come back per step."""
        k = self.spec_k
        queues = {slot: list(q) for slot, q in jobs}
        drafts: dict[int, list[int]] = {slot: [] for slot, _ in jobs}
        write_pos = {slot: int(self._lens[slot]) for slot, _ in jobs}
        steps = max(len(q) for _, q in jobs) + k - 1
        for _ in range(steps):
            feed = np.zeros((self.slots, 1), np.int32)
            tbl = np.zeros_like(self._tables)
            lens = np.zeros((self.slots,), np.int32)
            live = []
            for slot, _ in jobs:
                if queues[slot]:
                    tok = queues[slot].pop(0)
                elif len(drafts[slot]) < k:
                    tok = drafts[slot][-1]
                else:
                    continue                 # done: stays trash-targeted
                feed[slot, 0] = tok
                tbl[slot] = self._tables[slot]
                lens[slot] = write_pos[slot]
                write_pos[slot] += 1
                live.append(slot)
            self._state = self._state._replace(
                block_tables=self._to_device(tbl),
                length=self._to_device(lens))
            last, self._state = self._decode(self.params,
                                             self._to_device(feed),
                                             self._state)
            nxt = last.argmax(-1).cpu().numpy()
            for slot in live:
                if not queues[slot] and len(drafts[slot]) < k:
                    drafts[slot].append(int(nxt[slot]))
        return drafts


class ServingEngine:
    """One replica: continuous batching over a fixed-slot decode batch,
    driven by the blocking :meth:`serve` (admit a list of requests, run
    until all are DONE)."""

    def __init__(self, cfg, params, *, max_len: int = 256,
                 batch_slots: int = 4, chunk: int = 512,
                 paged: bool | None = None, block_size: int = 16,
                 pool_blocks: int | None = None,
                 cache_dtype: str = "bfloat16",
                 preemption: bool = True, prefix_sharing: bool = True,
                 prefill_chunk: int | None = None,
                 seeded_prefill: bool = True, host_blocks: int = 0,
                 draft_cfg=None, draft_params=None, spec_k: int = 3,
                 fault_plan=None, role: str = "mixed", device="cuda"):
        if host_blocks > 0:
            raise ValueError("the host KV tier (host_blocks > 0) is not "
                             "ported yet")
        if role != "mixed":
            raise ValueError(f"role={role!r}: disaggregated roles are not "
                             f"ported yet; only 'mixed' serves")
        if fault_plan is not None:
            raise ValueError("fault injection (fault_plan) is not ported yet")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine runs on the CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions of "
                "the kernels on the CPU")
        self.cfg = cfg
        self.fns = fns_for(cfg)              # ValueError unless ported
        if paged is None:                    # auto: families with paged fns
            paged = self.fns.init_paged_state is not None
        elif paged and self.fns.init_paged_state is None:
            raise ValueError(f"family {cfg.family!r} has no paged-KV "
                             f"support (ModelFns.init_paged_state is None)")
        self.paged = paged
        # speculative decoding: on iff a drafter model is given.  Greedy
        # slots then run a multi-token verify step instead of the vanilla
        # decode; non-greedy slots (and spec-off engines) are untouched.
        spec = draft_cfg is not None
        if spec:
            if not paged:
                raise ValueError("speculative decoding needs the paged KV "
                                 "engine (candidate rows are provisional "
                                 "pool blocks)")
            if spec_k < 1:
                raise ValueError(f"spec_k={spec_k} must be >= 1")
            if self.fns.verify_paged is None:
                raise ValueError(f"family {cfg.family!r} has no verify pass "
                                 f"(ModelFns.verify_paged is None)")
        self.spec_k = spec_k if spec else 0
        # worst-case provisional rows a verify step may write past a slot's
        # committed length: the pending token plus k draft candidates
        self.spec_rows = (spec_k + 1) if spec else 0
        if prefill_chunk is not None and not paged:
            raise ValueError("prefill_chunk needs the paged KV engine")
        if paged and getattr(cfg, "sliding_window", 0):
            # the paged attention paths are full-causal; serving a
            # sliding-window arch through them would silently diverge
            raise ValueError(
                f"family {cfg.family!r} uses sliding_window="
                f"{cfg.sliding_window}, which the paged KV attention "
                f"paths do not mask")
        if prefill_chunk is not None and (prefill_chunk < block_size
                                          or prefill_chunk % block_size):
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be a positive "
                f"multiple of block_size={block_size} (chunk starts "
                f"must stay block-aligned for the pool writes)")
        # weights cast to the compute dtype once, here (see prepare_params)
        self.params = self.fns.prepare_params(cfg, params, self.device)
        self.max_len = max_len
        self.slots = batch_slots
        self.block_size = block_size
        self.cache_dtype = cache_dtype
        # the contiguous caches' type: never int8 (see the module docstring)
        self._state_dtype = ("bfloat16" if cache_dtype == "int8" and not paged
                             else cache_dtype)
        self.prefix_sharing = prefix_sharing and paged
        # cache-seeded prefill: computation starts at the first unseeded
        # token; off = the recompute baseline (shared blocks still mapped,
        # but every prompt token re-run, its rows discarded into trash)
        self.seeded_prefill = seeded_prefill and paged
        self.prefill_chunk = prefill_chunk
        # prefix index: chained digest of the tokens of each full leading
        # block -> (block id, alloc generation); entries are validated
        # against the pool on lookup, so a freed-and-reused block can
        # never be shared stale
        self._prefix_index: dict[bytes, tuple[int, int]] = {}
        self.prefix_shared_total = 0        # lifetime shared table entries
        # slot -> in-progress chunked prefill (insertion order = service
        # order); drained by the executor under the prefill_chunk budget
        self._prefilling: dict[int, _PrefillJob] = {}
        self._last_decode_end: float | None = None
        self._gaps_dropped = 0              # decode_gaps entries trimmed
        fns = self.fns
        if paged:
            worst = batch_slots * -(-(max_len + self.spec_rows) // block_size)
            self.pool = KVBlockPool(pool_blocks or worst, block_size)
            # the table width covers the speculative overhang: a verify pass
            # writes up to spec_rows rows past the committed length before
            # acceptance trims them back
            self.max_blocks = self.pool.blocks_for(max_len + self.spec_rows)
            self._prefix_cap = 8 * self.pool.capacity
            # host mirrors of the device block tables / lengths: growth and
            # slot retirement are numpy writes, re-injected every step
            self._tables = np.zeros((batch_slots, self.max_blocks), np.int32)
            self._lengths = np.zeros((batch_slots,), np.int32)
            self._prefill_paged = (
                lambda p, t, s, w, tb, qs, kl, li: fns.prefill_paged(
                    cfg, p, t, s, w, tb, q_start=qs, kv_len=kl, last_idx=li,
                    chunk=chunk))
        else:
            self.pool = None
            # whole-prompt prefill into a batch-1 state with caches of
            # max_len rows (one reference jit entry per prompt length)
            self._prefill = lambda p, b: fns.prefill(
                cfg, p, b, max_len=max_len, chunk=chunk,
                cache_dtype=self._state_dtype)
        self._drafter = None
        if spec:
            # self-speculation shares the engine's prepared weights: no
            # second cast copy of the model
            shared = draft_cfg is cfg and (draft_params is None
                                           or draft_params is params)
            dparams = (self.params if shared else
                       fns_for(draft_cfg).prepare_params(
                           draft_cfg, draft_params, self.device))
            self._drafter = _Drafter(
                draft_cfg, dparams, slots=batch_slots, max_len=max_len,
                block_size=block_size, spec_k=spec_k, chunk=chunk,
                cache_dtype=cache_dtype, device=self.device)
            self._verify = lambda p, t, s, tb, qs, kl: fns.verify_paged(
                cfg, p, t, s, tb, q_start=qs, kv_len=kl, chunk=chunk)
        self._spec_on: set = set()          # slots decoding speculatively
        self.scheduler = ContinuousScheduler(batch_slots, pool=self.pool,
                                             preemption=preemption,
                                             spec_rows=self.spec_rows)
        self._decode = lambda p, t, s: fns.decode(cfg, p, t, s, chunk=chunk)
        # distinct padded prefill shapes: the reference jit-compiles once
        # per shape; the same padding keeps this counter equal to its
        self._prefill_shapes: set = set()
        self._state = None                  # decode state, built lazily
        self._last: np.ndarray | None = None  # (slots, V) next-token logits
        self.totals = ServeStats()          # lifetime counters (monotonic)

    # -- model plumbing --------------------------------------------------------

    @property
    def prefill_compiles(self) -> int:
        """Distinct padded prefill shapes seen (the reference's jit cache
        entries for the same workload)."""
        return len(self._prefill_shapes)

    def _check_fits(self, req: Request) -> None:
        """Reject requests that would overrun the per-slot KV capacity
        (``max_len`` rows) or, paged, whose block count exceeds the whole
        pool (they could never be admitted, only wedge the queue)."""
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_len + 1:
            raise CapacityError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new_tokens {req.max_new_tokens} exceeds KV capacity "
                f"max_len={self.max_len}")
        if self.pool is not None:
            self.pool.validate_rows(req.kv_rows + self.spec_rows, req.rid)

    def _bucket_len(self, n: int) -> int:
        """Smallest power-of-two multiple of block_size holding ``n``."""
        b = self.block_size
        while b < n:
            b *= 2
        return b

    def _batch_for(self, prompts: np.ndarray) -> dict:
        """prompts: (W, S) -> model batch dict (tokens only: the M-RoPE and
        audio families that need more are not ported)."""
        return {"tokens": self._to_device(np.asarray(prompts, np.int32))}

    def _prefill_one(self, req: Request):
        """Dense prefill of one prompt -> ((V,) logits, batch-1 state) --
        the contiguous-KV path (paged engines prefill straight into pool
        blocks via :meth:`_advance_prefill`).  Uses ``req.prefill_tokens``,
        so a resumed request re-prefills its history."""
        prompt = req.prefill_tokens
        self._prefill_shapes.add((1, len(prompt)))
        last, state = self._prefill(self.params, self._batch_for(prompt[None]))
        return last[0].cpu().numpy(), state

    def _init_state(self):
        """Batched decode state covering all slots: the paged pool in
        ``cache_dtype``, or the contiguous caches (the reference's
        contiguous branch builds them in its default bf16: the same type
        unless the engine asks for fp32; int8 gives bf16 here too)."""
        if self.paged:
            return self.fns.init_paged_state(
                self.cfg, self.pool.total_blocks, self.block_size,
                self.slots, self.max_blocks, self.cache_dtype,
                device=self.device)
        return self.fns.init_decode_state(self.cfg, self.slots, self.max_len,
                                          self._state_dtype, device=self.device)

    def _to_device(self, a) -> torch.Tensor:
        """Copy a host array (or list) to the engine's device."""
        return torch.tensor(np.asarray(a), device=self.device)

    # -- executor step ---------------------------------------------------------

    def _sample_active(self, active: list[tuple[int, Request]]) -> dict[int, int]:
        """Vectorized sampling: group slots by sampler batch_key, one
        `sample` call per group (one argmax for the whole batch when all
        slots are greedy)."""
        groups: dict = {}
        for slot, req in active:
            groups.setdefault(req.sampler.batch_key, []).append((slot, req))
        toks: dict[int, int] = {}
        for members in groups.values():
            rows = np.array([s for s, _ in members])
            out = members[0][1].sampler.sample(self._last[rows])
            for (slot, _), tok in zip(members, out):
                toks[slot] = int(tok)
        return toks

    def _prefix_keys(self, tokens: np.ndarray) -> list[bytes]:
        return prefix_digests(tokens, self.block_size)

    def _lookup_prefix(self, keys: list[bytes]) -> list[int]:
        """Longest run of full leading blocks already resident in the pool
        for this token prefix.  Dead index entries (block freed, or freed
        and re-allocated -- the generation tag catches both) are pruned on
        the way."""
        shared: list[int] = []
        for key in keys:
            ent = self._prefix_index.get(key)
            if ent is None:
                break
            bid, gen = ent
            if not self.pool.block_live(bid, gen):
                del self._prefix_index[key]
                break
            shared.append(bid)
        return shared

    def _register_prefix(self, keys: list[bytes], req: Request) -> None:
        """Publish the request's own *full* prompt blocks under their token
        prefix so later requests with the same leading tokens share (and,
        seeded, skip recomputing) them.  Called only once the blocks' rows
        are in the pool.  A live publication wins; a dead entry is
        overwritten."""
        for j in range(req.shared_blocks, len(keys)):
            ent = self._prefix_index.get(keys[j])
            if ent is not None and self.pool.block_live(*ent):
                continue
            bid = req.block_ids[j]
            self._prefix_index[keys[j]] = (bid, self.pool.generation(bid))
        if len(self._prefix_index) > self._prefix_cap:
            # two-phase trim: stale-generation entries go first, and only
            # if that is not enough are *live* entries capped --
            # oldest-published first (dict order)
            live = {k: e for k, e in self._prefix_index.items()
                    if self.pool.block_live(*e)}
            for k in list(live)[:max(0, len(live) - self._prefix_cap)]:
                del live[k]
            self._prefix_index = live

    def _admit_paged(self, slot: int, req: Request) -> None:
        """Queue an admitted request's cache-seeded chunked prefill (block
        materialization is deferred to its first chunk).  The decode-state
        table row stays at the trash block until the prefill completes:
        the in-flight batched decode keeps writing this slot's (discarded)
        row, and must not corrupt half-filled prompt blocks."""
        toks = req.prefill_tokens
        P = len(toks)
        nb = self.pool.blocks_for(P)
        keys = self._prefix_keys(toks) if self.prefix_sharing else []
        self._tables[slot] = 0
        self._lengths[slot] = 0
        self._prefilling[slot] = _PrefillJob(req=req, tokens=toks, nb=nb,
                                             keys=keys, slot=slot)
        self.totals.prefill_tokens_total += P

    def _materialize_blocks(self, job: _PrefillJob) -> None:
        """First-chunk block materialization: map shared prefix blocks
        (seeding past them when enabled) and allocate the tail from the
        reservation the scheduler took at admission.  The last prompt
        token is never seeded: its logits must be computed."""
        req = job.req
        P = len(job.tokens)
        bs = self.block_size
        shared = self._lookup_prefix(job.keys)[:(P - 1) // bs]
        ns = len(shared)
        if ns:
            self.pool.share(shared)
            self.pool.unreserve(ns)          # shared blocks need no copy
            self.prefix_shared_total += ns
        own = self.pool.alloc_reserved(job.nb - ns)
        req.block_ids = shared + own
        req.shared_blocks = ns
        req.blocks_reserved -= job.nb       # remaining = decode-growth tail
        self.totals.prefix_lookups += len(job.keys)
        job.pos = ns * bs if self.seeded_prefill else 0

    def _advance_prefill(self, slot: int, budget: int | None = None) -> int:
        """Run one chunk of a slot's prefill straight into its pool blocks;
        returns the number of real prompt tokens computed.

        Each call processes up to ``prefill_chunk`` tokens -- and no more
        than ``budget`` (floored to a power-of-two block multiple) --
        right-padded to a power-of-two bucket capped at the chunk.  Rows
        that must not land anywhere (bucket padding past the prompt, and
        the recompute-baseline's shared-prefix rows) write to the trash
        block.  On the final chunk the slot's decode table/length go live
        and the prompt's full blocks are published to the prefix index.
        """
        job = self._prefilling[slot]
        req = job.req
        if job.pos == -1:
            self._materialize_blocks(job)
        P = len(job.tokens)
        start = job.pos
        remaining = P - start
        bucket = self._bucket_len(remaining)
        bs = self.block_size
        cap = self.prefill_chunk
        if cap is not None and budget is not None and budget < cap:
            cap = bs
            while cap * 2 <= budget:
                cap *= 2
        Cpad = min(cap, bucket) if cap else bucket
        real = min(remaining, Cpad)
        b0 = start // bs
        chunk_toks = np.zeros((1, Cpad), np.int32)
        chunk_toks[0, :real] = job.tokens[start:start + real]
        wids = np.zeros((Cpad // bs,), np.int32)
        for j in range(Cpad // bs):
            lb = b0 + j                      # logical block of this write
            if req.shared_blocks <= lb < job.nb:
                wids[j] = req.block_ids[lb]
        # read table sliced to the blocks this chunk can see, rounded up to
        # a power of two (the reference's compile-cache key)
        mb_need = -(-(start + real) // bs)
        mb_eff = 1
        while mb_eff < mb_need:
            mb_eff *= 2
        mb_eff = min(mb_eff, self.max_blocks)
        tbl = np.zeros((1, mb_eff), np.int32)
        nb_vis = min(job.nb, mb_eff)
        tbl[0, :nb_vis] = req.block_ids[:nb_vis]
        self._prefill_shapes.add((1, Cpad, mb_eff))
        last, self._state = self._prefill_paged(
            self.params, self._to_device(chunk_toks), self._state,
            self._to_device(wids), self._to_device(tbl),
            self._to_device(np.array([start], np.int32)),
            self._to_device(np.array([start + real], np.int32)), real - 1)
        self.totals.prefill_tokens_computed += real
        job.pos = start + real
        if job.pos == P:                     # logits of the last real token
            del self._prefilling[slot]
            self._tables[slot] = 0
            if slot in self._spec_on:
                # speculative slots never join the batched vanilla decode:
                # their table row stays at trash (the decode step's write for
                # this slot must keep landing nowhere) and the verify pass
                # addresses the real blocks through its own table.  Seed the
                # drafter's mirror now -- after a preemption resume
                # ``job.tokens`` carries the folded committed output.
                self._lengths[slot] = 0
                self._drafter.seed(
                    slot, job.tokens,
                    len(req.prompt) + req.max_new_tokens + self.spec_k)
            else:
                self._tables[slot, :job.nb] = req.block_ids
                self._lengths[slot] = P
            self._set_last(slot, last[0].cpu().numpy())
            if self.prefix_sharing:
                self._register_prefix(job.keys, req)
            req.state = RequestState.DECODE
            # a PREFILL slot just became DECODE -- i.e. preemptible -- so a
            # queue head blocked on pool pressure is worth re-checking
            self.scheduler.notify_capacity()
        return real

    def _set_last(self, slot: int, last1: np.ndarray) -> None:
        """Store one slot's next-token logits (lazy-allocating the batch
        buffer)."""
        if self._last is None:
            self._last = np.zeros((self.slots, last1.shape[-1]), last1.dtype)
        self._last[slot] = last1

    def _retire_slot(self, slot: int) -> None:
        """Point a finished slot's table at the trash block before its
        freed blocks can be reused -- the batched decode still writes a
        (discarded) row for this slot every step."""
        self._tables[slot] = 0
        self._lengths[slot] = 0

    def _grow_paged(self, still: list[tuple[int, Request]]) -> None:
        """Allocate the next block for any request whose write position
        crossed a block boundary, then re-inject the host-side tables and
        lengths into the decode state."""
        bs = self.block_size
        for slot, req in still:
            pos = len(req.prompt) + len(req.output) - 1   # row written next
            if pos >= len(req.block_ids) * bs:
                nb = len(req.block_ids)
                req.block_ids.extend(self.pool.alloc_reserved(1))
                req.blocks_reserved -= 1
                self._tables[slot, nb] = req.block_ids[-1]
            self._lengths[slot] = pos
        self._state = self._state._replace(
            block_tables=self._to_device(self._tables),
            length=self._to_device(self._lengths))

    def _step(self) -> bool:
        """One executor iteration: refill free slots, spend the chunked
        prefill budget, sample one token per decoding slot (vectorized),
        advance the batched decode step.  Returns False when there was no
        work."""
        admitted = self.scheduler.admit()
        # trash the tables of any slots admit() preempted *before*
        # prefilling new prompts into the freed blocks: the victim slot
        # keeps writing its (discarded) decode row to the trash block
        for slot, _victim in self.scheduler.drain_preempted():
            self._retire_slot(slot)
            self._prefilling.pop(slot, None)
            if self._drafter is not None:
                # the victim's drafter mirror dies with its target KV; a
                # resume re-seeds it from the folded committed output
                self._drafter.drop(slot)
                self._spec_on.discard(slot)
        for slot, req in admitted:
            self.totals.prefills += 1
            if self._state is None:
                self._state = self._init_state()
            if self._drafter is not None:
                # only greedy samplers have the argmax-chain acceptance that
                # keeps outputs equal to vanilla decode's
                if req.sampler.batch_key == "greedy":
                    self._spec_on.add(slot)
                else:
                    self._spec_on.discard(slot)
            if self.paged:
                self._admit_paged(slot, req)
                if self.prefill_chunk is None:
                    # un-chunked: finish this prompt before admitting the
                    # next, so its published prefix blocks are sharable
                    # (and seedable) by the very next admission
                    while slot in self._prefilling:
                        self._advance_prefill(slot)
            else:
                last1, state1 = self._prefill_one(req)
                self.totals.prefill_tokens_total += len(req.prefill_tokens)
                self.totals.prefill_tokens_computed += \
                    len(req.prefill_tokens)
                self._state = _merge_slot(self._state, state1, slot)
                self._set_last(slot, last1)
                req.state = RequestState.DECODE

        if self._prefilling:
            # chunked mode: spend at most prefill_chunk prompt tokens per
            # executor step, oldest admission first, then fall through to
            # the decode step; the remaining budget caps each chunk
            budget = self.prefill_chunk
            while budget >= self.block_size and self._prefilling:
                job = next(iter(self._prefilling.values()))
                budget -= self._advance_prefill(job.slot, budget)

        active = self.scheduler.decoding()
        if not active:
            # a prefill-only period is not a decode gap
            self._last_decode_end = None
            return bool(self._prefilling)

        spec = [(s, r) for s, r in active if s in self._spec_on]
        spec_slots = {s for s, _ in spec}    # before the verify retires any
        if spec:
            self._verify_step(spec)
        active = [(s, r) for s, r in active if s not in spec_slots]
        if not active:
            return True

        toks = self._sample_active(active)
        now = time.monotonic()
        feed = np.zeros((self.slots, 1), np.int32)
        for slot, req in active:
            tok = toks[slot]
            feed[slot, 0] = tok
            if req.first_token_at is None:
                req.first_token_at = now
            req.output.append(tok)
            self.totals.tokens += 1
            if len(req.output) >= req.max_new_tokens:
                req.state = RequestState.DONE
                req.finished_at = time.monotonic()
                self.scheduler.release(slot)   # returns blocks to the pool
                if self.paged:
                    self._retire_slot(slot)
                if req.on_finish is not None:
                    req.on_finish(req)

        still = [(s, r) for s, r in self.scheduler.decoding()
                 if s not in self._spec_on]
        if still:        # someone needs next-token logits
            if self.paged:
                self._grow_paged(still)
            last, self._state = self._decode(
                self.params, self._to_device(feed), self._state)
            # (slots, V) fp32 logits go to the host for sampling every step
            last = last.cpu().numpy()
            if self._spec_on:
                # speculative slots fed 0 against trash tables: their rows
                # of this decode are garbage, and their real next-token
                # logits (set by the verify pass) must survive it
                keep = sorted(self._spec_on)
                last[keep] = self._last[keep]
            self._last = last
            self._note_decode_cadence()
            self.totals.decode_steps += 1
            self.totals.occupancy_sum += len(still) / self.slots
        else:
            self._last_decode_end = None     # cadence broken, not stalled
        return True

    def _note_decode_cadence(self) -> None:
        """Record the wall-clock gap since the previous decode step --
        chunked-prefill stalls surface here as ``decode_gaps`` outliers."""
        now = time.monotonic()
        if self._last_decode_end is not None:
            gaps = self.totals.decode_gaps
            gaps.append(now - self._last_decode_end)
            if len(gaps) > 65536:            # bound the lifetime list
                drop = len(gaps) // 2
                del gaps[:drop]
                self._gaps_dropped += drop
        self._last_decode_end = now

    def _verify_step(self, spec: list[tuple[int, Request]]) -> None:
        """One draft-and-verify round for every speculative decoding slot:
        propose ``k`` drafter tokens per slot, score the pending greedy
        token and all drafts in one batched target pass, commit the longest
        prefix of drafts matching the target's argmax chain, and roll back
        the rejected tail's provisional blocks.

        Invariant (as vanilla decode's): entering with ``n`` committed
        output tokens, KV rows ``0 .. P+n-1`` are written and
        ``self._last[slot]`` holds the target distribution after the
        committed stream.  The verify feeds ``[t_0, d_1 .. d_k]`` with
        ``t_0 = argmax(_last)`` at ``q_start = P+n``, so row ``j``'s
        logits condition on exactly the tokens vanilla greedy would have
        committed, and every committed token's KV row was written by the
        pass that scored it.  Each round commits at least ``t_0``.
        """
        k = self.spec_k
        C = k + 1
        bs = self.block_size
        # 1. drafter proposals, seeded with any committed tokens the drafter
        # has not ingested yet (a lag of at most 1 after an all-accept round)
        pending: dict[int, int] = {}
        jobs: list[tuple[int, list[int]]] = []
        for slot, req in spec:
            P = len(req.prompt)
            t0 = int(req.sampler.sample(self._last[slot][None])[0])
            pending[slot] = t0
            dlen = self._drafter.length(slot)
            gap = [int(t) for t in req.output[dlen - P:]]
            jobs.append((slot, gap + [t0]))
        drafts = self._drafter.propose(jobs)
        # 2. provisional growth, then one batched verify over all spec slots
        tokens = np.zeros((self.slots, C), np.int32)
        qs = np.zeros((self.slots,), np.int32)
        kl = np.full((self.slots,), C, np.int32)  # padding rows see only
        mb_need = 1                               # trash-block garbage
        for slot, req in spec:
            q0 = len(req.prompt) + len(req.output)
            nb_need = -(-(q0 + C) // bs)
            grow = nb_need - len(req.block_ids)
            if grow > 0:
                # provisional blocks out of the admission reservation, which
                # budgeted spec_rows for exactly this
                req.block_ids.extend(self.pool.alloc_reserved(grow))
                req.blocks_reserved -= grow
            tokens[slot, 0] = pending[slot]
            tokens[slot, 1:] = drafts[slot]
            qs[slot] = q0
            kl[slot] = q0 + C
            mb_need = max(mb_need, nb_need)
        mb_eff = 1
        while mb_eff < mb_need:
            mb_eff *= 2
        mb_eff = min(mb_eff, self.max_blocks)
        tbl = np.zeros((self.slots, mb_eff), np.int32)
        for slot, req in spec:
            tbl[slot, :len(req.block_ids)] = req.block_ids
        self._prefill_shapes.add((self.slots, C, mb_eff))
        logits, self._state = self._verify(
            self.params, self._to_device(tokens), self._state,
            self._to_device(tbl), self._to_device(qs), self._to_device(kl))
        logits = logits.cpu().numpy()            # (slots, C, V)
        # 3. vectorized longest-prefix acceptance
        rows = np.array([s for s, _ in spec])
        accepted, _ = greedy_accept_prefix(
            logits[rows], np.array([drafts[s] for s, _ in spec]))
        now = time.monotonic()
        for (slot, req), m in zip(spec, accepted):
            commit = [pending[slot]] + drafts[slot][:int(m)]
            commit = commit[:req.max_new_tokens - len(req.output)]
            self.totals.spec_proposed += k
            self.totals.spec_accepted += len(commit) - 1
            if req.first_token_at is None:
                req.first_token_at = now
            req.output.extend(commit)
            self.totals.tokens += len(commit)
            # next-token logits after the last committed token: verify row
            # j conditions on commit[0..j]
            self._set_last(slot, logits[slot, len(commit) - 1])
            # trim the rejected tail's blocks back into the reservation
            nb_keep = -(-(len(req.prompt) + len(req.output)) // bs)
            tail = req.block_ids[nb_keep:]
            if tail:
                self.pool.release_provisional(tail)
                req.blocks_reserved += len(tail)
                del req.block_ids[nb_keep:]
            if len(req.output) >= req.max_new_tokens:
                req.state = RequestState.DONE
                req.finished_at = time.monotonic()
                self.scheduler.release(slot)
                self._retire_slot(slot)
                self._drafter.drop(slot)
                self._spec_on.discard(slot)
                if req.on_finish is not None:
                    req.on_finish(req)
            else:
                # drafter rows holding committed tokens: the fed t_0 and the
                # accepted drafts, up to q_start + min(len(commit), k) - 1
                # (d_k is proposed but never fed back)
                self._drafter.set_len(slot, int(qs[slot]) + min(len(commit), k))
        self._note_decode_cadence()
        self.totals.verify_steps += 1
        self.totals.occupancy_sum += len(spec) / self.slots

    # -- measurement windows ---------------------------------------------------

    def begin_window(self) -> WindowBase:
        """Snapshot the lifetime counters (and reset the pool peak) so a
        caller can scope :class:`ServeStats` to one serving window."""
        if self.pool is not None:
            self.pool.reset_peak()
        return WindowBase(
            tokens=self.totals.tokens, prefills=self.totals.prefills,
            decode_steps=self.totals.decode_steps,
            verify_steps=self.totals.verify_steps,
            spec_proposed=self.totals.spec_proposed,
            spec_accepted=self.totals.spec_accepted,
            occupancy_sum=self.totals.occupancy_sum,
            prefill_compiles=self.prefill_compiles,
            preemptions=self.scheduler.preemptions,
            prefix_shared=self.prefix_shared_total,
            prefill_tokens_total=self.totals.prefill_tokens_total,
            prefill_tokens_computed=self.totals.prefill_tokens_computed,
            prefix_lookups=self.totals.prefix_lookups,
            decode_gap_n=self._gaps_dropped + len(self.totals.decode_gaps))

    def collect_window(self, base: WindowBase, requests: list[Request],
                       wall_s: float) -> ServeStats:
        """Stats for everything this engine did since ``base`` (a
        :meth:`begin_window` snapshot), with per-request latency metrics
        filled from ``requests``."""
        stats = ServeStats(requests=len(requests), wall_s=wall_s)
        stats.tokens = self.totals.tokens - base.tokens
        stats.prefills = self.totals.prefills - base.prefills
        stats.decode_steps = self.totals.decode_steps - base.decode_steps
        stats.verify_steps = self.totals.verify_steps - base.verify_steps
        stats.spec_proposed = self.totals.spec_proposed - base.spec_proposed
        stats.spec_accepted = self.totals.spec_accepted - base.spec_accepted
        if stats.spec_proposed:
            stats.accept_rate = stats.spec_accepted / stats.spec_proposed
        stats.occupancy_sum = self.totals.occupancy_sum - base.occupancy_sum
        stats.prefill_compiles = self.prefill_compiles - base.prefill_compiles
        stats.preemptions = self.scheduler.preemptions - base.preemptions
        stats.prefix_shared_blocks = (self.prefix_shared_total
                                      - base.prefix_shared)
        stats.prefill_tokens_total = (self.totals.prefill_tokens_total
                                      - base.prefill_tokens_total)
        stats.prefill_tokens_computed = (self.totals.prefill_tokens_computed
                                         - base.prefill_tokens_computed)
        stats.prefix_lookups = (self.totals.prefix_lookups
                                - base.prefix_lookups)
        if stats.prefix_lookups:
            stats.kv_hit_rate = stats.prefix_shared_blocks / stats.prefix_lookups
        stats.decode_gaps = list(self.totals.decode_gaps[
            max(0, base.decode_gap_n - self._gaps_dropped):])
        if self.pool is not None:
            stats.kv_blocks_peak = self.pool.peak_used
            stats.kv_pool_capacity = self.pool.capacity
            stats.kv_pool_util = self.pool.utilization
        stats.fill_request_metrics(requests)
        return stats

    # -- blocking mode ---------------------------------------------------------

    def serve(self, requests: list[Request]) -> ServeStats:
        """Continuous batching: admit everything, run the executor until
        every request is DONE.  A failure escapes after poisoning the
        scheduler, so later submits are refused instead of queueing into
        an engine nothing drains."""
        for r in requests:
            self._check_fits(r)
        base = self.begin_window()
        t0 = time.monotonic()
        for r in requests:
            self.scheduler.submit(r)
        while self.scheduler.has_work():
            try:
                self._step()
            except BaseException as e:
                self.scheduler.poison(e)
                raise
        return self.collect_window(base, requests, time.monotonic() - t0)
