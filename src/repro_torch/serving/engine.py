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
state (the hybrid, the recurrent xLSTM) serve from **contiguous** caches
(``paged=False``, the default for them), and so does the dense family
with ``paged=False``: each admitted prompt is prefilled whole into a
batch-1 state that is written into its slot of the batched decode state
(:func:`_merge_slot`), as the reference's contiguous path.  Contiguous caches are never int8:
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

Tiered KV (``host_blocks > 0``, paged with prefix sharing): the prefix
index holds every block it publishes, and when admission needs more than
the free list, the pool demotes idle held blocks -- their rows spill to a
:class:`~repro_torch.serving.kv_pool.HostTier` through an
``OffloadEngine([KVBlockTarget])`` transfer worker -- and a later prompt
with the same leading tokens (or a preempted request's resume) fetches
them back instead of recomputing them.  The port's pools are written in
place, so a spill *clones* the block's rows on the executor's stream
before its id can return to the free list; the worker's device-to-host
copy then reads the clone, never the reused block.

Fault tolerance (the reference's): a :class:`~repro_torch.serving.faults.
FaultPlan` fires at the executor step, each prefill chunk and decode
commit, and the tier's transfers; a request whose prefill or decode
raises fails alone (blocks freed, reservation returned); an exception
that escapes a step fails every queued and active request, frees their
blocks, poisons the scheduler and surfaces (re-raised by blocking
:meth:`ServingEngine.serve`, by :meth:`ServingEngine.stop` once in
service mode); requests past their ``deadline_s`` fail with
:class:`~repro_torch.serving.faults.DeadlineExceeded`.

Service mode: :meth:`ServingEngine.start` runs the executor on a thread
of its own, :meth:`ServingEngine.submit` admits from any thread (refusing
with ``ExecutorCrash`` after a crash and ``ShedError`` past
``shed_queue_depth``), :meth:`ServingEngine.stop` joins it.  The kernels
then launch from that thread.

Disaggregated roles (``role="prefill"|"decode"``, paged only): a
prefill-role replica under a :class:`~repro_torch.serving.router.
ReplicaRouter` runs its chunks at full budget and, at a prompt's last
chunk, samples and delivers the first token, export-pins the prompt's
blocks, *clones* them on the executor's stream (:meth:`_handoff`) and
hands them to the router's migration channel; the decode replica lands
them with one batched write (:meth:`adopt_blocks` / :meth:`_adopt_slot`)
and decodes without recomputing a prompt token.  Roles are placement
policy: an engine of any role serves a request alone.

Every attention call runs the hand-written CUDA kernels when the engine's
device is the card (:mod:`repro_torch.kernels`).  The engine runs on
``device="cuda"`` unless the caller passes another device; it raises when
no card is present rather than carry on on the CPU.  The replicas of a
fleet on one card all enqueue on its current stream, so their kernels run
in one order -- a migration's clone before the source's later writes, the
worker's copy after the clone, the adopter's write after that.

Refused as the reference refuses them: ``prefill_chunk``, speculative
decoding, the host tier and disaggregated roles without paging, and the
host tier without prefix sharing.

:meth:`ServingEngine.serve_wave` keeps the reference's lock-step wave
decode (prompts of one length prefilled together through K4, decoded
together through K3, on contiguous caches in bf16) for A/B comparison.

Under a mesh: an engine built inside
:func:`~repro_torch.distributed.sharding.use_rules` keeps those rules and
mesh and runs its prefills, decode steps and state allocation under them,
from whatever thread drives it.  Every rank of the mesh builds the same
engine and serves the same requests (the rules' ``batch`` must be
replicated), so every rank emits the same tokens; with ``kv_seq`` on a
mesh axis each rank holds its slots of the contiguous caches and every
decode step's attention merges the ranks' partials
(:mod:`repro_torch.distributed.collectives`).  A paged engine under such
rules raises: the pool is not sequence-sharded.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field, fields
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.offload import KVBlockTarget, OffloadEngine, WorkError
from repro_torch.distributed.sharding import (axis_sizes, current_mesh, current_rules,
                                              use_rules)
from repro_torch.models.registry import fns_for
from repro_torch.serving.faults import (DeadlineExceeded, ExecutorCrash,
                                        FaultError, FaultPlan, ShedError)
from repro_torch.serving.kv_pool import CapacityError, KVBlockPool
from repro_torch.serving.sampler import Sampler  # noqa: F401 (re-export)
from repro_torch.serving.sampler import greedy_accept_prefix
from repro_torch.serving.scheduler import (ContinuousScheduler, LoadSnapshot,
                                           Request, RequestState)


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



def _check_mesh_engine(rules, mesh, paged: bool) -> None:
    """Refuse what an engine under a mesh cannot serve: no rules, a
    batch split over ranks (every rank serves every slot), a paged pool
    under rules that shard ``kv_seq``."""
    if rules is None:
        raise ValueError("an engine under a mesh needs its sharding rules "
                         "(use_rules(rules, mesh))")
    entry = rules.rules.get("batch")
    sizes = axis_sizes(mesh)
    split = 1
    for ax in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
        split *= sizes.get(ax, 1)
    if split > 1:
        raise ValueError(f"the rules split the batch over {split} ranks; the engine "
                         f"serves every slot on every rank (batch replicated)")
    if paged and rules.rules.get("kv_seq") is not None:
        raise ValueError("the paged pool is not sequence-sharded: under rules that "
                         "shard kv_seq the engine serves from contiguous caches "
                         "(paged=False)")


def _leaf_pairs(big, small):
    """The tensors of two states of one structure (nested dicts, lists,
    tuples and NamedTuples), leaf beside leaf, as the reference's
    ``tree_map`` pairs them."""
    if isinstance(big, torch.Tensor):
        yield big, small
    elif isinstance(big, dict):
        for key in big:
            yield from _leaf_pairs(big[key], small[key])
    else:
        for b, s in zip(big, small, strict=True):
            yield from _leaf_pairs(b, s)


def _merge_slot(state, slot_state, slot: int):
    """Write a single-request decode state into slot ``slot`` of the batched
    state, **in place** (the reference's returns a new pytree), casting each
    leaf to the batched leaf's type.  Both come from the same model fns
    with the same ``max_len`` and differ only in batch size, so for every
    leaf the batch axis is the unique axis where the shapes differ.  A
    state is a NamedTuple of tensors (the hybrid, the dense caches) or
    nested dicts and lists of them (the recurrent family's).  Returns
    ``state``."""
    for big, small in _leaf_pairs(state, slot_state):
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
    kv_spills: int = 0          # tiering lifetime counters (0 when untiered)
    kv_fetches: int = 0
    prefix_hits_host: int = 0
    spill_bytes: int = 0
    requests_failed: int = 0    # fault-tolerance lifetime counters
    shed_rejections: int = 0
    faults_injected: int = 0
    kv_migrations: int = 0      # disagg lifetime counters (0 when mixed)
    migrated_blocks: int = 0


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
class _Adoption:
    """One migrated prefill staged for executor-side landing: the payload
    :meth:`ServingEngine.adopt_blocks` parks (on the migration worker)
    until :meth:`ServingEngine._admit_paged` pops it at admission and
    lands the rows into freshly allocated pool blocks."""
    req: Request
    keys: list                  # chained prefix digests, full blocks only
    tokens: np.ndarray          # the prefilled token stream (the prompt)
    blocks: list                # per-block host leaf dicts, table order
    last: np.ndarray            # final-chunk next-token logits (V,)


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
                                # not yet materialized; -2 = materialized
                                # but host-tier fetches still inbound (the
                                # slot is skipped, like a mid-prefill slot,
                                # until _drain_tier commits the last one)
    slot: int = -1              # engine slot (fetch commits validate the
                                # job is still this slot's live prefill)
    prefetch: dict = field(default_factory=dict)   # key -> WorkItem
    pending_n: int = 0          # registered fetches not yet committed
    fetched_ok: set = field(default_factory=set)   # logical blocks restored
    seed_base: int = 0          # device-shared leading blocks (fetch run
                                # extends the seed window past this)


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
    """One replica: continuous batching over a fixed-slot decode batch.

    Two driving modes share the same executor step:

      * :meth:`serve` -- blocking: admit a list of requests, run until all
        are DONE or FAILED.
      * :meth:`start` / :meth:`submit` / :meth:`stop` -- service mode: a
        background executor thread drains the admission queue as requests
        stream in.
    """

    def __init__(self, cfg, params, *, max_len: int = 256,
                 batch_slots: int = 4, chunk: int = 512,
                 paged: bool | None = None, block_size: int = 16,
                 pool_blocks: int | None = None,
                 cache_dtype: str = "bfloat16",
                 preemption: bool = True, prefix_sharing: bool = True,
                 prefill_chunk: int | None = None,
                 seeded_prefill: bool = True, host_blocks: int = 0,
                 draft_cfg=None, draft_params=None, spec_k: int = 3,
                 name: str = "", fault_plan: FaultPlan | None = None,
                 shed_queue_depth: int | None = None,
                 role: str = "mixed", device="cuda"):
        # disaggregated fleet role.  "mixed" (default) serves both phases;
        # "prefill" runs chunked prefill only and hands each finished
        # prompt's KV blocks to the router's migration channel via the
        # _on_prefilled hook; "decode" is a normal engine the router never
        # routes fresh prompts to (adopted requests land via adopt_blocks).
        # Roles are *policy*: a prefill replica without a hook installed
        # (standalone use) decodes its own requests.
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"role={role!r} must be 'prefill', 'decode' "
                             f"or 'mixed'")
        self.role = role
        # router-installed migration hook: called on the executor thread
        # with (req, keys, block_ids, gens, leaves, tokens, last) when a
        # prefill-role replica finishes a prompt
        self._on_prefilled = None
        # rid -> staged adoption payload, written by adopt_blocks on the
        # migration worker and consumed by _admit_paged on the executor
        self._adoptions: dict = {}               # guarded-by: self._adopt_lock
        self._adopt_lock = threading.Lock()
        # fault tolerance: the replica's name (the fault plan's replica
        # filter), the injection plan, and the admission shed threshold
        # (queue depth beyond which submit() refuses with ShedError rather
        # than guarantee an SLO miss)
        self.name = name
        self.fault_plan = fault_plan
        self.shed_queue_depth = shed_queue_depth
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
        # the sharding rules and mesh current at construction, entered again
        # around every model call (the context is per thread)
        self._rules, self._mesh = current_rules(), current_mesh()
        if self._mesh is not None:
            _check_mesh_engine(self._rules, self._mesh, paged)
        if paged and self.fns.init_paged_state is None:
            raise ValueError(f"family {cfg.family!r} has no paged-KV "
                             f"support (ModelFns.init_paged_state is None)")
        self.paged = paged
        if self.role != "mixed" and not paged:
            raise ValueError("disaggregated roles need the paged KV engine "
                             "(migration moves pool blocks)")
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
        # tiered KV: cold blocks spill to a host tier and restore through
        # the split-phase offload protocol instead of being recomputed
        if host_blocks > 0 and not paged:
            raise ValueError("KV tiering (host_blocks > 0) needs the paged "
                             "KV engine")
        if host_blocks > 0 and not prefix_sharing:
            raise ValueError("KV tiering keys host-resident blocks by the "
                             "prefix digests; it needs prefix_sharing=True")
        self.tiered = paged and host_blocks > 0
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
        self._prefix_index: dict[bytes, tuple[int, int]] = {}  # owned-by: executor-thread
        self.prefix_shared_total = 0  # owned-by: executor-thread; lifetime shared entries
        # slot -> in-progress chunked prefill (insertion order = service
        # order); drained by the executor under the prefill_chunk budget
        self._prefilling: dict[int, _PrefillJob] = {}  # owned-by: executor-thread
        # slot -> first output token sampled at a disaggregated handoff but
        # not yet fed through *this* pool: the adopting decode step feeds
        # it forward without re-sampling or re-delivering it
        self._adopted_feed: dict[int, int] = {}  # owned-by: executor-thread
        self._last_decode_end: float | None = None  # owned-by: executor-thread
        self._gaps_dropped = 0  # owned-by: executor-thread; decode_gaps entries trimmed
        fns = self.fns
        if paged:
            worst = batch_slots * -(-(max_len + self.spec_rows) // block_size)
            self.pool = KVBlockPool(pool_blocks or worst, block_size,
                                    host_blocks=host_blocks)
            # the table width covers the speculative overhang: a verify pass
            # writes up to spec_rows rows past the committed length before
            # acceptance trims them back
            self.max_blocks = self.pool.blocks_for(max_len + self.spec_rows)
            self._prefix_cap = 8 * self.pool.capacity
            # host mirrors of the device block tables / lengths: growth and
            # slot retirement are numpy writes, re-injected every step
            self._tables = np.zeros((batch_slots, self.max_blocks),
                                    np.int32)   # owned-by: executor-thread
            self._lengths = np.zeros((batch_slots,),
                                     np.int32)  # owned-by: executor-thread
            self._prefill_paged = (
                lambda p, t, s, w, tb, qs, kl, li: fns.prefill_paged(
                    cfg, p, t, s, w, tb, q_start=qs, kv_len=kl, last_idx=li,
                    chunk=chunk))
        else:
            self.pool = None
        # whole-prompt prefill into a state with caches of max_len rows (one
        # reference jit entry per shape): the contiguous path's, in
        # _state_dtype, and the wave path's, in bf16 whatever cache_dtype
        # says, as the reference's fns.prefill builds them
        self._prefill = self._sharded(
            lambda p, b, cache_dtype=self._state_dtype: fns.prefill(
                cfg, p, b, max_len=max_len, chunk=chunk, cache_dtype=cache_dtype))
        # executor host time of the tier's two executor-side halves (the
        # device-to-host copy itself runs on the transfer worker)
        self.spill_capture_s = 0.0  # owned-by: executor-thread
        self.fetch_commit_s = 0.0   # owned-by: executor-thread
        # executor host time of landing migrated blocks (disaggregation)
        self.adopt_commit_s = 0.0   # owned-by: executor-thread
        if self.tiered:
            # host tier driven as a split-phase offload device: one FIFO
            # worker (spill-before-fetch ordering for a given key is free),
            # spills fire-and-forget via submit(), fetches via submit_async
            # so _drain_tier collects them out of order between decode steps
            self._kv_target = KVBlockTarget(self.pool.host)
            if fault_plan is not None:
                # kv.spill / kv.fetch probe sites fire on the transfer
                # worker, mapped from the payload kind by _kv_fault_hook
                self._kv_target.fault_hook = self._kv_fault_hook
            self._kv_io = OffloadEngine([self._kv_target])
            self._kv_io.__enter__()           # daemon worker; see close()
            self.pool.on_demote = self._on_demote
            self._held_digests: dict[int, bytes] = {}  # owned-by: executor-thread; bid -> key
            self._fetch_refs: dict[int, tuple] = {}    # owned-by: executor-thread; seq -> ref
            self._staged: dict[int, object] = {}       # owned-by: executor-thread; early done
            self._claimed: set[int] = set()            # owned-by: executor-thread; pre-drain
        else:
            self._kv_io = None
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
        self._spec_on: set = set()  # owned-by: executor-thread; slots decoding speculatively
        self.scheduler = ContinuousScheduler(batch_slots, pool=self.pool,
                                             preemption=preemption,
                                             spec_rows=self.spec_rows)
        self._decode = self._sharded(lambda p, t, s: fns.decode(cfg, p, t, s, chunk=chunk))
        # distinct padded prefill shapes: the reference jit-compiles once
        # per shape; the same padding keeps this counter equal to its
        self._prefill_shapes: set = set()  # owned-by: executor-thread
        self._state = None  # owned-by: executor-thread; decode state, built lazily
        self._last: np.ndarray | None = None  # owned-by: executor-thread; (slots, V) logits
        self.totals = ServeStats()          # lifetime counters (monotonic)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # control-plane state shared with traffic threads: the captured
        # executor failure and whether stop() already surfaced it
        self._ctl_lock = threading.Lock()
        self._failure: BaseException | None = None  # guarded-by: self._ctl_lock
        self._failure_raised = False                # guarded-by: self._ctl_lock
        self._spill_delays: dict[bytes, float] = {}  # guarded-by: self._ctl_lock; key -> kv.spill delay
        # True once any submitted request carried a deadline_s -- lets the
        # executor skip the per-step deadline sweep for deadline-free
        # workloads (monotonic bool; racing the writer only delays the
        # first sweep by one step)
        self._has_deadlines = False

    # -- model plumbing --------------------------------------------------------

    def _sharded(self, fn):
        """``fn`` run under the rules and mesh the engine was built under
        (``fn`` itself without a mesh)."""
        if self._mesh is None:
            return fn
        rules, mesh = self._rules, self._mesh

        def run(*args, **kw):
            with use_rules(rules, mesh):
                return fn(*args, **kw)
        return run

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
        if req.deadline_s is not None:
            # monotonic enable flag for the executor's deadline sweep;
            # both admission paths (blocking serve, service submit) pass
            # through here before the scheduler sees the request
            self._has_deadlines = True

    # -- fault tolerance -------------------------------------------------------

    @property
    def failure(self) -> BaseException | None:
        """The exception that killed the executor, if any (thread-safe)."""
        with self._ctl_lock:
            return self._failure

    def _fault(self, site: str, rid=None) -> str | None:
        """Fire the fault plan's probe at ``site``: returns None (no
        fault) or the action that fired -- ``delay`` already slept here,
        ``raise`` already raised :class:`FaultError`, ``drop`` is the
        caller's to interpret (lost result / lost transfer).  Called from
        the executor thread and from the KV transfer worker."""
        spec = self._fire(site, rid)
        if spec is None:
            return None
        if spec.action == "delay":
            time.sleep(spec.delay_s)
            return "delay"
        if spec.action == "raise":
            raise FaultError(site, f"rid={rid}" if rid is not None else "")
        return "drop"

    def _fire(self, site: str, rid=None):
        """Fire the fault plan's probe at ``site`` and count a hit; returns
        the spec that fired, or None.  Acting on it is the caller's."""
        plan = self.fault_plan
        if plan is None:
            return None
        spec = plan.fire(site, rid=rid, replica=self.name)
        if spec is not None:
            with self._ctl_lock:      # probe fires on two threads
                self.totals.faults_injected += 1
        return spec

    def _kv_fault_hook(self, item) -> bool:
        """Transfer-worker probe (installed on the KVBlockTarget).  A fetch
        fires ``kv.fetch`` here; True drops it, and it reports a tier miss
        (the engine recomputes the block).  A spill's ``kv.spill`` probe
        already fired at submit (:meth:`_spill_block`): only a delay it
        drew is slept here, so the transfer is what it slows."""
        if item.payload[0] == "spill":
            with self._ctl_lock:
                delay = self._spill_delays.pop(item.payload[1], 0.0)
            if delay:
                time.sleep(delay)
            return False
        return self._fault("kv.fetch") == "drop"

    def _finish_failed(self, req: Request, exc: BaseException) -> None:
        """Move ``req`` to its terminal FAILED state and notify."""
        with self._adopt_lock:
            # a staged-but-never-landed adoption (deadline/crash before
            # admission) must not pin its host payload forever
            staged = self._adoptions.get(req.rid)
            if staged is not None and staged.req is req:
                del self._adoptions[req.rid]
        req.state = RequestState.FAILED
        req.error = exc
        req.finished_at = time.monotonic()
        self.totals.requests_failed += 1
        if req.on_finish is not None:
            try:
                req.on_finish(req)
            except Exception:  # fault-ok: a raising completion callback must not take down the failure path reporting the failure
                pass

    def _fail_slot(self, slot: int, req: Request, exc: BaseException) -> None:
        """Poison-request isolation: one request's prefill chunk or decode
        commit raised, so *that request* fails -- blocks freed, reservation
        returned, drafter mirror dropped, slot refilled next step -- and
        the executor loop lives on.

        Popping the prefill job is enough for in-flight host-tier fetches
        (the drain's job-alive guard discards commits for a dead job);
        only admission prefetches that never reached materialization need
        explicit discarding."""
        job = self._prefilling.pop(slot, None)
        if job is not None and job.pos == -1:
            for item in job.prefetch.values():
                self._discard_fetch(item)
        if self._drafter is not None:
            self._drafter.drop(slot)
            self._spec_on.discard(slot)
        self.scheduler.release(slot)       # blocks + reservation tail back
        if self.paged:
            self._retire_slot(slot)
        self._finish_failed(req, exc)
        self.scheduler.notify_capacity()   # a slot just opened

    def _record_crash(self, exc: BaseException) -> None:
        """Executor crash capture (runs on the dying executor thread): a
        non-request fault escaped :meth:`_step`.  Capture it so it
        surfaces through :attr:`failure` / :meth:`stop`, poison the
        scheduler against late submits, and fail every request this
        executor will now never serve, returning their blocks."""
        with self._ctl_lock:
            if self._failure is None:
                self._failure = exc
        self.scheduler.poison(exc)
        failed = self.scheduler.drain_queue()
        for slot, req in self.scheduler.active():
            try:
                self._fail_slot(slot, req, exc)
            except Exception:  # fault-ok: crash-path cleanup is best-effort — the pool may be mid-mutation from the very fault being handled
                self._finish_failed(req, exc)
        for req in failed:
            self._finish_failed(req, exc)

    def _raise_failure_once(self) -> None:
        """Surface a captured executor crash exactly once (stop() calls
        this; a second stop() is then silent -- idempotent teardown).  A
        stop() before any crash leaves the flag alone, so a crash after a
        clean stop-and-restart still surfaces (the reference marks it
        surfaced on every call, and so swallows that later crash)."""
        with self._ctl_lock:
            failure = self._failure
            raised = self._failure_raised
            if failure is not None:
                self._failure_raised = True
        if failure is not None and not raised:
            raise ExecutorCrash(
                "executor thread died mid-serve") from failure

    def _sweep_deadlines(self) -> None:
        """Fail queued and active requests whose hard deadline elapsed --
        decoding them further would deliver tokens the caller has already
        abandoned.  Skipped entirely for deadline-free workloads."""
        if not self._has_deadlines:
            return
        now = time.monotonic()
        for req in self.scheduler.expire_deadlines(now):
            self._finish_failed(
                req, DeadlineExceeded(
                    f"request {req.rid}: deadline {req.deadline_s}s "
                    f"elapsed while queued"))
        for slot, req in self.scheduler.active():
            if req.deadline_elapsed(now):
                self._fail_slot(
                    slot, req, DeadlineExceeded(
                        f"request {req.rid}: deadline {req.deadline_s}s "
                        f"elapsed after {len(req.output)} tokens"))

    def _bucket_len(self, n: int) -> int:
        """Smallest power-of-two multiple of block_size holding ``n``."""
        b = self.block_size
        while b < n:
            b *= 2
        return b

    def _batch_for(self, prompts: np.ndarray) -> dict:
        """prompts: (W, S) -> model batch dict: the tokens, and as the
        reference builds them, M-RoPE's (3, W, S) positions (three equal
        streams 0..S-1) and the audio family's (W, F, d_model) fp32 frames
        (zeros: the audio frontend is a stub)."""
        W, S = np.shape(prompts)
        batch = {"tokens": self._to_device(np.asarray(prompts, np.int32))}
        if self.cfg.m_rope:
            pos = torch.arange(S, dtype=torch.int32, device=self.device)
            batch["positions"] = pos.expand(3, W, S)
        if self.cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (W, self.cfg.encdec.num_encoder_frames, self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        return batch

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
        return self._sharded(self.fns.init_decode_state)(
            self.cfg, self.slots, self.max_len, self._state_dtype, device=self.device)

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
        if self.tiered and shared:
            # a hit refreshes demotion LRU: blocks just seeded from are
            # the worst possible eviction victims
            self.pool.touch(shared)
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
            if self.tiered and bid not in self._held_digests:
                # the index itself holds the block: when its requests all
                # leave it turns *demotable* (spill-then-free on demand)
                # instead of vanishing into the free list
                self.pool.hold(bid)
                self._held_digests[bid] = keys[j]
        if self.tiered:
            # tiered mode un-caps the index by recency: live entries are
            # bounded by pool capacity (each holds a distinct block) and
            # dead ones are just tombstones -- prune those, keep the rest
            if len(self._prefix_index) > self._prefix_cap:
                self._prefix_index = {
                    k: e for k, e in self._prefix_index.items()
                    if self.pool.block_live(*e)}
            return
        if len(self._prefix_index) > self._prefix_cap:
            # two-phase trim: stale-generation entries go first, and only
            # if that is not enough are *live* entries capped --
            # oldest-published first (dict order)
            live = {k: e for k, e in self._prefix_index.items()
                    if self.pool.block_live(*e)}
            for k in list(live)[:max(0, len(live) - self._prefix_cap)]:
                del live[k]
            self._prefix_index = live

    # -- KV tiering: host-offloaded blocks over the split-phase protocol ------

    def _read_block_slices(self, bid: int) -> dict:
        """Per-leaf *copies* of one pool block's rows, captured on the
        executor thread before the block id can be reused.  The pools are
        written in place, so a view would read whatever a later prefill
        writes into the reused block; the clone is enqueued on this
        thread's stream ahead of any such write, so stream order makes it
        read the old rows, and the transfer worker materializes it to host
        memory at its leisure.  Runs under the pool lock from
        :meth:`_on_demote`: it touches no pool state."""
        leaves = {}
        for name in ("k", "v", "k_scale", "v_scale"):
            arr = getattr(self._state, name, None)
            if arr is not None:
                leaves[name] = arr[:, bid].clone()
        return leaves

    def _write_block(self, bid: int, payload: dict) -> None:
        """Restore one fetched block's rows into pool block ``bid``."""
        self._write_blocks([bid], [payload])

    def _write_blocks(self, bids: list[int], payloads: list[dict]) -> None:
        """Land ``payloads[i]`` (host numpy leaves; bf16 as int16 bits)
        into pool block ``bids[i]``, in place: one host-to-device copy and
        one ``index_copy_`` per pool leaf, on the executor's stream (so the
        in-flight decode step, enqueued before, reads the old rows)."""
        if not bids:
            return
        idx = torch.tensor(bids, dtype=torch.long, device=self.device)
        for name in payloads[0]:
            arr = getattr(self._state, name)
            host = torch.from_numpy(np.ascontiguousarray(
                np.stack([p[name] for p in payloads], axis=1)))
            if arr.dtype == torch.bfloat16 and host.dtype == torch.int16:
                host = host.view(torch.bfloat16)
            arr.index_copy_(1, idx, host.to(self.device, arr.dtype))

    def _spill_block(self, bid: int, key: bytes) -> bool:
        """Queue one block's device->host copy under ``key`` unless the
        tier already holds (or is receiving) it; returns True if queued.
        The copy itself runs on the offload worker, overlapped with
        decode steps -- only the block's clone is enqueued here."""
        host = self.pool.host
        if key in host:
            return False
        t0 = time.perf_counter()
        leaves = self._read_block_slices(bid)
        # ``kv.spill`` fires here, on the executor thread, at submit.  A
        # dropped spill never pins its key, so whether a later probe finds
        # the key resident does not hang on when the transfer worker gets
        # to the drop (the count the reference settles to when its worker
        # keeps up).
        spec = self._fire("kv.spill")
        if spec is None or spec.action != "drop":
            if spec is not None:
                with self._ctl_lock:
                    self._spill_delays[key] = spec.delay_s
            host.begin_store(key)       # pin: tier eviction skips pendings
            self._kv_io.submit(("spill", key, leaves),
                               on_done=lambda item, key=key:
                               self._spill_done(key, item))
        self.spill_capture_s += time.perf_counter() - t0
        self.totals.kv_spills += 1
        self.totals.spill_bytes += sum(int(v.nbytes) for v in leaves.values())
        return True

    def _spill_done(self, key: bytes, item) -> None:
        """Spill completion hook (transfer-worker thread): a dropped or
        failed spill leaves a pinned pending placeholder nothing will
        ever fill -- release it, so the tier does not leak and a later
        fetch of the key cleanly misses into recompute."""
        if item.result is None or isinstance(item.result, WorkError):
            self.pool.host.drop(key)

    # assumes-lock: KVBlockPool._lock
    def _on_demote(self, ids: list[int]) -> None:
        """Pool demotion hook (runs under the pool lock -- must not
        re-enter the pool): an idle index-held block is about to return
        to the free list, so its content spills to the host tier first.
        The clone in :meth:`_read_block_slices` makes the free
        race-safe."""
        for bid in ids:
            key = self._held_digests.pop(bid, None)
            if key is not None:
                self._spill_block(bid, key)

    def _spill_victim(self, req: Request) -> None:
        """Preemption demote-on-evict: the victim's freed history blocks
        (prompt + generated, folded) spill keyed by the same chained
        digests re-admission will look up -- resume then *restores* the
        history instead of recomputing it.  Runs in the drain_preempted
        handler, before any post-eviction prefill can write the freed
        ids."""
        ids, req.evicted_block_ids = req.evicted_block_ids, []
        if not self.tiered or not ids:
            return
        keys = self._prefix_keys(req.prefill_tokens)
        for j in range(min(len(keys), len(ids))):
            ent = self._prefix_index.get(keys[j])
            if ent is not None and self.pool.block_live(*ent):
                continue                # still device-resident via the index
            self._spill_block(ids[j], keys[j])

    def _seed_pos(self, job: _PrefillJob) -> int:
        """First unseeded row once fetches settle: the device-shared run
        plus the contiguous restored run after it (a failed fetch caps
        the run; recompute overwrites the own blocks past it)."""
        if not self.seeded_prefill:
            return 0
        j = job.seed_base
        while j in job.fetched_ok:
            j += 1
        return j * self.block_size

    def _commit_fetch(self, job: _PrefillJob, j: int, bid: int,
                      payload: dict) -> None:
        """Restore logical block ``j`` of ``job`` into pool block ``bid``."""
        t0 = time.perf_counter()
        self._write_block(bid, payload)
        self.fetch_commit_s += time.perf_counter() - t0
        job.fetched_ok.add(j)
        self.totals.kv_fetches += 1
        self.totals.prefix_hits_host += 1

    def _drain_tier(self, timeout: float | None = 0.0) -> None:
        """Collect completed host-tier fetches and commit them into their
        jobs' pool blocks.  Runs on the executor thread between decode
        steps (and blocking briefly when a prefill has nothing else to
        do).  A commit is guarded three ways: the job must still be its
        slot's live prefill (not preempted since), the target block must
        still be this allocation (generation tag -- the spill->free->
        realloc->fetch race), and the payload non-None (the tier may
        have evicted the key after the prefetch probe)."""
        if not self.tiered:
            return
        while True:
            item = self._kv_io.next_done(timeout=timeout)
            if item is None:
                return
            timeout = 0.0                # only block for the first item
            if item.seq in self._claimed:
                self._claimed.discard(item.seq)
                continue
            ref = self._fetch_refs.pop(item.seq, None)
            if ref is None:
                # prefetch finished before its job materialized blocks:
                # park it -- _materialize_blocks consumes it from here
                self._staged[item.seq] = item
                continue
            job, j, bid, gen = ref
            job.pending_n -= 1
            alive = self._prefilling.get(job.slot) is job
            result = item.result
            if isinstance(result, WorkError):  # failed transfer = tier miss
                result = None
            if (result is not None and alive
                    and self.pool.block_live(bid, gen)):
                self._commit_fetch(job, j, bid, result)
            if alive and job.pending_n == 0 and job.pos == -2:
                job.pos = self._seed_pos(job)

    def _discard_fetch(self, item) -> None:
        """Drop an unused fetch item (prefetch past the seed window, or a
        dead job's leftovers) without leaking drain-side state."""
        if item.seq in self._staged:
            del self._staged[item.seq]   # already popped from the done-q
        else:
            self._claimed.add(item.seq)  # done-q will deliver; drain drops

    def drain_tier_io(self, timeout: float = 10.0) -> None:
        """Quiesce the host-tier transfer engine: block until every
        in-flight spill and fetch has landed (or been dropped) and the
        drain-side staging state is empty.  Call it after a serve -- or
        after a crash, when nobody else will ever drain -- so a leak check
        never misreads a transient pending pin or a parked fetch as a
        leak."""
        if not self.tiered:
            return
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._drain_tier(timeout=0.01)
            for seq in list(self._staged):       # orphans with no live job
                self._staged.pop(seq)
            if (not self._fetch_refs and not self._staged
                    and self.pool.host.pending_count == 0):
                return
        raise TimeoutError("host-tier IO did not quiesce within "
                           f"{timeout}s: {self.pool.leak_report()}")

    def close(self) -> None:
        """Shut the host tier's transfer worker down (after
        :meth:`drain_tier_io`).  The worker otherwise lives as long as the
        process and keeps the engine -- its pools and weights -- reachable
        through the fault hook and the tier.  Idempotent; the engine must
        not serve tiered traffic afterwards."""
        if self._kv_io is not None and self._kv_io._open:
            self._kv_io.__exit__(None, None, None)

    def _admit_paged(self, slot: int, req: Request) -> None:
        """Queue an admitted request's cache-seeded chunked prefill (block
        materialization is deferred to its first chunk).  The decode-state
        table row stays at the trash block until the prefill completes:
        the in-flight batched decode keeps writing this slot's (discarded)
        row, and must not corrupt half-filled prompt blocks.

        A request whose KV arrived by migration skips prefill entirely: its
        staged adoption payload lands here instead.  A *preempted* adopted
        request finds its payload already consumed and falls through to the
        normal recompute path -- roles are placement policy, not an engine
        capability split."""
        with self._adopt_lock:
            adoption = self._adoptions.get(req.rid)
            if adoption is not None and adoption.req is req:
                del self._adoptions[req.rid]
            else:
                adoption = None
        if adoption is not None:
            self._adopt_slot(slot, req, adoption)
            return
        toks = req.prefill_tokens
        P = len(toks)
        nb = self.pool.blocks_for(P)
        keys = self._prefix_keys(toks) if self.prefix_sharing else []
        self._tables[slot] = 0
        self._lengths[slot] = 0
        job = _PrefillJob(req=req, tokens=toks, nb=nb, keys=keys, slot=slot)
        self._prefilling[slot] = job
        self.totals.prefill_tokens_total += P
        if self.tiered and self.seeded_prefill:
            # prefetch-at-admission: fetches for the host-resident run
            # past the device-resident run start moving now, overlapped
            # with everything between admission and this job's first
            # chunk (materialization claims or re-probes them)
            host = self.pool.host
            ndev = len(self._lookup_prefix(keys))
            for key in keys[ndev:]:
                if key not in host:
                    break
                job.prefetch[key] = self._kv_io.submit_async(("fetch", key))

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
        job.seed_base = ns
        if not (self.tiered and self.seeded_prefill):
            job.pos = ns * bs if self.seeded_prefill else 0
            return
        # host-restorable run: own blocks past the device-shared run whose
        # content the host tier holds -- claim the admission prefetches (or
        # probe late for keys that demoted since), committing into the
        # just-allocated blocks as each fetch lands
        host = self.pool.host
        used: set[int] = set()
        for j in range(ns, (P - 1) // bs):
            key = job.keys[j]
            item = job.prefetch.get(key)
            if item is None:
                if key not in host:
                    break
                item = self._kv_io.submit_async(("fetch", key))
                job.prefetch[key] = item
            used.add(item.seq)
            bid, gen = req.block_ids[j], self.pool.generation(req.block_ids[j])
            if item.done.is_set():           # landed before materialization
                result = item.result
                if isinstance(result, WorkError):
                    result = None            # failed transfer = tier miss
                if result is None:
                    self._discard_fetch(item)
                    break                    # evicted since the probe: the
                                             # seed run caps here, recompute
                                             # overwrites the blocks past it
                self._commit_fetch(job, j, bid, result)
                self._discard_fetch(item)    # retire its drain-side state
            else:
                self._fetch_refs[item.seq] = (job, j, bid, gen)
                job.pending_n += 1
        for item in job.prefetch.values():   # prefetches past the run/cap
            if item.seq not in used and item.seq not in self._fetch_refs:
                self._discard_fetch(item)
        job.pos = -2 if job.pending_n else self._seed_pos(job)

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
        if self._fault("engine.prefill", rid=req.rid) == "drop":
            raise FaultError("engine.prefill",
                             f"dropped prefill chunk of {req.rid}")
        if job.pos == -1:
            self._materialize_blocks(job)
        if job.pos == -2:
            # host-tier fetches still inbound: try a non-blocking drain,
            # then skip this slot for the step (like a mid-prefill slot)
            # rather than stall the batch on the transfer
            self._drain_tier(timeout=0.0)
            if job.pos == -2:
                return 0
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
        if self.role == "prefill" and self.device.type == "cuda":
            # full-budget chunks enqueue back to back, and on a card shared
            # with a decode replica an unforced run piles up queued compute
            # that the decode replica's next step waits behind -- wait for
            # each chunk so the convoy never forms (the reference blocks on
            # the chunk's logits the same way)
            torch.cuda.current_stream(self.device).synchronize()
        self.totals.prefill_tokens_computed += real
        job.pos = start + real
        if job.pos == P:                     # logits of the last real token
            del self._prefilling[slot]
            self._tables[slot] = 0
            if self.role == "prefill" and self._on_prefilled is not None:
                # disaggregated fleet: this replica's work ends at the last
                # prompt token -- hand the blocks to the router's migration
                # channel instead of entering decode
                self._handoff(slot, job, req, last[0].cpu().numpy())
                return real
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

    def _handoff(self, slot: int, job: _PrefillJob, req: Request,
                 last1: np.ndarray) -> None:
        """Disaggregated prefill completion (executor thread): export-pin
        the prompt's blocks, clone their rows, release the slot, and fire
        the router's migration hook.

        :meth:`KVBlockPool.export_blocks` adds a holder per block *before*
        ``release()`` drops the request's holders, so the ids stay
        allocated (and their generations frozen) until the router's
        completion hook frees the export.  The pools are written in place,
        so the rows are *cloned* (:meth:`_read_block_slices`) on this
        thread's stream: a later write to a block is enqueued behind its
        clone, and the migration worker's device-to-host copy behind both.

        The first token is sampled and delivered here, from the final
        chunk's logits: migration latency leaves the TTFT path.  The
        adopting replica feeds it forward without re-sampling it (the
        sampler's stream advances exactly once)."""
        tok = int(req.sampler.sample(last1[None])[0])
        req.output.append(tok)
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
        self.totals.tokens += 1
        if len(req.output) >= req.max_new_tokens:
            # single-token request: DONE at handoff -- nothing to migrate
            if self.prefix_sharing:
                self._register_prefix(job.keys, req)
            self._spec_on.discard(slot)
            req.state = RequestState.DONE
            req.finished_at = time.monotonic()
            self.scheduler.release(slot)
            self._retire_slot(slot)
            self.scheduler.notify_capacity()
            if req.on_finish is not None:
                req.on_finish(req)
            return
        ids = list(req.block_ids)
        gens = self.pool.export_blocks(ids)
        leaves = [self._read_block_slices(b) for b in ids]
        if self.prefix_sharing:
            # publish locally too: a later prompt sharing this prefix
            # prefills cache-seeded on this replica
            self._register_prefix(job.keys, req)
        self._spec_on.discard(slot)   # drafter was never seeded: the slot
        #                               retires before its decode begins
        req.state = RequestState.PREFILLED
        self.scheduler.release(slot)  # request holders drop; exports stay
        self._retire_slot(slot)
        self.scheduler.notify_capacity()   # slot + blocks just came back
        self._on_prefilled(req, list(job.keys), ids, gens, leaves,
                           np.asarray(job.tokens), last1)

    def _adopt_slot(self, slot: int, req: Request,
                    adoption: _Adoption) -> None:
        """Land a migrated prefill straight into this pool (executor
        thread): allocate blocks from the admission reservation, write the
        payload rows with one batched :meth:`_write_blocks` (enqueued
        behind the in-flight decode step, like a prefill chunk's write),
        and enter DECODE *after* the handoff-sampled first token -- the
        next decode step feeds that token forward instead of sampling, so
        greedy outputs equal a local prefill's and no sampler stream
        advances twice."""
        tokens = adoption.tokens
        P = len(tokens)
        nb = self.pool.blocks_for(P)
        own = self.pool.alloc_reserved(nb)
        req.block_ids = own
        req.shared_blocks = 0
        req.blocks_reserved -= nb       # remaining = decode-growth tail
        # generation-safe: `own` was alloc_reserved just above -- private
        # refcount-1 blocks no other slot can reference, so no generation
        # check is needed before writing
        t0 = time.perf_counter()
        self._write_blocks(own, adoption.blocks)
        self.adopt_commit_s += time.perf_counter() - t0
        self._tables[slot] = 0
        if slot in self._spec_on:
            # same contract as prefill completion: speculative slots stay
            # off the batched vanilla decode; the drafter re-prefills the
            # migrated history through its own mirror
            self._lengths[slot] = 0
            self._drafter.seed(slot, tokens,
                               len(req.prompt) + req.max_new_tokens
                               + self.spec_k)
            # the verify invariant wants ``_last`` = distribution after the
            # committed stream with every committed row written; the
            # handoff-sampled token has neither, so hand it back to the
            # verify pass as its pending ``t_0`` (no re-sample) and
            # pre-compensate the commit's recount of a token the handoff
            # already delivered
            self._adopted_feed[slot] = req.output.pop()
            self.totals.tokens -= 1
        else:
            self._tables[slot, :nb] = own
            self._lengths[slot] = P
            # the handoff already sampled and delivered ``output[-1]``; the
            # next decode step feeds it forward (writing KV row P and
            # producing next-token logits) without re-sampling it
            self._adopted_feed[slot] = req.output[-1]
        self._set_last(slot, adoption.last)
        if self.prefix_sharing:
            self._register_prefix(adoption.keys, req)
        self.totals.kv_migrations += 1
        self.totals.migrated_blocks += nb
        # the whole prompt arrives precomputed: total rises, computed does
        # not -- prefill_compute_frac is the zero-recompute evidence
        self.totals.prefill_tokens_total += P
        req.state = RequestState.DECODE
        self.scheduler.notify_capacity()

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
        # a handoff-sampled token pending for a slot that dies before its
        # feed step must not leak into the slot's next occupant
        self._adopted_feed.pop(slot, None)

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
        # a raise here is a *replica* fault, not a request fault: it
        # escapes _step, kills the executor, and exercises the crash
        # capture path (_record_crash / failure / stop)
        self._fault("replica.executor")
        self._sweep_deadlines()
        admitted = self.scheduler.admit()
        # trash the tables of any slots admit() preempted *before*
        # prefilling new prompts into the freed blocks: the victim slot
        # keeps writing its (discarded) decode row to the trash block
        for slot, victim in self.scheduler.drain_preempted():
            self._retire_slot(slot)
            self._spill_victim(victim)
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
            try:
                if self.paged:
                    self._admit_paged(slot, req)
                    if self.prefill_chunk is None:
                        # un-chunked: finish this prompt before admitting
                        # the next, so its published prefix blocks are
                        # sharable (and seedable) by the very next
                        # admission; a zero advance means the job is
                        # waiting on host-tier fetches -- block briefly on
                        # the drain, there is nothing else to overlap
                        # them with here
                        while slot in self._prefilling:
                            if self._advance_prefill(slot) == 0:
                                self._drain_tier(timeout=0.005)
                else:
                    if self._fault("engine.prefill", rid=req.rid) == "drop":
                        raise FaultError("engine.prefill",
                                         f"dropped prefill of {req.rid}")
                    last1, state1 = self._prefill_one(req)
                    self.totals.prefill_tokens_total += \
                        len(req.prefill_tokens)
                    self.totals.prefill_tokens_computed += \
                        len(req.prefill_tokens)
                    self._state = _merge_slot(self._state, state1, slot)
                    self._set_last(slot, last1)
                    req.state = RequestState.DECODE
            except Exception as e:  # noqa: BLE001 -- poison isolation:
                # one request's raising prefill fails that request, not
                # the executor (crash faults escape one level up)
                self._fail_slot(slot, req, e)

        if self._prefilling:
            # chunked mode: spend at most prefill_chunk prompt tokens per
            # executor step, oldest admission first, then fall through to
            # the decode step; the remaining budget caps each chunk.  A
            # prefill-role replica has no decode slots to protect: it keeps
            # the chunk-sized shapes but runs them back to back at full
            # budget instead of one per step.
            self._drain_tier(timeout=0.0)    # commit landed fetches first
            budget = (self.prefill_chunk if self.role != "prefill"
                      else (1 << 30))
            while budget >= self.block_size:
                # oldest admission first, skipping slots whose blocks are
                # still inbound from the host tier (the fetch overlaps
                # the chunks and decode steps below)
                job = next((j for j in self._prefilling.values()
                            if j.pos != -2), None)
                if job is None:
                    break
                try:
                    budget -= self._advance_prefill(job.slot, budget)
                except Exception as e:  # noqa: BLE001 -- poison isolation
                    self._fail_slot(job.slot, job.req, e)

        active = self.scheduler.decoding()
        if not active:
            # a prefill-only period is not a decode gap
            self._last_decode_end = None
            if (self._prefilling
                    and all(j.pos == -2
                            for j in self._prefilling.values())):
                # every job is waiting on inbound blocks and there is no
                # decode to overlap with: block briefly on the drain
                # instead of spinning the executor
                self._drain_tier(timeout=0.005)
            return bool(self._prefilling)

        spec = [(s, r) for s, r in active if s in self._spec_on]
        spec_slots = {s for s, _ in spec}    # before the verify retires any
        if spec:
            self._verify_step(spec)
        active = [(s, r) for s, r in active if s not in spec_slots]
        if not active:
            return True

        toks = self._sample_active(
            [(s, r) for s, r in active if s not in self._adopted_feed])
        now = time.monotonic()
        feed = np.zeros((self.slots, 1), np.int32)
        for slot, req in active:
            pend = self._adopted_feed.pop(slot, None)
            tok = toks[slot] if pend is None else pend
            try:
                if self._fault("engine.decode", rid=req.rid) == "drop":
                    raise FaultError("engine.decode",
                                     f"dropped decode commit of {req.rid}")
            except Exception as e:  # noqa: BLE001 -- poison isolation: the
                # failed slot leaves `feed` at 0 against a trashed table,
                # exactly like a retired speculative slot
                self._fail_slot(slot, req, e)
                continue
            feed[slot, 0] = tok
            if pend is not None:
                # adopted slot: this token was sampled and delivered at the
                # prefill replica's handoff -- feed it forward, but do not
                # deliver it twice (it cannot be the request's final token
                # either: single-token requests finish at handoff)
                continue
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
            # an adopted slot's t_0 was already sampled (and delivered) at
            # the prefill replica's handoff -- committing it below restores
            # the verify invariant without re-sampling
            pend = self._adopted_feed.pop(slot, None)
            t0 = (pend if pend is not None
                  else int(req.sampler.sample(self._last[slot][None])[0]))
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
            try:
                if self._fault("engine.decode", rid=req.rid) == "drop":
                    raise FaultError("engine.decode",
                                     f"dropped verify commit of {req.rid}")
            except Exception as e:  # noqa: BLE001 -- poison isolation:
                # provisional rows already live in req.block_ids, so the
                # slot teardown frees them with the rest of the table
                self._fail_slot(slot, req, e)
                continue
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
            decode_gap_n=self._gaps_dropped + len(self.totals.decode_gaps),
            kv_spills=self.totals.kv_spills,
            kv_fetches=self.totals.kv_fetches,
            prefix_hits_host=self.totals.prefix_hits_host,
            spill_bytes=self.totals.spill_bytes,
            requests_failed=self.totals.requests_failed,
            shed_rejections=self.totals.shed_rejections,
            faults_injected=self.totals.faults_injected,
            kv_migrations=self.totals.kv_migrations,
            migrated_blocks=self.totals.migrated_blocks)

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
        stats.kv_spills = self.totals.kv_spills - base.kv_spills
        stats.kv_fetches = self.totals.kv_fetches - base.kv_fetches
        stats.prefix_hits_host = (self.totals.prefix_hits_host
                                  - base.prefix_hits_host)
        stats.spill_bytes = self.totals.spill_bytes - base.spill_bytes
        stats.requests_failed = (self.totals.requests_failed
                                 - base.requests_failed)
        stats.shed_rejections = (self.totals.shed_rejections
                                 - base.shed_rejections)
        stats.faults_injected = (self.totals.faults_injected
                                 - base.faults_injected)
        stats.kv_migrations = (self.totals.kv_migrations
                               - base.kv_migrations)
        stats.migrated_blocks = (self.totals.migrated_blocks
                                 - base.migrated_blocks)
        if stats.prefix_lookups:
            stats.kv_hit_rate = ((stats.prefix_shared_blocks
                                  + stats.prefix_hits_host)
                                 / stats.prefix_lookups)
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
        every request is DONE or FAILED.  A crash fails every queued and
        active request (returning their blocks), poisons the scheduler
        against later submits, and escapes."""
        assert self._thread is None, "engine already running in service mode"
        for r in requests:
            self._check_fits(r)
        base = self.begin_window()
        t0 = time.monotonic()
        for r in requests:
            self.scheduler.submit(r)
        while self.scheduler.has_work():
            try:
                self._step()
            except Exception as e:  # noqa: BLE001 -- crash capture: fail
                # every in-flight request (freeing its blocks) before the
                # crash surfaces, so the pool stays leak-free even when
                # the executor dies mid-batch
                self._record_crash(e)
                raise
        return self.collect_window(base, requests, time.monotonic() - t0)

    # -- service mode ----------------------------------------------------------

    def start(self) -> None:
        """Run the executor on a thread of its own (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._service_loop,
                                        name="serving-executor", daemon=True)
        self._thread.start()

    def _service_loop(self) -> None:
        try:
            while not self._stop.is_set():
                if not self.scheduler.wait_for_work(timeout=0.02):
                    continue
                self._step()
        except Exception as e:  # noqa: BLE001 -- crash capture: the
            # executor must not die silently; record the failure, fail
            # every in-flight request (freeing its KV blocks), and poison
            # the scheduler so later submitters see ExecutorCrash instead
            # of a hang.  stop()/failure re-surface the exception.
            self._record_crash(e)

    def submit(self, req: Request,
               on_finish: Callable[[Request], None] | None = None) -> None:
        """Thread-safe admission; ``on_finish`` fires from the executor
        thread the moment the request is DONE or FAILED.

        Raises :class:`ExecutorCrash` (chained to the original failure)
        if the executor has died, and :class:`ShedError` when the queue
        is already ``shed_queue_depth`` deep -- an admission there could
        only miss its SLO, so shedding it early is the graceful
        degradation mode."""
        crash = self.failure
        if crash is not None:
            raise ExecutorCrash(
                "executor is dead; submit refused") from crash
        if self.shed_queue_depth is not None:
            depth = self.scheduler.queued
            if depth >= self.shed_queue_depth:
                with self._ctl_lock:
                    self.totals.shed_rejections += 1
                raise ShedError(
                    f"queue depth {depth} >= shed threshold "
                    f"{self.shed_queue_depth}")
        self._check_fits(req)
        req.replica = self.name
        if on_finish is not None:
            req.on_finish = on_finish
        self.scheduler.submit(req)

    def adopt_blocks(self, req: Request, keys: list, tokens: np.ndarray,
                     blocks: list, last: np.ndarray) -> int:
        """Thread-safe admission of a *migrated* prefill -- the receiver
        half of the disaggregated handoff, called on the migration worker.
        Stages the payload and queues the request; the executor lands the
        rows into freshly allocated pool blocks at admission
        (:meth:`_adopt_slot`) and enters DECODE without recomputing a
        single prompt token.

        Unlike :meth:`submit` there is no shed check: the prefill compute
        is already spent (the request was shed-checked at its original
        admission).  Raises ``CapacityError`` / :class:`ExecutorCrash` like
        submit; the migration completion hook turns either into the
        retry-from-bare-prompt path.  Returns the number of blocks staged
        -- the migrate payload's success result."""
        req.replica = self.name    # before any raise: failures inside the
        #                            adopt are charged to *this* replica
        crash = self.failure
        if crash is not None:
            raise ExecutorCrash(
                "executor is dead; adopt refused") from crash
        self._check_fits(req)
        # the seq was minted by the source scheduler's heap; this one must
        # assign its own tiebreak, exactly like a stolen request
        req.arrival_seq = None
        with self._adopt_lock:
            self._adoptions[req.rid] = _Adoption(
                req=req, keys=keys, tokens=tokens, blocks=blocks,
                last=last)
        try:
            self.scheduler.submit(req)
        except BaseException:
            with self._adopt_lock:
                self._adoptions.pop(req.rid, None)
            raise
        return len(blocks)

    def stop(self, timeout: float = 10.0, *,
             raise_failure: bool = True) -> None:
        """Stop the service-mode executor thread; idempotent, safe to
        call twice and after a crash.  Raises if a live thread does not
        exit within ``timeout`` -- and keeps the handle, so a later
        :meth:`start` cannot race two executors over the decode state.
        If the executor died on a non-request fault, that crash is
        re-raised here exactly once (``raise_failure=False`` suppresses
        it)."""
        thread = self._thread
        if thread is not None:
            self._stop.set()
            thread.join(timeout=timeout)
            if thread.is_alive():
                raise RuntimeError(
                    f"executor thread did not stop within {timeout}s; "
                    f"handle retained -- a second start() would race two "
                    f"executors over the decode state")
            self._thread = None
        if raise_failure:
            self._raise_failure_once()

    @property
    def load(self) -> int:
        return self.scheduler.load

    def load_snapshot(self) -> LoadSnapshot:
        """Block-aware load triple (free slots, free KV blocks, queued
        prefill tokens) -- the raw request count in :attr:`load` hides
        pool starvation."""
        return self.scheduler.load_snapshot()

    # -- lock-step wave decode (the reference's, kept for A/B comparison) ----

    def serve_wave(self, requests: list[Request]) -> ServeStats:
        """The reference's lock-step path: bucket by prompt length, prefill
        each wave of up to ``slots`` equal-length prompts in one batched
        call (K4), decode until every wave member finishes (K3 on the
        wave's contiguous caches, built in bf16 whatever ``cache_dtype``
        says).  A finished slot idles until the slowest request in its
        wave completes -- kept only as the baseline continuous batching is
        compared against."""
        for r in requests:
            self._check_fits(r)
        stats = ServeStats(requests=len(requests))
        compiles0 = self.prefill_compiles
        t0 = time.monotonic()
        for r in requests:          # wave path bypasses scheduler.submit()
            if r.submitted_at is None:
                r.submitted_at = t0
        buckets: dict[int, list[Request]] = {}
        for r in requests:
            buckets.setdefault(len(r.prompt), []).append(r)
        for _, bucket in sorted(buckets.items()):
            for w0 in range(0, len(bucket), self.slots):
                wave = bucket[w0:w0 + self.slots]
                prompts = np.stack([r.prompt for r in wave])
                self._prefill_shapes.add(prompts.shape)
                last, state = self._prefill(self.params,
                                            self._batch_for(prompts),
                                            "bfloat16")
                last = last.cpu().numpy()
                stats.prefills += 1
                active = np.ones(len(wave), bool)
                n_steps = max(r.max_new_tokens for r in wave)
                for _ in range(n_steps):
                    toks = []
                    for i, r in enumerate(wave):
                        tok = int(r.sampler(last[i]))
                        if active[i]:
                            if r.first_token_at is None:
                                r.first_token_at = time.monotonic()
                            r.output.append(tok)
                            stats.tokens += 1
                            if len(r.output) >= r.max_new_tokens:
                                active[i] = False
                                r.state = RequestState.DONE
                                r.finished_at = time.monotonic()
                        toks.append(tok)
                    if not active.any():
                        break
                    last, state = self._decode(
                        self.params,
                        self._to_device(np.asarray(toks, np.int32)[:, None]),
                        state)
                    last = last.cpu().numpy()
                    stats.decode_steps += 1
                    stats.occupancy_sum += active.sum() / self.slots
        stats.wall_s = time.monotonic() - t0
        stats.prefill_compiles = self.prefill_compiles - compiles0
        stats.fill_request_metrics(requests)
        return stats


# -- moved to repro_torch.serving.router (deprecation shim) -------------------

_MOVED_TO_ROUTER = ("MultiReplicaEngine", "ReplicaTarget")


def __getattr__(name: str):
    """PEP-562 shim, as the reference's: the multi-replica classes live in
    :mod:`repro_torch.serving.router`; importing them from here still works
    but warns."""
    if name in _MOVED_TO_ROUTER:
        import warnings
        warnings.warn(
            f"repro_torch.serving.engine.{name} moved to "
            f"repro_torch.serving.router; update the import -- this shim "
            f"will be removed in a later PR",
            DeprecationWarning, stacklevel=2)
        from repro_torch.serving import router
        return getattr(router, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
