r"""Continuous-batching scheduler: SLO-aware admission + fixed decode slots
(counterpart of ``repro/serving/scheduler.py``).

The paper keeps every NCS stick saturated by split-phase load/collect; the
LM-serving analogue is keeping every *decode slot* saturated.  This module
owns the request lifecycle

    QUEUED -> PREFILL -> DECODE -> DONE
                ^___________|   \___ FAILED   (poison fault, deadline,
                (preemption re-queues         executor crash or retries
                 a decode)                    exhausted)

and, on a prefill-role replica of a disaggregated fleet, PREFILL ->
PREFILLED (the prompt's KV blocks migrate to a decode replica, where the
request re-enters QUEUED)

and the slot bookkeeping: a fixed number of decode slots per replica, an
admission queue feeding them, and thread-safe submit so a replica pull-loop
(or a live traffic source) can admit requests mid-stream.  The moment a
slot's request finishes, the next queued request is admitted into that slot
— no lock-step waves, no length bucketing.  With the engine's chunked
prefill a request may stay in PREFILL across several executor steps
(its prompt prefills one chunk at a time between decode steps); only
:meth:`ContinuousScheduler.decoding` slots join the batched decode.

Admission is a **priority queue**, not FIFO: requests are ordered by
``priority`` (higher serves first), then by TTFT-SLO deadline
(``submitted_at + slo_ttft_s``; requests without an SLO sort last within
their priority), then by arrival.  ``submit`` stamps ``submitted_at`` at
actual submission (unless the caller already set it: a retried or stolen
request keeps its first arrival), so
TTFT always measures queueing + prefill, never pre-construction time.

With a :class:`~repro_torch.serving.kv_pool.KVBlockPool` attached, admission is
*block-aware*: a request enters a slot only when the pool can reserve its
worst-case block count (prompt + decode budget), and release returns its
blocks — so admission is bounded by live KV rows, not by worst-case
``max_len`` per slot.  When the head of the queue outranks an active
decode and the pool cannot satisfy it, the scheduler **preempts**: the
lowest-priority (then most-blocks-remaining) active decode is evicted
recompute-style — its blocks return to the pool, its generated tokens fold
into its prompt (see :attr:`Request.prefill_tokens`), and it re-enters the
queue to be re-prefilled when space frees.  The executor learns about
evictions via :meth:`ContinuousScheduler.drain_preempted` so it can retire
the victim's block table before the freed blocks are reused.

Across replicas, the scheduler is the work-stealing substrate: an idle
peer pulls still-QUEUED requests off the back of this queue via
:meth:`ContinuousScheduler.steal` (heap invariants and ``submitted_at``
preserved), and :meth:`ContinuousScheduler.load_snapshot` exposes the
block-aware load triple the :class:`~repro_torch.serving.router.
ReplicaRouter` places on -- free slots, free KV blocks, queued prefill
tokens -- instead of the raw request count.  :meth:`drain_queue` and
:meth:`expire_deadlines` hand the executor the queued requests a crash or
an elapsed deadline fails.

The scheduler is pure bookkeeping: the :class:`~repro_torch.serving.engine.
ServingEngine` executor owns params, KV state, and the decode step.
"""
from __future__ import annotations

import heapq
import math
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.serving.faults import ExecutorCrash
from repro_torch.serving.kv_pool import KVBlockPool
from repro_torch.serving.sampler import Sampler, greedy


class RequestState(Enum):
    QUEUED = "queued"      # in the admission queue
    PREFILL = "prefill"    # assigned a slot; prompt being prefilled
    PREFILLED = "prefilled"  # prefill done on a prefill-role replica;
    #                          KV blocks migrating to a decode replica
    #                          (terminal *on the source* -- the request
    #                          re-enters QUEUED on the receiver)
    DECODE = "decode"      # occupying a decode slot
    DONE = "done"          # all tokens emitted
    FAILED = "failed"      # terminal: poison fault / deadline / executor
    #                        crash / retries exhausted -- req.error says which


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    sampler: Sampler = field(default_factory=greedy)
    priority: int = 0               # higher serves first; preempts lower
    slo_ttft_s: float | None = None  # TTFT target; orders within a priority
    deadline_s: float | None = None  # hard wall from submit; elapsed -> FAILED
    # filled by the scheduler/engine:
    state: RequestState = RequestState.QUEUED
    output: list = field(default_factory=list)
    submitted_at: float | None = None    # stamped by scheduler.submit()
    first_token_at: float | None = None
    finished_at: float | None = None
    on_finish: Callable[["Request"], None] | None = None
    preempted_count: int = 0        # times evicted from a decode slot
    error: BaseException | None = None   # set iff state is FAILED
    # engine that currently owns the request -- stamped at submit and
    # re-stamped by adopt_blocks when a migration hands it to a decode
    # replica, so failure attribution follows the request, not the
    # dispatch target
    replica: str | None = None
    # paged-KV bookkeeping (engine/scheduler-owned; empty when contiguous).
    # block_ids[:shared_blocks] are prefix-shared (refcounted, read-only);
    # blocks_reserved is the *remaining* unallocated reservation tail.
    block_ids: list = field(default_factory=list)
    blocks_reserved: int = 0
    shared_blocks: int = 0
    # eviction leaves the freed ids here (block_ids is cleared) so the
    # engine can spill the victim's still-intact rows to the host tier
    # before any new prefill overwrites them; the engine consumes and
    # clears it in its drain_preempted handler
    evicted_block_ids: list = field(default_factory=list)
    arrival_seq: int | None = None  # per-scheduler heap tiebreak (private)

    @property
    def kv_rows(self) -> int:
        """Worst-case KV rows written: every position except the final
        sampled token (which is never fed back)."""
        return len(self.prompt) + self.max_new_tokens - 1

    @property
    def prefill_tokens(self) -> np.ndarray:
        """What a (re-)prefill must process: the prompt, plus — after a
        preemption — the tokens already generated, folded in so the request
        resumes recompute-style from where it was evicted."""
        if not self.output:
            return self.prompt
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.output, np.int32)])

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_at is None or self.submitted_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def slo_miss(self) -> bool | None:
        """True/False once the first token is out; None without an SLO."""
        if self.slo_ttft_s is None or self.ttft_s is None:
            return None
        return self.ttft_s > self.slo_ttft_s

    @property
    def tpot_s(self) -> float | None:
        """Time per output token after the first (decode cadence)."""
        if self.finished_at is None or self.first_token_at is None \
                or len(self.output) < 2:
            return None
        return ((self.finished_at - self.first_token_at)
                / (len(self.output) - 1))

    def clone(self) -> "Request":
        """Fresh-output copy (for a retry on another replica): the same
        prompt, budget, sampler, priority, SLO, deadline and arrival."""
        return Request(rid=self.rid, prompt=self.prompt,
                       max_new_tokens=self.max_new_tokens,
                       sampler=self.sampler, priority=self.priority,
                       slo_ttft_s=self.slo_ttft_s,
                       deadline_s=self.deadline_s,
                       submitted_at=self.submitted_at)

    def deadline_elapsed(self, now: float) -> bool:
        """True once the per-request hard deadline has passed (always
        False without one or before submission)."""
        return (self.deadline_s is not None
                and self.submitted_at is not None
                and now - self.submitted_at > self.deadline_s)


class LoadSnapshot(NamedTuple):
    """One replica's load at a glance, for placement across replicas: a
    replica with two queued requests and no free KV blocks is worse off
    than one with four queued and half its pool free, which the raw
    request count hides."""
    free_slots: int
    free_blocks: int | None     # None for contiguous (pool-less) engines
    queued: int                 # requests in the admission queue
    queued_tokens: int          # prompt(+resume) tokens awaiting prefill
    # hot vs restorable: free_blocks is immediately-free device headroom;
    # restorable_blocks counts index-held blocks the pool can demote to
    # the host tier on demand -- admission capacity is their sum, but a
    # replica serving out of restorable headroom pays spill traffic
    restorable_blocks: int | None = None

    @property
    def idle(self) -> bool:
        """Nothing queued and at least one slot open."""
        return self.queued == 0 and self.free_slots > 0


class ContinuousScheduler:
    """Priority admission queue feeding a fixed set of decode slots.

    Thread-safe: `submit` may be called from any thread (a live traffic
    source, a replica pull-loop) while the executor thread runs
    `admit`/`decoding`/`release`.

    ``preemption=False`` disables eviction (the FIFO-era behaviour under
    block pressure: the head of the queue waits for blocks to free).
    ``spec_rows``: the provisional KV rows a speculative verify step may
    write past a slot's committed length, budgeted into every admission.
    """

    def __init__(self, num_slots: int, pool: KVBlockPool | None = None, *,
                 preemption: bool = True, spec_rows: int = 0):
        assert num_slots >= 1
        self.num_slots = num_slots
        self.pool = pool
        self.preemption = preemption
        # speculative decoding: each slot may hold up to ``spec_rows``
        # provisional rows (the pending token + k drafts) past its
        # committed KV, so admission reserves them on top of kv_rows
        self.spec_rows = spec_rows
        self.slots: list[Request | None] = \
            [None] * num_slots               # guarded-by: self._lock
        # heap of (-priority, slo deadline, arrival seq, request); the seq
        # is unique per scheduler so requests themselves are never compared
        self._heap: list[tuple[float, float, int, Request]] = \
            []                               # guarded-by: self._lock
        self._seq = 0                        # guarded-by: self._lock
        self._preempted: list[tuple[int, Request]] = \
            []                               # guarded-by: self._lock
        self._preemptions = 0                # guarded-by: self._lock
        # blocked-head admission cache: (head arrival_seq, capacity
        # version) of the last admit() that found the queue head unfit.
        # While the version is unchanged, re-running the slot scan /
        # reserve / preemption probe is provably the same answer, so
        # admit() returns immediately — the executor no longer re-prices
        # a blocked head every step of a long decode.
        self._blocked_sig: tuple | None = None  # guarded-by: self._lock
        self._event_epoch = 0                # guarded-by: self._lock
        # executor crash capture: once set, submit() raises instead of
        # queueing into a scheduler nothing will ever drain again
        self._poisoned: BaseException | None = None  # guarded-by: self._lock
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)  # alias-of: self._lock

    # -- lifetime counters (monotonic; locked so a router/bench thread can
    # -- read them mid-flight without tearing against the executor) -----------

    @property
    def preemptions(self) -> int:
        with self._lock:
            return self._preemptions

    # -- producer side ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if self.pool is not None:
            self.pool.validate_rows(req.kv_rows + self.spec_rows, req.rid)
        with self._work:
            if self._poisoned is not None:
                raise ExecutorCrash(
                    "executor is dead; submit refused"
                ) from self._poisoned
            if req.submitted_at is None:     # stamp at submission, not at
                req.submitted_at = time.monotonic()  # Request construction
            req.state = RequestState.QUEUED
            self._push(req)
            self._event_epoch += 1           # a new head may outrank
            self._work.notify_all()

    def poison(self, exc: BaseException) -> None:
        """Executor crash capture: refuse every later submit() with
        :class:`ExecutorCrash` chained to the original failure, closing
        the race between a crashing executor and a concurrent producer
        (whose request would otherwise queue forever)."""
        with self._work:
            self._poisoned = exc
            self._work.notify_all()

    # assumes-lock: self._lock
    def _push(self, req: Request) -> None:
        """Queue ``req`` at (priority, SLO deadline, arrival) order.  A
        re-queued preemption victim keeps its original arrival seq, so it
        resumes ahead of later arrivals of the same priority."""
        if req.arrival_seq is None:
            req.arrival_seq = self._seq
            self._seq += 1
        deadline = (req.submitted_at + req.slo_ttft_s
                    if req.slo_ttft_s is not None else math.inf)
        heapq.heappush(self._heap,
                       (-req.priority, deadline, req.arrival_seq, req))

    # -- executor side ---------------------------------------------------------

    # assumes-lock: self._lock
    def _capacity_version(self) -> tuple[int, int]:
        """Changes iff admission capacity may have grown since last read:
        scheduler events (submit / release / drain / expiry /
        notify_capacity) and pool headroom growth (free / unreserve /
        newly demotable).
        Capacity-*shrinking* events (reserve, alloc) are deliberately
        excluded — a cached "head does not fit" stays correct through
        them."""
        return (self._event_epoch,
                self.pool.avail_epoch if self.pool is not None else 0)

    def notify_capacity(self) -> None:
        """Executor hint that admission prospects changed outside the
        scheduler's own bookkeeping — e.g. a PREFILL request turned
        DECODE and is now preemption-eligible.  Invalidates the
        blocked-head cache."""
        with self._lock:
            self._event_epoch += 1

    def admit(self) -> list[tuple[int, Request]]:
        """Fill free slots from the admission queue; the returned
        (slot, request) pairs are in PREFILL state and need their prompt
        prefilled into the batched KV state.

        Block-aware (paged) mode: a request is admitted only when a slot
        is free and the pool can reserve its worst-case block count.
        Queue order is strict — a blocked head-of-queue request is never
        overtaken; it either preempts lower-priority active decodes (see
        :meth:`_preempt_for` — slot pressure and block pressure both
        qualify) or waits for capacity to free.  Preemption needs the
        pool's recompute bookkeeping, so contiguous (pool=None) engines
        always wait for a natural slot release."""
        out: list[tuple[int, Request]] = []
        with self._lock:
            while self._heap:
                req = self._heap[0][3]
                if self._blocked_sig is not None and self._blocked_sig == \
                        (req.arrival_seq, self._capacity_version()):
                    # same head, no capacity-growing event since it last
                    # failed: the full check would fail identically
                    break
                slot = next((i for i, r in enumerate(self.slots)
                             if r is None), None)
                need = (self.pool.blocks_for(req.kv_rows + self.spec_rows)
                        if self.pool is not None else 0)
                # NB: reserve only once a slot exists, so a blocked head
                # never strands a reservation it cannot use yet
                ok = slot is not None and (self.pool is None
                                           or self.pool.reserve(need))
                if not ok:
                    # head blocked on a slot or on blocks: a higher-
                    # priority head may evict lower-priority decodes
                    if not (self.preemption and self.pool is not None
                            and self._preempt_for(req, need)):
                        # wait for capacity to free; cache the verdict
                        # against the current capacity version
                        self._blocked_sig = (req.arrival_seq,
                                             self._capacity_version())
                        break
                    slot = next((i for i, r in enumerate(self.slots)
                                 if r is None), None)
                    if slot is None or not self.pool.reserve(need):
                        self._blocked_sig = (req.arrival_seq,
                                             self._capacity_version())
                        break               # defensive; _preempt_for holds
                if self.pool is not None:
                    req.blocks_reserved = need
                heapq.heappop(self._heap)
                req.state = RequestState.PREFILL
                self.slots[slot] = req
                out.append((slot, req))
                self._blocked_sig = None     # progress: cache is moot
        return out

    # assumes-lock: self._lock
    def _preempt_for(self, req: Request, need: int) -> bool:
        """Evict lower-priority active decodes until ``req`` has a slot
        and ``need`` blocks could be reserved.  Victim order: lowest
        priority first, then most blocks remaining (evicting the
        longest-tail decode frees the most future demand).  Returns False
        — touching nothing — when even evicting every eligible victim
        could not free enough, so a doomed admission never wastes
        completed decode work.  At least one victim is always evicted on
        success (the caller may need the slot, not just the blocks).
        Called under the scheduler lock."""
        victims = sorted(
            ((i, r) for i, r in enumerate(self.slots)
             if r is not None and r.state is RequestState.DECODE
             and r.priority < req.priority),
            key=lambda ir: (ir[1].priority, -ir[1].blocks_reserved,
                            -len(ir[1].block_ids)))
        if not victims:
            return False
        # gain: a victim's block comes back to the preemptor if no other
        # *request* shares it -- either straight to the free list
        # (refcount 1) or as a demotable index-held block (refcount 2
        # with the prefix index's hold; reserve() demotes it on demand).
        # The reservation tail always returns.  Conservative when two
        # victims share a block (counted for neither) — declining is
        # always safe, evicting-for-nothing is not.
        gain = sum(self.pool.reclaimable_count(r.block_ids)
                   + r.blocks_reserved for _, r in victims)
        if self.pool.available_blocks + gain < need:
            return False
        for slot, victim in victims:
            self._evict(slot, victim)
            if self.pool.available_blocks >= need:
                return True
        return self.pool.available_blocks >= need

    # assumes-lock: self._lock
    def _evict(self, slot: int, victim: Request) -> None:
        """Recompute-style preemption of one active decode: free its
        blocks, fold its generated tokens into its prompt (via
        ``prefill_tokens`` at re-admission), and re-queue it.  The executor
        must retire the victim's block table before reusing the freed
        blocks — it learns the slot via :meth:`drain_preempted`."""
        self.slots[slot] = None
        if victim.block_ids:
            # leave the freed ids on the victim so a tiered engine can
            # spill their contents to the host tier before the pool
            # re-scatters them (the engine consumes and clears this list
            # in its drain_preempted handler, which runs before any
            # post-eviction allocation touches the device state)
            victim.evicted_block_ids = list(victim.block_ids)
            self.pool.free(victim.block_ids)
        if victim.blocks_reserved:
            self.pool.unreserve(victim.blocks_reserved)
        victim.block_ids = []
        victim.blocks_reserved = 0
        victim.shared_blocks = 0
        victim.preempted_count += 1
        victim.state = RequestState.QUEUED
        self._preemptions += 1
        self._preempted.append((slot, victim))
        self._push(victim)

    def drain_preempted(self) -> list[tuple[int, Request]]:
        """(slot, victim) pairs evicted since the last call — the executor
        retires each slot's block table before the freed blocks can be
        re-scattered."""
        with self._lock:
            out, self._preempted = self._preempted, []
        return out

    def drain_queue(self) -> list[Request]:
        """Remove and return every still-QUEUED request -- the executor's
        crash path reclaims work a dead replica will never serve.  Active
        slots are *not* touched (their pool state needs the engine's
        retirement path)."""
        with self._lock:
            out = [e[3] for e in self._heap]
            self._heap = []
            self._blocked_sig = None
            self._event_epoch += 1
        return out

    def expire_deadlines(self, now: float) -> list[Request]:
        """Remove and return queued requests whose hard ``deadline_s``
        has already elapsed.  Active slots are checked by the executor
        (which owns their pool state)."""
        with self._lock:
            expired = [e[3] for e in self._heap
                       if e[3].deadline_elapsed(now)]
            if expired:
                dead = set(map(id, expired))
                self._heap = [e for e in self._heap
                              if id(e[3]) not in dead]
                heapq.heapify(self._heap)
                self._blocked_sig = None
                self._event_epoch += 1
        return expired

    def active(self) -> list[tuple[int, Request]]:
        with self._lock:
            return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def decoding(self) -> list[tuple[int, Request]]:
        """Slots whose request is past prefill — the only ones the batched
        decode step samples and advances.  With chunked prefill a request
        can sit in PREFILL across many executor steps while decode steps
        run around it, so slot occupancy and decode participation are not
        the same set."""
        with self._lock:
            return [(i, r) for i, r in enumerate(self.slots)
                    if r is not None and r.state is RequestState.DECODE]

    def release(self, slot: int) -> Request:
        """Free a slot whose request finished (state already DONE); drops
        the request's hold on its KV blocks (shared blocks survive while
        other requests still hold them) and returns the unallocated
        reservation tail to the pool."""
        with self._lock:
            req = self.slots[slot]
            assert req is not None, f"release of empty slot {slot}"
            self.slots[slot] = None
            self._event_epoch += 1  # a slot opened: blocked head may now fit
        if self.pool is not None:
            if req.block_ids:
                # generation-safe: every release caller immediately
                # _retire_slot()s the slot (trash-table redirect) before
                # the next scatter, and the engine's prefix index checks
                # block_live() before seeding from any (id, gen) entry
                self.pool.free(req.block_ids)
            if req.blocks_reserved:
                self.pool.unreserve(req.blocks_reserved)
            req.block_ids = []
            req.blocks_reserved = 0
            req.shared_blocks = 0
        return req

    # -- cross-replica work stealing -------------------------------------------

    def steal(self, max_items: int = 1, *,
              can_take: Callable[[Request], bool] | None = None
              ) -> list[Request]:
        """Remove up to ``max_items`` still-QUEUED requests so an idle peer
        scheduler can take them over (cross-replica work stealing).

        Victims come from the *back* of the queue -- the lowest-ranked
        entries by (priority, SLO deadline, arrival), i.e. the requests
        this replica would serve last -- so the local heap's service order
        for everything that stays is untouched.  While other entries are
        queued, the head (the request this replica serves next, typically
        with its prefix blocks already resident) is never stolen -- a
        ``can_take``-filtered scan cannot walk forward into it past
        rejected candidates.  A *sole* queued request is fair game: the
        donor has no capacity for it now (else it would be admitted), so
        moving it to an idle peer strictly helps its TTFT.  The surviving
        heap is re-heapified, preserving its invariants.

        Stolen requests keep their ``submitted_at`` stamp (TTFT spans the
        move: re-submission on the thief preserves a pre-stamped arrival)
        plus priority and SLO; only the per-scheduler ``arrival_seq`` is
        cleared, so the thief's heap assigns its own tiebreak and never
        compares seqs minted by two schedulers.

        ``can_take`` filters candidates by the *thief's* admission
        capacity (its ``max_len``, block size, and free blocks -- this
        scheduler's own pool geometry says nothing about the thief's): a
        request the thief could not admit must stay here, or it would
        ping-pong between queues instead of ever decoding.
        """
        stolen: list[Request] = []
        with self._lock:
            take: set[int] = set()
            # back of the queue first: largest heap key = served last; the
            # final (smallest-key) index is the head -- sliced off (when it
            # has company) so a filtered scan can never walk forward into it
            order = sorted(range(len(self._heap)),
                           key=lambda i: self._heap[i][:3], reverse=True)
            if len(order) > 1:
                order = order[:-1]
            for i in order:
                if len(stolen) >= max_items:
                    break
                req = self._heap[i][3]
                if can_take is not None and not can_take(req):
                    continue
                take.add(i)
                stolen.append(req)
            if take:
                self._heap = [e for i, e in enumerate(self._heap)
                              if i not in take]
                heapq.heapify(self._heap)
                for req in stolen:
                    req.arrival_seq = None
                self._event_epoch += 1  # queue shrank: head identity/rank moved
        return stolen

    # -- introspection ---------------------------------------------------------

    def load_snapshot(self) -> LoadSnapshot:
        """Block-aware load for cross-replica placement (racy by design:
        the executor keeps running; the router treats it as a hint)."""
        with self._lock:
            free_slots = sum(r is None for r in self.slots)
            queued = len(self._heap)
            queued_tokens = sum(len(e[3].prompt) + len(e[3].output)
                                for e in self._heap)
        free_blocks = (self.pool.free_blocks if self.pool is not None
                       else None)
        restorable = (self.pool.demotable_count if self.pool is not None
                      else None)
        return LoadSnapshot(free_slots=free_slots, free_blocks=free_blocks,
                            queued=queued, queued_tokens=queued_tokens,
                            restorable_blocks=restorable)

    @property
    def queued(self) -> int:
        with self._lock:
            return len(self._heap)

    @property
    def occupied(self) -> int:
        with self._lock:
            return sum(r is not None for r in self.slots)

    @property
    def load(self) -> int:
        """Queue depth analogue for least-loaded dispatch across replicas."""
        with self._lock:
            return len(self._heap) + sum(r is not None for r in self.slots)

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._heap) or any(r is not None for r in self.slots)

    def wait_for_work(self, timeout: float | None = None) -> bool:
        with self._work:
            if self.has_work():
                return True
            self._work.wait(timeout)
            return self.has_work()
