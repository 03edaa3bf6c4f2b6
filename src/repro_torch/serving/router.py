"""Replica router: prefix-affinity dispatch, block-aware load, work stealing,
disaggregated prefill/decode with KV migration (counterpart of
``repro/serving/router.py``).

Each replica is one :class:`~repro_torch.serving.engine.ServingEngine` in
service mode, driven through :mod:`repro_torch.core.offload`'s split-phase
protocol (non-blocking submit, out-of-order drain, deadline straggler
reissue); the router owns only the *policy* deciding which replica gets a
request:

  * **prefix-affinity dispatch** -- a fleet-level index of full-leading-
    block prompt digests (the engines' own chained digests,
    :func:`~repro_torch.serving.engine.prefix_digests`) maps digest ->
    replica, and a request routes to the replica already holding its
    longest prompt prefix, so cache-seeded prefill fires fleet-wide.
  * **block-aware load** -- a replica's load is its
    :class:`~repro_torch.serving.scheduler.LoadSnapshot` (free decode
    slots, free KV blocks, queued prefill tokens) rather than its raw
    request count, so a blocks-starved replica stops winning placement.
  * **work stealing** -- a replica that goes idle pulls still-QUEUED
    requests off the back of the most backlogged peer's priority heap
    (:meth:`~repro_torch.serving.scheduler.ContinuousScheduler.steal`);
    the offload layer's ``WorkItem.complete`` first-wins commit keeps a
    steal racing a deadline reissue safe.
  * **disaggregated prefill/decode** -- replicas built with
    ``role="prefill"`` run chunked prefill at full budget; at a prompt's
    last chunk its KV blocks *migrate* to the best-placed decode-capable
    replica as a ``("migrate", rid, keys, tables, leaves, gens)`` payload
    on a split-phase channel of its own (one
    :class:`~repro_torch.core.offload.KVBlockTarget` per decode-capable
    replica), and the receiver adopts them via
    :meth:`ServingEngine.adopt_blocks`, entering DECODE without recomputing
    a prompt token.  A failed migration (the ``kv.migrate`` fault site)
    releases the source's export pins and retries from the bare prompt.

The router is also the fleet's fault boundary: it tracks per-replica health
(HEALTHY -> DEGRADED -> DEAD), quarantines dead replicas out of placement,
affinity and stealing, and reissues their queued and in-flight requests to
survivors with bounded retries, so exhausted retries end in a typed FAILED
terminal, never a hang.

The replicas may share one card: their executors then enqueue on its
current stream, one after the other, which is what orders a migration's
clone (source executor), its device-to-host copy (migration worker) and
its landing (adopting executor).

``MultiReplicaEngine`` (request-count least-loaded dispatch) is the
routing A/B baseline: a :class:`ReplicaRouter` with every mechanism off.
"""
from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass
from itertools import islice
from typing import Callable

from repro_torch.core.offload import (KVBlockTarget, OffloadEngine, Target,
                                      WorkError, WorkItem)
from repro_torch.serving.engine import (ServeStats, ServingEngine,
                                        prefix_digests)
from repro_torch.serving.faults import (DeadlineExceeded, ExecutorCrash,
                                        FaultError, ShedError)
from repro_torch.serving.scheduler import LoadSnapshot, Request, RequestState


class ReplicaHealth(enum.Enum):
    """One replica's standing in the fleet.  DEGRADED (a request-level
    fault was observed) still serves traffic; DEAD (its executor crashed)
    is quarantined out of placement, affinity, and stealing."""
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DEAD = "dead"


class ReplicaTarget(Target):
    """Adapter: one continuous-batching replica as an offload Target.

    ``load_tensor`` admits a request clone into the replica's scheduler and
    returns immediately; the replica's executor thread plays the role of
    the per-device worker, and ``WorkItem.complete`` fires when the
    request's last token is emitted.  ``queue_depth`` exposes scheduler
    load (queued + occupied slots) for the offload layer's generic
    least-loaded paths; routed placement scores on the richer
    :meth:`ServingEngine.load_snapshot`.
    """

    # set by the router: (item, failed_request, replica_name) -> bool.
    # True = the request was reissued on a survivor; leave the item open
    # for that clone's first-wins commit.
    fail_handler: Callable[[WorkItem, Request, str], bool] | None = None

    def __init__(self, engine: ServingEngine, name: str,
                 tdp_watts: float = 1.0):
        self.engine = engine
        self.name = name
        self.tdp_watts = tdp_watts

    def open(self) -> None:
        self.busy = False
        self.engine.start()

    def close(self) -> None:
        # any captured executor crash was already routed through the retry
        # path; re-raising it here would abort teardown of the remaining
        # healthy replicas
        self.engine.stop(raise_failure=False)

    def dispatch(self, item: WorkItem, req: Request) -> None:
        """Admit ``req`` on this replica, wiring completion back to
        ``item``.  A FAILED terminal is offered to the router's
        ``fail_handler`` first; only an unhandled failure commits, so the
        item always resolves -- retried elsewhere or typed-FAILED.  Raises
        when this replica refuses admission (dead, shedding, capacity)."""
        def done(r: Request, item: WorkItem = item) -> None:
            # a disaggregated request finishes (or fails) on whichever
            # replica *adopted* it; r.replica follows the request, so
            # failures are charged to the engine that terminated it
            if (r.state is RequestState.FAILED
                    and self.fail_handler is not None
                    and self.fail_handler(item, r,
                                          r.replica or self.name)):
                return
            item.complete(r, self.name)
        self.engine.submit(req, on_finish=done)

    def load_tensor(self, item: WorkItem) -> WorkItem:
        req = item.payload.clone()      # reissue-safe: first clone wins
        try:
            self.dispatch(item, req)
        except Exception as e:  # noqa: BLE001 -- dead or shedding replica:
            # fail the clone and route it exactly like an in-flight
            # failure (retry on a survivor, else typed FAILED terminal)
            req.state = RequestState.FAILED
            req.error = e
            if not (self.fail_handler is not None
                    and self.fail_handler(item, req, self.name)):
                item.complete(req, self.name)
        return item

    @property
    def queue_depth(self) -> int:
        return self.engine.load


@dataclass
class RouterStats:
    """Lifetime placement counters (monotonic, like ``ServeStats`` totals);
    :meth:`ReplicaRouter.serve` windows them into the returned stats."""
    affinity_hits: int = 0      # requests routed onto a resident prefix
    affinity_blocks: int = 0    # full prefix blocks those hits landed on
    affinity_fallbacks: int = 0  # hits declined (owner overloaded)
    steals: int = 0             # requests moved to an idle replica
    retries: int = 0            # failed requests reissued to a survivor
    replica_failures: int = 0   # replicas quarantined DEAD (crashed)
    rebalance_errors: int = 0   # rebalance ticks that raised (and were
    #                             contained; serve() re-surfaces the last)
    migrations: int = 0         # disagg: prefills adopted by a decode peer
    migration_failures: int = 0  # disagg: migrations dropped/refused (the
    #                              request re-enters the retry path)


@dataclass
class _Migration:
    """One in-flight prefill->decode KV migration.  The offload payload
    stays the self-describing 6-tuple (``("migrate", rid, keys, tables,
    leaves, gens)``); what it must *not* carry across the core layer -- the
    live request, its token stream, the final-chunk logits, and the source
    pool whose export holds pin the blocks -- rides here, keyed by the
    identity of the payload's ``tables`` list (unique per migration and
    kept alive by this record, so the key cannot be reused mid-flight)."""
    req: Request
    tokens: object              # np.ndarray prompt stream for the receiver
    last: object                # np.ndarray final-chunk logits (V,)
    src: ServingEngine          # holds the export pins until completion
    export_ids: list            # pinned source block ids, table order
    tables: list                # the payload's tables list (the dict key)
    dest: int                   # replica index chosen at handoff


class _MigrationAdapter:
    """Duck-typed 'tier' a :class:`~repro_torch.core.offload.KVBlockTarget`
    drives for the migrate payload: ``adopt`` lands one migrated prefill on
    its decode replica via :meth:`ServingEngine.adopt_blocks`.  Before
    admitting, it checks the generations the export holds promise --
    ``block_live`` going False for an exported block would mean the id was
    freed and re-allocated mid-flight, which the hold exists to prevent, so
    a failure here is a broken invariant, not a race to tolerate."""

    name = "migration"

    def __init__(self, router: "ReplicaRouter", engine: ServingEngine):
        self.router = router
        self.engine = engine

    def adopt(self, rid, keys, tables, blocks, gens):
        with self.router._mig_lock:
            rec = self.router._mig_records.get(id(tables))
        if rec is None:          # record reaped by a concurrent completion
            return None          # (first-wins: this copy lost)
        for bid, gen in zip(rec.export_ids, gens):
            if not rec.src.pool.block_live(bid, gen):
                raise RuntimeError(
                    f"migration of request {rid}: exported block {bid} no "
                    f"longer holds generation {gen} -- export pin broken")
        return self.engine.adopt_blocks(rec.req, keys, rec.tokens, blocks,
                                        rec.last)


class ReplicaRouter:
    """Places individual requests across continuous-batching replicas.

    Placement policy = affinity, then block-aware score:

    1. With ``affinity`` on, look the prompt's chained block digests up in
       the fleet prefix index, deepest first; the replica owning the
       longest match wins -- unless its queue has reached
       ``affinity_queue_cap`` (default 4 x its slots: a cache hit is not
       worth unbounded head-of-line wait; fall through to the load score).
    2. Otherwise pick the replica with, in order: immediate capacity (a
       free slot *and* enough free blocks for this request), the fewest
       queued prefill tokens, the most free KV blocks.  With
       ``block_aware=False`` this degrades to the raw request count.

    With ``steal`` on, a background rebalance thread runs while
    :meth:`serve` is in flight: each tick, every idle replica steals the
    lowest-ranked queued request it has block headroom for from the most
    backlogged peer.  Dispatch, drain, and straggler reissue ride
    :mod:`repro_torch.core.offload` unchanged via its placement hook.
    """

    def __init__(self, replicas: list[ServingEngine], *,
                 affinity: bool = True, steal: bool = True,
                 block_aware: bool = True,
                 affinity_queue_cap: int | None = None,
                 steal_interval_s: float = 0.005,
                 deadline_s: float | None = None,
                 max_retries: int = 2,
                 prefix_index_cap: int = 65536):
        assert replicas, "router needs at least one replica"
        self.replicas = replicas
        self.max_retries = max_retries
        self.targets = [ReplicaTarget(e, name=f"replica{i}")
                        for i, e in enumerate(replicas)]
        self._target_index = {t.name: i for i, t in enumerate(self.targets)}
        for t in self.targets:
            t.fail_handler = self._on_request_failed
        # affinity needs every replica on one digest scheme: paged KV and a
        # common block size (else "same prefix" means different blocks)
        paged = all(e.pool is not None for e in replicas)
        sizes = {e.block_size for e in replicas}
        if affinity and paged and len(sizes) > 1:
            raise ValueError(
                f"prefix-affinity routing needs one block size fleet-wide, "
                f"got {sorted(sizes)}; disable affinity or align the pools")
        self.affinity = affinity and paged
        self.block_size = sizes.pop() if len(sizes) == 1 else None
        self.steal = steal
        self.block_aware = block_aware
        self.affinity_queue_cap = affinity_queue_cap
        self.steal_interval_s = steal_interval_s
        self.deadline_s = deadline_s
        # placement counters are bumped on the dispatch thread (_select)
        # *and* the rebalance thread (_rebalance_once) and windowed by
        # serve() -- unlocked `+=` across those threads drops increments
        self._stats_lock = threading.Lock()
        self.stats = RouterStats()           # guarded-by: self._stats_lock
        self._health = [ReplicaHealth.HEALTHY  # guarded-by: self._stats_lock
                        for _ in replicas]
        self._rebalance_exc: BaseException | None = None  # guarded-by: self._stats_lock
        # fleet prefix index: digest of blocks 0..j -> replica that last
        # computed (or was routed) that prefix.  A *hint*, not truth: a
        # replica may have evicted the blocks (its own index validates
        # against the pool at admission); staleness only costs recompute.
        # Confined to the dispatch thread (serve -> offload submit ->
        # _place -> _select/_register); the rebalance thread never reads it.
        self._prefix_owner: dict[bytes, int] = {}  # owned-by: dispatch-thread
        self._prefix_cap = prefix_index_cap
        self._steal_stop = threading.Event()
        self._steal_thread: threading.Thread | None = None
        # engine names (stamped on requests for failure attribution) may
        # differ from target names; resolve both in the failure path
        self._engine_index = {
            name: i for i, e in enumerate(replicas)
            if (name := getattr(e, "name", None))}
        # disaggregated fleet: prefill-role replicas hand finished prompts
        # to the migration channel; decode-capable replicas (role decode or
        # mixed) adopt them.  Roles are placement policy -- any replica can
        # still run either phase if asked.
        roles = [getattr(e, "role", "mixed") for e in replicas]
        self._prefill_set = frozenset(
            i for i, r in enumerate(roles) if r == "prefill")
        self._prefill_capable = frozenset(
            i for i, r in enumerate(roles) if r != "decode")
        self._decode_capable = [i for i, r in enumerate(roles)
                                if r != "prefill"]
        self.disaggregated = bool(self._prefill_set)
        self._mig_io = None
        if self.disaggregated:
            if not self._decode_capable:
                raise ValueError(
                    "a disaggregated fleet needs at least one decode-"
                    "capable (role='decode' or 'mixed') replica to adopt "
                    "migrated prefills")
            if not paged:
                raise ValueError("disaggregated serving needs paged KV on "
                                 "every replica (migration moves pool "
                                 "blocks)")
            if self.block_size is None:
                raise ValueError("KV migration needs one block size "
                                 "fleet-wide (blocks land id-for-id in the "
                                 "receiver's pool)")
            dtypes = {e.cache_dtype for e in replicas}
            if len(dtypes) > 1:
                raise ValueError(
                    f"KV migration needs one cache dtype fleet-wide -- "
                    f"adopt casts rows on write, which would silently "
                    f"corrupt quantized scales across {sorted(dtypes)}")
            self._mig_lock = threading.Lock()
            self._mig_records: dict[int, _Migration] = {}  # guarded-by: self._mig_lock
            self._mig_pending = 0                          # guarded-by: self._mig_lock
            # one migrate target per decode-capable replica;
            # _place_migration routes each payload to the destination its
            # record chose
            self._mig_target_index: dict[int, int] = {}
            mig_targets = []
            for k in self._decode_capable:
                e = self.replicas[k]
                tgt = KVBlockTarget(_MigrationAdapter(self, e),
                                    name=f"migrate-{k}")
                if e.fault_plan is not None:
                    # the kv.migrate probe fires on the migration worker,
                    # charged to the *destination* engine's plan filters
                    tgt.fault_hook = (
                        lambda item, e=e:
                        e._fault("kv.migrate",
                                 rid=item.payload[1]) == "drop")
                self._mig_target_index[k] = len(mig_targets)
                mig_targets.append(tgt)
            self._mig_io = OffloadEngine(mig_targets,
                                         scheduler=self._place_migration)
            self._mig_io.__enter__()       # daemon workers; router-lifetime
            for i in self._prefill_set:
                self.replicas[i]._on_prefilled = (
                    lambda req, keys, ids, gens, leaves, tokens, last,
                    i=i: self._migrate(i, req, keys, ids, gens, leaves,
                                       tokens, last))

    # -- replica health + failure routing --------------------------------------

    def health(self) -> list[ReplicaHealth]:
        with self._stats_lock:
            return list(self._health)

    def _healthy(self) -> list[int]:
        """Replica indices still eligible for traffic (not DEAD)."""
        with self._stats_lock:
            return [i for i, h in enumerate(self._health)
                    if h is not ReplicaHealth.DEAD]

    def _mark_degraded(self, i: int) -> None:
        with self._stats_lock:
            if self._health[i] is ReplicaHealth.HEALTHY:
                self._health[i] = ReplicaHealth.DEGRADED

    def _mark_dead(self, i: int) -> None:
        with self._stats_lock:
            if self._health[i] is ReplicaHealth.DEAD:
                return
            self._health[i] = ReplicaHealth.DEAD
            self.stats.replica_failures += 1

    def _heartbeat(self) -> None:
        """Quarantine any replica whose executor has died.  Runs on the
        rebalance thread each tick; the failure-routing path below also
        detects death inline, so a steal-free router is covered too."""
        for i, e in enumerate(self.replicas):
            if e.failure is not None:
                self._mark_dead(i)

    def _on_request_failed(self, item: WorkItem, failed: Request,
                           name: str) -> bool:
        """Failure routing -- runs on whichever replica thread terminated
        the request (executor poison isolation, crash capture, or a refused
        submit).  Updates that replica's health, then reissues a fresh
        clone on the least-loaded healthy survivor, preferring a
        *different* replica when one exists.  Bounded by ``max_retries``
        per work item; the caller commits the FAILED request as the item's
        terminal result on False, so a request can be retried or failed
        but never stranded."""
        i = self._target_index.get(name)
        if i is None:            # disagg attribution stamps engine names
            i = self._engine_index.get(name)
        if i is not None:
            if (isinstance(failed.error, ExecutorCrash)
                    or self.replicas[i].failure is not None):
                self._mark_dead(i)
            else:
                self._mark_degraded(i)
        if isinstance(failed.error, (DeadlineExceeded, ShedError)):
            # the deadline is already blown on any survivor too, and a shed
            # is the fleet's own back-pressure -- retrying either would
            # just convert typed rejection into queue pressure
            return False
        tries = getattr(item, "retries", 0)
        if tries >= self.max_retries:
            return False
        item.retries = tries + 1
        # fresh clone from the bare prompt: greedy regeneration on the
        # survivor equals an uninterrupted run
        retry = failed.clone()
        order = sorted(self._healthy(),
                       key=lambda j: self.replicas[j].load)
        if self.disaggregated:
            # restart from the bare prompt on a prefill-capable replica when
            # one survives (stable sort: load order kept within each class);
            # a decode-role survivor still works -- roles are policy
            order.sort(key=lambda j: j not in self._prefill_capable)
        for j in order:
            if j == i and len(order) > 1:
                continue
            try:
                self.targets[j].dispatch(item, retry)
            except Exception:  # fault-ok: the candidate refused admission (it may just have died); try the next survivor
                continue
            with self._stats_lock:
                self.stats.retries += 1
            return True
        return False

    # -- placement -------------------------------------------------------------

    def _owner_cap(self, owner: int) -> int:
        if self.affinity_queue_cap is not None:
            return self.affinity_queue_cap
        return 4 * self.replicas[owner].slots

    def _select(self, req: Request) -> int:
        """Replica index for ``req`` (affinity first, then load score).
        The affinity fast path snapshots only the owner; the full fleet is
        snapshotted lazily, on fallback to the load score."""
        healthy = set(self._healthy())
        if self.disaggregated and healthy & self._prefill_capable:
            # fresh prompts go to prefill-capable replicas; decode-role
            # replicas receive work only by migration (or, below, as the
            # last survivors of a fleet-wide failure)
            healthy &= self._prefill_capable
        digests = (prefix_digests(req.prefill_tokens, self.block_size)
                   if self.affinity else [])
        if digests:
            for j in range(len(digests) - 1, -1, -1):   # deepest match wins
                owner = self._prefix_owner.get(digests[j])
                if owner is None or owner not in healthy:
                    continue     # dead owners lost their cache anyway
                snap = self.replicas[owner].load_snapshot()
                # queue depth alone trips the cap: a blocks-starved owner
                # can back up a deep queue while a decode slot sits free
                if snap.queued >= self._owner_cap(owner):
                    with self._stats_lock:
                        self.stats.affinity_fallbacks += 1
                    break               # owner saturated: place by load
                with self._stats_lock:
                    self.stats.affinity_hits += 1
                    self.stats.affinity_blocks += j + 1
                self._register(digests, owner)
                return owner
        # quarantine: only healthy replicas compete for placement.  With
        # the whole fleet dead, any target refuses the submit and the
        # failure routing turns the request into a typed FAILED terminal
        pool = sorted(healthy) or list(range(len(self.replicas)))
        snaps = {i: self.replicas[i].load_snapshot() for i in pool}
        choice = min(pool, key=lambda i: self._score(i, snaps[i], req))
        if digests:
            self._register(digests, choice)
        return choice

    def _score(self, i: int, snap: LoadSnapshot, req: Request):
        """Placement cost (lower wins).  Block-aware: replicas that can
        admit *right now* beat ones that cannot; ties break on queued
        prefill tokens, then free blocks, then index (determinism)."""
        if not self.block_aware:         # raw request count
            e = self.replicas[i]
            return (snap.queued + (e.slots - snap.free_slots), 0, 0, i)
        e = self.replicas[i]
        need = (e.pool.blocks_for(req.kv_rows + e.spec_rows)
                if e.pool is not None else 0)
        # restorable blocks (idle index-held, spill-then-free on demand)
        # are admission headroom just like strictly free ones
        avail = ((snap.free_blocks + (snap.restorable_blocks or 0))
                 if snap.free_blocks is not None else None)
        fits_now = (snap.free_slots > 0
                    and (avail is None or avail >= need))
        return (0 if fits_now else 1, snap.queued_tokens,
                -(avail or 0), i)

    def _register(self, digests: list[bytes], owner: int) -> None:
        """Point every full-leading-block digest of a routed prompt at its
        replica.  Re-insertion refreshes recency (dict order is insertion
        order), so the cap drops the coldest prefixes first."""
        for d in digests:
            if d in self._prefix_owner:
                del self._prefix_owner[d]
            self._prefix_owner[d] = owner
        over = len(self._prefix_owner) - self._prefix_cap
        if over > 0:
            for d in list(islice(iter(self._prefix_owner), over)):
                del self._prefix_owner[d]

    # -- dispatch --------------------------------------------------------------

    def _place(self, targets: list[Target], payload: Request) -> Target:
        return targets[self._select(payload)]

    # -- KV migration (disaggregated prefill -> decode handoff) ----------------

    def _select_decode(self, req: Request) -> int:
        """Decode-side admission control: the healthy decode-capable
        replica best placed to adopt ``req`` -- the fresh placement's score,
        restricted to the adopting half of the fleet.  Raises when nobody
        can adopt (the caller fails the request into the retry path)."""
        healthy = set(self._healthy())
        pool = [i for i in self._decode_capable if i in healthy]
        if not pool:
            raise RuntimeError(
                f"request {req.rid}: no healthy decode-capable replica "
                f"left to adopt the migrated KV blocks")
        snaps = {i: self.replicas[i].load_snapshot() for i in pool}
        return min(pool, key=lambda i: self._score(i, snaps[i], req))

    def _migrate(self, src_i: int, req: Request, keys: list, ids: list,
                 gens: list, leaves: list, tokens, last) -> None:
        """Prefill-completion hook (runs on the *source* replica's executor
        thread): pick the adopting replica, record the in-flight
        migration, and submit the self-describing payload to the migration
        channel.  The source's export holds on ``ids`` stay live until
        :meth:`_mig_done` releases them, whatever happens to the
        transfer."""
        src = self.replicas[src_i]
        try:
            dest = self._select_decode(req)
        except Exception as e:  # noqa: BLE001 -- nobody can adopt: release
            # the exports and fail the request into the retry path (a
            # mixed survivor may still serve it end to end)
            # generation-safe: this free only drops the +1 export pin taken
            # by export_blocks moments ago on this same thread
            src.pool.free(ids)
            with self._stats_lock:
                self.stats.migration_failures += 1
            req.error = e
            req.state = RequestState.FAILED
            req.finished_at = time.monotonic()
            if req.on_finish is not None:
                req.on_finish(req)
            return
        tables = list(ids)
        rec = _Migration(req=req, tokens=tokens, last=last, src=src,
                         export_ids=ids, tables=tables, dest=dest)
        with self._mig_lock:
            self._mig_records[id(tables)] = rec
            self._mig_pending += 1
        self._mig_io.submit(("migrate", req.rid, keys, tables, leaves,
                             gens), on_done=self._mig_done)

    def _place_migration(self, targets: list[Target], payload) -> Target:
        with self._mig_lock:
            rec = self._mig_records[id(payload[3])]
        return targets[self._mig_target_index[rec.dest]]

    def _mig_done(self, item: WorkItem) -> None:
        """Migration completion (runs on the migration worker): release the
        source export pins, then either count the success or fail the
        request into the bounded bare-prompt retry path.  Every outcome --
        adopted, dropped by a kv.migrate fault, refused by a dead or full
        receiver -- flows through here exactly once, so the export pins
        can never leak and the request can never strand."""
        with self._mig_lock:
            rec = self._mig_records.pop(id(item.payload[3]), None)
            self._mig_pending -= 1
        if rec is None:
            return
        # success or failure, the source's part is over: the receiver owns
        # host copies (or nothing arrived).  Cross-thread free is safe --
        # free() never invokes on_demote.
        # generation-safe: this free drops only the +1 export pin from
        # export_blocks; the worker copied the rows to the host before
        # complete() fired, so nothing still reads these blocks
        rec.src.pool.free(rec.export_ids)
        result = item.result
        if result is not None and not isinstance(result, WorkError):
            with self._stats_lock:
                self.stats.migrations += 1
            return
        with self._stats_lock:
            self.stats.migration_failures += 1
        req = rec.req
        if isinstance(result, WorkError):
            # adopt_blocks raised (dead/full receiver); req.replica was
            # stamped with the receiver's name, so the failure is charged
            # where it happened
            err = result.error
        else:
            # an injected kv.migrate drop: the payload vanished in flight
            err = FaultError("kv.migrate",
                             f"migration of request {req.rid} dropped "
                             f"in flight")
        req.error = err
        req.state = RequestState.FAILED
        req.finished_at = time.monotonic()
        if req.on_finish is not None:
            req.on_finish(req)     # -> _on_request_failed -> retry clone

    def drain_migrations(self, timeout: float = 5.0) -> None:
        """Wait until no migration is in flight.  Export pins release in
        the completion hook, which can lag the *request's* completion by a
        worker beat -- leak sweeps (and teardown) must not race it."""
        if self._mig_io is None:
            return
        deadline = time.monotonic() + timeout
        while True:
            with self._mig_lock:
                n = self._mig_pending
            if n == 0:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{n} migration(s) still in flight after {timeout}s")
            time.sleep(0.0005)

    # -- work stealing ---------------------------------------------------------

    @staticmethod
    def _thief_can_take(thief: ServingEngine, snap: LoadSnapshot):
        """Admission filter in the *thief's* geometry (its max_len, block
        size, and free blocks): only steal what the thief could admit right
        now, or the request ping-pongs between queues instead of ever
        decoding."""
        def ok(req: Request) -> bool:
            if req.kv_rows > thief.max_len:      # per-slot KV capacity
                return False
            if thief.pool is not None:
                # the thief's own speculative overhang rides on top of the
                # request's worst case, exactly as its admission will charge
                need = thief.pool.blocks_for(req.kv_rows
                                             + thief.spec_rows)
                avail = snap.free_blocks + (snap.restorable_blocks or 0)
                if need > min(avail, thief.pool.capacity):
                    return False
            return True
        return ok

    def _rebalance_once(self) -> int:
        """One stealing pass: every idle replica takes the lowest-ranked
        queued request it could admit right now from the most backlogged
        peer (by queued prefill tokens).  Returns requests moved."""
        moved = 0
        healthy = self._healthy()
        snaps = {i: self.replicas[i].load_snapshot() for i in healthy}
        for i in healthy:
            snap = snaps[i]
            if not snap.idle:
                continue
            if self.disaggregated and self.replicas[i].role == "decode":
                # queued work is fresh prompts, and a decode-role replica
                # stealing one would prefill it locally -- the recompute
                # disaggregation exists to avoid
                continue
            donors = sorted(
                (j for j in healthy if j != i and snaps[j].queued > 0
                 and not (self.disaggregated
                          and self.replicas[j].role == "decode")),
                # a decode-role replica's queue holds *adopted* requests
                # whose KV blocks already landed in its pool -- stealing one
                # would strand the staged payload and re-prefill a prompt
                # that is already computed
                key=lambda j: (snaps[j].queued_tokens, snaps[j].queued),
                reverse=True)
            thief = self.replicas[i]
            for j in donors:
                got = self.replicas[j].scheduler.steal(
                    max_items=1,
                    can_take=self._thief_can_take(thief, snap))
                took = 0
                for req in got:
                    try:
                        # on_finish (WorkItem.complete) and submitted_at
                        # ride along: TTFT spans the move, and a steal
                        # racing a reissue resolves first-wins
                        thief.submit(req)
                        took += 1
                    except Exception:  # noqa: BLE001 -- thief refused
                        # (it died between snapshot and submit).  The
                        # stolen request must not vanish: hand it back to
                        # its donor, else fail it into the retry path
                        try:
                            self.replicas[j].submit(req)
                        except Exception as e2:  # noqa: BLE001 -- donor
                            # also gone mid-steal
                            req.state = RequestState.FAILED
                            req.error = e2
                            if req.on_finish is not None:
                                req.on_finish(req)
                moved += took
                if took:                # thief's free slot is now spoken for
                    break
        with self._stats_lock:
            self.stats.steals += moved
        return moved

    def _steal_loop(self) -> None:
        while not self._steal_stop.wait(self.steal_interval_s):
            try:
                self._heartbeat()
                self._rebalance_once()
            except Exception as e:  # noqa: BLE001 -- one bad tick must not
                # silently kill rebalancing for the rest of the serve;
                # count it and stash the exception for serve() to
                # re-surface after results are copied back
                with self._stats_lock:
                    self.stats.rebalance_errors += 1
                    self._rebalance_exc = e

    def _start_stealing(self) -> None:
        if not self.steal or self._steal_thread is not None:
            return
        self._steal_stop.clear()
        self._steal_thread = threading.Thread(target=self._steal_loop,
                                              name="router-rebalance",
                                              daemon=True)
        self._steal_thread.start()

    def _stop_stealing(self) -> None:
        if self._steal_thread is None:     # idempotent: double stop is a
            return                         # no-op, never an error
        self._steal_stop.set()
        self._steal_thread.join(timeout=10.0)
        if self._steal_thread.is_alive():
            raise RuntimeError("rebalance thread did not stop within 10s")
        self._steal_thread = None

    def stop(self) -> None:
        """Idempotent fleet teardown for service-mode use outside
        :meth:`serve` (which tears down its own context): stop the
        rebalance thread and every replica executor.  Captured executor
        crashes are suppressed (``raise_failure=False`` -- they were
        already routed through retry); every replica is offered a stop
        before the first teardown error re-surfaces."""
        errors: list[BaseException] = []
        try:
            self._stop_stealing()
        except Exception as e:  # noqa: BLE001 -- aggregated below; the
            # replicas must still be stopped
            errors.append(e)
        try:
            # settle in-flight migrations while their receivers still run
            # (an adopt against a stopped executor would strand a request)
            self.drain_migrations()
        except Exception as e:  # noqa: BLE001 -- aggregated below
            errors.append(e)
        for replica in self.replicas:
            try:
                replica.stop(raise_failure=False)
            except Exception as e:  # noqa: BLE001 -- aggregated below
                errors.append(e)
        if errors:
            raise errors[0]

    def close(self) -> None:
        """:meth:`stop`, then shut the migration channel's workers down.
        They otherwise live as long as the process and keep the replicas --
        their pools and weights -- reachable through the adapters.
        Idempotent; the router must not serve afterwards."""
        self.stop()
        if self._mig_io is not None and self._mig_io._open:
            self._mig_io.__exit__(None, None, None)

    # -- serving ---------------------------------------------------------------

    def serve(self, requests: list[Request], *,
              window: int | None = None) -> ServeStats:
        """Routed dispatch of *individual* requests with out-of-order
        collection and (optionally) live work stealing; blocks until every
        request is DONE or FAILED."""
        window = window or 2 * sum(e.slots for e in self.replicas)
        base = [e.begin_window() for e in self.replicas]
        with self._stats_lock:
            rbase = RouterStats(**vars(self.stats))
        t0 = time.monotonic()
        for r in requests:
            # arrival = hand-off to the router; clones inherit it, so both
            # reissue and stealing keep TTFT measured from here
            if r.submitted_at is None:
                r.submitted_at = t0
        self._start_stealing()
        try:
            with OffloadEngine(self.targets, scheduler=self._place,
                               deadline_s=self.deadline_s) as eng:
                results, _ = eng.run_unordered(requests, window=window)
        finally:
            self._stop_stealing()
        # every request resolved implies every migration resolved, but the
        # completion hook's export release can lag by a worker beat -- and
        # the caller's leak sweep must see the pins gone
        self.drain_migrations()
        stats = ServeStats(requests=len(requests),
                           wall_s=time.monotonic() - t0)
        delivered = 0
        for seq, done in results:      # copy the winning clone's results back
            orig = requests[seq]
            if isinstance(done, WorkError):
                # the replica worker itself raised (not a routed request
                # failure): surface it as a typed FAILED terminal
                orig.state = RequestState.FAILED
                orig.error = done.error
                orig.finished_at = time.monotonic()
                continue
            orig.output = done.output
            orig.state = done.state
            orig.error = done.error
            orig.first_token_at = done.first_token_at
            orig.finished_at = done.finished_at
            delivered += len(done.output)
        # declarative fleet aggregation: every ServeStats field merges by
        # its MERGE_RULES entry, so new fields cannot silently drop here
        for e, b in zip(self.replicas, base):
            stats.merge_from(e.collect_window(b, [], 0.0))
        # replica windows count every decoded token, including the losing
        # copy of a reissue/steal race; the fleet number is *delivered*
        # tokens (winning clones only), so throughput never double-counts
        stats.tokens = delivered
        with self._stats_lock:
            stats.router_steals = self.stats.steals - rbase.steals
            stats.router_affinity_hits = (self.stats.affinity_hits
                                          - rbase.affinity_hits)
            stats.requests_retried = self.stats.retries - rbase.retries
            stats.replica_failures = (self.stats.replica_failures
                                      - rbase.replica_failures)
            rebalance_exc = self._rebalance_exc
            self._rebalance_exc = None
        # the merged per-replica count tallies every failure event,
        # including ones a retry later recovered; the fleet-level number is
        # *terminal* failures -- requests whose callers got no answer
        stats.requests_failed = sum(
            1 for r in requests if r.state is RequestState.FAILED)
        stats.fill_request_metrics(requests)
        if rebalance_exc is not None:
            # a rebalance tick that raised was contained mid-serve (counted
            # in rebalance_errors) but must not stay silent -- results are
            # already copied back onto the caller's requests
            raise rebalance_exc
        return stats


class MultiReplicaEngine(ReplicaRouter):
    """Request-count least-loaded dispatch with no prefix affinity and no
    work stealing, kept as the routing A/B baseline.  New code should
    construct :class:`ReplicaRouter` directly."""

    def __init__(self, replicas: list[ServingEngine], *,
                 deadline_s: float | None = None,
                 max_retries: int = 2):
        super().__init__(replicas, affinity=False, steal=False,
                         block_aware=False, deadline_s=deadline_s,
                         max_retries=max_retries)
