"""Paged KV-cache block pool: fixed-size blocks, per-request block tables
(counterpart of ``repro/serving/kv_pool.py``).

Instead of reserving a worst-case ``(L, B, max_len, K, D)`` cache slice per
decode slot, the engine owns one global pool of ``num_blocks`` fixed-size KV
blocks (``block_size`` tokens each).  Requests hold *block tables* — lists of
physical block ids in logical order — and the scheduler admits a request when
enough blocks are *free*, not when a worst-case slot is free.  Block 0 is a
reserved trash block: retired decode slots keep writing their (discarded)
rows there, so freeing a finished request's blocks can never be corrupted by
the in-flight batched decode step.

Lifecycle per request:
  * admission: ``reserve(n)`` the worst-case block count (prompt + budget)
  * prefill:   ``alloc_reserved`` the prompt's blocks
  * decode:    ``alloc_reserved(1)`` each time generation crosses a block
  * verify:    ``alloc_reserved`` the blocks a speculative verify's candidate
               rows reach, then ``release_provisional`` the rejected tail's
  * release:   ``free`` the allocated ids + ``unreserve`` the unused tail

Blocks are **refcounted** so a full prompt-prefix block can be shared by
several requests (prefix sharing): ``alloc_reserved`` hands a block out with
refcount 1, ``share`` increments it for each additional holder, and ``free``
decrements — the block only returns to the free list when the last holder
lets go, so a sharer can never free a block out from under another request.
Each allocation also bumps the block's **generation** counter; the engine's
prefix index stores ``(block_id, generation)`` pairs and treats an entry as
dead the moment the generation moves on, so a stale index entry can never
alias a block that was freed and re-allocated with different contents.

``CapacityError`` is the shared typed error for requests that can *never*
fit (engine ``_check_fits`` and scheduler admission both raise it), as
opposed to transient fullness, which just defers admission.

**Tiered mode** (``host_blocks > 0``) turns the device pool into the hot
tier of a cache hierarchy.  The engine's prefix index takes a refcounted
*hold* on every block it publishes (:meth:`KVBlockPool.hold`), so a shared
prefix stays device-resident — still seedable at zero copy — after its
last request releases it.  A held block whose only remaining holder is the
index is **demotable**: when :meth:`reserve` cannot be satisfied from the
free list alone, the pool demotes least-recently-idle demotable blocks
(the ``on_demote`` callback lets the engine spill their rows to the
:class:`HostTier` first), so admission counts ``free + demotable`` as
headroom (:attr:`available_blocks`).  The pinned set is implicit: blocks
held by live block tables have refcount > 1 and are never demotable, and
an in-flight spill clones the block's rows on the executor's stream
before the id is freed (the port's pools are written in place, so a view
would read whatever a later prefill writes there), so reuse can never
corrupt it.  Generation tags keep their existing
contract — a demoted id leaves ``_refs`` without bumping its generation,
so ``block_live`` goes False immediately and the next allocation bumps it,
which is what makes a stale fetch commit detectable.

The transfer state machine lives one layer up (the engine tracks pending
fetches per prefill job); the pool owns *placement* truth: which ids are
held, which are demotable and in what LRU order, and the host tier's
digest-keyed payload store.

``avail_epoch`` is a monotonic counter bumped whenever admission headroom
may have *grown* (a free, an unreserve, a block turning demotable).  The
scheduler uses it to cache a blocked queue head's failed admission check
and skip re-evaluating it until something actually changed.
"""
from __future__ import annotations

import threading
from typing import Any, Callable


class CapacityError(ValueError):
    """Request exceeds KV capacity (per-request table or whole pool)."""


class Tier:
    """A KV-block payload store below the device pool.

    Keys are the engine's chained prefix digests (`bytes`); payloads are
    opaque to the tier (in practice a dict of per-leaf numpy arrays for
    one block: k/v rows plus quantization scales when present; bf16 rows
    as their int16 bit patterns, numpy having no bf16).  ``load``
    returns ``None`` for a missing key instead of raising — a tier may
    evict under its own capacity pressure, and the engine falls back to
    recompute for whatever a fetch no longer finds.
    """

    name = "tier"
    capacity: int = 0

    def store(self, key: bytes, payload: Any) -> None:
        raise NotImplementedError

    def load(self, key: bytes) -> Any:
        raise NotImplementedError

    def drop(self, key: bytes) -> None:
        raise NotImplementedError

    def __contains__(self, key: bytes) -> bool:
        raise NotImplementedError

    @property
    def used(self) -> int:
        raise NotImplementedError


class HostTier(Tier):
    """Pinned host-memory tier: digest-keyed block payloads, LRU-evicted.

    ``begin_store`` marks a key *pending* the moment a spill is submitted
    (on the engine thread), so a concurrent lookup already counts it as
    resident and a fetch submitted behind it collects the real payload —
    the single transfer worker drains FIFO, so the store always lands
    first.  Pending entries are pinned (never LRU-evicted) until the
    worker fills them.  Thread-safe: the engine thread probes/marks while
    the transfer worker stores/loads.
    """

    name = "host"
    _PENDING = object()

    def __init__(self, capacity: int):
        assert capacity >= 1
        self.capacity = capacity
        self._lock = threading.Lock()
        self._data: dict[bytes, Any] = {}  # guarded-by: self._lock; LRU order
        self.stores = 0                    # guarded-by: self._lock
        self.loads = 0                     # guarded-by: self._lock
        self.evictions = 0                 # guarded-by: self._lock
        self.misses = 0                    # guarded-by: self._lock

    def begin_store(self, key: bytes) -> None:
        """Reserve ``key`` for an in-flight spill (pinned placeholder)."""
        with self._lock:
            if key not in self._data:
                self._data[key] = self._PENDING
                self._evict_over_capacity()

    def store(self, key: bytes, payload: Any) -> None:
        with self._lock:
            self._data.pop(key, None)        # refresh LRU position
            self._data[key] = payload
            self.stores += 1
            self._evict_over_capacity()

    # assumes-lock: self._lock
    def _evict_over_capacity(self) -> None:
        # oldest non-pending entries go first
        over = len(self._data) - self.capacity
        if over <= 0:
            return
        for k in [k for k, v in self._data.items()
                  if v is not self._PENDING][:over]:
            del self._data[k]
            self.evictions += 1

    def load(self, key: bytes) -> Any:
        with self._lock:
            payload = self._data.get(key)
            if payload is None or payload is self._PENDING:
                self.misses += 1
                return None
            del self._data[key]              # move-to-end = LRU touch
            self._data[key] = payload
            self.loads += 1
            return payload

    def drop(self, key: bytes) -> None:
        with self._lock:
            self._data.pop(key, None)

    def __contains__(self, key: bytes) -> bool:
        with self._lock:
            return key in self._data         # pending counts as resident

    @property
    def used(self) -> int:
        with self._lock:
            return len(self._data)

    @property
    def pending_count(self) -> int:
        """Keys pinned by an in-flight spill that never landed — nonzero
        after drain means a spill was submitted and its payload dropped
        (a leak the fault tests sweep for)."""
        with self._lock:
            return sum(v is self._PENDING for v in self._data.values())


class DiskTierStub(Tier):
    """Interface placeholder for a third tier below host memory.

    Exists so the tier stack has a named next rung (device -> host ->
    disk) without this PR committing to a file format or an eviction
    policy for it; any attempt to actually move payloads through it
    raises, which is the honest behaviour for a stub.
    """

    name = "disk"
    capacity = 0

    def store(self, key: bytes, payload: Any) -> None:
        raise NotImplementedError(
            "DiskTierStub is an interface placeholder: the disk tier has "
            "no storage backend yet (host tier is the only real tier)")

    def load(self, key: bytes) -> Any:
        raise NotImplementedError(
            "DiskTierStub is an interface placeholder: the disk tier has "
            "no storage backend yet (host tier is the only real tier)")

    def drop(self, key: bytes) -> None:
        pass

    def __contains__(self, key: bytes) -> bool:
        return False

    @property
    def used(self) -> int:
        return 0


class KVBlockPool:
    """Allocator for a global pool of fixed-size KV-cache blocks.

    ``num_blocks`` counts *usable* blocks; the backing device tensors have
    ``total_blocks = num_blocks + 1`` rows because id 0 is the trash block
    and is never handed out.
    """

    TRASH = 0

    def __init__(self, num_blocks: int, block_size: int = 16, *,
                 host_blocks: int = 0):
        assert num_blocks >= 1 and block_size >= 1
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._lock = threading.Lock()
        # Hot-path structures are all O(1) per block: a LIFO list stack
        # (append/pop), dict refcounts, a dense generation list, and
        # insertion-ordered dict-sets for the held/demotable tracking —
        # no free-list or refcount scan anywhere in alloc/grow/free
        # (serving_bench's pool micro-bench pins this: per-op cost is
        # flat across pool sizes).
        # LIFO free stack of usable ids (1..num_blocks); 0 is trash.
        self._free: list[int] = \
            list(range(num_blocks, 0, -1))   # guarded-by: self._lock
        self._refs: dict[int, int] = {}      # guarded-by: self._lock
        self._gen = [0] * (num_blocks + 1)   # guarded-by: self._lock
        self._reserved = 0                   # guarded-by: self._lock
        self._peak_used = 0                  # guarded-by: self._lock
        # tiering (see module docstring): index-held ids, the demotable
        # subset in least-recently-idle order, and the host payload tier
        self._held: dict[int, None] = {}     # guarded-by: self._lock
        self._demotable: dict[int, None] = {}  # guarded-by: self._lock
        self.host: HostTier | None = \
            HostTier(host_blocks) if host_blocks > 0 else None
        # engine hook: spill these ids' rows to the host tier before the
        # pool frees them.  Called under the pool lock — the callback
        # must not call back into the pool.
        self.on_demote: Callable[[list[int]], None] | None = None
        self._demotions = 0                  # guarded-by: self._lock
        self._avail_epoch = 0                # guarded-by: self._lock

    # -- sizing ----------------------------------------------------------------

    @property
    def total_blocks(self) -> int:
        """Rows in the backing pool tensors (usable blocks + trash block)."""
        return self.num_blocks + 1

    @property
    def capacity(self) -> int:
        return self.num_blocks

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` KV rows."""
        return max(0, -(-tokens // self.block_size))

    def validate_rows(self, rows: int, rid=None) -> int:
        """The shared admission predicate: blocks for ``rows`` KV rows, or
        :class:`CapacityError` if they exceed the whole pool — engine
        ``_check_fits`` and scheduler ``submit`` both call this, so the
        check (and its message) cannot drift between the two."""
        blocks = self.blocks_for(rows)
        if blocks > self.capacity:
            raise CapacityError(
                f"request {rid}: {rows} KV rows need {blocks} blocks, "
                f"exceeding pool KV capacity of {self.capacity} blocks "
                f"({self.capacity * self.block_size} rows)")
        return blocks

    # -- accounting ------------------------------------------------------------

    @property
    def used_blocks(self) -> int:
        """Distinct allocated blocks (a shared block counts once)."""
        with self._lock:
            return len(self._refs)

    @property
    def free_blocks(self) -> int:
        """Blocks neither allocated nor promised to an admitted request."""
        with self._lock:
            return len(self._free) - self._reserved

    @property
    def reserved_blocks(self) -> int:
        with self._lock:
            return self._reserved

    @property
    def peak_used(self) -> int:
        """High-water mark of distinct allocated blocks."""
        with self._lock:
            return self._peak_used

    @property
    def utilization(self) -> float:
        """Peak allocated blocks as a fraction of capacity."""
        with self._lock:
            return self._peak_used / self.num_blocks

    def reset_peak(self) -> None:
        with self._lock:
            self._peak_used = len(self._refs)

    @property
    def demotions(self) -> int:
        """Lifetime count of index-held blocks demoted under pressure."""
        with self._lock:
            return self._demotions

    @property
    def demotable_count(self) -> int:
        """Blocks held only by the prefix index — freeable on demand (the
        scheduler's *restorable* headroom, and the router's)."""
        with self._lock:
            return len(self._demotable)

    @property
    def held_count(self) -> int:
        with self._lock:
            return len(self._held)

    @property
    def available_blocks(self) -> int:
        """What :meth:`reserve` can actually satisfy: strictly free blocks
        plus index-held blocks it may demote on demand."""
        with self._lock:
            return len(self._free) - self._reserved + len(self._demotable)

    @property
    def avail_epoch(self) -> int:
        """Monotonic headroom-growth counter (see module docstring); the
        scheduler's blocked-head admission cache keys on it."""
        with self._lock:
            return self._avail_epoch

    # -- lifecycle -------------------------------------------------------------

    def reserve(self, n: int) -> bool:
        """Promise ``n`` blocks to a request being admitted, demoting
        least-recently-idle index-held blocks if the free list alone
        cannot cover it (their rows spill to the host tier via the
        ``on_demote`` hook first).

        Returns False when the pool is transiently too full (caller defers
        admission); raises :class:`CapacityError` when ``n`` exceeds the
        whole pool, i.e. the request could never run.
        """
        if n > self.num_blocks:
            raise CapacityError(
                f"request needs {n} KV blocks but the pool only has "
                f"{self.num_blocks} (block_size={self.block_size})")
        with self._lock:
            shortfall = n - (len(self._free) - self._reserved)
            if shortfall > len(self._demotable):
                return False
            if shortfall > 0:
                self._demote_locked(shortfall)
            self._reserved += n
            return True

    # assumes-lock: self._lock
    def _demote_locked(self, k: int) -> None:
        """Free the ``k`` least-recently-idle demotable blocks (spilling
        their rows first via ``on_demote``).  Caller holds the lock; the
        callback must not re-enter the pool.  Generations are *not*
        bumped here — ``block_live`` goes False because the id leaves
        ``_refs``, and the next allocation bumps the generation, exactly
        like a normal free."""
        ids = []
        it = iter(self._demotable)
        for _ in range(k):
            ids.append(next(it))
        if self.on_demote is not None:
            self.on_demote(ids)
        for b in ids:
            assert self._refs.get(b) == 1, \
                f"demotable block {b} has refcount {self._refs.get(b)}"
            del self._refs[b]
            del self._held[b]
            del self._demotable[b]
            self._free.append(b)
        self._demotions += len(ids)

    def unreserve(self, n: int) -> None:
        with self._lock:
            assert self._reserved >= n, (self._reserved, n)
            self._reserved -= n
            if n:
                self._avail_epoch += 1

    def alloc_reserved(self, n: int) -> list[int]:
        """Materialize ``n`` previously reserved blocks as physical ids
        (each handed out with refcount 1 and a fresh generation)."""
        with self._lock:
            assert self._reserved >= n, \
                f"alloc of {n} blocks exceeds reservation {self._reserved}"
            assert len(self._free) >= n     # invariant: reserved <= free
            ids = [self._free.pop() for _ in range(n)]
            for b in ids:
                self._refs[b] = 1
                self._gen[b] += 1
            self._reserved -= n
            self._peak_used = max(self._peak_used, len(self._refs))
            return ids

    def share(self, ids: list[int]) -> None:
        """Add one holder to each (already allocated) block — the prefix-
        sharing path: a new request maps its leading table entries to
        blocks another request allocated.  A demotable block gaining a
        holder is hot again and leaves the demotion candidates."""
        with self._lock:
            for b in ids:
                if b not in self._refs:
                    raise ValueError(f"share of unallocated KV block {b}")
                self._refs[b] += 1
                self._demotable.pop(b, None)

    def free(self, ids: list[int]) -> list[int]:
        """Drop one holder per block; blocks whose last holder left return
        to the free list.  Returns the ids actually released (refcount hit
        zero).  Freeing an unallocated id raises.  An index-held block
        whose last *request* holder left (refcount back to the hold alone)
        becomes demotable instead of free — it stays device-resident and
        seedable until pool pressure demotes it."""
        released: list[int] = []
        with self._lock:
            for b in ids:
                refs = self._refs.get(b)
                if refs is None:
                    raise ValueError(f"double free of KV block {b}")
                if refs > 1:
                    self._refs[b] = refs - 1
                    if refs == 2 and b in self._held:
                        # idle now: last-touched order == demotable order
                        self._demotable.pop(b, None)
                        self._demotable[b] = None
                        self._avail_epoch += 1
                else:
                    del self._refs[b]
                    self._held.pop(b, None)      # defensive; a held block
                    self._demotable.pop(b, None)  # normally demotes instead
                    self._free.append(b)
                    released.append(b)
            if ids:
                # Any refcount decrement is a capacity event: even a
                # 2->1 drop on an unheld block raises the preemption
                # *gain* (reclaimable_count), so a blocked queue head
                # cached against the old epoch must be re-checked.
                self._avail_epoch += 1
        return released

    # -- tiering ---------------------------------------------------------------

    def hold(self, block_id: int) -> None:
        """The prefix index takes a holder on a just-published block, so
        it survives its requests' releases device-resident (demotable
        under pressure) instead of returning to the free list."""
        with self._lock:
            if block_id not in self._refs:
                raise ValueError(f"hold of unallocated KV block {block_id}")
            if block_id in self._held:
                raise ValueError(f"double hold of KV block {block_id}")
            self._refs[block_id] += 1
            self._held[block_id] = None

    def touch(self, ids: list[int]) -> None:
        """Refresh LRU position of any demotable ids among ``ids`` — a
        prefix lookup that seeds from an idle shared block makes it the
        *most* recently useful demotion candidate, not the next victim."""
        with self._lock:
            for b in ids:
                if b in self._demotable:
                    del self._demotable[b]
                    self._demotable[b] = None

    def release_provisional(self, ids: list[int]) -> None:
        """Return *provisionally grown* blocks — the rejected tail of a
        speculative verify step — and re-promise them to the caller.

        This is the rollback half of a grow-then-reject cycle: the engine
        ``alloc_reserved``s blocks for candidate KV rows before the verify
        pass, then hands back the ones past the accepted prefix.  Unlike
        :meth:`free`, the cycle must be *invisible*: each block's generation
        tag is rolled back to its pre-grow value (a provisional block never
        held published rows, so no prefix-index entry can alias it) and the
        blocks go back to being reserved rather than free, so another
        request can't race in and shrink the caller's worst-case budget.

        Provisional blocks are by construction unshared; passing a block
        with refcount != 1 (or a free block) raises without mutating.
        """
        with self._lock:
            for b in ids:
                refs = self._refs.get(b)
                if refs is None:
                    raise ValueError(
                        f"release_provisional of unallocated KV block {b}")
                if refs != 1:
                    raise ValueError(
                        f"release_provisional of shared KV block {b} "
                        f"(refcount {refs})")
            for b in ids:
                del self._refs[b]
                self._gen[b] -= 1
                self._free.append(b)
            self._reserved += len(ids)

    # -- migration export --------------------------------------------------------

    def export_blocks(self, ids: list[int]) -> list[int]:
        """Pin ``ids`` for an in-flight prefill->decode migration and
        return their generation tags, in order.

        Adds one holder per block (like :meth:`share`) so the source pool
        can neither free nor re-allocate a migrating block while its rows
        are in flight -- the export hold keeps the generations frozen as
        evidence the receiver checks, instead of a race against the
        releasing request.  The caller drops the export with a plain
        :meth:`free` once the transfer commits or fails.  Exporting the
        trash block or an unallocated id raises without mutating.
        """
        with self._lock:
            for b in ids:
                if b == self.TRASH:
                    raise ValueError("export of trash KV block 0")
                if b not in self._refs:
                    raise ValueError(f"export of unallocated KV block {b}")
            for b in ids:
                self._refs[b] += 1
                self._demotable.pop(b, None)
            return [self._gen[b] for b in ids]

    # -- prefix-index support ----------------------------------------------------

    def refcount(self, block_id: int) -> int:
        """Current holder count (0 if the block is free)."""
        with self._lock:
            return self._refs.get(block_id, 0)

    def reclaimable_count(self, ids: list[int]) -> int:
        """Tier-aware preemption gain: blocks a victim's free would return
        to the free list (refcount 1) *plus* blocks it would turn
        demotable (refcount 2 with one holder being the prefix index) —
        either way the pool can hand them to the preemptor."""
        with self._lock:
            out = 0
            for b in ids:
                refs = self._refs.get(b, 0)
                if refs == 1 or (refs == 2 and b in self._held):
                    out += 1
            return out

    def generation(self, block_id: int) -> int:
        """Allocation generation of ``block_id`` (bumped per allocation)."""
        with self._lock:
            return self._gen[block_id]

    def block_live(self, block_id: int, gen: int) -> bool:
        """True iff ``block_id`` is still allocated *and* still the same
        allocation the caller tagged — the prefix index's validity check:
        a block that was freed and re-allocated has a newer generation and
        must not be shared as if it still held the old prefix rows."""
        with self._lock:
            return block_id in self._refs and self._gen[block_id] == gen

    # -- fault-tolerance audit ---------------------------------------------------

    def leak_report(self) -> dict[str, int]:
        """Leak sweep for the fault tests: after a full drain (every
        request DONE or FAILED and every slot retired), the only
        legitimate surviving allocations are prefix-index holds — each
        with refcount exactly 1 (the hold itself).  Anything else is a
        leaked request holder, a stranded reservation, or a spill pin
        that never landed.  Returns a dict of violation counts; all-zero
        means leak-free."""
        with self._lock:
            unheld = [b for b in self._refs if b not in self._held]
            held_over = [b for b in self._held if self._refs.get(b, 0) != 1]
            report = {
                # allocated blocks no index hold accounts for
                "unheld_blocks": len(unheld),
                # held blocks some request still refcounts (or a hold on
                # a freed id)
                "held_with_extra_refs": len(held_over),
                "reserved_blocks": self._reserved,
            }
        report["host_pending"] = (self.host.pending_count
                                  if self.host is not None else 0)
        return report

    def assert_leak_free(self) -> None:
        """Raise with the full report when :meth:`leak_report` is dirty."""
        report = self.leak_report()
        if any(report.values()):
            raise AssertionError(f"KV pool leak after drain: {report}")
