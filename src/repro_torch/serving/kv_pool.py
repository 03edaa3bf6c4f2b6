"""Paged KV-cache block pool: fixed-size blocks, per-request block tables
(a copy of ``repro/serving/kv_pool.py`` without the host tier).

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
lets go.  Each allocation also bumps the block's **generation** counter; the
engine's prefix index stores ``(block_id, generation)`` pairs and treats an
entry as dead the moment the generation moves on, so a stale index entry can
never alias a block that was freed and re-allocated with different contents.

``avail_epoch`` is a monotonic counter bumped whenever admission headroom
may have *grown* (a free, an unreserve).  The scheduler uses it to cache a
blocked queue head's failed admission check.

The host tier (``host_blocks > 0`` in the reference) is not ported yet: the
port's pools are written in place, so a spill must copy a block before its
id is released, which the tiering slice adds.
"""
from __future__ import annotations

import threading


class CapacityError(ValueError):
    """Request exceeds KV capacity (per-request table or whole pool)."""


class KVBlockPool:
    """Allocator for a global pool of fixed-size KV-cache blocks.

    ``num_blocks`` counts *usable* blocks; the backing device tensors have
    ``total_blocks = num_blocks + 1`` rows because id 0 is the trash block
    and is never handed out.
    """

    TRASH = 0

    def __init__(self, num_blocks: int, block_size: int = 16, *,
                 host_blocks: int = 0):
        if host_blocks > 0:
            raise ValueError("the host KV tier (host_blocks > 0) is not "
                             "ported yet")
        assert num_blocks >= 1 and block_size >= 1
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._lock = threading.Lock()
        # LIFO free stack of usable ids (1..num_blocks); 0 is trash.
        self._free: list[int] = \
            list(range(num_blocks, 0, -1))   # guarded-by: self._lock
        self._refs: dict[int, int] = {}      # guarded-by: self._lock
        self._gen = [0] * (num_blocks + 1)   # guarded-by: self._lock
        self._reserved = 0                   # guarded-by: self._lock
        self._peak_used = 0                  # guarded-by: self._lock
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
        :class:`CapacityError` if they exceed the whole pool."""
        blocks = self.blocks_for(rows)
        if blocks > self.capacity:
            raise CapacityError(
                f"request {rid}: {rows} KV rows need {blocks} blocks, "
                f"exceeding pool KV capacity of {self.capacity} blocks "
                f"({self.capacity * self.block_size} rows)")
        return blocks

    # -- accounting ------------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        """Blocks neither allocated nor promised to an admitted request."""
        with self._lock:
            return len(self._free) - self._reserved

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
    def available_blocks(self) -> int:
        """What :meth:`reserve` can satisfy (free blocks; without a host
        tier nothing is demotable)."""
        return self.free_blocks

    @property
    def avail_epoch(self) -> int:
        """Monotonic headroom-growth counter; the scheduler's blocked-head
        admission cache keys on it."""
        with self._lock:
            return self._avail_epoch

    # -- lifecycle -------------------------------------------------------------

    def reserve(self, n: int) -> bool:
        """Promise ``n`` blocks to a request being admitted.  Returns False
        when the pool is transiently too full (caller defers admission);
        raises :class:`CapacityError` when ``n`` exceeds the whole pool."""
        if n > self.num_blocks:
            raise CapacityError(
                f"request needs {n} KV blocks but the pool only has "
                f"{self.num_blocks} (block_size={self.block_size})")
        with self._lock:
            if n > len(self._free) - self._reserved:
                return False
            self._reserved += n
            return True

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
        sharing path."""
        with self._lock:
            for b in ids:
                if b not in self._refs:
                    raise ValueError(f"share of unallocated KV block {b}")
                self._refs[b] += 1

    def free(self, ids: list[int]) -> list[int]:
        """Drop one holder per block; blocks whose last holder left return
        to the free list.  Returns the ids actually released.  Freeing an
        unallocated id raises."""
        released: list[int] = []
        with self._lock:
            for b in ids:
                refs = self._refs.get(b)
                if refs is None:
                    raise ValueError(f"double free of KV block {b}")
                if refs > 1:
                    self._refs[b] = refs - 1
                else:
                    del self._refs[b]
                    self._free.append(b)
                    released.append(b)
            if ids:
                # any refcount decrement raises the preemption gain
                # (reclaimable_count), so a cached blocked head is re-checked
                self._avail_epoch += 1
        return released

    def release_provisional(self, ids: list[int]) -> None:
        """Return *provisionally grown* blocks -- the rejected tail of a
        speculative verify step -- and re-promise them to the caller.

        The rollback half of a grow-then-reject cycle: the engine
        ``alloc_reserved``s blocks for candidate KV rows before the verify
        pass, then hands back the ones past the accepted prefix.  Unlike
        :meth:`free`, the cycle is invisible: each block's generation goes
        back to its pre-grow value (a provisional block never held
        published rows, so no prefix-index entry can alias it) and the
        blocks go back to being reserved rather than free, so no other
        request can shrink the caller's worst-case budget.

        Provisional blocks are unshared: a block with refcount != 1 (or a
        free block) raises before anything changes.
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

    # -- prefix-index support ----------------------------------------------------

    def reclaimable_count(self, ids: list[int]) -> int:
        """Preemption gain: blocks a victim's free would return to the free
        list (refcount exactly 1)."""
        with self._lock:
            return sum(self._refs.get(b, 0) == 1 for b in ids)

    def generation(self, block_id: int) -> int:
        """Allocation generation of ``block_id`` (bumped per allocation)."""
        with self._lock:
            return self._gen[block_id]

    def block_live(self, block_id: int, gen: int) -> bool:
        """True iff ``block_id`` is still allocated *and* still the same
        allocation the caller tagged."""
        with self._lock:
            return block_id in self._refs and self._gen[block_id] == gen

    # -- leak audit ----------------------------------------------------------------

    def leak_report(self) -> dict[str, int]:
        """Leak sweep after a full drain (every request DONE and every slot
        retired): without a host tier no allocation may survive.  Returns
        violation counts; all-zero means leak-free."""
        with self._lock:
            return {"unheld_blocks": len(self._refs),
                    "reserved_blocks": self._reserved}
