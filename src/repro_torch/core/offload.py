"""The paper's contribution, generalized: split-phase co-processor offload
(counterpart of ``repro/core/offload.py``; :class:`TorchTarget` takes the
place of its ``JaxTarget``, and its ``KVBlockTarget`` waits for the port's
host KV tier).

NCSw (paper section 3) maps onto this module as follows:

  NCAPI ``mvncLoadTensor``  -> :meth:`Target.load_tensor` (non-blocking:
                               stage input + enqueue execution)
  NCAPI ``mvncGetResult``   -> :meth:`Target.get_result` (blocking collect,
                               queueing order)
  one host thread per NCS   -> one worker thread per :class:`Target`
  static round-robin        -> :class:`OffloadEngine` scheduler="round_robin"
  USB transfer/compute overlap -> per-target transfer stage runs in the
                               worker while the previous item computes

Beyond the paper: deadline-based straggler reissue (a stuck device's item is
re-dispatched to the next free target; first result wins), dynamic
least-loaded scheduling as an alternative to static round-robin, a
pluggable placement hook (``scheduler=callable``), and target groups so one
engine can drive heterogeneous pools.

Two collection disciplines coexist:

  * :meth:`OffloadEngine.run` -- ordered collection (``inflight.pop(0)``),
    the paper's Fig 4 queueing-order semantics.
  * :meth:`OffloadEngine.submit_async` + :meth:`next_done` /
    :meth:`drain` / :meth:`run_unordered` -- out-of-order completion via a
    per-engine done-queue, so one slow item never blocks draining of
    finished ones.

Targets:
  * :class:`TorchTarget` -- runs a PyTorch function on a device (real
    compute: the card, or the CPU when asked).
  * :class:`SimTarget` -- calibrated latency model of a paper device (Myriad
    2 VPU / Xeon / Quadro), used to reproduce the paper's scaling figures.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.models.layers.module import tree_map


@dataclass
class WorkError:
    """Terminal error result: every attempt at the item raised.

    Committed through the normal :meth:`WorkItem.complete` path so
    collectors (``run``/``run_unordered``/``drain``) terminate instead of
    hanging on an item nothing will ever finish; consumers distinguish it
    with ``isinstance(item.result, WorkError)``.
    """
    error: BaseException
    target_name: str = ""


@dataclass
class WorkItem:
    seq: int
    payload: Any
    submitted_at: float = field(default_factory=time.monotonic)
    started_at: float | None = None
    finished_at: float | None = None
    result: Any = None
    target_name: str = ""
    reissued: bool = False
    failures: int = 0           # raising attempts (retries ride on this)
    done: threading.Event = field(default_factory=threading.Event)
    # async completion hook (set by OffloadEngine.submit); fired exactly once,
    # by whichever target completes the item first (reissue-safe).
    on_done: Callable[["WorkItem"], None] | None = None
    # failure hook: (item, exc, target_name) -> True if the failure was
    # *handled* (e.g. the router reissued the item on a survivor); False
    # lets fail() commit a WorkError so collectors still terminate.
    on_fail: Callable[["WorkItem", BaseException, str], bool] | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def complete(self, result: Any, target_name: str) -> bool:
        """First-completion-wins commit; returns False if already done."""
        with self._lock:
            if self.done.is_set():
                return False
            self.result = result
            self.target_name = target_name
            self.finished_at = time.monotonic()
            self.done.set()
        if self.on_done is not None:
            self.on_done(self)
        return True

    def fail(self, exc: BaseException, target_name: str) -> bool:
        """Route one raising attempt: give ``on_fail`` a chance to handle
        it (retry elsewhere); otherwise commit a :class:`WorkError` result
        so whoever is collecting this item unblocks with a typed failure
        instead of waiting forever.  Returns True if the item reached a
        terminal state here."""
        with self._lock:
            if self.done.is_set():
                return False
            self.failures += 1
        if self.on_fail is not None:
            try:
                if self.on_fail(self, exc, target_name):
                    return False          # handled: item lives on elsewhere
            except Exception:  # fault-ok: a broken failure handler must not kill the worker; fall through to the terminal WorkError commit
                pass
        return self.complete(WorkError(error=exc, target_name=target_name),
                             target_name)


class Target:
    """A co-processor endpoint (paper's abstract Target)."""

    name: str = "target"
    tdp_watts: float = 1.0
    # fault-injection probe (``target.compute`` site): called with the
    # item just before execute; returning True *drops* the item (completes
    # with None — a silently-lost result), raising routes through the
    # normal failure path, and a delay action sleeps inside the hook.
    fault_hook: Callable[[WorkItem], bool] | None = None

    def transfer(self, payload: Any) -> Any:
        """Host->device staging (USB transfer analogue)."""
        return payload

    def execute(self, staged: Any) -> Any:
        raise NotImplementedError

    # -- split-phase API (NCAPI semantics) -------------------------------------

    def open(self) -> None:
        self._q: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._run,
                                        name=f"offload-{self.name}",
                                        daemon=True)
        self._alive = True
        self.busy = False
        self._worker.start()

    def close(self) -> None:
        self._alive = False
        self._q.put(None)
        self._worker.join(timeout=5)

    def load_tensor(self, item: WorkItem) -> WorkItem:
        """Non-blocking: stage input + enqueue execution (mvncLoadTensor)."""
        self._q.put(item)
        return item

    @staticmethod
    def get_result(item: WorkItem, timeout: float | None = None) -> Any:
        """Blocking collect (mvncGetResult)."""
        if not item.done.wait(timeout):
            raise TimeoutError(f"item {item.seq} not done")
        return item.result

    def _run(self) -> None:
        while self._alive:
            item = self._q.get()
            if item is None:
                return
            if item.done.is_set():     # straggler reissue already finished it
                continue
            self.busy = True
            try:
                staged = self.transfer(item.payload)
                item.started_at = time.monotonic()
                if self.fault_hook is not None and self.fault_hook(item):
                    item.complete(None, self.name)   # injected drop
                    continue
                out = self.execute(staged)
                item.complete(out, self.name)
            except Exception as e:  # noqa: BLE001 — routed, not swallowed:
                # a raising transfer/execute used to kill this worker and
                # hang the item's collector; fail() keeps both alive
                item.fail(e, self.name)
            finally:
                self.busy = False

    @property
    def queue_depth(self) -> int:
        return self._q.qsize() + (1 if self.busy else 0)


class TorchTarget(Target):
    """Runs a PyTorch function on ``device``: ``transfer`` copies each numpy
    array of the payload (a nested dict/list, or one array) to the device,
    ``execute`` runs the function and hands every tensor of its result back
    as numpy (bf16, which numpy lacks, comes back as float32).  A CUDA
    device must exist: nothing falls back to the CPU."""

    def __init__(self, fn: Callable, name: str = "torch",
                 tdp_watts: float = 1.0, device="cuda"):
        self.fn = fn
        self.name = name
        self.tdp_watts = tdp_watts
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchTarget on cuda: no CUDA device")

    def transfer(self, payload):
        def put(x):
            if isinstance(x, np.ndarray):
                return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            return x
        return tree_map(put, payload)

    def execute(self, staged):
        out = self.fn(staged)

        def get(x):
            if isinstance(x, torch.Tensor):
                x = x.detach()
                if x.dtype == torch.bfloat16:
                    x = x.float()
                return x.cpu().numpy()
            return x
        return tree_map(get, out)


class SimTarget(Target):
    """Latency-calibrated stand-in for a paper device.

    The paper's single-device latencies (Fig 6b baselines): VPU 100.7 ms,
    CPU 26.0 ms, GPU 25.9 ms per inference; we split VPU time into a USB
    transfer share and SHAVE compute so transfer/compute overlap matters,
    exactly like the real NCS.
    """

    def __init__(self, name: str, compute_s: float, transfer_s: float = 0.0,
                 tdp_watts: float = 1.0, result_fn: Callable | None = None):
        self.name = name
        self.compute_s = compute_s
        self.transfer_s = transfer_s
        self.tdp_watts = tdp_watts
        self.result_fn = result_fn or (lambda p: p)

    def transfer(self, payload):
        if self.transfer_s:
            time.sleep(self.transfer_s)
        return payload

    def execute(self, staged):
        time.sleep(self.compute_s)
        return self.result_fn(staged)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@dataclass
class OffloadStats:
    items: int = 0
    wall_s: float = 0.0
    reissues: int = 0
    per_target: dict = field(default_factory=dict)

    @property
    def throughput(self) -> float:
        return self.items / self.wall_s if self.wall_s else 0.0


class OffloadEngine:
    """Coordinates N targets with the paper's split-phase protocol."""

    def __init__(self, targets: Sequence[Target], *,
                 scheduler: str | Callable[[list[Target], Any], Target]
                 = "round_robin",
                 deadline_s: float | None = None):
        # ``scheduler`` may be a placement hook: callable(targets, payload)
        # -> Target.  Higher layers (the serving ReplicaRouter) score
        # placement themselves — prefix affinity, block-aware load — while
        # riding this engine's split-phase submit/drain/reissue machinery
        # unchanged.
        assert callable(scheduler) or scheduler in ("round_robin",
                                                    "least_loaded")
        self.targets = list(targets)
        self.scheduler = scheduler
        self.deadline_s = deadline_s
        # Leaf lock for the engine's own counters/maps.  Submissions come
        # from several threads at once (the serve loop's submit_async, a
        # serving engine's spill submits from *inside* the pool lock, the
        # tier drain's next_done on the executor thread), so these need a
        # lock — but it is never held across _pick (a placement hook may
        # take scheduler/pool locks: router._place -> load_snapshot) or
        # load_tensor, which keeps it a leaf in the acquisition order and
        # the lock-order graph cycle-free.
        self._lock = threading.Lock()
        self._rr = 0                          # guarded-by: self._lock
        self._seq = 0                         # guarded-by: self._lock
        self._open = False
        self._done_q: queue.Queue = queue.Queue()
        self._async_pending: dict[int, WorkItem] = {}  # guarded-by: self._lock

    def __enter__(self):
        for t in self.targets:
            t.open()
        self._open = True
        return self

    def __exit__(self, *exc):
        self._open = False
        errors = []
        for t in self.targets:     # close every target even if one raises
            try:
                t.close()
            except Exception as e:  # noqa: BLE001 — aggregated below
                errors.append(e)
        # never mask an in-flight exception from the with-body; close
        # errors stay inspectable either way
        self.close_errors = errors
        if errors and exc[0] is None:
            if len(errors) == 1:
                raise errors[0]
            raise RuntimeError(
                f"{len(errors)} targets failed to close: "
                + "; ".join(repr(e) for e in errors)) from errors[0]

    def _pick(self, payload: Any) -> Target:
        if callable(self.scheduler):
            return self.scheduler(self.targets, payload)
        if self.scheduler == "round_robin":
            with self._lock:
                idx = self._rr
                self._rr += 1
            return self.targets[idx % len(self.targets)]
        return min(self.targets, key=lambda t: t.queue_depth)

    def submit(self, payload: Any, *,
               on_done: Callable[[WorkItem], None] | None = None) -> WorkItem:
        """Split-phase load (returns immediately; result via get_result).

        ``on_done`` fires exactly once, from the completing target's worker
        thread, the moment the item finishes — the async-notify alternative
        to blocking in :meth:`get_result`.
        """
        with self._lock:              # leaf: released before _pick/dispatch
            seq = self._seq
            self._seq += 1
        item = WorkItem(seq=seq, payload=payload, on_done=on_done)
        self._pick(payload).load_tensor(item)
        return item

    def submit_async(self, payload: Any) -> WorkItem:
        """Submit with completion routed to the engine's done-queue, so a
        consumer loop can collect items out of order via :meth:`next_done`
        / :meth:`drain` without head-of-line blocking."""
        item = self.submit(payload, on_done=self._done_q.put)
        with self._lock:
            self._async_pending[item.seq] = item
        return item

    def next_done(self, timeout: float | None = None) -> WorkItem | None:
        """Pop the next completed async item (any order); None on timeout.

        Retires the item from the async-pending set here (``drain``'s own
        pop is then a no-op), so a consumer loop that collects via
        ``next_done`` directly — the serving engine's KV-tier drain —
        cannot leak pending entries."""
        try:
            item = self._done_q.get(timeout=timeout)
        except queue.Empty:
            return None
        with self._lock:
            self._async_pending.pop(item.seq, None)
        return item

    def drain(self, n: int, *, deadline_s: float | None = None):
        """Yield ``n`` completed async items as they finish (out of order).

        With ``deadline_s`` (falls back to the engine's), a quiet period
        longer than the deadline triggers straggler reissue of every
        outstanding async item on the least-loaded target; first completion
        wins (``WorkItem.complete`` guards double-commit).
        """
        deadline = deadline_s if deadline_s is not None else self.deadline_s
        got = 0
        while got < n:
            item = self.next_done(timeout=deadline)
            if item is None:          # quiet past deadline -> reissue stragglers
                alt = min(self.targets, key=lambda t: t.queue_depth)
                with self._lock:      # snapshot only; dispatch outside
                    pending = list(self._async_pending.values())
                for it in pending:
                    # at most one reissue per item (same as get_result):
                    # repeating it would admit duplicate clones every quiet
                    # period on replica-style targets
                    if not it.done.is_set() and not it.reissued:
                        it.reissued = True
                        alt.load_tensor(it)
                item = self._done_q.get()
            with self._lock:
                self._async_pending.pop(item.seq, None)
            got += 1
            yield item

    def get_result(self, item: WorkItem) -> Any:
        if self.deadline_s is None:
            return Target.get_result(item)
        # deadline-based straggler mitigation: reissue on the least-loaded
        # other target; first completion wins.
        if item.done.wait(self.deadline_s):
            return item.result
        item.reissued = True
        alt = min(self.targets, key=lambda t: t.queue_depth)
        alt.load_tensor(item)
        return Target.get_result(item)

    def run(self, payloads, *, window: int | None = None) -> tuple[list, OffloadStats]:
        """Pipeline a stream: keep ``window`` items in flight (defaults to
        2x targets — the paper's double-buffering), collect in order."""
        assert self._open, "use `with OffloadEngine(...) as eng:`"
        window = window or 2 * len(self.targets)
        results: list[Any] = []
        stats = OffloadStats()
        inflight: list[WorkItem] = []
        t0 = time.monotonic()
        it = iter(payloads)
        exhausted = False
        while not exhausted or inflight:
            while not exhausted and len(inflight) < window:
                try:
                    inflight.append(self.submit(next(it)))
                except StopIteration:
                    exhausted = True
            item = inflight.pop(0)        # queueing order (paper Fig 4)
            results.append(self.get_result(item))
            stats.items += 1
            stats.reissues += int(item.reissued)
            stats.per_target[item.target_name] = \
                stats.per_target.get(item.target_name, 0) + 1
        stats.wall_s = time.monotonic() - t0
        return results, stats

    def run_unordered(self, payloads, *,
                      window: int | None = None) -> tuple[list, OffloadStats]:
        """Pipeline a stream with out-of-order collection: results are
        ``(seq, result)`` pairs in *completion* order.  Keeps ``window``
        items in flight; a straggler (engine ``deadline_s``) is reissued on
        the least-loaded target and never blocks draining of later items."""
        assert self._open, "use `with OffloadEngine(...) as eng:`"
        window = window or 2 * len(self.targets)
        payloads = list(payloads)
        stats = OffloadStats()
        results: list[tuple[int, Any]] = []
        t0 = time.monotonic()
        nxt = 0
        while nxt < len(payloads) and nxt < window:
            self.submit_async(payloads[nxt])
            nxt += 1
        for item in self.drain(len(payloads)):
            results.append((item.seq, item.result))
            stats.items += 1
            stats.reissues += int(item.reissued)
            stats.per_target[item.target_name] = \
                stats.per_target.get(item.target_name, 0) + 1
            if nxt < len(payloads):
                self.submit_async(payloads[nxt])
                nxt += 1
        stats.wall_s = time.monotonic() - t0
        return results, stats
