"""Fault-tolerance runtime pieces: simulated failures, heartbeats, retry
(the port's own copy of ``repro/distributed/fault.py``, which imports no
JAX; the port imports nothing of the JAX package).

On a multi-host fleet, node failure surfaces as a collective timeout or a
missing heartbeat; in one process, faults are *injected* deterministically
(by step) and the trainer demonstrates the recovery path: abort step ->
restore from the last committed checkpoint -> continue.  The same hooks are
where a deployment would plug its cluster-manager callbacks.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Mapping


class SimulatedFault(RuntimeError):
    """A node/device failure injected by the fault schedule."""

    def __init__(self, step: int, kind: str, detail: str = ""):
        super().__init__(f"simulated {kind} at step {step} {detail}")
        self.step = step
        self.kind = kind


@dataclass
class FaultSchedule:
    """step -> kind; kinds: 'crash' (lose state, restart from checkpoint),
    'device_loss' (elastic re-mesh), 'straggler' (inject delay seconds)."""

    events: Mapping[int, str] = field(default_factory=dict)
    straggler_delay: float = 0.05
    _fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        kind = self.events.get(step)
        if kind is None or step in self._fired:
            return
        self._fired.add(step)
        if kind == "straggler":
            time.sleep(self.straggler_delay)
            return
        raise SimulatedFault(step, kind)


@dataclass
class Heartbeat:
    """Deadline-based liveness check.  `beat()` every step; `stalled()` is
    what a controller would poll to decide reissue/evict (paper's analogue:
    the NCSw host thread noticing a stuck NCS device)."""

    timeout_s: float = 30.0
    _last: float = field(default_factory=time.monotonic)

    def beat(self) -> None:
        self._last = time.monotonic()

    def stalled(self) -> bool:
        return (time.monotonic() - self._last) > self.timeout_s


def with_retries(fn: Callable, *, attempts: int = 3,
                 on_fault: Callable[[SimulatedFault, int], None] | None = None):
    """Run ``fn()``, retrying after SimulatedFault up to ``attempts`` times.
    ``on_fault(fault, attempt)`` performs recovery (restore/re-mesh)."""
    last: SimulatedFault | None = None
    for attempt in range(attempts):
        try:
            return fn()
        except SimulatedFault as f:
            last = f
            if on_fault is not None:
                on_fault(f, attempt)
    raise RuntimeError(f"exhausted {attempts} retries") from last
