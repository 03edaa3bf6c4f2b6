"""Deterministic, seedable fault injection for the serving stack (a copy
of ``repro/serving/faults.py``: the same sites, actions and plan syntax,
so a plan parses and fires identically on either engine).

A fleet of sub-1W co-processors fails individually by design; the paper's
deployment targets (space, edge) make faults the *expected* case rather
than the exception.  This module is the harness that lets every recovery
path in the serving stack be provoked on demand, in-process, inside CI:

  * :class:`FaultSpec` — one injection: a *site* (a named probe point in
    the stack), an *action* (raise / drop / delay), an arrival window
    (skip the first ``after`` matching arrivals, then fire ``count``
    times), and optional request-id / replica filters.
  * :class:`FaultPlan` — an ordered list of specs plus the thread-safe
    ``fire()`` probe the stack calls at each site.  Plans are plain data:
    the same plan against the same workload injects the same faults in
    the same order, so every chaos test is reproducible bit-for-bit.
  * The typed failure vocabulary (:class:`FaultError`,
    :class:`ShedError`, :class:`DeadlineExceeded`,
    :class:`ExecutorCrash`) shared by the engine and router so callers
    can distinguish an injected fault from load shedding from a deadline
    miss from a dead executor.

Probe sites (the closed vocabulary, validated at plan construction):

  ``target.compute``    offload Target worker, before execute
  ``engine.prefill``    one request's prefill chunk, before compute
  ``engine.decode``     one request's decode commit, before the token
                        lands in ``req.output``
  ``kv.spill``          tiered-KV spill transfer (drop/delay only —
                        the submit happens under pool-adjacent state,
                        so a raise would be a crash, not a fault)
  ``kv.fetch``          tiered-KV fetch transfer (drop/delay only;
                        a drop exercises the recompute fallback)
  ``kv.migrate``        prefill→decode KV-block migration transfer
                        (drop/delay only; kept so that plans parse as the
                        reference's: only a replica router fires it, and
                        the port has none yet)
  ``replica.executor``  top of one executor step — a raise here kills
                        the whole replica (the crash-capture path)

The ``drop`` action means "pretend the work silently produced nothing":
at transfer sites the result becomes a tier miss; at compute sites the
item completes with ``None``.  ``delay`` sleeps ``delay_s`` and then
proceeds — enough to trip deadlines and straggler reissue.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field


class FaultError(RuntimeError):
    """An injected fault (the ``raise`` action) at a named site."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site}"
                         + (f": {detail}" if detail else ""))
        self.site = site


class ShedError(RuntimeError):
    """Admission rejected: queue depth guarantees an SLO miss."""


class DeadlineExceeded(RuntimeError):
    """The request's ``deadline_s`` elapsed before completion."""


class ExecutorCrash(RuntimeError):
    """A replica's executor thread died on a non-request fault."""


SITES = (
    "target.compute",
    "engine.prefill",
    "engine.decode",
    "kv.spill",
    "kv.fetch",
    "kv.migrate",
    "replica.executor",
)

ACTIONS = ("raise", "drop", "delay")

# transfer sites run under pool-adjacent state where a raise would be an
# engine crash rather than an isolable per-request fault
_NO_RAISE_SITES = ("kv.spill", "kv.fetch", "kv.migrate")


@dataclass
class FaultSpec:
    """One injection: fire ``action`` on matching arrivals at ``site``,
    skipping the first ``after`` and then firing ``count`` times."""
    site: str
    action: str = "raise"
    after: int = 0
    count: int = 1
    delay_s: float = 0.0
    rid: str | None = None        # only arrivals for this request id
    replica: str | None = None    # only arrivals on this replica/engine

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites are {SITES}")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"actions are {ACTIONS}")
        if self.site in _NO_RAISE_SITES and self.action == "raise":
            raise ValueError(f"site {self.site} supports only drop/delay "
                             f"(a raise there is a crash, not a fault)")
        if self.after < 0 or self.count < 1:
            raise ValueError("after must be >= 0 and count >= 1")


@dataclass
class FaultPlan:
    """An ordered set of :class:`FaultSpec` plus the thread-safe probe.

    ``fire(site, rid=..., replica=...)`` returns the first spec whose
    filters match and whose arrival window is open, bumping the global
    ``injected`` counter; ``None`` means "no fault here".  Arrival
    counting is per-spec and global across threads (one lock), so a plan
    shared by several replicas still fires deterministically with
    respect to each spec's own arrival stream.
    """
    specs: list[FaultSpec] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._seen = [0] * len(self.specs)
        self.injected = 0          # guarded-by: self._lock

    def __bool__(self) -> bool:
        return bool(self.specs)

    def fire(self, site: str, *, rid: str | None = None,
             replica: str | None = None) -> FaultSpec | None:
        if not self.specs:
            return None
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.rid is not None and spec.rid != rid:
                    continue
                if spec.replica is not None and spec.replica != replica:
                    continue
                self._seen[i] += 1
                if spec.after < self._seen[i] <= spec.after + spec.count:
                    self.injected += 1
                    return spec
            return None

    @property
    def fired(self) -> int:
        with self._lock:
            return self.injected

    @classmethod
    def from_seed(cls, seed: int, n: int = 3,
                  sites: tuple[str, ...] = SITES,
                  max_after: int = 8, max_count: int = 2,
                  max_delay_s: float = 0.002) -> "FaultPlan":
        """A deterministic random plan: ``n`` specs over ``sites`` with
        random actions and arrival windows.  Same seed, same plan."""
        rng = random.Random(seed)
        specs: list[FaultSpec] = []
        for _ in range(n):
            site = rng.choice(sites)
            actions = [a for a in ACTIONS
                       if not (site in _NO_RAISE_SITES and a == "raise")]
            action = rng.choice(actions)
            specs.append(FaultSpec(
                site=site, action=action,
                after=rng.randrange(max_after),
                count=1 + rng.randrange(max_count),
                delay_s=rng.uniform(0.0, max_delay_s)
                if action == "delay" else 0.0))
        return cls(specs)

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """CLI syntax: ``site[:action[:after[:count]]]`` comma-separated,
        or ``seed=<int>`` for a random plan — e.g.
        ``replica.executor:raise:4,kv.fetch:drop`` or ``seed=7``."""
        text = text.strip()
        if not text:
            return cls([])
        if text.startswith("seed="):
            return cls.from_seed(int(text[5:]))
        specs = []
        for part in text.split(","):
            bits = part.strip().split(":")
            spec = FaultSpec(
                site=bits[0],
                action=bits[1] if len(bits) > 1 else "raise",
                after=int(bits[2]) if len(bits) > 2 else 0,
                count=int(bits[3]) if len(bits) > 3 else 1)
            specs.append(spec)
        return cls(specs)
