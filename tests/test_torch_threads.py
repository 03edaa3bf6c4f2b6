"""Worker-thread hygiene in the port, as ``tests/test_threads.py`` holds the
JAX package: every worker the stack spawns is a *named daemon* thread and
orderly shutdown leaves none behind (offload workers, a serving executor,
a crashed executor, the router's rebalance thread and its migration
workers).  Plus the kernel table's launch counters under threads: a fleet
runs one executor thread per replica, each bumping the same counters, and
``chip_smoke.py`` holds those counts exactly."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as R
from repro_torch.core.offload import OffloadEngine, SimTarget
from repro_torch.kernels import dispatch
from repro_torch.models.registry import fns_for
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import ExecutorCrash, FaultPlan, FaultSpec
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.sampler import greedy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = R.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    return cfg, fns_for(cfg).init(cfg, torch.Generator().manual_seed(0))


def _workers(before: set[int]) -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.ident not in before]


def _engine(model, **kw):
    cfg, params = model
    return ServingEngine(cfg, params, cache_dtype="float32", device="cpu",
                         **kw)


def test_offload_workers_named_daemon_and_reaped():
    before = {t.ident for t in threading.enumerate()}
    with OffloadEngine([SimTarget(f"t{i}", compute_s=0.001)
                        for i in range(2)]) as eng:
        eng.run(list(range(4)))
        spawned = _workers(before)
        assert spawned, "expected live offload workers"
        for t in spawned:
            assert t.daemon, f"offload worker {t.name!r} is non-daemon"
            assert t.name.startswith("offload-"), t.name
    for t in spawned:
        t.join(timeout=5.0)
    assert not [t for t in _workers(before) if t.is_alive()]


def test_engine_executor_named_daemon_and_reaped(model):
    cfg = model[0]
    eng = _engine(model, max_len=16, batch_slots=2)
    before = {t.ident for t in threading.enumerate()}
    eng.start()
    try:
        spawned = _workers(before)
        assert [t.name for t in spawned] == ["serving-executor"]
        assert all(t.daemon for t in spawned)
        done = threading.Event()
        prompt = np.arange(4, dtype=np.int32) % cfg.vocab_size
        eng.submit(Request(0, prompt, max_new_tokens=2, sampler=greedy()),
                   on_finish=lambda r: done.set())
        assert done.wait(timeout=60.0)
    finally:
        eng.stop()
    leftovers = [t for t in _workers(before) if t.is_alive()]
    assert not leftovers, [t.name for t in leftovers]
    for t in threading.enumerate():
        if t is threading.main_thread():
            continue
        assert t.daemon or not t.name.startswith("Thread-"), t.name


def test_crashed_executor_is_reaped_by_stop(model):
    cfg = model[0]
    plan = FaultPlan([FaultSpec("replica.executor", "raise")])
    eng = _engine(model, max_len=16, batch_slots=2, fault_plan=plan)
    before = {t.ident for t in threading.enumerate()}
    eng.start()
    failed = threading.Event()
    prompt = np.arange(4, dtype=np.int32) % cfg.vocab_size
    eng.submit(Request(0, prompt, max_new_tokens=2, sampler=greedy()),
               on_finish=lambda r: failed.set())
    assert failed.wait(timeout=60.0)
    with pytest.raises(ExecutorCrash):
        eng.stop()
    eng.stop()                                    # idempotent second stop
    leftovers = [t for t in _workers(before) if t.is_alive()]
    assert not leftovers, [t.name for t in leftovers]


def test_router_rebalance_thread_reaped_after_serve_and_stop(model):
    cfg = model[0]
    router = ReplicaRouter([_engine(model, max_len=16, batch_slots=2)
                            for _ in range(2)],
                           steal=True, steal_interval_s=0.001)
    before = {t.ident for t in threading.enumerate()}
    router._start_stealing()
    t = next(t for t in _workers(before) if t.name == "router-rebalance")
    assert t.daemon
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=8)
                    .astype(np.int32), max_new_tokens=2, sampler=greedy())
            for i in range(4)]
    router.serve(reqs)
    assert all(len(r.output) == 2 for r in reqs)
    assert not t.is_alive()           # serve()'s finally reaped it
    router.stop()
    router.stop()                                 # idempotent
    leftovers = [t for t in _workers(before) if t.is_alive()]
    assert not leftovers, [t.name for t in leftovers]


def test_migration_workers_are_named_daemons(model):
    """A disaggregated router's migration channel runs one named daemon
    worker per decode-capable replica until the router's ``close()``."""
    before = {t.ident for t in threading.enumerate()}
    kw = dict(max_len=24, batch_slots=1, block_size=8, prefill_chunk=8)
    router = ReplicaRouter([_engine(model, role="prefill", **kw),
                            _engine(model, role="decode", **kw)],
                           affinity=False, steal=False)
    spawned = _workers(before)
    assert [t.name for t in spawned] == ["offload-migrate-1"]
    assert all(t.daemon for t in spawned)
    assert len(router._mig_io.targets) == 1
    router.close()
    router.close()                                # idempotent
    leftovers = [t for t in _workers(before) if t.is_alive()]
    assert not leftovers, [t.name for t in leftovers]


# -- the kernel table's counters under threads ---------------------------------

class _YieldingCounts(dict):
    """A by-body count table that hands the interpreter to another thread
    between reading a count and writing it back -- where a thread switch
    loses an unlocked increment."""

    def get(self, *a):
        value = dict.get(self, *a)
        time.sleep(0)
        return value


def test_launch_counters_are_exact_under_threads():
    """8 threads each count 2000 launches (by two bodies) and 2000 plain
    calls on one kernel at once, with the interpreter switching threads
    every few bytecodes and inside every by-body update: the totals come
    out exact.  Without the kernel's lock the read-modify-writes lose
    increments."""
    import sys
    kern = dispatch.Kernel("probe", launch=None,
                           plain=lambda x: x, source="", replaces="",
                           tolerance=dispatch.tolerance_ratio)
    kern.body_launches = _YieldingCounts()
    x = torch.zeros(1)
    n, threads = 2000, 8
    go = threading.Barrier(threads)

    def work(k):
        go.wait()
        for i in range(n):
            kern.count_launch("mma" if (i + k) % 2 else "fma")
            kern(x)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(k,), daemon=True)
                for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert kern.launches == n * threads
    assert kern.body_launches == {"mma": n * threads // 2,
                                  "fma": n * threads // 2}
    assert kern.plain_calls == n * threads
    kern.reset_counts()
    assert (kern.launches, kern.plain_calls, kern.body_launches) == (0, 0, {})


def test_fleet_counts_every_plain_call_of_two_executors(model):
    """Two replica executors serving at once on the CPU take the kernels'
    plain versions from their own threads; the plain-call counts equal
    what the two engines' model calls make (one K2 call a layer of each
    prefill chunk, one K1 call a layer of each decode step), exactly."""
    cfg = model[0]
    engines = [_engine(model, max_len=48, batch_slots=2, prefill_chunk=16)
               for _ in range(2)]
    chunks = [0, 0]
    for i, e in enumerate(engines):
        orig = e._prefill_paged

        def counted(*a, _orig=orig, _i=i, **kw):
            chunks[_i] += 1
            return _orig(*a, **kw)
        e._prefill_paged = counted
    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=5, sampler=greedy())
            for i, n in enumerate((20, 33, 9, 40, 17, 28))]
    router = ReplicaRouter(engines, affinity=False, steal=False)
    table = dispatch.kernel_table()
    dispatch.reset_counts()
    stats = router.serve(reqs)
    router.stop()
    L = cfg.num_layers
    assert all(len(r.output) == 5 for r in reqs)
    assert table["paged_prefill_attention"].plain_calls == L * sum(chunks)
    assert table["paged_decode_attention"].plain_calls == \
        L * stats.decode_steps
    assert all(table[n].launches == 0 for n in table)
