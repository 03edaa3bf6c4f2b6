"""The port's replica router against the JAX package: every test of
``tests/test_router.py`` mirrored on ``repro_torch``, with the steal cases
of ``tests/test_scheduler.py``, the two router tests of
``tests/test_faults.py`` and the multi-replica and wave cases of
``tests/test_serving.py``.

Where a test drives engines, the JAX fleet serves the same requests beside
the port's (``qwen2.5-3b-smoke`` at fp32, fp32 KV pools, the same weights
through ``repro_torch.interop``), and the two must agree on the greedy
tokens, the states and the counters that do not depend on thread timing:
``affinity_hits`` (placement is decided on the dispatch thread in submit
order), ``requests_failed`` and ``replica_failures``.  Steal counts,
retries beyond the first and per-replica splits depend on timing; those
tests assert only what the reference's assert."""
import dataclasses
import math
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro_torch.serving.engine as engine_mod
from repro.configs import registry as JR
from repro.models.registry import fns_for as jax_fns
from repro.serving import engine as JE
from repro.serving import faults as JF
from repro.serving import router as JRT
from repro.serving import sampler as JS
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy
from repro_torch.serving import engine as TE
from repro_torch.serving import faults as TF
from repro_torch.serving import sampler as TS
from repro_torch.serving.engine import MERGE_RULES, Request, ServeStats
from repro_torch.serving.kv_pool import KVBlockPool
from repro_torch.serving.router import (MultiReplicaEngine, ReplicaHealth,
                                        ReplicaRouter)
from repro_torch.serving.sampler import greedy
from repro_torch.serving.scheduler import (ContinuousScheduler, LoadSnapshot,
                                           RequestState)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    cfg = JR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    jp = jax_fns(cfg).init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    tcfg = TR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    return cfg, jp, tcfg, tp


def _engine(weights, jax_side: bool, **kw):
    cfg, jp, tcfg, tp = weights
    kw = dict(dict(paged=True, cache_dtype="float32"), **kw)
    if jax_side:
        return JE.ServingEngine(cfg, jp, **kw)
    return TE.ServingEngine(tcfg, tp, device="cpu", **kw)


def _both(build):
    """``build(jax_side)`` for the JAX package and for the port."""
    return build(True), build(False)


def _leak_free(eng):
    eng.drain_tier_io()
    eng.pool.assert_leak_free()


# -- ServeStats declarative merge ----------------------------------------------

def test_merge_rules_cover_every_field():
    """Bijection between ServeStats fields and MERGE_RULES (the
    reference's rules, field for field)."""
    fields = {f.name for f in dataclasses.fields(ServeStats)}
    assert set(MERGE_RULES) == fields, set(MERGE_RULES) ^ fields
    assert MERGE_RULES == JE.MERGE_RULES


def test_merge_from_missing_rule_raises(monkeypatch):
    monkeypatch.delitem(engine_mod.MERGE_RULES, "tokens")
    with pytest.raises(ValueError, match="merge rule"):
        ServeStats().merge_from(ServeStats())


def test_merge_from_semantics():
    a = ServeStats(requests=1, tokens=10, wall_s=2.0)
    a.ttft.append(0.1)
    b = ServeStats(requests=2, tokens=5, wall_s=1.0, kv_blocks_peak=7,
                   kv_pool_util=0.5)
    b.ttft.append(0.2)
    a.merge_from(b)
    assert a.requests == 3 and a.tokens == 15
    assert a.wall_s == 2.0                     # max, not sum
    assert a.ttft == [0.1, 0.2]                # extend
    assert a.kv_blocks_peak == 7               # opt_sum: None counts as 0
    assert a.kv_pool_util is None              # derived: never copied over
    c = ServeStats()
    c.merge_from(ServeStats())
    assert c.kv_blocks_peak is None            # opt_sum: all-None stays None


def test_every_derived_rule_has_a_recompute():
    derived = {k for k, v in MERGE_RULES.items() if v == "derived"}
    assert derived == set(engine_mod._DERIVED), \
        derived ^ set(engine_mod._DERIVED)


def test_merge_recomputes_derived_ratios_from_merged_counters():
    a = ServeStats(kv_blocks_peak=5, kv_pool_capacity=10, kv_pool_util=0.5,
                   spec_proposed=10, spec_accepted=9, accept_rate=0.9)
    b = ServeStats(kv_blocks_peak=1, kv_pool_capacity=30, kv_pool_util=1 / 30,
                   spec_proposed=30, spec_accepted=0, accept_rate=0.0)
    a.merge_from(b)
    assert a.kv_blocks_peak == 6 and a.kv_pool_capacity == 40
    assert a.kv_pool_util == 6 / 40            # not (0.5 + 1/30) / 2
    assert a.spec_proposed == 40 and a.spec_accepted == 9
    assert a.accept_rate == 9 / 40             # not (0.9 + 0.0) / 2
    c = ServeStats(kv_pool_util=0.7, accept_rate=0.9)
    c.merge_from(ServeStats())
    assert c.kv_pool_util is None and c.accept_rate is None


# -- placement policy (unit, fake replicas; both routers on the same fakes) ---

class _FakePool:
    capacity = 64

    def __init__(self, block_size=16):
        self.block_size = block_size

    def blocks_for(self, tokens):
        return -(-tokens // self.block_size)


class _FakeReplica:
    """Just enough surface for placement: pool, slots, block_size,
    spec_rows, load_snapshot."""
    block_size = 16
    slots = 4
    spec_rows = 0

    def __init__(self, snap: LoadSnapshot):
        self.pool = _FakePool()
        self._snap = snap

    def load_snapshot(self) -> LoadSnapshot:
        return self._snap


def _idle_snap():
    return LoadSnapshot(free_slots=4, free_blocks=64, queued=0,
                        queued_tokens=0)


def _req(rid, prompt, n=4):
    return Request(rid, np.asarray(prompt, np.int32), max_new_tokens=n,
                   sampler=greedy())


def _jreq(rid, prompt, n=4):
    return JE.Request(rid, np.asarray(prompt, np.int32), max_new_tokens=n,
                      sampler=JS.greedy())


def test_affinity_routes_to_prefix_owner():
    picks = {}
    for side, (Router, mk) in {"jax": (JRT.ReplicaRouter, _jreq),
                               "port": (ReplicaRouter, _req)}.items():
        reps = [_FakeReplica(_idle_snap()), _FakeReplica(_idle_snap())]
        router = Router(reps, steal=False)
        prefix = np.arange(32, dtype=np.int32)          # 2 full blocks
        owner = router._select(mk(0, prefix))
        follow = mk(1, np.concatenate([prefix,
                                       np.arange(100, 108, dtype=np.int32)]))
        assert router._select(follow) == owner
        assert router.stats.affinity_hits == 1
        assert router.stats.affinity_blocks == 2        # deepest digest won
        other = router._select(mk(2, np.arange(200, 232, dtype=np.int32)))
        assert router.stats.affinity_hits == 1
        picks[side] = (owner, other)
    assert picks["port"] == picks["jax"]


def test_block_aware_score_beats_request_count():
    starved = _FakeReplica(LoadSnapshot(free_slots=2, free_blocks=0,
                                        queued=0, queued_tokens=0))
    healthy = _FakeReplica(LoadSnapshot(free_slots=1, free_blocks=32,
                                        queued=2, queued_tokens=24))
    req = _req(0, np.arange(16), n=16)                  # needs 2 blocks
    router = ReplicaRouter([starved, healthy], affinity=False, steal=False)
    assert router._select(req) == 1                     # blocks win
    legacy = MultiReplicaEngine([starved, healthy])
    assert legacy._select(req) == 0                     # count loses
    jreq = _jreq(0, np.arange(16), n=16)
    assert JRT.ReplicaRouter([starved, healthy], affinity=False,
                             steal=False)._select(jreq) == 1
    assert JRT.MultiReplicaEngine([starved, healthy])._select(jreq) == 0


def test_affinity_falls_back_when_owner_saturated():
    reps = [_FakeReplica(_idle_snap()), _FakeReplica(_idle_snap())]
    router = ReplicaRouter(reps, steal=False, affinity_queue_cap=2)
    prefix = np.arange(32, dtype=np.int32)
    owner = router._select(_req(0, prefix))
    reps[owner]._snap = LoadSnapshot(free_slots=0, free_blocks=64,
                                     queued=2, queued_tokens=80)
    assert router._select(_req(1, prefix)) != owner
    assert router.stats.affinity_fallbacks == 1


def test_affinity_fallback_trips_on_queue_depth_alone():
    reps = [_FakeReplica(_idle_snap()), _FakeReplica(_idle_snap())]
    router = ReplicaRouter(reps, steal=False, affinity_queue_cap=3)
    prefix = np.arange(32, dtype=np.int32)
    owner = router._select(_req(0, prefix))
    reps[owner]._snap = LoadSnapshot(free_slots=1, free_blocks=0,
                                     queued=3, queued_tokens=120)
    assert router._select(_req(1, prefix)) != owner
    assert router.stats.affinity_fallbacks == 1


def test_steal_filter_uses_thief_geometry():
    thief = _FakeReplica(_idle_snap())
    thief.max_len = 20
    ok = ReplicaRouter._thief_can_take(thief, thief.load_snapshot())
    assert ok(_req(0, np.arange(8), n=8))           # 15 rows <= max_len
    assert not ok(_req(1, np.arange(16), n=16))     # 31 rows: never fits
    thief2 = _FakeReplica(LoadSnapshot(free_slots=1, free_blocks=1,
                                       queued=0, queued_tokens=0))
    thief2.max_len = 64
    ok2 = ReplicaRouter._thief_can_take(thief2, thief2.load_snapshot())
    assert ok2(_req(2, np.arange(8), n=8))          # 15 rows -> 1 block
    assert not ok2(_req(3, np.arange(16), n=16))    # 31 rows -> 2 blocks


def test_mismatched_block_sizes_reject_affinity():
    a, b = _FakeReplica(_idle_snap()), _FakeReplica(_idle_snap())
    b.block_size = 32
    with pytest.raises(ValueError, match="block size"):
        ReplicaRouter([a, b])
    ReplicaRouter([a, b], affinity=False)               # load-only is fine


# -- real engines: fleet-wide seeding, stealing, shim --------------------------

def _prefix_reqs(mod, smod, vocab, n, seed, new_tokens=2, tail=8):
    """n requests over one 2-block (32-token) common prefix with distinct
    tails."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=32).astype(np.int32)
    return [mod.Request(i, np.concatenate(
                [prefix, rng.integers(0, vocab, size=tail).astype(np.int32)]),
                max_new_tokens=new_tokens, sampler=smod.greedy())
            for i in range(n)]


def test_router_affinity_seeds_fleet_wide_and_matches_single(weights):
    """Same-prefix requests land on one replica (affinity), seed its
    prefix blocks instead of recomputing, and still produce exactly the
    single-replica greedy outputs -- the JAX fleet's too."""
    vocab = weights[0].vocab_size
    kw = dict(max_len=43, batch_slots=3)
    out = {}
    for jax_side, (mod, smod, Router) in ((True, (JE, JS, JRT.ReplicaRouter)),
                                          (False, (TE, TS, ReplicaRouter))):
        router = Router([_engine(weights, jax_side, **kw),
                         _engine(weights, jax_side, **kw)], steal=False)
        reqs = _prefix_reqs(mod, smod, vocab, 3, seed=5)
        stats = router.serve(reqs)
        router.stop()
        out[jax_side] = (reqs, stats)
    treqs, tstats = out[False]
    jreqs, jstats = out[True]
    ref = _prefix_reqs(TE, TS, vocab, 3, seed=5)
    _engine(weights, False, **kw).serve(ref)
    assert [r.output for r in treqs] == [r.output for r in ref]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert tstats.router_affinity_hits >= 2             # followers hit
    assert tstats.router_affinity_hits == jstats.router_affinity_hits
    assert tstats.prefill_tokens_computed < tstats.prefill_tokens_total
    assert len(tstats.ttft) == 3 and tstats.tokens == 6


def test_rebalance_once_moves_backlog_to_idle(weights):
    """Deterministic steal path (no threads): an idle replica pulls exactly
    one queued request from the backlogged peer, on both packages; TTFT
    keeps measuring from the original submission."""
    vocab = weights[0].vocab_size
    for jax_side, (mod, smod, Router) in ((True, (JE, JS, JRT.ReplicaRouter)),
                                          (False, (TE, TS, ReplicaRouter))):
        a, b = (_engine(weights, jax_side, max_len=43, batch_slots=1)
                for _ in range(2))
        router = Router([a, b], steal=True)
        reqs = _prefix_reqs(mod, smod, vocab, 3, seed=7)
        for r in reqs:
            a.scheduler.submit(r)
        stamps = [r.submitted_at for r in reqs]
        a.scheduler.admit()                 # head takes A's only slot
        assert a.scheduler.queued == 2 and b.scheduler.queued == 0
        assert router._rebalance_once() == 1
        assert a.scheduler.queued == 1 and b.scheduler.queued == 1
        assert router.stats.steals == 1
        assert [r.submitted_at for r in reqs] == stamps
        b.scheduler.admit()
        assert router._rebalance_once() == 0


def test_router_steals_under_live_backlog(weights):
    """End to end: affinity piles a shared-prefix burst onto one 1-slot
    replica; the stealing thread moves queued requests to the idle peer and
    every request still completes with full output, the JAX fleet's
    tokens."""
    vocab = weights[0].vocab_size
    out = {}
    for jax_side, (mod, smod, Router) in ((True, (JE, JS, JRT.ReplicaRouter)),
                                          (False, (TE, TS, ReplicaRouter))):
        router = Router([_engine(weights, jax_side, max_len=43,
                                 batch_slots=1) for _ in range(2)],
                        steal=True, steal_interval_s=0.001)
        reqs = _prefix_reqs(mod, smod, vocab, 6, seed=9, new_tokens=4)
        stats = router.serve(reqs)
        router.stop()
        out[jax_side] = (reqs, stats)
    reqs, stats = out[False]
    assert all(len(r.output) == 4 for r in reqs)
    assert stats.router_steals >= 1
    assert stats.tokens == 24 and len(stats.ttft) == 6
    assert [r.output for r in reqs] == [r.output for r in out[True][0]]


def test_engine_module_shim_warns():
    from repro_torch.serving import router
    with pytest.warns(DeprecationWarning, match="moved to"):
        cls = engine_mod.MultiReplicaEngine
    assert cls is router.MultiReplicaEngine
    with pytest.warns(DeprecationWarning):
        assert engine_mod.ReplicaTarget is router.ReplicaTarget
    with pytest.raises(AttributeError):
        engine_mod.not_a_thing


# -- scheduler work stealing (tests/test_scheduler.py) -------------------------

def _sreq(rid, n=4, **kw):
    return Request(rid, np.arange(6, dtype=np.int32), max_new_tokens=n, **kw)


def test_steal_takes_back_of_queue_and_preserves_order():
    s = ContinuousScheduler(1)
    reqs = [_sreq(0, priority=2), _sreq(1, priority=0), _sreq(2, priority=1),
            _sreq(3, priority=0)]
    for r in reqs:
        s.submit(r)
    got = s.steal(max_items=2)
    assert [r.rid for r in got] == [3, 1]               # latest arrival first
    assert all(r.arrival_seq is None for r in got)      # thief re-seqs
    order = []
    while s.has_work():
        [(slot, r)] = s.admit()
        r.state = RequestState.DONE
        s.release(slot)
        order.append(r.rid)
    assert order == [0, 2]                              # head untouched


def test_steal_respects_thief_admission_filter():
    pool = KVBlockPool(16, block_size=4)
    s = ContinuousScheduler(1, pool=pool)
    head = _sreq(0, n=3)
    big = Request(1, np.arange(8, dtype=np.int32), max_new_tokens=17)
    tail = _sreq(2, n=3)
    for r in (head, big, tail):
        s.submit(r)
    assert s.steal(max_items=3,
                   can_take=lambda r: -(-r.kv_rows // 4) <= 1) == []
    got = s.steal(max_items=3,
                  can_take=lambda r: -(-r.kv_rows // 4) <= 2)
    assert [r.rid for r in got] == [2]
    assert s.steal(max_items=1,
                   can_take=lambda r: -(-r.kv_rows // 4) <= 2) == []
    assert s.queued == 2                        # head + big stayed


def test_steal_protects_head_unless_sole_entry():
    s = ContinuousScheduler(1)
    s.submit(_sreq(0))
    s.submit(_sreq(1))
    assert [r.rid for r in s.steal(max_items=5)] == [1]
    assert s.queued == 1
    assert [r.rid for r in s.steal(max_items=5)] == [0]
    assert s.queued == 0


def test_steal_preserves_submitted_at_for_ttft():
    donor, thief = ContinuousScheduler(1), ContinuousScheduler(1)
    donor.submit(_sreq(0))
    r = _sreq(1)
    donor.submit(r)
    stamped = r.submitted_at
    assert stamped is not None
    time.sleep(0.02)
    [stolen] = donor.steal()
    assert stolen is r
    thief.submit(stolen)
    assert stolen.submitted_at == stamped       # the move is TTFT-neutral
    stolen.first_token_at = stamped + 1.0
    assert stolen.ttft_s == 1.0


def test_property_steal_partitions_and_orders():
    """Property (needs hypothesis, as the reference's): stealing never
    duplicates or loses a request, and both heaps drain in (priority,
    SLO deadline) order with ``submitted_at``, priority and SLO kept."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, strategies as st

    spec = st.tuples(st.integers(0, 3),
                     st.one_of(st.none(), st.floats(0.01, 10.0)))

    @given(st.lists(spec, min_size=1, max_size=10),
           st.lists(spec, min_size=0, max_size=6),
           st.integers(0, 10))
    def prop(donor_specs, thief_specs, k):
        donor, thief = ContinuousScheduler(1), ContinuousScheduler(1)
        all_reqs = {}
        for i, (pri, slo) in enumerate(donor_specs):
            r = _sreq(i, priority=pri, slo_ttft_s=slo)
            r.submitted_at = float(i)
            donor.submit(r)
            all_reqs[i] = r
        for i, (pri, slo) in enumerate(thief_specs):
            r = _sreq(100 + i, priority=pri, slo_ttft_s=slo)
            r.submitted_at = float(100 + i)
            thief.submit(r)
            all_reqs[100 + i] = r
        stamps = {rid: r.submitted_at for rid, r in all_reqs.items()}
        for r in donor.steal(max_items=k):
            thief.submit(r)

        def drain(s):
            out = []
            while s.has_work():
                [(slot, r)] = s.admit()
                r.state = RequestState.DONE
                s.release(slot)
                out.append(r)
            return out

        def key(r):
            dl = (r.submitted_at + r.slo_ttft_s
                  if r.slo_ttft_s is not None else math.inf)
            return (-r.priority, dl)

        d, t = drain(donor), drain(thief)
        assert sorted(r.rid for r in d + t) == sorted(all_reqs)
        for r in d + t:
            assert r.submitted_at == stamps[r.rid]
        assert [key(r) for r in d] == sorted(key(r) for r in d)
        assert [key(r) for r in t] == sorted(key(r) for r in t)

    prop()


# -- replica quarantine + retry (tests/test_faults.py) -------------------------

def _reqs(mod, smod, vocab, n, seed=0, prompt_len=9, new_tokens=4):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(0, vocab, size=prompt_len)
                        .astype(np.int32),
                        max_new_tokens=new_tokens, sampler=smod.greedy())
            for i in range(n)]


def test_replica_death_quarantines_and_retries_bit_identical(weights):
    """One of two replicas crashes mid-serve: every request still
    completes with the no-fault tokens, the dead replica is quarantined,
    both pools drain leak-free -- and the JAX fleet agrees on the states,
    tokens, ``requests_failed`` and ``replica_failures``."""
    vocab = weights[0].vocab_size
    ref = _reqs(TE, TS, vocab, 6, seed=10)
    _engine(weights, False, max_len=16, batch_slots=2).serve(ref)
    out = {}
    for jax_side, (mod, smod, fmod, Router) in (
            (True, (JE, JS, JF, JRT.ReplicaRouter)),
            (False, (TE, TS, TF, ReplicaRouter))):
        plan = fmod.FaultPlan([fmod.FaultSpec("replica.executor", "raise",
                                              after=2, replica="replica0")])
        replicas = [_engine(weights, jax_side, max_len=16, batch_slots=2,
                            name=f"replica{i}", fault_plan=p)
                    for i, p in enumerate((plan, None))]
        router = Router(replicas, steal=True, steal_interval_s=0.001,
                        affinity=False)
        reqs = _reqs(mod, smod, vocab, 6, seed=10)
        stats = router.serve(reqs)
        health = [h.value for h in router.health()]
        router.stop()
        out[jax_side] = (reqs, stats, health)
        if not jax_side:
            for e in replicas:
                _leak_free(e)
    (treqs, tst, th), (jreqs, jst, jh) = out[False], out[True]
    assert all(r.state is RequestState.DONE for r in treqs)
    assert [r.output for r in treqs] == [r.output for r in ref]
    assert tst.requests_failed == 0
    assert tst.requests_retried >= 1
    assert tst.replica_failures == 1
    assert th[0] == ReplicaHealth.DEAD.value and th[1] != "dead"
    assert [r.state.value for r in treqs] == [r.state.value for r in jreqs]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert (tst.requests_failed, tst.replica_failures) == \
        (jst.requests_failed, jst.replica_failures)
    assert th == jh


def _crash_after_submits(eng, k: int) -> None:
    """Fix where a one-replica fleet's crash falls among its submits: the
    executor's first step, at whose top ``replica.executor`` fires, waits
    until ``k`` submits have returned, and every later submit waits until
    the crash is recorded.  A request queued before the crash is failed by
    the crash capture with the fault's own error (``FaultError``); one
    submitted after it is refused with ``ExecutorCrash`` -- on both sides.
    Left to the threads, the third request's side of that line is a race
    on each side, and the two sides' types could differ."""
    queued = threading.Event()
    done = [0]
    step, submit = eng._step, eng.submit

    def gated_step():
        assert queued.wait(timeout=30)
        return step()

    def gated_submit(req, on_finish=None):
        if done[0] >= k:
            deadline = time.monotonic() + 30
            while eng.failure is None:
                assert time.monotonic() < deadline
                time.sleep(0.001)
        try:
            return submit(req, on_finish=on_finish)
        finally:
            done[0] += 1
            if done[0] == k:
                queued.set()

    eng._step = gated_step
    eng.submit = gated_submit


def _dead_fleet(weights, jax_side: bool, crash_after: int):
    """Three requests through a one-replica router whose executor raises at
    its first step, ``crash_after`` of them queued before it does: (error
    type names, requests_failed, health)."""
    mod, smod, fmod, Router = ((JE, JS, JF, JRT.ReplicaRouter) if jax_side
                               else (TE, TS, TF, ReplicaRouter))
    plan = fmod.FaultPlan([fmod.FaultSpec("replica.executor", "raise")])
    eng = _engine(weights, jax_side, max_len=16, batch_slots=2,
                  name="replica0", fault_plan=plan)
    _crash_after_submits(eng, crash_after)
    router = Router([eng], steal=False, max_retries=1)
    reqs = _reqs(mod, smod, weights[0].vocab_size, 3, seed=11)
    stats = router.serve(reqs)
    health = [h.value for h in router.health()]
    router.stop()
    router.stop()                        # idempotent fleet teardown
    if not jax_side:
        _leak_free(eng)
        assert all(r.state is RequestState.FAILED and r.error is not None
                   for r in reqs)
    return [type(r.error).__name__ for r in reqs], stats.requests_failed, health


def test_whole_fleet_dead_fails_typed_never_hangs(weights):
    """The whole fleet dies with all three requests queued: each fails
    typed, with the JAX fleet's error types, failure count and health."""
    port = _dead_fleet(weights, False, crash_after=3)
    assert port == _dead_fleet(weights, True, crash_after=3)
    assert port == (["FaultError"] * 3, 3, [ReplicaHealth.DEAD.value])


@pytest.mark.parametrize("crash_after", [1, 2])
def test_whole_fleet_dead_error_type_follows_the_crash_point(weights, crash_after):
    """Requests queued before the executor's crash fail with the fault's
    error, later ones are refused with ``ExecutorCrash``, on both sides.
    ``crash_after=2`` is the order that made the comparison flicker when
    one side's third request landed after the crash and the other's
    before it."""
    port = _dead_fleet(weights, False, crash_after)
    want = ["FaultError"] * crash_after + ["ExecutorCrash"] * (3 - crash_after)
    assert port == _dead_fleet(weights, True, crash_after)
    assert port == (want, 3, [ReplicaHealth.DEAD.value])


# -- multi-replica and wave serving (tests/test_serving.py) --------------------

def test_wave_path_matches_continuous(weights):
    """The lock-step wave decode (K4 prefill of a wave, K3 decode on bf16
    contiguous caches) gives the continuous engine's greedy tokens, and
    the JAX engine's ``serve_wave`` tokens and step counts."""
    vocab = weights[0].vocab_size
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, size=8).astype(np.int32)
               for _ in range(4)]

    def mk(mod, smod):
        return [mod.Request(i, p, max_new_tokens=3, sampler=smod.greedy())
                for i, p in enumerate(prompts)]
    jeng, teng = _both(lambda j: _engine(weights, j, max_len=12,
                                         batch_slots=2))
    cont, wave, jwave = mk(TE, TS), mk(TE, TS), mk(JE, JS)
    teng.serve(cont)
    tst = teng.serve_wave(wave)
    jst = jeng.serve_wave(jwave)
    assert [r.output for r in cont] == [r.output for r in wave]
    assert [r.output for r in wave] == [r.output for r in jwave]
    assert (tst.prefills, tst.decode_steps, tst.tokens) == \
        (jst.prefills, jst.decode_steps, jst.tokens) == (2, 4, 12)
    assert all(r.state is RequestState.DONE for r in wave)


def test_wave_path_buckets_by_length_and_matches_jax(weights):
    """Prompts of two lengths and unequal budgets: one wave per length
    bucket and slot group, a finished member idling until its wave ends,
    the JAX engine's tokens, occupancy and shapes."""
    vocab = weights[0].vocab_size
    rng = np.random.default_rng(4)
    lens, news = (6, 9, 6, 9, 6), (2, 4, 3, 1, 4)
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]

    def mk(mod, smod):
        return [mod.Request(i, p, max_new_tokens=m, sampler=smod.greedy())
                for i, (p, m) in enumerate(zip(prompts, news))]
    jeng, teng = _both(lambda j: _engine(weights, j, max_len=16,
                                         batch_slots=2))
    treqs, jreqs = mk(TE, TS), mk(JE, JS)
    tst = teng.serve_wave(treqs)
    jst = jeng.serve_wave(jreqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [len(r.output) for r in treqs] == list(news)
    for name in ("prefills", "decode_steps", "tokens", "occupancy_sum",
                 "prefill_compiles"):
        assert getattr(tst, name) == getattr(jst, name), name


def test_wave_path_equals_the_contiguous_engine_on_bf16_caches(weights):
    """The waves keep their caches in bf16 whatever ``cache_dtype`` says
    (as the reference's ``fns.prefill``), so on an fp32 model their tokens
    are the contiguous engine's on bf16 caches -- the comparison the card's
    fp32 gate makes -- where an fp32 paged pool may part from them."""
    from repro_torch.models.transformer import KVCache
    vocab = weights[0].vocab_size
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, size=64).astype(np.int32)
               for _ in range(8)]

    def mk():
        return [Request(i, p, max_new_tokens=12, sampler=greedy())
                for i, p in enumerate(prompts)]
    wave, cont = mk(), mk()
    _engine(weights, False, max_len=80, batch_slots=4,
            prefill_chunk=32).serve_wave(wave)
    eng = _engine(weights, False, paged=False, max_len=80, batch_slots=4,
                  cache_dtype="bfloat16")
    eng.serve(cont)
    assert isinstance(eng._state, KVCache)
    assert eng._state.k.dtype == torch.bfloat16
    assert [r.output for r in wave] == [r.output for r in cont]


def test_rejects_request_exceeding_kv_capacity(weights):
    eng = _engine(weights, False, max_len=10, batch_slots=2)
    too_big = Request(0, np.arange(8, dtype=np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="KV capacity"):
        eng.serve([too_big])
    with pytest.raises(ValueError, match="KV capacity"):
        eng.submit(too_big)
    with pytest.raises(ValueError, match="KV capacity"):
        eng.serve_wave([too_big])
    ok = Request(1, np.arange(8, dtype=np.int32), max_new_tokens=3)
    assert eng.serve([ok]).tokens == 3


def test_multireplica_counts(weights):
    out = {}
    for jax_side, (mod, Multi) in ((True, (JE, JRT.MultiReplicaEngine)),
                                   (False, (TE, MultiReplicaEngine))):
        replicas = [_engine(weights, jax_side, max_len=12, batch_slots=2)
                    for _ in range(2)]
        reqs = [mod.Request(i, np.arange(6, dtype=np.int32),
                            max_new_tokens=3) for i in range(6)]
        out[jax_side] = (reqs, Multi(replicas).serve(reqs))
    reqs, stats = out[False]
    assert stats.tokens == 18
    assert stats.requests == 6
    assert all(len(r.output) == 3 for r in reqs)
    assert stats.prefills == 6
    assert [r.output for r in reqs] == [r.output for r in out[True][0]]


def test_multireplica_aggregates_paged_pool_stats(weights):
    replicas = [_engine(weights, False, max_len=16, batch_slots=2)
                for _ in range(2)]
    reqs = [Request(i, np.arange(6, dtype=np.int32), max_new_tokens=3)
            for i in range(6)]
    stats = MultiReplicaEngine(replicas).serve(reqs)
    assert stats.kv_blocks_peak is not None and stats.kv_blocks_peak >= 1
    assert stats.kv_blocks_peak <= sum(e.pool.capacity for e in replicas)
    assert 0.0 < stats.kv_pool_util <= 1.0
    assert len(stats.ttft) == 6


# -- the launcher's fleet and wave flags on the CPU ----------------------------

def _launch(main, monkeypatch, capsys, *args):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen2.5-3b",
                                     "--smoke", "--requests", "6",
                                     "--new-tokens", "4", *args])
    assert main() == 0
    return capsys.readouterr().out


def _line(out, head):
    return next((ln for ln in out.splitlines() if ln.startswith(head)), None)


@pytest.mark.parametrize("args", [
    ("--replicas", "2"),
    ("--replicas", "2", "--replica-roles", "prefill,decode"),
    ("--replicas", "2", "--no-affinity", "--no-steal"),
    ("--mode", "wave"),
    ("--replicas", "2", "--inject-faults", "replica.executor:raise:4",
     "--max-retries", "2", "--hipri-every", "2", "--slo-ttft-ms", "60000"),
], ids=["fleet", "disagg", "no-affinity-no-steal", "wave", "faults-hipri"])
def test_serve_launcher_fleet_and_wave_on_the_cpu(capsys, monkeypatch, args):
    """``--replicas``, ``--replica-roles``, ``--no-affinity``,
    ``--no-steal``, ``--max-retries``, ``--mode wave``, ``--hipri-every``
    and ``--slo-ttft-ms`` on the CPU: the port's launcher prints the
    reference launcher's lines for them, equal where what they count
    follows from the prompts and the flags (the request and token counts,
    the affinity hits, the ``disagg:`` line, the failed count); steals and
    retries depend on thread timing and only their presence is held."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    tout = _launch(tserve.main, monkeypatch, capsys, "--device", "cpu", *args)
    jout = _launch(jserve.main, monkeypatch, capsys, *args)
    count = lambda out: _line(out, "requests=").split(" wall=")[0]  # noqa
    assert count(tout) == count(jout) == "requests=6 tokens=24"
    fleet = "--replicas" in args
    for head in ("router:", "disagg:", "faults:", "preemptions="):
        assert (_line(tout, head) is None) == (_line(jout, head) is None), \
            head
    assert (_line(tout, "router:") is not None) == fleet
    if fleet:
        hits = lambda out: _line(out, "router:").split("  ")[0]  # noqa
        assert hits(tout) == hits(jout) == "router: affinity_hits=0"
    assert _line(tout, "disagg:") == _line(jout, "disagg:")
    if "--replica-roles" in args:
        assert _line(tout, "disagg:") == "disagg: migrations=6  " \
                                         "migrated_blocks=6"
    if "--inject-faults" in args:
        assert "failed=0" in _line(tout, "faults:")
        assert "replica_failures=1" in _line(tout, "faults:")
        assert _line(tout, "preemptions=").endswith("slo_miss_rate=0.00")
    if "--no-steal" in args:
        assert _line(tout, "router:") == _line(jout, "router:")


@pytest.mark.parametrize("args", [
    ("--mode", "wave", "--replicas", "2"),
    ("--replicas", "2", "--replica-roles", "prefill"),
    ("--replica-roles", "prefill"),
], ids=["wave-with-replicas", "role-count", "roles-on-one-replica"])
def test_serve_launcher_refuses_what_the_reference_refuses(monkeypatch,
                                                           capsys, args):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    for main, extra in ((tserve.main, ("--device", "cpu")),
                        (jserve.main, ())):
        monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen2.5-3b",
                                         "--smoke", *extra, *args])
        with pytest.raises(SystemExit) as exc:
            main()
        assert exc.value.code == 2
    err = capsys.readouterr().err
    assert err.count("error:") == 2
