"""The port's fault tolerance against the JAX package: every test of
``tests/test_faults.py`` but the two replica-router ones (those are in
``tests/test_torch_router.py``), mirrored on ``repro_torch``.  Where a test drives an engine, the JAX engine runs the
same requests under the same plan (``qwen2.5-3b-smoke`` at fp32, an fp32
KV pool, the same weights through ``repro_torch.interop``), and the two
must end in equal states, equal outputs and equal counters:
``requests_failed``, ``faults_injected``, ``kv_spills``, ``kv_fetches``,
``prefix_hits_host``, ``spill_bytes`` and ``prefill_tokens_computed``.

* FaultPlan / FaultSpec: validation, arrival windows and filters, seeded
  plans equal to the reference's, the CLI syntax.
* The offload layer's ``target.compute`` drop and a raising target.
* Poison isolation (``engine.prefill`` / ``engine.decode`` raise one
  request; also under speculative decoding, where the failed slot's
  drafter mirror is dropped and its provisional blocks freed).
* ``kv.spill`` / ``kv.fetch`` drops on churn traffic through a tiered
  pool: outputs equal the no-fault run's, nothing leaks.
* Seeded chaos plans over the request-level and transfer sites.
* Deadlines, load shedding.
* Crash capture: blocking ``serve`` fails every queued and active request
  and frees their blocks (``replica.executor:raise:N``; the port used to
  leave them non-terminal and allocated), service mode surfaces the crash
  through ``stop()`` exactly once.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models.registry import fns_for as jax_fns
from repro.serving import engine as JE
from repro.serving import faults as JF
from repro.serving import sampler as JS
from repro_torch.configs import registry as TR
from repro_torch.core.offload import OffloadEngine, SimTarget, WorkError
from repro_torch.interop import params_from_numpy
from repro_torch.serving import engine as TE
from repro_torch.serving import faults as TF
from repro_torch.serving import sampler as TS
from repro_torch.serving.faults import (SITES, DeadlineExceeded,
                                        ExecutorCrash, FaultError, FaultPlan,
                                        FaultSpec, ShedError)
from repro_torch.serving.scheduler import RequestState

torch.set_num_threads(1)

# the counters a fault or tier run must reproduce exactly
FAULT_COUNTERS = ("requests_failed", "faults_injected", "kv_spills",
                  "kv_fetches", "prefix_hits_host", "spill_bytes",
                  "prefill_tokens_computed")


@pytest.fixture(scope="module")
def weights():
    cfg = JR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    jp = jax_fns(cfg).init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    tcfg = TR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    return cfg, jp, tcfg, tp


def _reqs(mod, smod, vocab, n, seed=0, prompt_len=9, new_tokens=4, **kw):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(0, vocab, size=prompt_len)
                        .astype(np.int32),
                        max_new_tokens=new_tokens, sampler=smod.greedy(), **kw)
            for i in range(n)]


def _churn_reqs(mod, smod, vocab, seed=5):
    """3 distinct 2-block prefixes revisited with fresh tails out of a
    5-block pool: every revisit finds its prefix demoted to the host
    tier, so spills and fetches both flow."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, size=16).astype(np.int32)
                for _ in range(3)]
    reqs = []
    for v in range(2):
        for g, p in enumerate(prefixes):
            tail = rng.integers(0, vocab, size=4).astype(np.int32)
            reqs.append(mod.Request(v * 3 + g, np.concatenate([p, tail]),
                                    max_new_tokens=3, sampler=smod.greedy()))
    return reqs


def _engines(weights, plans=(None, None), **kw):
    """A JAX engine and the port's on the same weights, fp32 pool."""
    cfg, jp, tcfg, tp = weights
    kw = dict(dict(paged=True, cache_dtype="float32"), **kw)
    jeng = JE.ServingEngine(cfg, jp, fault_plan=plans[0], **kw)
    teng = TE.ServingEngine(tcfg, tp, fault_plan=plans[1], device="cpu", **kw)
    return jeng, teng


def _assert_leak_free(eng):
    eng.drain_tier_io()
    eng.pool.assert_leak_free()


def _assert_same(jeng, teng, jreqs, treqs):
    """Equal states, outputs, error types and fault/tier counters."""
    assert [r.state.value for r in treqs] == [r.state.value for r in jreqs]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [type(r.error).__name__ for r in treqs] == \
        [type(r.error).__name__ for r in jreqs]
    for name in FAULT_COUNTERS:
        assert getattr(teng.totals, name) == getattr(jeng.totals, name), name


def _plans(build):
    """The same plan built from each package's faults module."""
    return build(JF), build(TF)


# -- FaultPlan unit semantics --------------------------------------------------

def test_fault_spec_validates_site_action_and_window():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("engine.nonsense")
    with pytest.raises(ValueError, match="unknown fault action"):
        FaultSpec("engine.decode", "explode")
    with pytest.raises(ValueError, match="only drop/delay"):
        FaultSpec("kv.fetch", "raise")
    with pytest.raises(ValueError, match="after must be"):
        FaultSpec("engine.decode", count=0)
    assert SITES == JF.SITES and TF.ACTIONS == JF.ACTIONS


def test_fault_plan_arrival_window_and_filters():
    plan = FaultPlan([FaultSpec("engine.decode", "drop", after=2, count=2),
                      FaultSpec("engine.prefill", "raise", rid=7)])
    # arrivals 1,2 skipped; 3,4 fire; 5+ closed
    hits = [plan.fire("engine.decode") is not None for _ in range(6)]
    assert hits == [False, False, True, True, False, False]
    # rid filter: only request 7's arrivals count at all
    assert plan.fire("engine.prefill", rid=3) is None
    assert plan.fire("engine.prefill", rid=7) is not None
    assert plan.fire("engine.prefill", rid=7) is None   # window spent
    assert plan.fired == 3
    assert not FaultPlan([]) and plan


def _spec_tuple(s):
    return (s.site, s.action, s.after, s.count, s.delay_s, s.rid, s.replica)


def test_fault_plan_from_seed_deterministic_and_valid():
    a, b = FaultPlan.from_seed(11, n=5), FaultPlan.from_seed(11, n=5)
    assert a.specs == b.specs
    assert FaultPlan.from_seed(12, n=5).specs != a.specs
    for spec in a.specs:       # every generated spec passes validation
        assert spec.site in SITES
    for seed in range(8):      # the reference's plan for the same seed
        assert [_spec_tuple(s) for s in FaultPlan.from_seed(seed).specs] == \
            [_spec_tuple(s) for s in JF.FaultPlan.from_seed(seed).specs]


def test_fault_plan_parse():
    plan = FaultPlan.parse("replica.executor:raise:4,kv.fetch:drop")
    assert [(s.site, s.action, s.after) for s in plan.specs] == \
        [("replica.executor", "raise", 4), ("kv.fetch", "drop", 0)]
    assert FaultPlan.parse("seed=7").specs == FaultPlan.from_seed(7).specs
    assert not FaultPlan.parse("").specs
    with pytest.raises(ValueError):
        FaultPlan.parse("kv.spill:raise")
    text = "kv.spill:drop:1:2,kv.fetch:drop:1:2,engine.decode:raise:40:1"
    assert [_spec_tuple(s) for s in FaultPlan.parse(text).specs] == \
        [_spec_tuple(s) for s in JF.FaultPlan.parse(text).specs]


# -- offload-layer faults (target.compute) -------------------------------------

def test_target_fault_hook_drops_compute():
    plan = FaultPlan([FaultSpec("target.compute", "drop", count=1)])
    tgt = SimTarget("t0", compute_s=0.0)
    tgt.fault_hook = lambda item: plan.fire("target.compute") is not None
    with OffloadEngine([tgt]) as eng:
        results, _ = eng.run(list(range(3)))
    # exactly one unit of work was silently dropped (completed as None)
    assert plan.fired == 1
    assert sorted(r is None for r in results) == [False, False, True]


def test_target_worker_exception_commits_workerror_not_thread_death():
    class Exploding(SimTarget):
        def execute(self, staged):
            raise RuntimeError("boom")
    with OffloadEngine([Exploding("t0", compute_s=0.0)]) as eng:
        item = eng.submit_async("x")
        done = eng.next_done(timeout=5.0)
    assert done is item and isinstance(item.result, WorkError)
    assert "boom" in str(item.result.error)
    assert item.failures == 1


# -- poison-request isolation --------------------------------------------------

@pytest.mark.parametrize("site", ["engine.prefill", "engine.decode"])
def test_poisoned_request_fails_alone(weights, site):
    """A raise inside one request's prefill chunk or decode commit fails
    that request only: peers finish with the no-fault outputs, the pool
    drains leak-free, and the JAX engine agrees on everything."""
    cfg = weights[0]
    _, ref_eng = _engines(weights, max_len=16, batch_slots=2)
    ref = _reqs(TE, TS, cfg.vocab_size, 3, seed=2)
    ref_eng.serve(ref)
    jplan, tplan = _plans(lambda m: m.FaultPlan([m.FaultSpec(site, "raise",
                                                             rid=1)]))
    jeng, teng = _engines(weights, (jplan, tplan), max_len=16, batch_slots=2)
    jreqs = _reqs(JE, JS, cfg.vocab_size, 3, seed=2)
    treqs = _reqs(TE, TS, cfg.vocab_size, 3, seed=2)
    jeng.serve(jreqs)
    stats = teng.serve(treqs)
    assert treqs[1].state is RequestState.FAILED
    assert isinstance(treqs[1].error, FaultError) and tplan.fired >= 1
    for r in (treqs[0], treqs[2]):
        assert r.state is RequestState.DONE
        assert r.output == ref[r.rid].output      # bit-identical survivors
    assert stats.requests_failed == 1 and stats.faults_injected >= 1
    assert tplan.fired == jplan.fired
    _assert_same(jeng, teng, jreqs, treqs)
    _assert_leak_free(teng)


@pytest.mark.parametrize("site", ["engine.prefill", "engine.decode"])
def test_poisoned_request_fails_alone_under_speculation(weights, site):
    """The poison case with self-speculative decoding: a raise in the
    failed request's prefill or verify commit drops its drafter mirror and
    frees its provisional blocks with the rest of its table; the peers'
    tokens equal vanilla greedy's and both pools (target and drafter)
    drain leak-free -- as on the JAX engine."""
    cfg, jp, tcfg, tp = weights
    _, ref_eng = _engines(weights, max_len=24, batch_slots=2)
    ref = _reqs(TE, TS, cfg.vocab_size, 3, seed=3, new_tokens=8)
    ref_eng.serve(ref)
    jplan, tplan = _plans(lambda m: m.FaultPlan([m.FaultSpec(site, "raise",
                                                             rid=1)]))
    jeng = JE.ServingEngine(cfg, jp, paged=True, cache_dtype="float32",
                            max_len=24, batch_slots=2, draft_cfg=cfg,
                            draft_params=jp, spec_k=3, fault_plan=jplan)
    teng = TE.ServingEngine(tcfg, tp, cache_dtype="float32", max_len=24,
                            batch_slots=2, draft_cfg=tcfg, draft_params=tp,
                            spec_k=3, fault_plan=tplan, device="cpu")
    jreqs = _reqs(JE, JS, cfg.vocab_size, 3, seed=3, new_tokens=8)
    treqs = _reqs(TE, TS, cfg.vocab_size, 3, seed=3, new_tokens=8)
    jst = jeng.serve(jreqs)
    tst = teng.serve(treqs)
    assert treqs[1].state is RequestState.FAILED
    assert isinstance(treqs[1].error, FaultError)
    for r in (treqs[0], treqs[2]):
        assert r.state is RequestState.DONE
        assert r.output == ref[r.rid].output
    _assert_same(jeng, teng, jreqs, treqs)
    assert tst.verify_steps == jst.verify_steps > 0
    assert (tst.spec_proposed, tst.spec_accepted) == \
        (jst.spec_proposed, jst.spec_accepted)
    assert teng._drafter._blocks == {} and not teng._spec_on
    _assert_leak_free(teng)
    teng._drafter.pool.assert_leak_free()


def test_dropped_kv_transfers_degrade_without_leaking(weights):
    """kv.spill / kv.fetch drops lose tier traffic, never correctness:
    a dropped fetch reads as a tier miss and the engine recomputes the
    block, so outputs stay equal to the no-fault run's -- and the
    dropped spill's pending pin is released, so nothing leaks."""
    cfg = weights[0]
    kw = dict(max_len=24, batch_slots=1, block_size=8, pool_blocks=5,
              host_blocks=16)
    _, ref_eng = _engines(weights, **kw)
    ref = _churn_reqs(TE, TS, cfg.vocab_size)
    ref_eng.serve(ref)
    assert ref_eng.totals.kv_spills > 0 and ref_eng.totals.kv_fetches > 0

    def build(m):
        return m.FaultPlan([m.FaultSpec("kv.spill", "drop", count=2),
                            m.FaultSpec("kv.fetch", "drop", after=1, count=2),
                            m.FaultSpec("kv.fetch", "delay", count=2,
                                        delay_s=0.002)])
    jplan, tplan = _plans(build)
    jeng, teng = _engines(weights, (jplan, tplan), **kw)
    jreqs = _churn_reqs(JE, JS, cfg.vocab_size)
    treqs = _churn_reqs(TE, TS, cfg.vocab_size)
    # One request at a time, each engine's tier quiesced between.  The
    # reference fires kv.spill on its transfer worker, and until the
    # worker gets to a dropped spill its key stays pinned as resident: an
    # admission probe that runs first submits a fetch for it, which moves
    # kv.fetch's arrival window (kv_fetches 3, not 2).  Quiescing settles
    # the reference; the port fires kv.spill at submit and needs no such
    # schedule (test_dropped_spill_never_pins_its_key below).
    for jr, tr in zip(jreqs, treqs):
        jeng.serve([jr])
        jeng.drain_tier_io()
        teng.serve([tr])
        teng.drain_tier_io()
    assert [r.output for r in treqs] == [r.output for r in ref]
    assert all(r.state is RequestState.DONE for r in treqs)
    assert tplan.fired >= 1 and tplan.fired == jplan.fired
    _assert_same(jeng, teng, jreqs, treqs)
    _assert_leak_free(teng)
    _assert_leak_free(ref_eng)


@pytest.mark.parametrize("worker_lag_s", [0.0, 0.05])
def test_dropped_spill_never_pins_its_key(weights, worker_lag_s):
    """The port fires ``kv.spill`` on the executor thread when it submits
    the spill, so a dropped spill never pins its key in the host tier.
    Served all at once, with the transfer worker as fast as it runs or
    lagging every transfer, the churn run under the drop plan fetches the
    same four keys and restores the same two blocks: the count the
    reference settles to when its worker keeps up."""
    _, _, tcfg, tp = weights
    plan = TF.FaultPlan([TF.FaultSpec("kv.spill", "drop", count=2),
                         TF.FaultSpec("kv.fetch", "drop", after=1, count=2),
                         TF.FaultSpec("kv.fetch", "delay", count=2,
                                      delay_s=0.002)])
    eng = TE.ServingEngine(tcfg, tp, fault_plan=plan, device="cpu",
                           paged=True, cache_dtype="float32", max_len=24,
                           batch_slots=1, block_size=8, pool_blocks=5,
                           host_blocks=16)
    hook, submit = eng._kv_target.fault_hook, eng._kv_io.submit_async
    fetched = []

    def lagging_hook(item):
        time.sleep(worker_lag_s)
        return hook(item)

    def logging_submit(payload, *a, **kw):
        fetched.append(payload[1])
        return submit(payload, *a, **kw)
    eng._kv_target.fault_hook = lagging_hook
    eng._kv_io.submit_async = logging_submit
    reqs = _churn_reqs(TE, TS, tcfg.vocab_size)
    eng.serve(reqs)
    assert all(r.state is RequestState.DONE for r in reqs)
    assert eng.totals.faults_injected == 6 and eng.totals.kv_spills == 8
    assert eng.totals.kv_fetches == 2 and len(fetched) == 4
    assert eng.totals.prefill_tokens_computed == 112
    _assert_leak_free(eng)
    eng.close()


CHAOS_SITES = ("engine.prefill", "engine.decode", "kv.spill", "kv.fetch")


def _chaos_run(weights, seed, n):
    """One seeded plan on both engines (tiered, 14-block pool)."""
    cfg = weights[0]
    jplan, tplan = _plans(lambda m: m.FaultPlan.from_seed(
        seed, n=3, sites=CHAOS_SITES))
    jeng, teng = _engines(weights, (jplan, tplan), max_len=24,
                          batch_slots=2, block_size=4, pool_blocks=14,
                          host_blocks=16)
    jreqs = _reqs(JE, JS, cfg.vocab_size, n, seed=seed % 997, prompt_len=8,
                  new_tokens=3)
    treqs = _reqs(TE, TS, cfg.vocab_size, n, seed=seed % 997, prompt_len=8,
                  new_tokens=3)
    jeng.serve(jreqs)
    teng.serve(treqs)
    assert all(r.state in (RequestState.DONE, RequestState.FAILED)
               for r in treqs), seed
    assert all(r.output for r in treqs
               if r.state is RequestState.DONE), seed
    _assert_same(jeng, teng, jreqs, treqs)
    _assert_leak_free(teng)


@pytest.mark.parametrize("seed", range(6))
def test_seeded_fault_plans_never_leak(weights, seed):
    """Deterministic chaos sweep: any injection plan over the
    request-level and transfer sites leaves every request terminal, the
    pool leak-free, the tier drained -- and the port where the JAX
    engine ends."""
    _chaos_run(weights, seed, 4)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=8, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=2**16))
    def test_fault_plan_property_leak_free(weights, seed):
        """Property form of the seeded sweep."""
        _chaos_run(weights, seed, 3)
except ImportError:          # hypothesis is optional; the seeded sweep
    pass                     # above covers the property deterministically


# -- graceful degradation: deadlines and shedding ------------------------------

def test_deadline_cancels_queued_and_active(weights):
    cfg = weights[0]
    jeng, teng = _engines(weights, max_len=24, batch_slots=1)
    for eng, mod, smod in ((jeng, JE, JS), (teng, TE, TS)):
        doomed = _reqs(mod, smod, cfg.vocab_size, 2, seed=4, new_tokens=12,
                       deadline_s=0.0)
        fine = _reqs(mod, smod, cfg.vocab_size, 1, seed=5)[0]
        eng.serve(doomed + [fine])
        if mod is TE:
            assert all(r.state is RequestState.FAILED for r in doomed)
            assert all(isinstance(r.error, DeadlineExceeded) for r in doomed)
            assert fine.state is RequestState.DONE and len(fine.output) == 4
            treqs = doomed + [fine]
        else:
            jreqs = doomed + [fine]
    _assert_same(jeng, teng, jreqs, treqs)
    _assert_leak_free(teng)


def test_shed_rejections_are_typed_and_counted(weights):
    cfg = weights[0]
    _, eng = _engines(weights, max_len=16, batch_slots=1,
                      shed_queue_depth=1)
    a, b = _reqs(TE, TS, cfg.vocab_size, 2, seed=6)
    eng.submit(a)                       # queued (executor not running)
    with pytest.raises(ShedError):
        eng.submit(b)
    assert eng.totals.shed_rejections == 1
    assert a.replica == eng.name and eng.load == 1
    snap = eng.load_snapshot()
    assert (snap.queued, snap.free_slots, snap.queued_tokens) == (1, 1, 9)
    eng.stop()                          # idempotent no-op: never started


# -- executor crash capture ----------------------------------------------------

@pytest.mark.parametrize("after", [1, 4])
def test_blocking_serve_crash_fails_all_and_surfaces(weights, after):
    """``replica.executor:raise:N`` in blocking ``serve``: the crash
    escapes, every request still queued or active is FAILED (the same set
    as on the JAX engine), the pool is leak-free and later submits are
    refused."""
    cfg = weights[0]
    jplan, tplan = _plans(lambda m: m.FaultPlan.parse(
        f"replica.executor:raise:{after}"))
    jeng, teng = _engines(weights, (jplan, tplan), max_len=16, batch_slots=2)
    jreqs = _reqs(JE, JS, cfg.vocab_size, 3, seed=7)
    treqs = _reqs(TE, TS, cfg.vocab_size, 3, seed=7)
    with pytest.raises(JF.FaultError):
        jeng.serve(jreqs)
    with pytest.raises(FaultError):
        teng.serve(treqs)
    # after one step every request is still in flight; after four the
    # first two have finished and only the third fails
    failed = [r.state is RequestState.FAILED for r in treqs]
    assert failed == ([True] * 3 if after == 1 else [False, False, True])
    assert all(r.state is RequestState.DONE for r in treqs if r.error is None)
    assert isinstance(teng.failure, FaultError)
    _assert_same(jeng, teng, jreqs, treqs)
    with pytest.raises(ExecutorCrash):   # poisoned against late submits
        teng.submit(_reqs(TE, TS, cfg.vocab_size, 1, seed=8)[0])
    _assert_leak_free(teng)


def test_service_mode_crash_capture_and_idempotent_stop(weights):
    """A service-mode executor that dies surfaces through failure/stop()
    instead of a join-timeout; stop() re-raises exactly once and is
    idempotent after."""
    cfg = weights[0]
    plan = FaultPlan([FaultSpec("replica.executor", "raise")])
    _, eng = _engines(weights, (None, plan), max_len=16, batch_slots=2)
    states = []
    done = threading.Event()
    eng.start()
    eng.submit(_reqs(TE, TS, cfg.vocab_size, 1, seed=9)[0],
               on_finish=lambda r: (states.append(r.state), done.set()))
    assert done.wait(timeout=30.0)
    assert states == [RequestState.FAILED]
    deadline = time.monotonic() + 10.0
    while eng.failure is None and time.monotonic() < deadline:
        time.sleep(0.005)
    assert isinstance(eng.failure, FaultError)
    with pytest.raises(ExecutorCrash):
        eng.stop()
    eng.stop()                           # second stop: silent, idempotent
    eng.stop(raise_failure=False)
    with pytest.raises(ExecutorCrash):
        eng.submit(_reqs(TE, TS, cfg.vocab_size, 1, seed=10)[0])
    _assert_leak_free(eng)


def test_service_mode_crash_after_a_clean_restart_still_surfaces(weights):
    """A clean start / stop, then a restart whose executor crashes: the
    second stop() raises ExecutorCrash (once).  The reference's
    ``_raise_failure_once`` marks the crash surfaced on every stop(),
    so there the crash after the clean stop would be swallowed."""
    cfg = weights[0]
    _, eng = _engines(weights, max_len=16, batch_slots=2)
    done = threading.Semaphore(0)
    eng.start()
    eng.submit(_reqs(TE, TS, cfg.vocab_size, 1, seed=11)[0],
               on_finish=lambda r: done.release())
    assert done.acquire(timeout=30)
    eng.stop()                           # clean: nothing to raise
    eng.fault_plan = FaultPlan.parse("replica.executor:raise")
    crashed = _reqs(TE, TS, cfg.vocab_size, 2, seed=12)
    for r in crashed:          # queued before the executor runs: both are
        eng.submit(r, on_finish=lambda r: done.release())   # in when it dies
    eng.start()
    for _ in crashed:
        assert done.acquire(timeout=30)
    with pytest.raises(ExecutorCrash):
        eng.stop()
    eng.stop()
    assert all(r.state is RequestState.FAILED for r in crashed)
    _assert_leak_free(eng)
