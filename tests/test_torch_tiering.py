"""The port's host KV tier against the JAX package: every test of
``tests/test_kv_tiering.py`` mirrored on ``repro_torch`` (its refusal test
lives in ``test_torch_engine.py``), plus the port's own in-place capture
test.

* HostTier (LRU, pending pins), DiskTierStub, and the pool's hold /
  demote lifecycle: the same operations on the port's objects and the
  reference's give the same answers.
* ``KVBlockTarget``: spill then fetch round trip through the single FIFO
  worker, bf16 leaves carried as their int16 bits.
* Churn restore (``qwen2.5-3b-smoke`` at fp32, the same weights through
  ``repro_torch.interop``), on an fp32 and on an int8 pool, tiered and
  untiered: greedy tokens equal to the JAX engine's, and ``kv_spills``,
  ``kv_fetches``, ``prefix_hits_host``, ``spill_bytes``,
  ``prefill_tokens_computed`` equal to its counters; restoring computes
  fewer prompt tokens than recomputing and gives the same tokens.
* Preemption resume in service mode: the victim's history spills and is
  restored, and its stream equals the un-preempted JAX run's.
* Service mode serves a batch with the tokens of blocking ``serve``.
* In-place capture: ``_read_block_slices`` clones, so a block captured,
  then overwritten in the pool, reaches the tier with its old bytes (bf16
  through the int16 bitcast, and int8 with its scales) -- where a view of
  the pool would carry the new ones.
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
from repro.serving import kv_pool as JP
from repro.serving import sampler as JS
from repro_torch.configs import registry as TR
from repro_torch.core.offload import KVBlockTarget, OffloadEngine, host_leaf
from repro_torch.interop import params_from_numpy
from repro_torch.models.registry import fns_for
from repro_torch.serving import engine as TE
from repro_torch.serving import kv_pool as TP
from repro_torch.serving import sampler as TS
from repro_torch.serving.kv_pool import DiskTierStub, HostTier

torch.set_num_threads(1)

TIER_COUNTERS = ("kv_spills", "kv_fetches", "prefix_hits_host",
                 "spill_bytes", "prefill_tokens_total",
                 "prefill_tokens_computed", "prefix_shared_blocks",
                 "prefix_lookups", "kv_hit_rate", "decode_steps",
                 "preemptions")


@pytest.fixture(scope="module")
def weights():
    cfg = JR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    jp = jax_fns(cfg).init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    tcfg = TR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    return cfg, jp, tcfg, tp


# -- tier semantics -----------------------------------------------------------

def _tier_script(mod):
    tier = mod.HostTier(2)
    out = []
    tier.store(b"a", 1)
    tier.store(b"b", 2)
    out += [b"a" in tier, tier.used, tier.load(b"a")]
    tier.store(b"c", 3)                         # capacity 2: evicts b, not a
    out += [b"b" in tier, b"a" in tier, b"c" in tier, tier.evictions,
            tier.load(b"b"), tier.misses]
    tier.drop(b"a")
    out += [b"a" in tier, tier.used]
    return out


def test_host_tier_store_load_lru_eviction():
    got = _tier_script(TP)
    assert got == [True, 2, 1, False, True, True, 1, None, 1, False, 1]
    assert got == _tier_script(JP)


def test_host_tier_pending_placeholder_pins_and_reads_as_resident():
    tier = HostTier(1)
    tier.begin_store(b"k")
    assert b"k" in tier                         # in-flight spill counts as
    assert tier.load(b"k") is None              # resident, but has no bytes
    assert tier.pending_count == 1
    tier.store(b"other", 0)                     # pending is never the victim:
    assert b"k" in tier and b"other" not in tier    # the newcomer bounces
    tier.store(b"k", 42)                        # worker fills the placeholder
    assert tier.load(b"k") == 42 and tier.pending_count == 0


def test_disk_tier_stub_is_an_honest_placeholder():
    disk = DiskTierStub()
    with pytest.raises(NotImplementedError):
        disk.store(b"k", 0)
    with pytest.raises(NotImplementedError):
        disk.load(b"k")
    assert b"k" not in disk and disk.used == 0
    disk.drop(b"k")                             # drop is a no-op, not an error


# -- pool hold / demote lifecycle ---------------------------------------------

def _pool_script(mod):
    """The reference test's hold / demote sequence, recording what the
    pool answers at each step."""
    demoted = []
    pool = mod.KVBlockPool(4, block_size=8, host_blocks=4)
    pool.on_demote = demoted.extend
    out = [pool.reserve(2)]
    a, b = pool.alloc_reserved(2)
    pool.hold(a)                                # prefix index takes a holder
    with pytest.raises(ValueError, match="double hold"):
        pool.hold(a)
    gen = pool.generation(a)
    out += [pool.free([a, b]) == [b], pool.demotable_count, pool.held_count,
            pool.free_blocks, pool.available_blocks, pool.block_live(a, gen)]
    pool.share([a])                             # a lookup hit makes it hot
    out.append(pool.demotable_count)
    pool.free([a])
    out.append(pool.demotable_count)
    epoch = pool.avail_epoch
    out += [pool.reserve(4), demoted == [a], pool.demotions, pool.held_count,
            pool.demotable_count, pool.block_live(a, gen)]
    pool.unreserve(4)
    out += [pool.avail_epoch > epoch, pool.available_blocks,
            pool.leak_report()]
    return out


def test_pool_hold_demote_lifecycle_and_generation_guard():
    got = _pool_script(TP)
    assert got == [True, True, 1, 1, 3, 4, True, 0, 1, True, True, 1, 0, 0,
                   False, True, 4, {"unheld_blocks": 0,
                                    "held_with_extra_refs": 0,
                                    "reserved_blocks": 0, "host_pending": 0}]
    assert got == _pool_script(JP)


# -- split-phase transfer protocol --------------------------------------------

def test_kv_block_target_spill_then_fetch_roundtrip():
    tier = HostTier(4)
    payload = {"k": torch.arange(6, dtype=torch.float32),
               "v": torch.randn(6).to(torch.bfloat16)}
    with OffloadEngine([KVBlockTarget(tier)]) as io:
        tier.begin_store(b"key")                # pin before the async spill
        io.submit(("spill", b"key", payload))
        item = io.submit_async(("fetch", b"key"))
        assert io.next_done(timeout=5.0) is item
        # single FIFO worker: the fetch behind the spill finds its bytes
        np.testing.assert_array_equal(item.result["k"], payload["k"].numpy())
        # bf16 travels as its bits: int16 on the host, a view restores it
        assert item.result["v"].dtype == np.int16
        assert torch.equal(torch.from_numpy(item.result["v"])
                           .view(torch.bfloat16), payload["v"])
        assert io.targets[0].copies == 1
    assert b"key" in tier
    with OffloadEngine([KVBlockTarget(tier)]) as io:
        miss = io.submit_async(("fetch", b"missing"))
        assert io.next_done(timeout=5.0) is miss
        assert miss.result is None              # tier miss = recompute signal


# -- end to end: churn restore ------------------------------------------------

def _churn_reqs(mod, smod, vocab, seed=5):
    """3 distinct 2-block prefixes revisited with fresh tails: the second
    visit finds its prefix demoted out of a 5-block pool."""
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


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_churn_restores_from_host_bit_identical_to_recompute(weights,
                                                             cache_dtype):
    cfg, jp, tcfg, tp = weights
    outs, computed = {}, {}
    for tiered in (True, False):
        kw = dict(max_len=24, batch_slots=1, block_size=8, pool_blocks=5,
                  host_blocks=16 if tiered else 0, cache_dtype=cache_dtype)
        jeng = JE.ServingEngine(cfg, jp, paged=True, **kw)
        eng = TE.ServingEngine(tcfg, tp, device="cpu", **kw)
        jreqs = _churn_reqs(JE, JS, cfg.vocab_size)
        reqs = _churn_reqs(TE, TS, cfg.vocab_size)
        js = jeng.serve(jreqs)
        ts = eng.serve(reqs)
        outs[tiered] = [r.output for r in reqs]
        computed[tiered] = eng.totals.prefill_tokens_computed
        assert outs[tiered] == [r.output for r in jreqs]
        for name in TIER_COUNTERS:
            assert getattr(ts, name) == getattr(js, name), name
        if tiered:
            assert eng.totals.kv_spills > 0 and eng.totals.spill_bytes > 0
            assert eng.totals.kv_fetches > 0
            assert eng.totals.prefix_hits_host > 0
            # bookkeeping balanced: only index-held blocks stay resident
            assert eng.pool.used_blocks == eng.pool.demotable_count
            assert eng.pool.reserved_blocks == 0
            eng.drain_tier_io()
            eng.pool.assert_leak_free()
            assert eng._kv_target.copies == eng.totals.kv_spills
            assert eng.spill_capture_s > 0 and eng.fetch_commit_s > 0
            eng.close()
            eng.close()                         # idempotent
        else:
            assert eng.totals.kv_spills == 0 == eng.totals.kv_fetches
    assert outs[True] == outs[False]            # restore is the exact bytes
    assert computed[True] < computed[False]     # ...and it saved compute


# -- end to end: preemption resume --------------------------------------------

def test_preemption_resume_restores_history_from_host_tier(weights):
    """A preempted decode's history blocks spill to the host tier; its
    resume *restores* them instead of re-running the folded prompt, and
    still lands the un-preempted greedy stream of the JAX engine."""
    cfg, jp, tcfg, tp = weights
    prompt = (np.arange(8, dtype=np.int32) * 7) % cfg.vocab_size
    kw = dict(max_len=33, batch_slots=1, block_size=4, pool_blocks=9,
              cache_dtype="float32")
    ref = JE.Request(0, prompt, max_new_tokens=24, sampler=JS.greedy())
    JE.ServingEngine(cfg, jp, paged=True, **kw).serve([ref])

    eng = TE.ServingEngine(tcfg, tp, host_blocks=32, device="cpu", **kw)
    low = TE.Request(0, prompt, max_new_tokens=24, sampler=TS.greedy())
    high = TE.Request(1, np.arange(4, dtype=np.int32), max_new_tokens=2,
                      sampler=TS.greedy(), priority=1)
    ev_low, ev_high = threading.Event(), threading.Event()
    eng.start()
    try:
        eng.submit(low, on_finish=lambda r: ev_low.set())
        deadline = time.monotonic() + 60
        while len(low.output) < 8:      # enough history for full blocks
            assert time.monotonic() < deadline, "low request never started"
            time.sleep(0.005)
        eng.submit(high, on_finish=lambda r: ev_high.set())
        assert ev_high.wait(60) and ev_low.wait(60)
    finally:
        eng.stop()
    assert low.preempted_count >= 1
    assert eng.totals.kv_spills > 0             # victim history spilled...
    assert eng.totals.prefix_hits_host > 0      # ...and restored on resume
    assert len(high.output) == 2
    assert low.output == ref.output             # restore-resume is exact
    assert eng.pool.reserved_blocks == 0
    eng.drain_tier_io()
    eng.pool.assert_leak_free()


def test_service_mode_serves_like_blocking_serve(weights):
    """start / submit from the main thread / on_finish / stop: every
    request DONE with the tokens blocking ``serve`` gives (on the JAX
    engine), the pool leak-free, ``stop`` silent without a crash."""
    cfg, jp, tcfg, tp = weights
    kw = dict(max_len=40, batch_slots=2, block_size=8, prefill_chunk=16,
              cache_dtype="float32")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 21, 12, 30)]
    jreqs = [JE.Request(i, p, max_new_tokens=6, sampler=JS.greedy())
             for i, p in enumerate(prompts)]
    JE.ServingEngine(cfg, jp, paged=True, **kw).serve(jreqs)
    eng = TE.ServingEngine(tcfg, tp, device="cpu", **kw)
    reqs = [TE.Request(i, p, max_new_tokens=6, sampler=TS.greedy())
            for i, p in enumerate(prompts)]
    done = threading.Semaphore(0)
    eng.start()
    eng.start()                                 # idempotent
    try:
        for r in reqs:
            eng.submit(r, on_finish=lambda r: done.release())
        for _ in reqs:
            assert done.acquire(timeout=60)
    finally:
        eng.stop()
    eng.stop()
    assert all(r.state is TE.RequestState.DONE for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert eng.pool.leak_report() == {"unheld_blocks": 0,
                                      "held_with_extra_refs": 0,
                                      "reserved_blocks": 0, "host_pending": 0}
    with pytest.raises(AssertionError, match="service mode"):
        eng.start()
        try:
            eng.serve(reqs[:1])
        finally:
            eng.stop()


# -- in-place capture ---------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_spill_capture_holds_the_rows_from_before_an_overwrite(cache_dtype):
    """The port's pools are written in place: capture a block with
    ``_read_block_slices``, overwrite that pool block, then materialize the
    capture through ``KVBlockTarget``.  The tier must hold the block's
    bytes from before the overwrite -- bit for bit, bf16 through the int16
    bitcast, int8 with both scale leaves -- and restoring them into
    another block must reproduce them; a view of the pool would have
    carried the overwritten bytes."""
    tcfg = TR.smoke("qwen2.5-3b")
    params = fns_for(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    eng = TE.ServingEngine(tcfg, params, max_len=40, batch_slots=1,
                           block_size=8, cache_dtype=cache_dtype,
                           host_blocks=8, device="cpu")
    rng = np.random.default_rng(0)
    req = TE.Request(0, rng.integers(0, tcfg.vocab_size, 30).astype(np.int32),
                     max_new_tokens=2, sampler=TS.greedy())
    eng.serve([req])
    state = eng._state
    names = ("k", "v", "k_scale", "v_scale") if cache_dtype == "int8" \
        else ("k", "v")
    bid = 1
    before = {n: getattr(state, n)[:, bid].clone() for n in names}
    assert all(before[n].abs().sum() > 0 for n in names)   # real rows
    view = {n: getattr(state, n)[:, bid] for n in names}
    leaves = eng._read_block_slices(bid)
    assert sorted(leaves) == sorted(names)
    for n in names:                             # a later prefill's write
        pool = getattr(state, n)
        pool[:, bid] = pool[:, bid + 1]
    assert not all(torch.equal(view[n], before[n]) for n in names)
    tier = HostTier(4)
    target = KVBlockTarget(tier)
    tier.begin_store(b"blk")
    nbytes = target.execute(("spill", b"blk", leaves))
    host = tier.load(b"blk")
    assert nbytes == sum(t.nbytes for t in before.values())
    for n in names:
        want = host_leaf(before[n])
        assert host[n].dtype == want.dtype and np.array_equal(host[n], want)
        if before[n].dtype == torch.bfloat16:
            assert host[n].dtype == np.int16
    # restore into another block: the same bits come back
    eng._write_blocks([bid + 2], [host])
    for n in names:
        got = getattr(state, n)[:, bid + 2]
        assert got.dtype == before[n].dtype and torch.equal(got, before[n])
    eng.close()


# -- the launcher -------------------------------------------------------------

def _launch(main, monkeypatch, capsys, *args):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen2.5-3b",
                                     "--smoke", "--requests", "6",
                                     "--prompt-len", "32", "--new-tokens", "4",
                                     *args])
    assert main() == 0
    return capsys.readouterr().out


def _line(out, head):
    return next((ln for ln in out.splitlines() if ln.startswith(head)), None)


@pytest.mark.parametrize("args", [
    ("--host-blocks", "16", "--kv-pool-blocks", "6"),
    ("--host-blocks", "16", "--inject-faults", "seed=3"),
    ("--host-blocks", "16", "--kv-pool-blocks", "6", "--no-kv-tiering"),
    ("--deadline-s", "0"),
], ids=["tiered", "tiered-faults", "no-kv-tiering", "deadline"])
def test_serve_launcher_tiering_and_faults_on_the_cpu(capsys, monkeypatch,
                                                      args):
    """``--host-blocks``, ``--no-kv-tiering``, ``--inject-faults`` and
    ``--deadline-s`` on the CPU: the launcher's ``tiering:`` and
    ``faults:`` lines equal the reference launcher's for the same flags
    (what they count follows from the prompts and the plan, not from the
    random weights, which differ between the two launchers)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    tout = _launch(tserve.main, monkeypatch, capsys, "--device", "cpu", *args)
    jout = _launch(jserve.main, monkeypatch, capsys, *args)
    for head in ("tiering:", "faults:"):
        assert _line(tout, head) == _line(jout, head), head
    tiered = "--host-blocks" in args and "--no-kv-tiering" not in args
    assert (_line(tout, "tiering:") is not None) == tiered
    faults = "--inject-faults" in args or "--deadline-s" in args
    assert (_line(tout, "faults:") is not None) == faults
    if "--deadline-s" in args:
        assert "failed=6" in _line(tout, "faults:")


def test_service_mode_concurrent_submitters_stress(weights):
    """16 threads (more than this host's cores) submit 32 requests that
    share prefixes to a tiered service-mode engine on a pool too small to
    keep them, with a shortened switch interval: every request finishes
    DONE exactly once, the token count adds up, the tier drains and the
    pool is leak-free -- what a lost update in the scheduler, the pool or
    the tier would break."""
    import sys
    cfg, jp, tcfg, tp = weights
    eng = TE.ServingEngine(tcfg, tp, max_len=40, batch_slots=2, block_size=8,
                           pool_blocks=10, host_blocks=24,
                           cache_dtype="float32", device="cpu")
    rng = np.random.default_rng(21)
    prefixes = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
                for _ in range(4)]
    reqs = [TE.Request(i, np.concatenate(
                [prefixes[i % 4], rng.integers(0, cfg.vocab_size, 5)
                 .astype(np.int32)]), max_new_tokens=3, sampler=TS.greedy())
            for i in range(32)]
    finished: dict = {}
    lock = threading.Lock()

    def on_finish(r):
        with lock:
            finished[r.rid] = finished.get(r.rid, 0) + 1

    def submitter(k):
        for r in reqs[2 * k:2 * k + 2]:
            eng.submit(r, on_finish=on_finish)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start()
        threads = [threading.Thread(target=submitter, args=(k,), daemon=True)
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        deadline = time.monotonic() + 120
        while len(finished) < len(reqs):
            assert time.monotonic() < deadline, sorted(finished)
            time.sleep(0.01)
        eng.stop()
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert finished == {r.rid: 1 for r in reqs}
    assert all(r.state is TE.RequestState.DONE and len(r.output) == 3
               for r in reqs)
    assert eng.totals.tokens == sum(len(r.output) for r in reqs)
    assert eng.totals.kv_spills > 0
    eng.drain_tier_io()
    eng.pool.assert_leak_free()
    eng.close()
