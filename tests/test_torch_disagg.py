"""The port's disaggregated prefill/decode fleet against the JAX package:
every test of ``tests/test_disagg.py`` mirrored on ``repro_torch`` (role
policy and validation, the pool's export pins, migration end to end,
first token at handoff, ``kv.migrate`` chaos, load snapshots under
prefill sentinel slots), plus the int8 pool, speculative decoding on the
decode replica, and the port's own hazard: its pools are written in
place, so a handoff must clone the blocks it migrates.

Where a test drives engines, the JAX fleet serves the same requests beside
the port's (``qwen2.5-3b-smoke`` at fp32, fp32 KV pools unless stated, the
same weights through ``repro_torch.interop``), and the two must agree on
greedy tokens, states, and the counters thread timing cannot move:
``kv_migrations``, ``migrated_blocks``, ``requests_failed`` and the decode
replica's ``prefill_tokens_computed == 0``."""
import time

import jax
import numpy as np
import pytest
import torch

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
from repro_torch.serving.faults import FaultPlan, FaultSpec
from repro_torch.serving.kv_pool import KVBlockPool
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.scheduler import RequestState

torch.set_num_threads(1)

SIDES = ((True, JE, JS, JF, JRT.ReplicaRouter),
         (False, TE, TS, TF, ReplicaRouter))


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


def _prompts(vocab, sizes, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in sizes]


def _mk_reqs(mod, smod, prompts, new_tokens, rid0=0):
    return [mod.Request(rid0 + i, p, max_new_tokens=new_tokens,
                        sampler=smod.greedy())
            for i, p in enumerate(prompts)]


def _fleet(weights, jax_side, plan=None, **kw):
    pre = _engine(weights, jax_side, name="pre0", role="prefill",
                  fault_plan=plan, **kw)
    dec = _engine(weights, jax_side, name="dec0", role="decode",
                  fault_plan=plan, **kw)
    return pre, dec


def _serve_disagg(weights, prompts, new_tokens, *, plan_of=None, steal=False,
                  max_retries=2, **kw):
    """Serve ``prompts`` through a prefill + decode fleet on each package.
    Returns {jax_side: (requests, fleet stats, decode replica's window,
    prefill engine, decode engine, plan)}."""
    out = {}
    for jax_side, mod, smod, fmod, Router in SIDES:
        plan = plan_of(fmod) if plan_of else None
        pre, dec = _fleet(weights, jax_side, plan, **kw)
        router = Router([pre, dec], affinity=False, steal=steal,
                        max_retries=max_retries)
        base = dec.begin_window()
        reqs = _mk_reqs(mod, smod, prompts, new_tokens)
        stats = router.serve(reqs)
        router.stop()
        out[jax_side] = (reqs, stats, dec.collect_window(base, [],
                                                         stats.wall_s),
                         pre, dec, plan)
    return out


def _same(out, fields=("kv_migrations", "migrated_blocks",
                       "prefill_tokens_computed")):
    (treqs, tst, tw, *_), (jreqs, jst, jw, *_) = out[False], out[True]
    assert [r.state.value for r in treqs] == [r.state.value for r in jreqs]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert tst.requests_failed == jst.requests_failed
    for name in fields:
        assert getattr(tw, name) == getattr(jw, name), name


def _local_ref(weights, prompts, new_tokens, **kw):
    ref = _mk_reqs(TE, TS, prompts, new_tokens)
    _engine(weights, False, name="ref", **kw).serve(ref)
    return ref


# -- role policy and validation ------------------------------------------------

def test_role_validation(weights):
    with pytest.raises(ValueError, match="role="):
        _engine(weights, False, max_len=24, batch_slots=1, role="prefil")
    with pytest.raises(ValueError, match="paged"):
        _engine(weights, False, max_len=24, batch_slots=1, paged=False,
                role="prefill")
    pre = _engine(weights, False, max_len=24, batch_slots=1, block_size=8,
                  role="prefill")
    with pytest.raises(ValueError, match="decode-capable"):
        ReplicaRouter([pre])
    # one cache dtype fleet-wide: adopt would cast rows across pools
    dec = _engine(weights, False, max_len=24, batch_slots=1, block_size=8,
                  role="decode", cache_dtype="int8")
    with pytest.raises(ValueError, match="cache dtype"):
        ReplicaRouter([pre, dec], affinity=False)


def test_roles_are_policy_not_capability(weights):
    """A prefill- or decode-role engine serves a fresh prompt standalone,
    with the tokens of a mixed engine (and of the JAX engine)."""
    vocab = weights[0].vocab_size
    prompts = _prompts(vocab, [8])
    kw = dict(max_len=24, batch_slots=1, block_size=8)
    ref = _local_ref(weights, prompts, 4, **kw)
    for role in ("prefill", "decode"):
        jeng, teng = (_engine(weights, j, role=role, **kw)
                      for j in (True, False))
        jreqs = _mk_reqs(JE, JS, prompts, 4)
        treqs = _mk_reqs(TE, TS, prompts, 4)
        jeng.serve(jreqs)
        teng.serve(treqs)
        assert [r.output for r in treqs] == [r.output for r in ref], role
        assert [r.output for r in treqs] == [r.output for r in jreqs], role
        teng.pool.assert_leak_free()


# -- export pinning ------------------------------------------------------------

def test_export_blocks_pins_and_validates():
    pool = KVBlockPool(8, 8)
    pool.reserve(2)
    ids = pool.alloc_reserved(2)
    gens = pool.export_blocks(ids)
    assert len(gens) == len(ids)
    assert all(pool.refcount(b) == 2 for b in ids)
    assert all(pool.block_live(b, g) for b, g in zip(ids, gens))
    with pytest.raises(ValueError, match="trash"):
        pool.export_blocks([pool.TRASH])
    free_id = next(i for i in range(1, 8) if i not in ids)
    with pytest.raises(ValueError, match="unallocated"):
        pool.export_blocks([free_id])
    assert all(pool.refcount(b) == 2 for b in ids)   # no partial pins
    pool.free(ids)              # drop the export pins...
    pool.free(ids)              # ...then the allocation holders
    pool.assert_leak_free()


# -- migration end to end ------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_disagg_bit_identical_zero_recompute_leak_free(weights, cache_dtype):
    """Migrated decode gives a local serve's tokens and the JAX fleet's;
    the decode replica computes no prompt token; every block is counted;
    both pools drain leak-free (on an int8 pool the scales migrate with
    the rows)."""
    vocab = weights[0].vocab_size
    kw = dict(max_len=64, batch_slots=3, block_size=16, prefill_chunk=16,
              cache_dtype=cache_dtype)
    prompts = _prompts(vocab, [8, 8, 40])
    ref = _local_ref(weights, prompts, 4, **kw)
    out = _serve_disagg(weights, prompts, 4, **kw)
    reqs, stats, w, pre, dec, _ = out[False]
    assert [r.output for r in reqs] == [r.output for r in ref], \
        "migrated decode diverged from local prefill+decode"
    assert all(r.first_token_at is not None for r in reqs)
    assert w.prefill_tokens_computed == 0
    assert w.kv_migrations == len(reqs)
    assert w.migrated_blocks == sum(-(-(len(p) + 4) // 16) for p in prompts)
    _same(out)
    pre.pool.assert_leak_free()
    dec.pool.assert_leak_free()


def test_single_token_request_finishes_at_handoff(weights):
    vocab = weights[0].vocab_size
    kw = dict(max_len=48, batch_slots=2, block_size=16, prefill_chunk=16)
    prompts = _prompts(vocab, [8, 24])
    ref = _local_ref(weights, prompts, 1, **kw)
    out = _serve_disagg(weights, prompts, 1, **kw)
    reqs, stats, w, pre, dec, _ = out[False]
    assert [r.output for r in reqs] == [r.output for r in ref]
    assert all(r.state is RequestState.DONE for r in reqs)
    assert w.kv_migrations == 0 and w.tokens == 0
    _same(out)
    pre.pool.assert_leak_free()
    dec.pool.assert_leak_free()


def test_steal_never_raids_the_disagg_migration_path(weights):
    vocab = weights[0].vocab_size
    kw = dict(max_len=48, batch_slots=2, block_size=16, prefill_chunk=16)
    prompts = _prompts(vocab, [8, 8, 24], seed=13)
    ref = _local_ref(weights, prompts, 4, **kw)
    out = _serve_disagg(weights, prompts, 4, steal=True, **kw)
    reqs, stats, w, pre, dec, _ = out[False]
    assert [r.output for r in reqs] == [r.output for r in ref]
    assert w.kv_migrations == len(reqs)
    assert w.prefill_tokens_computed == 0
    assert stats.router_steals == 0
    _same(out)
    pre.pool.assert_leak_free()
    dec.pool.assert_leak_free()


def test_migrate_drop_retries_from_bare_prompt(weights):
    vocab = weights[0].vocab_size
    kw = dict(max_len=64, batch_slots=2, block_size=16, prefill_chunk=16)
    prompts = _prompts(vocab, [8, 40], seed=9)
    ref = _local_ref(weights, prompts, 4, **kw)
    out = _serve_disagg(
        weights, prompts, 4, max_retries=3,
        plan_of=lambda f: f.FaultPlan([f.FaultSpec("kv.migrate", "drop",
                                                   count=1)]), **kw)
    reqs, stats, w, pre, dec, plan = out[False]
    assert plan.fired == 1
    assert all(r.state is RequestState.DONE for r in reqs), \
        [(r.rid, r.state, r.error) for r in reqs]
    assert [r.output for r in reqs] == [r.output for r in ref]
    assert stats.requests_retried >= 1
    _same(out, fields=("kv_migrations", "migrated_blocks"))
    pre.pool.assert_leak_free()
    dec.pool.assert_leak_free()


def test_seeded_migrate_chaos_terminal_and_leak_free(weights):
    """Seeded plans over kv.migrate (drop / delay mixes): every request
    reaches a typed terminal state, DONE outputs equal the unfaulted run's,
    neither pool leaks a block or an export pin."""
    vocab = weights[0].vocab_size
    kw = dict(max_len=48, batch_slots=2, block_size=16, prefill_chunk=16)
    prompts = _prompts(vocab, [8, 24], seed=11)
    ref_out = {r.rid: r.output for r in _local_ref(weights, prompts, 3, **kw)}
    for seed in range(3):
        pre, dec = _fleet(weights, False,
                          FaultPlan.from_seed(seed, n=4, sites=("kv.migrate",)),
                          **kw)
        router = ReplicaRouter([pre, dec], affinity=False, steal=False,
                               max_retries=3)
        reqs = _mk_reqs(TE, TS, prompts, 3)
        router.serve(reqs)
        router.stop()
        assert all(r.state in (RequestState.DONE, RequestState.FAILED)
                   for r in reqs), [(r.rid, r.state) for r in reqs]
        for r in reqs:
            if r.state is RequestState.DONE:
                assert r.output == ref_out[r.rid], (seed, r.rid)
            else:
                assert r.error is not None, (seed, r.rid)
        pre.pool.assert_leak_free()
        dec.pool.assert_leak_free()


def test_disagg_with_speculative_decode_replica(weights):
    """Self-speculation on both replicas: the adopted slot hands its
    handoff token back to the verify pass as ``t_0`` (no re-sample, no
    double count); tokens equal the local serve's and the JAX fleet's, and
    the token count is the delivered one.  The verify rounds are not held
    to the JAX fleet's: they depend on whether the two adoptions land in
    one executor step."""
    cfg, jp, tcfg, tp = weights
    vocab = cfg.vocab_size
    kw = dict(max_len=64, batch_slots=2, block_size=16, prefill_chunk=16)
    prompts = _prompts(vocab, [8, 40], seed=17)
    ref = _local_ref(weights, prompts, 6, **kw)
    out = {}
    for jax_side, mod, smod, fmod, Router in SIDES:
        dcfg, dp = (cfg, jp) if jax_side else (tcfg, tp)
        pre, dec = _fleet(weights, jax_side, draft_cfg=dcfg, draft_params=dp,
                          spec_k=2, **kw)
        router = Router([pre, dec], affinity=False, steal=False)
        base = dec.begin_window()
        reqs = _mk_reqs(mod, smod, prompts, 6)
        stats = router.serve(reqs)
        router.stop()
        out[jax_side] = (reqs, stats, dec.collect_window(base, [],
                                                         stats.wall_s),
                         pre, dec, None)
    reqs, stats, w, pre, dec, _ = out[False]
    assert [r.output for r in reqs] == [r.output for r in ref]
    assert stats.tokens == 12 and w.verify_steps > 0
    # verify rounds depend on whether the two adoptions land in one step
    _same(out)
    dec.pool.assert_leak_free()
    dec._drafter.pool.assert_leak_free()
    pre.pool.assert_leak_free()


def test_handoff_clones_the_blocks_it_migrates(weights):
    """The port's pools are written in place: the leaves a handoff passes
    to the migration channel must be copies taken at the handoff, not
    views of pool blocks that a later prefill may overwrite.  Overwriting
    the whole pool after the handoff leaves them unchanged (a view would
    follow the overwrite)."""
    vocab = weights[0].vocab_size
    eng = _engine(weights, False, max_len=48, batch_slots=1, block_size=16,
                  prefill_chunk=16, role="prefill")
    handed = []

    def hook(req, keys, ids, gens, leaves, tokens, last):
        want = {n: getattr(eng._state, n)[:, ids].clone()
                for n in leaves[0]}
        for n in ("k", "v"):
            getattr(eng._state, n).fill_(7.0)
        handed.append((ids, leaves, want))
    eng._on_prefilled = hook
    req = _mk_reqs(TE, TS, _prompts(vocab, [40], seed=3), 4)[0]
    eng.serve([req])
    assert req.state is RequestState.PREFILLED and len(req.output) == 1
    (ids, leaves, want), = handed
    assert len(ids) == 3 and len(leaves) == 3
    for name, rows in want.items():
        got = torch.stack([blk[name] for blk in leaves], dim=1)
        assert torch.equal(got, rows), name
    eng.pool.free(ids)                   # the export pins
    eng.pool.assert_leak_free()


def test_adopted_blocks_equal_their_handoff_clones(weights):
    """Every block the decode replica lands equals bit for bit the clone
    its source took at the handoff (k, v and, on an int8 pool, both
    scales)."""
    vocab = weights[0].vocab_size
    kw = dict(max_len=64, batch_slots=2, block_size=16, prefill_chunk=16,
              cache_dtype="int8")
    pre, dec = _fleet(weights, False, **kw)
    clones = {}
    handoff = pre._handoff

    def capture(slot, job, req, last1):
        clones[req.rid] = [pre._read_block_slices(b) for b in req.block_ids]
        return handoff(slot, job, req, last1)
    pre._handoff = capture
    checked = []
    adopt = dec._adopt_slot

    def check(slot, req, adoption):
        adopt(slot, req, adoption)
        for bid, want in zip(req.block_ids, clones[req.rid]):
            for name, t in want.items():
                assert torch.equal(getattr(dec._state, name)[:, bid], t), \
                    (req.rid, name)
        checked.append(req.rid)
    dec._adopt_slot = check
    router = ReplicaRouter([pre, dec], affinity=False, steal=False)
    reqs = _mk_reqs(TE, TS, _prompts(vocab, [8, 40, 20], seed=23), 3)
    router.serve(reqs)
    router.stop()
    assert sorted(checked) == [0, 1, 2]
    assert all(r.state is RequestState.DONE for r in reqs)
    pre.pool.assert_leak_free()
    dec.pool.assert_leak_free()


# -- load snapshots under prefill sentinel slots -------------------------------

def test_load_snapshot_pins_mid_prefill_slot(weights):
    vocab = weights[0].vocab_size
    snaps = {}
    for jax_side, mod, smod, *_ in SIDES:
        eng = _engine(weights, jax_side, max_len=32, batch_slots=2,
                      block_size=8, pool_blocks=12, prefill_chunk=8)
        free0 = eng.pool.free_blocks
        for i, p in enumerate(_prompts(vocab, [16, 16, 16], seed=5)):
            eng.submit(mod.Request(i, p, max_new_tokens=4,
                                   sampler=smod.greedy()))
        eng._step()
        poses = sorted(j.pos for j in eng._prefilling.values())
        assert poses == [-1, 8], poses
        snap = eng.scheduler.load_snapshot()
        snaps[jax_side] = (snap.free_slots, snap.queued, snap.queued_tokens,
                           free0 - snap.free_blocks)
        while eng.scheduler.has_work():
            eng._step()
        eng.pool.assert_leak_free()
    assert snaps[False] == (0, 1, 16, 6) == snaps[True]


def test_load_snapshot_pins_inbound_tier_slot(weights):
    """pos == -2 (host-tier fetches inbound): the slot reads as occupied
    with its blocks allocated; the fetch then lands and decode completes
    with the recompute baseline's tokens."""
    cfg = weights[0]
    plan = FaultPlan([FaultSpec("kv.fetch", "delay", delay_s=0.25,
                                count=8)])
    eng = _engine(weights, False, max_len=24, batch_slots=1, block_size=8,
                  pool_blocks=5, host_blocks=16, prefill_chunk=8,
                  fault_plan=plan)
    rng = np.random.default_rng(6)
    prefixes = [rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
                for _ in range(3)]
    tails = [rng.integers(0, cfg.vocab_size, size=4).astype(np.int32)
             for _ in range(2)]
    eng.serve([TE.Request(i, np.concatenate([p, tails[0]]),
                          max_new_tokens=3, sampler=TS.greedy())
               for i, p in enumerate(prefixes)])
    assert eng.totals.kv_spills > 0
    prompt = np.concatenate([prefixes[0], tails[1]])
    ref = TE.Request(7, prompt, max_new_tokens=4, sampler=TS.greedy())
    _engine(weights, False, max_len=24, batch_slots=1,
            block_size=8).serve([ref])
    req = TE.Request(3, prompt, max_new_tokens=4, sampler=TS.greedy())
    eng.submit(req)
    eng._step()
    (job,) = eng._prefilling.values()
    assert job.pos == -2
    snap = eng.scheduler.load_snapshot()
    assert snap.free_slots == 0
    assert snap.queued == 0 and snap.queued_tokens == 0
    assert snap.free_blocks == 0
    deadline = time.monotonic() + 30.0
    while req.state is not RequestState.DONE:
        assert time.monotonic() < deadline, "inbound-tier slot hung"
        eng._step()
    assert req.output == ref.output
    assert eng.totals.prefix_hits_host > 0
    eng.drain_tier_io()
    eng.pool.assert_leak_free()
    eng.close()
