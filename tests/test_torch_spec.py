"""The port's speculative decoding against the JAX package, at
``qwen2.5-3b-smoke`` with fp32 compute, on the same weights (through
``repro_torch.interop``) and requests made from numpy seeds.  On the CPU
every kernel wrapper runs its plain version: the verify pass K2's, the
drafter's decode steps K1's and its seeds K2's.

* ``greedy_accept_prefix``, ``KVBlockPool.release_provisional`` (with its
  refusals) and the scheduler's ``spec_rows`` admission: equal to the
  reference's, exactly.
* ``verify_paged`` (the ``write_ids=None`` layout: candidate rows at
  mid-block ``q_start``, a padding slot on an all-trash table): logits
  within 1e-5 of the largest (fp32 pool, other summation orders; 1e-4 for
  a bf16 pool, whose rows may round one bf16 step apart) and the pool rows
  it writes within 1e-5 of the largest (fp32) or one bf16 step (2^-7 of
  the largest); an int8 pool: logits within 1e-4 (atol 1e-4), its int8
  rows equal or one quantization step apart (share < 1e-3) and scales
  within 1e-5 relative.
* Every case of ``tests/test_spec_decode.py`` mirrored on the port's
  engine (oracle and adversary stub drafters, the shared-weight drafter,
  acceptance across a block boundary, a preempted speculative slot, int8
  spec against int8 vanilla): greedy tokens equal vanilla greedy's, and
  ``verify_steps``, ``decode_steps``, ``spec_proposed``, ``spec_accepted``
  (and the other deterministic counters) equal the JAX engine's on the
  same run; both pools leak-free.
* The launcher's ``--draft-model``, ``--spec-k`` and ``--no-spec`` on the
  CPU, and its refusal of ``--draft-model`` with ``--contiguous-kv``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import transformer as JT
from repro.models.registry import fns_for as jax_fns
from repro.serving import engine as JE
from repro.serving import kv_pool as JP
from repro.serving import sampler as JS
from repro.serving import scheduler as JSch
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.models.registry import fns_for
from repro_torch.serving import engine as TE
from repro_torch.serving import kv_pool as TP
from repro_torch.serving import sampler as TS
from repro_torch.serving import scheduler as TSch

torch.set_num_threads(1)

CLEAN = {"unheld_blocks": 0, "held_with_extra_refs": 0, "reserved_blocks": 0,
         "host_pending": 0}
SPEC_COUNTERS = ("verify_steps", "decode_steps", "spec_proposed",
                 "spec_accepted", "accept_rate", "tokens", "prefills",
                 "prefill_compiles", "kv_blocks_peak", "preemptions")


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32))


def _rel(t, j):
    t, j = _f32(t), _f32(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


@pytest.fixture(scope="module")
def weights():
    cfg = JR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    tcfg = TR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    jp = jax_fns(cfg).init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jp, tcfg, tp


# -- host-side pieces ---------------------------------------------------------

def test_greedy_accept_prefix_matches_reference():
    V = 5
    logits = np.full((3, 4, V), -1.0)
    chains = [[2, 3, 1, 4], [0, 3, 1, 4], [2, 3, 0, 4]]
    for b, chain in enumerate(chains):
        for j, t in enumerate(chain):
            logits[b, j, t] = 1.0
    drafts = np.array([[2, 3, 1]] * 3)
    accepted, targets = TS.greedy_accept_prefix(logits, drafts)
    assert accepted.tolist() == [3, 0, 2] and targets.tolist() == chains
    rng = np.random.default_rng(0)
    for k in (1, 3, 5):
        lg = rng.standard_normal((16, k + 1, 7)).astype(np.float32)
        tgt = lg.argmax(-1)
        # drafts that follow the chain for a random prefix, then miss
        cut = rng.integers(0, k + 1, 16)
        dr = np.where(np.arange(k)[None] < cut[:, None], tgt[:, :-1],
                      (tgt[:, :-1] + 1) % 7)
        for t, j in zip(TS.greedy_accept_prefix(lg, dr),
                        JS.greedy_accept_prefix(lg, dr)):
            assert t.dtype == j.dtype and np.array_equal(t, j)
        assert np.array_equal(TS.greedy_accept_prefix(lg, dr)[0], cut)


def _pool_state(pool, n):
    return ([pool.generation(b) for b in range(n + 1)], pool.free_blocks,
            pool.available_blocks, pool.peak_used)


def test_release_provisional_matches_reference():
    """Grow-then-reject: the released blocks come back reserved, with their
    generations rolled back, exactly as in the reference; shared and
    unallocated blocks are refused before anything changes."""
    n = 8
    tp, jp = TP.KVBlockPool(n, 4), JP.KVBlockPool(n, 4)
    for pool in (tp, jp):
        assert pool.reserve(6)
    ids = [pool.alloc_reserved(4) for pool in (tp, jp)]
    assert ids[0] == ids[1]
    ids = ids[0]
    assert _pool_state(tp, n) == _pool_state(jp, n)
    for pool in (tp, jp):
        pool.release_provisional(ids[2:])
    assert _pool_state(tp, n) == _pool_state(jp, n)
    assert tp.leak_report() == dict(CLEAN, unheld_blocks=2, reserved_blocks=4)
    assert (jp.used_blocks, jp.reserved_blocks) == (2, 4)
    # the released blocks are handed out again, generations as before
    assert [p.alloc_reserved(2) for p in (tp, jp)] == [ids[2:][::-1]] * 2
    assert _pool_state(tp, n) == _pool_state(jp, n)
    for pool in (tp, jp):
        pool.share([ids[0]])
    for pool, mod in ((tp, TP), (jp, JP)):
        before = _pool_state(pool, n)
        with pytest.raises(ValueError, match="shared KV block"):
            pool.release_provisional([ids[1], ids[0]])
        with pytest.raises(ValueError, match="unallocated KV block"):
            pool.release_provisional([ids[1], 7])
        assert _pool_state(pool, n) == before       # nothing mutated
    for pool in (tp, jp):
        pool.free([ids[0], ids[0]] + ids[1:])
        pool.unreserve(2)
    assert tp.leak_report() == CLEAN
    assert _pool_state(tp, n) == _pool_state(jp, n)


def test_spec_rows_admission_matches_reference():
    """Admission reserves ``kv_rows + spec_rows`` rows of blocks, and a
    request whose rows fit the pool only without the overhang is refused
    at submit."""
    for spec_rows in (0, 4):
        admitted = []
        for mod_sch, mod_pool in ((TSch, TP), (JSch, JP)):
            pool = mod_pool.KVBlockPool(9, 8)
            sch = mod_sch.ContinuousScheduler(3, pool=pool,
                                              spec_rows=spec_rows)
            assert sch.spec_rows == spec_rows
            reqs = [mod_sch.Request(i, np.zeros(n, np.int32),
                                    max_new_tokens=m)
                    for i, (n, m) in enumerate(((9, 8), (20, 4), (5, 12)))]
            for r in reqs:
                sch.submit(r)
            got = [(s, r.rid, r.blocks_reserved) for s, r in sch.admit()]
            admitted.append((got, pool.free_blocks))
            with pytest.raises(mod_pool.CapacityError):
                sch.submit(mod_sch.Request(9, np.zeros(60, np.int32),
                                           max_new_tokens=17 - spec_rows))
        assert admitted[0] == admitted[1]
    # with the overhang the third request no longer fits beside the others
    assert [rid for _, rid, _ in admitted[0][0]] == [0, 1]


# -- the verify pass ----------------------------------------------------------

BS, MB = 8, 6


def _verify_inputs(vocab, num_layers, K, D, pool_dtype):
    """Pools (L, N, BS, K, D) of random rows, per-slot tables, candidate
    tokens: three live slots at mid-block q_start, the fourth padding
    (all-trash table, q_start 0, kv_len C)."""
    rng = np.random.default_rng(7)
    C, live = 4, 3
    N = 1 + live * MB
    tables = np.zeros((4, MB), np.int32)
    tables[:live] = (1 + rng.permutation(live * MB)).reshape(live, MB)
    q_start = np.array([9, 27, 3, 0], np.int32)
    kv_len = q_start + C
    tokens = rng.integers(0, vocab, (4, C)).astype(np.int32)
    shape = (num_layers, N, BS, K, D)
    k = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    v = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    if pool_dtype == "int8":
        (kq, ks), (vq, vs) = JT.quantize_kv(k), JT.quantize_kv(v)
        pools = dict(k=kq, v=vq, k_scale=ks, v_scale=vs)
    else:
        pools = dict(k=k.astype(pool_dtype), v=v.astype(pool_dtype))
    return pools, tables, q_start, kv_len, tokens


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16", "int8"])
def test_verify_paged_matches_reference(weights, pool_dtype):
    cfg, jp, tcfg, tp = weights
    tp = T.prepare_params(tcfg, tp, "cpu")
    pools, tables, q_start, kv_len, tokens = _verify_inputs(
        cfg.vocab_size, cfg.num_layers, cfg.num_kv_heads,
        cfg.resolved_head_dim, pool_dtype)
    B = tables.shape[0]
    quant = pool_dtype == "int8"
    jcls = JT.QuantPagedKVCache if quant else JT.PagedKVCache
    tcls = T.QuantPagedKVCache if quant else T.PagedKVCache
    zeros = np.zeros((B, MB), np.int32), np.zeros((B,), np.int32)
    jc = jcls(**pools, block_tables=jnp.asarray(zeros[0]),
              length=jnp.asarray(zeros[1]))
    tc = tcls(**{n: tensor_from_numpy(np.asarray(a)) for n, a in pools.items()},
              block_tables=torch.from_numpy(zeros[0]),
              length=torch.from_numpy(zeros[1]))
    jl, jc = jax_fns(cfg).verify_paged(
        cfg, jp, jnp.asarray(tokens), jc, jnp.asarray(tables),
        q_start=jnp.asarray(q_start), kv_len=jnp.asarray(kv_len))
    dispatch.reset_counts()
    k_before = tc.k
    tl, tc = fns_for(tcfg).verify_paged(
        tcfg, tp, torch.from_numpy(tokens), tc, torch.from_numpy(tables),
        q_start=torch.from_numpy(q_start), kv_len=torch.from_numpy(kv_len))
    assert tc.k is k_before                        # written in place
    table = dispatch.kernel_table()
    assert table["paged_prefill_attention"].plain_calls == tcfg.num_layers
    assert table["paged_decode_attention"].plain_calls == 0
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape \
        == (B, 4, cfg.vocab_size)
    live = slice(0, 3)                             # the padding slot: garbage
    if quant:
        np.testing.assert_allclose(_f32(tl[live]), _f32(jl[live]), rtol=1e-4,
                                   atol=1e-4)
    else:
        assert _rel(tl[live], jl[live]) <= (1e-5 if pool_dtype == "float32"
                                            else 1e-4)
    # every block but the trash block (the padding slot's rows race there)
    for name in ("k", "v"):
        t, j = getattr(tc, name)[:, 1:], np.asarray(getattr(jc, name))[:, 1:]
        was = np.asarray(pools[name])[:, 1:]
        assert not np.array_equal(_f32(t), _f32(was))   # candidate rows landed
        if quant:
            apart = np.abs(t.numpy().astype(np.int32) - j.astype(np.int32))
            assert apart.max() <= 1 and (apart > 0).mean() < 1e-3, name
        else:
            assert _rel(t, j) <= (1e-5 if pool_dtype == "float32"
                                  else 2 ** -7), name
    if quant:
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tc, name)[:, 1:].numpy(),
                                       np.asarray(getattr(jc, name))[:, 1:],
                                       rtol=1e-5, atol=0)


# -- the engine: tests/test_spec_decode.py mirrored ---------------------------

def _prompts(vocab, n, size, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=size).astype(np.int32)
            for _ in range(n)]


class _StubDrafter:
    """The reference test's drafter stub, for either engine.  ``oracle``
    proposes the vanilla continuation (accept all k); ``adversary`` tokens
    that miss the target's argmax (accept none)."""

    def __init__(self, eng, continuations, k, vocab, mode):
        self.eng = eng
        self.cont = continuations
        self.k = k
        self.vocab = vocab
        self.mode = mode
        self._lens: dict[int, int] = {}

    def seed(self, slot, tokens, rows):
        self._lens[slot] = len(tokens)

    def drop(self, slot):
        self._lens.pop(slot, None)

    def set_len(self, slot, rows):
        self._lens[slot] = rows

    def length(self, slot):
        return self._lens.get(slot, 0)

    def propose(self, jobs):
        out = {}
        for slot, queue in jobs:
            req = self.eng.scheduler.slots[slot]
            seq = self.cont[req.rid]
            n = len(req.output)
            want = [int(t) for t in seq[n + 1:n + 1 + self.k]]
            while len(want) < self.k:
                want.append(0)
            if self.mode == "adversary":
                want = [(t + 1) % self.vocab for t in want]
            self._lens[slot] = self._lens.get(slot, 0) + len(queue)
            out[slot] = want
        return out


def _serve(mod, sampler, cfg, params, prompts, max_new, *, spec, drafter=None,
           **kw):
    """One engine of package ``mod`` over the prompts: (outputs by rid,
    stats, engine)."""
    extra = dict(draft_cfg=cfg, draft_params=params) if spec else {}
    if mod is TE:
        extra["device"] = "cpu"
    else:
        extra["paged"] = True
    eng = mod.ServingEngine(cfg, params, **extra, **kw)
    if drafter is not None:
        eng._drafter = drafter(eng)
    reqs = [mod.Request(i, p.copy(), max_new_tokens=max_new,
                        sampler=sampler.greedy())
            for i, p in enumerate(prompts)]
    st = eng.serve(reqs)
    return {r.rid: list(r.output) for r in reqs}, st, eng


def _both_spec(weights, prompts, max_new, *, mode=None, **kw):
    """The vanilla paged greedy baseline (the port's, equal to the JAX
    engine's), then the same requests speculatively on both engines --
    with the stub drafter ``mode`` where given.  Holds the port's tokens
    to the baseline and its counters to the JAX engine's.  Returns
    (port stats, baseline stats, port spec engine)."""
    cfg, jp, tcfg, tp = weights
    vkw = {k: v for k, v in kw.items() if k != "spec_k"}
    base, st0, _ = _serve(TE, TS, tcfg, tp, prompts, max_new, spec=False,
                          **vkw)
    jbase, _, _ = _serve(JE, JS, cfg, jp, prompts, max_new, spec=False, **vkw)
    assert base == jbase
    stub = (None if mode is None else
            lambda e: _StubDrafter(e, base, kw.get("spec_k", 3),
                                   cfg.vocab_size, mode))
    out, st, eng = _serve(TE, TS, tcfg, tp, prompts, max_new, spec=True,
                          drafter=stub, **kw)
    jout, jst, _ = _serve(JE, JS, cfg, jp, prompts, max_new, spec=True,
                          drafter=stub, **kw)
    assert out == base == jout
    for name in SPEC_COUNTERS:
        assert getattr(st, name) == getattr(jst, name), name
    assert eng.pool.leak_report() == CLEAN
    if isinstance(eng._drafter, TE._Drafter):
        assert eng._drafter.pool.leak_report() == CLEAN
    return st, st0, eng


KW = dict(max_len=32, batch_slots=2, block_size=8, cache_dtype="float32")


def test_oracle_drafter_accepts_all_k(weights):
    prompts = _prompts(weights[0].vocab_size, 3, 9, seed=3)
    st, st0, _ = _both_spec(weights, prompts, 8, mode="oracle", spec_k=3,
                            **KW)
    assert st.verify_steps == 4 and st.decode_steps == 0
    assert st.accept_rate == 1.0
    assert st.spec_proposed == st.spec_accepted == 3 * 2 * 3
    assert st0.decode_steps == 2 * 7
    assert st.steps_per_token < st0.steps_per_token


def test_adversarial_drafter_accepts_zero(weights):
    prompts = _prompts(weights[0].vocab_size, 2, 9, seed=4)
    st, st0, _ = _both_spec(weights, prompts, 6, mode="adversary", spec_k=3,
                            **KW)
    assert st.verify_steps == 6 and st0.decode_steps == 5
    assert st.spec_accepted == 0 and st.accept_rate == 0.0


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_real_drafter_shared_weights_bit_identical(weights, cache_dtype):
    """Self-speculation: the drafter runs on the engine's own prepared
    weights (no second copy), and the output is vanilla greedy's."""
    prompts = _prompts(weights[0].vocab_size, 3, 9, seed=5)
    kw = dict(KW, cache_dtype=cache_dtype)
    dispatch.reset_counts()
    st, st0, eng = _both_spec(weights, prompts, 10, spec_k=3, **kw)
    assert eng._drafter.params is eng.params
    assert st.accept_rate is not None and st.accept_rate > 0.5
    assert st.decode_steps + st.verify_steps < st0.decode_steps
    assert all(k.launches == 0 for k in dispatch.kernel_table().values())


def test_acceptance_crosses_block_boundary_mid_verify(weights):
    prompts = _prompts(weights[0].vocab_size, 2, 6, seed=6)
    st, _, _ = _both_spec(weights, prompts, 8, mode="oracle", spec_k=3, **KW)
    assert st.accept_rate == 1.0


def _preempt_run(mod, sampler, cfg, params, vanilla_expect=None):
    """The reference test's schedule: an anchor and a victim share a
    prefix, a higher-priority arrival after two steps evicts the victim.
    Returns (anchor, victim, high, resumes, engine, stats)."""
    bs = 8
    rng = np.random.default_rng(17)
    prefix = rng.integers(0, cfg.vocab_size, size=2 * bs).astype(np.int32)
    anchor_p = np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, size=4).astype(np.int32)])
    victim_p = np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, size=4).astype(np.int32)])
    kw = dict(max_len=44, batch_slots=2, block_size=bs, pool_blocks=11,
              draft_cfg=cfg, draft_params=params, spec_k=3,
              cache_dtype="float32")
    kw.update(dict(device="cpu") if mod is TE else dict(paged=True))
    eng = mod.ServingEngine(cfg, params, **kw)
    resumes = []
    orig = eng._materialize_blocks

    def spy(job):
        orig(job)
        resumes.append((job.req.rid, list(job.tokens)))
    eng._materialize_blocks = spy
    anchor = mod.Request(0, anchor_p, max_new_tokens=16,
                         sampler=sampler.greedy(), priority=1)
    victim = mod.Request(1, victim_p, max_new_tokens=24,
                         sampler=sampler.greedy(), priority=0)
    base = eng.begin_window()
    eng.scheduler.submit(anchor)
    eng.scheduler.submit(victim)
    for _ in range(2):
        eng._step()
    high = mod.Request(2, np.arange(8, dtype=np.int32), max_new_tokens=2,
                       sampler=sampler.greedy(), priority=2)
    eng.scheduler.submit(high)
    while eng.scheduler.has_work():
        eng._step()
    st = eng.collect_window(base, [anchor, victim, high], 0.0)
    return anchor, victim, high, resumes, eng, st, victim_p


def test_spec_slot_preempted_folds_only_committed_tokens(weights):
    cfg, jp, tcfg, tp = weights
    anchor, victim, high, resumes, eng, st, victim_p = _preempt_run(
        TE, TS, tcfg, tp)
    *_, jst, _ = _preempt_run(JE, JS, cfg, jp)
    vanilla, _, _ = _serve(TE, TS, tcfg, tp, [victim_p], 24, spec=False,
                           max_len=44, batch_slots=1, block_size=8,
                           cache_dtype="float32")
    expect = vanilla[0]
    assert victim.preempted_count >= 1
    assert victim.output == expect
    assert len(anchor.output) == 16 and len(high.output) == 2
    rid1 = [toks for rid, toks in resumes if rid == 1]
    assert len(rid1) >= 2
    folded = rid1[-1][len(victim_p):]
    assert folded == expect[:len(folded)]
    for name in SPEC_COUNTERS:
        assert getattr(st, name) == getattr(jst, name), name
    assert eng.pool.leak_report() == CLEAN
    assert eng._drafter.pool.leak_report() == CLEAN


def test_int8_pool_spec_matches_int8_vanilla(weights):
    """Both arms read the same quantized pool, so the outputs agree token
    for token."""
    prompts = _prompts(weights[0].vocab_size, 3, 9, seed=8)
    st, st0, eng = _both_spec(weights, prompts, 8, spec_k=3,
                              **dict(KW, cache_dtype="int8"))
    assert isinstance(eng._state, T.QuantPagedKVCache)
    assert isinstance(eng._drafter._state, T.QuantPagedKVCache)
    assert st.decode_steps + st.verify_steps < st0.decode_steps


def test_engine_refuses_speculation_it_cannot_run(weights):
    _, _, tcfg, tp = weights
    with pytest.raises(ValueError, match="paged KV engine"):
        TE.ServingEngine(tcfg, tp, paged=False, draft_cfg=tcfg, device="cpu")
    with pytest.raises(ValueError, match="spec_k=0"):
        TE.ServingEngine(tcfg, tp, draft_cfg=tcfg, spec_k=0, device="cpu")
    eng = TE.ServingEngine(tcfg, tp, max_len=16, batch_slots=2, block_size=8,
                           draft_cfg=tcfg, spec_k=3, device="cpu")
    # the table and the worst-case pool cover the overhang of k + 1 rows
    assert eng.spec_rows == 4 and eng.max_blocks == 3
    assert eng.pool.capacity == 2 * 3
    assert eng._drafter.max_blocks == 3


# -- the launcher -------------------------------------------------------------

def _launch(monkeypatch, capsys, *args):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen2.5-3b",
                                     "--smoke", "--device", "cpu",
                                     "--requests", "3", "--new-tokens", "6",
                                     *args])
    assert serve.main() == 0
    return capsys.readouterr().out


def test_serve_launcher_speculative_on_the_cpu(capsys, monkeypatch):
    spec = _launch(monkeypatch, capsys, "--draft-model", "qwen2.5-3b",
                   "--spec-k", "2")
    plain = _launch(monkeypatch, capsys, "--draft-model", "qwen2.5-3b",
                    "--no-spec")
    assert "requests=3 tokens=18" in spec and "requests=3 tokens=18" in plain
    line = next(ln for ln in spec.splitlines() if ln.startswith("spec:"))
    assert "accept_rate=" in line and "verify_steps=" in line
    assert "spec:" not in plain


def test_serve_launcher_refuses_speculation_on_contiguous_kv(capsys,
                                                            monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen2.5-3b",
                                     "--smoke", "--device", "cpu",
                                     "--contiguous-kv", "--draft-model",
                                     "qwen2.5-3b"])
    with pytest.raises(SystemExit) as e:
        serve.main()
    assert e.value.code == 2
    assert "--draft-model needs the paged KV pool" in capsys.readouterr().err
