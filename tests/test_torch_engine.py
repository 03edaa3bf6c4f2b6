"""The port's paged ServingEngine against the JAX reference's, at fp32, on
the same weights (through ``repro_torch.interop``) and the same requests:
greedy outputs must be identical and the deterministic counters equal --
through chunked prefill, seeded shared prefixes and a preemption, with an
fp32 and with an int8 KV pool.  The reference's int8 engine tests
mirrored at its bf16 smoke config: greedy streams within one top-1 flip
of the bf16 pool's, and seeded prefill equal to full recompute token for
token.  Plus the constructor's refusals: no card and no device asked for,
the option this port does not carry yet (disaggregated roles), and the
reference's own (a host tier without paging or without prefix sharing, a
chunk that is not a block multiple).  Contiguous dense serving and
speculative decoding are held in ``test_torch_contiguous.py`` and
``test_torch_spec.py``, faults and the host tier in
``test_torch_faults.py`` and ``test_torch_tiering.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models.registry import fns_for as jax_fns
from repro.serving import engine as JE
from repro.serving import sampler as JS
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.serving import sampler as TS

torch.set_num_threads(1)

COUNTERS = ("prefill_tokens_total", "prefill_tokens_computed",
            "prefix_shared_blocks", "preemptions", "decode_steps",
            "prefill_compiles", "kv_blocks_peak")


@pytest.fixture(scope="module")
def weights():
    cfg = JR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    jp = jax_fns(cfg).init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    tcfg = TR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    return cfg, jp, tcfg, tp


def _mixed(mod, sampler, vocab):
    """Mixed lengths, three of five sharing a 32-token (4-block) prefix."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, vocab, 32).astype(np.int32)
    out = []
    for i, n in enumerate((5, 21, 3, 40, 12)):
        tail = rng.integers(0, vocab, n).astype(np.int32)
        prompt = np.concatenate([prefix, tail]) if i % 2 == 0 else tail
        out.append(mod.Request(i, prompt, max_new_tokens=4 + i,
                               sampler=sampler.greedy()))
    return out, []


def _preempting(mod, sampler, vocab):
    """An anchor and a lower-priority victim share a prefix; a
    higher-priority request arriving mid-decode finds no free slot and
    preempts the victim, which resumes seeded from the surviving prefix."""
    rng = np.random.default_rng(17)
    prefix = rng.integers(0, vocab, 16).astype(np.int32)
    tail = lambda: rng.integers(0, vocab, 4).astype(np.int32)  # noqa: E731
    first = [mod.Request(0, np.concatenate([prefix, tail()]),
                         max_new_tokens=24, sampler=sampler.greedy(),
                         priority=1),
             mod.Request(1, np.concatenate([prefix, tail()]),
                         max_new_tokens=8, sampler=sampler.greedy())]
    later = [mod.Request(2, np.arange(8, dtype=np.int32), max_new_tokens=2,
                         sampler=sampler.greedy(), priority=2)]
    return first, later


def _drive(eng, first, later, steps_before=3):
    """Submit ``first``, step, submit ``later``, run to completion -- the
    same executor schedule on either engine."""
    base = eng.begin_window()
    for r in first + later:
        eng._check_fits(r)
    for r in first:
        eng.scheduler.submit(r)
    for _ in range(steps_before):
        eng._step()
    for r in later:
        eng.scheduler.submit(r)
    while eng.scheduler.has_work():
        eng._step()
    return eng.collect_window(base, first + later, 0.0)


WORKLOADS = [
    (_mixed, dict(max_len=80, batch_slots=3, prefill_chunk=16)),
    (_mixed, dict(max_len=80, batch_slots=3)),
    (_preempting, dict(max_len=44, batch_slots=2, pool_blocks=10)),
    (_preempting, dict(max_len=44, batch_slots=2, pool_blocks=10,
                       prefill_chunk=16)),
]
WORKLOAD_IDS = ["mixed-chunk16", "mixed-unchunked", "preempt", "preempt-chunk16"]


@pytest.mark.parametrize(
    "workload,kw",
    WORKLOADS + [(w, dict(kw, cache_dtype="int8")) for w, kw in WORKLOADS],
    ids=WORKLOAD_IDS + [f"{i}-int8" for i in WORKLOAD_IDS])
def test_engine_matches_jax_engine(weights, workload, kw):
    """The fp32 pool, and the int8 pool (both engines quantize the same
    rows on write and dequantize them in the attention)."""
    cfg, jp, tcfg, tp = weights
    kw = dict(dict(block_size=8, cache_dtype="float32"), **kw)
    jreqs = workload(JE, JS, cfg.vocab_size)
    treqs = workload(TE, TS, cfg.vocab_size)
    jeng = JE.ServingEngine(cfg, jp, paged=True, **kw)
    teng = TE.ServingEngine(tcfg, tp, device="cpu", **kw)
    js = _drive(jeng, *jreqs)
    dispatch.reset_counts()
    ts = _drive(teng, *treqs)
    jout = [r.output for r in jreqs[0] + jreqs[1]]
    tout = [r.output for r in treqs[0] + treqs[1]]
    assert tout == jout
    assert all(r.state is TE.RequestState.DONE for r in treqs[0] + treqs[1])
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.prefill_tokens_computed < ts.prefill_tokens_total  # seeded
    if workload is _preempting:
        assert ts.preemptions >= 1
    assert teng.pool.leak_report() == {"unheld_blocks": 0, "held_with_extra_refs": 0,
                                       "reserved_blocks": 0, "host_pending": 0}
    table = dispatch.kernel_table()
    assert table["paged_prefill_attention"].plain_calls > 0
    assert table["paged_decode_attention"].plain_calls > 0
    assert all(k.launches == 0 for k in table.values())
    quant = kw["cache_dtype"] == "int8"
    assert isinstance(teng._state, TT.QuantPagedKVCache) == quant
    assert teng._state.k.dtype == (torch.int8 if quant else torch.float32)


def _smoke_bf16():
    """The reference's int8 engine tests' setting: the smoke config as it
    is (bf16 compute), weights from PRNGKey(0)."""
    cfg = JR.smoke("qwen2.5-3b")
    jp = jax_fns(cfg).init(cfg, jax.random.PRNGKey(0))
    return TR.smoke("qwen2.5-3b"), params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp))


def test_paged_engine_int8_cache_top1_stable():
    """Mirror of ``tests/test_paged_kv.py::
    test_paged_engine_int8_cache_top1_stable``: greedy streams of the int8
    pool match the bf16 pool's up to at most one top-1 flip event (the
    first divergence of a request; what follows decodes another context)."""
    tcfg, tp = _smoke_bf16()
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab_size, size=10).astype(np.int32)
               for _ in range(2)]
    mk = lambda: [TE.Request(i, p, max_new_tokens=4,  # noqa: E731
                             sampler=TS.greedy()) for i, p in enumerate(prompts)]
    bf = TE.ServingEngine(tcfg, tp, max_len=16, batch_slots=2, device="cpu")
    q8 = TE.ServingEngine(tcfg, tp, max_len=16, batch_slots=2,
                          cache_dtype="int8", device="cpu")
    rb, rq = mk(), mk()
    bf.serve(rb)
    q8.serve(rq)
    flips = sum(any(a != b for a, b in zip(ra.output, rb_.output))
                for ra, rb_ in zip(rb, rq))
    assert flips <= 1
    assert q8._state.k.dtype == torch.int8
    assert q8._state.k_scale.dtype == torch.float32


def _prefix_workload(vocab, n=4, prefix_tokens=32, seed=11):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=prefix_tokens).astype(np.int32)
    return [TE.Request(i, np.concatenate(
                [prefix, rng.integers(0, vocab, size=5).astype(np.int32)]),
                max_new_tokens=4, sampler=TS.greedy()) for i in range(n)]


def test_int8_seeded_prefill_matches_recompute_exactly():
    """Mirror of ``tests/test_paged_prefill.py::
    test_seeded_prefill_matches_recompute_exactly[int8]``: a seeded prefill
    (the shared prefix read from the int8 pool, never re-run) gives greedy
    continuations identical to the full-recompute baseline, where both
    read the same quantized prefix rows."""
    tcfg, tp = _smoke_bf16()
    kw = dict(max_len=48, batch_slots=4, paged=True, block_size=8,
              cache_dtype="int8", device="cpu")
    seeded = TE.ServingEngine(tcfg, tp, **kw)
    recomp = TE.ServingEngine(tcfg, tp, seeded_prefill=False, **kw)
    rs = _prefix_workload(tcfg.vocab_size)
    rr = _prefix_workload(tcfg.vocab_size)
    ss = seeded.serve(rs)
    sr = recomp.serve(rr)
    assert [r.output for r in rs] == [r.output for r in rr]
    assert sr.prefill_tokens_computed == sr.prefill_tokens_total
    assert ss.prefill_tokens_total == sr.prefill_tokens_total
    assert ss.prefill_tokens_computed == ss.prefill_tokens_total - 3 * 32
    assert ss.prefix_shared_blocks == sr.prefix_shared_blocks == 12
    assert seeded.pool.leak_report() == {"unheld_blocks": 0, "held_with_extra_refs": 0,
                                         "reserved_blocks": 0, "host_pending": 0}
    assert seeded.pool.free_blocks == seeded.pool.capacity


def test_serve_blocking_matches_jax(weights):
    """The blocking ``serve`` entry point end to end."""
    cfg, jp, tcfg, tp = weights
    kw = dict(max_len=80, batch_slots=2, block_size=8, cache_dtype="float32",
              prefill_chunk=32)
    jreqs, _ = _mixed(JE, JS, cfg.vocab_size)
    treqs, _ = _mixed(TE, TS, cfg.vocab_size)
    js = JE.ServingEngine(cfg, jp, paged=True, **kw).serve(jreqs)
    ts = TE.ServingEngine(tcfg, tp, device="cpu", **kw).serve(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert ts.tokens == js.tokens and ts.requests == js.requests
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name


def test_engine_defaults_to_the_card(weights, monkeypatch):
    """With no ``device`` the engine runs on CUDA; with no card it raises
    instead of carrying on on the CPU."""
    _, _, tcfg, tp = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.ServingEngine(tcfg, tp)


@pytest.mark.parametrize("kw,match", [
    (dict(paged=False, host_blocks=4), "tier"),
    (dict(paged=False, role="prefill"), "role"),
    (dict(prefix_sharing=False, host_blocks=4), "tier"),
    (dict(prefill_chunk=24), "multiple of block_size"),
])
def test_constructor_refuses_what_is_not_ported(weights, kw, match):
    _, _, tcfg, tp = weights
    with pytest.raises(ValueError, match=match):
        TE.ServingEngine(tcfg, tp, device="cpu", **kw)


def test_constructor_refuses_other_families(weights):
    """Every family of the repo's configs serves now; a family with no
    model functions is refused, and so is a paged engine for the audio
    family, which has no paged pool (as the reference's)."""
    _, _, _, tp = weights
    with pytest.raises(ValueError, match="not ported"):
        TE.ServingEngine(TR.smoke("qwen2.5-3b").replace(family="diffusion"), tp,
                         device="cpu")
    with pytest.raises(ValueError, match="paged-KV"):
        TE.ServingEngine(TR.smoke("whisper-medium"), tp, paged=True, device="cpu")


def test_serve_stats_merge_rules_cover_every_field():
    names = {f.name for f in dataclasses.fields(TE.ServeStats)}
    assert set(TE.MERGE_RULES) == names
    assert {n for n, r in TE.MERGE_RULES.items() if r == "derived"} \
        == set(TE._DERIVED)
    assert TE.MERGE_RULES == JE.MERGE_RULES


def test_prefix_digests_match_reference():
    toks = np.arange(50, dtype=np.int32)
    assert TE.prefix_digests(toks, 8) == JE.prefix_digests(toks, 8)
