"""The port's dense contiguous KV caches against the JAX package, at
``qwen2.5-3b-smoke`` (2 layers, H=4, K=2, D=16) with fp32 compute, on the
same weights (handed over through ``repro_torch.interop``) and the same
tokens, made from a numpy seed.  On the CPU every kernel wrapper runs its
plain version: ``prefill``'s attention K4's, a contiguous decode K3's.

* ``make_cache``: shapes, dtypes and bytes (int8 about half of bf16).
* ``prefill``: logits within 1e-5 of the largest logit (fp32, other
  summation orders), with ``max_len`` growth and ``last_pos``; the cache
  rows within 1e-5 of the largest (fp32) or one bf16 step (2^-7 of the
  largest, a bf16 cache).
* ``decode_step`` on a ``KVCache``: logits within 1e-5 of the largest (an
  fp32 cache; 2^-10 for a bf16 one, whose attention rounds p and each PV
  partial to bf16 in both packages), a slot idle at ``max_len - 1`` that
  writes one row and then nothing.
* The int8 branch: ``seq_sharded_decode_attention`` on the same inputs
  gives the reference's int8 rows and fp32 scales bit for bit, and its
  output within 1e-5 (fp32) / 2e-2 (bf16); ``decode_step`` on a
  ``QuantKVCache`` seeded with the same quantized rows: logits within 1e-4
  (atol 1e-4), the rows it writes equal or one quantization step apart
  (a K/V element on a rounding edge; share < 1e-3) and scales within 1e-5
  relative; the reference's top-1 stability test mirrored at its bf16
  smoke config.
* Serving: the port's ``ServingEngine(paged=False)`` gives the JAX
  engine's greedy tokens and deterministic counters at 1, 2 and 4 slots,
  and K4 / K3 run once a layer of each prefill / decode step.
* The launcher's ``--contiguous-kv`` on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.distributed.collectives import \
    seq_sharded_decode_attention as jax_seq_decode
from repro.models import transformer as JT
from repro.models.registry import fns_for as jax_fns
from repro.serving import engine as JE
from repro.serving import sampler as JS
from repro_torch.configs import registry as TR
from repro_torch.distributed import collectives as TC
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.models.registry import fns_for
from repro_torch.serving import engine as TE
from repro_torch.serving import sampler as TS

torch.set_num_threads(1)

RTOL = 1e-5


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
    return cfg, jp, tcfg, T.prepare_params(tcfg, tp, "cpu")


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _bytes(c):
    return sum(t.numel() * t.element_size() for t in c)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_make_cache_matches_reference(dtype):
    cfg, tcfg = JR.smoke("qwen2.5-3b"), TR.smoke("qwen2.5-3b")
    jc = JT.make_cache(cfg, 2, 32, dtype)
    tc = T.make_cache(tcfg, 2, 32, dtype, device="cpu")
    assert type(tc).__name__ == type(jc).__name__
    assert tc._fields == jc._fields
    for name in jc._fields:
        j, t = getattr(jc, name), getattr(tc, name)
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
        assert not t.any()
    assert tc.max_len == 32
    assert _bytes(tc) == sum(x.size * x.dtype.itemsize
                             for x in jax.tree_util.tree_leaves(jc))
    # test_quant_cache.py::test_quant_cache_bytes_halved: int8 k/v are half
    # of bf16, the fp32 scales add 4 / head_dim
    bf = T.make_cache(tcfg, 2, 32, "bfloat16", device="cpu")
    if dtype == "int8":
        hd = tcfg.resolved_head_dim
        assert _bytes(tc) <= _bytes(bf) * (0.5 + 2.0 / hd) + 128
    ln = torch.tensor([3, 31], dtype=torch.int32)
    assert T.make_cache(tcfg, 2, 32, dtype, num_layers=1, length=ln,
                        device="cpu").length is ln
    assert T.make_cache(tcfg, 2, 32, dtype, num_layers=1,
                        device="cpu").k.shape[0] == 1


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_len,last_pos", [(None, None), (40, None),
                                              (40, (20, 7))])
def test_prefill_matches_reference(weights, cache_dtype, max_len, last_pos):
    cfg, jp, tcfg, tp = weights
    toks = _tokens(cfg.vocab_size, (2, 21))
    lp = None if last_pos is None else np.asarray(last_pos, np.int32)
    jl, jc = JT.prefill(cfg, jp, jnp.asarray(toks), cache_dtype=cache_dtype,
                        max_len=max_len,
                        last_pos=None if lp is None else jnp.asarray(lp))
    dispatch.reset_counts()
    tl, tc = T.prefill(tcfg, tp, torch.from_numpy(toks),
                       cache_dtype=cache_dtype, max_len=max_len,
                       last_pos=None if lp is None else torch.from_numpy(lp))
    table = dispatch.kernel_table()
    assert table["flash_attention"].plain_calls == tcfg.num_layers
    assert table["decode_attention"].plain_calls == 0
    assert isinstance(tc, T.KVCache)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert _rel(tl, jl) <= RTOL
    limit = RTOL if cache_dtype == "float32" else 2 ** -7
    for name in ("k", "v"):
        j, t = getattr(jc, name), getattr(tc, name)
        assert tuple(t.shape) == j.shape == (2, 2, max_len or 21, 2, 16)
        assert str(t.dtype)[6:] == str(j.dtype)
        assert _rel(t, j) <= limit, name
        assert not t[:, :, 21:].any()            # grown rows are zero
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [21, 21]


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_steps_with_an_idle_slot_match_reference(weights, cache_dtype):
    """Three slots prefilled, the last then idle at ``max_len - 1`` (as the
    engine's batched state starts): it writes row ``max_len - 1`` once and
    then runs past the cache without writing."""
    cfg, jp, tcfg, tp = weights
    S, max_len, steps = 13, 16, 4
    toks = _tokens(cfg.vocab_size, (3, S), seed=1)
    _, jc = JT.prefill(cfg, jp, jnp.asarray(toks), cache_dtype=cache_dtype,
                       max_len=max_len)
    _, tc = T.prefill(tcfg, tp, torch.from_numpy(toks),
                      cache_dtype=cache_dtype, max_len=max_len)
    idle = np.array([S, S, max_len - 1], np.int32)
    jc = jc._replace(length=jnp.asarray(idle))
    tc = tc._replace(length=torch.from_numpy(idle))
    before = [tc.k.clone(), tc.v.clone()]
    dispatch.reset_counts()
    limit = RTOL if cache_dtype == "float32" else 2 ** -10
    for step in range(steps):
        tok = _tokens(cfg.vocab_size, (3, 1), seed=10 + step)
        jl, jc = JT.decode_step(cfg, jp, jnp.asarray(tok), jc)
        k_before = tc.k
        tl, tc = T.decode_step(tcfg, tp, torch.from_numpy(tok), tc)
        assert tc.k is k_before                  # written in place
        assert _rel(tl[:2], jl[:2]) <= limit, step
    table = dispatch.kernel_table()
    assert table["decode_attention"].plain_calls == steps * tcfg.num_layers
    assert table["paged_decode_attention"].plain_calls == 0
    assert tc.length.tolist() == [S + steps, S + steps, max_len - 1 + steps]
    for name, was in zip(("k", "v"), before):
        j, t = getattr(jc, name), getattr(tc, name)
        assert _rel(t, j) <= (2 ** -7 if cache_dtype == "bfloat16"
                              else limit), name
        # the idle slot's one write landed at max_len - 1 and nowhere else
        assert not torch.equal(t[:, 2, max_len - 1], was[:, 2, max_len - 1])
        assert torch.equal(t[:, 2, :max_len - 1], was[:, 2, :max_len - 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_collectives_int8_branch_matches_reference(dtype):
    """The single-device int8 branch on the same inputs: the written int8
    rows and fp32 scales bit for bit (lengths inside, at the last row, and
    past the cache), in place, and the attention output."""
    rng = np.random.default_rng(3)
    B, S, H, K, D = 4, 24, 8, 2, 16
    lengths = np.array([0, 9, 23, 30], np.int32)
    q, nk, nv = (rng.standard_normal(s).astype(np.float32) for s in
                 ((B, 1, H, D), (B, 1, K, D), (B, 1, K, D)))
    kq, ks = JT.quantize_kv(jnp.asarray(
        3 * rng.standard_normal((B, S, K, D)), jnp.float32))
    vq, vs = JT.quantize_kv(jnp.asarray(
        3 * rng.standard_normal((B, S, K, D)), jnp.float32))
    j_args = [jnp.asarray(a).astype(dtype) for a in (q, nk, nv)]
    t_args = [tensor_from_numpy(np.asarray(a)) for a in j_args]
    j_out, *j_cache = jax_seq_decode(
        j_args[0], kq, vq, j_args[1], j_args[2], jnp.asarray(lengths),
        k_scale=ks, v_scale=vs, chunk=8)
    t_cache = [tensor_from_numpy(np.asarray(a)) for a in (kq, vq, ks, vs)]
    t_out, *t_new = TC.seq_sharded_decode_attention(
        t_args[0], t_cache[0], t_cache[1], t_args[1], t_args[2],
        torch.from_numpy(lengths), k_scale=t_cache[2], v_scale=t_cache[3],
        chunk=8)
    assert all(a is b for a, b in zip(t_new, t_cache))     # in place
    for t, j in zip(t_new, j_cache):
        assert t.dtype == (torch.int8 if j.dtype == jnp.int8 else torch.float32)
        np.testing.assert_array_equal(t.numpy().view(np.int8 if t.dtype == torch.int8
                                                     else np.int32),
                                      np.asarray(j).view(np.int8 if j.dtype == jnp.int8
                                                         else np.int32))
    assert not np.array_equal(t_new[0].numpy(), np.asarray(kq))  # rows written
    np.testing.assert_allclose(_f32(t_out), _f32(j_out), rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_int8_decode_steps_match_reference(weights):
    """``decode_step`` on a :class:`QuantKVCache`: both packages start from
    the reference prefill's rows quantized by their own ``quantize_kv``
    (equal bit for bit), then decode the same tokens."""
    cfg, jp, tcfg, tp = weights
    S, max_len, steps = 12, 16, 3
    toks = _tokens(cfg.vocab_size, (2, S + steps), seed=4)
    _, st = JT.prefill(cfg, jp, jnp.asarray(toks[:, :S]), max_len=max_len,
                       cache_dtype="float32")
    jq = [*JT.quantize_kv(st.k), *JT.quantize_kv(st.v)]
    jc = JT.QuantKVCache(k=jq[0], v=jq[2], k_scale=jq[1], v_scale=jq[3],
                         length=st.length)
    tq = [*T.quantize_kv(tensor_from_numpy(np.asarray(st.k))),
          *T.quantize_kv(tensor_from_numpy(np.asarray(st.v)))]
    for t, j in zip(tq, jq):
        np.testing.assert_array_equal(_f32(t), _f32(j))
    tc = T.QuantKVCache(k=tq[0], v=tq[2], k_scale=tq[1], v_scale=tq[3],
                        length=tensor_from_numpy(np.asarray(st.length)))
    dispatch.reset_counts()
    for t in range(S, S + steps):
        tok = toks[:, t:t + 1]
        jl, jc = JT.decode_step(cfg, jp, jnp.asarray(tok), jc)
        tl, tc = T.decode_step(tcfg, tp, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    assert dispatch.kernel_table()["decode_attention"].plain_calls == \
        steps * tcfg.num_layers
    assert tc.k.dtype == torch.int8 and tc.k_scale.dtype == torch.float32
    for name in ("k", "v"):
        t = getattr(tc, name).numpy().astype(np.int32)
        j = np.asarray(getattr(jc, name)).astype(np.int32)
        apart = np.abs(t - j)
        assert apart.max() <= 1 and (apart > 0).mean() < 1e-3, name
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), rtol=1e-5,
                                   atol=0)
    assert tc.length.tolist() == np.asarray(jc.length).tolist()


def test_int8_cache_decode_top1_stable():
    """Mirror of ``tests/test_quant_cache.py::
    test_int8_cache_decode_top1_stable`` at its bf16 smoke config: decoding
    from an int8 cache stays within 0.15 of the largest logit of the full
    forward, and its top-1 agrees on all but at most one token."""
    cfg = JR.smoke("qwen2.5-3b")
    jp = jax_fns(cfg).init(cfg, jax.random.PRNGKey(0))
    tcfg = TR.smoke("qwen2.5-3b")
    tp = T.prepare_params(tcfg, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp)), "cpu")
    B, S, extra = 2, 12, 3
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, S + extra), seed=1))
    full, _ = T.forward(tcfg, tp, toks, remat=False)
    _, st = T.prefill(tcfg, tp, toks[:, :S], max_len=S + extra)
    kq, ks = T.quantize_kv(st.k)
    vq, vs = T.quantize_kv(st.v)
    qc = T.QuantKVCache(k=kq, v=vq, k_scale=ks, v_scale=vs, length=st.length)
    agree = 0
    for t in range(S, S + extra):
        lg, qc = T.decode_step(tcfg, tp, toks[:, t:t + 1], qc)
        ref = full[:, t]
        assert float((lg - ref).abs().max() / ref.abs().max()) < 0.15
        agree += int((lg.argmax(-1) == ref.argmax(-1)).sum())
    assert agree >= 2 * extra - 1
    assert qc.k.dtype == torch.int8


def _requests(mod, sampler, vocab):
    rng = np.random.default_rng(5)
    return [mod.Request(i, rng.integers(0, vocab, n).astype(np.int32),
                        max_new_tokens=3 + i, sampler=sampler.greedy())
            for i, n in enumerate((7, 33, 20, 41, 12))]


COUNTERS = ("prefill_tokens_total", "prefill_tokens_computed", "prefills",
            "decode_steps", "prefill_compiles", "tokens", "kv_blocks_peak",
            "verify_steps", "spec_proposed")


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_contiguous_engine_matches_jax_engine(weights, slots):
    cfg, jp, tcfg, tp = weights
    je = JE.ServingEngine(cfg, jp, paged=False, max_len=64,
                          batch_slots=slots, chunk=16)
    jr = _requests(JE, JS, cfg.vocab_size)
    js = je.serve(jr)
    dispatch.reset_counts()
    te = TE.ServingEngine(tcfg, tp, paged=False, max_len=64,
                          batch_slots=slots, chunk=16, device="cpu")
    tr = _requests(TE, TS, tcfg.vocab_size)
    ts = te.serve(tr)
    assert not te.paged and te.pool is None
    assert isinstance(te._state, T.KVCache)
    assert te._state.k.dtype == torch.bfloat16      # the reference's default
    assert [r.output for r in tr] == [r.output for r in jr]
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    table = dispatch.kernel_table()
    L = tcfg.num_layers
    assert table["flash_attention"].plain_calls == L * ts.prefills
    assert table["decode_attention"].plain_calls == L * ts.decode_steps
    assert table["paged_decode_attention"].plain_calls == 0
    assert table["paged_prefill_attention"].plain_calls == 0
    assert all(k.launches == 0 for k in table.values())


def test_contiguous_engine_int8_builds_bf16_caches_as_the_reference(weights):
    cfg, jp, tcfg, tp = weights
    je = JE.ServingEngine(cfg, jp, paged=False, max_len=64, batch_slots=2,
                          chunk=16, cache_dtype="int8")
    jr = _requests(JE, JS, cfg.vocab_size)
    js = je.serve(jr)
    te = TE.ServingEngine(tcfg, tp, paged=False, max_len=64, batch_slots=2,
                          chunk=16, cache_dtype="int8", device="cpu")
    tr = _requests(TE, TS, tcfg.vocab_size)
    ts = te.serve(tr)
    assert je._state.k.dtype == jnp.bfloat16
    assert isinstance(te._state, T.KVCache)
    assert te._state.k.dtype == te._state.v.dtype == torch.bfloat16
    assert [r.output for r in tr] == [r.output for r in jr]
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name


def test_serve_launcher_contiguous_kv_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen2.5-3b",
                                     "--smoke", "--device", "cpu",
                                     "--contiguous-kv", "--requests", "3",
                                     "--new-tokens", "3"])
    assert serve.main() == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=9" in out
    assert "contiguous KV: 20 rows x 4 slots" in out
    assert "kv_blocks_peak" not in out and "spec:" not in out
