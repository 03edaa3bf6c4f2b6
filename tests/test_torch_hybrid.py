"""The port's zamba2 hybrid against the JAX package on the same weights
(handed over through ``repro_torch.interop``) and the same tokens, at
``zamba2-1.2b-smoke`` (5 layers: 2 segments of 2 Mamba layers, a 1-layer
tail) on the CPU, where every kernel wrapper runs its plain version.

* Parameters: names and shapes leaf for leaf with ``hybrid.lm_table``,
  the ``(n_seg, e, ...)`` stacking and the separate ``tail_blocks``.
* ``prefill`` then ``decode_step``: logits within 1e-5 of the largest
  logit at fp32 (2^-10 when the KV cache is bf16), and every leaf of the
  decode state.
* The contiguous decode attention (``_write_row`` and the single-device
  ``seq_sharded_decode_attention``) with lengths past the cache.
* Serving: the port's contiguous ``ServingEngine(device="cpu")`` gives the
  JAX engine's greedy tokens and deterministic counters, at fp32.
* The kernel wrappers' counts on that path: K5 once per Mamba layer and
  prompt, K4 once per shared-block application and prompt, K3 once per
  application and decode step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.distributed.collectives import \
    seq_sharded_decode_attention as jax_seq_decode
from repro.models import hybrid as JH
from repro.models.registry import fns_for as jax_fns
from repro.serving import engine as JE
from repro.serving import sampler as JS
from repro_torch.configs import registry as TR
from repro_torch.distributed import collectives as TC
from repro_torch.distributed.sharding import use_rules
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import hybrid as TH
from repro_torch.models.registry import fns_for
from repro_torch.serving import engine as TE
from repro_torch.serving import sampler as TS

torch.set_num_threads(1)

RTOL = 1e-5


def _rel(t, j):
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


@pytest.fixture(scope="module")
def weights():
    cfg = JR.smoke("zamba2-1.2b").replace(compute_dtype="float32")
    tcfg = TR.smoke("zamba2-1.2b").replace(compute_dtype="float32")
    jp = jax_fns(cfg).init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jp, tcfg, tp


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tuple(tree.shape)


def test_params_match_the_reference_leaf_for_leaf(weights):
    cfg, jp, tcfg, _ = weights
    tp = fns_for(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    assert dict(_leaves(tp)) == dict(_leaves(jp))
    n_seg, e, tail = TH._segments(tcfg)
    assert (n_seg, e, tail) == JH._segments(cfg) == (2, 2, 1)
    assert tp["seg_blocks"]["mamba"]["in_proj"].shape[:2] == (n_seg, e)
    assert tp["tail_blocks"]["mamba"]["in_proj"].shape[0] == tail
    no_tail = tcfg.replace(num_layers=4)
    assert "tail_blocks" not in TH.lm_table(no_tail)


def test_prepare_params_casts_product_weights_only(weights):
    _, _, tcfg, tp = weights
    bf = TH.prepare_params(tcfg.replace(compute_dtype="bfloat16"), tp, "cpu")
    seg = bf["seg_blocks"]
    for leaf in (seg["mamba"]["in_proj"], seg["mamba"]["out_proj"],
                 seg["mamba"]["conv_w"], seg["mamba"]["conv_b"],
                 bf["shared"]["in_proj"], bf["shared"]["attn"]["wq"],
                 bf["shared"]["mlp"]["w_down"]):
        assert leaf.dtype == torch.bfloat16
    for leaf in (seg["mamba"]["a_log"], seg["mamba"]["d_skip"],
                 seg["mamba"]["dt_bias"], seg["mamba"]["norm"],
                 seg["norm"]["scale"], bf["embed"]["tok"],
                 bf["embed"]["lm_head"], bf["ln_f"]["scale"]):
        assert leaf.dtype == torch.float32


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(weights, cache_dtype):
    cfg, jp, tcfg, tp = weights
    tp = TH.prepare_params(tcfg, tp, "cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 45)).astype(np.int32)
    jl, js = JH.prefill(cfg, jp, jnp.asarray(toks), max_len=60,
                        cache_dtype=cache_dtype)
    tl, ts = TH.prefill(tcfg, tp, torch.from_numpy(toks), max_len=60,
                        cache_dtype=cache_dtype)
    assert _rel(tl, jl) <= RTOL
    # decode attention over a bf16 cache rounds p and each PV partial to
    # bf16 in both packages; a rounding that falls the other way moves an
    # attention output by up to 2^-8 of it (measured: 1.4e-5 of the largest
    # logit), so the bf16-cache logits and the state after them are held
    # to 2^-10
    limit = RTOL if cache_dtype == "float32" else 2 ** -10
    for step in range(3):
        tok = np.random.default_rng(step).integers(
            0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, js = JH.decode_step(cfg, jp, jnp.asarray(tok), js)
        tl, ts = TH.decode_step(tcfg, tp, torch.from_numpy(tok), ts)
        assert _rel(tl, jl) <= limit, step
    for name in js._fields:
        j, t = getattr(js, name), getattr(ts, name)
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype)[6:] == str(j.dtype), name
        if name == "length":
            assert t.tolist() == np.asarray(j).tolist() == [48, 48]
        elif j.size:
            # a bf16 leaf rounds where JAX's does: one bf16 step apart; the
            # fp32 leaves carry the logits' limit
            assert _rel(t, j) <= (2 ** -7 if t.dtype == torch.bfloat16
                                  else limit), name


def test_decode_state_and_idle_slots_match_reference(weights):
    cfg, _, tcfg, _ = weights
    js = jax_fns(cfg).init_decode_state(cfg, 3, 20)
    ts = fns_for(tcfg).init_decode_state(tcfg, 3, 20, device="cpu")
    for name in js._fields:
        assert tuple(getattr(ts, name).shape) == getattr(js, name).shape
    assert ts.length.tolist() == [19, 19, 19]         # idle: max_len - 1
    assert ts.kv_k.dtype == torch.bfloat16 and ts.ssm_seg.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_decode_attention_matches_reference(dtype):
    """New row written at ``lengths`` (not at all past S), attention over
    ``lengths + 1`` rows; the caches come back updated in place."""
    rng = np.random.default_rng(1)
    B, S, H, K, D = 4, 24, 4, 2, 16
    lengths = np.array([0, 9, 23, 30], np.int32)     # 23: last row; 30: past S
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, 1, H, D), (B, S, K, D), (B, S, K, D), (B, 1, K, D), (B, 1, K, D))]
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    t = [tensor_from_numpy(np.asarray(a)) for a in j]
    j_out, jk, jv = jax_seq_decode(*j, jnp.asarray(lengths), chunk=8)
    t_out, tk, tv = TC.seq_sharded_decode_attention(
        *t, torch.from_numpy(lengths), chunk=8)
    assert tk is t[1] and tv is t[2]                 # in place
    assert np.array_equal(tk.float().numpy(), np.asarray(jk.astype(jnp.float32)))
    assert np.array_equal(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)))
    np.testing.assert_allclose(
        t_out.float().numpy(), np.asarray(j_out.astype(jnp.float32)),
        atol=1e-5 if dtype == "float32" else 2e-2, rtol=0)


def test_contiguous_decode_attention_refuses_what_is_not_ported():
    q = torch.zeros((1, 1, 2, 16))
    c = torch.zeros((1, 8, 2, 16))
    n = torch.zeros((1, 1, 2, 16))
    lens = torch.zeros((1,), dtype=torch.int32)
    # a mesh without sharding rules (the mesh branch itself is ported:
    # test_torch_collectives_mesh.py)
    with pytest.raises(ValueError, match="mesh"):
        with use_rules(None, object()):
            TC.seq_sharded_decode_attention(q, c, c, n, n, lens)
    # the int8 branch is ported (test_torch_contiguous.py); an int8 cache
    # without its scales is refused
    with pytest.raises(ValueError, match="int8 pool needs"):
        TC.seq_sharded_decode_attention(q, c.to(torch.int8), c.to(torch.int8),
                                        n, n, lens)
    with pytest.raises(NotImplementedError, match="softcap"):
        TC.seq_sharded_decode_attention(q, c, c, n, n, lens, softcap=30.0)


BATCH_AXIS = {"conv_seg": 2, "ssm_seg": 2, "conv_tail": 1, "ssm_tail": 1,
              "kv_k": 1, "kv_v": 1, "length": 0}


def test_merge_slot_matches_reference(weights):
    cfg, _, tcfg, _ = weights
    js = jax_fns(cfg).init_decode_state(cfg, 3, 10)
    ts = fns_for(tcfg).init_decode_state(tcfg, 3, 10, device="cpu")
    rng = np.random.default_rng(2)
    one = []
    for name in js._fields:                 # batch axis of each leaf: 1 slot
        shape = list(getattr(js, name).shape)
        shape[BATCH_AXIS[name]] = 1
        one.append(np.array([7], np.int32) if name == "length"
                   else rng.standard_normal(shape).astype(np.float32))
    jm = JE._merge_slot(js, type(js)(*map(jnp.asarray, one)), jnp.int32(1))
    tm = TE._merge_slot(ts, type(ts)(*map(torch.from_numpy, one)), 1)
    assert tm is ts
    for name in js._fields:
        assert _rel(getattr(tm, name), getattr(jm, name)) == 0.0, name


def _requests(mod, sampler, vocab):
    rng = np.random.default_rng(5)
    return [mod.Request(i, rng.integers(0, vocab, n).astype(np.int32),
                        max_new_tokens=3 + i, sampler=sampler.greedy())
            for i, n in enumerate((7, 33, 20, 41, 12))]


COUNTERS = ("prefill_tokens_total", "prefill_tokens_computed", "prefills",
            "decode_steps", "prefill_compiles", "tokens", "kv_blocks_peak")


@pytest.mark.parametrize("slots", [1, 2])
def test_contiguous_engine_matches_jax_engine(weights, slots):
    cfg, jp, tcfg, tp = weights
    je = JE.ServingEngine(cfg, jp, max_len=64, batch_slots=slots, chunk=16)
    jr = _requests(JE, JS, cfg.vocab_size)
    js = je.serve(jr)
    dispatch.reset_counts()
    te = TE.ServingEngine(tcfg, tp, max_len=64, batch_slots=slots, chunk=16,
                          device="cpu")
    tr = _requests(TE, TS, tcfg.vocab_size)
    ts = te.serve(tr)
    assert not je.paged and not te.paged and te.pool is None
    assert [r.output for r in tr] == [r.output for r in jr]
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    table = dispatch.kernel_table()
    n_seg, _, _ = TH._segments(tcfg)
    assert table["ssm_scan"].plain_calls == tcfg.num_layers * ts.prefills
    assert table["flash_attention"].plain_calls == n_seg * ts.prefills
    assert table["decode_attention"].plain_calls == n_seg * ts.decode_steps
    assert all(k.launches == 0 for k in table.values())
    assert table["paged_decode_attention"].plain_calls == 0


def test_contiguous_engine_int8_builds_bf16_caches_as_the_reference(weights):
    """``cache_dtype="int8"`` on the contiguous path: the reference's
    engine builds bf16 caches whatever ``cache_dtype`` says, and so does the
    port (it never reaches the int8 refusal of the contiguous decode
    attention); greedy tokens and counters equal the JAX engine's."""
    cfg, jp, tcfg, tp = weights
    je = JE.ServingEngine(cfg, jp, max_len=64, batch_slots=2, chunk=16,
                          cache_dtype="int8")
    jr = _requests(JE, JS, cfg.vocab_size)
    js = je.serve(jr)
    te = TE.ServingEngine(tcfg, tp, max_len=64, batch_slots=2, chunk=16,
                          cache_dtype="int8", device="cpu")
    tr = _requests(TE, TS, tcfg.vocab_size)
    ts = te.serve(tr)
    assert not te.paged
    assert je._state.kv_k.dtype == jnp.bfloat16
    assert te._state.kv_k.dtype == te._state.kv_v.dtype == torch.bfloat16
    assert [r.output for r in tr] == [r.output for r in jr]
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name


def test_engine_refuses_what_the_contiguous_path_does_not_carry(weights):
    _, _, tcfg, tp = weights
    with pytest.raises(ValueError, match="paged-KV"):
        TE.ServingEngine(tcfg, tp, paged=True, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk needs the paged"):
        TE.ServingEngine(tcfg, tp, prefill_chunk=16, device="cpu")
    eng = TE.ServingEngine(tcfg, tp, max_len=16, device="cpu")
    too_long = TE.Request(0, np.zeros(14, np.int32), max_new_tokens=4,
                          sampler=TS.greedy())
    with pytest.raises(TE.CapacityError, match="max_len=16"):
        eng.serve([too_long])


def test_serve_launcher_runs_zamba2_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "zamba2-1.2b",
                                     "--smoke", "--device", "cpu",
                                     "--requests", "3", "--new-tokens", "3"])
    assert serve.main() == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=9" in out
    assert "contiguous KV: 20 rows x 4 slots" in out
    assert "tokens/s/W: not measured (CPU run)" in out
