"""The port's xLSTM (the ssm family) against the JAX package on the same
weights (handed over through ``repro_torch.interop``) and the same inputs,
at ``xlstm-125m-smoke`` (4 blocks: mLSTM, sLSTM, mLSTM, mLSTM; d_model 64,
4 heads, the mLSTM scan at N = 32, P = 33) on the CPU, where every kernel
wrapper runs its plain version.

* Parameters: names and shapes leaf for leaf with ``recurrent.lm_table``
  (a list of per-block tables), the forget-gate bias's linspace [3, 6].
* ``mlstm_forward`` / ``mlstm_step`` and ``slstm_forward`` / ``slstm_step``
  at fp32, S = 45 (one chunk) and S = 200 (two chunks of 128, the second
  ragged): outputs and states within 1e-5 of the largest |ref| (the same
  fp32 arithmetic; only the order of sums differs).
* ``prefill`` then ``decode_step`` on the whole model: logits within 1e-5
  of the largest logit at fp32 compute (the hybrid tests' limit) and 5e-2
  at bf16 compute (the dense tests' bf16-compute limit,
  tests/test_torch_model.py: XLA and PyTorch round their elementwise ops
  at other points, and a one-ulp flip of a bf16 hidden state moves the
  logits by about that much; measured 9e-3 here).
* ``_merge_slot`` on the nested decode state, against the reference's.
* Serving: the port's contiguous ``ServingEngine(device="cpu")`` gives the
  JAX engine's greedy tokens and counters at fp32, at 1 and 2 slots, with
  K5 once per mLSTM block and prompt and K7 on every weight product.
* The launcher on the CPU, and its refusal without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import recurrent as JRC
from repro.models.layers import xlstm as JX
from repro.models.registry import fns_for as jax_fns
from repro.serving import engine as JE
from repro.serving import sampler as JS
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import recurrent as TRC
from repro_torch.models.layers import xlstm as TX
from repro_torch.models.registry import fns_for
from repro_torch.serving import engine as TE
from repro_torch.serving import sampler as TS

torch.set_num_threads(1)

RTOL = 1e-5
BF16_RTOL = 5e-2


def _rel(t, j):
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    cfg = JR.smoke("xlstm-125m").replace(compute_dtype="float32")
    tcfg = TR.smoke("xlstm-125m").replace(compute_dtype="float32")
    jp = jax_fns(cfg).init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(_to_numpy(jp))
    return cfg, jp, tcfg, tp


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tuple(tree.shape)


def test_params_match_the_reference_leaf_for_leaf(weights):
    cfg, jp, tcfg, _ = weights
    tp = fns_for(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    assert dict(_leaves(tp)) == dict(_leaves(jp))
    kinds = ["r" in b["core"] for b in tp["blocks"]]
    assert kinds == [False, True, False, False]       # block 1: the sLSTM
    b_f = tp["blocks"][0]["core"]["b_f"]
    assert torch.equal(b_f, torch.linspace(3.0, 6.0, tcfg.num_heads))
    np.testing.assert_allclose(b_f.numpy(), np.asarray(jp["blocks"][0]["core"]["b_f"]),
                               rtol=1e-7)
    full = TR.config("xlstm-125m")
    table = TRC.lm_table(full)
    assert sum("r" in b["core"] for b in table["blocks"]) == 3   # 9 mLSTM, 3 sLSTM
    assert table["blocks"][0]["core"]["wq"].shape == (1536, 4, 384)


def test_prepare_params_moves_and_casts_nothing(weights):
    _, _, tcfg, tp = weights
    bf = TRC.prepare_params(tcfg.replace(compute_dtype="bfloat16"), tp, "cpu")
    assert dict(_leaves(bf)) == dict(_leaves(tp))
    assert all(t.dtype == torch.float32 for t in
               (bf["blocks"][0]["core"]["wq"], bf["blocks"][1]["core"]["r"],
                bf["embed"]["tok"]))


def _block(weights, i):
    cfg, jp, tcfg, tp = weights
    return cfg, jp["blocks"][i]["core"], tcfg, tp["blocks"][i]["core"]


@pytest.mark.parametrize("S", [45, 200])
def test_mlstm_forward_and_steps_match_reference(weights, S):
    """Prefill S tokens (state out), a second prefill carrying the state
    in, then three decode steps."""
    cfg, jp, tcfg, tp = _block(weights, 0)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jo, jst = JX.mlstm_forward(cfg, jp, jnp.asarray(x), return_state=True)
    to, tst = TX.mlstm_forward(tcfg, tp, torch.from_numpy(x), return_state=True)
    assert _rel(to, jo) <= RTOL
    assert _rel(tst.mem, jst.mem) <= RTOL and _rel(tst.conv, jst.conv) <= RTOL
    assert tst.mem.shape == (2, 4, 32, 33)
    jo2, jst = JX.mlstm_forward(cfg, jp, jnp.asarray(x[:, :9]), jst,
                                return_state=True)
    to2, tst = TX.mlstm_forward(tcfg, tp, torch.from_numpy(x[:, :9]), tst,
                                return_state=True)
    assert _rel(to2, jo2) <= RTOL and _rel(tst.mem, jst.mem) <= RTOL
    for step in range(3):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = JX.mlstm_step(cfg, jp, jnp.asarray(xs), jst)
        ty, tst = TX.mlstm_step(tcfg, tp, torch.from_numpy(xs), tst)
        assert _rel(ty, jy) <= RTOL, step
        assert _rel(tst.mem, jst.mem) <= RTOL and _rel(tst.conv, jst.conv) <= RTOL


@pytest.mark.parametrize("S", [45, 200])
def test_slstm_forward_and_steps_match_reference(weights, S):
    cfg, jp, tcfg, tp = _block(weights, 1)
    rng = np.random.default_rng(S + 1)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jo, jst = JX.slstm_forward(cfg, jp, jnp.asarray(x), return_state=True)
    to, tst = TX.slstm_forward(tcfg, tp, torch.from_numpy(x), return_state=True)
    assert _rel(to, jo) <= RTOL
    for name in jst._fields:
        assert _rel(getattr(tst, name), getattr(jst, name)) <= RTOL, name
    for step in range(3):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = JX.slstm_step(cfg, jp, jnp.asarray(xs), jst)
        ty, tst = TX.slstm_step(tcfg, tp, torch.from_numpy(xs), tst)
        assert _rel(ty, jy) <= RTOL, step
        for name in jst._fields:
            assert _rel(getattr(tst, name), getattr(jst, name)) <= RTOL, name


def test_recurrent_weight_is_the_per_head_product():
    """The block-diagonal weight gives the reference's head-block product."""
    rng = np.random.default_rng(3)
    r = rng.standard_normal((4, 8, 4, 8)).astype(np.float32)
    h = rng.standard_normal((3, 32)).astype(np.float32)
    ref = np.einsum("bhk,hkgj->bghj", h.reshape(3, 4, 8), r).reshape(3, 4, 32)
    out = (torch.from_numpy(h) @ TX.recurrent_weight(torch.from_numpy(r)))
    np.testing.assert_allclose(out.reshape(3, 4, 32).numpy(), ref, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(weights, compute):
    cfg, jp, tcfg, tp = weights
    cfg, tcfg = (c.replace(compute_dtype=compute) for c in (cfg, tcfg))
    limit = RTOL if compute == "float32" else BF16_RTOL
    tp = TRC.prepare_params(tcfg, tp, "cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 150)).astype(np.int32)
    jl, js = JRC.prefill(cfg, jp, jnp.asarray(toks))
    tl, ts = TRC.prefill(tcfg, tp, torch.from_numpy(toks))
    assert _rel(tl, jl) <= limit
    for step in range(3):
        tok = np.random.default_rng(step).integers(
            0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, js = JRC.decode_step(cfg, jp, jnp.asarray(tok), js)
        tl, ts = TRC.decode_step(tcfg, tp, torch.from_numpy(tok), ts)
        assert _rel(tl, jl) <= limit, step
    assert ts["length"].tolist() == np.asarray(js["length"]).tolist() == [153, 153]
    for i, (j, t) in enumerate(zip(js["states"], ts["states"])):
        assert type(t).__name__ == type(j).__name__
        for name in j._fields:
            jl_, tl_ = getattr(j, name), getattr(t, name)
            assert tuple(tl_.shape) == jl_.shape, (i, name)
            assert str(tl_.dtype)[6:] == str(jl_.dtype), (i, name)
            if compute == "float32":
                assert _rel(tl_, jl_) <= limit, (i, name)


def test_forward_matches_reference(weights):
    cfg, jp, tcfg, tp = weights
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 30)).astype(np.int32)
    jl, _ = jax_fns(cfg).forward(cfg, jp, {"tokens": jnp.asarray(toks)})
    tl, aux = fns_for(tcfg).forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 30, cfg.vocab_size) and float(aux) == 0.0
    assert _rel(tl, jl) <= RTOL


def test_decode_state_and_idle_slots_match_reference(weights):
    cfg, _, tcfg, _ = weights
    js = jax_fns(cfg).init_decode_state(cfg, 3, 20)
    ts = fns_for(tcfg).init_decode_state(tcfg, 3, 20, device="cpu")
    assert ts["length"].tolist() == [19, 19, 19]      # idle: max_len - 1
    for j, t in zip(js["states"], ts["states"]):
        for name in j._fields:
            assert tuple(getattr(t, name).shape) == getattr(j, name).shape
            assert str(getattr(t, name).dtype)[6:] == str(getattr(j, name).dtype)
            assert _rel(getattr(t, name), getattr(j, name)) == 0.0
    sl = ts["states"][1]
    assert len({sl.h.data_ptr(), sl.c.data_ptr(), sl.n.data_ptr()}) == 3


def test_merge_slot_walks_the_nested_state(weights):
    """The recurrent state -- a dict of a list of NamedTuples and the
    lengths -- merged in place, leaf for leaf as the reference's
    ``tree_map`` merges it, each leaf cast to the batched leaf's type."""
    cfg, _, tcfg, _ = weights
    js = jax_fns(cfg).init_decode_state(cfg, 3, 10)
    ts = fns_for(tcfg).init_decode_state(tcfg, 3, 10, device="cpu")
    rng = np.random.default_rng(2)

    def one(leaf):
        return rng.standard_normal((1, *leaf.shape[1:])).astype(np.float32)
    small = jax.tree_util.tree_map(one, _to_numpy(js["states"]))
    # the prefill's conv history is in the compute type (bf16 here), the
    # batched one fp32: the merge casts it up
    jsmall = [type(s)(*(jnp.asarray(a, jnp.bfloat16) if n == "conv"
                        else jnp.asarray(a) for n, a in zip(s._fields, s)))
              for s in small]
    tsmall = [type(s)(*(torch.from_numpy(a).bfloat16() if n == "conv"
                        else torch.from_numpy(a) for n, a in zip(s._fields, s)))
              for s in small]
    jm = JE._merge_slot(js, {"states": jsmall, "length": jnp.array([7], jnp.int32)},
                        jnp.int32(1))
    before = [t.data_ptr() for s in ts["states"] for t in s]
    tm = TE._merge_slot(ts, {"states": tsmall,
                             "length": torch.tensor([7], dtype=torch.int32)}, 1)
    assert tm is ts
    assert [t.data_ptr() for s in tm["states"] for t in s] == before
    assert tm["length"].tolist() == np.asarray(jm["length"]).tolist() == [9, 7, 9]
    for j, t in zip(jm["states"], tm["states"]):
        for name in j._fields:
            assert getattr(t, name).dtype == torch.float32
            assert _rel(getattr(t, name), getattr(j, name)) == 0.0, name


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
    assert table["ssm_scan"].plain_calls == 3 * ts.prefills    # 3 mLSTM blocks
    # K7: 7 products an mLSTM block, 4 + (one a token) an sLSTM block, the
    # head; a decode step is one token
    per_prefill = 3 * 7 + 4 + 1
    assert table["matmul"].plain_calls == (
        per_prefill * (ts.prefills + ts.decode_steps)
        + ts.prefill_tokens_total + ts.decode_steps)
    assert all(k.launches == 0 for k in table.values())


def test_serve_launcher_runs_xlstm_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "xlstm-125m",
                                     "--smoke", "--device", "cpu",
                                     "--requests", "3", "--new-tokens", "3"])
    assert serve.main() == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=9" in out
    assert "contiguous KV: 20 rows x 4 slots" in out
    assert "tokens/s/W: not measured (CPU run)" in out


def test_serve_launcher_refuses_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a machine without a card")
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "xlstm-125m", "--smoke"])
    with pytest.raises(SystemExit):
        serve.main()
    with pytest.raises(RuntimeError, match="CUDA device"):
        TE.ServingEngine(TR.smoke("xlstm-125m"), {}, max_len=8)
