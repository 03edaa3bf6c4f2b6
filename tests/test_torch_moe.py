"""The port's mixture-of-experts layer and MoE transformer against the JAX
reference (``repro/models/layers/moe.py``, the ``moe`` family of
``repro/models/transformer.py``) on the same numpy-seeded inputs and the
same weights (handed over through ``repro_torch.interop``).

* ``route``: the expert ids equal the reference's, prob and the aux loss
  within 1e-6.
* ``moe_einsum`` (the capacity dispatch) at fp32 and bf16, at the smoke
  configs' ``capacity_factor`` 4.0 (nothing drops) and at 1.0, 0.5 and a
  capacity of 1 (tokens drop); ``moe_dense`` against ``moe_einsum`` where
  nothing drops.  fp32: 1e-5 of the largest output (the same arithmetic,
  other summation orders).  bf16: 2^-6 of the largest -- both sides round
  each product and the SwiGLU to bf16, but XLA fuses ``silu(g) * u`` and
  rounds once where PyTorch rounds twice, and a one-ulp flip of h moves
  an output by up to an ulp of the largest.
* The plain version of K7's batched entry against an fp64 bmm.
* The whole model: ``forward`` (logits and aux loss), ``prefill_paged``
  with a padded chunk, ``verify_paged``, and the port's engine serving
  deepseek-moe-16b-smoke with the JAX engine's greedy tokens.
* The reference's semantics the port keeps: capacity is 1 per (row,
  expert) in a verify pass and depends on the padded chunk in prefill, so
  the reference's MoE speculative and chunked outputs are not those of
  plain decoding (ROADMAP Queue 3).

The prefill / decode comparisons of both MoE smoke configs at fp32 and
bf16 are ``test_torch_model.py::test_prefill_then_decode_matches_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import transformer as JT
from repro.models.layers import moe as JM
from repro.models.layers.module import init_table
from repro.models.registry import fns_for as jax_fns
from repro.serving import engine as JE
from repro.serving import sampler as JS
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.matmul.ref import matmul_batched_ref
from repro_torch.models import transformer as T
from repro_torch.models.layers import moe as TM
from repro_torch.models.registry import fns_for
from repro_torch.serving import engine as TE
from repro_torch.serving import sampler as TS

torch.set_num_threads(1)

MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
BF16_REL = 2.0 ** -6


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32))


def _rel(t, j):
    t, j = _f32(t), _f32(j)
    return float(np.abs(t - j).max() / np.abs(j).max())


def _layer(arch, compute_dtype="float32", **moe_kw):
    """The smoke config's MoE layer weights from the reference's init, both
    sides' configs, and x (2, 12, d_model) from numpy."""
    jcfg = JR.smoke(arch).replace(compute_dtype=compute_dtype)
    jm = dataclasses.replace(jcfg.moe, **moe_kw)
    tm = dataclasses.replace(TR.smoke(arch).moe, **moe_kw)
    jp = init_table(jax.random.PRNGKey(3), JM.moe_table(
        jcfg.d_model, jm.num_experts, jm.d_ff_expert), "float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(5).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    dt = jnp.dtype(compute_dtype)
    return jm, tm, jp, tp, jnp.asarray(x).astype(dt), tensor_from_numpy(
        np.asarray(jnp.asarray(x).astype(dt)))


@pytest.mark.parametrize("arch", MOE)
def test_route_matches_reference(arch):
    jm, tm, jp, tp, jx, tx = _layer(arch)
    jidx, jprob, jaux = JM.route(jm, jp, jx)
    dispatch.reset_counts()
    tidx, tprob, taux = TM.route(tm, tp, tx)
    assert dispatch.kernel_table()["matmul"].plain_calls == 1     # the router, on K7
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=0, atol=1e-6)
    assert tprob.dtype == torch.float32 and tidx.shape == jidx.shape
    assert abs(float(taux) - float(jaux)) <= 1e-6
    if tm.norm_topk_prob:
        np.testing.assert_allclose(tprob.sum(-1).numpy(), 1.0, rtol=1e-6)


# capacity_factor 4.0 (the smoke configs': nothing drops), then cases that drop
CAPACITY = [dict(), dict(capacity_factor=1.0), dict(capacity_factor=0.5),
            dict(capacity=1)]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CAPACITY, ids=["cf4", "cf1", "cf0.5", "capacity1"])
def test_moe_einsum_matches_reference(arch, compute_dtype, case):
    case = dict(case)
    capacity = case.pop("capacity", None)
    jm, tm, jp, tp, jx, tx = _layer(arch, compute_dtype, **case)
    jidx, jprob, _ = JM.route(jm, jp, jx)
    idx, prob = torch.from_numpy(np.array(jidx)).long(), torch.from_numpy(np.array(jprob))
    tp = {n: (w if n == "router" else w.to(tx.dtype)) for n, w in tp.items()}
    want = JM.moe_einsum(jm, jp, jx, jidx, jprob, capacity=capacity)
    dispatch.reset_counts()
    got = TM.moe_einsum(tm, tp, tx, idx, prob, capacity=capacity)
    assert dispatch.kernel_table()["matmul_batched"].plain_calls == 3
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    cap = capacity or TM.capacity_of(tm, tx.shape[1])
    _, keep = TM.dispatch_slots(tm, idx, cap)
    drops = int((~keep).sum())
    if case or capacity:
        assert drops > 0                       # the case exercises dropping
    else:
        assert drops == 0
    assert _rel(got, want) <= (1e-5 if compute_dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_dense_matches_einsum_where_nothing_drops(arch):
    jm, tm, jp, tp, jx, tx = _layer(arch)
    jidx, jprob, _ = JM.route(jm, jp, jx)
    idx, prob = torch.from_numpy(np.array(jidx)).long(), torch.from_numpy(np.array(jprob))
    dense = TM.moe_dense(tm, tp, tx, idx, prob)
    assert _rel(dense, TM.moe_einsum(tm, tp, tx, idx, prob)) <= 1e-6
    assert _rel(dense, JM.moe_dense(jm, jp, jx, jidx, jprob)) <= 1e-5


def test_dispatch_positions_follow_the_flattened_order():
    """A batch row's choices of one expert take positions in (s, k) order;
    within a token k runs in descending probability."""
    cfg = TR.smoke("deepseek-moe-16b").moe
    idx = torch.tensor([[[3, 1], [1, 3], [3, 0]]])            # (1, 3, 2)
    slot, keep = TM.dispatch_slots(cfg, idx, 2)
    pos = slot - idx * 2                                      # B = 1: slot = e C + pos
    assert pos.tolist() == [[[0, 0], [1, 1], [2, 0]]]
    assert keep.tolist() == [[[True, True], [True, True], [False, True]]]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-6), (torch.bfloat16, 2.0 ** -8)])
def test_batched_plain_version_matches_fp64(dtype, rtol):
    """Ragged E, M, N and K; each expert's product an fp32 sum rounded once."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 7, 333), generator=g).to(dtype)
    y = torch.randn((5, 333, 19), generator=g).to(dtype)
    got = matmul_batched_ref(x, y)
    want = torch.bmm(x.double(), y.double())
    assert got.dtype == dtype and got.shape == (5, 7, 19)
    err = (got.double() - want).abs()
    assert bool((err <= rtol * want.abs() + 1e-5 * want.abs().max()).all())


# -- the model ----------------------------------------------------------------

def _weights(arch, compute_dtype):
    jcfg = JR.smoke(arch).replace(compute_dtype=compute_dtype)
    tcfg = TR.smoke(arch).replace(compute_dtype=compute_dtype)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_aux_match_reference(arch):
    jcfg, tcfg, jp, tp = _weights(arch, "float32")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jaux = JT.forward(jcfg, jp, jnp.asarray(toks))
    tl, taux = T.forward(tcfg, tp, torch.from_numpy(toks))
    n_moe = tcfg.num_layers - tcfg.moe.first_k_dense
    assert float(taux) > 0 and abs(float(taux) - float(jaux)) <= 1e-6 * n_moe
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)


def test_param_layout_matches_reference_leaf_for_leaf():
    """deepseek's dense_blocks list and its (L - first_k) stack, leaf for
    leaf; ``init(cast_products=True)`` gives ``prepare_params``'s numbers
    and leaves the router in fp32."""
    jcfg, tcfg = JR.smoke("deepseek-moe-16b"), TR.smoke("deepseek-moe-16b")
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = T.init(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, tp))
    for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree_util.tree_leaves(tp)):
        assert tuple(t.shape) == j.shape, jax.tree_util.keystr(path)
    assert len(tp["dense_blocks"]) == 1
    assert tp["blocks"]["moe"]["w_gate"].shape[0] == tcfg.num_layers - 1
    cast = T.init(tcfg.replace(compute_dtype="bfloat16"), torch.Generator().manual_seed(0),
                  cast_products=True)
    want = T.prepare_params(tcfg.replace(compute_dtype="bfloat16"), tp)
    for a, b in zip(jax.tree_util.tree_leaves(cast), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert cast["blocks"]["moe"]["router"].dtype == torch.float32
    assert cast["blocks"]["moe"]["w_down"].dtype == torch.bfloat16
    assert cast["dense_blocks"][0]["mlp"]["w_up"].dtype == torch.bfloat16


BS, MB = 8, 6


def _pools(cfg, mod, n_blocks, batch, rng):
    shape = (cfg.num_layers, n_blocks, BS, cfg.num_kv_heads, cfg.resolved_head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    zeros = np.zeros((batch, MB), np.int32), np.zeros((batch,), np.int32)
    if mod is JT:
        return JT.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                               block_tables=jnp.asarray(zeros[0]),
                               length=jnp.asarray(zeros[1]))
    return T.PagedKVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                          block_tables=torch.from_numpy(zeros[0]),
                          length=torch.from_numpy(zeros[1]))


@pytest.mark.parametrize("arch", MOE)
def test_prefill_paged_matches_reference(arch):
    """One 13-token chunk padded to 16 rows, seeded past 8 rows: the
    padding rows route and count toward the capacity, as the reference's."""
    jcfg, tcfg, jp, tp = _weights(arch, "float32")
    rng = np.random.default_rng(9)
    jc, tc = (_pools(jcfg, mod, 6, 1, np.random.default_rng(4)) for mod in (JT, T))
    toks = np.pad(rng.integers(0, jcfg.vocab_size, 13), (0, 3)).astype(np.int32)[None]
    args = dict(write_ids=np.array([2, 3], np.int32), table=np.array([[1, 2, 3, 0, 0, 0]],
                                                                     np.int32),
                q_start=np.array([8], np.int32), kv_len=np.array([21], np.int32))
    jl, jc = JT.prefill_paged(jcfg, jp, jnp.asarray(toks), jc, jnp.asarray(args["write_ids"]),
                              jnp.asarray(args["table"]), q_start=jnp.asarray(args["q_start"]),
                              kv_len=jnp.asarray(args["kv_len"]), last_idx=12)
    dispatch.reset_counts()
    tl, tc = fns_for(tcfg).prefill_paged(
        tcfg, T.prepare_params(tcfg, tp), torch.from_numpy(toks), tc,
        torch.from_numpy(args["write_ids"]), torch.from_numpy(args["table"]),
        q_start=torch.from_numpy(args["q_start"]), kv_len=torch.from_numpy(args["kv_len"]),
        last_idx=12)
    table = dispatch.kernel_table()
    n_moe = tcfg.num_layers - tcfg.moe.first_k_dense
    assert table["matmul_batched"].plain_calls == 3 * n_moe
    assert table["paged_prefill_attention"].plain_calls == tcfg.num_layers
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(_f32(getattr(tc, name))[:, 1:],
                                   _f32(getattr(jc, name))[:, 1:], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_verify_paged_matches_reference(arch):
    """Three live slots of 4 candidate rows at mid-block q_starts and a
    padding slot on an all-trash table; each batch row routes in its own
    capacity group."""
    jcfg, tcfg, jp, tp = _weights(arch, "float32")
    rng = np.random.default_rng(7)
    tables = np.zeros((4, MB), np.int32)
    tables[:3] = (1 + rng.permutation(3 * MB)).reshape(3, MB)
    q_start = np.array([9, 27, 3, 0], np.int32)
    kv_len = q_start + 4
    toks = rng.integers(0, jcfg.vocab_size, (4, 4)).astype(np.int32)
    jc, tc = (_pools(jcfg, mod, 1 + 3 * MB, 4, np.random.default_rng(4)) for mod in (JT, T))
    jl, _ = JT.verify_paged(jcfg, jp, jnp.asarray(toks), jc, jnp.asarray(tables),
                            q_start=jnp.asarray(q_start), kv_len=jnp.asarray(kv_len))
    tl, _ = T.verify_paged(tcfg, T.prepare_params(tcfg, tp), torch.from_numpy(toks), tc,
                           torch.from_numpy(tables), q_start=torch.from_numpy(q_start),
                           kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(_f32(tl[:3]), _f32(jl[:3]), rtol=1e-4, atol=1e-4)


def test_engine_serves_deepseek_smoke_with_the_jax_engines_tokens():
    """Chunked prefill with shared prefixes, then batched decode, at fp32:
    greedy tokens and counters equal the JAX engine's."""
    jcfg, tcfg, jp, tp = _weights("deepseek-moe-16b", "float32")

    def reqs(mod, sampler):
        rng = np.random.default_rng(11)
        prefix = rng.integers(0, jcfg.vocab_size, 16).astype(np.int32)
        out = []
        for i, n in enumerate((5, 21, 3, 12)):
            tail = rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
            prompt = np.concatenate([prefix, tail]) if i % 2 == 0 else tail
            out.append(mod.Request(i, prompt, max_new_tokens=4 + i, sampler=sampler.greedy()))
        return out

    kw = dict(max_len=64, batch_slots=3, prefill_chunk=16, block_size=8,
              cache_dtype="float32")
    jreqs, treqs = reqs(JE, JS), reqs(TE, TS)
    js = JE.ServingEngine(jcfg, jp, paged=True, **kw).serve(jreqs)
    dispatch.reset_counts()
    teng = TE.ServingEngine(tcfg, tp, device="cpu", **kw)
    ts = teng.serve(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.state is TE.RequestState.DONE for r in treqs)
    for name in ("prefill_tokens_total", "prefill_tokens_computed", "prefix_shared_blocks",
                 "decode_steps", "kv_blocks_peak"):
        assert getattr(ts, name) == getattr(js, name), name
    table = dispatch.kernel_table()
    calls = ts.decode_steps + table["paged_prefill_attention"].plain_calls // tcfg.num_layers
    assert table["matmul_batched"].plain_calls == 3 * (tcfg.num_layers - 1) * calls
    assert all(k.launches == 0 for k in table.values())


# -- the reference's semantics, kept (ROADMAP Queue 3) ------------------------

def test_capacity_makes_verify_and_chunked_prefill_differ_from_plain_decoding():
    """deepseek-moe-16b-smoke at capacity_factor 1.0, where its verify pass
    over 4 candidates has the full config's capacity of 1 per (row,
    expert) (top-2 of 8 here, top-6 of 64 there): a row's repeated expert
    drops, so the pass does not give the logits of decoding the candidates
    one at a time; and a prompt's last logits depend on how far its chunk
    is padded (the padding rows route and count toward S).  The port agrees
    with the reference on each, so both differ from plain decoding."""
    arch = "deepseek-moe-16b"
    jcfg, tcfg, jp, tp = _weights(arch, "float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=1.0))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=1.0))
    tp = T.prepare_params(tcfg, tp)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab_size, 13).astype(np.int32)
    table = np.array([[1, 2, 3, 4, 0, 0]], np.int32)

    def prefill(mod, cfg, params, pad, tensor):
        cache = _pools(cfg, mod, 6, 1, np.random.default_rng(4))
        toks = np.pad(prompt, (0, pad - 13))[None].astype(np.int32)
        ids = np.array([1, 2, 3, 4][:pad // BS], np.int32)
        lg, cache = mod.prefill_paged(cfg, params, tensor(toks), cache, tensor(ids),
                                      tensor(table), q_start=tensor(np.array([0], np.int32)),
                                      kv_len=tensor(np.array([13], np.int32)), last_idx=12)
        return _f32(lg), cache

    j16, _ = prefill(JT, jcfg, jp, 16, jnp.asarray)
    j32, _ = prefill(JT, jcfg, jp, 32, jnp.asarray)
    t16, tc = prefill(T, tcfg, tp, 16, torch.from_numpy)
    t32, _ = prefill(T, tcfg, tp, 32, torch.from_numpy)
    np.testing.assert_allclose(t16, j16, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t32, j32, rtol=1e-4, atol=1e-4)
    assert np.abs(j16 - j32).max() > 1e-3          # the padding changed the capacity

    # verify 4 candidates after the prompt vs decoding them one by one
    cand = rng.integers(0, jcfg.vocab_size, (1, 4)).astype(np.int32)
    q0 = np.array([13], np.int32)
    tl, _ = T.verify_paged(tcfg, tp, torch.from_numpy(cand), tc, torch.from_numpy(table),
                           q_start=torch.from_numpy(q0), kv_len=torch.from_numpy(q0 + 4))
    _, jc = prefill(JT, jcfg, jp, 16, jnp.asarray)
    jl, _ = JT.verify_paged(jcfg, jp, jnp.asarray(cand), jc, jnp.asarray(table),
                            q_start=jnp.asarray(q0), kv_len=jnp.asarray(q0 + 4))
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    _, jc = prefill(JT, jcfg, jp, 16, jnp.asarray)
    jc = jc._replace(block_tables=jnp.asarray(table), length=jnp.asarray(q0))
    steps = []
    for j in range(4):
        lg, jc = JT.decode_step(jcfg, jp, jnp.asarray(cand[:, j:j + 1]), jc)
        steps.append(_f32(lg)[0])
    assert TM.capacity_of(tcfg.moe, 4) == 1       # a row's repeated expert drops
    assert np.abs(np.stack(steps) - _f32(jl)[0]).max() > 1e-3
