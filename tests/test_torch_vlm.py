"""The port's vlm family (qwen2-vl: the transformer under M-RoPE) against
the JAX package on the same weights (handed over through
``repro_torch.interop``) and the same tokens, at ``qwen2-vl-72b-smoke`` on
the CPU, where every kernel wrapper runs its plain version.

* ``apply_m_rope`` against the reference's, with three equal position
  streams (text) and three different ones.
* ``prefill`` (with the default positions and with streams 1 and 2 apart
  from stream 0), ``prefill_paged`` then ``decode_step`` on a paged pool,
  and ``verify_paged``: logits and caches.  fp32 compute at rtol 1e-4 /
  atol 1e-4; bf16 compute within 5e-2 of the largest magnitude (one bf16
  ulp of a hidden state moves the logits by about that much, as
  ``tests/test_torch_model.py`` states for the dense family).
* The paged and the contiguous engine's greedy tokens and counters
  against the JAX engine's, at fp32.
* A caller's positions whose stream 0 is not each row's index raise: K4
  and K2 mask by row, where the reference masks by stream 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import transformer as JT
from repro.models.layers import rope as JROPE
from repro.models.registry import fns_for as jax_fns
from repro.serving import engine as JE
from repro.serving import sampler as JS
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.models.layers import rope as TROPE
from repro_torch.models.registry import TRANSFORMER_FNS, fns_for
from repro_torch.serving import engine as TE
from repro_torch.serving import sampler as TS

torch.set_num_threads(1)

ARCH = "qwen2-vl-72b"
BS, MB = 8, 6


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32))


def _close(t, j, compute_dtype):
    t, j = _f32(t), _f32(j)
    if compute_dtype == "float32":
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(t - j).max() <= 5e-2 * np.abs(j).max()


def _weights(compute_dtype):
    jcfg = JR.smoke(ARCH).replace(compute_dtype=compute_dtype)
    tcfg = TR.smoke(ARCH).replace(compute_dtype=compute_dtype)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _streams(B, S, kind, seed=0):
    """(3, B, S) int32 positions: stream 0 each row's index; streams 1 and
    2 equal to it ("equal", text) or drawn apart ("different")."""
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    if kind == "different":
        rng = np.random.default_rng(seed)
        pos[1:] = rng.integers(0, 4 * S, (2, B, S))
    return pos


def test_registry_serves_the_vlm_family_on_the_transformer():
    assert fns_for(TR.smoke(ARCH)) is TRANSFORMER_FNS
    assert TR.smoke(ARCH).m_rope


def test_m_rope_streams_follow_the_sections():
    np.testing.assert_array_equal(TROPE.m_rope_streams((2, 3, 1)),
                                  [0, 0, 1, 1, 1, 2])
    with pytest.raises(ValueError, match="sections"):
        TROPE.apply_m_rope(torch.zeros((1, 2, 1, 8)), torch.zeros((3, 1, 2)),
                           1e4, (1, 1, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["equal", "different"])
def test_apply_m_rope_matches_reference(kind, dtype):
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 11, 3, 32
    x = jnp.asarray(rng.standard_normal((B, S, H, D)).astype(np.float32)).astype(dtype)
    pos = _streams(B, S, kind, seed=4) + 1000       # large angles too
    j = JROPE.apply_m_rope(x, jnp.asarray(pos), 1e6, (4, 6, 6))
    t = TROPE.apply_m_rope(tensor_from_numpy(np.asarray(x)), torch.from_numpy(pos),
                           1e6, (4, 6, 6))
    assert str(t.dtype).split(".")[-1] == dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f32(t), _f32(j), rtol=1e-5, atol=1e-5)
    else:     # the rotation in fp32, one rounding to bf16: one ulp apart at most
        assert np.abs(_f32(t) - _f32(j)).max() <= 2 ** -7 * np.abs(_f32(j)).max()


def test_m_rope_with_equal_streams_is_rope():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 7, 2, 32)).astype(np.float32))
    pos = torch.from_numpy(_streams(2, 7, "equal"))
    torch.testing.assert_close(TROPE.apply_m_rope(x, pos, 1e6, (4, 6, 6)),
                               TROPE.apply_rope(x, pos[0], 1e6), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["default", "different"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(compute_dtype, kind):
    jcfg, tcfg, jp, tp = _weights(compute_dtype)
    tp = T.prepare_params(tcfg, tp)
    B, S = 2, 13
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pos = None if kind == "default" else _streams(B, S, kind, seed=2)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks),
                        None if pos is None else jnp.asarray(pos),
                        max_len=20, cache_dtype=compute_dtype)
    dispatch.reset_counts()
    tl, tc = T.prefill(tcfg, tp, torch.from_numpy(toks),
                       None if pos is None else torch.from_numpy(pos),
                       max_len=20, cache_dtype=compute_dtype)
    assert dispatch.kernel_table()["flash_attention"].plain_calls == tcfg.num_layers
    _close(tl, jl, compute_dtype)
    for name in ("k", "v"):
        _close(getattr(tc, name), getattr(jc, name), compute_dtype)
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [S, S]


def _run(mod, cfg, params, tensor, steps):
    """Drive ``mod`` (the JAX or the torch transformer) through the paged
    schedule of ``tests/test_torch_model.py``: a prompt in chunks of 8
    and 12, a second one seeded past its first 16 rows, then 3 decode
    steps of both."""
    cache = mod.make_paged_cache(cfg, 1 + 10, BS, 2, MB, cfg.compute_dtype, **(
        {"device": "cpu"} if mod is T else {}))
    logits = []
    for tokens, wids, table, q_start, kv_len, last in steps["prefill"]:
        lg, cache = mod.prefill_paged(
            cfg, params, tensor(tokens), cache, tensor(wids), tensor(table),
            q_start=tensor(q_start), kv_len=tensor(kv_len), last_idx=last)
        logits.append(lg)
    cache = cache._replace(block_tables=tensor(steps["tables"]),
                           length=tensor(steps["lengths"]))
    for tok in steps["decode"]:
        lg, cache = mod.decode_step(cfg, params, tensor(tok), cache)
        logits.append(lg)
    return logits, cache


def _schedule(vocab):
    rng = np.random.default_rng(0)
    a = rng.integers(0, vocab, 20).astype(np.int32)
    b = np.concatenate([a[:16], rng.integers(0, vocab, 7).astype(np.int32)])
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    tbl_a, tbl_b = i32([[1, 2, 3, 0, 0, 0]]), i32([[1, 2, 4, 0, 0, 0]])
    pad = lambda t, n: np.pad(t, (0, n - len(t)))[None]  # noqa: E731
    return {"prefill": [(a[None, :8], i32([1]), tbl_a, i32([0]), i32([8]), 7),
                        (pad(a[8:20], 16), i32([2, 3]), tbl_a, i32([8]), i32([20]), 11),
                        (pad(b[16:], 8), i32([4]), tbl_b, i32([16]), i32([23]), 6)],
            "tables": np.concatenate([tbl_a, tbl_b]), "lengths": i32([20, 23]),
            "decode": [rng.integers(0, vocab, (2, 1)).astype(np.int32)
                       for _ in range(3)]}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_paged_then_decode_match_reference(compute_dtype):
    jcfg, tcfg, jp, tp = _weights(compute_dtype)
    tp = T.prepare_params(tcfg, tp)
    steps = _schedule(jcfg.vocab_size)
    jl, jc = _run(JT, jcfg, jp, jnp.asarray, steps)
    dispatch.reset_counts()
    tl, tc = _run(T, tcfg, tp, torch.from_numpy, steps)
    table = dispatch.kernel_table()
    assert table["paged_prefill_attention"].plain_calls == 3 * tcfg.num_layers
    assert table["paged_decode_attention"].plain_calls == 3 * tcfg.num_layers
    assert table["matmul"].plain_calls == 6 * (7 * tcfg.num_layers + 1)
    for t, j in zip(tl, jl):
        _close(t, j, compute_dtype)
    for name in ("k", "v"):     # every block but the trash block
        _close(_f32(getattr(tc, name))[:, 1:], _f32(getattr(jc, name))[:, 1:],
               compute_dtype)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_verify_paged_matches_reference():
    """Three live slots of 4 candidate rows at mid-block q_starts (RoPE at
    their own positions, three equal streams) and a padding slot."""
    jcfg, tcfg, jp, tp = _weights("float32")
    rng = np.random.default_rng(7)
    shape = (jcfg.num_layers, 1 + 3 * MB, BS, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tables = np.zeros((4, MB), np.int32)
    tables[:3] = (1 + rng.permutation(3 * MB)).reshape(3, MB)
    q_start = np.array([9, 27, 3, 0], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (4, 4)).astype(np.int32)
    zeros = np.zeros((4, MB), np.int32), np.zeros((4,), np.int32)
    jc = JT.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                         block_tables=jnp.asarray(zeros[0]), length=jnp.asarray(zeros[1]))
    tc = T.PagedKVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                        block_tables=torch.from_numpy(zeros[0]),
                        length=torch.from_numpy(zeros[1]))
    jl, jc = JT.verify_paged(jcfg, jp, jnp.asarray(toks), jc, jnp.asarray(tables),
                             q_start=jnp.asarray(q_start), kv_len=jnp.asarray(q_start + 4))
    tl, tc = T.verify_paged(tcfg, T.prepare_params(tcfg, tp), torch.from_numpy(toks), tc,
                            torch.from_numpy(tables), q_start=torch.from_numpy(q_start),
                            kv_len=torch.from_numpy(q_start + 4))
    np.testing.assert_allclose(_f32(tl[:3]), _f32(jl[:3]), rtol=1e-4, atol=1e-4)
    live = np.unique(tables[:3])
    for name in ("k", "v"):
        np.testing.assert_allclose(_f32(getattr(tc, name))[:, live],
                                   _f32(getattr(jc, name))[:, live], rtol=1e-4, atol=1e-4)


def _requests(mod, sampler, vocab):
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, vocab, 16).astype(np.int32)
    out = []
    for i, n in enumerate((5, 21, 3, 12)):
        tail = rng.integers(0, vocab, n).astype(np.int32)
        prompt = np.concatenate([prefix, tail]) if i % 2 == 0 else tail
        out.append(mod.Request(i, prompt, max_new_tokens=4 + i, sampler=sampler.greedy()))
    return out


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_serves_qwen2_vl_smoke_with_the_jax_engines_tokens(paged):
    """Paged (chunked prefill with shared prefixes, K2 / K1) and contiguous
    (the whole prompt through K4 with the engine's (3, W, S) positions, K3)
    at fp32: greedy tokens and counters equal the JAX engine's."""
    jcfg, tcfg, jp, tp = _weights("float32")
    kw = dict(max_len=64, batch_slots=3, block_size=8, cache_dtype="float32")
    if paged:
        kw["prefill_chunk"] = 16
    jreqs, treqs = _requests(JE, JS, jcfg.vocab_size), _requests(TE, TS, tcfg.vocab_size)
    js = JE.ServingEngine(jcfg, jp, paged=paged, **kw).serve(jreqs)
    dispatch.reset_counts()
    teng = TE.ServingEngine(tcfg, tp, paged=paged, device="cpu", **kw)
    ts = teng.serve(treqs)
    assert teng.paged == paged
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.state is TE.RequestState.DONE for r in treqs)
    for name in ("prefill_tokens_total", "prefill_tokens_computed", "decode_steps",
                 "prefills"):
        assert getattr(ts, name) == getattr(js, name), name
    table = dispatch.kernel_table()
    attention = (("paged_prefill_attention", "paged_decode_attention") if paged
                 else ("flash_attention", "decode_attention"))
    assert all(table[n].plain_calls > 0 for n in attention)
    assert all(k.launches == 0 for k in table.values())


def test_engine_batch_carries_three_equal_position_streams():
    _, tcfg, _, tp = _weights("float32")
    eng = TE.ServingEngine(tcfg, tp, max_len=32, paged=False, device="cpu")
    batch = eng._batch_for(np.zeros((2, 5), np.int32))
    assert tuple(batch["positions"].shape) == (3, 2, 5)
    assert (batch["positions"] == torch.arange(5, dtype=torch.int32)).all()
    assert "frames" not in batch


def test_positions_whose_stream_0_is_not_the_row_index_raise():
    """K4 and K2 mask by row index where the reference masks by stream 0:
    such positions raise in ``prefill`` and ``forward``; streams 1 and 2
    are free."""
    _, tcfg, _, tp = _weights("float32")
    tp = T.prepare_params(tcfg, tp)
    toks = torch.zeros((1, 6), dtype=torch.int32)
    free = torch.from_numpy(_streams(1, 6, "different", seed=9))
    T.prefill(tcfg, tp, toks, free)                      # streams 1, 2 free
    T.forward(tcfg, tp, toks, free, remat=False)
    shifted = free.clone()
    shifted[0] += 3
    for fn in (lambda: T.prefill(tcfg, tp, toks, shifted),
               lambda: T.forward(tcfg, tp, toks, shifted, remat=False)):
        with pytest.raises(ValueError, match="stream 0"):
            fn()


def test_serve_launcher_runs_qwen2_vl_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--device",
                                     "cpu", "--requests", "3", "--new-tokens", "3"])
    assert serve.main() == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=9" in out
    assert "kv_blocks_peak" in out
