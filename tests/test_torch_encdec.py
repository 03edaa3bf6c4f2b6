"""The port's encoder-decoder (whisper, the audio family) against the JAX
package on the same weights (handed over through ``repro_torch.interop``),
the same tokens and the same frames, at ``whisper-medium-smoke`` (2
encoder and 2 decoder layers, 32 frames) on the CPU, where every kernel
wrapper runs its plain version.

* ``sinusoid`` (from 0 and at per-row offsets), ``encode``, ``cross_kv``,
  ``forward``, ``prefill`` and ``decode_step``: logits and every leaf of
  the state.  fp32 compute at rtol 1e-4 / atol 1e-4 (fp32 caches) and
  2^-10 of the largest logit over bf16 caches (decode attention rounds p
  to the cache's type in both packages, where a rounding may fall the
  other way); the encoder at bf16 compute within 5e-2 of the largest
  magnitude (one bf16 ulp of a hidden state moves the output by about
  that much, as ``tests/test_torch_model.py`` states for the dense
  family), the decoder's logits and state at bf16 compute to accuracy
  parity: the random smoke model amplifies bf16 rounding so far that the
  reference's own bf16 logits sit 0.47 of the largest from its fp32 ones
  (the port's 0.46), so the port's bf16 values may sit no farther from
  the reference's fp32 ones than the reference's bf16 values do, plus
  5e-2 of the largest, as ``tests/test_torch_model.py`` holds the MoE
  family.
* The contiguous engine's greedy tokens and counters against the JAX
  engine's at 1 and 2 slots, and the kernels' counts on that path: K4
  three times a layer a prefill (encoder, decoder self and cross), K3
  twice a layer a decode step.
* K4's plain version at a KV length of its own (non-causal) against the
  reference's ``chunked_attention``; K4 at S != S_kv causal, or with no
  key rows, raises (its backward at S != S_kv non-causal is
  ``tests/test_torch_encdec_training.py``'s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import encdec as JED
from repro.models.layers.attention import chunked_attention as jax_chunked_attention
from repro.models.registry import fns_for as jax_fns
from repro.serving import engine as JE
from repro.serving import sampler as JS
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import encdec as TED
from repro_torch.models.registry import ENCDEC_FNS, fns_for
from repro_torch.serving import engine as TE
from repro_torch.serving import sampler as TS

torch.set_num_threads(1)

ARCH = "whisper-medium"
RTOL = 1e-4


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32))


def _rel(t, j):
    t, j = _f32(t), _f32(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def _close(t, j, compute_dtype):
    if compute_dtype == "float32":
        np.testing.assert_allclose(_f32(t), _f32(j), rtol=RTOL, atol=RTOL)
    else:
        assert _rel(t, j) <= 5e-2


def _parity(t, j, x):
    """The port's bf16 value ``t`` no farther from the reference's fp32
    value ``x`` than the reference's bf16 value ``j`` is, plus 5e-2 of the
    largest."""
    t, j, x = _f32(t), _f32(j), _f32(x)
    assert np.abs(t - x).max() <= np.abs(j - x).max() + 5e-2 * np.abs(x).max()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def weights(request):
    compute_dtype = request.param
    jcfg = JR.smoke(ARCH).replace(compute_dtype=compute_dtype)
    tcfg = TR.smoke(ARCH).replace(compute_dtype=compute_dtype)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def fp32_weights():
    jcfg = JR.smoke(ARCH).replace(compute_dtype="float32")
    tcfg = TR.smoke(ARCH).replace(compute_dtype="float32")
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _inputs(cfg, B=2, S=9, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal(
        (B, cfg.encdec.num_encoder_frames, cfg.d_model)).astype(np.float32)
    return toks, frames


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def test_registry_serves_the_audio_family_contiguous():
    fns = fns_for(TR.smoke(ARCH))
    assert fns is ENCDEC_FNS and fns.init_paged_state is None
    assert fns.verify_paged is None and fns.init_decode_state is not None


def test_params_match_the_reference_leaf_for_leaf(fp32_weights):
    jcfg, tcfg, jp, _ = fp32_weights
    tp = fns_for(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    assert dict(_leaves(tp)) == dict(_leaves(jp))
    assert tp["dec_blocks"]["cross_attn"]["wk"].shape[0] == tcfg.num_layers
    assert tp["enc_blocks"]["mlp"]["b_in"].shape == (2, tcfg.d_ff)


def test_prepare_params_casts_product_weights_only(fp32_weights):
    _, tcfg, _, tp = fp32_weights
    bf = TED.prepare_params(tcfg.replace(compute_dtype="bfloat16"), tp, "cpu")
    for leaf in (bf["enc_blocks"]["attn"]["wq"], bf["enc_blocks"]["attn"]["bk"],
                 bf["enc_blocks"]["mlp"]["w_in"], bf["enc_blocks"]["mlp"]["b_out"],
                 bf["dec_blocks"]["cross_attn"]["wv"], bf["dec_blocks"]["self_attn"]["wo"]):
        assert leaf.dtype == torch.bfloat16
    for leaf in (bf["enc_blocks"]["ln1"]["scale"], bf["enc_blocks"]["ln1"]["bias"],
                 bf["dec_ln_f"]["bias"], bf["enc_ln_f"]["scale"], bf["embed"]["tok"],
                 bf["embed"]["lm_head"]):
        assert leaf.dtype == torch.float32


@pytest.mark.parametrize("offset", [0, 37, "rows"])
@pytest.mark.parametrize("d", [64, 1024])
def test_sinusoid_matches_reference(d, offset):
    """From 0, from an int offset, and at per-row offsets (decode): within
    fp32 rounding of the reference's, at whisper-medium's width too."""
    if offset == "rows":
        rows = np.array([0, 5, 255, 1499], np.int32)
        j = jax.vmap(lambda o: JED.sinusoid(1, d, o))(jnp.asarray(rows))
        t = TED.sinusoid(1, d, torch.from_numpy(rows))
    else:
        j = JED.sinusoid(1500, d, offset)
        t = TED.sinusoid(1500, d, offset)
    assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=2e-4)


def test_encode_and_cross_kv_match_reference(weights):
    jcfg, tcfg, jp, tp = weights
    tp = TED.prepare_params(tcfg, tp)
    _, frames = _inputs(jcfg)
    je = JED.encode(jcfg, jp, jnp.asarray(frames))
    dispatch.reset_counts()
    te = TED.encode(tcfg, tp, torch.from_numpy(frames))
    table = dispatch.kernel_table()
    L_enc = tcfg.encdec.num_encoder_layers
    assert table["flash_attention"].plain_calls == L_enc
    assert table["matmul"].plain_calls == 6 * L_enc
    _close(te, je, tcfg.compute_dtype)
    jk, jv = JED.cross_kv(jcfg, jp, je)
    tk, tv = TED.cross_kv(tcfg, tp, tensor_from_numpy(np.asarray(je)))
    assert tuple(tk.shape) == jk.shape == (tcfg.num_layers, 2, 32, 4, 16)
    _close(tk, jk, tcfg.compute_dtype)
    _close(tv, jv, tcfg.compute_dtype)


def test_forward_matches_reference(weights):
    jcfg, tcfg, jp, tp = weights
    toks, frames = _inputs(jcfg, S=12)
    jl, jaux = JED.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(frames))
    tl, taux = fns_for(tcfg).forward(
        tcfg, TED.prepare_params(tcfg, tp),
        {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})
    assert tuple(tl.shape) == jl.shape and tl.dtype == torch.float32
    if tcfg.compute_dtype == "float32":
        _close(tl, jl, "float32")
    else:
        exact, _ = JED.forward(jcfg.replace(compute_dtype="float32"), jp,
                               jnp.asarray(toks), jnp.asarray(frames))
        _parity(tl, jl, exact)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_match_reference(weights, cache_dtype):
    jcfg, tcfg, jp, tp = weights
    tp = TED.prepare_params(tcfg, tp)
    toks, frames = _inputs(jcfg)
    jl, js = JED.prefill(jcfg, jp, jnp.asarray(toks), jnp.asarray(frames), max_len=16,
                         cache_dtype=cache_dtype)
    dispatch.reset_counts()
    tl, ts = TED.prefill(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(frames),
                         max_len=16, cache_dtype=cache_dtype)
    table = dispatch.kernel_table()
    L, L_enc = tcfg.num_layers, tcfg.encdec.num_encoder_layers
    # the encoder's layers, each decoder layer's self- and cross-attention
    assert table["flash_attention"].plain_calls == L_enc + 2 * L
    # encoder 6 a layer, cross K/V 2, decoder 8, the LM head
    assert table["matmul"].plain_calls == 6 * L_enc + 2 * L + 8 * L + 1
    bf16 = tcfg.compute_dtype == "bfloat16"
    if bf16:     # the reference in fp32 compute on the same caches' type
        f32 = jcfg.replace(compute_dtype="float32")
        xl, xs = JED.prefill(f32, jp, jnp.asarray(toks), jnp.asarray(frames),
                             max_len=16, cache_dtype=cache_dtype)
        _parity(tl, jl, xl)
    else:
        _close(tl, jl, "float32")
    limit = RTOL if cache_dtype == "float32" else 2 ** -10
    rng = np.random.default_rng(3)
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, js = JED.decode_step(jcfg, jp, jnp.asarray(tok), js)
        dispatch.reset_counts()
        tl, ts = TED.decode_step(tcfg, tp, torch.from_numpy(tok), ts)
        table = dispatch.kernel_table()
        assert table["decode_attention"].plain_calls == 2 * L
        assert table["matmul"].plain_calls == 8 * L + 1
        if bf16:
            xl, xs = JED.decode_step(f32, jp, jnp.asarray(tok), xs)
            _parity(tl, jl, xl)
        elif cache_dtype == "float32":
            np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=RTOL, atol=RTOL)
        else:
            assert _rel(tl, jl) <= limit, step
    for name in js._fields:
        j, t = getattr(js, name), getattr(ts, name)
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        if name == "length":
            assert t.tolist() == np.asarray(j).tolist() == [12, 12]
        elif bf16:
            _parity(t, j, getattr(xs, name))
        else:
            # a bf16 leaf rounds where JAX's does: one bf16 step apart; the
            # fp32 leaves carry the logits' limit
            assert _rel(t, j) <= (2 ** -7 if t.dtype == torch.bfloat16 else limit), name


def test_decode_state_and_idle_slots_match_reference(fp32_weights):
    jcfg, tcfg, _, _ = fp32_weights
    js = jax_fns(jcfg).init_decode_state(jcfg, 3, 20)
    ts = fns_for(tcfg).init_decode_state(tcfg, 3, 20, device="cpu")
    for name in js._fields:
        assert tuple(getattr(ts, name).shape) == getattr(js, name).shape, name
    assert ts.length.tolist() == [19, 19, 19]          # idle: max_len - 1
    assert ts.cross_k.dtype == ts.self_v.dtype == torch.bfloat16


def test_merge_slot_finds_the_batch_axis_of_every_leaf(fp32_weights):
    """The (L, B, F, K, D) cross caches and the (L, B, S, K, D) self caches
    merge at axis 1, length at axis 0, as the reference's ``_merge_slot``."""
    jcfg, tcfg, _, _ = fp32_weights
    js = jax_fns(jcfg).init_decode_state(jcfg, 3, 10)
    ts = fns_for(tcfg).init_decode_state(tcfg, 3, 10, device="cpu")
    rng = np.random.default_rng(2)
    one = []
    for name in js._fields:
        shape = list(getattr(js, name).shape)
        shape[0 if name == "length" else 1] = 1
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
            for i, n in enumerate((7, 16, 3, 11, 5))]


COUNTERS = ("prefill_tokens_total", "prefill_tokens_computed", "prefills",
            "decode_steps", "prefill_compiles", "tokens")


@pytest.mark.parametrize("slots", [1, 2])
def test_contiguous_engine_matches_jax_engine(fp32_weights, slots):
    jcfg, tcfg, jp, tp = fp32_weights
    js = JE.ServingEngine(jcfg, jp, max_len=32, batch_slots=slots, chunk=16).serve(
        jr := _requests(JE, JS, jcfg.vocab_size))
    dispatch.reset_counts()
    te = TE.ServingEngine(tcfg, tp, max_len=32, batch_slots=slots, chunk=16, device="cpu")
    ts = te.serve(tr := _requests(TE, TS, tcfg.vocab_size))
    assert not te.paged and te.pool is None
    assert [r.output for r in tr] == [r.output for r in jr]
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    table = dispatch.kernel_table()
    L, L_enc = tcfg.num_layers, tcfg.encdec.num_encoder_layers
    assert table["flash_attention"].plain_calls == (L_enc + 2 * L) * ts.prefills
    assert table["decode_attention"].plain_calls == 2 * L * ts.decode_steps
    assert all(k.launches == 0 for k in table.values())
    assert table["paged_decode_attention"].plain_calls == 0


def test_engine_batch_carries_zero_frames(fp32_weights):
    _, tcfg, _, tp = fp32_weights
    eng = TE.ServingEngine(tcfg, tp, max_len=32, device="cpu")
    batch = eng._batch_for(np.zeros((2, 5), np.int32))
    assert tuple(batch["frames"].shape) == (2, 32, tcfg.d_model)
    assert batch["frames"].dtype == torch.float32 and not batch["frames"].any()
    assert "positions" not in batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,S_kv,H,K", [(5, 37, 4, 2), (1, 1500, 4, 4), (16, 13, 2, 1)])
def test_flash_attention_takes_a_kv_length_of_its_own(S, S_kv, H, K, dtype):
    """K4's plain version at S != S_kv, non-causal (ragged S_kv, GQA, one
    query row, more queries than keys) against the reference's
    ``chunked_attention`` on the same values."""
    rng = np.random.default_rng(S_kv)
    D = 16
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, S, H, D), (2, S_kv, K, D), (2, S_kv, K, D))]
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    want = jax_chunked_attention(*j, causal=False, chunk=256)
    got = flash_attention(*(tensor_from_numpy(np.asarray(a)) for a in j),
                          causal=False, chunk=256)
    assert tuple(got.shape) == (2, S, H, D)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=RTOL)
    else:
        assert np.abs(_f32(got) - _f32(want)).max() <= 2 ** -7 * np.abs(_f32(want)).max()


def test_flash_attention_refuses_a_kv_length_causal_and_in_the_backward():
    """A causal call at S != S_kv raises, forward and backward, and so does
    one with no key rows; the backward takes S != S_kv non-causal."""
    q = torch.randn((1, 4, 2, 16))
    kv = torch.randn((1, 9, 2, 16))
    with pytest.raises(ValueError, match="causal attention takes k and v"):
        flash_attention(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="causal attention takes k and v"):
        flash_attention(q.clone().requires_grad_(), kv, kv, causal=True)
    with pytest.raises(ValueError, match="flash_attention_backward: causal attention"):
        dispatch.kernel_table()["flash_attention_backward"](
            q, kv, kv, q, q, torch.zeros((1, 2, 4)), causal=True)
    with pytest.raises(ValueError, match="no key rows"):
        flash_attention(q.detach(), kv[:, :0], kv[:, :0], causal=False)
    flash_attention(q.clone().requires_grad_(), kv, kv, causal=False).sum().backward()


def test_serve_launcher_runs_whisper_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--device",
                                     "cpu", "--requests", "3", "--new-tokens", "3"])
    assert serve.main() == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=9" in out
    assert "contiguous KV" in out
