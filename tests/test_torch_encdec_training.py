"""Training whisper (the audio family, encoder-decoder) on the CPU against
the JAX package, at ``whisper-medium-smoke`` (2 encoder and 2 decoder
layers, 32 frames), on the same weights (handed over through
``repro_torch.interop``) and the same numpy data; and K4's backward at a
KV length of its own, which the decoder's cross-attention needs.

* K4's plain backward (``flash_attention_backward_ref``) and
  ``flash_attention``'s autograd at S != S_kv, non-causal (more keys than
  queries, one query row against 1500 keys, fewer keys than queries; GQA
  and G = 1), fp32, against ``jax.vjp`` of the reference's
  ``chunked_attention(causal=False)`` with ``kv_positions = arange(S_kv)``:
  each gradient within 1e-5 of its own largest entry (the same fp32
  formulas summed in other orders, as ``tests/test_torch_backward.py``
  holds the square case).
* One train step (``make_train_step``, AdamW) at fp32 compute, remat
  "none" / "full" / "dots" and 1 / 2 microbatches: the loss and metrics
  (rtol 1e-5), every gradient leaf (within 5e-4 of its own largest entry,
  as the dense family's test; up to 1.3e-4 is read) and the updated
  parameters, with the plain calls of K4, its backward and K7 held
  exactly a microbatch.  "dots" runs as "full": the reference checkpoints
  each block with ``nothing_saveable`` whatever the policy.  The key
  biases' exact gradient is zero (without RoPE a bias on every key
  shifts a row's scores by one constant, which the softmax ignores): both
  packages give rounding noise there, ~1e-8, held within 5e-4 of the
  same attention's query-bias gradient instead of their own largest, and
  their update (AdamW's first step moves by about lr times the sign of
  that noise) is not compared.
* One train step at bf16 compute to accuracy parity, as the test of
  whisper's serving holds its logits: the port's loss no farther from the
  reference's fp32 step than the reference's own bf16 loss is, plus 5e-2
  of it; its gradients, all leaves as one vector, no farther from the
  fp32 ones (relative L2) than the reference's bf16 gradients are, plus
  0.1.  The random smoke model amplifies bf16 rounding: the reference's
  own bf16 gradients sit 0.72 from its fp32 ones, the port's 0.68 (0.73
  and 0.78 on another batch), so single leaves are not compared.
* The microbatch split gives each microbatch its own rows of whisper's
  ``frames`` and GoogLeNet's ``images`` at batch 3 and 3 microbatches
  (the reference's takes them for M-RoPE positions there).
* The Trainer trains ``whisper-medium-smoke`` with a falling loss, and the
  launcher runs it on the CPU.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.models.layers.attention import chunked_attention as jax_chunked_attention
from repro.models.registry import fns_for as jax_fns
from repro.optim import optimizers as JO
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import SyntheticImages, SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (flash_attention_backward_ref,
                                                     flash_attention_ref)
from repro_torch.launch import train as train_launcher
from repro_torch.optim import optimizers as TO
from repro_torch.training.train_step import _split_microbatches, make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCH = "whisper-medium"
ATTN_REL = 1e-5     # each attention gradient, of its largest
GRAD_REL = 5e-4     # each gradient leaf, of its largest (the dense test's)
KERNELS = ("flash_attention", "flash_attention_backward", "matmul")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(t, j):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# K4's backward at a KV length of its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["plain", "autograd"])
@pytest.mark.parametrize("S,S_kv,H,K", [(5, 37, 4, 2), (1, 1500, 4, 4), (16, 13, 2, 1)])
def test_attention_backward_at_a_kv_length_of_its_own_matches_jax_vjp(S, S_kv, H, K, how):
    rng = np.random.default_rng(S * 7 + S_kv)
    B, D = 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S_kv, K, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: jax_chunked_attention(
        q, k, v, causal=False, kv_positions=jnp.arange(S_kv, dtype=jnp.int32), chunk=256),
        *map(jnp.asarray, (q, k, v)))
    jd = vjp(jnp.asarray(do))
    T = torch.from_numpy
    if how == "plain":
        o, lse = flash_attention_ref(T(q), T(k), T(v), causal=False, chunk=256, with_lse=True)
        assert lse.shape == (B, H, S)
        td = flash_attention_backward_ref(T(q), T(k), T(v), o, T(do), lse, causal=False)
    else:
        ts = [T(a).requires_grad_() for a in (q, k, v)]
        dispatch.reset_counts()
        o = flash_attention(*ts, causal=False, chunk=256)
        o.backward(T(do))
        td = [t.grad for t in ts]
        table = dispatch.kernel_table()
        assert table["flash_attention"].plain_calls == 1
        assert table["flash_attention_backward"].plain_calls == 1
    assert _rel(o, out) <= ATTN_REL
    assert [tuple(t.shape) for t in td] == [q.shape, k.shape, v.shape]
    for t, j in zip(td, jd):
        assert _rel(t, j) <= ATTN_REL


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------

def _setup(compute_dtype="float32", remat="full", seed=0):
    jcfg = JR.smoke(ARCH).replace(compute_dtype=compute_dtype, remat=remat)
    tcfg = TR.smoke(ARCH).replace(compute_dtype=compute_dtype, remat=remat)
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _want_counts(cfg):
    """Plain calls of one microbatch's forward and backward, from the
    config: K4 once an encoder layer and twice a decoder layer (causal self,
    cross), again in the recompute under any remat but "none", its
    backward once each; K7 for every weight product -- six an encoder layer
    (q k v o, the MLP's two), eight a decoder layer (self q k v o, cross q
    and o, the MLP's two), the cross K/V two a decoder layer outside the
    checkpoints, the LM head -- the blocks' again in the recompute, and
    every one twice in the backward (dX, dW)."""
    E, L = cfg.encdec.num_encoder_layers, cfg.num_layers
    ckpt = cfg.remat != "none"
    blocks = 6 * E + 8 * L
    fwd = blocks + 2 * L + 1
    return {"flash_attention": (E + 2 * L) * (2 if ckpt else 1),
            "flash_attention_backward": E + 2 * L,
            "matmul": fwd + (blocks if ckpt else 0) + 2 * fwd}


def _steps(compute_dtype, remat, accum, seed=3):
    """The reference's and the port's step on one batch: (jax params after,
    jax metrics, jax grads), (torch params after, torch metrics, torch
    grads), the port's plain calls."""
    jcfg, jp, tcfg, tp = _setup(compute_dtype, remat)
    batch = next(JaxSyntheticTokens(jcfg, 4, 12, seed=seed))
    assert batch["frames"].shape == (4, jcfg.encdec.num_encoder_frames, jcfg.d_model)
    captured = {}

    def grab(key):
        def hook(g):
            captured[key] = jax.tree_util.tree_map(np.array, g) if key == "jax" \
                else {k: v.clone() for k, v in _flat(g).items()}
            return g
        return hook
    jstep = jax_make_train_step(jcfg, JO.adamw(JO.constant(1e-3)), accum=accum,
                                grad_transform=grab("jax"))
    tstep = make_train_step(tcfg, TO.adamw(TO.constant(1e-3)), accum=accum,
                            grad_transform=grab("torch"))
    jp2, _, jm = jstep(jp, JO.adamw(JO.constant(1e-3)).init(jp),
                       jax.tree_util.tree_map(jnp.asarray, batch))
    dispatch.reset_counts()
    topt = TO.adamw(TO.constant(1e-3))
    tp2, _, tm = tstep(tp, topt.init(tp), batch)
    table = dispatch.kernel_table()
    counts = {n: table[n].plain_calls for n in KERNELS}
    assert all(not p.requires_grad and p.grad is None for p in _flat(tp2).values())
    return (jp2, jm, _flat(captured["jax"])), (tp2, tm, captured["torch"]), counts


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_loss_and_gradients_match_jax(accum, remat):
    (jp2, jm, jg), (tp2, tm, tg), counts = _steps("float32", remat, accum)
    assert counts == {n: accum * c
                      for n, c in _want_counts(TR.smoke(ARCH).replace(remat=remat)).items()}
    for k in ("loss", "nll", "accuracy", "aux_loss", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_REL)
    assert set(jg) == set(tg)
    scale = {k: np.abs(_np(jg[k[:-1] + ("bq",)] if k[-1] == "bk" else g)).max()
             for k, g in jg.items()}   # a key bias's exact zero: the query bias's scale
    for k, g in jg.items():
        assert np.abs(_np(tg[k]) - _np(g)).max() <= GRAD_REL * scale[k], k
    for k, p in _flat(jp2).items():
        live = np.abs(jg[k]) > 1e-3 * scale[k]
        np.testing.assert_allclose(_np(_flat(tp2)[k])[live], _np(p)[live],
                                   rtol=1e-5, atol=1e-6)


def test_bf16_train_step_has_the_references_accuracy():
    """bf16 compute: the port's loss no farther from the reference's fp32
    step than the reference's own bf16 loss is, plus 5e-2 of it; its
    gradients, as one vector, no farther from the fp32 ones than the
    reference's bf16 gradients are, plus 0.1 (relative L2)."""
    (_, jm, jg), (_, tm, tg), _ = _steps("bfloat16", "full", 1)
    (_, xm, xg), _, _ = _steps("float32", "full", 1)
    assert abs(float(tm["loss"]) - float(xm["loss"])) <= \
        abs(float(jm["loss"]) - float(xm["loss"])) + 5e-2 * abs(float(xm["loss"]))

    def vector(g):
        return np.concatenate([_np(g[k]).ravel() for k in sorted(xg)])
    t, j, x = vector(tg), vector(jg), vector(xg)
    assert np.isfinite(t).all()
    norm = np.linalg.norm
    assert norm(t - x) / norm(x) <= norm(j - x) / norm(x) + 0.1


# ---------------------------------------------------------------------------
# the microbatch split, the Trainer, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["whisper frames", "googlenet images"])
def test_split_microbatches_gives_each_microbatch_its_own_rows(source):
    """At batch 3 and 3 microbatches, a whisper batch's ``frames`` (B, F,
    D) and a GoogLeNet batch's ``images`` (B, H, W, 3) split along the
    batch like every input but M-RoPE's positions: microbatch i is row i."""
    if source == "whisper frames":
        batch = next(SyntheticTokens(TR.smoke(ARCH), 3, 10, seed=1))
        key = "frames"
    else:
        batch = SyntheticImages(TR.smoke("googlenet").vocab_size, 3, 64, seed=1).sample(3)
        key = "images"
    assert batch[key].shape[0] == 3 and batch[key].ndim >= 3
    for b in (batch, {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in batch.items()}):
        out = _split_microbatches(b, 3)
        for k, a in b.items():
            assert tuple(out[k].shape) == (3, 1, *a.shape[1:])
            for i in range(3):
                np.testing.assert_array_equal(np.asarray(out[k][i]), np.asarray(a[i:i + 1]))


def test_trainer_trains_whisper(tmp_path):
    cfg = TR.smoke(ARCH)
    data = SyntheticTokens(cfg, batch=4, seq_len=16)
    tc = TrainerConfig(num_steps=12, ckpt_every=100, ckpt_dir=str(tmp_path),
                       async_save=False, device="cpu")
    tr = Trainer(cfg, iter(data), tc, optimizer=TO.adamw(TO.warmup_cosine(3e-3, 3, 12)))
    assert tr.cfg.family == "audio"
    losses = [h["loss"] for h in tr.train() if "loss" in h]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_launcher_trains_whisper_on_the_cpu(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6", "--batch", "4",
            "--seq", "16", "--warmup", "2", "--ckpt-dir", str(tmp_path)]
    before = {t.ident for t in threading.enumerate()}
    out = train_launcher.run(train_launcher.parse(args))
    s = out["summary"]
    assert s["arch"] == "whisper-medium-smoke" and s["steps"] == 6
    assert s["last_loss"] < s["first_loss"]
    again = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "3",
             "--seq", "8", "--accum", "3", "--ckpt-dir", str(tmp_path / "b")]
    assert train_launcher.main(again) == 0
    assert "whisper-medium-smoke: steps=2" in capsys.readouterr().out
    assert not [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive() and t.name == "prefetch"]
