"""GoogLeNet training on the CPU against the JAX package, at
``googlenet-smoke`` (the full graph: 57 convolutions, 9 inception modules,
1000 classes) on 64x64 images, fp32, on the same weights (handed over
through ``repro_torch.interop``) and the same numpy batch from
``SyntheticImages``.  The reference trains it the same way: ``Trainer``
fed by ``SyntheticImages`` and ``make_train_step`` (its launcher feeds
only tokens).

* One train step (``make_train_step``, AdamW) at 1 and 2 microbatches of
  a batch of 2: the loss and metrics (rtol 1e-5) at fp32, with the plain
  calls of K6, its backward and K7 held exactly; every gradient leaf
  (within ``GRAD_REL`` of its own largest entry, as the LM tests hold
  them) and the updated parameters with each side's convs summed in fp64
  and rounded once (2e-6 of a leaf's largest is read): at fp32 one ReLU
  of this batch sits within the two libraries' rounding of zero.  The
  port's fp32 gradients within ``GRAD_REL`` of its rounded-once run.
* ``classification_cross_entropy`` against the reference's.
* The Trainer takes GoogLeNet: a checkpoint written mid-run restores bit
  for bit, a crash resumes from the last checkpoint (the step after it
  runs again), as ``tests/test_training.py`` holds the reference's.
"""
import contextlib
import tempfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.data.pipeline import SyntheticImages as JaxSyntheticImages
from repro.models.layers import conv as JC
from repro.models.registry import fns_for as jax_fns
from repro.optim import optimizers as JO
from repro.training import losses as JL
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.distributed.fault import FaultSchedule
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.conv2d.ref import conv2d_backward_ref, conv2d_ref
from repro_torch.models.registry import fns_for
from repro_torch.optim import optimizers as TO
from repro_torch.training import losses as TL
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import TRAINED_FAMILIES, Trainer, TrainerConfig

torch.set_num_threads(1)

GRAD_REL = 5e-4     # each gradient leaf, of its largest (the LM tests')
SIZE = 64


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_rel(t, j, rel):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= rel * max(np.abs(j).max(), 1e-30)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _counts():
    table = dispatch.kernel_table()
    return {n: table[n].plain_calls for n in ("conv2d", "conv2d_backward", "matmul")}


def _jax_exact_conv(params, x, *, stride=1, padding="SAME"):
    """The reference's conv with its products summed in fp64 and the sum
    rounded once to x's type (under ``jax.enable_x64``)."""
    out = jax.lax.conv_general_dilated(
        x.astype(jnp.float64), params["w"].astype(jnp.float64), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return (out + params["b"].astype(jnp.float64)).astype(x.dtype)


def _torch_exact_conv(x, w, b, *, stride=1):
    return conv2d_ref(x.double(), w.double(), b.double(), stride=stride).to(x.dtype)


def _torch_exact_backward(x, w, b, dy, *, stride=1, need_dx=True):
    dx, dw, db = conv2d_backward_ref(x.double(), w.double(), b.double(), dy.double(),
                                     stride=stride, need_dx=need_dx)
    return None if dx is None else dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype)


def _jax_step(jcfg, jp, batch, accum, exact):
    """The reference's jitted train step: (new params, metrics, gradients)."""
    captured = {}

    def grab(g):            # under jit: the gradients reach the host by callback
        jax.debug.callback(lambda h: captured.update(g=jax.tree_util.tree_map(np.array, h)),
                           g)
        return g
    opt = JO.adamw(JO.constant(1e-3))
    step = jax.jit(jax_make_train_step(jcfg, opt, accum=accum, grad_transform=grab))
    with contextlib.ExitStack() as stack:
        if exact:
            stack.enter_context(jax.enable_x64(True))
            stack.enter_context(mock.patch.object(JC, "conv2d", _jax_exact_conv))
        p2, _, m = step(jp, opt.init(jp), jax.tree_util.tree_map(jnp.asarray, batch))
        jax.effects_barrier()
    return p2, m, _flat(captured["g"])


def _torch_step(tcfg, jp, batch, accum, exact):
    """The port's train step on the reference's weights: (new params,
    metrics, gradients, plain calls of K6, its backward and K7)."""
    captured = {}
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    opt = TO.adamw(TO.constant(1e-3))
    step = make_train_step(tcfg, opt, accum=accum, grad_transform=lambda g: captured.update(
        g={k: v.clone() for k, v in _flat(g).items()}) or g)
    table = dispatch.kernel_table()
    with contextlib.ExitStack() as stack:
        if exact:
            stack.enter_context(mock.patch.object(table["conv2d"], "plain", _torch_exact_conv))
            stack.enter_context(mock.patch.object(table["conv2d_backward"], "plain",
                                                  _torch_exact_backward))
        dispatch.reset_counts()
        tp2, _, m = step(tp, opt.init(tp), batch)
    assert all(not p.requires_grad and p.grad is None for p in _flat(tp2).values())
    return tp2, m, captured["g"], _counts()


def _metrics_match(tm, jm):
    for k in ("loss", "nll", "accuracy", "aux_loss", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_loss_and_gradients_match_jax(accum):
    """The port's fp32 step against the reference's: loss and metrics as
    they are.  Gradients and updates with every conv summed in fp64 and
    rounded once on both sides: at fp32 the two libraries' sums, each right
    to its rounding, put one ReLU of this batch on opposite sides of zero
    (inc4e.b1, a pre-activation of -3.3e-7 in the port and +8.8e-8 in the
    reference against an rms of 0.42), and every gradient upstream of it
    moves by up to 11% of its largest entry.  The port's fp32 gradients are
    then held to its own rounded-once run."""
    jcfg, tcfg = JR.smoke("googlenet"), TR.smoke("googlenet")
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    batch = SyntheticImages(jcfg.vocab_size, 2, SIZE, seed=3).sample(2)
    _, jm32, _ = _jax_step(jcfg, jp, batch, accum, exact=False)
    _, tm32, tg32, counts = _torch_step(tcfg, jp, batch, accum, exact=False)
    # a microbatch: K6 and its backward once a conv, K7 for the classifier's
    # forward, dX and dW
    assert counts == {"conv2d": 57 * accum, "conv2d_backward": 57 * accum,
                      "matmul": 3 * accum}
    _metrics_match(tm32, jm32)
    jp2, jm, jg = _jax_step(jcfg, jp, batch, accum, exact=True)
    tp2, tm, tg, counts = _torch_step(tcfg, jp, batch, accum, exact=True)
    assert counts["conv2d"] == counts["conv2d_backward"] == 57 * accum
    _metrics_match(tm, jm)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=GRAD_REL)
    assert set(jg) == set(tg) == set(tg32) and len(jg) == 116
    for k, g in jg.items():
        _close_rel(tg[k], g, GRAD_REL)
        _close_rel(tg32[k], tg[k], GRAD_REL)
    for k, p in _flat(jp2).items():
        g = np.abs(jg[k])
        live = g > 1e-3 * g.max()
        np.testing.assert_allclose(_np(_flat(tp2)[k])[live], _np(p)[live],
                                   rtol=1e-5, atol=1e-6)


def test_classification_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = (4 * rng.standard_normal((6, 50))).astype(np.float32)
    labels = rng.integers(0, 50, 6).astype(np.int32)
    labels[:2] = logits[:2].argmax(-1)                 # some right answers
    jl, jm = JL.classification_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tl, tm = TL.classification_cross_entropy(torch.from_numpy(logits),
                                             torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tm["accuracy"]) == float(jm["accuracy"]) == pytest.approx(2 / 6)


def test_synthetic_images_and_the_forward_entry_match_the_reference():
    ours = SyntheticImages(1000, 3, 32, seed=4)
    ref = JaxSyntheticImages(1000, 3, 32, seed=4)
    for _ in range(2):
        a, b = next(ours), next(ref)
        for k in ("images", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    cfg = TR.smoke("googlenet")
    fns = fns_for(cfg)
    params = fns.init(cfg, torch.Generator().manual_seed(0))
    batch = {"images": torch.from_numpy(a["images"])}
    logits, aux = fns.forward(cfg, params, batch, remat=False, chunk=7)
    assert logits.shape == (3, 1000) and float(aux) == 0.0
    assert "cnn" in TRAINED_FAMILIES


def _trainer(tmp, steps, events=None, ckpt_every=4, seed=0):
    cfg = TR.smoke("googlenet")
    data = SyntheticImages(cfg.vocab_size, 2, 32, seed=seed)
    tc = TrainerConfig(num_steps=steps, ckpt_every=ckpt_every, ckpt_dir=tmp,
                       async_save=False, device="cpu")
    return Trainer(cfg, iter(data), tc, optimizer=TO.adamw(TO.warmup_cosine(3e-3, 3, steps)),
                   fault_schedule=FaultSchedule(events=events or {}))


def test_trainer_crash_recovery_resumes_from_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, steps=10, events={9: "crash"})
        hist = tr.train()
        events = [h for h in hist if "event" in h]
        assert len(events) == 1 and events[0]["event"] == "crash"
        steps_run = [h["step"] for h in hist if "loss" in h]
        assert steps_run.count(8) == 2      # step 8 re-ran after restore
        assert tr.step == 10
        assert all(np.isfinite(h["loss"]) for h in hist if "loss" in h)


def test_trainer_checkpoint_round_trip_and_resume():
    """Trainer A saves at step 4; trainer B (another init) restores it bit
    for bit and continues; the next step equals A's."""
    with tempfile.TemporaryDirectory() as d:
        a = _trainer(d, steps=4)
        a.train()
        b = _trainer(d, steps=5, seed=1)
        assert b.try_resume() and b.step == 4
        state = lambda tr: _flat(tr.params) | {("opt",) + k: v for k, v in  # noqa: E731
                                               _flat(tr.opt_state).items()}
        for k, v in state(a).items():
            torch.testing.assert_close(state(b)[k], v, rtol=0, atol=0)
        a.data_iter, b.data_iter = (iter(SyntheticImages(1000, 2, 32, seed=7)) for _ in "ab")
        a.tc.num_steps = 5
        a.train()
        b.train()
        assert a.history[-1]["loss"] == b.history[-1]["loss"]
        for k, v in state(a).items():
            torch.testing.assert_close(state(b)[k], v, rtol=0, atol=0)
