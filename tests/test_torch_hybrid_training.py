"""Training the zamba2 hybrid on the CPU against the JAX package, at
``zamba2-1.2b-smoke`` (5 layers, ``shared_attn_every=2``: two segments of
two Mamba-2 layers and the shared block, a 1-layer tail) and fp32
compute, on the same weights (handed over through ``repro_torch.interop``)
and the same numpy data.

* ``hybrid.forward``'s logits against the reference's, with ``remat``
  on and off (within 1e-5 of the largest logit).
* One train step (``make_train_step``, AdamW) at 1 and 2 microbatches: the
  loss and metrics (rtol 1e-5), every gradient leaf (within ``GRAD_REL``
  of its own largest entry, as the dense family's test holds them) and
  the updated parameters, with the plain-call counts of the five kernel
  entries on the path held exactly.
* ``remat="full"`` against ``"none"``: loss and gradients bit for bit;
  ``"dots"`` is not ported.
* The Trainer takes ``zamba2-1.2b``, and the launcher trains it at smoke
  size on the CPU with a falling loss.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.models import hybrid as JH
from repro.models.registry import fns_for as jax_fns
from repro.optim import optimizers as JO
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.launch import train as train_launcher
from repro_torch.models import hybrid as TH
from repro_torch.optim import optimizers as TO
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

REL = 1e-5          # logits, of the largest
GRAD_REL = 5e-4     # each gradient leaf, of its largest (the dense test's)
KERNELS = ("ssm_scan", "ssm_scan_backward", "flash_attention",
           "flash_attention_backward", "matmul")


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


def _setup(seed=0):
    jcfg = JR.smoke("zamba2-1.2b").replace(compute_dtype="float32")
    tcfg = TR.smoke("zamba2-1.2b").replace(compute_dtype="float32")
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _counts():
    table = dispatch.kernel_table()
    return {n: table[n].plain_calls for n in KERNELS}


def _want_counts(cfg, remat=True):
    """Plain calls of one microbatch's forward and backward, from the
    config: K5 once a Mamba layer, K4 once a shared-block application, each
    again in the recompute of a checkpointed segment (the tail is not
    checkpointed); each backward once; K7 for every weight product (two a
    Mamba layer, eight a shared-block application, the LM head), again in
    the recompute, and twice in the backward (dX, dW)."""
    n_seg, e, tail = TH._segments(cfg)
    full = remat and cfg.remat == "full"
    layers = n_seg * e + tail
    fwd = 2 * layers + 8 * n_seg + 1
    again = (2 * e * n_seg + 8 * n_seg) if full else 0
    return {"ssm_scan": layers + (n_seg * e if full else 0), "ssm_scan_backward": layers,
            "flash_attention": n_seg * (2 if full else 1),
            "flash_attention_backward": n_seg, "matmul": fwd + again + 2 * fwd}


@pytest.mark.parametrize("remat", [True, False])
def test_forward_logits_match_jax(remat):
    jcfg, jp, tcfg, tp = _setup()
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 45)).astype(np.int32)
    jl, jaux = JH.forward(jcfg, jp, jnp.asarray(tokens), remat=remat)
    dispatch.reset_counts()
    tl, taux = TH.forward(tcfg, tp, torch.from_numpy(tokens), remat=remat)
    assert tl.shape == (2, 45, jcfg.vocab_size) and tl.dtype == torch.float32
    _close_rel(tl, jl, REL)
    assert float(taux) == float(jaux) == 0.0
    n_seg, e, tail = TH._segments(tcfg)
    c = _counts()
    assert (c["ssm_scan"], c["flash_attention"]) == (n_seg * e + tail, n_seg)
    assert c["ssm_scan_backward"] == c["flash_attention_backward"] == 0


def test_forward_refuses_positions_that_are_not_the_rows():
    _, _, tcfg, tp = _setup()
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32)[None] + 3
    with pytest.raises(ValueError, match="0..S-1"):
        TH.forward(tcfg, tp, tokens, pos)
    TH.forward(tcfg, tp, tokens, pos - 3)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_loss_and_gradients_match_jax(accum):
    jcfg, jp, tcfg, tp = _setup()
    batch = next(JaxSyntheticTokens(jcfg, 4, 40, seed=3))
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
    assert _counts() == {n: accum * c for n, c in _want_counts(tcfg).items()}
    for k in ("loss", "nll", "accuracy", "aux_loss", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_REL)
    jflat = _flat(captured["jax"])
    assert set(jflat) == set(captured["torch"])
    for k, g in jflat.items():
        _close_rel(captured["torch"][k], g, GRAD_REL)
    for k, p in _flat(jp2).items():
        g = np.abs(jflat[k])
        live = g > 1e-3 * g.max()
        np.testing.assert_allclose(_np(_flat(tp2)[k])[live], _np(p)[live],
                                   rtol=1e-5, atol=1e-6)
    assert all(not p.requires_grad and p.grad is None for p in _flat(tp2).values())


def test_remat_policies():
    """``full`` recomputes each segment exactly (same loss and gradients as
    ``none``, bit for bit), with K5 and K4 launched again in the recompute;
    ``dots`` is not ported."""
    _, _, tcfg, tp = _setup(seed=1)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 45)).astype(np.int32))
    grads = {}
    for policy in ("full", "none"):
        cfg = tcfg.replace(remat=policy)
        for p in _flat(tp).values():
            p.grad = None
            p.requires_grad_(True)
        dispatch.reset_counts()
        loss = TH.forward(cfg, tp, tokens)[0].square().mean()
        loss.backward()
        assert _counts() == _want_counts(cfg)
        grads[policy] = (loss.item(), {k: p.grad.clone() for k, p in _flat(tp).items()})
    for p in _flat(tp).values():
        p.requires_grad_(False)
        p.grad = None
    assert grads["full"][0] == grads["none"][0]
    for k, g in grads["full"][1].items():
        torch.testing.assert_close(g, grads["none"][1][k], rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="dots"):
        TH.forward(tcfg.replace(remat="dots"), tp, tokens)


def test_trainer_trains_the_hybrid(tmp_path):
    cfg = TR.smoke("zamba2-1.2b")
    data = SyntheticTokens(cfg, batch=4, seq_len=16)
    tc = TrainerConfig(num_steps=12, ckpt_every=100, ckpt_dir=str(tmp_path),
                       async_save=False, device="cpu")
    tr = Trainer(cfg, iter(data), tc, optimizer=TO.adamw(TO.warmup_cosine(3e-3, 3, 12)))
    losses = [h["loss"] for h in tr.train() if "loss" in h]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_launcher_trains_zamba2_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "16", "--warmup", "2", "--ckpt-dir", str(tmp_path)]
    before = {t.ident for t in threading.enumerate()}
    out = train_launcher.run(train_launcher.parse(args))
    s = out["summary"]
    assert s["arch"] == "zamba2-1.2b-smoke" and s["steps"] == 6
    assert s["last_loss"] < s["first_loss"]
    again = ["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu", "--steps", "2",
             "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path / "b")]
    assert train_launcher.main(again) == 0
    assert "zamba2-1.2b-smoke: steps=2" in capsys.readouterr().out
    assert not [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive() and t.name == "prefetch"]
