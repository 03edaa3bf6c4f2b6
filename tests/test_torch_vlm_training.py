"""Training qwen2-vl (the vlm family: the dense transformer under M-RoPE)
on the CPU against the JAX package, at ``qwen2-vl-72b-smoke`` and fp32
compute, on the same weights (handed over through ``repro_torch.interop``)
and the same numpy data.

* One train step (``make_train_step``, AdamW) at remat "none" and "dots"
  and 1 / 2 microbatches (``tests/test_torch_training.py`` runs "full"
  among the dense family's cases), and one whose position streams 1 and 2
  are drawn apart from stream 0, as a vision frontend would give them: the
  loss and metrics (rtol 1e-5), every gradient leaf (within 5e-4 of its
  own largest entry, the dense family's limit) and the updated
  parameters, with the plain calls of K4, its backward and K7 held exactly
  a microbatch.
* The training forward and the train step refuse positions whose stream 0
  is not each row's index (K4 masks by row, the reference by stream 0),
  and leave the parameters as they found them.
* The Trainer trains ``qwen2-vl-72b-smoke`` with a falling loss, and the
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
from repro.models.registry import fns_for as jax_fns
from repro.optim import optimizers as JO
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.launch import train as train_launcher
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as TO
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCH = "qwen2-vl-72b"
GRAD_REL = 5e-4     # each gradient leaf, of its largest (the dense test's)
KERNELS = ("flash_attention", "flash_attention_backward", "matmul")


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


def _setup(remat="full", seed=0):
    jcfg = JR.smoke(ARCH).replace(compute_dtype="float32", remat=remat)
    tcfg = TR.smoke(ARCH).replace(compute_dtype="float32", remat=remat)
    assert tcfg.m_rope and tcfg.family == "vlm"
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _batch(cfg, streams="equal", seed=3):
    """``SyntheticTokens``' batch of 4 x 16; ``streams="different"`` draws
    position streams 1 and 2 apart from stream 0 (the rows 0..S-1)."""
    batch = next(JaxSyntheticTokens(cfg, 4, 16, seed=seed))
    assert batch["positions"].shape == (3, 4, 16)
    if streams == "different":
        rng = np.random.default_rng(seed)
        batch["positions"][1:] = rng.integers(0, 64, (2, 4, 16))
    return batch


def _want_counts(cfg):
    """Plain calls of one microbatch's forward and backward: K4 a layer,
    again in the recompute under "full" and "dots", its backward once; K7
    seven products a block and the LM head, the blocks' again in the
    recompute under "full" ("dots" keeps them), every one twice in the
    backward."""
    L = cfg.num_layers
    fwd = 7 * L + 1
    return {"flash_attention": L * (1 if cfg.remat == "none" else 2),
            "flash_attention_backward": L,
            "matmul": fwd + (7 * L if cfg.remat == "full" else 0) + 2 * fwd}


def _train_step_vs_jax(accum, remat="full", streams="equal"):
    jcfg, jp, tcfg, tp = _setup(remat)
    batch = _batch(jcfg, streams)
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
    assert {n: table[n].plain_calls for n in KERNELS} == {
        n: accum * c for n, c in _want_counts(tcfg).items()}
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


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum, remat):
    _train_step_vs_jax(accum, remat)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_with_streams_apart_matches_jax(accum):
    """Streams 1 and 2 drawn apart from stream 0 (each microbatch its own
    rows of them): the same step as the reference's."""
    _train_step_vs_jax(accum, "full", "different")


def test_training_refuses_a_stream_0_that_is_not_the_rows():
    _, _, tcfg, tp = _setup()
    batch = _batch(tcfg, "different")
    batch["positions"][0] += 1
    tokens, positions = (torch.from_numpy(batch[k]) for k in ("tokens", "positions"))
    with pytest.raises(ValueError, match="stream 0"):
        T.forward(tcfg, tp, tokens, positions, remat=True)
    opt = TO.adamw(TO.constant(1e-3))
    before = {k: v.clone() for k, v in _flat(tp).items()}
    with pytest.raises(ValueError, match="stream 0"):
        make_train_step(tcfg, opt, accum=2)(tp, opt.init(tp), batch)
    for k, v in _flat(tp).items():
        assert not v.requires_grad and v.grad is None
        assert torch.equal(v, before[k])


def test_trainer_trains_qwen2_vl(tmp_path):
    cfg = TR.smoke(ARCH)
    data = SyntheticTokens(cfg, batch=4, seq_len=16)
    tc = TrainerConfig(num_steps=12, ckpt_every=100, ckpt_dir=str(tmp_path),
                       async_save=False, device="cpu")
    tr = Trainer(cfg, iter(data), tc, optimizer=TO.adamw(TO.warmup_cosine(3e-3, 3, 12)))
    assert tr.cfg.family == "vlm"
    losses = [h["loss"] for h in tr.train() if "loss" in h]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_launcher_trains_qwen2_vl_on_the_cpu(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6", "--batch", "4",
            "--seq", "16", "--warmup", "2", "--ckpt-dir", str(tmp_path)]
    before = {t.ident for t in threading.enumerate()}
    out = train_launcher.run(train_launcher.parse(args))
    s = out["summary"]
    assert s["arch"] == "qwen2-vl-72b-smoke" and s["steps"] == 6
    assert s["last_loss"] < s["first_loss"]
    again = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "3",
             "--seq", "8", "--accum", "3", "--ckpt-dir", str(tmp_path / "b")]
    assert train_launcher.main(again) == 0
    assert "qwen2-vl-72b-smoke: steps=2" in capsys.readouterr().out
    assert not [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive() and t.name == "prefetch"]
