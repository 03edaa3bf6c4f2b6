"""Training xlstm-125m (the ssm family) on the CPU against the JAX package,
at ``xlstm-125m-smoke`` (4 blocks: three mLSTM, the sLSTM at block 1;
d_model 64, so the scan runs at N = 32, P = 33) and fp32 compute, on the
same weights (handed over through ``repro_torch.interop``) and the same
numpy data.

* One train step (``make_train_step``, AdamW) at 1 and 2 microbatches: the
  loss and metrics (rtol 1e-5), every gradient leaf (within ``GRAD_REL``
  of its own largest entry, as the dense and hybrid tests hold them) and
  the updated parameters, with the plain-call counts of K5, its backward
  and K7 held exactly.
* The Trainer takes ``xlstm-125m``: 12 steps with a falling loss; a crash
  restores the last checkpoint with the list of per-block tables bit for
  bit, and the step after it runs again; the launcher trains it at smoke
  size on the CPU.
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
from repro_torch.distributed.fault import FaultSchedule
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.launch import train as train_launcher
from repro_torch.models.recurrent import training_launches
from repro_torch.optim import optimizers as TO
from repro_torch.optim.optimizers import leaves
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

GRAD_REL = 5e-4     # each gradient leaf, of its largest (the dense test's)
KERNELS = ("ssm_scan", "ssm_scan_backward", "matmul")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_rel(t, j, rel):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= rel * max(np.abs(j).max(), 1e-30)


def _flat(tree, prefix=()):
    """(path, leaf) of the nested dicts and the list of blocks."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _setup(seed=0):
    jcfg = JR.smoke("xlstm-125m").replace(compute_dtype="float32")
    tcfg = TR.smoke("xlstm-125m").replace(compute_dtype="float32")
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _counts():
    table = dispatch.kernel_table()
    return {n: table[n].plain_calls for n in KERNELS}


def _want_counts(cfg, seq):
    """Plain calls of one microbatch's forward and backward, from the
    config (``recurrent.training_launches``)."""
    n = training_launches(cfg, seq)
    return {**n, "matmul": sum(n["matmul"].values())}


def _train_step_vs_jax(accum):
    """One train step of the port and of the reference: loss, metrics,
    every gradient leaf, the updated parameters; K5, its backward and K7's
    plain calls exact."""
    jcfg, jp, tcfg, tp = _setup()
    batch = next(JaxSyntheticTokens(jcfg, 4, 40, seed=3))
    captured = {}

    def grab(key):
        def hook(g):
            captured[key] = _flat(jax.tree_util.tree_map(np.array, g)) if key == "jax" \
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
    assert _counts() == {n: accum * c for n, c in _want_counts(tcfg, 40).items()}
    for k in ("loss", "nll", "accuracy", "aux_loss", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_REL)
    jflat = captured["jax"]
    assert set(jflat) == set(captured["torch"])
    assert any(k[0] == "blocks" and k[2] == "core" and k[3] == "r" for k in jflat)
    for k, g in jflat.items():
        _close_rel(captured["torch"][k], g, GRAD_REL)
    tflat = _flat(tp2)
    for k, p in _flat(jp2).items():
        g = np.abs(jflat[k])
        live = g > 1e-3 * g.max()
        np.testing.assert_allclose(_np(tflat[k])[live], _np(p)[live], rtol=1e-5, atol=1e-6)
    assert all(not p.requires_grad and p.grad is None for p in tflat.values())


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_loss_and_gradients_match_jax(accum):
    _train_step_vs_jax(accum)


def _trainer(tmp, steps, events=None, ckpt_every=4):
    cfg = TR.smoke("xlstm-125m")
    data = SyntheticTokens(cfg, batch=4, seq_len=16)
    tc = TrainerConfig(num_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(tmp),
                       async_save=False, device="cpu")
    return Trainer(cfg, iter(data), tc, optimizer=TO.adamw(TO.warmup_cosine(3e-3, 3, steps)),
                   fault_schedule=FaultSchedule(events=events or {}))


def test_trainer_trains_xlstm(tmp_path):
    tr = _trainer(tmp_path, 12, ckpt_every=100)
    losses = [h["loss"] for h in tr.train() if "loss" in h]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_trainer_crash_restores_the_blocks_bit_for_bit(tmp_path):
    """A crash at step 9 restores step 8's checkpoint: the list of
    per-block tables (mLSTM and sLSTM tables side by side) and the optimizer
    state equal, bit for bit, what was saved; step 8 runs again."""
    tr = _trainer(tmp_path, 10, events={9: "crash"})
    saved, restored = {}, []
    save, recover = tr.save, tr._recover

    def snapshot():
        return {k: v.clone() for k, v in _flat({"params": tr.params,
                                                 "opt": tr.opt_state}).items()}

    def save_and_keep():
        saved[tr.step] = snapshot()
        save()

    def recover_and_keep(fault):
        recover(fault)
        restored.append((tr.step, snapshot(), tr.params["blocks"]))
    tr.save, tr._recover = save_and_keep, recover_and_keep
    hist = tr.train()
    events = [h for h in hist if "event" in h]
    assert len(events) == 1 and events[0]["event"] == "crash"
    assert [h["step"] for h in hist if "loss" in h].count(8) == 2
    assert tr.step == 10 and all(np.isfinite(h["loss"]) for h in hist if "loss" in h)
    (step, state, blocks), = restored
    assert step == 8 and set(state) == set(saved[8])
    for k, v in saved[8].items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    cfg = TR.smoke("xlstm-125m")
    assert isinstance(blocks, list) and len(blocks) == cfg.num_layers
    assert [("r" in b["core"]) for b in blocks] == [i % 4 == 1 for i in range(cfg.num_layers)]
    assert all(not p.requires_grad for p in leaves(tr.params))


def test_launcher_trains_xlstm_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "xlstm-125m", "--smoke", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "16", "--warmup", "2", "--ckpt-dir", str(tmp_path)]
    before = {t.ident for t in threading.enumerate()}
    out = train_launcher.run(train_launcher.parse(args))
    s = out["summary"]
    assert s["arch"] == "xlstm-125m-smoke" and s["steps"] == 6
    assert s["last_loss"] < s["first_loss"]
    again = ["--arch", "xlstm-125m", "--smoke", "--device", "cpu", "--steps", "2",
             "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path / "b")]
    assert train_launcher.main(again) == 0
    assert "xlstm-125m-smoke: steps=2" in capsys.readouterr().out
    assert not [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive() and t.name == "prefetch"]
