"""Data parallelism alone, the Trainer under a mesh, and the families
whose layers are not cut on a model axis yet.

* googlenet-smoke on a (2, 1) mesh: the batch on ``data``, every weight
  whole on both gloo ranks, the gradients averaged over the axis; against
  the reference's step jitted with ``in_shardings`` on its own (2, 1)
  mesh and against the port's step without one.  Both sides' convs are
  summed in fp64 and rounded once, as ``tests/test_torch_googlenet_
  training.py`` holds them (at fp32 one ReLU of a batch can sit within the
  two libraries' rounding of zero).
* zamba2-1.2b-smoke (the hybrid) on (2, 1) against the port's step
  without a mesh; on a model axis of 4 its step raises, naming 11b'.
* ``Trainer(..., rules=, mesh=)``: qwen2.5-3b-smoke on a (2, 2) mesh, a
  checkpoint a step, each rank's slices under its coordinate; a second
  Trainer resumes bit for bit; one on a (1, 4) mesh raises, naming 11c;
  the history against a Trainer's without a mesh on the same data.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as R
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.distributed.sharding import MeshShape, rules_for, use_rules
from repro_torch.optim import optimizers as O
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig
from torch_mesh_ranks import (jax_train, run_world, train_body, trainer_body,
                              trainer_init_body)
from torch_sharded_checks import (GRAD_REL, check_case, close_rel, expected_collectives,
                                  flat, port_npz, port_step)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def googlenet_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_cnn")
    info = jax_train(tmp, "googlenet", [(2, 1, False)], accum=2, B=4, S=32, opt="adamw",
                     exact_conv=True)
    z = np.load(tmp / "train.npz")
    ranks = run_world(train_body, 2, tmp, "googlenet", 2, 1, False, 2, "adamw", True)
    return z, info["info"], ranks, port_step("googlenet", z, accum=2, opt="adamw",
                                             exact_conv=True)


def test_googlenet_data_parallel_matches_reference_and_unsharded(googlenet_run):
    """Loss, metrics and grad norm on both ranks; gradients, updated
    parameters and AdamW's moments; each rank holds the whole tree (a
    model axis of 1 and no FSDP: nothing is sliced); the step's
    collectives are the gradients' and metrics' all-reduces alone."""
    z, info, ranks, plain = googlenet_run
    cfg = R.smoke("googlenet").replace(compute_dtype="float32")
    rules = rules_for(cfg, ShapeConfig("t", "train", 1, 4), MeshShape(("data", "model"), (2, 1)))
    want = expected_collectives(cfg, rules, {"data": 2, "model": 1}, accum=2, opt="adamw")
    assert set(want) == {"all_reduce"}
    check_case(z, info, ranks, plain, "2x1", opt="adamw", collectives=want)


def test_hybrid_data_parallel_matches_unsharded(tmp_path):
    """zamba2-1.2b-smoke's step on a (2, 1) mesh: its Mamba-2 and shared
    attention blocks run whole on each rank's batch rows (K5 and K4 with
    their backward kernels' plain versions), and the averaged gradients,
    the loss and the updated parameters are the step's without a mesh."""
    z = port_npz(tmp_path, "zamba2-1.2b", 4, 16)
    ranks = run_world(train_body, 2, tmp_path, "zamba2-1.2b", 2, 1, False, 2, "adamw", False)
    p_plain, s_plain, g_plain, m_plain = port_step("zamba2-1.2b", z, accum=2, opt="adamw")
    cfg = R.smoke("zamba2-1.2b")
    rules = rules_for(cfg, ShapeConfig("t", "train", 16, 4), MeshShape(("data", "model"), (2, 1)))
    want = expected_collectives(cfg, rules, {"data": 2, "model": 1}, accum=2, opt="adamw")
    for r in ranks:
        for k in ("loss", "nll", "accuracy"):
            np.testing.assert_allclose(r["metrics"][k], m_plain[k], rtol=1e-5)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], m_plain["grad_norm"],
                                   rtol=GRAD_REL)
        assert r["collectives"] == want and set(want) == {"all_reduce"}
    g = flat(ranks[0]["grad"])
    assert set(g) == set(g_plain)
    for k in g:
        close_rel(g[k], g_plain[k], what=k)
    for k, p in flat(ranks[0]["param"]).items():
        gk = np.abs(g_plain[k].numpy())
        live = gk > 1e-3 * gk.max()
        np.testing.assert_allclose(p.numpy()[live], p_plain[k].numpy()[live], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m", "whisper-medium"])
def test_families_without_a_model_axis_port_refuse_one(arch):
    """The hybrid, ssm and audio families' layers are not cut on a model
    axis yet: their step on a (1, 4) mesh raises, naming 11b'."""
    cfg = R.smoke(arch)
    rules = rules_for(cfg, ShapeConfig("t", "train", 16, 4), MeshShape(("data", "model"), (1, 4)))
    step = make_train_step(cfg, O.adamw(O.constant(1e-3)))
    with use_rules(rules, MeshShape(("data", "model"), (1, 4))):
        with pytest.raises(NotImplementedError, match="11b'"):
            step({}, {}, {})


def test_trainer_checkpoints_each_ranks_slices(tmp_path):
    """Two steps on a (2, 2) mesh, checkpointed after each: the resumed
    Trainer's slices equal the trained ones bit for bit on every rank; a
    Trainer on a (1, 4) mesh over the same directory refuses, naming 11c;
    the losses, metrics and grad norms of both steps are a Trainer's
    without a mesh on the same data."""
    ckpt = str(tmp_path / "ckpt")
    ranks = run_world(trainer_body, 4, tmp_path, "qwen2.5-3b", 2, 2, 2, ckpt,
                      MeshShape(("data", "model"), (1, 4)))
    cfg = R.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    plain = Trainer(cfg, iter(SyntheticTokens(cfg, 4, 16, seed=3)),
                    TrainerConfig(num_steps=2, ckpt_every=10, ckpt_dir=str(tmp_path / "p"),
                                  async_save=False, device="cpu"))
    hist = plain.train()
    for r in ranks:
        assert r["resumed"] and r["step"] == 2 and r["same"]
        assert "11c" in r["error"]
        assert len(r["history"]) == len(hist) == 2
        for h, want in zip(r["history"], hist):
            for k in ("loss", "nll", "accuracy"):
                np.testing.assert_allclose(h[k], want[k], rtol=1e-5)
            np.testing.assert_allclose(h["grad_norm"], want["grad_norm"], rtol=GRAD_REL)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_trainer_draws_each_ranks_slices(tmp_path, opt):
    """The Trainer's init on a (2, 2) mesh, which cuts each leaf (a stacked
    leaf's each layer) as it is drawn and makes the optimizer's state as
    zeros at the slices' shapes, gives every rank the whole seeded state
    cut by ``shard_tree``, bit for bit: Adafactor's factoring too, which
    the whole leaf's shape decides (the two KV heads are one a rank)."""
    ranks = run_world(trainer_init_body, 4, tmp_path, "qwen2.5-3b", 2, 2, opt)
    for r in ranks:
        assert r["same"] and r["leaves"] > 0
