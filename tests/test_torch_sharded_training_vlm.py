"""The sharded train step of the vlm family: qwen2-vl-72b-smoke (Adafactor,
M-RoPE with three position streams, stream 1 and 2 apart from the rows) on
(2, 4) and (1, 4) meshes by ``rules_for``'s training rules, on 8 and 4
gloo ranks, against the reference's step jitted with ``in_shardings`` on
its own mesh of XLA host devices and against the port's step without a
mesh.  The positions come in whole ((3, B, S), the batch cut on ``data``);
Adafactor's factored means and update RMS are summed over the axes that
slice the dims they average (tolerances: ``tests/torch_sharded_checks.py``)."""
import numpy as np
import pytest

from repro_torch.configs import registry as R
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import MeshShape, rules_for
from torch_mesh_ranks import jax_train, run_world, train_body
from torch_sharded_checks import check_case, expected_collectives, port_step

ARCH, ACCUM, B, S = "qwen2-vl-72b", 2, 4, 16
MESHES = [(2, 4, False), (1, 4, False)]


def _tag(data, model, fsdp):
    return f"{data}x{model}" + ("_fsdp" if fsdp else "")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_vlm")
    info = jax_train(tmp, ARCH, MESHES, accum=ACCUM, B=B, S=S, opt="adafactor")
    z = np.load(tmp / "train.npz")
    assert z["batch/positions"].shape == (3, B, S)
    ranks = {_tag(*m): run_world(train_body, m[0] * m[1], tmp, ARCH, *m, ACCUM, "adafactor",
                                 False) for m in MESHES}
    return z, info["info"], ranks, port_step(ARCH, z, accum=ACCUM, opt="adafactor")


@pytest.mark.parametrize("mesh", MESHES, ids=[_tag(*m) for m in MESHES])
def test_sharded_step_matches_reference_and_unsharded(runs, mesh):
    """Loss, metrics and grad norm on every rank; gradients, the direction
    of every leaf's update and Adafactor's factored moments gathered back;
    each rank's bytes its sharded share; the collectives, exactly."""
    z, info, ranks, plain = runs
    data, model, fsdp = mesh
    cfg = R.smoke(ARCH).replace(compute_dtype="float32")
    rules = rules_for(cfg, ShapeConfig("t", "train", S, B),
                      MeshShape(("data", "model"), (data, model)), fsdp=fsdp)
    want = expected_collectives(cfg, rules, {"data": data, "model": model}, accum=ACCUM,
                                opt="adafactor")
    check_case(z, info, ranks[_tag(*mesh)], plain, _tag(*mesh), opt="adafactor",
               collectives=want)
