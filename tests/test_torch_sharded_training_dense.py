"""The sharded train step of the dense family: qwen2.5-3b-smoke (AdamW,
tied embeddings, 4 query and 2 KV heads) on (2, 4) and (1, 4) meshes by
``rules_for``'s training rules -- heads, ``ff`` and the vocabulary on
``model``, ``seq_sp``, the batch on ``data``; the KV heads, which 4 does not
divide, replicated, each rank reading the one its query head's group uses
-- and on (2, 4) with FSDP (``embed`` on ``data``).  Each on 8 or 4 gloo
ranks against the reference's step jitted with ``in_shardings`` on its own
mesh of XLA host devices, and against the port's step without a mesh
(tolerances: ``tests/torch_sharded_checks.py``)."""
import numpy as np
import pytest

from repro_torch.configs import registry as R
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import MeshShape, rules_for
from torch_mesh_ranks import jax_train, run_world, train_body
from torch_sharded_checks import check_case, expected_collectives, port_step

ARCH, ACCUM, B, S = "qwen2.5-3b", 2, 4, 16
MESHES = [(2, 4, False), (1, 4, False), (2, 4, True)]


def _tag(data, model, fsdp):
    return f"{data}x{model}" + ("_fsdp" if fsdp else "")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's three sharded steps, the port's on gloo ranks, and
    the port's step without a mesh."""
    tmp = tmp_path_factory.mktemp("sharded_dense")
    info = jax_train(tmp, ARCH, MESHES, accum=ACCUM, B=B, S=S, opt="adamw")
    assert info["devices"] == 8
    z = np.load(tmp / "train.npz")
    ranks = {_tag(*m): run_world(train_body, m[0] * m[1], tmp, ARCH, *m, ACCUM, "adamw",
                                 False) for m in MESHES}
    return z, info["info"], ranks, port_step(ARCH, z, accum=ACCUM, opt="adamw")


@pytest.mark.parametrize("mesh", MESHES, ids=[_tag(*m) for m in MESHES])
def test_sharded_step_matches_reference_and_unsharded(runs, mesh):
    """Loss, metrics and grad norm on every rank; gradients, updated
    parameters and AdamW's moments gathered back; each rank's bytes its
    sharded share; the collectives of the step, exactly."""
    z, info, ranks, plain = runs
    data, model, fsdp = mesh
    cfg = R.smoke(ARCH).replace(compute_dtype="float32")
    shape = MeshShape(("data", "model"), (data, model))
    rules = rules_for(cfg, ShapeConfig("t", "train", S, B), shape, fsdp=fsdp)
    assert rules.rules["kv_heads"] is None and rules.rules["seq_sp"] == "model"
    assert (rules.rules["embed"] == "data") == fsdp
    want = expected_collectives(cfg, rules, {"data": data, "model": model}, accum=ACCUM,
                                opt="adamw")
    check_case(z, info, ranks[_tag(*mesh)], plain, _tag(*mesh), opt="adamw",
               collectives=want)
