"""The sharded train step of the moe family: deepseek-moe-16b-smoke
(AdamW; one dense block, then MoE blocks of 8 routed top-2 experts and 2
shared) on (2, 4) and (1, 4) meshes by ``rules_for``'s training rules, on 8
and 4 gloo ranks, against the reference's step jitted with
``in_shardings`` on its own mesh of XLA host devices (where ``moe_apply``
takes ``moe_ep``) and against the port's step without a mesh
(``moe_einsum``; the smoke config's capacity factor of 4.0 drops no
choice on either side).  The experts run expert-parallel on the rank's
rows of the sequence-sharded stream, ``moe_ep``'s three all-to-alls
differentiated by their reverse; the router reads the rank's rows, its
load-balance sums taken over every rank's (tolerances:
``tests/torch_sharded_checks.py``)."""
import numpy as np
import pytest

from repro_torch.configs import registry as R
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import MeshShape, rules_for
from torch_mesh_ranks import jax_train, run_world, train_body
from torch_sharded_checks import check_case, expected_collectives, port_step

ARCH, ACCUM, B, S = "deepseek-moe-16b", 2, 4, 16
MESHES = [(2, 4, False), (1, 4, False)]


def _tag(data, model, fsdp):
    return f"{data}x{model}" + ("_fsdp" if fsdp else "")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_moe")
    info = jax_train(tmp, ARCH, MESHES, accum=ACCUM, B=B, S=S, opt="adamw")
    z = np.load(tmp / "train.npz")
    ranks = {_tag(*m): run_world(train_body, m[0] * m[1], tmp, ARCH, *m, ACCUM, "adamw",
                                 False) for m in MESHES}
    return z, info["info"], ranks, port_step(ARCH, z, accum=ACCUM, opt="adamw")


@pytest.mark.parametrize("mesh", MESHES, ids=[_tag(*m) for m in MESHES])
def test_sharded_step_matches_reference_and_unsharded(runs, mesh):
    """Loss, metrics (the aux loss the whole batch's on every rank) and
    grad norm; gradients, updated parameters and AdamW's moments gathered
    back; each rank's bytes its sharded share (the experts cut on
    ``model``); the collectives, exactly (a microbatch's MoE block: 3
    all-to-alls forward, 3 in the recompute, 2 backward)."""
    z, info, ranks, plain = runs
    data, model, fsdp = mesh
    cfg = R.smoke(ARCH).replace(compute_dtype="float32")
    rules = rules_for(cfg, ShapeConfig("t", "train", S, B),
                      MeshShape(("data", "model"), (data, model)), fsdp=fsdp)
    assert rules.rules["experts"] == "model" and rules.rules["kv_heads"] == "model"
    want = expected_collectives(cfg, rules, {"data": data, "model": model}, accum=ACCUM,
                                opt="adamw")
    assert want["all_to_all"] == ACCUM * 2 * 8
    check_case(z, info, ranks[_tag(*mesh)], plain, _tag(*mesh), opt="adamw",
               collectives=want)
