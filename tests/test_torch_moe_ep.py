"""Expert parallelism: the port's ``moe_ep`` on 8 gloo ranks, a (2, 4) mesh,
against the reference's ``moe_ep`` on its own (2, 4) mesh of 8 XLA host
devices, at the reference test's config (8 experts, top-2, d_ff 32) with
no drops (capacity factor 8.0) and with drops (1.0), forward and
backward; its capacity positions against the reference's; ``moe_apply``'s
strategy choice."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.moe import _positions_within as j_positions_within
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.sharding import MeshShape, ShardingRules, use_rules
from repro_torch.models.layers import moe as M
from torch_mesh_ranks import moe_body, moe_grad_body, run_jax, run_world

FACTORS = (8.0, 1.0)

_JAX_MOE = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.models.layers import moe as M
from repro.distributed.sharding import ShardingRules, use_rules
rng = np.random.default_rng(0)
params = {"router": rng.standard_normal((16, 8)) * 0.1,
          "w_gate": rng.standard_normal((8, 16, 32)) * 0.1,
          "w_up": rng.standard_normal((8, 16, 32)) * 0.1,
          "w_down": rng.standard_normal((8, 32, 16)) * 0.1}
params = {k: v.astype(np.float32) for k, v in params.items()}
x = rng.standard_normal((2, 12, 16)).astype(np.float32)
jp = {k: jnp.asarray(v) for k, v in params.items()}
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rules = ShardingRules({"batch": ("data",), "seq_model": "model", "experts": "model",
                       "embed_act": None, "seq": None})
out = dict(params, x=x)
for cf in (8.0, 1.0):
    cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, capacity_factor=cf)
    idx, prob, _ = M.route(cfg, jp, jnp.asarray(x))
    out["idx"], out["prob"] = np.asarray(idx), np.asarray(prob)
    out[f"dense_{cf}"] = np.asarray(M.moe_dense(cfg, jp, jnp.asarray(x), idx, prob))
    with mesh, use_rules(rules, mesh):
        y = jax.jit(lambda *a: M.moe_apply(cfg, *a))(jp, jnp.asarray(x), idx, prob)
    out[f"ep_{cf}"] = np.asarray(y)
np.savez(OUT + "/moe.npz", **out)
print(json.dumps({"devices": jax.device_count()}))
"""


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    """The reference's ``moe_apply`` (``moe_ep``) on its (2, 4) mesh, then
    the port's on 8 gloo ranks on the same inputs and routes."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    assert run_jax(_JAX_MOE, tmp)["devices"] == 8
    return dict(np.load(tmp / "moe.npz")), run_world(moe_body, 8, tmp, FACTORS)


@pytest.mark.parametrize("cf", FACTORS)
def test_moe_ep_matches_reference_mesh(moe_run, cf):
    """Each rank's output for its batch row within 1e-5 of the reference's
    ``moe_ep``: at capacity factor 8.0 nothing drops, and both equal
    ``moe_dense``; at 1.0 choices drop (the output parts from the dense
    oracle's), the same ones on both sides.  A call makes three
    all-to-alls (the rows and their local expert ids out, the rows back)
    and one all-gather on the model axis."""
    ref, ranks = moe_run
    apart = np.abs(ref[f"ep_{cf}"] - ref[f"dense_{cf}"]).max()
    assert (apart < 1e-5) if cf == 8.0 else (apart > 1e-2)
    for rank, got in enumerate(ranks):
        d = rank // 4
        y = got[cf]["y"]
        assert y.shape == (1, 12, 16) and torch.isfinite(y).all()
        np.testing.assert_allclose(y.numpy(), ref[f"ep_{cf}"][d:d + 1], atol=1e-5, rtol=0)
        assert got[cf]["collectives"] == {"all_to_all": 3, "all_gather": 1}


def test_positions_within_matches_reference():
    """Arrival rank among equal destinations, and the counts, against the
    reference's, on destinations with empty and crowded bins."""
    rng = np.random.default_rng(4)
    for n, num in ((1, 1), (24, 4), (97, 8), (200, 3)):
        dest = rng.integers(0, num, n).astype(np.int32)
        dest[: n // 3] = num - 1
        pos, counts = M._positions_within(torch.from_numpy(dest).long(), num)
        j_pos, j_counts = j_positions_within(jnp.asarray(dest), num)
        assert pos.tolist() == np.asarray(j_pos).tolist()
        assert counts.tolist() == np.asarray(j_counts).tolist()


@pytest.mark.parametrize("mesh_shape, S, E, strategy", [
    ((2, 4), 12, 8, "ep"),        # the reference test's shapes
    ((2, 4), 1, 8, "einsum"),     # a decode step: S < the axis
    ((2, 4), 10, 8, "einsum"),    # S not divisible by the axis
    ((2, 4), 12, 6, "einsum"),    # E not divisible by the axis
    ((4, 1), 12, 8, "einsum"),    # one rank on the experts axis (one card)
    (None, 12, 8, "einsum"),      # no mesh
])
def test_moe_apply_strategy(monkeypatch, mesh_shape, S, E, strategy):
    """``moe_ep`` only where the ``experts`` axis has more than one rank and
    divides S and E (the reference's rule), ``moe_einsum`` otherwise."""
    called = []
    monkeypatch.setattr(M, "moe_ep", lambda *a, **kw: called.append("ep"))
    monkeypatch.setattr(M, "moe_einsum", lambda *a, **kw: called.append("einsum"))
    cfg = MoEConfig(num_experts=E, top_k=2, d_ff_expert=8)
    x = torch.zeros((2, S, 4))
    rules = ShardingRules({"batch": ("data",), "experts": "model"})
    if mesh_shape is None:
        M.moe_apply(cfg, {}, x, None, None)
    else:
        with use_rules(rules, MeshShape(("data", "model"), mesh_shape)):
            M.moe_apply(cfg, {}, x, None, None)
    assert called == [strategy]


def test_moe_ep_is_forward_only():
    """No process group: refused, with or without an input that requires
    grad.  ``moe_ep`` has a backward now (``test_moe_ep_gradients_match_
    reference_mesh``): an input that requires grad is no longer refused for
    that, and reaches the same process-group check."""
    cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=8)
    mesh = MeshShape(("data", "model"), (1, 4))
    x = torch.zeros((1, 8, 4))
    params = {n: torch.zeros((8, 4, 8)) for n in ("w_gate", "w_up")}
    params["w_down"] = torch.zeros((8, 8, 4))
    with pytest.raises(RuntimeError, match="process group"):
        M.moe_ep(cfg, params, x, None, None, mesh=mesh, model_axis="model")
    with pytest.raises(RuntimeError, match="process group"):
        M.moe_ep(cfg, params, x.requires_grad_(), None, None, mesh=mesh,
                 model_axis="model")


_JAX_MOE_GRAD = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.configs.base import MoEConfig
from repro.models.layers import moe as M
from repro.distributed.sharding import ShardingRules, use_rules
rng = np.random.default_rng(0)
params = {"router": rng.standard_normal((16, 8)) * 0.1,
          "w_gate": rng.standard_normal((8, 16, 32)) * 0.1,
          "w_up": rng.standard_normal((8, 16, 32)) * 0.1,
          "w_down": rng.standard_normal((8, 32, 16)) * 0.1}
params = {k: v.astype(np.float32) for k, v in params.items()}
x = rng.standard_normal((2, 12, 16)).astype(np.float32)
cot = rng.standard_normal((2, 12, 16)).astype(np.float32)
jp = {k: jnp.asarray(v) for k, v in params.items()}
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rules = ShardingRules({"batch": ("data",), "seq_model": "model", "experts": "model",
                       "embed_act": None, "seq": None})
out = dict(params, x=x, cot=cot)
for cf in (8.0, 1.0):
    cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, capacity_factor=cf)
    idx, prob, _ = M.route(cfg, jp, jnp.asarray(x))
    out[f"idx_{cf}"], out[f"prob_{cf}"] = np.asarray(idx), np.asarray(prob)

    def loss(w, xx, pp):
        return jnp.sum(M.moe_apply(cfg, dict(jp, **w), xx, idx, pp) * cot)
    w = {n: jp[n] for n in ("w_gate", "w_up", "w_down")}
    with mesh, use_rules(rules, mesh):
        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(w, jnp.asarray(x), prob)
    for n, v in g[0].items():
        out[f"g_{n}_{cf}"] = np.asarray(v)
    out[f"g_x_{cf}"], out[f"g_prob_{cf}"] = np.asarray(g[1]), np.asarray(g[2])
np.savez(OUT + "/moe.npz", **out)
print(json.dumps({"devices": jax.device_count()}))
"""


@pytest.fixture(scope="module")
def moe_grad_run(tmp_path_factory):
    """``jax.grad`` of the reference's ``moe_apply`` (``moe_ep``) on its
    (2, 4) mesh, then the port's backward on 8 gloo ranks."""
    tmp = tmp_path_factory.mktemp("moe_ep_grad")
    assert run_jax(_JAX_MOE_GRAD, tmp)["devices"] == 8
    return dict(np.load(tmp / "moe.npz")), run_world(moe_grad_body, 8, tmp, FACTORS)


@pytest.mark.parametrize("cf", FACTORS)
def test_moe_ep_gradients_match_reference_mesh(moe_grad_run, cf):
    """``moe_ep``'s backward against ``jax.grad`` of the reference's
    ``moe_ep`` under its mesh, at capacity factor 8.0 (nothing drops) and
    1.0 (choices drop): each rank's gradients are its share -- of x, the
    rows of its sequence slice; of prob, its kept choices; of the expert
    weights, its E / M experts on its batch row -- and summed over the
    ranks they are the reference's, within 1e-5 of the largest entry.  The
    backward reverses the three all-to-alls' two that carry rows (the
    expert ids carry none) and takes the all-gather's slice (its
    consumer is replicated): a call then makes 5 all-to-alls and 1
    all-gather."""
    ref, ranks = moe_grad_run
    for name in ("w_gate", "w_up", "w_down"):
        got = sum(r[cf][name] for r in ranks).numpy()
        want = ref[f"g_{name}_{cf}"]
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    for name in ("x", "prob"):
        want = ref[f"g_{name}_{cf}"]
        for d in range(2):
            got = sum(r[cf][name] for r in ranks[4 * d:4 * d + 4]).numpy()
            np.testing.assert_allclose(got, want[d:d + 1], atol=1e-5 * np.abs(want).max(),
                                       rtol=0)
    for r in ranks:
        assert r[cf]["collectives"] == {"all_to_all": 5, "all_gather": 1}
