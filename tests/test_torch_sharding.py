"""The sharding rules and policy against the reference's, for every arch in
the registry at its full config, on the production meshes (16 x 16 and 2 x
16 x 16) and the test meshes (2 x 4 and 1 x 4): ``rules_for`` and each
leaf's spec, ``param_axes``, the optimizers' ``state_axes``,
``decode_state_axes`` (bf16 and int8), ``batch_axes_for`` and
``sharded_bytes_per_device``.  The reference reads only the axis names and
sizes of a mesh there, so it gets a stand-in (and ``AbstractMesh``
shardings).  Then what a rank holds: ``local_slice`` / ``shard_batch`` and
DTensor's slices under ``placements`` against the shards of the
reference's arrays on 8 XLA host devices."""
import json
import types

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as JR
from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.configs.specs import abstract_params as j_abstract_params
from repro.configs.specs import input_specs as j_input_specs
from repro.distributed import policy as JP
from repro.distributed.sharding import rules_for as j_rules_for
from repro.optim.optimizers import adafactor as j_adafactor
from repro.optim.optimizers import adamw as j_adamw
from repro_torch.configs import registry as R
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.configs.specs import abstract_params, input_specs
from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import policy as P
from repro_torch.distributed.sharding import (MeshShape, ShardingRules, local_slice,
                                              placements, rules_for)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim.optimizers import adafactor, adamw, constant
from torch_mesh_ranks import placements_body, run_jax, run_world

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x4": (("data", "model"), (2, 4)),
          "1x4": (("data", "model"), (1, 4))}
ARCHS = R.ARCH_IDS


def _meshes(key):
    """(the port's MeshShape, the reference's stand-in, an AbstractMesh)."""
    names, shape = MESHES[key]
    stand_in = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    return MeshShape(names, shape), stand_in, AbstractMesh(shape, names)


def flat(tree, path=()):
    """(path, leaf) of a tree of dicts, lists and NamedTuples whose leaves
    are tuples of axis names or arrays."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flat(tree[k], path + (k,))]
    if isinstance(tree, list) or hasattr(tree, "_fields"):
        names = tree._fields if hasattr(tree, "_fields") else range(len(tree))
        return [kv for n, v in zip(names, tree) for kv in flat(v, path + (n,))]
    return [(path, tuple(tree) if isinstance(tree, tuple) else tree)]


def test_production_meshes():
    assert make_production_mesh() == MeshShape(("data", "model"), (16, 16))
    assert make_production_mesh(multi_pod=True) == MeshShape(("pod", "data", "model"),
                                                             (2, 16, 16))


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_rules_and_specs_match_reference(mesh_key):
    """``rules_for`` for every arch and assigned shape, and the spec of
    every parameter leaf under those rules."""
    mesh, stand_in, _ = _meshes(mesh_key)
    for arch in ARCHS:
        cfg, j_cfg = R.config(arch), JR.config(arch)
        axes = flat(P.param_axes(cfg))
        for shape, j_shape in zip(ALL_SHAPES, J_SHAPES):
            rules, j_rules = rules_for(cfg, shape, mesh), j_rules_for(j_cfg, j_shape, stand_in)
            assert dict(rules.rules) == dict(j_rules.rules), (arch, shape.name)
            assert P.cell_policy(cfg, shape, mesh) == rules
            for _, ax in axes:
                assert rules.spec(list(ax)) == tuple(j_rules.spec(list(ax))), (arch, ax)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_axes_match_reference(arch):
    """``param_axes`` leaf for leaf, and AdamW's and Adafactor's
    ``state_axes`` from them."""
    cfg, j_cfg = R.config(arch), JR.config(arch)
    axes, j_axes = P.param_axes(cfg), JP.param_axes(j_cfg)
    assert flat(axes) == flat(j_axes)
    for opt, j_opt in ((adamw(constant(1e-3)), j_adamw(lambda s: 1e-3)),
                       (adafactor(constant(1e-3)), j_adafactor(lambda s: 1e-3))):
        assert flat(opt.state_axes(axes)) == flat(j_opt.state_axes(j_axes))
        assert flat(P.opt_state_axes(cfg, opt)) == flat(j_opt.state_axes(j_axes))


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_axes_match_reference(arch, cache_dtype):
    cfg, j_cfg = R.config(arch), JR.config(arch)
    got, want = P.decode_state_axes(cfg, cache_dtype), JP.decode_state_axes(j_cfg, cache_dtype)
    assert type(got).__name__ == type(want).__name__
    assert flat(got) == flat(want)


def test_batch_axes_for_matches_reference():
    for name in ("tokens", "labels", "positions", "frames", "images", "last_pos", "mask"):
        for ndim in (1, 2, 3, 4):
            assert P.batch_axes_for(name, ndim) == JP.batch_axes_for(name, ndim), (name, ndim)


def _ref_bytes(sds, axes, rules, stand_in, abstract):
    return JP.sharded_bytes_per_device(sds, JP._to_shardings(axes, abstract, rules), stand_in)


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_sharded_bytes_per_device_match_reference(mesh_key):
    """Per-device bytes of the parameters (under the train and the decode
    rules), of AdamW's and Adafactor's state (train) and of the decode
    state at decode_32k (bf16 and int8 caches), every arch: the port's
    ``meta`` tensors against the reference's abstract arrays."""
    mesh, stand_in, abstract = _meshes(mesh_key)
    train, decode = ALL_SHAPES[0], ALL_SHAPES[2]
    for arch in ARCHS:
        cfg, j_cfg = R.config(arch), JR.config(arch)
        params, j_params = abstract_params(cfg), j_abstract_params(j_cfg)
        assert all(t.device.type == "meta" for _, t in flat(params))
        axes, j_axes = P.param_axes(cfg), JP.param_axes(j_cfg)
        for shape, j_shape in ((train, J_SHAPES[0]), (decode, J_SHAPES[2])):
            rules, j_rules = rules_for(cfg, shape, mesh), j_rules_for(j_cfg, j_shape, stand_in)
            assert P.sharded_bytes_per_device(params, axes, rules, mesh) == \
                _ref_bytes(j_params, j_axes, j_rules, stand_in, abstract), (arch, shape.name)
        rules, j_rules = rules_for(cfg, train, mesh), j_rules_for(j_cfg, J_SHAPES[0], stand_in)
        for opt, j_opt in ((adamw(constant(1e-3)), j_adamw(lambda s: 1e-3)),
                           (adafactor(constant(1e-3)), j_adafactor(lambda s: 1e-3))):
            import jax
            got = P.sharded_bytes_per_device(opt.init(params), opt.state_axes(axes), rules,
                                             mesh)
            want = _ref_bytes(jax.eval_shape(j_opt.init, j_params), j_opt.state_axes(j_axes),
                              j_rules, stand_in, abstract)
            assert got == want, (arch, "opt")
        rules, j_rules = rules_for(cfg, decode, mesh), j_rules_for(j_cfg, J_SHAPES[2], stand_in)
        for cd in ("bfloat16", "int8"):
            batch, state = input_specs(cfg, decode, cd)
            j_batch, j_state = j_input_specs(j_cfg, J_SHAPES[2], cd)
            assert P.sharded_bytes_per_device(state, P.decode_state_axes(cfg, cd), rules,
                                              mesh) == \
                _ref_bytes(j_state, JP.decode_state_axes(j_cfg, cd), j_rules, stand_in,
                           abstract), (arch, cd)
            assert {k: tuple(v.shape) for k, v in batch.items()} == \
                {k: tuple(v.shape) for k, v in j_batch.items()}


# ---------------------------------------------------------------------------
# what each rank holds, against the reference's shards on 8 host devices
# ---------------------------------------------------------------------------

# (mesh shape, axis names, spec, global shape): an entry naming two mesh
# axes cuts its dim major to minor
SLICE_CASES = (((2, 4), ("data", "model"), (("data", "model"),), (16, 3)),
               ((2, 4), ("data", "model"), ("model", "data"), (8, 6)),
               ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model"), (8, 4)),
               ((2, 2, 2), ("pod", "data", "model"), (None, ("data", "model")), (3, 8)))
BATCH_RULES = {"batch": ("pod", "data"), "seq": "model"}

_JAX_SHARDS = """
import json, numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.data.pipeline import shard_batch
from repro.distributed.sharding import ShardingRules

def shards(arr, mesh):
    out = {}
    for sh in arr.addressable_shards:
        coord = [int(c[0]) for c in np.nonzero(mesh.devices == sh.device)]
        out[",".join(map(str, coord))] = [[s.start or 0, s.stop if s.stop is not None else n]
                                          for s, n in zip(sh.index, arr.shape)]
    return out

cases = json.loads(CASES)
res = {"cases": [], "batch": {}}
for shape, names, spec, gshape in cases:
    mesh = jax.make_mesh(tuple(shape), tuple(names),
                         axis_types=(jax.sharding.AxisType.Auto,) * len(names))
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    x = jax.device_put(np.zeros(gshape, np.float32), NamedSharding(mesh, P(*spec)))
    res["cases"].append(shards(x, mesh))
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
batch = {"tokens": np.zeros((4, 6), np.int32), "positions": np.zeros((3, 4, 6), np.int32),
         "frames": np.zeros((4, 5, 2), np.float32), "last_pos": np.zeros((4,), np.int32)}
placed = shard_batch(batch, mesh, ShardingRules({"batch": ("pod", "data"), "seq": "model"}))
res["batch"] = {k: shards(v, mesh) for k, v in placed.items()}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shards")
    cases = json.dumps([[list(s), list(n), [list(e) if isinstance(e, tuple) else e
                                            for e in spec], list(g)]
                        for s, n, spec, g in SLICE_CASES])
    return run_jax(f"CASES = {cases!r}\n" + _JAX_SHARDS, tmp), tmp


def _index(bounds):
    return tuple(slice(a, b) for a, b in bounds)


def test_local_slice_and_shard_batch_match_reference_shards(jax_shards):
    """Every device's shard, for every coordinate of each case's mesh, and
    ``shard_batch``'s local slices (M-RoPE's positions split along axis 1)
    on a (2, 2, 2) mesh with the batch on ("pod", "data")."""
    res, _ = jax_shards
    for (shape, names, spec, gshape), want in zip(SLICE_CASES, res["cases"]):
        mesh = MeshShape(names, shape)
        for key, bounds in want.items():
            coord = tuple(int(c) for c in key.split(","))
            assert local_slice(gshape, spec, mesh, coord) == _index(bounds), (spec, coord)
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 9, (4, 6)), "positions": rng.integers(0, 9, (3, 4, 6)),
             "frames": rng.standard_normal((4, 5, 2)), "last_pos": rng.integers(0, 9, (4,))}
    for key in res["batch"]["tokens"]:
        coord = tuple(int(c) for c in key.split(","))
        local = shard_batch(batch, mesh, ShardingRules(BATCH_RULES), coord)
        for name, arr in batch.items():
            assert np.array_equal(local[name], arr[_index(res["batch"][name][key])]), name


def test_placements_shard_major_to_minor(jax_shards):
    """DTensor's local tensor under ``placements(spec)`` on 8 gloo ranks is
    the reference's shard of the same device coordinate (and
    ``local_slice``'s); an entry that names mesh axes against the mesh's
    order is refused."""
    res, tmp = jax_shards
    ranks = run_world(placements_body, 8, tmp, SLICE_CASES)
    for r, got in enumerate(ranks):
        for (shape, names, spec, gshape), want, case in zip(SLICE_CASES, res["cases"], got):
            x = torch.arange(int(np.prod(gshape)), dtype=torch.float32).reshape(gshape)
            key = ",".join(map(str, case["coordinate"]))
            assert torch.equal(case["local"], x[_index(want[key])]), (r, spec)
            assert torch.equal(case["sliced"], case["local"])
    with pytest.raises(ValueError, match="order"):
        placements((("model", "data"),), MeshShape(("data", "model"), (2, 4)))
