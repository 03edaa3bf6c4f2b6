"""Gloo worlds for the port's mesh tests, and the bodies their ranks run.

A test spawns ``world`` CPU processes (``spawn`` start method), each of
which joins a gloo process group through a file in the test's temporary
directory (no TCP port, so parallel test workers cannot clash), runs one
of the rank bodies below on its local tensors with one thread, and saves
what it returns there.  A world that is not done within its time limit is
killed and fails the test, and so is one whose rank raised.  The ranks
import torch, numpy and the port only: the JAX side of each comparison runs
elsewhere (``run_jax``: a subprocess with 8 host devices) and hands its
arrays over as ``.npz`` files.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def run_world(body, world: int, tmp_path, *args, timeout: float = 240.0) -> list:
    """Run ``body(rank, world, tmp_dir, *args)`` on ``world`` gloo ranks;
    returns each rank's result, in rank order."""
    tmp = Path(tmp_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(body, r, world, str(tmp), args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    late = False
    try:
        # until every rank is done, one has failed (the others would wait
        # in a collective for it), or the time is up
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                late = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
    errors = [(tmp / f"rank{r}.err").read_text() for r in range(world)
              if (tmp / f"rank{r}.err").exists()]
    if errors:
        raise AssertionError("a rank raised:\n" + errors[0])
    if late:
        raise AssertionError(f"the {world} ranks were not done after {timeout}s: killed")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"ranks exited with {codes}")
    import torch
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


def _rank_main(body, rank: int, world: int, tmp: str, args) -> None:
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank,
                                world_size=world)
        try:
            out = body(rank, world, tmp, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, f"{tmp}/rank{rank}.pt")
    except BaseException:    # noqa: BLE001 -- the parent reads the traceback
        Path(f"{tmp}/rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def run_jax(code: str, out_dir, n: int = 8, timeout: float = 300.0) -> dict:
    """Run ``code`` in a subprocess with ``n`` XLA host devices (``OUT``
    names ``out_dir`` there); returns the JSON of its last line."""
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    prog = f"OUT = {str(out_dir)!r}\n" + textwrap.dedent(code)
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                          env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def _mesh(data: int, model: int):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(data, model)


def decode_body(rank, world, tmp):
    """The mesh branch of ``seq_sharded_decode_attention`` on a (2, 4) mesh
    with ``batch`` on data and ``kv_seq`` on model, at fp32, bf16 (q and
    caches) and int8 (fp32 q, int8 caches with their scales): this rank's
    batch slice and its slots of each cache, from ``inputs.npz``."""
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import ShardingRules, use_rules
    mesh = _mesh(2, 4)
    d, m = mesh.get_coordinate()
    z = np.load(f"{tmp}/inputs.npz")
    B, S = z["ck"].shape[:2]
    b = slice(d * B // 2, (d + 1) * B // 2)
    s = slice(m * S // 4, (m + 1) * S // 4)
    rules = ShardingRules({"batch": ("data",), "kv_seq": "model"})
    out = {}
    for case, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                     ("int8", torch.float32)):
        def t(name, sl=(b,), dtype=dt):
            return torch.from_numpy(np.ascontiguousarray(z[name][sl])).to(dtype)
        q, nk, nv = t("q"), t("nk"), t("nv")
        lengths = torch.from_numpy(z["lengths"][b])
        C.reset_collective_counts()
        with use_rules(rules, mesh):
            if case == "int8":
                res = C.seq_sharded_decode_attention(
                    q, t("ck_q", (b, s), torch.int8), t("cv_q", (b, s), torch.int8), nk, nv,
                    lengths, k_scale=t("ks", (b, s), torch.float32),
                    v_scale=t("vs", (b, s), torch.float32), chunk=4)
            else:
                res = C.seq_sharded_decode_attention(q, t("ck", (b, s)), t("cv", (b, s)), nk,
                                                     nv, lengths, chunk=4)
        out[case] = [r.float() if r.is_floating_point() else r for r in res]
        out[case + "_gathers"] = C.collective_counts()
    return out


def engine_body(rank, world, tmp, arch, prompts, new_tokens, max_len):
    """qwen2.5-3b-smoke served by the contiguous engine under ``rules_for``'s
    decode rules on a (1, 4) mesh (``kv_seq`` on model): random weights from
    seed 0, greedy; returns each request's tokens, this rank's cache shape
    and the collectives issued."""
    import torch
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import rules_for, use_rules
    from repro_torch.models.registry import fns_for
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import greedy
    mesh = _mesh(1, 4)
    cfg = R.smoke(arch)
    rules = rules_for(cfg, ShapeConfig("serve", "decode", max_len, 1), mesh)
    params = fns_for(cfg).init(cfg, torch.Generator().manual_seed(0))
    with use_rules(rules, mesh):
        eng = ServingEngine(cfg, params, paged=False, max_len=max_len, batch_slots=2,
                            device="cpu")
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=new_tokens,
                    sampler=greedy()) for i, p in enumerate(prompts)]
    C.reset_collective_counts()
    stats = eng.serve(reqs)
    return {"tokens": [list(r.output) for r in reqs], "cache": tuple(eng._state.k.shape),
            "collectives": C.collective_counts(), "decode_steps": stats.decode_steps,
            "rules": dict(rules.rules)}


def moe_body(rank, world, tmp, factors):
    """``moe_apply`` on a (2, 4) mesh (``batch`` on data, ``experts`` on
    model) for each capacity factor in ``factors``: this rank's batch slice
    of the inputs in ``moe.npz``; returns the outputs and the collectives."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import ShardingRules, use_rules
    from repro_torch.models.layers import moe as M
    mesh = _mesh(2, 4)
    d, _ = mesh.get_coordinate()
    z = np.load(f"{tmp}/moe.npz")
    B = z["x"].shape[0]
    b = slice(d * B // 2, (d + 1) * B // 2)
    params = {n: torch.from_numpy(z[n]) for n in ("router", "w_gate", "w_up", "w_down")}
    rules = ShardingRules({"batch": ("data",), "seq_model": "model", "experts": "model",
                           "embed_act": None, "seq": None})
    out = {}
    with torch.no_grad(), use_rules(rules, mesh):
        for cf in factors:
            cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, capacity_factor=cf)
            C.reset_collective_counts()
            y = M.moe_apply(cfg, params, torch.from_numpy(z["x"][b]),
                            torch.from_numpy(z["idx"][b]).long(),
                            torch.from_numpy(z["prob"][b]))
            out[cf] = {"y": y, "collectives": C.collective_counts()}
    return out


def placements_body(rank, world, tmp, cases):
    """Each (mesh shape, axis names, spec) of ``cases``: ``arange`` of the
    case's global shape distributed by ``placements(spec, mesh)``; returns
    this rank's coordinate, its local tensor and ``local_slice``'s slice
    of the same tensor."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import local_slice, placements
    out = []
    for shape, names, spec, gshape in cases:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        x = torch.arange(int(np.prod(gshape)), dtype=torch.float32).reshape(gshape)
        local = distribute_tensor(x, mesh, placements(spec, mesh)).to_local()
        out.append({"coordinate": tuple(mesh.get_coordinate()), "local": local,
                    "sliced": x[local_slice(gshape, spec, mesh)]})
    return out


# ---------------------------------------------------------------------------
# sharded training: the reference's step on its mesh, the port's on gloo ranks
# ---------------------------------------------------------------------------

# Written into the JAX subprocess with ``ARCH``, ``MESHES`` ((data, model,
# fsdp) each), ``ACCUM``, ``B``, ``S``, ``OPT`` and ``EXACT_CONV`` set in
# front: the reference's params from PRNGKey(0) and a numpy batch, then for
# each mesh its ``make_train_step`` jitted with ``in_shardings`` (params,
# optimizer state, batch) under ``use_rules(rules, mesh)``, as
# ``launch/dryrun.py`` builds it, the gradients fetched by callback.
JAX_TRAIN = """
import contextlib, json, re
from unittest import mock
import numpy as np, jax, jax.numpy as jnp
from repro.configs import registry as R
from repro.configs.base import ShapeConfig
from repro.distributed import policy
from repro.distributed.sharding import rules_for, use_rules
from repro.models.registry import fns_for
from repro.optim import optimizers as O
from repro.training.train_step import make_train_step

def name(path):
    return re.sub(r"[^A-Za-z0-9_.]+", "_", jax.tree_util.keystr(path)).strip("_")

def put(out, prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + name(path)] = np.asarray(leaf)

def exact_conv(params, x, *, stride=1, padding="SAME"):
    out = jax.lax.conv_general_dilated(
        x.astype(jnp.float64), params["w"].astype(jnp.float64), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return (out + params["b"].astype(jnp.float64)).astype(x.dtype)

cfg = R.smoke(ARCH).replace(compute_dtype="float32")
params = fns_for(cfg).init(cfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(7)
if cfg.family == "cnn":
    batch = {"images": rng.standard_normal((B, S, S, 3)).astype(np.float32),
             "labels": rng.integers(0, cfg.vocab_size, B).astype(np.int32)}
else:
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.m_rope:      # stream 0 the rows, streams 1 and 2 apart
        pos = np.stack([np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)),
                        rng.integers(0, S, (B, S)), rng.integers(0, S, (B, S))])
        batch["positions"] = pos.astype(np.int32)
out = {}
put(out, "init/", params)
for k, v in batch.items():
    out["batch/" + k] = v
info = {}
for data, model, fsdp in MESHES:
    tag = f"{data}x{model}" + ("_fsdp" if fsdp else "")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                             ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    shape = ShapeConfig("t", "train", 1 if cfg.family == "cnn" else S, B)
    rules = rules_for(cfg, shape, mesh, fsdp=fsdp)
    opt = (O.adafactor if OPT == "adafactor" else O.adamw)(O.constant(1e-3))
    got = {}

    def grab(g):
        jax.debug.callback(lambda h: got.update(g=jax.tree_util.tree_map(np.array, h)), g)
        return g
    step = make_train_step(cfg, opt, accum=ACCUM, grad_transform=grab)
    specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
    with contextlib.ExitStack() as stack:
        if EXACT_CONV:
            from repro.models.layers import conv as JC
            stack.enter_context(jax.enable_x64(True))
            stack.enter_context(mock.patch.object(JC, "conv2d", exact_conv))
        with mesh, use_rules(rules, mesh):
            fn = jax.jit(step, in_shardings=(policy.param_shardings(cfg, mesh, rules),
                                             policy.opt_state_shardings(cfg, opt, mesh, rules),
                                             policy.batch_shardings(specs, mesh, rules)))
            p2, o2, m = fn(params, opt.init(params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
            jax.effects_barrier()
    put(out, tag + "/param/", p2)
    put(out, tag + "/opt/", {k: v for k, v in o2.items() if k != "step"})
    put(out, tag + "/grad/", got["g"])
    info[tag] = {"metrics": {k: float(v) for k, v in m.items()},
                 "rules": {k: v for k, v in rules.rules.items()}}
np.savez(OUT + "/train.npz", **out)
print(json.dumps({"devices": jax.device_count(), "info": info}))
"""


def jax_train(tmp, arch, meshes, *, accum, B, S, opt, exact_conv=False) -> dict:
    """The reference's sharded steps (``JAX_TRAIN``) on 8 XLA host devices;
    returns the JSON it prints and leaves ``train.npz`` in ``tmp``."""
    head = (f"ARCH = {arch!r}\nMESHES = {list(meshes)!r}\nACCUM = {accum}\nB = {B}\n"
            f"S = {S}\nOPT = {opt!r}\nEXACT_CONV = {exact_conv}\n")
    return run_jax(head + JAX_TRAIN, tmp, timeout=600)


def _tree_from(z, prefix, like):
    """A torch tree shaped as ``like`` from the arrays ``z[prefix + name]``
    (the leaves' names as the reference's checkpoints spell them)."""
    import torch
    from repro_torch.checkpoint.checkpoint import _leaf_name, _leaves_with_path, _rebuild
    vals = [torch.from_numpy(np.array(z[prefix + _leaf_name(path)]))
            for path, _ in _leaves_with_path(like)]
    return _rebuild(like, iter(vals))


def train_body(rank, world, tmp, arch, data, model, fsdp, accum, opt, exact_conv):
    """One step of the port's sharded train step on a (data, model) mesh,
    from the reference's initial params and batch in ``train.npz``: every
    rank's metrics, collectives and bytes held; rank 0 also returns the
    gradients, parameters and optimizer state gathered back whole."""
    import contextlib
    from unittest import mock
    import torch
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import gather_tree, rules_for, shard_tree, use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.conv2d.ref import conv2d_backward_ref, conv2d_ref
    from repro_torch.models.layers.module import tree_map
    from repro_torch.models.registry import fns_for
    from repro_torch.optim import optimizers as O
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_train_step
    mesh = _mesh(data, model)
    cfg = R.smoke(arch).replace(compute_dtype="float32")
    z = np.load(f"{tmp}/train.npz")
    batch = {k[len("batch/"):]: z[k] for k in z.files if k.startswith("batch/")}
    B = len(batch["labels"])
    S = 1 if cfg.family == "cnn" else batch["tokens"].shape[1]
    rules = rules_for(cfg, ShapeConfig("t", "train", S, B), mesh, fsdp=fsdp)
    fns = fns_for(cfg)
    params = _tree_from(z, "init/", fns.init(cfg, torch.Generator().manual_seed(1)))
    axes = tree_map(lambda d: d.axes, fns.table(cfg))
    optimizer = (O.adafactor if opt == "adafactor" else O.adamw)(O.constant(1e-3))
    state_axes = optimizer.state_axes(axes)
    whole_state = optimizer.init(params)
    # the bytes a rank should hold: the policy's analytic share of the
    # whole trees, and the whole trees' bytes
    share = (policy.sharded_bytes_per_device(params, axes, rules, mesh)
             + policy.sharded_bytes_per_device(whole_state, state_axes, rules, mesh))
    whole = sum(t.numel() * t.element_size() for t in leaves(params) + leaves(whole_state))
    sp = shard_tree(params, axes, rules, mesh)
    st = shard_tree(whole_state, state_axes, rules, mesh)
    del params, whole_state
    got = {}

    def grab(g):
        got["g"] = tree_map(lambda t: t.clone(), g)
        return g
    step = make_train_step(cfg, optimizer, accum=accum, grad_transform=grab)
    table = dispatch.kernel_table()
    with contextlib.ExitStack() as stack:
        if exact_conv:   # every conv summed in fp64 and rounded once, as the reference's
            stack.enter_context(mock.patch.object(
                table["conv2d"], "plain", lambda x, w, b, *, stride=1: conv2d_ref(
                    x.double(), w.double(), b.double(), stride=stride).to(x.dtype)))

            def exact_bwd(x, w, b, dy, *, stride=1, need_dx=True):
                dx, dw, db = conv2d_backward_ref(x.double(), w.double(), b.double(),
                                                 dy.double(), stride=stride, need_dx=need_dx)
                return None if dx is None else dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype)
            stack.enter_context(mock.patch.object(table["conv2d_backward"], "plain", exact_bwd))
        C.reset_collective_counts()
        with use_rules(rules, mesh):
            sp, st, metrics = step(sp, st, batch)
        counts = C.collective_counts()
    held = sum(t.untyped_storage().nbytes() for t in leaves(sp) + leaves(st))
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "collectives": counts,
           "held": held, "share": share, "whole": whole, "rules": dict(rules.rules)}
    full = {"param": gather_tree(sp, axes, rules, mesh),
            "opt": gather_tree({k: v for k, v in st.items() if k != "step"},
                               {k: v for k, v in state_axes.items() if k != "step"},
                               rules, mesh),
            "grad": gather_tree(got["g"], axes, rules, mesh)}
    if rank == 0:
        out.update(full)
    return out


def moe_grad_body(rank, world, tmp, factors):
    """``moe_apply``'s backward on a (2, 4) mesh (``moe_ep``): this rank's
    batch slice of ``moe.npz``'s x, whole expert weights, the loss
    ``sum(y * cot)``; returns the rank's gradients of x, prob and the three
    expert weights (each its share: summed over the ranks they are the
    whole gradient) and the collectives."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import ShardingRules, use_rules
    from repro_torch.models.layers import moe as M
    mesh = _mesh(2, 4)
    d, _ = mesh.get_coordinate()
    z = np.load(f"{tmp}/moe.npz")
    B = z["x"].shape[0]
    b = slice(d * B // 2, (d + 1) * B // 2)
    rules = ShardingRules({"batch": ("data",), "seq_model": "model", "experts": "model",
                           "embed_act": None, "seq": None})
    out = {}
    for cf in factors:
        cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, capacity_factor=cf)
        w = {n: torch.from_numpy(z[n]).requires_grad_() for n in ("w_gate", "w_up", "w_down")}
        x = torch.from_numpy(z["x"][b]).requires_grad_()
        prob = torch.from_numpy(z[f"prob_{cf}"][b]).requires_grad_()
        C.reset_collective_counts()
        with use_rules(rules, mesh):
            y = M.moe_apply(cfg, w, x, torch.from_numpy(z[f"idx_{cf}"][b]).long(), prob)
            (y * torch.from_numpy(z["cot"][b])).sum().backward()
        out[cf] = {"x": x.grad, "prob": prob.grad, **{n: t.grad for n, t in w.items()},
                   "collectives": C.collective_counts()}
    return out


def trainer_body(rank, world, tmp, arch, data, model, steps, ckpt_dir, restore_mesh):
    """``Trainer(..., rules=, mesh=)`` on a (data, model) mesh: ``steps``
    steps of ``SyntheticTokens`` checkpointed after each; then a second
    Trainer on the same directory resumes (its state against the first's,
    gathered back), and one built on a ``restore_mesh`` of another shape
    raises.  Returns the history, the resumed step, whether the states
    match bit for bit, and the error text."""
    import torch
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.trainer import Trainer, TrainerConfig
    mesh = _mesh(data, model)
    cfg = R.smoke(arch).replace(compute_dtype="float32")
    rules = rules_for(cfg, ShapeConfig("t", "train", 16, 4), mesh)
    tc = TrainerConfig(num_steps=steps, ckpt_every=1, ckpt_dir=ckpt_dir, async_save=False,
                       device="cpu")
    tr = Trainer(cfg, iter(SyntheticTokens(cfg, 4, 16, seed=3)), tc, rules=rules, mesh=mesh)
    hist = tr.train()
    again = Trainer(cfg, iter(SyntheticTokens(cfg, 4, 16, seed=3)), tc, rules=rules,
                    mesh=mesh)
    resumed = again.try_resume()
    same = all(torch.equal(a, b) for a, b in zip(leaves(again.params), leaves(tr.params)))
    same &= all(torch.equal(a, b) for a, b in zip(leaves(again.opt_state),
                                                  leaves(tr.opt_state)))
    err = ""
    try:
        Trainer(cfg, iter(()), tc, rules=rules, mesh=restore_mesh)
    except NotImplementedError as e:
        err = str(e)
    return {"history": [{k: v for k, v in h.items() if k != "step_time_s"} for h in hist],
            "resumed": resumed, "step": again.step, "same": same, "error": err}


def trainer_init_body(rank, world, tmp, arch, data, model, opt):
    """``Trainer(..., rules=, mesh=).init_state()`` on a (data, model) mesh
    with the optimizer ``opt``: whether the rank's parameters and state
    equal the whole seeded state cut by ``shard_tree``, bit for bit and
    shape for shape."""
    import torch
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import rules_for, shard_tree
    from repro_torch.models.layers.module import tree_map
    from repro_torch.models.registry import fns_for
    from repro_torch.optim.optimizers import leaves, make_optimizer
    from repro_torch.training.trainer import Trainer, TrainerConfig
    mesh = _mesh(data, model)
    cfg = R.smoke(arch).replace(optimizer=opt)
    rules = rules_for(cfg, ShapeConfig("t", "train", 16, 4), mesh)
    tc = TrainerConfig(num_steps=0, ckpt_dir=f"{tmp}/ckpt_{opt}", device="cpu")
    tr = Trainer(cfg, iter(()), tc, rules=rules, mesh=mesh)
    tr.init_state()
    fns, optimizer = fns_for(cfg), make_optimizer(cfg)
    axes = tree_map(lambda d: d.axes, fns.table(cfg))
    whole = fns.init(cfg, torch.Generator("cpu").manual_seed(tc.seed))
    want = (shard_tree(whole, axes, rules, mesh),
            shard_tree(optimizer.init(whole), optimizer.state_axes(axes), rules, mesh))
    got = (tr.params, tr.opt_state)
    same = [a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
            for g, w in zip(got, want) for a, b in zip(leaves(g), leaves(w), strict=True)]
    return {"same": all(same), "leaves": len(same)}


def collectives_grad_body(rank, world, tmp):
    """Each differentiable collective on a (1, 4) mesh's model group in
    fp64, its loss this rank's ``sum(y * c[rank])`` (a rank's own weights:
    a partial consumer), or, for the replicated gather, ``sum(y * c[0])``
    on every rank; returns each input's gradient.  ``x`` and ``c`` come
    from ``coll.npz``."""
    import torch
    from repro_torch.distributed import collectives as C
    mesh = _mesh(1, 4)
    g = mesh.get_group("model")
    z = np.load(f"{tmp}/coll.npz")
    X, Cw = torch.from_numpy(z["x"]), torch.from_numpy(z["c"])    # (4, 8, 8) each
    out = {}

    def run(name, fn, x, c):
        x = x.clone().requires_grad_()
        (fn(x) * c).sum().backward()
        out[name] = x.grad
    run("all_reduce", lambda x: C.all_reduce(x, g), X[rank], Cw[rank])
    run("gather_partial", lambda x: C.all_gather_dim(x, 1, g), X[rank][:, :2],
        Cw[rank][:, :8])
    run("gather_replicated", lambda x: C.all_gather_dim(x, 1, g, consumer="replicated"),
        X[rank][:, :2], Cw[0][:, :8])
    run("gather_partial_of_replicated", lambda x: C.all_gather_dim(x, 1, g), X[rank][:, :2],
        Cw[0][:, :8])
    run("reduce_scatter", lambda x: C.reduce_scatter_dim(x, 0, g), X[rank], Cw[rank][:2])
    run("all_to_all", lambda x: C.all_to_all(x, g), X[rank], Cw[rank])
    return out


def pieces_body(rank, world, tmp):
    """The vocabulary-parallel cross-entropy, the global norm, Adafactor and
    ``shard_tree`` / ``gather_tree`` on 4 gloo ranks in fp64, from
    ``pieces.npz``."""
    import torch
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import (ShardingRules, gather_tree, shard_of,
                                                  shard_tree, use_rules)
    from repro_torch.optim import optimizers as O
    from repro_torch.optim.optimizers import ShardLayout
    from repro_torch.training.losses import lm_cross_entropy
    z = np.load(f"{tmp}/pieces.npz")
    out = {}
    # the cross-entropy: vocabulary on model, rows whole or own (seq_sp)
    mesh = _mesh(1, 4)
    logits = torch.from_numpy(z["logits"])                 # (B, S, V) whole
    labels = torch.from_numpy(z["labels"])
    V = logits.shape[-1]
    for seq_sp in (False, True):
        rules = ShardingRules({"vocab": "model", "heads": "model",
                               "seq_sp": "model" if seq_sp else None, "batch": None})
        with use_rules(rules, mesh):
            tp = TP.plan()
        x = logits[..., rank * V // 4:(rank + 1) * V // 4].clone().requires_grad_()
        loss, m = lm_cross_entropy(x, labels, tp=tp)
        loss.backward()
        out[f"ce_{seq_sp}"] = {"loss": loss.detach(), "nll": m["nll"], "acc": m["accuracy"],
                               "grad": x.grad}
    # global norm, Adafactor, shard / gather on a (2, 2) mesh
    mesh = _mesh(2, 2)
    rules = ShardingRules({"a": "data", "b": "model", "ab": ("data", "model")})
    axes = {"w": ("a", "b"), "v": ("b", None, "a"), "s": (None,), "m": ("ab", None)}
    whole = {k: torch.from_numpy(z[k]) for k in axes}
    grads = {k: torch.from_numpy(z["g_" + k]) for k in axes}
    sp = shard_tree(whole, axes, rules, mesh)
    sg = shard_tree(grads, axes, rules, mesh)
    back = gather_tree(sp, axes, rules, mesh)
    out["round_trip"] = all(torch.equal(back[k], whole[k]) for k in axes)
    out["contiguous"] = all(t.is_contiguous() and t.untyped_storage().nbytes()
                            == t.numel() * t.element_size() for t in sp.values())
    out["local_shapes"] = {k: tuple(t.shape) for k, t in sp.items()}
    with use_rules(rules, mesh):
        out["shard_of_ab"] = shard_of(mesh, rules, "ab")
    table = {k: type("D", (), {"axes": a})() for k, a in axes.items()}
    layout = ShardLayout.of(sp, table, rules, mesh)
    out["norm"] = O.global_norm(sg, layout)
    opt = O.adafactor(O.constant(1e-2))
    state = shard_tree(opt.init(whole), opt.state_axes(axes), rules, mesh)
    new, state, met = opt.update(sg, state, sp, layout=layout)
    out["adafactor"] = gather_tree(new, axes, rules, mesh)
    out["adafactor_norm"] = met["grad_norm"]
    return out
