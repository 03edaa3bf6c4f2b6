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
