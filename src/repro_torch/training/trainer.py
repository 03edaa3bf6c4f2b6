"""Training loop with checkpoint/auto-resume and fault recovery
(counterpart of ``repro/training/trainer.py``).

The loop is deliberately boring: one train step, a periodic async
checkpoint, the fault schedule checked every step.  On a ``crash`` fault
it restores the last committed checkpoint (losing at most
``ckpt_every - 1`` steps).  The elastic re-mesh on ``device_loss`` comes
with the distributed slice: here ``on_device_loss`` is called, then the
state restored, as for a crash.

It trains the dense family (the transformer LMs), the hybrid (zamba2:
K5 and K4 with their backward kernels), the ssm family (xlstm-125m: each
mLSTM block's scan through K5 and its backward, N and P walked in slices
there, the sLSTM's cell steps differentiated by autograd, every weight
product through K7 and its backward) and the CNN (GoogLeNet, fed by
``SyntheticImages`` as the reference's is: every convolution through K6
and its backward kernel) and the moe family (deepseek-moe-16b,
qwen3-moe: the router's aux loss added to the loss, each expert product
forward, in the recompute and in the backward through K7's batched entry,
the capacity dispatch differentiated as the reference's einsums are), the
vlm family (qwen2-vl-72b: the dense transformer with M-RoPE, its three
position streams from the batch, stream 0 the rows 0..S-1 as K4 masks by
row) and the audio family (whisper-medium: the encoder over
``SyntheticTokens``' frames and the decoder, every encoder and decoder
block checkpointed under remat, K4's backward at the cross-attention's
KV length of its own).  Every family that ``fns_for`` maps trains.
State lives on ``TrainerConfig.device``, the card by default.

Under a mesh (``Trainer(..., rules=, mesh=)``) the state is drawn from
the seed as without one, but each rank keeps only its slices, cut a leaf
(of a stacked leaf, a layer) at a time as it is drawn
(:meth:`Trainer._init_slices`); every step runs
under ``use_rules(rules, mesh)`` (the sharded step of
:mod:`repro_torch.training.train_step`).  Each rank checkpoints its slices
in a directory of its own, named by its mesh coordinate, beside a
``MESH.json`` with the mesh's axes and sizes; a restore on a mesh of
another shape raises (re-meshing is ROADMAP item 11c).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.distributed.fault import FaultSchedule, Heartbeat, SimulatedFault
from repro_torch.distributed.sharding import local_part, shard_tree, use_rules
from repro_torch.models.layers.module import init_table, tree_map
from repro_torch.models.registry import fns_for
from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.training.train_step import make_train_step

TRAINED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio", "cnn")


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    keep: int = 3
    async_save: bool = True
    seed: int = 0
    device: str = "cuda"


def training_device(name: str) -> torch.device:
    """The device to train on; raises for ``cuda`` where there is no card
    (there is no silent fall-back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on cuda needs an NVIDIA card "
                           "(torch.cuda.is_available() is False); "
                           "ask for the CPU with device='cpu'")
    return dev


class Trainer:
    def __init__(self, cfg, data_iter: Iterator[dict], tc: TrainerConfig,
                 *, optimizer: Optimizer | None = None,
                 fault_schedule: FaultSchedule | None = None,
                 accum: int | None = None,
                 on_device_loss: Callable[[], None] | None = None,
                 rules=None, mesh=None):
        if cfg.family not in TRAINED_FAMILIES:
            raise NotImplementedError(
                f"training the {cfg.family!r} family is not ported; the port "
                f"trains {list(TRAINED_FAMILIES)}")
        if (rules is None) != (mesh is None):
            raise ValueError("a mesh needs its rules, and rules their mesh")
        self.cfg = cfg
        self.tc = tc
        self.device = training_device(tc.device)
        self.data_iter = data_iter
        self.fns = fns_for(cfg)
        self.optimizer = optimizer or make_optimizer(cfg)
        self.faults = fault_schedule or FaultSchedule()
        self.heartbeat = Heartbeat()
        self.rules, self.mesh = rules, mesh
        ckpt_dir = tc.ckpt_dir
        if mesh is not None:
            self._check_mesh_file()
            coord = "_".join(str(c) for c in mesh.get_coordinate())
            ckpt_dir = os.path.join(tc.ckpt_dir, f"rank_{coord}")
        self.ckpt = Checkpointer(ckpt_dir, keep=tc.keep, async_save=tc.async_save)
        self.on_device_loss = on_device_loss
        self._step_fn = make_train_step(cfg, self.optimizer, accum=accum)
        self.step = 0
        self.params = None
        self.opt_state = None
        self.history: list[dict] = []

    # -- state ------------------------------------------------------------------

    def _mesh_shape(self) -> dict:
        return {"axes": list(self.mesh.mesh_dim_names), "shape": list(self.mesh.shape)}

    def _check_mesh_file(self) -> None:
        """Raise where ``ckpt_dir`` holds checkpoints of another mesh's
        slices; record this mesh's shape there otherwise."""
        path = os.path.join(self.tc.ckpt_dir, "MESH.json")
        if os.path.exists(path):
            with open(path) as f:
                saved = json.load(f)
            if saved != self._mesh_shape():
                raise NotImplementedError(
                    f"the checkpoints in {self.tc.ckpt_dir} hold the slices of a "
                    f"{saved} mesh, not of {self._mesh_shape()}: restoring on another "
                    f"mesh is elastic re-meshing (ROADMAP item 11c)")
            return
        os.makedirs(self.tc.ckpt_dir, exist_ok=True)
        with open(path + f".tmp{os.getpid()}", "w") as f:
            json.dump(self._mesh_shape(), f)
        os.replace(path + f".tmp{os.getpid()}", path)

    def _sharding(self):
        """The rules and mesh as the current ones (nothing without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_rules(self.rules, self.mesh)

    def init_state(self) -> None:
        gen = torch.Generator(self.device).manual_seed(self.tc.seed)
        if self.mesh is None:
            self.params = self.fns.init(self.cfg, gen)
            self.opt_state = self.optimizer.init(self.params)
        else:
            self.params, self.opt_state = self._init_slices(gen)
        self.step = 0

    def _init_slices(self, gen: torch.Generator):
        """The rank's slices of the seeded state, the whole never resident.
        Each parameter is drawn as the family's ``init`` draws it
        (``init_table`` on its table), a stacked leaf a layer at a time, and
        cut to the rank's slice before the next draw.  The optimizer's state
        starts at zero (AdamW's moments, Adafactor's factored or full second
        moments): its ``init`` runs on the meta device at the whole shapes,
        which gives the trees, the factoring and the shapes to cut, and the
        slices are then made as zeros on the card."""
        table = self.fns.table(self.cfg)
        axes = tree_map(lambda d: d.axes, table)
        params = init_table(gen, table, self.cfg.param_dtype,
                            place=lambda t, ax: local_part(t, ax, self.rules, self.mesh))
        whole = tree_map(lambda d: torch.empty(d.shape, device="meta"), table)
        state = shard_tree(self.optimizer.init(whole), self.optimizer.state_axes(axes),
                           self.rules, self.mesh)
        state = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=self.device)
                         if t.is_meta else t, state)
        return params, state

    def try_resume(self) -> bool:
        if self.params is None:
            self.init_state()
        like = {"params": self.params, "opt": self.opt_state,
                "step": torch.zeros((), dtype=torch.int32)}
        res = self.ckpt.restore_latest(like)
        if res is None:
            return False
        _, tree = res
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = int(tree["step"])
        return True

    def save(self) -> None:
        self.ckpt.save(self.step, {
            "params": self.params, "opt": self.opt_state,
            "step": torch.tensor(self.step, dtype=torch.int32)})

    # -- loop -------------------------------------------------------------------

    def train(self) -> list[dict]:
        if self.params is None and not self.try_resume():
            self.init_state()
        while self.step < self.tc.num_steps:
            try:
                self._one_step()
            except SimulatedFault as f:
                self._recover(f)
        self.ckpt.wait()
        return self.history

    def _one_step(self) -> None:
        self.faults.check(self.step)
        batch = next(self.data_iter)
        t0 = time.monotonic()
        with self._sharding():
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}   # waits for the device
        metrics["step"] = self.step
        metrics["step_time_s"] = time.monotonic() - t0
        self.heartbeat.beat()
        self.history.append(metrics)
        self.step += 1
        if self.step % self.tc.ckpt_every == 0:
            self.save()

    def _recover(self, fault: SimulatedFault) -> None:
        """Restore the last checkpoint (after ``on_device_loss`` for a device
        loss)."""
        if fault.kind == "device_loss" and self.on_device_loss is not None:
            self.on_device_loss()
        resumed = self.try_resume()
        if not resumed:
            self.init_state()
        self.history.append({"step": self.step, "event": fault.kind,
                             "resumed_from": self.step if resumed else 0})
