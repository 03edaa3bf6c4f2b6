"""Training loop with checkpoint/auto-resume and fault recovery
(counterpart of ``repro/training/trainer.py``).

The loop is deliberately boring: one train step, a periodic async
checkpoint, the fault schedule checked every step.  On a ``crash`` fault
it restores the last committed checkpoint (losing at most
``ckpt_every - 1`` steps).  The elastic re-mesh on ``device_loss`` comes
with the distributed slice: here ``on_device_loss`` is called, then the
state restored, as for a crash.

It trains the dense family (the transformer LMs), the hybrid (zamba2:
K5 and K4 with their backward kernels) and the CNN (GoogLeNet, fed by
``SyntheticImages`` as the reference's is: every convolution through K6
and its backward kernel).  State lives on ``TrainerConfig.device``, the
card by default.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.distributed.fault import FaultSchedule, Heartbeat, SimulatedFault
from repro_torch.models.registry import fns_for
from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.training.train_step import make_train_step

TRAINED_FAMILIES = ("dense", "hybrid", "cnn")


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
                 on_device_loss: Callable[[], None] | None = None):
        if cfg.family not in TRAINED_FAMILIES:
            raise NotImplementedError(
                f"training the {cfg.family!r} family is not ported; the port "
                f"trains {list(TRAINED_FAMILIES)}")
        self.cfg = cfg
        self.tc = tc
        self.device = training_device(tc.device)
        self.data_iter = data_iter
        self.fns = fns_for(cfg)
        self.optimizer = optimizer or make_optimizer(cfg)
        self.faults = fault_schedule or FaultSchedule()
        self.heartbeat = Heartbeat()
        self.ckpt = Checkpointer(tc.ckpt_dir, keep=tc.keep,
                                 async_save=tc.async_save)
        self.on_device_loss = on_device_loss
        self._step_fn = make_train_step(cfg, self.optimizer, accum=accum)
        self.step = 0
        self.params = None
        self.opt_state = None
        self.history: list[dict] = []

    # -- state ------------------------------------------------------------------

    def init_state(self) -> None:
        gen = torch.Generator(self.device).manual_seed(self.tc.seed)
        self.params = self.fns.init(self.cfg, gen)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0

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
