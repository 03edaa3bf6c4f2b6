"""Training launcher for the PyTorch/CUDA port (counterpart of
``repro/launch/train.py``, with ``--device``): the ported Trainer on one
card, every weight product of the forward and backward through the K7
matmul kernel (an MoE layer's expert products through its batched
entry), attention through K4 (whisper's cross-attention at a KV length
of its own) and (zamba2's Mamba-2 layers, xlstm's mLSTM blocks) the scan
through K5, each with its backward kernel.  An MoE
config's router aux loss is added to the loss, as the reference's.  Prints the first and last loss, the step time, tokens/s,
tokens/s/W against the card's power limit and the peak device memory.  It feeds ``SyntheticTokens``, as the
reference's does; GoogLeNet, whose forward reads images, trains as the
reference trains it: ``Trainer(cfg, iter(SyntheticImages(...)), tc)``
(``chip_smoke.py`` phase 22c), every conv through K6 and its backward.

Example (on a machine with an NVIDIA card): qwen2.5-3b at full width,
4 steps of 8 x 512 tokens in 8 microbatches (the config's ``accum_steps``;
the launcher's default is 1, as the reference's):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 4 --batch 8 --seq 512 --accum 8
  # the kernels' plain versions, on the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --smoke --device cpu --steps 20 --batch 4 --seq 16
  # zamba2-1.2b at full width, 3 steps of 8 x 512 in 8 microbatches:
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --steps 3 --batch 8 --seq 512 --accum 8
  # xlstm-125m at full width (9 mLSTM blocks, their scans through K5 and
  # its sliced backward; 3 sLSTM blocks), 3 steps of 8 x 512 in 8
  # microbatches, or on the CPU at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --steps 3 --batch 8 --seq 512 --accum 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --smoke --device cpu --steps 20 --batch 4 --seq 16
  # deepseek-moe-16b's smoke config on the CPU (at full width its 28
  # layers' fp32 state, ~262 GB, does not fit one card: chip_smoke.py
  # phase 26c trains it cut to 4 layers through the Trainer):
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b \\
      --smoke --device cpu --steps 20 --batch 4 --seq 16
  # whisper-medium at its full config (24 + 24 layers, 1500 frames a
  # sequence from SyntheticTokens), 3 steps of 8 x 448 decoder tokens in 8
  # microbatches; qwen2-vl-72b's smoke config on the CPU (at full width its
  # fp32 state does not fit one card: chip_smoke.py phase 30b trains it
  # cut to 4 layers through the Trainer, with its config's Adafactor):
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium \\
      --steps 3 --batch 8 --seq 448 --accum 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-72b \\
      --smoke --device cpu --steps 20 --batch 4 --seq 16
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.configs import registry as arch_registry
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens
from repro_torch.distributed.fault import FaultSchedule
from repro_torch.optim.optimizers import adamw, warmup_cosine
from repro_torch.training.trainer import Trainer, TrainerConfig


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches per step (default 1, as the "
                         "reference launcher's)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-fault", type=int, default=None,
                    help="simulate a crash at this step (recovery demo)")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train as ``args`` say; returns the history and a summary."""
    cfg = (arch_registry.smoke(args.arch) if args.smoke
           else arch_registry.config(args.arch))
    data = Prefetcher(SyntheticTokens(cfg, args.batch, args.seq))
    faults = FaultSchedule(
        events={args.inject_fault: "crash"} if args.inject_fault else {})
    tc = TrainerConfig(num_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, device=args.device)
    cuda = torch.device(args.device).type == "cuda"
    try:
        trainer = Trainer(cfg, iter(data), tc,
                          optimizer=adamw(warmup_cosine(args.lr, args.warmup,
                                                        args.steps)),
                          fault_schedule=faults, accum=args.accum)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        if args.resume:
            trainer.try_resume()
        history = trainer.train()
    finally:
        data.close()
    steps = [h for h in history if "loss" in h]
    times = [h["step_time_s"] for h in steps]
    timed = times[1:] or times           # the first step warms up
    step_s = sum(timed) / len(timed)
    summary = {
        "arch": cfg.name, "steps": len(steps), "first_loss": steps[0]["loss"],
        "last_loss": steps[-1]["loss"], "first_step_s": times[0],
        "step_s": step_s, "tokens_per_s": args.batch * args.seq / step_s,
        "accum": args.accum,
        "peak_memory_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    }
    return {"history": history, "summary": summary, "trainer": trainer}


def main(argv=None) -> int:
    args = parse(argv)
    out = run(args)
    s = out["summary"]
    line = (f"{s['arch']}: steps={s['steps']} first_loss={s['first_loss']:.3f} "
            f"last_loss={s['last_loss']:.3f} accum={s['accum']} "
            f"first_step={s['first_step_s']:.3f}s step={s['step_s']:.3f}s "
            f"tokens/s={s['tokens_per_s']:.1f}")
    if s["peak_memory_bytes"] is not None:
        from repro_torch.launch.serve import card_name_and_power_limit
        name, watts = card_name_and_power_limit()
        line += (f" tokens/s/W={s['tokens_per_s'] / watts:.4f} at power.limit "
                 f"{watts:.0f} W ({name}) max_memory_allocated="
                 f"{s['peak_memory_bytes'] / 2**30:.2f}GiB")
    print(line)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(out["history"], f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
