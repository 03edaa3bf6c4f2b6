"""GoogLeNet inference through the NCSw-style split-phase offload engine on
one card (counterpart of ``examples/offload_inference.py``).

  1. Real GoogLeNet inference (random weights from ``--seed``, synthetic
     ILSVRC-like images) through ``OffloadEngine([TorchTarget])``: img/s,
     time per batch, and img/W against the card's power limit (paper
     Eq. 1); every convolution runs the conv2d kernel.
  2. The paper's section 4.2 estimators: fp16 and bf16 predictions against
     fp32 on the same weights and images (``--fig7-images``).
  3. The paper's multi-VPU scaling law on 1..8 calibrated Myriad-2
     simulants (``SimTarget``), as the example runs it.

Example (on a machine with an NVIDIA card):
  PYTHONPATH=src python -m repro_torch.launch.offload_inference
  PYTHONPATH=src python -m repro_torch.launch.offload_inference \\
      --precision fp16 --batch 1 --batches 32
  # the plain PyTorch versions of the kernels, on the CPU, at 64x64:
  PYTHONPATH=src python -m repro_torch.launch.offload_inference \\
      --device cpu --size 64 --batches 2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry as arch_registry
from repro_torch.core.offload import OffloadEngine, SimTarget, TorchTarget
from repro_torch.core.power import PAPER_LATENCY_S, PAPER_TDP_W, report
from repro_torch.core.precision import (POLICIES, confidence_delta,
                                        prediction_agreement, top1_delta,
                                        top1_error_rate)
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.kernels import dispatch
from repro_torch.launch.serve import card_name_and_power_limit
from repro_torch.models import googlenet

SIM_SCALE = 0.05   # run the calibrated simulation at 20x speed


def serve_batches(cfg, params, batches, device) -> dict:
    """Top-1 labels of ``batches`` (numpy (B, H, W, 3) each) through an
    ``OffloadEngine`` over one ``TorchTarget`` on ``device``, after the
    first batch once as warm-up; the kernels' counts are zeroed just before
    the timed run and read just after it."""
    target = TorchTarget(lambda im: googlenet.predict(cfg, params, im)[0],
                         name=f"googlenet-{device.type}", device=device)
    with OffloadEngine([target]) as eng:
        eng.run(batches[:1])
        dispatch.reset_counts()
        labels, stats = eng.run(batches)
    k = dispatch.kernel_table()["conv2d"]
    B = batches[0].shape[0]
    return {"labels": labels, "img_s": stats.throughput * B,
            "batch_ms": stats.wall_s / stats.items * 1e3,
            "batches": stats.items, "launches": k.launches,
            "body_launches": dict(k.body_launches), "plain_calls": k.plain_calls}


def precision_deltas(cfg32, params, images, labels, device, *,
                     batch: int = 8) -> dict:
    """Paper Fig 7 on the port: fp16 and bf16 compute against fp32 on the
    same fp32 weights and images.  With random weights nothing matches the
    synthetic labels, so the confidence filter conditions on the fp32
    model's own top-1, as ``benchmarks/fig7_error_rate.py`` does."""
    def probs(cfg):
        out = []
        for i in range(0, len(images), batch):
            x = torch.from_numpy(images[i:i + batch]).to(device)
            out.append(googlenet.predict(cfg, params, x)[2].cpu().numpy())
        return np.concatenate(out)

    p32 = probs(cfg32)
    ref_labels = np.argmax(p32, -1)
    out = {}
    for name, dtype in (("fp16", "float16"), ("bf16", "bfloat16")):
        p_lp = probs(cfg32.replace(compute_dtype=dtype))
        out[name] = {
            "top1_error_fp32": top1_error_rate(p32, labels),
            "top1_error_lp": top1_error_rate(p_lp, labels),
            "top1_delta": top1_delta(p32, p_lp, labels),
            "confidence_delta": confidence_delta(p32, p_lp, ref_labels),
            "prediction_agreement": prediction_agreement(p32, p_lp),
        }
    return out


def vpu_sweep() -> list[tuple[int, float, float, float]]:
    """The paper's multi-VPU scaling on simulated NCS sticks: (devices,
    speedup, img/s, img/W) for 1, 2, 4 and 8."""
    lat = PAPER_LATENCY_S["vpu"] * SIM_SCALE
    rows, base = [], None
    for n in (1, 2, 4, 8):
        vpus = [SimTarget(f"ncs{i}", compute_s=lat * 0.8, transfer_s=lat * 0.2,
                          tdp_watts=PAPER_TDP_W["vpu"]) for i in range(n)]
        with OffloadEngine(vpus) as eng:
            _, st = eng.run(range(48))
        base = base or st.throughput
        img_s = st.throughput * SIM_SCALE
        rows.append((n, st.throughput / base, img_s,
                     report("vpu", n, img_s).items_per_watt))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--size", type=int, default=224, help="image side")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=16,
                    help="batches timed through the engine (after the first "
                         "one, untimed, as warm-up)")
    ap.add_argument("--precision", choices=sorted(POLICIES), default="fp32")
    ap.add_argument("--fig7-images", type=int, default=48,
                    help="images for the fp16/bf16-vs-fp32 estimators (0: skip)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu (with --size 64) to run "
                 "the plain versions on the CPU")
    cfg32 = arch_registry.GOOGLENET
    policy = POLICIES[args.precision]
    cfg = policy.apply_to_config(cfg32)
    params32 = googlenet.init(cfg32, torch.Generator(device).manual_seed(args.seed))
    params = policy.cast_params(params32)
    src = SyntheticImages(num_classes=cfg.vocab_size, batch=args.batch,
                          size=args.size, seed=args.seed)
    batches = [src.sample(args.batch)["images"] for _ in range(args.batches)]
    name, watts = (card_name_and_power_limit() if device.type == "cuda"
                   else (None, None))
    r = serve_batches(cfg, params, batches, device)
    print(f"[{device.type}] GoogLeNet {args.size}x{args.size} batch {args.batch} "
          f"{args.precision}: {r['img_s']:.2f} img/s, {r['batch_ms']:.2f} ms per "
          f"batch over {r['batches']} batches through the engine; conv2d "
          f"launches {r['launches']} ({r['launches'] / r['batches']:.0f} per "
          f"forward), plain calls {r['plain_calls']}")
    if watts:
        rep = report(name, 1, r["img_s"], per_device_watts=watts)
        print(f"[{device.type}] {name} power.limit={watts:.0f}W: "
              f"{rep.items_per_watt:.4f} img/W, {rep.joules_per_item:.4f} J/img")
    else:
        print("[cpu] img/W: not measured (CPU run)")

    if args.fig7_images:
        sample = SyntheticImages(num_classes=cfg32.vocab_size, size=args.size,
                                 seed=7).sample(args.fig7_images)
        deltas = precision_deltas(cfg32, params32, sample["images"],
                                  sample["labels"], device, batch=args.batch)
        for lp, m in deltas.items():
            print(f"[fig7] {lp} vs fp32 over {args.fig7_images} images: top1 "
                  f"delta={m['top1_delta']:.4f} confidence delta="
                  f"{m['confidence_delta']:.3e} agreement="
                  f"{m['prediction_agreement']:.3f}")

    for n, speedup, img_s, img_w in vpu_sweep():
        print(f"[vpu x{n}]  speedup {speedup:4.2f}x   {img_s:6.1f} img/s   "
              f"{img_w:6.2f} img/W (simulated)")
    print("paper Fig 6b/8a: near-ideal scaling to 8 devices; "
          ">3x img/W vs CPU/GPU")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
