"""Serving launcher for the PyTorch/CUDA port: the continuous-batching
engine on one card, with throughput, serving-quality metrics (TTFT p50/p99,
TPOT, slot occupancy) and tokens/s per watt against the card's power limit
(counterpart of ``repro/launch/serve.py``, single replica).  The dense
family serves from the paged KV pool (from contiguous per-slot caches with
``--contiguous-kv``), the hybrid (zamba2) from contiguous per-slot caches;
contiguous caches hold ``prompt_len + new_tokens + 1`` rows.  With
``--draft-model`` greedy requests decode speculatively on the paged pool;
``--host-blocks`` adds the host KV tier, ``--inject-faults`` a fault plan
and ``--deadline-s`` a deadline on every request.

Example (on a machine with an NVIDIA card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --prompt-len 512 --prefill-chunk 256 --kv-pool-blocks 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --contiguous-kv
  # speculative decoding, the target drafting for itself (shared weights):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --draft-model qwen2.5-3b --spec-k 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
  # the host KV tier and a seeded fault plan:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --host-blocks 256 --inject-faults seed=3
  # the plain PyTorch versions of the kernels, on the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --smoke --device cpu --host-blocks 16 --inject-faults seed=3
"""
from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from repro_torch.configs import registry as arch_registry
from repro_torch.models.registry import fns_for
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.sampler import greedy, temperature


def _fmt_ms(v: float | None) -> str:
    return f"{v * 1e3:.1f}ms" if v is not None else "n/a"


def card_name_and_power_limit() -> tuple[str, float]:
    """(name, power limit in W) of card 0, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), float(limit.strip().split()[0])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--contiguous-kv", action="store_true",
                    help="disable the paged KV pool (worst-case per-slot "
                         "cache, per-prompt-length prefill shapes)")
    ap.add_argument("--kv-pool-blocks", type=int, default=None,
                    help="paged KV pool size in blocks (default: worst "
                         "case = slots x ceil(max_len / block_size))")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="C",
                    help="prefill prompts in C-token chunks interleaved "
                         "with decode steps (C a multiple of the 16-token "
                         "block size; default: whole prompt in one go)")
    ap.add_argument("--no-preemption", action="store_true",
                    help="disable decode preemption")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable refcounted prompt-prefix block sharing")
    ap.add_argument("--host-blocks", type=int, default=0, metavar="N",
                    help="tiered KV cache: spill cold pool blocks (idle "
                         "shared prefixes, preemption victims' histories) "
                         "to an N-block host tier and restore them "
                         "asynchronously through the split-phase offload "
                         "protocol instead of recomputing (0 = untiered)")
    ap.add_argument("--no-kv-tiering", action="store_true",
                    help="ignore --host-blocks: run the untiered pool "
                         "(the recompute A/B baseline for tiering)")
    ap.add_argument("--no-seeded-prefill", action="store_true",
                    help="recompute baseline: every prompt token is re-run "
                         "(compare prefill_tokens_computed)")
    ap.add_argument("--draft-model", default=None, metavar="ARCH",
                    help="enable speculative decoding with this arch as "
                         "the drafter (paged KV only); greedy requests "
                         "propose --spec-k tokens per step and the target "
                         "verifies them in one batched pass -- outputs are "
                         "vanilla greedy's.  Same arch as --arch = "
                         "self-speculation (shares the target's weights)")
    ap.add_argument("--spec-k", type=int, default=3, metavar="K",
                    help="drafter tokens proposed per speculative round "
                         "(each verify pass scores K+1 positions and "
                         "commits 1..K+1 tokens)")
    ap.add_argument("--no-spec", action="store_true",
                    help="ignore --draft-model: run vanilla decode (the "
                         "A/B baseline for speculative decoding)")
    ap.add_argument("--deadline-s", type=float, default=None, metavar="S",
                    help="per-request completion deadline: a request "
                         "still queued or mid-decode after S seconds is "
                         "cancelled with a typed DeadlineExceeded and its "
                         "KV blocks reclaimed")
    ap.add_argument("--inject-faults", default=None, metavar="PLAN",
                    help="deterministic fault injection for chaos runs: "
                         "comma-separated site[:action[:after[:count]]] "
                         "specs (sites: target.compute engine.prefill "
                         "engine.decode kv.spill kv.fetch "
                         "replica.executor; actions: raise drop delay) or "
                         "seed=<int> for a random seeded plan -- e.g. "
                         "'replica.executor:raise:4,kv.fetch:drop'")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args()

    cfg = (arch_registry.smoke(args.arch) if args.smoke
           else arch_registry.config(args.arch))
    fns = fns_for(cfg)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu (with --smoke) to run "
                 "the plain versions on the CPU")
    params = fns.init(cfg, torch.Generator(device).manual_seed(0))
    max_len = args.prompt_len + args.new_tokens + 1
    rng = np.random.default_rng(0)
    mk_sampler = (greedy if args.temperature == 0
                  else lambda: temperature(args.temperature, top_k=40))
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens, sampler=mk_sampler())
            for i in range(args.requests)]
    if args.deadline_s is not None:
        for r in reqs:
            r.deadline_s = args.deadline_s
    fault_plan = (FaultPlan.parse(args.inject_faults)
                  if args.inject_faults else None)
    kw = dict(max_len=max_len, batch_slots=args.slots,
              paged=False if args.contiguous_kv else None,
              pool_blocks=args.kv_pool_blocks,
              preemption=not args.no_preemption,
              prefix_sharing=not args.no_prefix_sharing,
              prefill_chunk=args.prefill_chunk,
              seeded_prefill=not args.no_seeded_prefill,
              host_blocks=0 if args.no_kv_tiering else args.host_blocks,
              fault_plan=fault_plan, device=device)
    if args.draft_model and not args.no_spec:
        if args.contiguous_kv:
            ap.error("--draft-model needs the paged KV pool; "
                     "drop --contiguous-kv")
        if args.draft_model == args.arch:        # self-speculation
            kw.update(draft_cfg=cfg, draft_params=params)
        else:
            dcfg = (arch_registry.smoke(args.draft_model) if args.smoke
                    else arch_registry.config(args.draft_model))
            kw.update(draft_cfg=dcfg, draft_params=fns_for(dcfg).init(
                dcfg, torch.Generator(device).manual_seed(1)))
        kw["spec_k"] = args.spec_k
    eng = ServingEngine(cfg, params, **kw)
    del params, kw                  # the engine keeps its own cast copies
    stats = eng.serve(reqs)
    print(f"requests={stats.requests} tokens={stats.tokens} "
          f"wall={stats.wall_s:.2f}s tok/s={stats.tokens_per_s:.2f}")
    print(f"ttft p50={_fmt_ms(stats.ttft_p50_s)} "
          f"p99={_fmt_ms(stats.ttft_p99_s)}  "
          f"tpot={_fmt_ms(stats.mean_tpot_s)}  "
          f"slot_occupancy={stats.slot_occupancy:.2f}")
    if eng.paged:
        print(f"prefill_compiles={stats.prefill_compiles}  "
              f"kv_blocks_peak={stats.kv_blocks_peak}  "
              f"kv_pool_util={stats.kv_pool_util:.2f}")
    else:
        print(f"prefill_compiles={stats.prefill_compiles}  contiguous KV: "
              f"{max_len} rows x {args.slots} slots")
    if stats.prefill_tokens_total:       # none when every request failed
        stall = (f"{stats.decode_stall_p99_s * 1e3:.1f}ms"
                 if stats.decode_stall_p99_s is not None else "n/a")
        print(f"prefill_tokens={stats.prefill_tokens_computed}"
              f"/{stats.prefill_tokens_total} computed "
              f"({stats.prefill_compute_frac:.0%})  "
              f"decode_stall_p99={stall}")
    if stats.spec_proposed:
        spt = (f"{stats.steps_per_token:.2f}"
               if stats.steps_per_token is not None else "n/a")
        print(f"spec: accept_rate={stats.accept_rate:.2f}  "
              f"verify_steps={stats.verify_steps}  "
              f"decode_steps={stats.decode_steps}  steps/token={spt}")
    if stats.kv_spills or stats.kv_fetches:
        hit = (f"{stats.kv_hit_rate:.2f}"
               if stats.kv_hit_rate is not None else "n/a")
        print(f"tiering: spills={stats.kv_spills}  "
              f"fetches={stats.kv_fetches}  "
              f"host_hits={stats.prefix_hits_host}  "
              f"spill_bytes={stats.spill_bytes}  kv_hit_rate={hit}")
    if (stats.requests_failed or stats.shed_rejections
            or stats.faults_injected):
        # the reference's line: retries and replica failures stay 0 on
        # one replica
        print(f"faults: injected={stats.faults_injected}  "
              f"failed={stats.requests_failed}  "
              f"retried={stats.requests_retried}  "
              f"replica_failures={stats.replica_failures}  "
              f"shed={stats.shed_rejections}")
    if stats.preemptions or stats.prefix_shared_blocks:
        print(f"preemptions={stats.preemptions}  "
              f"prefix_shared_blocks={stats.prefix_shared_blocks}")
    if device.type == "cuda":
        name, watts = card_name_and_power_limit()
        print(f"{name} power.limit={watts:.0f}W  "
              f"tokens/s/W={stats.tokens_per_s / watts:.4f}")
    else:
        print("tokens/s/W: not measured (CPU run)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
