"""Serving launcher for the PyTorch/CUDA port: the continuous-batching
engine on one card, with throughput, serving-quality metrics (TTFT p50/p99,
TPOT, slot occupancy) and tokens/s per watt against the card's power limit
(counterpart of ``repro/launch/serve.py``, every flag of it).  The dense
and MoE families serve from the paged KV pool (from contiguous per-slot
caches with ``--contiguous-kv``), the hybrid (zamba2) and the recurrent xLSTM from
contiguous per-slot state;
contiguous caches hold ``prompt_len + new_tokens + 1`` rows.  With
``--draft-model`` greedy requests decode speculatively on the paged pool;
``--host-blocks`` adds the host KV tier, ``--inject-faults`` a fault plan
and ``--deadline-s`` a deadline on every request.  ``--replicas N`` builds
N engines from one set of weights, on the one card, behind a
:class:`~repro_torch.serving.router.ReplicaRouter` (``--replica-roles``
makes the fleet disaggregated: prefill replicas migrate each prompt's KV
blocks to decode replicas); the tokens/s/W line divides by that one card's
power limit.  ``--mode wave`` serves lock-step waves (one replica).

Example (on a machine with an NVIDIA card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --prompt-len 512 --prefill-chunk 256 --kv-pool-blocks 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --contiguous-kv
  # speculative decoding, the target drafting for itself (shared weights):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --draft-model qwen2.5-3b --spec-k 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
  # the host KV tier and a seeded fault plan:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --host-blocks 256 --inject-faults seed=3
  # two replicas on the card: routed, or disaggregated prefill/decode:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --replicas 2 --prompt-len 512 --prefill-chunk 256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --replicas 2 --replica-roles prefill,decode --prefill-chunk 256
  # lock-step waves, the continuous engine's A/B baseline:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --mode wave
  # the plain PyTorch versions of the kernels, on the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
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
from repro_torch.models import transformer
from repro_torch.models.registry import TRANSFORMER_FNS, fns_for
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.router import ReplicaRouter
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica count; >1 builds that many engines on the "
                         "one device and routes individual requests through "
                         "the ReplicaRouter (prefix-affinity + block-aware "
                         "placement, idle replicas steal queued work)")
    ap.add_argument("--no-affinity", action="store_true",
                    help="multi-replica only: disable prefix-affinity "
                         "routing (requests place by block-aware load "
                         "alone)")
    ap.add_argument("--no-steal", action="store_true",
                    help="multi-replica only: disable work stealing (an "
                         "idle replica no longer pulls queued requests "
                         "off a backlogged peer)")
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
    ap.add_argument("--hipri-every", type=int, default=0, metavar="N",
                    help="mark every Nth request priority 1 (0 = all "
                         "requests priority 0); exercises SLO-aware "
                         "admission and preemption")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT SLO attached to the high-priority requests "
                         "(reported as slo_miss_rate)")
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
    ap.add_argument("--max-retries", type=int, default=2, metavar="N",
                    help="multi-replica only: reissue a request that "
                         "failed on one replica (poison fault, replica "
                         "crash) to a surviving replica up to N times "
                         "before marking it FAILED; retries restart from "
                         "the bare prompt, so greedy outputs are unchanged")
    ap.add_argument("--replica-roles", default=None, metavar="R1,R2,...",
                    help="disaggregated fleet: comma-separated per-replica "
                         "roles (prefill/decode/mixed, one per --replicas); "
                         "prefill-role replicas migrate each finished "
                         "prompt's KV blocks to a decode-capable replica "
                         "instead of decoding locally")
    ap.add_argument("--inject-faults", default=None, metavar="PLAN",
                    help="deterministic fault injection for chaos runs: "
                         "comma-separated site[:action[:after[:count]]] "
                         "specs (sites: target.compute engine.prefill "
                         "engine.decode kv.spill kv.fetch "
                         "replica.executor; actions: raise drop delay) or "
                         "seed=<int> for a random seeded plan -- e.g. "
                         "'replica.executor:raise:4,kv.fetch:drop'")
    ap.add_argument("--mode", choices=("continuous", "wave"),
                    default="continuous",
                    help="wave = lock-step decode (single replica only), "
                         "for A/B comparison")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args()
    if args.mode == "wave" and args.replicas > 1:
        ap.error("--mode wave is the single-replica legacy baseline; "
                 "drop --replicas or use --mode continuous")

    cfg = (arch_registry.smoke(args.arch) if args.smoke
           else arch_registry.config(args.arch))
    fns = fns_for(cfg)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu (with --smoke) to run "
                 "the plain versions on the CPU")
    gen = torch.Generator(device).manual_seed(0)
    # the transformer's product weights are stored in the compute dtype as
    # they are drawn, a layer at a time (the numbers the engine's
    # prepare_params gives): deepseek-moe-16b's fp32 tree (65.5 GB) would
    # not fit the card beside its bf16 copy
    params = (transformer.init(cfg, gen, cast_products=True)
              if fns is TRANSFORMER_FNS else fns.init(cfg, gen))
    max_len = args.prompt_len + args.new_tokens + 1
    rng = np.random.default_rng(0)
    mk_sampler = (greedy if args.temperature == 0
                  else lambda: temperature(args.temperature, top_k=40))
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens, sampler=mk_sampler())
            for i in range(args.requests)]
    if args.hipri_every:
        for r in reqs[::args.hipri_every]:
            r.priority = 1
            if args.slo_ttft_ms is not None:
                r.slo_ttft_s = args.slo_ttft_ms / 1e3
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
    roles = (args.replica_roles.split(",") if args.replica_roles
             else ["mixed"] * args.replicas)
    if len(roles) != args.replicas:
        ap.error(f"--replica-roles names {len(roles)} roles for "
                 f"--replicas {args.replicas}")
    if args.replicas == 1 and roles != ["mixed"]:
        ap.error("--replica-roles needs --replicas > 1 (a lone prefill "
                 "replica has nowhere to migrate blocks)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # every replica is built from the one set of weights, as the
    # reference's are; each engine keeps its own cast copy
    if args.replicas > 1:
        engines = [ServingEngine(cfg, params, name=f"replica{i}", role=role,
                                 **kw) for i, role in enumerate(roles)]
    else:
        engines = [ServingEngine(cfg, params, **kw)]
    del params, kw
    eng = engines[0]
    if args.replicas > 1:
        router = ReplicaRouter(engines, affinity=not args.no_affinity,
                               steal=not args.no_steal,
                               max_retries=args.max_retries)
        stats = router.serve(reqs)
        router.close()
    else:
        stats = (eng.serve_wave(reqs) if args.mode == "wave"
                 else eng.serve(reqs))
    print(f"requests={stats.requests} tokens={stats.tokens} "
          f"wall={stats.wall_s:.2f}s tok/s={stats.tokens_per_s:.2f}")
    print(f"ttft p50={_fmt_ms(stats.ttft_p50_s)} "
          f"p99={_fmt_ms(stats.ttft_p99_s)}  "
          f"tpot={_fmt_ms(stats.mean_tpot_s)}  "
          f"slot_occupancy={stats.slot_occupancy:.2f}")
    if eng.paged and args.mode != "wave":
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
    if args.replicas > 1:
        print(f"router: affinity_hits={stats.router_affinity_hits}  "
              f"steals={stats.router_steals}")
    if stats.spec_proposed:
        spt = (f"{stats.steps_per_token:.2f}"
               if stats.steps_per_token is not None else "n/a")
        print(f"spec: accept_rate={stats.accept_rate:.2f}  "
              f"verify_steps={stats.verify_steps}  "
              f"decode_steps={stats.decode_steps}  steps/token={spt}")
    if stats.kv_migrations:
        print(f"disagg: migrations={stats.kv_migrations}  "
              f"migrated_blocks={stats.migrated_blocks}")
    if stats.kv_spills or stats.kv_fetches:
        hit = (f"{stats.kv_hit_rate:.2f}"
               if stats.kv_hit_rate is not None else "n/a")
        print(f"tiering: spills={stats.kv_spills}  "
              f"fetches={stats.kv_fetches}  "
              f"host_hits={stats.prefix_hits_host}  "
              f"spill_bytes={stats.spill_bytes}  kv_hit_rate={hit}")
    if (stats.requests_failed or stats.requests_retried
            or stats.replica_failures or stats.shed_rejections
            or stats.faults_injected):
        print(f"faults: injected={stats.faults_injected}  "
              f"failed={stats.requests_failed}  "
              f"retried={stats.requests_retried}  "
              f"replica_failures={stats.replica_failures}  "
              f"shed={stats.shed_rejections}")
    if stats.preemptions or stats.prefix_shared_blocks or stats.slo_tracked:
        miss = (f"{stats.slo_miss_rate:.2f}"
                if stats.slo_miss_rate is not None else "n/a")
        print(f"preemptions={stats.preemptions}  "
              f"prefix_shared_blocks={stats.prefix_shared_blocks}  "
              f"slo_miss_rate={miss}")
    if device.type == "cuda":
        # power per card, not per replica: the replicas share the card
        name, watts = card_name_and_power_limit()
        print(f"{name} power.limit={watts:.0f}W  "
              f"tokens/s/W={stats.tokens_per_s / watts:.4f}"
              + (f"  ({args.replicas} replicas on this one card; peak "
                 f"memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
                 f" GiB)" if args.replicas > 1 else ""))
    else:
        print("tokens/s/W: not measured (CPU run)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
