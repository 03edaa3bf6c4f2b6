"""The paper's devices, for its TDP-normalized metric (counterpart of the
paper-device part of ``repro/roofline/hw.py``).  The card the port runs on
reports its own power limit (``nvidia-smi``); no constant here stands for
it."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    hbm_bandwidth: float        # bytes/s per chip
    ici_link_bandwidth: float   # bytes/s per link
    ici_links: int              # links per chip
    hbm_bytes: float            # device memory capacity per chip
    vmem_bytes: float           # on-chip scratchpad (CMX analogue)
    tdp_watts: float            # thermal design power per chip


# The paper's co-processor: Movidius Myriad 2 VPU (MA2450) on the NCS.
# 12 SHAVEs @600MHz; manufacturer-claimed 1000 Gflops FP16; CMX 2MB; TDP 0.9W
# (2.5W peak for the whole NCS stick, per the paper).
MYRIAD2_VPU = ChipSpec(
    name="myriad2-vpu",
    peak_flops_bf16=1e12,        # FP16 claimed peak
    hbm_bandwidth=4e9,           # LPDDR3 ballpark
    ici_link_bandwidth=0.4e9,    # USB 3.0 effective
    ici_links=1,
    hbm_bytes=4 * 1024**3,       # 4GB stacked LPDDR3
    vmem_bytes=2 * 1024**2,      # CMX
    tdp_watts=0.9,
)

# Reference devices from the paper's evaluation (TDP only is used).
XEON_E5_2609V2 = ChipSpec(
    name="xeon-e5-2609v2",
    peak_flops_bf16=80e9 * 4,    # 4 cores @2.5GHz, AVX fp32-ish; not used for roofline
    hbm_bandwidth=51.2e9,
    ici_link_bandwidth=8e9,
    ici_links=1,
    hbm_bytes=72 * 1024**3,
    vmem_bytes=10 * 1024**2,
    tdp_watts=80.0,
)
QUADRO_K4000 = ChipSpec(
    name="quadro-k4000",
    peak_flops_bf16=1.246e12,
    hbm_bandwidth=134e9,
    ici_link_bandwidth=8e9,
    ici_links=1,
    hbm_bytes=3 * 1024**3,
    vmem_bytes=0.5 * 1024**2,
    tdp_watts=80.0,
)
