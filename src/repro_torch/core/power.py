"""Power accounting (paper section 5, Eq. 1): Throughput_Watt = (items/s) /
TDP (counterpart of ``repro/core/power.py``, without the TPU target).

The paper's devices have their TDPs in :mod:`repro_torch.roofline.hw`; for
the card, the caller passes the power limit ``nvidia-smi`` reports.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.roofline.hw import MYRIAD2_VPU, QUADRO_K4000, XEON_E5_2609V2

# Paper-calibrated single-inference latencies (Fig 6b normalization bases).
PAPER_LATENCY_S = {
    "vpu": 0.1007,     # Myriad 2 VPU, single NCS
    "cpu": 0.0260,     # dual Xeon E5-2609v2, Caffe-MKL
    "gpu": 0.0259,     # Quadro K4000, Caffe-cuDNN
}

PAPER_TDP_W = {
    "vpu": MYRIAD2_VPU.tdp_watts,        # 0.9 W chip (2.5 W stick peak)
    "cpu": XEON_E5_2609V2.tdp_watts,     # 80 W
    "gpu": QUADRO_K4000.tdp_watts,       # 80 W
}


def throughput_per_watt(items_per_s: float, tdp_watts: float) -> float:
    """Paper Eq. (1)."""
    return items_per_s / tdp_watts


def joules_per_item(items_per_s: float, tdp_watts: float) -> float:
    return tdp_watts / items_per_s if items_per_s else float("inf")


@dataclass(frozen=True)
class PowerReport:
    device: str
    n_devices: int
    items_per_s: float
    tdp_watts_total: float

    @property
    def items_per_watt(self) -> float:
        return throughput_per_watt(self.items_per_s, self.tdp_watts_total)

    @property
    def joules_per_item(self) -> float:
        return joules_per_item(self.items_per_s, self.tdp_watts_total)

    def row(self) -> str:
        return (f"{self.device:>14s} x{self.n_devices:<3d} "
                f"{self.items_per_s:10.2f} items/s  "
                f"{self.tdp_watts_total:8.1f} W  "
                f"{self.items_per_watt:8.3f} items/W  "
                f"{self.joules_per_item:8.3f} J/item")


def report(device: str, n_devices: int, items_per_s: float,
           *, per_device_watts: float | None = None) -> PowerReport:
    """Eq. 1 over ``n_devices``.  ``per_device_watts`` defaults to the
    paper's TDP for its devices ("vpu", "cpu", "gpu"); any other device
    must pass its own (for the card: its ``nvidia-smi`` power limit)."""
    if per_device_watts is None:
        if device not in PAPER_TDP_W:
            raise ValueError(f"no TDP known for {device!r}: pass "
                             f"per_device_watts")
        per_device_watts = PAPER_TDP_W[device]
    return PowerReport(device=device, n_devices=n_devices,
                       items_per_s=items_per_s,
                       tdp_watts_total=per_device_watts * n_devices)
