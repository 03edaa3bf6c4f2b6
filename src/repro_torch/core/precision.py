"""Precision policies + the paper's section 4.2 error-delta estimators
(counterpart of ``repro/core/precision.py``).

The paper checks that FP16 on the VPU is inference-safe vs the FP32 CPU
reference: (a) top-1 error differs by only 0.09 %, (b) mean absolute
confidence difference (on top-1-correct images) is 0.44 %.  Both
estimators are reproduced exactly (numpy); the policies cover fp16 (the
paper's VPU precision) and bf16.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.common import dtype_of
from repro_torch.models.layers.module import tree_map


@dataclass(frozen=True)
class PrecisionPolicy:
    """What dtype each tensor class uses."""
    name: str
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    cache_dtype: str = "bfloat16"

    def apply_to_config(self, cfg):
        return cfg.replace(param_dtype=self.param_dtype,
                           compute_dtype=self.compute_dtype)

    def cast_params(self, params):
        """Every floating tensor of ``params`` cast to ``param_dtype``."""
        dt = dtype_of(self.param_dtype)
        return tree_map(lambda t: t.to(dt) if t.is_floating_point() else t,
                        params)


FP32 = PrecisionPolicy("fp32")
BF16 = PrecisionPolicy("bf16", param_dtype="float32",
                       compute_dtype="bfloat16")
FP16 = PrecisionPolicy("fp16", param_dtype="float16",
                       compute_dtype="float16", cache_dtype="float16")
POLICIES = {p.name: p for p in (FP32, BF16, FP16)}


# --- paper section 4.2 estimators --------------------------------------------

def top1_error_rate(probs: np.ndarray, labels: np.ndarray) -> float:
    """Fraction of images whose argmax != label (top-1 estimation)."""
    pred = np.argmax(probs, axis=-1)
    return float(np.mean(pred != labels))


def top1_delta(probs_a: np.ndarray, probs_b: np.ndarray,
               labels: np.ndarray) -> float:
    """|top-1 error(a) - top-1 error(b)| (paper Fig 7a quantity)."""
    return abs(top1_error_rate(probs_a, labels) -
               top1_error_rate(probs_b, labels))


def confidence_delta(probs_a: np.ndarray, probs_b: np.ndarray,
                     labels: np.ndarray) -> float:
    """Mean |confidence_a - confidence_b| over images both predict correctly
    ("after filtering the top-1 miss-predictions", paper Fig 7b)."""
    pa, pb = np.argmax(probs_a, -1), np.argmax(probs_b, -1)
    both = (pa == labels) & (pb == labels)
    if not np.any(both):
        return float("nan")
    ca = np.max(probs_a, -1)[both]
    cb = np.max(probs_b, -1)[both]
    return float(np.mean(np.abs(ca - cb)))


def prediction_agreement(probs_a: np.ndarray, probs_b: np.ndarray) -> float:
    """Fraction of inputs where both precisions pick the same top-1 class."""
    return float(np.mean(np.argmax(probs_a, -1) == np.argmax(probs_b, -1)))
