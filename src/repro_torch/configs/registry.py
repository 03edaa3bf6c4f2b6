"""Registry of all assigned architectures (+ the paper's GoogLeNet)."""
from __future__ import annotations

from typing import Mapping

from repro_torch.configs import (command_r_plus_104b, deepseek_moe_16b, googlenet,
                           llama3_405b, qwen2_5_3b, qwen2_vl_72b, qwen3_32b,
                           qwen3_moe_235b_a22b, whisper_medium, xlstm_125m,
                           zamba2_1_2b)
from repro_torch.configs.base import ArchAssignment, ModelConfig

_MODULES = {
    "qwen2.5-3b": qwen2_5_3b,
    "command-r-plus-104b": command_r_plus_104b,
    "qwen3-32b": qwen3_32b,
    "llama3-405b": llama3_405b,
    "zamba2-1.2b": zamba2_1_2b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "xlstm-125m": xlstm_125m,
    "whisper-medium": whisper_medium,
}

ASSIGNED: Mapping[str, ArchAssignment] = {
    name: mod.ASSIGNMENT for name, mod in _MODULES.items()
}

SMOKE: Mapping[str, ModelConfig] = {
    name: mod.SMOKE for name, mod in _MODULES.items()
}

GOOGLENET = googlenet.CONFIG
GOOGLENET_FP16 = googlenet.CONFIG_FP16

ARCH_IDS = tuple(_MODULES)


def get(arch: str) -> ArchAssignment:
    if arch == "googlenet":
        return googlenet.ASSIGNMENT
    return ASSIGNED[arch]


def config(arch: str) -> ModelConfig:
    return get(arch).model


def smoke(arch: str) -> ModelConfig:
    if arch == "googlenet":
        return googlenet.SMOKE
    return SMOKE[arch]
