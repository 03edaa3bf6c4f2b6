"""Rotary position embeddings (counterpart of
``repro/models/layers/rope.py``; M-RoPE waits for the VLM slice)."""
from __future__ import annotations

import numpy as np
import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), computed in numpy
    float32 exactly as the reference does."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    freqs = (1.0 / (theta ** exponents)).astype(np.float32)
    return torch.from_numpy(freqs).to(device)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) queries or keys; positions: (B, S) int absolute
    positions."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    angles = positions[..., None].float() * freqs                 # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]                        # (B, S, 1, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    return _rotate(x, cos, sin)
