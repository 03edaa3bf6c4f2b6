"""Rotary position embeddings: standard RoPE and Qwen2-VL's multimodal
M-RoPE (counterpart of ``repro/models/layers/rope.py``)."""
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


def m_rope_streams(sections: tuple[int, ...]) -> np.ndarray:
    """The position stream each frequency slot reads, (sum(sections),)
    int64: slot i of section j reads stream j, in numpy as the
    reference's ``np.repeat``."""
    return np.repeat(np.arange(len(sections)), sections)


def apply_m_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                 sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D); positions: (3, B, S) int
    temporal / height / width ids (three equal streams for text); the
    D // 2 frequency slots are split into ``sections`` (sum D // 2), each
    slot rotated by its own stream's angle.  The rotation in fp32."""
    d_half = x.shape[-1] // 2
    if sum(sections) != d_half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to D/2 = {d_half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    stream = torch.from_numpy(m_rope_streams(sections)).to(x.device)
    # each slot's position from its stream: (B, S, D/2)
    pos = positions.movedim(0, -1)[..., stream].float()
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]                        # (B, S, 1, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    return _rotate(x, cos, sin)
