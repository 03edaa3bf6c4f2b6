"""Mamba-2 (SSD) mixer (counterpart of ``repro/models/layers/ssm.py``,
``:114-271``).

Prefill (:func:`mamba_forward`) runs the chunked scan through
:func:`repro_torch.kernels.ssm_scan.ops.ssm_scan` -- the hand-written CUDA
kernel on the card, its plain version on the CPU -- where the reference
calls the scan's oracle, ``chunked_linear_attn``.  Decode
(:func:`mamba_step`) is one recurrence step in plain PyTorch, as in the
reference, which has no kernel for it.  Recurrence math is fp32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.common import dtype_of, truncated_normal_init
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models.layers.linear import matmul
from repro_torch.models.layers.module import ParamDef, bias, scale, weight
from repro_torch.models.layers.norms import rmsnorm


def linear_attn_step(q, k, v, log_decay, log_gate, state):
    """Single-token recurrence (decode).  q/k (B, H, N), v (B, H, P),
    log_decay/log_gate (B, H), state (B, H, N, P).  Returns (y, new_state),
    both fp32."""
    a = torch.exp(log_decay.float())[..., None, None]
    gate = torch.exp(torch.clamp(log_gate.float(), max=30.0))[..., None, None]
    kv = torch.einsum("bhn,bhp->bhnp", k.float(), v.float())
    new_state = a * state.float() + gate * kv
    y = torch.einsum("bhn,bhnp->bhp", q.float(), new_state)
    return y, new_state


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_channels)
    ssm: torch.Tensor    # (B, H, N, P) fp32


def _a_log_init(gen, shape, dtype):
    # A in [1, 16) log-spaced (Mamba-2 default init)
    h = shape[0]
    a = 1.0 + 15.0 * (torch.arange(h, dtype=torch.float32,
                                   device=gen.device) + 0.5) / h
    return torch.log(a).to(dtype_of(dtype))


def _dt_bias_init(gen, shape, dtype):
    # softplus^-1 of dt in [1e-3, 1e-1], log-spaced
    h = shape[0]
    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), h,
                                  device=gen.device))
    return torch.log(torch.expm1(dt)).to(dtype_of(dtype))


def _conv_w_init(gen, shape, dtype):
    return truncated_normal_init(gen, shape, dtype, stddev=0.2)


def mamba_table(cfg):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    h = s.num_heads(d)
    n = s.d_state
    conv_ch = d_in + 2 * n
    return {
        # order: [z (d_in) | x (d_in) | B (n) | C (n) | dt (h)]
        "in_proj": weight((d, 2 * d_in + 2 * n + h), ("embed", "ff")),
        "conv_w": ParamDef((s.d_conv, conv_ch), ("conv", "ff"), _conv_w_init),
        "conv_b": bias((conv_ch,), ("ff",)),
        "a_log": ParamDef((h,), (None,), _a_log_init),
        "d_skip": scale((h,), (None,)),
        "dt_bias": ParamDef((h,), (None,), _dt_bias_init),
        "norm": scale((d_in,), ("ff",)),
        "out_proj": weight((d_in, d), ("ff", "embed")),
    }


def _causal_conv1d(x, w, b, history=None):
    """x: (B, S, Ch); w: (K, Ch) depthwise; history: (B, K-1, Ch) or None.
    Returns (y, new_history).  A history of another type than x meets it
    in the wider one, as the reference's concatenate promotes them."""
    K = w.shape[0]
    if history is None:
        history = torch.zeros((x.shape[0], K - 1, x.shape[2]),
                              dtype=x.dtype, device=x.device)
    xh = torch.cat([history, x], dim=1)
    # depthwise conv as a sum of shifted slices (K is tiny, typically 4)
    y = sum(xh[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(K))
    y = y + b[None, None, :]
    new_hist = xh[:, -(K - 1):, :] if K > 1 else history
    return y, new_hist


def _mamba_split(cfg, params, u):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    h = s.num_heads(cfg.d_model)
    n = s.d_state
    proj = matmul(u, params["in_proj"].to(u.dtype))
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * n]
    dt_raw = proj[..., -h:]
    return z, xbc, dt_raw, (d_in, h, n)


def mamba_forward(cfg, params, u, state: MambaState | None = None,
                  return_state: bool = False):
    """Full-sequence Mamba-2 mixer.  u: (B, S, D) -> (B, S, D) [, the
    state after the last token].  The scan runs through the ``ssm_scan``
    kernel, with B and C -- one group shared by all heads -- handed over as
    a stride-0 head view, not a copy per head."""
    s = cfg.ssm
    B, S, _ = u.shape
    z, xbc, dt_raw, (d_in, h, n) = _mamba_split(cfg, params, u)
    xbc, conv_hist = _causal_conv1d(
        xbc, params["conv_w"].to(u.dtype), params["conv_b"].to(u.dtype),
        None if state is None else state.conv)
    xbc = F.silu(xbc)
    x = xbc[..., :d_in].reshape(B, S, h, s.head_dim)
    b_in = xbc[..., d_in:d_in + n]                      # (B, S, N) one group
    c_in = xbc[..., d_in + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())   # (B, S, H)
    a = -torch.exp(params["a_log"].float())                        # (H,)
    log_decay = dt * a[None, None, :]

    def heads(t):       # (B, S, N) -> (B, S, H, N), stride 0 over heads
        return t.contiguous()[:, :, None, :].expand(B, S, h, n)

    y, fin = ssm_scan(heads(c_in), heads(b_in), x.contiguous(), log_decay,
                      torch.log(dt), chunk=s.chunk_size,
                      initial_state=None if state is None else state.ssm)
    y = y + params["d_skip"].float()[None, None, :, None] * x.float()
    y = y.reshape(B, S, d_in).to(u.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm"]}, y, cfg.norm_eps)
    out = matmul(y, params["out_proj"].to(u.dtype))
    if return_state:
        return out, MambaState(conv=conv_hist, ssm=fin)
    return out


def mamba_step(cfg, params, u, state: MambaState):
    """Single-token decode.  u: (B, 1, D) -> (B, 1, D), new state."""
    s = cfg.ssm
    B = u.shape[0]
    z, xbc, dt_raw, (d_in, h, n) = _mamba_split(cfg, params, u)
    xbc, conv_hist = _causal_conv1d(
        xbc, params["conv_w"].to(u.dtype), params["conv_b"].to(u.dtype),
        state.conv)
    xbc = F.silu(xbc)
    x = xbc[:, 0, :d_in].reshape(B, h, s.head_dim)
    b_in = xbc[:, 0, None, d_in:d_in + n].expand(B, h, n)
    c_in = xbc[:, 0, None, d_in + n:].expand(B, h, n)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"].float())  # (B, H)
    a = -torch.exp(params["a_log"].float())
    y, new_ssm = linear_attn_step(c_in, b_in, x, dt * a[None, :],
                                  torch.log(dt), state.ssm)
    y = y + params["d_skip"].float()[None, :, None] * x.float()
    y = y.reshape(B, 1, d_in).to(u.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm"]}, y, cfg.norm_eps)
    out = matmul(y, params["out_proj"].to(u.dtype))
    return out, MambaState(conv=conv_hist, ssm=new_ssm)


def mamba_init_state(cfg, batch: int, dtype=torch.float32, *,
                     device="cuda") -> MambaState:
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    h = s.num_heads(cfg.d_model)
    return MambaState(
        conv=torch.zeros((batch, s.d_conv - 1, d_in + 2 * s.d_state),
                         dtype=dtype_of(dtype), device=device),
        ssm=torch.zeros((batch, h, s.d_state, s.head_dim),
                        dtype=torch.float32, device=device))
