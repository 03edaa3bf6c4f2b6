"""xLSTM layers (counterpart of ``repro/models/layers/xlstm.py``): the
mLSTM (matrix memory, chunkwise-parallel) and the sLSTM (scalar memory with
recurrent weights, sequential).

The mLSTM is a decayed outer-product recurrence, so its prefill and its
training forward (:func:`mlstm_forward`) run the chunked scan through
:func:`repro_torch.kernels.ssm_scan.ops.ssm_scan` -- the hand-written CUDA
kernel (K5) on the card, its plain version on the CPU -- where the
reference calls the scan's oracle, ``chunked_linear_attn``.  The
max(|n.q|, 1) normalizer comes from a ones column appended to v, so the
scan runs at P = head width + 1 (xlstm-125m: N = 384, P = 385, on K5's
FMA body).  In training, once q, k or v requires grad, the scan goes
through ``_SsmScan`` and its gradient through K5's backward kernel, whose
FMA body walks N and P in slices at these widths; the ones column's
gradient carries d den into q, k and both gates, and ``_with_ones``'s
concatenation hands v's gradient back without it.  Decode
(:func:`mlstm_step`) is one recurrence step in plain PyTorch, as in the
reference, which has no kernel for it.

The sLSTM's hidden-to-gate recurrence runs as a loop of cell steps, the
reference's ``lax.scan`` (no Pallas kernel there); in training autograd
differentiates the loop as JAX differentiates the scan, each step's
recurrent product through K7's backward (dX and dW; the first step's h is
a constant, so dW alone there).  ``r``'s gradient reaches it through
:func:`recurrent_weight`'s einsum, which keeps only the diagonal
blocks.  Its head-block-diagonal
recurrent product goes through K7 as one launch a step on the
block-diagonal (D, 4 D) weight, built once a call by
:func:`recurrent_weight`: one launch reads 4x the weight's nonzeros but
saves three launches and a layout copy a step, and the host issues every
step.  ``chip_smoke.py``'s ``slstm_product_timing`` times both ways: on an
H100 the one launch was never the slower over 300 cell steps, and up to
twice as fast at four rows.
The zeros add exactly, so the product is the per-head one.

Every weight product goes through :func:`~repro_torch.models.layers.linear.
matmul` (K7).  Types follow the reference's: each weight is cast to the
block input's type, and a product meets the activation in the wider of the
two, as JAX promotes them; so a decode step whose conv history is fp32 (the
engine's batched state) computes that block in fp32.  Recurrence math is
fp32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models.layers.linear import matmul
from repro_torch.models.layers.module import ParamDef, bias, scale, weight
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.models.layers.ssm import _causal_conv1d, linear_attn_step

MLSTM_CHUNK = 128       # the reference's chunk; the clamps at 30 apply per chunk


def _cast(w, to, at):
    """``w`` cast to ``to`` (the reference's ``astype(x.dtype)``), then
    carried exactly into the product's type ``at``."""
    return w.to(to).to(at)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    conv: torch.Tensor    # (B, K-1, di)
    mem: torch.Tensor     # (B, H, N, P+1) fp32 -- last column: the normalizer


def _mlstm_dims(cfg):
    di = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    return di, cfg.num_heads, di // cfg.num_heads


def _forget_bias_init(gen, shape, dtype):
    """Forget-gate bias: positive (starts remembering), linspace [3, 6]."""
    return torch.linspace(3.0, 6.0, shape[0], device=gen.device).to(dtype)


def mlstm_table(cfg):
    d = cfg.d_model
    di, h, dh = _mlstm_dims(cfg)
    k = cfg.xlstm.conv1d_kernel
    return {
        "up_proj": weight((d, 2 * di), ("embed", "ff")),
        "conv_w": weight((k, di), ("conv", "ff"), stddev=0.2),
        "conv_b": bias((di,), ("ff",)),
        "wq": weight((di, h, dh), (None, "heads", None)),
        "wk": weight((di, h, dh), (None, "heads", None)),
        "wv": weight((di, h, dh), (None, "heads", None)),
        "w_i": weight((di, h), (None, "heads"), stddev=0.02),
        "b_i": bias((h,), ("heads",)),
        "w_f": weight((di, h), (None, "heads"), stddev=0.02),
        "b_f": ParamDef((h,), ("heads",), _forget_bias_init),
        "skip": scale((di,), ("ff",)),
        "norm": scale((di,), ("ff",)),
        "down_proj": weight((di, d), ("ff", "embed")),
    }


def _heads(x, w, dt):
    """x (..., di) @ w (di, h, dh) -> (..., h, dh), w cast to ``dt`` first."""
    di, h, dh = w.shape
    out = matmul(x, _cast(w, dt, x.dtype).reshape(di, h * dh))
    return out.reshape(*x.shape[:-1], h, dh)


def _mlstm_qkvg(cfg, params, x, conv_hist):
    """The shared projection path.  x: (B, S, D)."""
    di, _, dh = _mlstm_dims(cfg)
    up = matmul(x, params["up_proj"].to(x.dtype))
    xi, z = up[..., :di], up[..., di:]
    xc, new_hist = _causal_conv1d(xi, params["conv_w"].to(x.dtype),
                                  params["conv_b"].to(x.dtype), conv_hist)
    xc = F.silu(xc)
    q = _heads(xc, params["wq"], x.dtype)
    k = _heads(xc, params["wk"], x.dtype) / (dh ** 0.5)
    v = _heads(xi, params["wv"], x.dtype)
    log_f = F.logsigmoid(
        matmul(xc, _cast(params["w_f"], x.dtype, xc.dtype)).float()
        + params["b_f"].float())
    log_i = (matmul(xc, _cast(params["w_i"], x.dtype, xc.dtype)).float()
             + params["b_i"].float())
    log_i = torch.clamp(log_i, -30.0, 15.0)
    return q, k, v, log_f, log_i, xi, xc, z, new_hist


def _mlstm_out(cfg, params, num, den, xc, z, B, S):
    di, h, dh = _mlstm_dims(cfg)
    y = num / torch.clamp(den.abs(), min=1.0)                 # (B, S, H, dh)
    y = y.reshape(B, S, di).to(xc.dtype)
    y = y + params["skip"].to(xc.dtype) * xc
    y = y.reshape(B, S, h, dh).float()
    # head-wise RMS norm with a full-width scale (GroupNorm analogue)
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps)
    y = y.reshape(B, S, di) * params["norm"].float()
    y = y.to(xc.dtype) * F.silu(z)
    return matmul(y, params["down_proj"].to(y.dtype))


def _with_ones(v):
    """v (..., P) -> (..., P + 1): the normalizer's ones column."""
    return torch.cat([v, torch.ones((*v.shape[:-1], 1), dtype=v.dtype,
                                    device=v.device)], dim=-1)


def mlstm_forward(cfg, params, x, state: MLSTMState | None = None,
                  return_state: bool = False):
    """Full-sequence mLSTM.  x: (B, S, D) -> (B, S, D) [, the state after
    the last token].  The scan runs through the ``ssm_scan`` kernel at
    chunk 128, q, k and v meeting in the wider of their types (the scan
    reads them as fp32 either way)."""
    B, S, _ = x.shape
    q, k, v, log_f, log_i, _, xc, z, hist = _mlstm_qkvg(
        cfg, params, x, None if state is None else state.conv)
    dt = torch.promote_types(q.dtype, v.dtype)
    y, fin = ssm_scan(q.to(dt).contiguous(), k.to(dt).contiguous(),
                      _with_ones(v.to(dt)), log_f, log_i, chunk=MLSTM_CHUNK,
                      initial_state=None if state is None else state.mem)
    out = _mlstm_out(cfg, params, y[..., :-1], y[..., -1:], xc, z, B, S)
    if return_state:
        return out, MLSTMState(conv=hist, mem=fin)
    return out


def mlstm_step(cfg, params, x, state: MLSTMState):
    """x: (B, 1, D) single-token decode -> (B, 1, D), the new state."""
    B = x.shape[0]
    q, k, v, log_f, log_i, _, xc, z, hist = _mlstm_qkvg(
        cfg, params, x, state.conv)
    y, mem = linear_attn_step(q[:, 0], k[:, 0], _with_ones(v[:, 0]),
                              log_f[:, 0], log_i[:, 0], state.mem)
    y = y[:, None]                                            # (B, 1, H, P+1)
    out = _mlstm_out(cfg, params, y[..., :-1], y[..., -1:], xc, z, B, 1)
    return out, MLSTMState(conv=hist, mem=mem)


def mlstm_init_state(cfg, batch: int, dtype=torch.float32, *,
                     device="cuda") -> MLSTMState:
    di, h, dh = _mlstm_dims(cfg)
    return MLSTMState(
        conv=torch.zeros((batch, cfg.xlstm.conv1d_kernel - 1, di),
                         dtype=dtype, device=device),
        mem=torch.zeros((batch, h, dh, dh + 1), dtype=torch.float32,
                        device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    h: torch.Tensor   # (B, D) fp32
    c: torch.Tensor   # (B, D) fp32
    n: torch.Tensor   # (B, D) fp32
    m: torch.Tensor   # (B, D) fp32 stabilizer


def slstm_table(cfg):
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    dff = int(cfg.xlstm.slstm_proj_factor * d)
    return {
        # input projections for (i, f, z, o)
        "w_in": weight((d, 4, d), ("embed", None, "ff"), stddev=0.02),
        "b_in": bias((4, d), (None, "ff")),
        # head-block-diagonal recurrent weights
        "r": weight((h, dh, 4, dh), ("heads", None, None, None), stddev=0.02),
        "norm": scale((d,), ("embed",)),
        # post-cell gated MLP (proj factor 4/3)
        "up_gate": weight((d, dff), ("embed", "ff")),
        "up": weight((d, dff), ("embed", "ff")),
        "down": weight((dff, d), ("ff", "embed")),
    }


def recurrent_weight(r):
    """r (H, dh, 4, dh) -> the block-diagonal (D, 4 D) fp32 weight W with
    W[h dh + k, g D + h dh + j] = r[h, k, g, j]: ``h_{t-1} @ W`` is the
    reference's ``einsum("bhk,hkgj->bghj")`` laid out as (B, 4, D)."""
    H, dh = r.shape[0], r.shape[1]
    eye = torch.eye(H, dtype=torch.float32, device=r.device)
    return torch.einsum("hkgj,hl->hkglj", r.float(), eye).reshape(H * dh,
                                                                  4 * H * dh)


def _slstm_cell(pre, st: SLSTMState) -> SLSTMState:
    """One timestep from the gates' pre-activations pre (B, 4, D) fp32:
    the input's contribution plus the recurrent product."""
    it, ft, zt, ot = pre.unbind(1)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + st.m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + st.m - m_new)
    c_new = f_p * st.c + i_p * torch.tanh(zt)
    n_new = f_p * st.n + i_p
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
    return SLSTMState(h=h_new, c=c_new, n=n_new, m=m_new)


def slstm_forward(cfg, params, x, state: SLSTMState | None = None,
                  return_state: bool = False):
    """x: (B, S, D).  A loop of S cell steps (the true recurrence), then the
    norm and the gated MLP."""
    B, S, d = x.shape
    if state is None:
        state = slstm_init_state(cfg, B, device=x.device)
    wx = matmul(x, params["w_in"].to(x.dtype).reshape(d, 4 * d))
    wx = (wx.reshape(B, S, 4, d) + params["b_in"].to(x.dtype)).float()
    r_bd = recurrent_weight(params["r"])
    hs = []
    for t in range(S):
        pre = wx[:, t] + matmul(state.h, r_bd).reshape(B, 4, d)
        state = _slstm_cell(pre, state)
        hs.append(state.h)
    y = torch.stack(hs, dim=1).to(x.dtype)                    # (B, S, D)
    y = rmsnorm({"scale": params["norm"]}, y, cfg.norm_eps)
    g = matmul(y, params["up_gate"].to(x.dtype))
    u = matmul(y, params["up"].to(x.dtype))
    out = matmul(F.gelu(g, approximate="tanh") * u, params["down"].to(x.dtype))
    if return_state:
        return out, state
    return out


def slstm_step(cfg, params, x, state: SLSTMState):
    return slstm_forward(cfg, params, x, state, return_state=True)


def slstm_init_state(cfg, batch: int, *, device="cuda") -> SLSTMState:
    """Zero h, c, n and a -1e30 stabilizer, each a tensor of its own (the
    engine writes the batched state's leaves in place)."""
    def full(value):
        return torch.full((batch, cfg.d_model), value, dtype=torch.float32,
                          device=device)
    return SLSTMState(h=full(0.0), c=full(0.0), n=full(0.0), m=full(-1e30))
