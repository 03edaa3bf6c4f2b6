"""Plain PyTorch version of the chunked SSD / decayed linear-attention scan:
the port of ``repro/models/layers/ssm.py::chunked_linear_attn`` (the
oracle of ``repro/kernels/ssm_scan``), returning the final state too.

    H_t = exp(d_t) H_{t-1} + exp(g_t) k_t v_t^T ;   y_t = q_t . H_t

Quadratic attention inside each chunk, a scan over the per-chunk states
between them; the reference's associative scan over chunks is a loop here
(the same recurrence, summed in order).  All arithmetic is fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssm_scan_ref(q, k, v, log_decay, log_gate=None, *, chunk: int = 128,
                 initial_state=None):
    """q, k: (B, S, H, N); v: (B, S, H, P); log_decay, log_gate: (B, S, H)
    (``log_gate`` None -> 0); initial_state: (B, H, N, P) or None.

    Returns (y (B, S, H, P) fp32, final_state (B, H, N, P) fp32).  A ragged
    S is padded to a multiple of ``min(chunk, S)`` with identity steps:
    decay 0 in log space and gate -1e30, as the reference pads.
    """
    B, S, H, N = k.shape
    P = v.shape[-1]
    q, k, v = q.float(), k.float(), v.float()
    log_decay = log_decay.float()
    g = (torch.zeros_like(log_decay) if log_gate is None
         else log_gate.float())

    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        def zpad(a):
            return F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
        q, k, v, g, log_decay = map(zpad, (q, k, v, g, log_decay))
        g[:, S:] = -1e30
    C = (S + pad) // chunk

    def cs(a):                      # (B, S', H, ...) -> (B, C, Q, H, ...)
        return a.reshape(B, C, chunk, *a.shape[2:])

    qc, kc, vc, dc, gc = map(cs, (q, k, v, log_decay, g))
    cum = torch.cumsum(dc, dim=2)                   # (B, C, Q, H) inclusive
    total = cum[:, :, -1]                           # (B, C, H)

    # intra-chunk: w[i, j] = exp(cum_i - cum_j + g_j) for i >= j
    scores = torch.einsum("bcihn,bcjhn->bchij", qc, kc)
    cum_t = cum.transpose(2, 3)                     # (B, C, H, Q)
    logw = cum_t[..., :, None] - cum_t[..., None, :] \
        + gc.transpose(2, 3)[..., None, :]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    w = torch.where(causal, torch.exp(torch.clamp(logw, max=30.0)),
                    torch.zeros((), device=q.device))
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores * w, vc)

    # per-chunk summary: S_c = sum_j exp(total - cum_j + g_j) k_j v_j^T
    wk = torch.exp(torch.clamp(total[:, :, None] - cum + gc, max=30.0))
    s_c = torch.einsum("bcjhn,bcjhp->bchnp", kc * wk[..., None], vc)

    # between chunks: H_c = exp(total_c) H_{c-1} + S_c; chunk c sees H_{c-1}
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    h_prev = []
    for c in range(C):
        h_prev.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + s_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)             # (B, C, H, N, P)

    # inter-chunk: y_off_i = exp(cum_i) q_i . H_prev
    wq = torch.exp(torch.clamp(cum, max=30.0))
    y_off = torch.einsum("bcihn,bchnp->bcihp", qc * wq[..., None], h_prev)
    y = (y_diag + y_off).reshape(B, C * chunk, H, P)[:, :S]
    return y, h
