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


def ssm_scan_backward_ref(q, k, v, log_decay, log_gate, dy, d_final=None, *,
                          chunk: int = 128, initial_state=None):
    """The gradient of :func:`ssm_scan_ref` given ``dy`` (B, S, H, P), the
    gradient of y, and ``d_final`` (B, H, N, P), that of the final state
    (None: 0), as explicit formulas in fp32 -- the decomposition the
    kernel computes (see ``csrc/ssm_scan_backward.cu``): the entering
    states recomputed chunk by chunk, the state's gradient carried back
    over the chunks, then each chunk's local terms.  Where a clamp at 30 is
    active the derivative is 0, as the reference's ``minimum`` gives.

    Returns (dq, dk (B, S, H, N), dv (B, S, H, P) in the inputs' dtypes;
    d log_decay, d log_gate (B, S, H) fp32 -- the latter None when
    ``log_gate`` is; d initial_state (B, H, N, P) fp32 or None).  fp64
    inputs are carried through in fp64 (to measure fp32's rounding)."""
    B, S, H, N = k.shape
    P = v.shape[-1]
    def wide(t):
        return t.to(torch.promote_types(t.dtype, torch.float32))
    qf, kf, vf = wide(q), wide(k), wide(v)
    ld = wide(log_decay)
    g = torch.zeros_like(ld) if log_gate is None else wide(log_gate)
    dyf = wide(dy)
    dt = ld.dtype

    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        def zpad(a):
            return F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
        qf, kf, vf, g, ld, dyf = map(zpad, (qf, kf, vf, g, ld, dyf))
        g[:, S:] = -1e30
    C = (S + pad) // chunk

    def cs(a):                      # (B, S', H, ...) -> (B, C, Q, H, ...)
        return a.reshape(B, C, chunk, *a.shape[2:])

    qc, kc, vc, dc, gc, dyc = map(cs, (qf, kf, vf, ld, g, dyf))
    cum = torch.cumsum(dc, dim=2)                   # (B, C, Q, H)
    total = cum[:, :, -1]                           # (B, C, H)

    # the forward's weights, and where each clamp lets a derivative through
    scores = torch.einsum("bcihn,bcjhn->bchij", qc, kc)
    cum_t = cum.transpose(2, 3)                     # (B, C, H, Q)
    logw = cum_t[..., :, None] - cum_t[..., None, :] \
        + gc.transpose(2, 3)[..., None, :]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    w = torch.where(causal, torch.exp(torch.clamp(logw, max=30.0)),
                    torch.zeros((), device=q.device))
    live_w = causal & (logw < 30.0)
    lk = total[:, :, None] - cum + gc               # (B, C, Q, H)
    wk = torch.exp(torch.clamp(lk, max=30.0))
    wq = torch.exp(torch.clamp(cum, max=30.0))

    # the states entering each chunk: H_c = exp(total_c) H_{c-1} + S_c
    s_c = torch.einsum("bcjhn,bcjhp->bchnp", kc * wk[..., None], vc)
    h = (torch.zeros((B, H, N, P), dtype=dt, device=q.device)
         if initial_state is None else wide(initial_state))
    h_prev = []
    for c in range(C):
        h_prev.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + s_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)             # (B, C, H, N, P)

    # the state's gradient, carried back: G_{c-1} = exp(total_c) G_c + U_c;
    # total_c collects exp(total_c) sum(G_c o H_{c-1})
    u_c = torch.einsum("bcihn,bcihp->bchnp", qc * wq[..., None], dyc)
    gst = (torch.zeros((B, H, N, P), dtype=dt, device=q.device)
           if d_final is None else wide(d_final))
    g_c, d_total = [None] * C, []
    for c in reversed(range(C)):
        g_c[c] = gst
        decay = torch.exp(total[:, c])
        d_total.append(decay * (gst * h_prev[:, c]).sum((-2, -1)))
        gst = decay[..., None, None] * gst + u_c[:, c]
    d_init = gst
    g_c = torch.stack(g_c, dim=1)                   # (B, C, H, N, P)
    d_total = torch.stack(d_total[::-1], dim=1)     # (B, C, H)

    # inter-chunk term y_off_i = wq_i q_i . H_{c-1}
    hdy = torch.einsum("bchnp,bcihp->bcihn", h_prev, dyc)
    dq = wq[..., None] * hdy
    d_cum = torch.where(cum < 30.0, (qc * hdy).sum(-1) * wq,
                        torch.zeros((), device=q.device))
    # chunk summary S_c = sum_j wk_j k_j v_j^T
    gv = torch.einsum("bchnp,bcjhp->bcjhn", g_c, vc)
    dk = wk[..., None] * gv
    dv = wk[..., None] * torch.einsum("bchnp,bcjhn->bcjhp", g_c, kc)
    d_lk = torch.where(lk < 30.0, (kc * gv).sum(-1) * wk,
                       torch.zeros((), device=q.device))
    d_total = d_total + d_lk.sum(2)
    d_cum = d_cum - d_lk
    d_g = d_lk
    # intra-chunk term y_diag_i = sum_j (q_i.k_j) w_ij v_j
    d_m = torch.einsum("bcihp,bcjhp->bchij", dyc, vc)
    dv = dv + torch.einsum("bchij,bcihp->bcjhp", scores * w, dyc)
    d_a = d_m * w
    dq = dq + torch.einsum("bchij,bcjhn->bcihn", d_a, kc)
    dk = dk + torch.einsum("bchij,bcihn->bcjhn", d_a, qc)
    d_logw = torch.where(live_w, d_a * scores, torch.zeros((), device=q.device))
    d_cum = d_cum + (d_logw.sum(-1) - d_logw.sum(-2)).transpose(2, 3)
    d_g = d_g + d_logw.sum(-2).transpose(2, 3)
    # total_c = cum_{Q-1}; cum the inclusive cumsum of the decay
    d_cum[:, :, -1] += d_total
    d_decay = torch.flip(torch.cumsum(torch.flip(d_cum, [2]), 2), [2])

    def back(a):                    # (B, C, Q, H, ...) -> (B, S, H, ...)
        return a.reshape(B, C * chunk, *a.shape[3:])[:, :S]
    return (back(dq).to(q.dtype), back(dk).to(k.dtype), back(dv).to(v.dtype),
            back(d_decay).contiguous(),
            None if log_gate is None else back(d_g).contiguous(),
            None if initial_state is None else d_init)
