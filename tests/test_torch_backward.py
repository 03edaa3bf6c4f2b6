"""The backward kernels' plain versions, and the differentiable wrappers
around K4 and K5, against the JAX package on the CPU at fp32.

* K5's backward (``ssm_scan_backward_ref``) against ``jax.vjp`` of the
  reference scan ``chunked_linear_attn`` (B=2, H=4, N=P=16, chunk 32; S 64
  and a ragged 45; with and without the gate, an initial state and a
  nonzero final-state gradient; a gate past the clamp at 30), and against
  ``torch.autograd`` of the plain forward ``ssm_scan_ref``.
* K4's backward (``flash_attention_backward_ref``) against ``jax.vjp`` of
  the reference attention ``chunked_attention`` (causal and full, G = 1, 2,
  4, D = 16, S 37 and 64), and the forward's log-sum-exp.
* Each output within 1e-5 of its own largest entry: the same fp32
  formulas summed in other orders (1e-7 to 1e-6 is read).
* The Mamba-2 mixer's gradients through the differentiable ``ssm_scan``
  (q and k as stride-0 head views, summed over heads by autograd) against
  ``jax.grad`` of the reference mixer.
* K4's backward on the tensor cores: its rounding (P and dS carried as
  bf16 hi + lo pairs) modelled in fp32 at the card's training heads,
  within 0.9 of the bf16 limit against fp64, and past it without the lo
  halves; its route; the ctypes signatures of K4 and its backward.
* K5's backward on the tensor cores: its rounding (every fp32 operand
  as a bf16 hi + lo pair, a product of two fp32 operands as three
  products) modelled in fp32 at zamba2-1.2b's widths, within 0.9 of the
  limit against fp64, and past it with the fp32 operands as bf16 alone or
  a fp32 x fp32 product as two; its route; its ctypes signature.
* The differentiable wrappers (K4, K5, K7) keep a ``grad_fn`` and count
  their plain calls; ``build.load`` builds and loads a library once when
  two threads ask for it at once.
"""
import ctypes
import re
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as JR
from repro.models.layers import ssm as JS
from repro.models.layers.attention import chunked_attention
from repro.models.layers.module import init_table
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_lse,
                                                     flash_attention_backward_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_backward_ref, ssm_scan_ref
from repro_torch.models.layers import ssm as TS
from repro_torch.models.layers.linear import matmul

torch.set_num_threads(1)

RTOL = 1e-5     # each gradient, of its largest entry


def _rel(t, j):
    t = t.detach().double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j, dtype=np.float64)
    assert t.shape == j.shape
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def _scan_operands(S, *, gate=True, clamp=False, seed=0, B=2, H=4, N=16, P=16):
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((B, S, H, N))).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, S, H, N))).astype(np.float32)
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ld = (-0.3 * np.abs(rng.standard_normal((B, S, H)))).astype(np.float32)
    lg = (0.5 * rng.standard_normal((B, S, H))).astype(np.float32)
    if clamp:       # every 7th step's gate past 30: its weights clamp
        lg[:, ::7] += 31.0
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    df = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return q, k, v, ld, lg if gate else None, h0, dy, df


SCAN_CASES = [  # (S, gate, initial state and d_final, a gate past the clamp)
    (64, True, True, False), (45, True, True, False), (64, False, False, False),
    (45, False, True, False), (64, True, False, False), (45, True, True, True),
    (64, True, False, True)]


def _scan_backward_vs_jax_vjp(operands, state, chunk):
    """The plain backward against ``jax.vjp`` of the reference scan on the
    same operands, each gradient within ``RTOL`` of its largest entry."""
    q, k, v, ld, lg, h0, dy, df = operands

    def f(q, k, v, ld, lg, h0):
        return JS.chunked_linear_attn(q, k, v, ld, lg, chunk=chunk, initial_state=h0,
                                      return_final_state=True)
    args = [jnp.asarray(a) if a is not None else None for a in (q, k, v, ld, lg)]
    j0 = jnp.asarray(h0) if state else None
    live = [i for i, a in enumerate(args + [j0]) if a is not None]

    def g(*xs):
        full = list(args + [j0])
        for i, x in zip(live, xs):
            full[i] = x
        return f(*full)
    (y, fin), vjp = jax.vjp(g, *[(args + [j0])[i] for i in live])
    jd = vjp((jnp.asarray(dy), jnp.asarray(df) if state else jnp.zeros_like(fin)))
    T = torch.from_numpy
    td = ssm_scan_backward_ref(T(q), T(k), T(v), T(ld), None if lg is None else T(lg),
                               T(dy), T(df) if state else None, chunk=chunk,
                               initial_state=T(h0) if state else None)
    assert (td[4] is None) == (lg is None) and (td[5] is None) == (not state)
    td = [t for t in td if t is not None]
    assert len(td) == len(jd)
    for t, j in zip(td, jd):
        assert _rel(t, j) <= RTOL


@pytest.mark.parametrize("S,gate,state,clamp", SCAN_CASES)
def test_scan_backward_matches_jax_vjp(S, gate, state, clamp):
    operands = _scan_operands(S, gate=gate, clamp=clamp)
    _scan_backward_vs_jax_vjp(operands, state, 32)
    if clamp:       # a step's own weight exp(min(g, 30)) clamps
        assert (operands[4] > 30.0).any()


@pytest.mark.parametrize("den_only", [False, True])
def test_scan_backward_matches_jax_vjp_at_xlstm_widths(den_only):
    """xlstm-125m's mLSTM widths (N = 384, P = 385: v's last column the
    normalizer's ones, as ``xlstm._with_ones`` appends it), per-head q/k,
    chunk 128, S = 200 (two chunks, the second ragged), with h0 and
    d_final; ``den_only``: dy and d_final zero but in that last column, the
    gradient of the normalizer alone, which reaches q, k and both gates."""
    q, k, v, ld, lg, h0, dy, df = _scan_operands(200, seed=5, B=1, H=2, N=384, P=385)
    q, k = q / 10.0, k / 10.0          # q.k of order 1, as k / sqrt(N) makes it
    v[..., -1] = 1.0
    if den_only:
        dy[..., :-1] = 0.0
        df[..., :-1] = 0.0
    _scan_backward_vs_jax_vjp((q, k, v, ld, lg, h0, dy, df), True, 128)


@pytest.mark.parametrize("S,state", [(45, True), (64, False)])
def test_scan_backward_matches_autograd_of_the_plain_forward(S, state):
    q, k, v, ld, lg, h0, dy, df = _scan_operands(S, clamp=True, seed=3)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, ld, lg)]
    t0 = torch.from_numpy(h0).requires_grad_(True) if state else None
    y, fin = ssm_scan_ref(*ts, chunk=32, initial_state=t0)
    loss = (y * torch.from_numpy(dy)).sum()
    if state:
        loss = loss + (fin * torch.from_numpy(df)).sum()
    loss.backward()
    want = [t.grad for t in ts] + ([t0.grad] if state else [])
    T = torch.from_numpy
    got = ssm_scan_backward_ref(T(q), T(k), T(v), T(ld), T(lg), T(dy),
                                T(df) if state else None, chunk=32,
                                initial_state=T(h0) if state else None)
    got = [g for g in got if g is not None]
    for g, w in zip(got, want):
        assert _rel(g, w.numpy()) <= RTOL


def test_scan_clamp_derivative_is_zero_above_30():
    """With no decay every weight of step j is exp(min(g_j, 30)): where the
    gate is past 30 all of them clamp, and the gate's gradient is exactly
    0 (the reference's minimum), where exp(g) would give it one."""
    q, k, v, ld, lg, h0, dy, df = _scan_operands(32, clamp=True, seed=5)
    ld[:] = 0.0
    T = torch.from_numpy
    d = ssm_scan_backward_ref(T(q), T(k), T(v), T(ld), T(lg), T(dy), chunk=32)
    clamped = lg > 30.0
    assert clamped.any() and (~clamped).any()
    np.testing.assert_array_equal(d[4].numpy()[clamped], 0.0)
    assert (d[4].numpy()[~clamped] != 0.0).all()
    _, vjp = jax.vjp(lambda g: JS.chunked_linear_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ld), g, chunk=32)[0],
        jnp.asarray(lg))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(dy))[0])[clamped], 0.0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("S", [37, 64])
def test_attention_backward_matches_jax_vjp(causal, G, S):
    rng = np.random.default_rng(S * 10 + G)
    B, K, D = 2, 2, 16
    H = K * G
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: chunked_attention(q, k, v, causal=causal, chunk=16),
                       *map(jnp.asarray, (q, k, v)))
    jd = vjp(jnp.asarray(do))
    T = torch.from_numpy
    o, lse = flash_attention_ref(T(q), T(k), T(v), causal=causal, chunk=16, with_lse=True)
    assert _rel(o, out) <= RTOL
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    td = flash_attention_backward_ref(T(q), T(k), T(v), o, T(do), lse, causal=causal)
    for t, j in zip(td, jd):
        assert _rel(t, j) <= RTOL


def test_attention_lse_is_each_rows_normaliser():
    """exp(s - lse) sums to 1 over each row's visible keys."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 9, 2, 16)).astype(np.float32))
    lse = attention_lse(q, k, causal=True)
    kk = k.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / 4.0
    s = s.masked_fill(torch.ones(9, 9, dtype=torch.bool).triu(1), -1e30)
    torch.testing.assert_close(torch.exp(s - lse[..., None]).sum(-1),
                               torch.ones(1, 4, 9), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind,S,H,K,D", [("attention", 512, 16, 2, 128),
                                          ("attention", 512, 32, 32, 64),
                                          ("attention", 333, 32, 32, 64),
                                          ("scan", 512, 64, 0, 64), ("scan", 1000, 64, 0, 64)])
def test_plain_backwards_round_well_inside_the_card_limit(kind, S, H, K, D):
    """The plain backwards' own fp32 rounding at the card's shapes (K4 at
    qwen2.5-3b's and zamba2-1.2b's training heads, K5 at zamba2's widths
    with B and C shared by every head, the second case with a state and
    d_final): against the same formulas carried in fp64, each gradient
    within 1/16 of ``dispatch.GRAD_RTOL``'s fp32 limit, so two right fp32
    sums sit well inside it (2.6e-7 to 1.4e-6 of the largest is read)."""
    g = torch.Generator().manual_seed(1)
    if kind == "attention":
        q = torch.randn((1, S, H, D), generator=g)
        k, v = (torch.randn((1, S, K, D), generator=g) for _ in range(2))
        do = torch.randn((1, S, H, D), generator=g)
        out, lse = flash_attention_ref(q, k, v, with_lse=True)
        args, kw, fn = (q, k, v, out, do, lse), {}, flash_attention_backward_ref
    else:
        q, k = (torch.randn((1, S, 1, D), generator=g).expand(1, S, H, D) for _ in range(2))
        v = torch.randn((1, S, H, D), generator=g)
        log_dt = torch.empty((1, S, H)).uniform_(-6.9078, -2.3026, generator=g)
        ld = -torch.exp(log_dt) * (1.0 + 15.0 * (torch.arange(H) + 0.5) / H)
        state = S == 1000
        h0, df = ((torch.randn((1, H, D, D), generator=g) for _ in range(2)) if state
                  else (None, None))
        dy = torch.randn((1, S, H, D), generator=g)
        args, kw, fn = (q, k, v, ld, log_dt, dy, df), {"initial_state": h0}, \
            ssm_scan_backward_ref
    f32 = fn(*args, **kw)

    def wide(t):
        return None if t is None else t.double()
    f64 = fn(*map(wide, args), **{n: wide(t) for n, t in kw.items()})
    for a, b in zip(f32, f64):
        if a is not None:
            assert _rel(a, b.numpy()) <= dispatch.GRAD_RTOL[torch.float32] / 16


# ---------------------------------------------------------------------------
# K4's backward on the tensor cores ("mma"): its rounding, its route, its
# C signature
# ---------------------------------------------------------------------------

def _bf16_attention_case(S, H, K, D, seed):
    """bf16 q / k / v / dout from numpy, K4's output (rounded to bf16) and
    log-sum-exp from the plain forward, as the training path hands them to
    the backward."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((1, S, H, D), dtype=np.float32)).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, S, K, D), dtype=np.float32)).bfloat16()
            for _ in range(2))
    out, lse = flash_attention_ref(q.float(), k.float(), v.float(), with_lse=True)
    return q, k, v, out.bfloat16(), do, lse


def _mma_backward_model(q, k, v, out, do, lse, *, lo=True):
    """The rounding of the "mma" body, in fp32: S and dP from the bf16
    operands, P = exp(scale S - lse) and dS = P o (dP - D) in fp32, each
    carried into its product as a bf16 hi + lo pair (``lo=False``: bf16
    alone, flash-attention-2's rounding), every product summed in fp32,
    each gradient rounded once to bf16."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G, scale = H // K, 1.0 / D ** 0.5

    def pair(t):
        hi = t.bfloat16().float()
        return hi, (t - hi).bfloat16().float() if lo else torch.zeros_like(t)
    qh, doh = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kh, vh = (t.float().repeat_interleave(G, 2).transpose(1, 2) for t in (k, v))
    p = torch.exp(qh @ kh.transpose(-1, -2) * scale - lse[..., None])
    p = p.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), 0.0)
    delta = (doh * out.float().transpose(1, 2)).sum(-1, keepdim=True)
    ph, pl = pair(p)
    sh, sl = pair(p * (doh @ vh.transpose(-1, -2) - delta))
    dq = (sh @ kh + sl @ kh) * scale
    dk = (sh.transpose(-1, -2) @ qh + sl.transpose(-1, -2) @ qh) * scale
    dv = ph.transpose(-1, -2) @ doh + pl.transpose(-1, -2) @ doh

    def per_kv(t):
        return t.transpose(1, 2).reshape(B, S, K, G, D).sum(3)
    return (dq.transpose(1, 2).bfloat16(), per_kv(dk).bfloat16(), per_kv(dv).bfloat16())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("S,H,K,D", [(512, 16, 2, 128), (512, 32, 32, 64), (333, 32, 32, 64)])
def test_mma_backward_rounding_sits_inside_the_bf16_limit(S, H, K, D, seed):
    """The "mma" body's rounding modelled on the CPU at qwen2.5-3b's and
    zamba2-1.2b's training heads, against the same gradients carried in
    fp64 from the same bf16 values: within 0.9 of ``grad_tolerance_ratio``'s
    bf16 limit (2^-8 of each gradient's largest; 0.56 to 0.73 is read,
    most of it the gradient's own one rounding to bf16)."""
    args = _bf16_attention_case(S, H, K, D, seed)
    ref = flash_attention_backward_ref(*(t.double() for t in args))
    assert dispatch.grad_tolerance_ratio(_mma_backward_model(*args), ref) <= 0.9


def test_mma_backward_needs_the_lo_halves():
    """Carried as bf16 alone (flash-attention-2's rounding), P and dS put
    zamba2's heads at S 333 past the bf16 limit (1.16 is read), where
    the hi + lo pairs stay inside it (0.67): why the body makes two
    products of each."""
    args = _bf16_attention_case(333, 32, 32, 64, 0)
    ref = flash_attention_backward_ref(*(t.double() for t in args))
    assert dispatch.grad_tolerance_ratio(_mma_backward_model(*args, lo=False), ref) > 1.0
    assert dispatch.grad_tolerance_ratio(_mma_backward_model(*args), ref) <= 0.9


def test_backward_route_on_the_training_paths():
    """``backward_body_for``: the tensor cores for bf16 at head_dim 64 and
    128 (zamba2's shared block, qwen2.5-3b's heads), FMA for every fp32
    call and for bf16 at another head_dim; the launcher refuses a body
    the route does not allow before it reaches the card."""
    from repro_torch.kernels.flash_attention import ops

    def q(D, dtype):
        return torch.zeros((1, 4, 2, D), dtype=dtype)
    for cfg in (TR.config("qwen2.5-3b"), TR.config("zamba2-1.2b")):
        assert ops.backward_body_for(q(cfg.head_dim, torch.bfloat16)) == "mma"
        assert ops.backward_body_for(q(cfg.head_dim, torch.float32)) == "fma"
    assert ops.backward_body_for(q(TR.smoke("qwen2.5-3b").head_dim, torch.bfloat16)) == "fma"
    assert [ops.backward_body_for(q(D, torch.bfloat16)) for D in (16, 32, 96, 64, 128)] \
        == ["fma", "fma", "fma", "mma", "mma"]
    with pytest.raises(ValueError, match="on the card"):
        ops._launch_backward(*(torch.zeros((1, 4, 2, 64)) for _ in range(5)),
                             torch.zeros((1, 2, 4)))


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_backward"])
def test_flash_argtypes_match_the_c_entry_point(name):
    """The ctypes signatures of K4 and its backward against the C entry
    points' parameter lists (a missing int would shift the stream)."""
    from repro_torch.kernels.flash_attention import ops
    text = (build.CSRC / f"{name}.cu").read_text()
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    names = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in m.group(1).replace("\n", " ").split(",")]
    want = ops._ARGTYPES if name == "flash_attention" else ops._BWD_ARGTYPES
    assert want == [names[p] for p in params]


# ---------------------------------------------------------------------------
# K5's backward on the tensor cores ("mma"): its rounding, its route, its
# C signature
# ---------------------------------------------------------------------------

def _mma_scan_backward_model(q, k, v, log_decay, log_gate, dy, d_final=None, *,
                             chunk=128, initial_state=None, carry="pairs"):
    """The rounding of K5's "mma" backward, in fp32: ``ssm_scan_backward_ref``
    with each product taken as the body takes it.  bf16 q / k / v are exact;
    every fp32 operand (dy, the states H_{c-1} and G_c, k o wk, q o wq, dA,
    (QK^T o W)) is carried as bf16 hi = bf16(x) and lo = bf16(x - hi), a
    product with one such operand as two products (hi, lo), a product of
    two as three (hi hi + hi lo + lo hi), all summed in fp32; dq / dk / dv
    rounded once to bf16.  ``carry="two"``: a product of two fp32 operands
    drops the lo of its B operand (hi hi + lo hi); ``"bf16"``: every fp32
    operand as bf16 hi alone."""
    B, S, H, N = k.shape
    P = v.shape[-1]

    def halves(t, b_side):
        hi = t.bfloat16().float()
        if carry == "bf16" or (carry == "two" and b_side):
            return [hi]
        return [hi, (t - hi).bfloat16().float()]

    def prod(eq, a, b, a32, b32):
        xs, ys = halves(a, False) if a32 else [a], halves(b, True) if b32 else [b]
        return sum(torch.einsum(eq, x, y) for i, x in enumerate(xs)
                   for j, y in enumerate(ys) if i + j < 2)
    qf, kf, vf, ld, dyf = (t.float() for t in (q, k, v, log_decay, dy))
    g = log_gate.float()
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        def zpad(a):
            return F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
        qf, kf, vf, g, ld, dyf = map(zpad, (qf, kf, vf, g, ld, dyf))
        g[:, S:] = -1e30
    C = (S + pad) // chunk

    def cs(a):
        return a.reshape(B, C, chunk, *a.shape[2:])
    qc, kc, vc, dc, gc, dyc = map(cs, (qf, kf, vf, ld, g, dyf))
    cum = torch.cumsum(dc, 2)
    total = cum[:, :, -1]
    scores = torch.einsum("bcihn,bcjhn->bchij", qc, kc)
    cum_t = cum.transpose(2, 3)
    logw = cum_t[..., :, None] - cum_t[..., None, :] + gc.transpose(2, 3)[..., None, :]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    w = torch.where(causal, torch.exp(logw.clamp(max=30.0)), torch.zeros(()))
    lk = total[:, :, None] - cum + gc
    wk, wq = torch.exp(lk.clamp(max=30.0)), torch.exp(cum.clamp(max=30.0))
    s_c = prod("bcjhn,bcjhp->bchnp", kc * wk[..., None], vc, True, False)
    h = torch.zeros((B, H, N, P)) if initial_state is None else initial_state.float()
    h_prev = []
    for c in range(C):
        h_prev.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + s_c[:, c]
    h_prev = torch.stack(h_prev, 1)
    u_c = prod("bcihn,bcihp->bchnp", qc * wq[..., None], dyc, True, True)
    gst = torch.zeros((B, H, N, P)) if d_final is None else d_final.float()
    g_c, d_total = [None] * C, []
    for c in reversed(range(C)):
        g_c[c] = gst
        decay = torch.exp(total[:, c])
        d_total.append(decay * (gst * h_prev[:, c]).sum((-2, -1)))
        gst = decay[..., None, None] * gst + u_c[:, c]
    g_c, d_total = torch.stack(g_c, 1), torch.stack(d_total[::-1], 1)
    z = prod("bcihp,bchnp->bcihn", dyc, h_prev, True, True)         # A dy, B H^T
    dq = wq[..., None] * z
    d_cum = torch.where(cum < 30.0, (qc * z).sum(-1) * wq, torch.zeros(()))
    gv = prod("bcjhp,bchnp->bcjhn", vc, g_c, False, True)
    dk = wk[..., None] * gv
    dv = wk[..., None] * prod("bcjhn,bchnp->bcjhp", kc, g_c, False, True)
    d_lk = torch.where(lk < 30.0, (kc * gv).sum(-1) * wk, torch.zeros(()))
    d_total, d_cum, d_g = d_total + d_lk.sum(2), d_cum - d_lk, d_lk
    d_a = prod("bcihp,bcjhp->bchij", dyc, vc, True, False) * w
    dv = dv + prod("bchji,bcihp->bcjhp", (scores * w).transpose(-1, -2), dyc, True, True)
    dq = dq + prod("bchij,bcjhn->bcihn", d_a, kc, True, False)
    dk = dk + prod("bchji,bcihn->bcjhn", d_a.transpose(-1, -2), qc, True, False)
    d_logw = torch.where(causal & (logw < 30.0), d_a * scores, torch.zeros(()))
    d_cum = d_cum + (d_logw.sum(-1) - d_logw.sum(-2)).transpose(2, 3)
    d_g = d_g + d_logw.sum(-2).transpose(2, 3)
    d_cum[:, :, -1] += d_total
    d_decay = torch.flip(torch.cumsum(torch.flip(d_cum, [2]), 2), [2])

    def back(a):
        return a.reshape(B, C * chunk, *a.shape[3:])[:, :S]
    return (back(dq).bfloat16(), back(dk).bfloat16(), back(dv).bfloat16(),
            back(d_decay).contiguous(), back(d_g).contiguous(),
            None if initial_state is None else gst)


def _bf16_scan_case(S, H, N, state, seed=0):
    """chip_smoke's scan operands at zamba2-1.2b's widths from a numpy seed:
    bf16 q / k one group for every head (a stride-0 view), bf16 v, decay
    -dt*A with dt log-uniform in [1e-3, 1e-1] and A over [1, 16] by head,
    gate log(dt); fp32 dy, and an initial state and d_final when asked."""
    rng = np.random.default_rng(seed)
    T = torch.from_numpy
    q, k = (T(rng.standard_normal((1, S, 1, N), np.float32)).bfloat16().expand(1, S, H, N)
            for _ in range(2))
    v = T(rng.standard_normal((1, S, H, N), np.float32)).bfloat16()
    log_dt = T(rng.uniform(-6.9078, -2.3026, (1, S, H)).astype(np.float32))
    ld = -torch.exp(log_dt) * (1.0 + 15.0 * (torch.arange(H) + 0.5) / H)
    dy = T(rng.standard_normal((1, S, H, N), np.float32))
    h0, df = ((T(rng.standard_normal((1, H, N, N), np.float32)) for _ in range(2)) if state
              else (None, None))
    return (q, k, v, ld, log_dt, dy, df), h0


def _scan_ratio(S, H, N, state, carry):
    args, h0 = _bf16_scan_case(S, H, N, state)
    ref = ssm_scan_backward_ref(*(None if t is None else t.double() for t in args),
                                initial_state=None if h0 is None else h0.double())
    return dispatch.grad_tolerance_ratio(
        _mma_scan_backward_model(*args, initial_state=h0, carry=carry), ref)


_SCAN_MMA_CASES = [(512, 4, 64, False), (512, 4, 64, True), (1000, 2, 64, True),
                   (300, 2, 128, True)]


@pytest.mark.parametrize("S,H,N,state", _SCAN_MMA_CASES)
def test_mma_scan_backward_rounding_sits_inside_the_limit(S, H, N, state):
    """K5's "mma" backward modelled at zamba2-1.2b's widths (N = P = 64,
    B and C shared by every head; a ragged S, N = P = 128), with and
    without h0 / d_final, against the same gradients carried in fp64 from
    the same bf16 values: within 0.9 of ``grad_tolerance_ratio`` (0.65 to
    0.80 is read, the bf16 gradients' own rounding; the fp32 ones ~0.1 of
    their limit)."""
    assert _scan_ratio(S, H, N, state, "pairs") <= 0.9


@pytest.mark.parametrize("carry", ["two", "bf16"])
@pytest.mark.parametrize("S,H,N,state", _SCAN_MMA_CASES[:2])
def test_mma_scan_backward_needs_every_pair_and_three_products(S, H, N, state, carry):
    """The fp32 operands as bf16 alone, or a product of two fp32 operands
    as two products (the B operand's lo dropped), put the fp32 gradients
    far past their limit (26x and more is read): why the body carries
    every fp32 operand as a pair and takes three products of two."""
    assert _scan_ratio(S, H, N, state, carry) > 1.0


def test_scan_backward_route_on_the_training_path():
    """``backward_body_for`` follows the forward's rule: zamba2-1.2b's
    Mamba-2 widths at bf16 on "mma", fp32 on "fma", N != P or a width
    outside ``MMA_WIDTHS`` on "fma"; the launcher refuses a CPU tensor and
    a body the route does not allow before it reaches the card."""
    from repro_torch.kernels.ssm_scan import ops
    ssm = TR.config("zamba2-1.2b").ssm

    def qkv(N, P, dtype):
        return (torch.zeros((1, 4, 2, N), dtype=dtype), torch.zeros((1, 4, 2, N), dtype=dtype),
                torch.zeros((1, 4, 2, P), dtype=dtype))
    assert ops.backward_body_for(*qkv(ssm.d_state, ssm.head_dim, torch.bfloat16)) == "mma"
    assert ops.backward_body_for(*qkv(ssm.d_state, ssm.head_dim, torch.float32)) == "fma"
    assert [ops.backward_body_for(*qkv(N, P, torch.bfloat16))
            for N, P in ((16, 16), (32, 48), (48, 48), (128, 128), (256, 256))] \
        == ["mma", "fma", "fma", "mma", "fma"]
    q, k, v = qkv(64, 64, torch.float32)
    ld = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="on the card"):
        ops._launch_backward(q, k, v, ld, ld, torch.zeros((1, 4, 2, 64)))


def test_scan_backward_argtypes_match_the_c_entry_point():
    """The ctypes signature of K5's backward against its C entry point's
    parameter list (a missing int would shift the stream)."""
    from repro_torch.kernels.ssm_scan import ops
    text = (build.CSRC / "ssm_scan_backward.cu").read_text()
    m = re.search(r'extern "C" int ssm_scan_backward\(([^)]*)\)', text)
    names = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in m.group(1).replace("\n", " ").split(",")]
    assert ops._BWD_ARGTYPES == [names[p] for p in params]


# ---------------------------------------------------------------------------
# the differentiable wrappers
# ---------------------------------------------------------------------------

def test_wrappers_keep_a_grad_fn_and_count_plain_calls():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 4, 16), generator=g, requires_grad=True)
    k = torch.randn((1, 8, 2, 16), generator=g, requires_grad=True)
    v = torch.randn((1, 8, 2, 16), generator=g, requires_grad=True)
    dispatch.reset_counts()
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    sq = torch.randn((1, 8, 1, 16), generator=g, requires_grad=True)
    sv = torch.randn((1, 8, 4, 16), generator=g, requires_grad=True)
    ld = -torch.rand((1, 8, 4), generator=g)
    y, fin = ssm_scan(sq.expand(1, 8, 4, 16), sq.expand(1, 8, 4, 16), sv, ld, chunk=4)
    assert y.grad_fn is not None and fin.grad_fn is not None
    y.sum().backward()
    assert sq.grad.shape == (1, 8, 1, 16) and sv.grad is not None
    x = torch.randn((3, 16), generator=g, requires_grad=True)
    w = torch.randn((16, 5), generator=g, requires_grad=True)
    assert matmul(x, w).grad_fn is not None
    table = dispatch.kernel_table()
    assert [table[n].plain_calls for n in ("flash_attention", "flash_attention_backward",
                                           "ssm_scan", "ssm_scan_backward", "matmul")] \
        == [1, 1, 1, 1, 1]
    # without grad the wrappers call the kernel entry as before
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
        assert ssm_scan(sq.expand(1, 8, 4, 16), sq.expand(1, 8, 4, 16), sv, ld,
                        chunk=4)[0].grad_fn is None
    assert table["flash_attention"].plain_calls == 2 and table["ssm_scan"].plain_calls == 2
    assert table["flash_attention_backward"].plain_calls == 1


def test_scan_wrapper_gradient_matches_the_plain_backward():
    """Through ``_SsmScan``: a stride-0 q/k view's gradient is the plain
    backward's per-head gradient summed over heads; d_final reaches it."""
    q, k, v, ld, lg, h0, dy, df = _scan_operands(45, seed=7, H=3)
    T = torch.from_numpy
    bq = T(q[:, :, :1].copy()).requires_grad_(True)
    bk = T(k[:, :, :1].copy()).requires_grad_(True)
    tv, tld, tlg, th0 = (T(a).requires_grad_(True) for a in (v, ld, lg, h0))
    y, fin = ssm_scan(bq.expand(2, 45, 3, 16), bk.expand(2, 45, 3, 16), tv, tld, tlg,
                      chunk=32, initial_state=th0)
    ((y * T(dy)).sum() + (fin * T(df)).sum()).backward()
    ref = ssm_scan_backward_ref(bq.detach().expand(2, 45, 3, 16),
                                bk.detach().expand(2, 45, 3, 16), T(v), T(ld), T(lg),
                                T(dy), T(df), chunk=32, initial_state=T(h0))
    torch.testing.assert_close(bq.grad, ref[0].sum(2, keepdim=True))
    torch.testing.assert_close(bk.grad, ref[1].sum(2, keepdim=True))
    for t, r in zip((tv, tld, tlg, th0), ref[2:]):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0)


@pytest.fixture(scope="module")
def mamba():
    cfg = JR.smoke("zamba2-1.2b").replace(compute_dtype="float32")
    tcfg = TR.smoke("zamba2-1.2b").replace(compute_dtype="float32")
    jp = init_table(jax.random.PRNGKey(1), JS.mamba_table(cfg), "float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jp, tcfg, tp


@pytest.mark.parametrize("S", [45, 64])
def test_mixer_gradients_match_jax(mamba, S):
    """The Mamba-2 mixer's input and weight gradients: the scan's q / k are
    B and C, one group shared by every head (stride-0 views here, a
    broadcast in the reference); their per-head gradients are summed."""
    cfg, jp, tcfg, tp = mamba
    rng = np.random.default_rng(S)
    u = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jg = jax.grad(lambda p, u: (JS.mamba_forward(cfg, p, u) * w).sum(), argnums=(0, 1))(
        jp, jnp.asarray(u))
    tu = torch.from_numpy(u).requires_grad_(True)
    for p in tp.values():
        p.grad = None
        p.requires_grad_(True)
    dispatch.reset_counts()
    (TS.mamba_forward(tcfg, tp, tu) * torch.from_numpy(w)).sum().backward()
    table = dispatch.kernel_table()
    assert (table["ssm_scan"].plain_calls, table["ssm_scan_backward"].plain_calls) == (1, 1)
    assert _rel(tu.grad, jg[1]) <= 1e-4
    for name, g in jg[0].items():
        assert _rel(tp[name].grad, g) <= 1e-4, name
    for p in tp.values():
        p.requires_grad_(False)
        p.grad = None


# ---------------------------------------------------------------------------
# the first build and load from two threads
# ---------------------------------------------------------------------------

def test_load_from_two_threads_builds_and_loads_once(tmp_path, monkeypatch):
    """Two threads that first ask for one library at once: one nvcc, one
    ``CDLL``, both get the same library; the temporary file names the
    thread."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    started, tmps = [], []
    gate = threading.Barrier(2)

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            tmps.append(out)
            open(out, "w").close()

        def communicate(self):
            return "ptxas info", None

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.fn = mock.MagicMock()

        def __getattr__(self, name):
            return self.fn

    libs = []

    def cdll(path):
        libs.append(path)
        return FakeLib(path)

    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(build.ctypes, "CDLL", cdll)
    got, idents = [], set()

    def ask():
        idents.add(threading.get_ident())
        gate.wait()
        got.append(build.load("flash_attention_backward", [ctypes.c_int]))
    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(started) == 1 and len(libs) == 1
    assert got[0] is got[1]
    assert any(tmps[0].endswith(f".{i}.tmp") for i in idents)
