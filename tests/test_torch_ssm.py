"""The port's K5 plain version and Mamba-2 layer against the JAX package,
on the same inputs and weights (made with numpy, handed over through
``repro_torch.interop``), at fp32 on the CPU.

* ``ssm_scan_ref`` against ``chunked_linear_attn`` -- y and the final
  state, with and without ``initial_state``, S a multiple of the chunk and
  ragged -- and against the Pallas ``ssm_scan`` in interpret mode where S
  is a multiple of the chunk (the Pallas kernel asserts it).  Limit: 1e-5
  of the largest |ref| (the same fp32 arithmetic; only the order of the
  sums over chunks differs).
* ``mamba_forward`` (prefill, state out) and ``mamba_step`` (decode) at
  ``zamba2-1.2b-smoke`` widths, within 1e-5 of the largest |ref|.
* The launcher's operand check: B and C reach the kernel as a stride-0
  head view, which it admits, and no other non-contiguous layout.
* At the mLSTM's widths, P = N + 1 (the normalizer's ones column; N = 32
  and xlstm-125m's N = 384): ``ssm_scan_ref`` against
  ``chunked_linear_attn`` with and without a state, and against the
  Pallas scan in interpret mode, within the same 1e-5; the route sends
  them to the FMA body (which walks N in slices, so any width fits), never
  to the tensor cores.
* The kernel's route (``body_for``), and a plain emulation of the
  tensor-core body's rounding (``_emulated_mma``): its three products
  with an fp32 operand take the operand split into bf16 hi + lo, which
  holds the card's limit
  (``SSM_RTOL`` of the largest |ref|) with room to spare at Mamba-2-like
  operands, where one bf16 rounding of the same operands fails it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as JR
from repro.kernels.ssm_scan.kernel import ssm_scan as pallas_ssm_scan
from repro.models.layers import ssm as JS
from repro.models.layers.module import init_table
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models.layers import ssm as TS
from repro_torch.models.layers.module import init_table as torch_init_table

torch.set_num_threads(1)

RTOL = 1e-5


def _rel(t, j):
    j = np.asarray(j, np.float32)
    return float(np.abs(np.asarray(t, np.float32) - j).max() / np.abs(j).max())


def _scan_inputs(seed, B, S, H, N, P):
    """Mamba-like operands: decay -dt*A <= 0, gate log(dt)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, N))
    k = rng.standard_normal((B, S, H, N))
    v = rng.standard_normal((B, S, H, P))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H)))
    ld = -dt * rng.uniform(1.0, 16.0, (H,))
    h0 = rng.standard_normal((B, H, N, P))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return tuple(map(f32, (q, k, v, ld, np.log(dt), h0)))


@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16), (7, 16), (33, 32)])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_scan_matches_chunked_linear_attn(S, chunk, with_state):
    q, k, v, ld, lg, h0 = _scan_inputs(S, 2, S, 3, 8, 4)
    init = h0 if with_state else None
    jy, jf = JS.chunked_linear_attn(
        *map(jnp.asarray, (q, k, v, ld, lg)), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init),
        return_final_state=True)
    ty, tf = ssm_scan_ref(*map(torch.from_numpy, (q, k, v, ld, lg)),
                          chunk=chunk, initial_state=None if init is None
                          else torch.from_numpy(init))
    assert ty.dtype == tf.dtype == torch.float32
    assert ty.shape == (2, S, 3, 4) and tf.shape == (2, 3, 8, 4)
    assert _rel(ty, jy) <= RTOL and _rel(tf, jf) <= RTOL


@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32), (16, 16)])
def test_plain_scan_matches_pallas_interpret(S, chunk):
    q, k, v, ld, lg, _ = _scan_inputs(S + 1, 1, S, 2, 16, 8)
    jy = pallas_ssm_scan(*map(jnp.asarray, (q, k, v, ld, lg)), chunk=chunk,
                         interpret=True)
    ty, _ = ssm_scan_ref(*map(torch.from_numpy, (q, k, v, ld, lg)),
                         chunk=chunk)
    assert _rel(ty, jy) <= RTOL


def test_plain_scan_takes_bf16_and_no_gate():
    """bf16 operands are read exactly into fp32; a missing gate is 0."""
    q, k, v, ld, _, _ = _scan_inputs(3, 1, 40, 2, 8, 8)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    y, fin = ssm_scan(qb, kb, vb, torch.from_numpy(ld), chunk=16)
    y32, fin32 = ssm_scan_ref(qb.float(), kb.float(), vb.float(),
                              torch.from_numpy(ld), torch.zeros(ld.shape),
                              chunk=16)
    assert y.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(fin, fin32)


def test_wrapper_counts_the_plain_version_on_the_cpu():
    kern = dispatch.kernel_table()["ssm_scan"]
    dispatch.reset_counts()
    q, k, v, ld, lg, _ = _scan_inputs(4, 1, 20, 2, 4, 4)
    ssm_scan(*map(torch.from_numpy, (q, k, v, ld, lg)), chunk=8)
    assert (kern.launches, kern.plain_calls) == (0, 1)
    with pytest.raises(ValueError, match="on the card"):
        kern.launch(*map(torch.from_numpy, (q, k, v, ld, lg)))


def test_operand_check_admits_the_stride0_head_view_only():
    cpu = torch.device("cpu")
    base = torch.zeros((2, 9, 5))                        # (B, S, N)
    view = base[:, :, None, :].expand(2, 9, 4, 5)        # stride 0 over heads
    assert view.stride(2) == 0
    dispatch.check_operand(view, "k", device=cpu, dtypes=(torch.float32,),
                           shape=(2, 9, 4, 5), broadcast_dim=2)
    with pytest.raises(ValueError, match="contiguous"):  # without the option
        dispatch.check_operand(view, "k", device=cpu, dtypes=(torch.float32,))
    # a stride-0 view of a strided (B, S, N) slice, and a transposed tensor
    strided = torch.zeros((2, 9, 12))[..., 2:7][:, :, None, :].expand(2, 9, 4, 5)
    with pytest.raises(ValueError, match="stride-0"):
        dispatch.check_operand(strided, "k", device=cpu,
                               dtypes=(torch.float32,), broadcast_dim=2)
    swapped = torch.zeros((2, 4, 9, 5)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        dispatch.check_operand(swapped, "k", device=cpu,
                               dtypes=(torch.float32,), broadcast_dim=2)


def test_ssm_tolerance_holds_order_noise_and_rejects_a_lost_state():
    """The card's K5 limit: fp32 order noise passes; the state carried into
    a chunk dropped (what a broken scan gives) fails by far."""
    q, k, v, ld, lg, _ = _scan_inputs(5, 1, 96, 2, 8, 8)
    args = list(map(torch.from_numpy, (q, k, v, ld, lg)))
    ref = ssm_scan_ref(*args, chunk=32)
    noisy = tuple(t * (1 + 1e-7 * torch.randn(t.shape, generator=torch.Generator()
                                              .manual_seed(0))) for t in ref)
    assert dispatch.ssm_tolerance_ratio(noisy, ref) <= 0.1
    # every chunk on its own: y and state without the carried state
    parts = [ssm_scan_ref(*(a[:, c:c + 32] for a in args), chunk=32)
             for c in (0, 32, 64)]
    lost = (torch.cat([p[0] for p in parts], dim=1), parts[-1][1])
    assert dispatch.ssm_tolerance_ratio(lost, ref) > 100


def _bf16_view(shape, *, offset=0):
    """A bf16 tensor of ``shape``, ``offset`` elements past a 16-byte
    aligned start."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=torch.bfloat16)[offset:offset + n].view(shape)


@pytest.mark.parametrize("dtype,N,P,shared,offset,body", [
    (torch.bfloat16, 64, 64, True, 0, "mma"),      # zamba2-1.2b
    (torch.bfloat16, 16, 16, True, 0, "mma"),      # its smoke widths
    (torch.bfloat16, 128, 128, False, 0, "mma"),   # per-head q/k
    (torch.bfloat16, 32, 32, False, 0, "mma"),
    (torch.float32, 64, 64, True, 0, "fma"),       # every fp32 call
    (torch.float32, 16, 16, False, 0, "fma"),
    (torch.bfloat16, 32, 48, False, 0, "fma"),     # N != P
    (torch.bfloat16, 256, 256, True, 0, "fma"),    # not instantiated
    (torch.bfloat16, 8, 8, True, 0, "fma"),
    (torch.bfloat16, 64, 64, True, 1, "fma"),      # not on 16 bytes
])
def test_body_for_routes_each_case(dtype, N, P, shared, offset, body):
    B, S, H = 2, 9, 4
    hq = 1 if shared else H
    q, k = (_bf16_view((B, S, hq, N), offset=offset).to(dtype).expand(B, S, H, N)
            for _ in range(2))
    v = _bf16_view((B, S, H, P)).to(dtype)
    assert (q.stride(2) == 0) == shared
    assert ssm_ops.body_for(q, k, v) == body


def _bf16(x):
    return x.bfloat16().float()


def _split(x, terms):
    """x as the tensor cores see it: one bf16 rounding (terms 1), or bf16
    hi + lo with lo = bf16(x - hi) (terms 2)."""
    hi = _bf16(x)
    return hi if terms == 1 else hi + _bf16(x - hi)


def _emulated_mma(q, k, v, ld, lg, *, chunk, initial_state=None, terms=2):
    """The tensor-core body's arithmetic in fp32 PyTorch: per chunk the
    weighted scores (q_i.k_j) w_ij, the entering state H_{c-1} and k o wk
    each through :func:`_split` before their product with an exact bf16
    operand; q.H_prev scaled by exp(min(cum, 30)) after the product; the
    states passed chunk by chunk in fp32.  Any S (identity steps pad it)."""
    B, S, H, N = k.shape
    P = v.shape[-1]
    q, k, v, ld, g = (t.float() for t in (q, k, v, ld, lg))
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        q, k, v, g, ld = (F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
                          for a in (q, k, v, g, ld))
        g[:, S:] = -1e30
    C = (S + pad) // chunk
    qc, kc, vc, dc, gc = (a.reshape(B, C, chunk, *a.shape[2:])
                          for a in (q, k, v, ld, g))
    cum = torch.cumsum(dc, 2)
    total = cum[:, :, -1]
    cum_t = cum.transpose(2, 3)
    logw = cum_t[..., :, None] - cum_t[..., None, :] + gc.transpose(2, 3)[..., None, :]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    w = torch.where(causal, torch.exp(logw.clamp(max=30.0)), torch.zeros(()))
    m = torch.einsum("bcihn,bcjhn->bchij", qc, kc) * w
    y_diag = torch.einsum("bchij,bcjhp->bcihp", _split(m, terms), vc)
    wk = torch.exp((total[:, :, None] - cum + gc).clamp(max=30.0))
    sums = torch.einsum("bcjhn,bcjhp->bchnp", _split(kc * wk[..., None], terms), vc)
    h = (torch.zeros((B, H, N, P)) if initial_state is None
         else initial_state.float())
    entering = []
    for c in range(C):
        entering.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + sums[:, c]
    y_off = torch.einsum("bcihn,bchnp->bcihp", qc,
                         _split(torch.stack(entering, 1), terms))
    y_off = y_off * torch.exp(cum.clamp(max=30.0))[..., None]
    return (y_diag + y_off).reshape(B, C * chunk, H, P)[:, :S], h


def _zamba_operands(seed, S, H, N, *, shared=True, with_state=False):
    """chip_smoke.ssm_case's distribution from a numpy seed, bf16 values:
    q, k one group for every head (a stride-0 view) or per head; decay
    -dt*A with dt log-uniform in [1e-3, 1e-1] and A over [1, 16] by head;
    gate log(dt)."""
    rng = np.random.default_rng(seed)
    hq = 1 if shared else H
    q, k = (_bf16(torch.from_numpy(rng.standard_normal((1, S, hq, N), np.float32)))
            .expand(1, S, H, N) for _ in range(2))
    v = _bf16(torch.from_numpy(rng.standard_normal((1, S, H, N), np.float32)))
    log_dt = torch.from_numpy(rng.uniform(-6.9078, -2.3026, (1, S, H)).astype(np.float32))
    a = 1.0 + 15.0 * (torch.arange(H) + 0.5) / H
    h0 = (torch.from_numpy(rng.standard_normal((1, H, N, N), np.float32))
          if with_state else None)
    return (q, k, v, -torch.exp(log_dt) * a, log_dt), h0


_ZAMBA_CASES = [(1000, 8, 64, True, False), (1000, 8, 64, True, True),
                (1024, 8, 64, True, False), (1000, 4, 128, False, True),
                (77, 4, 16, True, True), (300, 4, 32, False, True)]


@pytest.mark.parametrize("S,H,N,shared,with_state", _ZAMBA_CASES)
def test_mma_body_rounding_holds_the_limit(S, H, N, shared, with_state):
    """bf16 hi + lo on each fp32 operand: within half the card's limit."""
    args, h0 = _zamba_operands(S, S, H, N, shared=shared, with_state=with_state)
    chunk = 32 if N == 16 else 128
    ref = ssm_scan_ref(*args, chunk=chunk, initial_state=h0)
    out = _emulated_mma(*args, chunk=chunk, initial_state=h0)
    assert dispatch.ssm_tolerance_ratio(out, ref) <= 0.5


@pytest.mark.parametrize("S,H,N,shared,with_state", _ZAMBA_CASES[:4])
def test_one_bf16_rounding_fails_the_limit(S, H, N, shared, with_state):
    """The same operands each rounded once to bf16 fail the card's limit:
    why the tensor-core body splits them."""
    args, h0 = _zamba_operands(S, S, H, N, shared=shared, with_state=with_state)
    ref = ssm_scan_ref(*args, chunk=128, initial_state=h0)
    out = _emulated_mma(*args, chunk=128, initial_state=h0, terms=1)
    assert dispatch.ssm_tolerance_ratio(out, ref) > 1


@pytest.fixture(scope="module")
def mamba():
    cfg = JR.smoke("zamba2-1.2b").replace(compute_dtype="float32")
    tcfg = TR.smoke("zamba2-1.2b").replace(compute_dtype="float32")
    jp = init_table(jax.random.PRNGKey(1), JS.mamba_table(cfg), "float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jp, tcfg, tp


def test_mamba_table_matches_reference(mamba):
    cfg, jp, tcfg, _ = mamba
    tp = torch_init_table(torch.Generator().manual_seed(0),
                          TS.mamba_table(tcfg), "float32")
    assert set(tp) == set(jp)
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape, name
    for name in ("a_log", "dt_bias", "d_skip", "norm", "conv_b"):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("S", [45, 64])
def test_mamba_forward_and_steps_match_reference(mamba, S):
    """Prefill S tokens (state out), then three decode steps from it."""
    cfg, jp, tcfg, tp = mamba
    rng = np.random.default_rng(S)
    u = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jo, jst = JS.mamba_forward(cfg, jp, jnp.asarray(u), return_state=True)
    to, tst = TS.mamba_forward(tcfg, tp, torch.from_numpy(u),
                               return_state=True)
    assert _rel(to, jo) <= RTOL
    assert _rel(tst.ssm, jst.ssm) <= RTOL
    assert _rel(tst.conv, jst.conv) <= RTOL
    # a second prefill carrying the state in (initial_state and history)
    jo2, jst2 = JS.mamba_forward(cfg, jp, jnp.asarray(u[:, :9]), jst,
                                 return_state=True)
    to2, tst2 = TS.mamba_forward(tcfg, tp, torch.from_numpy(u[:, :9]), tst,
                                 return_state=True)
    assert _rel(to2, jo2) <= RTOL and _rel(tst2.ssm, jst2.ssm) <= RTOL
    for step in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = JS.mamba_step(cfg, jp, jnp.asarray(x), jst)
        ty, tst = TS.mamba_step(tcfg, tp, torch.from_numpy(x), tst)
        assert _rel(ty, jy) <= RTOL, step
        assert _rel(tst.ssm, jst.ssm) <= RTOL and _rel(tst.conv, jst.conv) <= RTOL


def test_linear_attn_step_and_init_state_match_reference(mamba):
    cfg, _, tcfg, _ = mamba
    rng = np.random.default_rng(9)
    q, k = (rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, 3, 5)).astype(np.float32)
    ld = -rng.random((2, 3)).astype(np.float32)
    lg = rng.standard_normal((2, 3)).astype(np.float32) * 20
    st = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    jy, js = JS.linear_attn_step(*map(jnp.asarray, (q, k, v, ld, lg, st)))
    ty, ts = TS.linear_attn_step(*map(torch.from_numpy, (q, k, v, ld, lg, st)))
    assert _rel(ty, jy) <= RTOL and _rel(ts, js) <= RTOL
    jz = JS.mamba_init_state(cfg, 3, jnp.bfloat16)
    tz = TS.mamba_init_state(tcfg, 3, "bfloat16", device="cpu")
    assert tz.conv.shape == jz.conv.shape and tz.conv.dtype == torch.bfloat16
    assert tz.ssm.shape == jz.ssm.shape and tz.ssm.dtype == torch.float32


def _mlstm_operands(seed, S, H, N):
    """mLSTM-like operands (repro/models/layers/xlstm.py): q, k ~ N(0, 1)
    with k / sqrt(N), v with the ones column (P = N + 1), forget gates
    log_sigmoid of a bias in [3, 6] plus noise, input gates clipped to
    [-30, 15]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, S, H, N))
    k = rng.standard_normal((1, S, H, N)) / np.sqrt(N)
    v = np.concatenate([rng.standard_normal((1, S, H, N)),
                        np.ones((1, S, H, 1))], axis=-1)
    f = rng.standard_normal((1, S, H)) + np.linspace(3.0, 6.0, H)
    ld = -np.logaddexp(0.0, -f)                       # log_sigmoid
    lg = np.clip(3.0 * rng.standard_normal((1, S, H)), -30.0, 15.0)
    h0 = rng.standard_normal((1, H, N, N + 1))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return tuple(map(f32, (q, k, v, ld, lg, h0)))


@pytest.mark.parametrize("N", [32, 384])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_scan_takes_the_mlstm_widths(N, with_state):
    """P = N + 1, S = 256 over two chunks of 128, against the oracle."""
    q, k, v, ld, lg, h0 = _mlstm_operands(N, 256, 1, N)
    init = h0 if with_state else None
    jy, jf = JS.chunked_linear_attn(
        *map(jnp.asarray, (q, k, v, ld, lg)), chunk=128,
        initial_state=None if init is None else jnp.asarray(init),
        return_final_state=True)
    ty, tf = ssm_scan(*map(torch.from_numpy, (q, k, v, ld, lg)), chunk=128,
                      initial_state=None if init is None
                      else torch.from_numpy(init))
    assert ty.shape == (1, 256, 1, N + 1) and tf.shape == (1, 1, N, N + 1)
    assert _rel(ty, jy) <= RTOL and _rel(tf, jf) <= RTOL


@pytest.mark.parametrize("N", [32, 384])
def test_plain_scan_matches_pallas_interpret_at_the_mlstm_widths(N):
    q, k, v, ld, lg, _ = _mlstm_operands(N + 1, 256, 1, N)
    jy = pallas_ssm_scan(*map(jnp.asarray, (q, k, v, ld, lg)), chunk=128,
                         interpret=True)
    ty, _ = ssm_scan_ref(*map(torch.from_numpy, (q, k, v, ld, lg)),
                         chunk=128)
    assert _rel(ty, jy) <= RTOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,N", [
    (1000, 384),    # xlstm-125m's prefill
    (256, 384),
    (54, 384),
    (7, 384),       # S under the chunk
    (256, 32),      # its smoke widths
])
def test_body_for_routes_the_mlstm_widths(dtype, S, N):
    """P = N + 1 never takes the tensor-core body (N != P, and a bf16 row
    of 385 is not 16-byte aligned): the FMA body, at any S; the
    backward's route stays FMA."""
    q, k = (torch.zeros((1, S, 4, N), dtype=dtype) for _ in range(2))
    v = torch.zeros((1, S, 4, N + 1), dtype=dtype)
    assert ssm_ops.body_for(q, k, v) == "fma"
    assert ssm_ops.backward_body_for(q, k, v) == "fma"
