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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.kernels.ssm_scan.kernel import ssm_scan as pallas_ssm_scan
from repro.models.layers import ssm as JS
from repro.models.layers.module import init_table
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
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
