"""The port's conv2d kernel wrapper and conv layers on the CPU: the plain
version of K6 against the JAX oracle (``repro/kernels/conv2d/ref.py``) and
against the Pallas TPU kernel in interpret mode, on the same numpy inputs;
the pooling and LRN layers against ``repro.models.layers.conv``; and the
launcher's refusals.

Tolerances.  fp32: 1e-5 relative, plus 1e-5 of the largest |output| for
outputs near zero (the three sum the same products in other orders).
fp16 / bf16: the plain version and the Pallas kernel both sum in fp32, add
the bias in fp32 and round once; the oracle rounds the conv to the type and
adds the bias rounded to the type.  So outputs differ by one or two
roundings: 2 ulps of the largest |output| (fp16 2^-9, bf16 2^-6 of it).
The Pallas kernel asserts ``Cout % bc == 0``, so it runs with ``bc = 8``,
which divides both Cout values of the sweep.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d.kernel import conv2d as jax_pallas_conv
from repro.kernels.conv2d.ref import conv2d_ref as jax_conv_ref
from repro.models.layers import conv as jconv
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.conv2d.ops import conv2d
from repro_torch.kernels.conv2d.ref import same_padding
from repro_torch.models.layers import conv as tconv

torch.set_num_threads(1)

ATOL_OF_MAX = {"float32": 1e-5, "float16": 2.0 ** -9, "bfloat16": 2.0 ** -6}
# (H=W, KH=KW, stride, Cin, Cout)
SWEEP = list(itertools.product((7, 14, 15), (1, 3, 5, 7), (1, 2), (3, 16), (8, 24)))
# Against the Pallas kernel too (interpret mode takes about a second a
# shape), and at fp16 / bf16: every value of each axis, with the stem-like
# and the asymmetric-padding cases (even maps at stride 2, 7x7 windows)
SWEEP_LP = [(7, 1, 1, 3, 8), (7, 7, 2, 16, 24), (14, 3, 2, 16, 24),
            (14, 7, 2, 3, 8), (15, 5, 1, 3, 24), (15, 3, 2, 16, 8),
            (14, 5, 1, 16, 8), (15, 7, 1, 3, 24)]


def _case(H, KH, Cin, Cout, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, H, H, Cin)).astype(np.float32),
            rng.standard_normal((KH, KH, Cin, Cout)).astype(np.float32),
            rng.standard_normal((Cout,)).astype(np.float32))


def _both(a, dtype):
    j = jnp.asarray(a).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(t_out, j_out, dtype):
    ref = np.asarray(j_out.astype(jnp.float32))
    atol = ATOL_OF_MAX[dtype] * np.abs(ref).max()
    rtol = 1e-5 if dtype == "float32" else 0
    np.testing.assert_allclose(t_out.float().numpy(), ref, rtol=rtol, atol=atol)


def _check(dtype, H, KH, stride, Cin, Cout, *, pallas):
    x, w, b = _case(H, KH, Cin, Cout)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    jb, tb = jnp.asarray(b), torch.from_numpy(b)        # fp32 bias
    out = conv2d(tx, tw, tb, stride=stride)
    hout = -(-H // stride)
    assert out.shape == (2, hout, hout, Cout) and out.dtype == tx.dtype
    _close(out, jax_conv_ref(jx, jw, jb, stride=stride), dtype)
    if pallas:
        _close(out, jax_pallas_conv(jx, jw, jb, stride=stride, bc=8,
                                    interpret=True), dtype)


@pytest.mark.parametrize("H,KH,stride,Cin,Cout", SWEEP)
def test_conv2d_plain_matches_jax_ref_fp32(H, KH, stride, Cin, Cout):
    _check("float32", H, KH, stride, Cin, Cout, pallas=False)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("H,KH,stride,Cin,Cout", SWEEP_LP)
def test_conv2d_plain_matches_jax_ref_and_pallas(dtype, H, KH, stride, Cin, Cout):
    _check(dtype, H, KH, stride, Cin, Cout, pallas=True)


def test_conv2d_plain_bias_in_x_dtype():
    """A bias in x's type is added in fp32 too: the same output as the
    same values handed over in fp32."""
    x, w, b = _case(14, 3, 16, 24)
    tx, tw = torch.from_numpy(x).half(), torch.from_numpy(w).half()
    tb = torch.from_numpy(b).half()
    assert torch.equal(conv2d(tx, tw, tb), conv2d(tx, tw, tb.float()))


@pytest.mark.parametrize("size,window,stride,expect", [
    (224, 7, 2, (2, 3)),     # stem1: 2 before, 3 after
    (112, 3, 2, (0, 1)),     # the SAME 3x3/2 max-pools on 112, 56, 28, 14
    (56, 3, 2, (0, 1)),
    (15, 3, 2, (1, 1)),
    (28, 3, 1, (1, 1)),
    (7, 5, 1, (2, 2)),
    (7, 1, 1, (0, 0)),
])
def test_same_padding_is_asymmetric(size, window, stride, expect):
    assert same_padding(size, window, stride) == expect


@pytest.mark.parametrize("H,window,stride", [(14, 3, 2), (15, 3, 2), (7, 3, 1),
                                             (16, 3, 2)])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_pools_and_lrn_match_jax(H, window, stride, dtype):
    """SAME max-pool (-inf padding, the odd pixel after), average pool
    (VALID and SAME), global average pool and LRN, NHWC.  Max-pool, the
    global pool and LRN agree exactly; the reference's fp16 average pool
    sums the window in fp16 (8 roundings of sums up to 9 max|x|, then / 9)
    where the port sums in fp32, so it is held to 2^-8 max|x| at fp16."""
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2, H, H, 12))).astype(np.float32)
    jx, tx = _both(x, dtype)
    avg_atol = 1e-6 if dtype == "float32" else 2.0 ** -8 * np.abs(x).max()

    def close(t, j, atol=1e-6):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j.astype(jnp.float32)),
                                   rtol=1e-6, atol=atol)
    mp = tconv.max_pool(tx, window, stride)
    assert mp.is_contiguous()
    close(mp, jconv.max_pool(jx, window, stride))
    close(tconv.avg_pool(tx, window, stride),
          jconv.avg_pool(jx, window, stride), avg_atol)
    close(tconv.avg_pool(tx, window, stride, "SAME"),
          jconv.avg_pool(jx, window, stride, "SAME"), avg_atol)
    close(tconv.global_avg_pool(tx), jconv.global_avg_pool(jx))
    close(tconv.lrn(tx), jconv.lrn(jx))
    close(tconv.lrn(tx * 100), jconv.lrn(jx * 100))    # where LRN bites


def test_relu_conv_casts_the_weight_to_x_dtype():
    x, w, b = _case(7, 3, 16, 8)
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b).bfloat16()}
    out = tconv.relu_conv(params, torch.from_numpy(x).half())
    assert out.dtype == torch.float16 and (out >= 0).all()
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b).astype(jnp.bfloat16)}
    ref = jconv.relu_conv(jp, jnp.asarray(x).astype(jnp.float16))
    _close(out, ref, "float16")


def test_cpu_tensors_take_the_counted_plain_version():
    k = dispatch.kernel_table()["conv2d"]
    x, w, b = (torch.from_numpy(a) for a in _case(7, 3, 3, 8))
    dispatch.reset_counts()
    conv2d(x, w, b)
    with dispatch.plain_versions():
        conv2d(x, w, b)
    assert (k.launches, k.plain_calls) == (0, 2)


def test_launcher_refuses_what_the_kernel_does_not_take():
    """The CUDA launcher takes only card tensors; the operand checks it
    runs refuse a wrong dtype, a non-NHWC layout (an NCHW tensor viewed as
    NHWC is not contiguous), and an x at an address the kernel's 16-byte
    loads cannot read."""
    k = dispatch.kernel_table()["conv2d"]
    x, w, b = (torch.from_numpy(a) for a in _case(7, 3, 16, 8))
    with pytest.raises(ValueError, match="on the card"):
        k.launch(x, w, b)
    cpu = torch.device("cpu")
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        dispatch.check_operand(x.double(), "x", device=cpu, dtypes=dtypes)
    with pytest.raises(ValueError, match="contiguous"):
        dispatch.check_operand(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                               "x", device=cpu, dtypes=dtypes)
    flat = torch.zeros(1 + x.numel())
    odd = flat[1:].view(x.shape)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        dispatch.check_operand(odd, "x", device=cpu, dtypes=dtypes, align=16)


def test_build_without_nvcc_raises_for_conv2d(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    assert "conv2d" in build.sources()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["conv2d"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_conv_tolerance_holds_rounding_and_rejects_a_lost_chunk(dtype):
    """The card's kernel-vs-plain limit for conv2d: one rounding of the
    fp32 output to the kernel's type passes; a sum that loses one 16-deep
    chunk of K (what a wrong K loop gives) fails by far more than 10x."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 14, 14, 64), generator=g).to(dtype).float()
    w = (torch.randn((3, 3, 64, 48), generator=g) / 24).to(dtype).float()
    b = torch.randn((48,), generator=g)
    ref = conv2d(x, w, b)
    assert dispatch.conv_tolerance_ratio(ref.to(dtype), ref) <= 0.5
    w_lost = w.clone()
    w_lost[0, 0, :16] = 0                   # K rows 0..15: tap 0, channels 0..15
    assert dispatch.conv_tolerance_ratio(conv2d(x, w_lost, b).to(dtype), ref) > 10
