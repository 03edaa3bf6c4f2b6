"""The port's conv2d kernel wrapper and conv layers on the CPU: the plain
version of K6 against the JAX oracle (``repro/kernels/conv2d/ref.py``) and
against the Pallas TPU kernel in interpret mode, on the same numpy inputs;
the pooling and LRN layers against ``repro.models.layers.conv``; the
launcher's refusals; the kernel's route (which body a call runs), its
split-K rule on GoogLeNet's shapes, and the split-K arithmetic emulated in
fp32 against the JAX oracle and the Pallas kernel.

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
from repro_torch.kernels.conv2d.ops import (FMA_BK, MIN_SLICE_CHUNKS, MMA_BK, SMS,
                                            body_for, conv2d, conv_splits, conv_tile,
                                            x_in_pieces)
from repro_torch.kernels.conv2d.ref import same_padding
from repro_torch.models.googlenet import conv_shapes
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(3, 64), (8, 8), (16, 24), (24, 20), (20, 64),
                                      (832, 32), (192, 13)])
def test_conv_route_by_dtype_cin_cout_and_alignment(dtype, cin, cout):
    """K6's body is decided before the launch from the type, Cout and w's
    alignment alone: fp16 / bf16 with Cout a multiple of 8 (a 16-byte piece
    of w inside a row) take the tensor cores, everything else -- every
    fp32 call, a w that does not start 16-byte aligned -- the FMA body.
    x goes in 16-byte pieces where Cin is a multiple of the piece (a piece
    inside one tap) and x is aligned, else element by element (stem1's
    Cin = 3): on either body."""
    x = torch.zeros((1, 5, 5, cin), dtype=dtype)
    w = torch.zeros((3, 3, cin, cout), dtype=dtype)
    want = "mma" if dtype != torch.float32 and cout % 8 == 0 else "fma"
    assert body_for(x, w) == want
    assert x_in_pieces(x, w) == (cin % (16 // x.element_size()) == 0)
    odd_x = torch.zeros(1 + x.numel(), dtype=dtype)[1:].view(x.shape)
    odd_w = torch.zeros(1 + w.numel(), dtype=dtype)[1:].view(w.shape)
    assert body_for(odd_x, w) == want and not x_in_pieces(odd_x, w)
    assert body_for(x, odd_w) == "fma"


def _gemm(batch, xs, ws, stride):
    """(M, N, K) of one conv's implicit GEMM."""
    _, H, W, Cin = xs
    KH, KW, _, Cout = ws
    return batch * -(-H // stride) * -(-W // stride), Cout, KH * KW * Cin


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("body", ["mma", "fma"])
def test_conv_splits_on_googlenet_shapes(batch, body):
    """The split-K rule on GoogLeNet's 57 convs: no split where the output
    tiles already give every SM a block; otherwise enough K slices to do so
    as long as each keeps MIN_SLICE_CHUNKS chunks.  Every slice, as the
    kernel deals them (slice z: chunks z * nk // splits up to (z + 1) * nk
    // splits), is non-empty and at least that long.  At batch 8 and at
    batch 1 every conv of stages 4 and 5 is split; at batch 1 every conv
    past the stem but those with fewer than two slices' worth of chunks."""
    bk = MMA_BK if body == "mma" else FMA_BK
    split = {}
    for name, xs, ws, stride in conv_shapes(batch, 224):
        M, N, K = _gemm(batch, xs, ws, stride)
        bm, bn = conv_tile(body, M, N)
        splits = conv_splits(M, N, K, bm, bn, bk)
        tiles, nk = -(-M // bm) * -(-N // bn), -(-K // bk)
        sizes = [(z + 1) * nk // splits - z * nk // splits for z in range(splits)]
        assert sum(sizes) == nk and min(sizes) >= 1
        if tiles >= SMS:
            assert splits == 1, name
        elif splits > 1:
            assert min(sizes) >= MIN_SLICE_CHUNKS, name
            assert tiles * splits >= SMS or splits == nk // MIN_SLICE_CHUNKS, name
        else:
            assert nk < 2 * MIN_SLICE_CHUNKS or tiles * 2 > SMS, name
        split[name] = splits
    assert all(split[n] > 1 for n in split if n[0] in "45")
    if batch == 8:
        assert split["stem1"] == split["stem2"] == 1
    else:
        short = {n for n, xs, ws, stride in conv_shapes(batch, 224)
                 if -(-_gemm(batch, xs, ws, stride)[2] // bk) < 2 * MIN_SLICE_CHUNKS}
        assert all(split[n] > 1 for n in split if not n.startswith("stem") and n not in short)
    if body == "mma" and batch == 8:       # 7 tiles of 64 x 64, 13 chunks of 64
        assert (split["5a.b3r"], split["4a.b2"], split["5b.b2"]) == (6, 2, 4)


def _split_k_conv(x, w, b, stride, bk, splits):
    """K6's split-K arithmetic in fp32 plain PyTorch: the implicit GEMM over
    K = KH * KW * Cin in the kernel's k order (tap-major, channel-minor),
    the cdiv(K, bk) chunks dealt into ``splits`` slices as conv2d.cu's
    slice_of deals them, each slice's partial summed on its own, the
    partials added in slice order, the bias added once in fp32, one
    rounding to x's type."""
    B, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    hout, wout = -(-H // stride), -(-W // stride)
    (pt, pb), (pl, pr) = same_padding(H, KH, stride), same_padding(W, KW, stride)
    xp = torch.nn.functional.pad(x.float(), (0, 0, pl, pr, pt, pb))
    taps = [xp[:, i:i + (hout - 1) * stride + 1:stride, j:j + (wout - 1) * stride + 1:stride]
            for i in range(KH) for j in range(KW)]
    a = torch.cat(taps, -1).reshape(B * hout * wout, KH * KW * Cin)
    wk = w.float().reshape(KH * KW * Cin, Cout)
    K = a.shape[1]
    nk = -(-K // bk)
    total = torch.zeros((a.shape[0], Cout))
    for z in range(splits):
        lo, hi = z * nk // splits * bk, min((z + 1) * nk // splits * bk, K)
        total = total + a[:, lo:hi] @ wk[lo:hi]
    return (total + b.float()).reshape(B, hout, wout, Cout).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("H,KH,stride,Cout,bc", [(7, 3, 1, 40, 8), (9, 5, 2, 20, 4),
                                                 (8, 1, 1, 72, 8)])
def test_split_k_arithmetic_matches_jax_ref_and_pallas(dtype, H, KH, stride, Cout, bc):
    """K6's split-K emulated in fp32 (partials per K slice summed in slice
    order, the bias once, one rounding) at Cin = 24 (a chunk spans taps)
    and a Cout that is not a multiple of the 64-wide tile, at the FMA
    body's 32-deep and the mma body's 64-deep chunks and 1-3 slices, equals
    the JAX oracle and the Pallas kernel in interpret mode."""
    x, w, b = _case(H, KH, 24, Cout, seed=H)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    jb, tb = jnp.asarray(b), torch.from_numpy(b)
    ref = jax_conv_ref(jx, jw, jb, stride=stride)
    pallas = jax_pallas_conv(jx, jw, jb, stride=stride, bc=bc, interpret=True)
    K = KH * KH * 24
    for bk in (FMA_BK, MMA_BK):
        for splits in range(1, min(3, -(-K // bk)) + 1):
            out = _split_k_conv(tx, tw, tb, stride, bk, splits)
            assert out.dtype == tx.dtype
            _close(out, ref, dtype)
            _close(out, pallas, dtype)
