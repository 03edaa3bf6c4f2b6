"""K6's backward on the CPU: its plain version against JAX's gradient of
the reference conv, its rounding at GoogLeNet's shapes, and the autograd
Function that carries K6's gradient.

* ``conv2d_backward_ref`` (dx, dw, db as explicit fp32 formulas over the
  taps) against ``jax.vjp`` of ``repro/kernels/conv2d/ref.py::conv2d_ref``
  at KH 1/3/5/7, strides 1 and 2, odd maps, evaluated at fp32 and at fp64
  (JAX at fp32): each gradient within 1e-5 of its largest entry (two fp32
  sums in other orders; ~2e-7 is read).  And against autograd of the
  port's own ``conv2d_ref`` in fp64 (1e-12).
* Its rounding against the same formulas in fp64 at GoogLeNet's batch-8
  shapes: fp32 within ``GRAD_RTOL[fp32] / 20`` of each gradient's largest
  (1.1e-7 to 6.1e-7 is read), fp16 within ``GRAD_RTOL[fp16] / 2`` (one
  rounding, at most 2^-11; 2.9e-4 to 3.7e-4 is read) -- the source of the
  fp16 limit the card holds the kernel to.
* ``ops.conv2d``: through ``_Conv2d`` only where grad is on and an input
  requires it, dgrad only where x needs its gradient; the counts; the
  launcher's ctypes signature; the route of each pass
  (``backward_body_for``), its tile and the split plan of both passes.
* The identity the ring dgrad rests on: at stride 1, dx is the plain
  forward conv of dy by the flipped, transposed weight with the pads
  swapped (fp64, against ``conv2d_backward_ref``).
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d.ref import conv2d_ref as jax_conv2d_ref
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.conv2d import ops
from repro_torch.kernels.conv2d.ref import conv2d_backward_ref, conv2d_ref, same_padding
from repro_torch.kernels.dispatch import GRAD_RTOL
from repro_torch.models.googlenet import conv_shapes

torch.set_num_threads(1)

REL = 1e-5
# (B, H, W, Cin, KH, Cout, stride): KH 1 / 3 / 5 / 7, strides 1 and 2, odd
# maps, SAME padding symmetric and not
CASES = ((2, 9, 7, 3, 7, 5, 2), (2, 8, 8, 4, 3, 6, 1), (2, 7, 9, 5, 5, 3, 2),
         (1, 6, 5, 3, 1, 4, 2), (2, 11, 11, 4, 3, 8, 2), (2, 12, 12, 6, 5, 4, 1),
         (1, 13, 11, 3, 7, 8, 1), (2, 10, 10, 8, 1, 16, 1))
# GoogLeNet's batch-8 convs at 224 held for rounding: every kernel size,
# maps from 112^2 to 7^2, a Cout no tile divides
ROUNDING_SHAPES = ("stem1", "stem2r", "3a.b1", "3a.b3", "4a.b2", "4a.b3", "4e.b2",
                   "5a.b1", "5b.b2")


def _case(B, H, W, Cin, KH, Cout, stride, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, Cin)).astype(np.float32)
    w = (rng.standard_normal((KH, KH, Cin, Cout)) / np.sqrt(KH * KH * Cin)).astype(np.float32)
    b = rng.standard_normal(Cout).astype(np.float32)
    dy = rng.standard_normal((B, -(-H // stride), -(-W // stride), Cout)).astype(np.float32)
    return x, w, b, dy


def _rel(a, r):
    a, r = np.asarray(a, dtype=np.float64), np.asarray(r, dtype=np.float64)
    assert a.shape == r.shape
    return np.abs(a - r).max() / max(np.abs(r).max(), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp(case, dtype):
    *shape, stride = case
    x, w, b, dy = _case(*shape, stride)
    _, vjp = jax.vjp(lambda x, w, b: jax_conv2d_ref(x, w, b, stride=stride),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    got = conv2d_backward_ref(*(torch.from_numpy(t).to(dtype) for t in (x, w, b, dy)),
                              stride=stride)
    assert [g.dtype for g in got] == [dtype] * 3
    for g, j in zip(got, want):
        assert _rel(g.numpy(), j) <= REL
    dx, dw, db = conv2d_backward_ref(*(torch.from_numpy(t).to(dtype) for t in (x, w, b, dy)),
                                     stride=stride, need_dx=False)
    assert dx is None and torch.equal(dw, got[1]) and torch.equal(db, got[2])


@pytest.mark.parametrize("case", CASES[:4])
def test_plain_backward_matches_autograd_of_the_forward(case):
    *shape, stride = case
    x, w, b, dy = (torch.from_numpy(t).double() for t in _case(*shape, stride, seed=1))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    conv2d_ref(*leaves, stride=stride).backward(dy)
    for g, leaf in zip(conv2d_backward_ref(x, w, b, dy, stride=stride), leaves):
        assert _rel(g.numpy(), leaf.grad.numpy()) <= 1e-12


@pytest.mark.parametrize("name", ROUNDING_SHAPES)
def test_plain_backward_rounding_at_googlenet_shapes(name):
    """fp32 and fp16 gradients of the plain backward against the same
    formulas in fp64 on the same values: the rounding the card's limits
    (``GRAD_RTOL``) are set from."""
    _, xs, ws, stride = next(c for c in conv_shapes(8, 224) if c[0] == name)
    x, w, b, dy = _case(xs[0], xs[1], xs[2], xs[3], ws[0], ws[3], stride)
    need_dx = name != "stem1"
    for dtype in (torch.float32, torch.float16):
        args = [torch.from_numpy(t).to(dtype) for t in (x, w, dy)]
        bias = torch.from_numpy(b)
        got = conv2d_backward_ref(args[0], args[1], bias, args[2], stride=stride,
                                  need_dx=need_dx)
        ref = conv2d_backward_ref(args[0].double(), args[1].double(), bias.double(),
                                  args[2].double(), stride=stride, need_dx=need_dx)
        assert [g is None for g in got] == [not need_dx, False, False]
        for g, r in zip(got[:2], ref[:2]):
            if g is not None:
                assert g.dtype == dtype
                assert _rel(g.numpy(), r.numpy()) <= GRAD_RTOL[dtype] / (20 if dtype == torch.float32 else 2)
        assert got[2].dtype == torch.float32
        assert _rel(got[2].numpy(), ref[2].numpy()) <= GRAD_RTOL[torch.float32] / 20


def test_conv2d_takes_the_function_only_for_gradients():
    x, w, b, dy = (torch.from_numpy(t) for t in _case(2, 9, 7, 3, 7, 5, 2))
    table = dispatch.kernel_table()
    fwd, bwd = table["conv2d"], table["conv2d_backward"]
    assert fwd.gradient == "repro_torch.kernels.conv2d.ops.conv2d"
    assert bwd.note and bwd.replaces == fwd.replaces
    dispatch.reset_counts()
    assert ops.conv2d(x, w, b, stride=2).grad_fn is None
    wg, bg = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    with torch.no_grad():
        assert ops.conv2d(x, wg, bg, stride=2).grad_fn is None
    assert (fwd.plain_calls, bwd.plain_calls) == (2, 0)
    # x needs no gradient (GoogLeNet's images): dw and db, no dgrad
    seen = []
    plain = bwd.plain
    bwd.plain = lambda *a, **kw: seen.append(kw["need_dx"]) or plain(*a, **kw)
    try:
        out = ops.conv2d(x, wg, bg, stride=2)
        assert type(out.grad_fn).__name__ == "_Conv2dBackward"
        out.backward(dy)
        xg = x.clone().requires_grad_(True)
        ops.conv2d(xg, wg, bg, stride=2).backward(dy)
    finally:
        bwd.plain = plain
    assert seen == [False, True]
    assert (fwd.plain_calls, bwd.plain_calls) == (4, 2)
    want = conv2d_backward_ref(x, w, b, dy, stride=2)
    for got, ref in zip((xg.grad, wg.grad / 2, bg.grad / 2), want):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_backward_launcher_refuses_cpu_tensors():
    x, w, b, dy = (torch.from_numpy(t) for t in _case(1, 6, 5, 3, 1, 4, 2))
    with pytest.raises(ValueError, match="on the card"):
        ops._launch_backward(x, w, b, dy, stride=2)


def test_backward_argtypes_match_the_c_entry_point():
    text = (build.CSRC / "conv2d_backward.cu").read_text()
    m = re.search(r'extern "C" int conv2d_backward\(([^)]*)\)', text)
    names = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in m.group(1).replace("\n", " ").split(",")]
    assert ops._BWD_ARGTYPES == [names[p] for p in params]


def test_backward_splits_on_googlenet_shapes():
    """Each pass is split only where its output tiles are fewer than the
    SMs, by the forward's rule on the pass's body's tile and chunk, and
    each slice keeps two chunks."""
    for bodies in (("fma", "fma"), ("mma", "mma"), ("gather", "gather")):
        for name, xs, ws, stride in conv_shapes(8, 224):
            B, H, W, Cin = xs
            KH, KW, _, Cout = ws
            pixels = B * -(-H // stride) * -(-W // stride)
            for body, splits, (M, N, K) in zip(
                    bodies, ops.backward_splits(xs, ws, stride, bodies),
                    ((B * H * W, Cin, KH * KW * Cout), (KH * KW * Cin, Cout, pixels))):
                bm, bk = ops.backward_tile(body, M, N), ops.BWD_BK[body]
                tiles = -(-M // bm) * -(-N // 64)
                assert bm == (128 if body != "gather" and -(-M // 128) * -(-N // 64) >= ops.SMS
                              else 64)
                assert splits == ops.conv_splits(M, N, K, bm, 64, bk)
                assert splits == 1 or (tiles < ops.SMS and -(-K // bk) >= 2 * splits)
    assert ops.backward_splits((8, 224, 224, 3), (7, 7, 3, 64), 2, ("gather", "fma")) == (1, 44)
    assert ops.backward_splits((8, 7, 7, 192), (3, 3, 192, 384), 1, ("fma", "fma")) == (7, 1)
    assert ops.backward_splits((8, 224, 224, 3), (7, 7, 3, 64), 2, ("gather", "mma")) == (1, 44)


def test_backward_route_on_the_training_shapes():
    """``backward_body_for`` on GoogLeNet's training convs: every dgrad the
    path asks for (stride 1) and every wgrad on the ring bodies -- "fma" at
    fp32, "mma" at fp16 / bf16 -- stem1's 3-channel x gathered inside
    wgrad's ring body; the gather body for a dgrad at a stride, a Cout the
    16-byte pieces do not fit, or an unaligned dy or w."""
    for dtype, ring in ((torch.float32, "fma"), (torch.float16, "mma"),
                        (torch.bfloat16, "mma")):
        for name, xs, ws, stride in conv_shapes(2, 32):
            x, w = torch.zeros(xs, dtype=dtype), torch.zeros(ws, dtype=dtype)
            dy = torch.zeros((xs[0], -(-xs[1] // stride), -(-xs[2] // stride), ws[3]),
                             dtype=dtype)
            assert ops.backward_body_for(x, w, dy, stride) == (
                "gather" if stride > 1 else ring, ring), name
            assert ops.x_in_pieces(x, w) == (name != "stem1")
        x, w = torch.zeros((2, 9, 9, 16), dtype=dtype), torch.zeros((3, 3, 16, 12), dtype=dtype)
        dy = torch.zeros((2, 9, 9, 12), dtype=dtype)
        assert ops.backward_body_for(x, w, dy, 1) == (
            ("fma", "fma") if dtype == torch.float32 else ("gather", "gather"))
        wa = torch.zeros((3 * 3 * 16 * 16 + 1,), dtype=dtype)[1:].view(3, 3, 16, 16)
        dya = torch.zeros((2 * 9 * 9 * 16 + 1,), dtype=dtype)[1:].view(2, 9, 9, 16)
        assert ops.backward_body_for(x, wa, dya[:, :, :, :16], 1) == ("gather", "gather")
        assert ops.backward_body_for(x, wa, torch.zeros((2, 9, 9, 16), dtype=dtype), 1) == \
            ("gather", ring)


def _flipped_dgrad(dy, w, H, W):
    """dx at stride 1 as the ring dgrad computes it: the plain forward conv
    (``conv2d_ref``) of dy by w flipped in both taps and transposed (ci and
    co swapped), whose pads are the forward's swapped -- the forward's
    after-pad goes before.  ``conv2d_ref`` pads SAME (s = (KH - 1) // 2
    before), so dy is first zero-padded by KH on each side and the window
    is cut where row h of dx reads dy from h - pb on."""
    KH, KW = w.shape[:2]
    _, pb = same_padding(H, KH, 1)
    _, pr = same_padding(W, KW, 1)
    wf = w.flip(0, 1).transpose(2, 3).contiguous()
    padded = torch.nn.functional.pad(dy, (0, 0, KW, KW, KH, KH))
    full = conv2d_ref(padded, wf, torch.zeros(wf.shape[3], dtype=dy.dtype))
    h0, w0 = (KH - 1) // 2 + KH - pb, (KW - 1) // 2 + KW - pr
    return full[:, h0:h0 + H, w0:w0 + W, :]


@pytest.mark.parametrize("name", ["stem2r", "stem2", "3a.b3", "4a.b2", "5b.b3", "4x2", "2x2"])
def test_flipped_weight_dgrad_equals_the_plain_backward(name):
    """The identity the ring dgrad rests on: at stride 1, dx is the SAME
    conv of dy by the flipped, transposed weight with the before and after
    pads swapped.  On GoogLeNet's stride-1 windows (1x1, 3x3, 5x5; their
    pads are even, so the swap is a no-op there) and on even windows whose
    pads differ (4x2: 1 / 2 and 0 / 1; 2x2), held in fp64 against
    ``conv2d_backward_ref``'s dx."""
    shapes = {n: (xs, ws) for n, xs, ws, stride in conv_shapes(2, 32) if stride == 1}
    shapes.update({"4x2": ((2, 9, 10, 6), (4, 2, 6, 5)), "2x2": ((1, 7, 8, 3), (2, 2, 3, 4))})
    xs, ws = shapes[name]
    x, w, b, dy = (torch.from_numpy(t).double()
                   for t in _case(xs[0], xs[1], xs[2], xs[3], ws[0], ws[3], 1))
    if ws[1] != ws[0]:
        w = torch.from_numpy(np.random.default_rng(3).standard_normal(ws))
    want = conv2d_backward_ref(x, w, b, dy)[0]
    got = _flipped_dgrad(dy, w, xs[1], xs[2])
    assert got.shape == want.shape
    assert _rel(got.numpy(), want.numpy()) <= 1e-12
