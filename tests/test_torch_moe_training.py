"""The gradients of the port's mixture-of-experts layer against the JAX
reference (``repro/models/layers/moe.py``) on the CPU, on the same
numpy-seeded inputs and weights (handed over through
``repro_torch.interop``).

* ``linear.batched_matmul`` (K7's batched entry, its plain version here):
  dX and dW against fp64 autograd and against ``jax.grad`` of the
  reference's ``"ecd,edf->ecf"`` einsum, at fp32, on the training shapes'
  layout cut small and on ragged ones (a contraction of 1 and 7 rows in
  dW), with an incoming gradient of zero strides.  fp32: 2e-6 of the
  largest entry (the same products summed in fp32 in other orders).
* ``route`` + ``moe_einsum``: the gradients of the reference's loss in
  ``tests/test_moe.py::test_moe_grad_flows`` (``sum(y ** 2) + aux``) with
  respect to x, the router and the three expert weights, at fp32 with
  capacity_factor 4.0 (nothing drops), 1.0, 0.5 and a capacity of 1
  (choices drop).  Each leaf within 1e-5 of its largest entry (fp32 sums
  in other orders, through a softmax and a SwiGLU).
* The capacity dispatch's backward: the same bits on two runs, a dropped
  choice adding exactly zero, and at bf16 each token's kept rows summed
  in fp32 and rounded once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models.layers import moe as JM
from repro.models.layers.module import init_table
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.matmul import ops as K7
from repro_torch.models.layers import linear
from repro_torch.models.layers import moe as TM

torch.set_num_threads(1)

MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
BATCHED_REL = 2e-6   # fp32 products of K <= 48 terms, other summation orders
MOE_GRAD_REL = 1e-5  # each leaf, of its largest


def _rel(t, ref):
    t = t.detach().double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    ref = np.asarray(ref, np.float64)
    assert t.shape == ref.shape
    return float(np.abs(t - ref).max() / max(np.abs(ref).max(), 1e-30))


# (E, M, K, N): the expert products' layout cut small (C rows of D into F),
# a contraction of 1 and of 7 rows in dW (C = 1, 7), odd sizes
BATCHED_SHAPES = [(4, 12, 32, 24), (3, 1, 16, 20), (5, 7, 33, 17), (2, 61, 9, 40)]


@pytest.mark.parametrize("shape", BATCHED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_batched_matmul_gradients_match_fp64_and_jax(shape):
    E, M, K, N = shape
    rng = np.random.default_rng(sum(shape))
    xn = rng.standard_normal((E, M, K)).astype(np.float32)
    wn = rng.standard_normal((E, K, N)).astype(np.float32)
    dyn = rng.standard_normal((E, M, N)).astype(np.float32)
    x = torch.from_numpy(xn).requires_grad_(True)
    w = torch.from_numpy(wn).requires_grad_(True)
    dispatch.reset_counts()
    y = linear.batched_matmul(x, w)
    y.backward(torch.from_numpy(dyn))
    # the forward and its two backward products, each one call of the entry
    assert dispatch.kernel_table()["matmul_batched"].plain_calls == 3
    x64 = torch.from_numpy(xn).double().requires_grad_(True)
    w64 = torch.from_numpy(wn).double().requires_grad_(True)
    torch.bmm(x64, w64).backward(torch.from_numpy(dyn).double())
    assert _rel(x.grad, x64.grad) <= BATCHED_REL
    assert _rel(w.grad, w64.grad) <= BATCHED_REL
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(jnp.einsum("ecd,edf->ecf", a, b) * dyn),
                        argnums=(0, 1))(jnp.asarray(xn), jnp.asarray(wn))
    assert _rel(x.grad, jdx) <= BATCHED_REL
    assert _rel(w.grad, jdw) <= BATCHED_REL


def test_batched_matmul_takes_a_zero_strided_gradient():
    """``y.sum()`` hands the backward an expanded scalar (strides 0, 0, 0):
    it is made contiguous before the entry reads it."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 5, 8)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((3, 8, 6)).astype(np.float32)).requires_grad_(True)
    linear.batched_matmul(x, w).sum().backward()
    ones = torch.ones(3, 5, 6, dtype=torch.float64)
    torch.testing.assert_close(x.grad.double(), ones @ w.detach().double().transpose(1, 2),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(w.grad.double(), x.detach().double().transpose(1, 2) @ ones,
                               rtol=1e-6, atol=1e-6)


def test_batched_entry_names_its_gradient_wrapper():
    """A direct call of the batched entry on the card with an input that
    requires grad raises, naming the differentiable wrapper."""
    assert K7.BATCHED.gradient == "repro_torch.models.layers.linear.batched_matmul"


def _layer(arch, **moe_kw):
    """The smoke config's MoE layer weights from the reference's init, both
    sides' configs, and x (2, 12, d_model) from numpy, at fp32."""
    jm = dataclasses.replace(JR.smoke(arch).moe, **moe_kw)
    tm = dataclasses.replace(TR.smoke(arch).moe, **moe_kw)
    d = JR.smoke(arch).d_model
    jp = init_table(jax.random.PRNGKey(3), JM.moe_table(
        d, jm.num_experts, jm.d_ff_expert), "float32")
    npp = jax.tree_util.tree_map(np.asarray, jp)
    x = np.random.default_rng(5).standard_normal((2, 12, d)).astype(np.float32)
    return jm, tm, npp, x


# capacity_factor 4.0 (the smoke configs': nothing drops), then cases that drop
CAPACITY = [dict(), dict(capacity_factor=1.0), dict(capacity_factor=0.5),
            dict(capacity=1)]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("case", CAPACITY, ids=["cf4", "cf1", "cf0.5", "capacity1"])
def test_moe_gradients_match_jax(arch, case):
    case = dict(case)
    capacity = case.pop("capacity", None)
    jm, tm, npp, xn = _layer(arch, **case)

    def jloss(p, x):
        idx, prob, aux = JM.route(jm, p, x)
        y = JM.moe_einsum(jm, p, x, idx, prob, capacity=capacity)
        return jnp.sum(y ** 2) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, npp), jnp.asarray(xn))
    tp = params_from_numpy(npp)
    for p in tp.values():
        p.requires_grad_(True)
    x = torch.from_numpy(xn).requires_grad_(True)
    dispatch.reset_counts()
    idx, prob, aux = TM.route(tm, tp, x)
    y = TM.moe_einsum(tm, tp, x, idx, prob, capacity=capacity)
    (y.square().sum() + aux).backward()
    table = dispatch.kernel_table()
    # the router's product and its two backward products; the experts'
    # three products and two backward products each
    assert table["matmul"].plain_calls == 3
    assert table["matmul_batched"].plain_calls == 9
    if case or capacity:                      # choices drop
        cap = capacity or TM.capacity_of(tm, 12)
        assert not bool(TM.dispatch_slots(tm, idx, cap)[1].all())
    assert _rel(x.grad, jgx) <= MOE_GRAD_REL
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert _rel(tp[k].grad, jg[k]) <= MOE_GRAD_REL, k


def _dispatch_inputs(dtype, capacity=2):
    """A layer's routes with drops (capacity 2 for 24 choices of 8 experts
    a batch row), and x, dxs and drows from numpy."""
    tm = dataclasses.replace(TR.smoke("deepseek-moe-16b").moe)
    rng = np.random.default_rng(11)
    idx = torch.from_numpy(np.stack([rng.permutation(8)[:2] for _ in range(2 * 12)])
                           .reshape(2, 12, 2))
    slot, keep = TM.dispatch_slots(tm, idx, capacity)
    rows = 8 * 2 * capacity
    x = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32)).to(dtype)
    dxs = torch.from_numpy(rng.standard_normal((rows, 16)).astype(np.float32)).to(dtype)
    drows = torch.from_numpy(rng.standard_normal((24, 2, 16)).astype(np.float32)).to(dtype)
    return slot.reshape(24, 2), keep.reshape(24, 2), rows, x, dxs, drows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_backward_sums_kept_rows_once(dtype):
    """Each token's gradient is its kept rows of dxs summed in fp32 in
    choice order and rounded once to x's type; a dropped choice adds
    exactly zero; two runs give the same bits.  The combine's backward
    writes each kept row's gradient once and leaves every other row 0."""
    slot, keep, rows, x, dxs, drows = _dispatch_inputs(dtype)
    assert 0 < int(keep.sum()) < keep.numel()
    got = []
    for _ in range(2):
        xr = x.clone().requires_grad_(True)
        xs = TM._Dispatch.apply(xr, slot, keep, rows)
        xs.backward(dxs)
        got.append(xr.grad)
    assert torch.equal(got[0], got[1]) and got[0].dtype == dtype
    want = torch.zeros(24, 16, dtype=torch.float32)
    for t in range(24):
        for j in range(2):
            if keep[t, j]:
                want[t] += dxs[slot[t, j]].float()
    assert torch.equal(got[0], want.to(dtype))
    # the forward: each kept slot holds its token, every other row zeros
    live = torch.zeros(rows, dtype=torch.bool)
    live[slot[keep]] = True
    assert torch.equal(xs[~live], torch.zeros_like(xs[~live]))
    ys = torch.from_numpy(np.random.default_rng(2).standard_normal((rows, 16))
                          .astype(np.float32)).to(dtype).requires_grad_(True)
    out = TM._Combine.apply(ys, slot, keep)
    assert torch.equal(out[~keep], torch.zeros_like(out[~keep]))
    out.backward(drows)
    assert torch.equal(ys.grad[slot[keep]], drows[keep])
    assert torch.equal(ys.grad[~live], torch.zeros_like(ys.grad[~live]))
