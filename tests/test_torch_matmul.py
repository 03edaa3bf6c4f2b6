"""The port's K7 matmul wrapper and the linear layer on the CPU: the plain
version of K7 against the JAX oracle (``repro/kernels/matmul/ref.py``) and
against the Pallas TPU kernel in interpret mode, on the same numpy inputs;
ragged and transposed operands (which the Pallas kernel refuses) against
the oracle alone; the launcher's operand checks; and ``linear.matmul``'s
gradients against ``jax.vjp`` of the same product.

Tolerances: the card's own limit for K7 (``dispatch.matmul_tolerance_ratio``
<= 1): per element 2^-20 sqrt(K) max|ref| for fp32 (the two sum the same
fp32 products in other orders), plus twice the one output rounding,
2^-7 |ref| (bf16) or 2^-10 |ref| (fp16), where one side rounds a sum that
the other's order put across a rounding boundary.  Gradients: the same
limit with K the contraction length of each gradient product (N for dX,
M for dW); bf16 gradients are each one bf16 product in both frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul.kernel import matmul as jax_pallas_matmul
from repro.kernels.matmul.ref import matmul_ref as jax_matmul_ref
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.matmul.ops import matmul, operand_strides
from repro_torch.models.layers import linear

torch.set_num_threads(1)

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
# test_kernels.py's sweep: (m, k, n, bm, bn, bk)
SWEEP = [(128, 128, 128, 128, 128, 128), (256, 128, 384, 128, 128, 64),
         (512, 256, 128, 256, 128, 256)]


def _both(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(DTYPES[dtype])
    return j, tensor_from_numpy(np.asarray(j))


def _operands(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (_both(rng.standard_normal((m, k)).astype(np.float32), dtype),
            _both(rng.standard_normal((k, n)).astype(np.float32), dtype))


def _ratio(t_out, j_out, k):
    return dispatch.matmul_tolerance_ratio(
        t_out, torch.from_numpy(np.array(j_out.astype(jnp.float32))), k)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n,bm,bn,bk", SWEEP)
def test_plain_matches_oracle_and_pallas(dtype, m, k, n, bm, bn, bk):
    (jx, tx), (jy, ty) = _operands(m, k, n, dtype)
    out = matmul(tx, ty)
    assert out.dtype == tx.dtype and out.shape == (m, n)
    assert _ratio(out, jax_matmul_ref(jx, jy), k) <= 1.0
    pallas = jax_pallas_matmul(jx, jy, bm=bm, bn=bn, bk=bk, interpret=True)
    assert _ratio(out, pallas, k) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 130), (5, 37, 3), (33, 1, 7),
                                   (129, 70, 257), (16, 300, 33)])
@pytest.mark.parametrize("layout", ["rows", "x.T", "y.T", "both.T"])
def test_ragged_and_transposed_operands_match_oracle(dtype, m, k, n, layout):
    """Any M, N, K (the Pallas kernel asserts its tiles divide the shape),
    and operands handed over as transposed views, as the tied LM head and
    the backward products hand them."""
    (jx, tx), (jy, ty) = _operands(m, k, n, dtype, seed=1)
    if layout in ("x.T", "both.T"):
        tx = tx.T.contiguous().T            # same values, column-major
        assert not tx.is_contiguous() or 1 in tx.shape
    if layout in ("y.T", "both.T"):
        ty = ty.T.contiguous().T
    operand_strides(tx, "x", device=tx.device, dtypes=(tx.dtype,))
    operand_strides(ty, "y", device=ty.device, dtypes=(ty.dtype,))
    assert _ratio(matmul(tx, ty), jax_matmul_ref(jx, jy), k) <= 1.0


def test_launcher_checks_operands():
    cpu = torch.device("cpu")
    x = torch.zeros((6, 8))
    assert operand_strides(x, "x", device=cpu, dtypes=(torch.float32,)) == (8, 1)
    assert operand_strides(x.T, "x", device=cpu, dtypes=(torch.float32,)) == (1, 8)
    assert operand_strides(x[:1], "x", device=cpu, dtypes=(torch.float32,)) == (1, 1)
    with pytest.raises(ValueError, match="unit stride"):
        operand_strides(x[::2, ::2], "x", device=cpu, dtypes=(torch.float32,))
    with pytest.raises(ValueError, match="2-D"):
        operand_strides(x[None], "x", device=cpu, dtypes=(torch.float32,))
    with pytest.raises(ValueError, match="dtype"):
        operand_strides(x.half(), "x", device=cpu, dtypes=(torch.float32,))
    k7 = dispatch.kernel_table()["matmul"]
    with pytest.raises(ValueError, match="on the card"):
        k7.launch(x, x.T)


def test_cpu_calls_take_the_counted_plain_version():
    k7 = dispatch.kernel_table()["matmul"]
    dispatch.reset_counts()
    x = torch.randn((3, 5, 8), requires_grad=True)
    w = torch.randn((8, 4), requires_grad=True)
    linear.matmul(x, w).sum().backward()     # an expanded (0, 0)-strided dY
    assert (k7.launches, k7.plain_calls) == (0, 3)   # forward, dX, dW
    np.testing.assert_allclose(x.grad.numpy(),
                               np.broadcast_to(w.sum(1).detach().numpy(), (3, 5, 8)),
                               rtol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(),
                               np.broadcast_to(x.sum((0, 1)).detach().numpy()[:, None],
                                               (8, 4)), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 37, 64, 96), (1, 5, 48, 130)])
def test_linear_gradients_match_jax(dtype, shape):
    """Forward, dX and dW of ``linear.matmul`` on (B, S, K) x (K, N) against
    ``jax.vjp`` of the reference layers' einsum, on the same values and
    cotangent."""
    B, S, K, N = shape
    rng = np.random.default_rng(2)
    jx, tx = _both(rng.standard_normal((B, S, K)).astype(np.float32), dtype)
    jw, tw = _both(rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K), dtype)
    jg, tg = _both(rng.standard_normal((B, S, N)).astype(np.float32), dtype)
    out, vjp = jax.vjp(lambda x, w: jnp.einsum("bsk,kn->bsn", x, w), jx, jw)
    jdx, jdw = vjp(jg)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    tout = linear.matmul(tx, tw)
    tout.backward(tg)
    M = B * S
    assert _ratio(tout.detach().reshape(M, N), out.reshape(M, N), K) <= 1.0
    assert _ratio(tx.grad.reshape(M, K), jdx.reshape(M, K), N) <= 1.0
    assert _ratio(tw.grad, jdw, M) <= 1.0
