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
from repro_torch.kernels.matmul.ops import (batched_body_for, body_for, matmul,
                                           matmul_batched, narrow_tile, operand_strides,
                                           route, route_batched, tma_strides,
                                           writes_dominate)
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


def _fp32_sum_within_bound(got, terms):
    """``got`` (fp32) against the float64 sum of ``terms`` over their last
    axis, within the fp32 summation bound n 2^-24 sum|terms| per element
    (any order of n - 1 fp32 additions and the one rounding of the
    result).  A relative limit alone cannot hold a sum of mixed signs
    near 0."""
    terms = terms.astype(np.float64)
    want = terms.sum(-1)
    limit = terms.shape[-1] * 2.0 ** -24 * np.abs(terms).sum(-1)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= limit).all(), float((err / np.maximum(limit, 1e-300)).max())


@pytest.mark.parametrize("seed", range(8))
def test_cpu_calls_take_the_counted_plain_version(seed):
    k7 = dispatch.kernel_table()["matmul"]
    dispatch.reset_counts()
    torch.manual_seed(seed)
    x = torch.randn((3, 5, 8), requires_grad=True)
    w = torch.randn((8, 4), requires_grad=True)
    linear.matmul(x, w).sum().backward()     # an expanded (0, 0)-strided dY
    assert (k7.launches, k7.plain_calls) == (0, 3)   # forward, dX, dW
    xs, ws = x.detach().numpy(), w.detach().numpy()
    # dX[b, s, i] = sum_j w[i, j]; dW[i, j] = sum_(b, s) x[b, s, i]
    _fp32_sum_within_bound(x.grad.numpy(), np.broadcast_to(ws, (3, 5, 8, 4)))
    _fp32_sum_within_bound(w.grad.numpy(), np.broadcast_to(
        xs.reshape(15, 8).T[:, None, :], (8, 4, 15)))


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


def _padded(rows, cols, dtype, transposed):
    """A (rows, cols) operand of ``dtype`` whose row stride is a multiple of
    16 bytes: row-major, or (``transposed``) the transpose of a column
    slice of a wider row-major buffer, as a TMA-readable ``x.T`` is."""
    if transposed:
        pad = -(-rows // 8) * 8
        return torch.zeros((cols, pad), dtype=dtype)[:, :rows].T
    pad = -(-cols // 8) * 8
    return torch.zeros((rows, pad), dtype=dtype)[:, :cols]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("layout", ["rows", "x.T", "y.T", "both.T"])
@pytest.mark.parametrize("M,K,N", [(1, 2048, 256), (4, 2048, 11008), (513, 64, 256),
                                   (513, 11008, 2048)])
def test_route_takes_wgmma_for_aligned_16_bit_operands_only(dtype, layout, M, K, N):
    """K7's body is decided before the launch from the type and the layout:
    fp16 / bf16 operands that TMA can read go to wgmma, in all four layouts
    (the transposed ones with the transpose bit); an fp32 product never
    does.  The strides handed to the wgmma body name the contiguous dim
    with a 1 and give a row stride of whole 16-byte units."""
    x = _padded(M, K, dtype, layout in ("x.T", "both.T"))
    y = _padded(K, N, dtype, layout in ("y.T", "both.T"))
    want = "fma" if dtype == torch.float32 else "wgmma"
    assert body_for(x, y) == want
    for t, contiguous_dim in ((x, 0 if "x.T" in layout or "both" in layout else 1),
                              (y, 0 if "y.T" in layout or "both" in layout else 1)):
        strides = tma_strides(t)
        assert strides is not None and strides[contiguous_dim] == 1
        row = strides[1 - contiguous_dim]
        assert row > 1 and row * t.element_size() % 16 == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_route_keeps_unaligned_16_bit_operands_on_fma(dtype):
    """What TMA cannot read stays on the FMA body: a row stride that is not
    a multiple of 16 bytes (N = 3, 33, 130; K = 37; the tiling check's
    N = 300), a base that is not 16-byte aligned, and K = 0."""
    x = torch.zeros((16, 64), dtype=dtype)
    for n in (3, 33, 130, 300):
        assert body_for(x, torch.zeros((64, n), dtype=dtype)) == "fma"
    assert body_for(torch.zeros((5, 37), dtype=dtype), torch.zeros((37, 64), dtype=dtype)) \
        == "fma"
    assert body_for(torch.zeros((5, 64), dtype=dtype).T.contiguous().T,
                    torch.zeros((64, 64), dtype=dtype)) == "fma"   # x.T, row stride 5
    assert body_for(torch.zeros((16, 64), dtype=dtype).T.contiguous().T,
                    torch.zeros((64, 64), dtype=dtype)) == "wgmma"   # x.T, row stride 16
    buf = torch.zeros((16, 72), dtype=dtype)
    assert buf.data_ptr() % 16 == 0 and buf[:, 1:65].data_ptr() % 16 == 2
    assert body_for(buf[:, 1:65], torch.zeros((64, 64), dtype=dtype)) == "fma"
    assert body_for(buf[:, 8:72], torch.zeros((64, 64), dtype=dtype)) == "wgmma"
    assert body_for(torch.zeros((16, 0), dtype=dtype), torch.zeros((0, 64), dtype=dtype)) \
        == "fma"
    assert tma_strides(torch.zeros((7, 3), dtype=dtype)) is None


def test_tile_rule():
    """Decode (M <= 16) takes the narrow tile on either body; the wgmma body
    also takes it where the 128 x 128 tiles would number fewer than the
    132 SMs (qwen's N = 256 K/V projections, the N = 2048 products at 512
    tokens), the FMA body never."""
    assert narrow_tile(4, 11008, "wgmma") and narrow_tile(4, 11008, "fma")
    assert narrow_tile(16, 2048, "fma") and not narrow_tile(17, 2048, "fma")
    assert narrow_tile(512, 256, "wgmma") and not narrow_tile(512, 256, "fma")
    assert narrow_tile(512, 2048, "wgmma")
    assert not narrow_tile(512, 11008, "wgmma") and not narrow_tile(2048, 11008, "wgmma")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("layout", ["rows", "x.T", "y.T", "both.T"])
def test_route_hands_over_the_strides_tma_reads(dtype, layout):
    """One call decides the body and, for wgmma, gives each operand's
    strides as ``tma_strides`` reads them; the FMA body gets none, for fp32
    and for a 16-bit operand TMA cannot read (a 600-byte row)."""
    x = _padded(513, 2048, dtype, layout in ("x.T", "both.T"))
    y = _padded(2048, 256, dtype, layout in ("y.T", "both.T"))
    if dtype == torch.float32:
        assert route(x, y) == ("fma", None, None)
    else:
        assert route(x, y) == ("wgmma", tma_strides(x), tma_strides(y))
    assert route(x, torch.zeros((2048, 300), dtype=dtype)) == ("fma", None, None)


def test_tile_rule_reads_the_sm_count():
    """The wgmma body's narrow tile past decode depends on the card's SMs:
    at M = 512, N = 2048 the 4 x 16 wide tiles fill a card of 64 SMs but
    not one of 132; the FMA body and decode do not depend on it."""
    assert narrow_tile(512, 2048, "wgmma", 132) and not narrow_tile(512, 2048, "wgmma", 64)
    assert not narrow_tile(512, 2048, "fma", 132) and not narrow_tile(512, 2048, "fma", 1000)
    assert narrow_tile(4, 11008, "wgmma", 1) and narrow_tile(4, 11008, "fma", 1)


def test_bodies_are_counted_apart():
    """``count_launch`` adds to ``launches`` and to its body's count;
    ``reset_counts`` clears both; a CPU call counts only a plain call."""
    k7 = dispatch.kernel_table()["matmul"]
    dispatch.reset_counts()
    matmul(torch.zeros((2, 8), dtype=torch.bfloat16), torch.zeros((8, 8), dtype=torch.bfloat16))
    assert (k7.launches, k7.plain_calls, k7.body_launches) == (0, 1, {})
    k7.count_launch("wgmma")
    k7.count_launch("wgmma")
    k7.count_launch("fma")
    assert k7.launches == 3 and k7.body_launches == {"wgmma": 2, "fma": 1}
    dispatch.reset_counts()
    assert (k7.launches, k7.body_launches) == (0, {})


def _views(E, C, D, F, dtype, dy_cols=None):
    """The batched products of x (E, C, D) @ w (E, D, F) as the MoE layer
    and its backward hand them to K7's batched entry: {view: (x, y)}, on
    the meta device (the route reads shapes, strides and the base address
    alone).  ``dy_cols``: dY's row stride, where it is a slice of a wider
    buffer."""
    x = torch.empty((E, C, D), dtype=dtype, device="meta")
    w = torch.empty((E, D, F), dtype=dtype, device="meta")
    dy = torch.empty((E, C, dy_cols or F), dtype=dtype, device="meta")[:, :, :F]
    return {"fwd": (x, w), "dX": (dy, w.transpose(1, 2)), "dW": (x.transpose(1, 2), dy)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("E,C,D,F,view,want", [
    (64, 60, 2048, 1408, "dW", "wgmma_persistent"),    # training gate/up
    (64, 60, 1408, 2048, "dW", "wgmma_persistent"),    # training down
    (1, 60, 2048, 1408, "dW", "wgmma_persistent"),
    (64, 1, 2048, 1408, "dW", "wgmma_persistent"),
    (64, 61, 2048, 1408, "dW", "wgmma_persistent"),
    (64, 128, 2048, 1408, "dW", "wgmma_persistent"),
    (64, 129, 2048, 1408, "dW", "wgmma_persistent"),
    (64, 480, 2048, 1408, "dW", "wgmma_persistent"),   # 4096-token rows: writes 1.74x reads
    (64, 834, 2048, 1408, "dW", "wgmma_persistent"),   # the last C that writes >= reads
    (64, 835, 2048, 1408, "dW", "wgmma"),
    (64, 960, 2048, 1408, "dW", "wgmma"),              # writes 0.87x reads
    (4, 129, 264, 136, "dW", "wgmma"),                 # writes 0.70x reads
    (5, 13, 520, 1000, "dW", "wgmma_persistent"),      # ragged M and N, N % 8 == 0
    (64, 60, 2048, 1408, "dX", "wgmma"),
    (64, 60, 1408, 2048, "dX", "wgmma"),
    (64, 30, 2048, 1408, "fwd", "wgmma"),              # a prefill chunk's gate / up
    (64, 4, 1408, 2048, "fwd", "wgmma"),               # a decode step's down
    (2, 5, 64, 256, "fwd", "wgmma"),                   # K = 64, but reads 13x its writes
    (64, 30, 64, 1408, "fwd", "wgmma"),                # reads 2.2x its writes
    (64, 256, 128, 1408, "fwd", "wgmma_persistent"),   # writes 1.69x reads
])
def test_batched_route_names_the_persistent_body(dtype, E, C, D, F, view, want):
    """K7's batched entry sends a view TMA can read to the persistent body
    where it writes at least as many elements as it reads and its output
    row is a multiple of 16 bytes -- the experts' dW at both training
    shapes and up to C = 834 at their widths, a forward of a shallow
    contraction into many rows -- and every other view TMA can read to
    the tile-per-block wgmma body; both bodies read the operands at the
    strides ``tma_strides`` gives."""
    x, y = _views(E, C, D, F, dtype)[view]
    assert route_batched(x, y) == (want, tma_strides(x[0]), tma_strides(y[0]))
    assert batched_body_for(x, y) == want


@pytest.mark.parametrize("dtype,F,dy_cols,view,want", [
    (torch.bfloat16, 999, None, "dW", "fma"),    # dY's rows 1998 bytes: TMA cannot read it
    (torch.bfloat16, 999, None, "dX", "fma"),
    (torch.bfloat16, 999, 1008, "dW", "wgmma"),  # dY readable, the output row 1998 bytes
    (torch.float16, 999, 1008, "dW", "wgmma"),
    (torch.float32, 1408, None, "dW", "fma"),
    (torch.float32, 1408, None, "dX", "fma"),
    (torch.float32, 1408, None, "fwd", "fma"),
])
def test_batched_route_keeps_other_views_off_the_persistent_body(dtype, F, dy_cols, view, want):
    """An output row that is not a multiple of 16 bytes (N = 999) stays on
    the tile-per-block wgmma body where TMA can read the operands (dY a slice of a
    padded buffer) and on FMA where it cannot; fp32 never leaves FMA."""
    x, y = _views(64, 60, 2048, F, dtype, dy_cols)[view]
    assert batched_body_for(x, y) == want


@pytest.mark.parametrize("M,K,N,want", [
    (2048, 60, 1408, True), (2048, 834, 1408, True), (2048, 835, 1408, False),
    (30, 2048, 1408, False), (4, 2048, 1408, False), (1, 1, 1, False), (2, 1, 2, True)])
def test_writes_dominate_compares_elements_written_and_read(M, K, N, want):
    """The switch between the batched entry's wgmma bodies: M N >= K (M + N)."""
    assert writes_dominate(M, K, N) is want


def test_persistent_tile_rule_counts_every_expert():
    """The persistent body walks every expert's tiles with one grid, so
    its narrow tile is for a launch whose wide tiles, over all experts,
    are fewer than the SMs; the tile-per-block body counts one expert's."""
    assert not narrow_tile(2048, 1408, "wgmma_persistent", 132, 64)    # 11,264 wide tiles
    assert narrow_tile(264, 136, "wgmma_persistent", 132, 8)           # 48
    assert not narrow_tile(264, 136, "wgmma_persistent", 132, 22)      # 132
    assert narrow_tile(2048, 1408, "wgmma", 132) is False
    assert narrow_tile(30, 1408, "wgmma", 132) and narrow_tile(4, 1408, "wgmma_persistent", 1)


def test_batched_bodies_are_counted_apart():
    """The batched entry counts its two wgmma bodies under their own
    names; a CPU call counts only a plain call."""
    k7b = dispatch.kernel_table()["matmul_batched"]
    dispatch.reset_counts()
    matmul_batched(torch.zeros((2, 3, 8), dtype=torch.bfloat16),
                   torch.zeros((2, 8, 8), dtype=torch.bfloat16))
    assert (k7b.launches, k7b.plain_calls, k7b.body_launches) == (0, 1, {})
    for body in ("wgmma", "wgmma_persistent", "wgmma_persistent", "fma"):
        k7b.count_launch(body)
    assert k7b.launches == 4
    assert k7b.body_launches == {"wgmma": 1, "wgmma_persistent": 2, "fma": 1}
    dispatch.reset_counts()
    assert (k7b.launches, k7b.body_launches) == (0, {})
