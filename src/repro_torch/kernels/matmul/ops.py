"""Block GEMM: the CUDA kernel ``csrc/matmul.cu`` beside its plain version,
behind one wrapper with the reference's signature (counterpart of
``repro/kernels/matmul/ops.py``).

The kernel takes any M, N and K and strided operands: each operand needs a
unit stride in one of its two dims, so a transposed view (``w.T``) reaches
the kernel as it is.  It has two bodies, and :func:`route` picks one
before the launch: fp16 / bf16 operands that TMA can read go to the
tensor cores (``wgmma``), everything else -- every fp32 product among
them -- to plain FMA.  The plain version multiplies in fp32 and rounds
once, as the kernel does.

The batched entry (:func:`matmul_batched`, the C entry ``matmul_batched``
of the same source, its own kernel-table entry ``"matmul_batched"``)
computes ``out[e] = x[e] @ y[e]`` for the E experts of a mixture-of-experts
layer in one launch: per expert the 2-D entry's route, tile rule and
arithmetic, each operand with a stride between its experts.  It has a
third body, ``"wgmma_persistent"`` (:func:`route_batched`), for a product
that writes at least as many elements as it reads (:func:`writes_dominate`)
-- the experts' dW = X^T @ dY of MoE training, contracting over the
capacity C: a persistent grid walks the output tiles with the stores
staged in shared memory and issued by TMA, overlapping the next tile's
work; the same instruction and order, so the same bits."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import matmul_tolerance_ratio, register_kernel
from repro_torch.kernels.matmul.ref import matmul_batched_ref, matmul_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
# matmul_batched: x y out, dtype E M N K, sxe, sxm sxk, sye, syk syn narrow body, stream
_BATCHED_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
MAX_EXPERTS = 65535    # the grid's third dim
NARROW_M = 16          # at most this many rows: the narrow tile (decode)
_INT_MAX = 2**31 - 1
_TENSOR_CORE = (torch.bfloat16, torch.float16)
TMA_ALIGN = 16         # bytes: a TMA operand's base address and row stride
WIDE = 128             # the wgmma body's wide tile is WIDE x WIDE
SMS = 132              # streaming multiprocessors of an H100 SXM (the tile rule's default)
_BODY_CODE = {"fma": 0, "wgmma": 1, "wgmma_persistent": 2}   # matmul_batched's `body`
_ENCODE_ERROR = 10000  # csrc/matmul.cu: ENCODE_ERROR + the CUresult of a failed encoding


def operand_strides(t: torch.Tensor, name: str, *, device, dtypes) -> tuple[int, int]:
    """Raise unless ``t`` is a 2-D tensor on ``device`` with one of
    ``dtypes`` and a unit stride in one of its dims (a row-major matrix or
    a transposed view of one); return its two strides in elements, a
    size-1 dim's stride read as 1 (its one index is 0).  What the K7
    launcher checks before handing raw pointers and strides to the kernel:
    unlike :func:`~repro_torch.kernels.dispatch.check_operand`, a view that
    is not contiguous passes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {list(dtypes)}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, not of shape {tuple(t.shape)}")
    strides = tuple(1 if n == 1 else s for n, s in zip(t.shape, t.stride()))
    if 1 not in strides:
        raise ValueError(f"{name} has strides {t.stride()}: one dim needs a unit stride")
    if max(strides) > _INT_MAX:
        raise ValueError(f"{name}: the kernel takes strides below 2**31")
    return strides


def tma_strides(t: torch.Tensor) -> tuple[int, int] | None:
    """``t``'s two strides in elements as the wgmma body reads them, or None
    where TMA cannot read ``t``.  One of the two is 1 and names the
    contiguous dim (dim 1 where both could be); the other, the row stride,
    is a multiple of ``TMA_ALIGN`` bytes, as is the base address.  A size-1
    outer dim's stride is never followed, so it is given as the inner
    extent rounded up to 8 elements."""
    if t.data_ptr() % TMA_ALIGN:
        return None
    for inner in (1, 0):
        outer = 1 - inner
        if t.shape[inner] != 1 and t.stride(inner) != 1:
            continue
        row = t.stride(outer) if t.shape[outer] > 1 else -(-t.shape[inner] // 8) * 8
        if row > 0 and row * t.element_size() % TMA_ALIGN == 0:
            return (row, 1) if inner == 1 else (1, row)
    return None


def route(x: torch.Tensor, y: torch.Tensor):
    """``(body, x strides, y strides)``: the body a product runs, decided
    before the launch from the type and the layout alone, and for
    ``"wgmma"`` (tensor cores, TMA-staged tiles) each operand's strides as
    :func:`tma_strides` gives them.  fp16 / bf16 operands that TMA can read
    with K >= 1 go to wgmma; everything else, every fp32 product among
    them, to ``"fma"`` with no strides."""
    if x.dtype not in _TENSOR_CORE or x.shape[1] == 0:
        return "fma", None, None
    xs = tma_strides(x)
    ys = tma_strides(y) if xs is not None else None
    if ys is None:
        return "fma", None, None
    return "wgmma", xs, ys


def body_for(x: torch.Tensor, y: torch.Tensor) -> str:
    """The body :func:`route` names for ``x @ y``."""
    return route(x, y)[0]


@functools.cache
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of ``device``'s card, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def narrow_tile(M: int, N: int, body: str, sms: int = SMS, experts: int = 1) -> bool:
    """Whether a product takes the narrow tile by default: M <=
    ``NARROW_M`` (decode) for every body, and for the wgmma bodies also
    where the wide tiles would number fewer than the card's ``sms`` (qwen's
    N = 256 K/V projections: 8 wide tiles at M = 512, 32 narrow ones) --
    for the persistent body, which walks every expert's tiles with one
    grid, the wide tiles of all ``experts``."""
    if M <= NARROW_M:
        return True
    return body.startswith("wgmma") and experts * -(-M // WIDE) * -(-N // WIDE) < sms


def _launch(x, y, *, tile: str | None = None):
    """Check the operands, allocate the output and launch the kernel on the
    current stream, on the body :func:`route` names.  ``tile`` forces
    ``"wide"`` (128 x 128) or ``"narrow"`` (FMA 16 x 32, wgmma 64 x 64); by
    default :func:`narrow_tile` decides."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    sxm, sxk = operand_strides(x, "x", device=dev, dtypes=tuple(_DTYPE_CODE))
    syk, syn = operand_strides(y, "y", device=dev, dtypes=(x.dtype,))
    M, K = x.shape
    K2, N = y.shape
    if K != K2:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} do not chain")
    if not (0 < M <= _INT_MAX and 0 < N <= _INT_MAX and K <= _INT_MAX):
        raise ValueError(f"the kernel takes 0 < M, N and K < 2**31, not "
                         f"M={M} N={N} K={K}")
    if tile not in (None, "wide", "narrow"):
        raise ValueError(f"tile {tile!r}: 'wide', 'narrow' or None")
    body, xs, ys = route(x, y)
    if body == "wgmma":
        (sxm, sxk), (syk, syn) = xs, ys
    narrow = narrow_tile(M, N, body, sm_count(dev)) if tile is None else tile == "narrow"
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    lib = build.load("matmul", _ARGTYPES)
    KERNEL.count_launch(body)
    err = lib.matmul(x.data_ptr(), y.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
                     M, N, K, sxm, sxk, syk, syn, int(narrow), int(body == "wgmma"),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        what = (f"cuTensorMapEncodeTiled returned {err - _ENCODE_ERROR}"
                if err >= _ENCODE_ERROR else f"CUDA error {err}")
        raise RuntimeError(f"matmul ({body} body, M={M} K={K} N={N}, strides x "
                           f"{(sxm, sxk)} y {(syk, syn)}): {what}")
    return out


def writes_dominate(M: int, K: int, N: int) -> bool:
    """Whether an (M x K) @ (K x N) product writes at least as many
    elements as it reads, ``M N >= K (M + N)``: the switch between the
    batched entry's two wgmma bodies.  The persistent body overlaps a
    tile's stores with the next tile's loads and product, which pays
    where the stores lead; the tile-per-block body keeps two blocks an SM
    on a three-stage ring, which hides the reads better where they lead.
    At deepseek-moe-16b's widths dW (M x N = 2048 x 1408) holds it up to a
    capacity C of 834; the forward and dX, contracting over 1408 or 2048
    for a few dozen rows, never do."""
    return M * N >= K * (M + N)


def route_batched(x: torch.Tensor, y: torch.Tensor):
    """:func:`route` of one expert's product ``x[0] @ y[0]``, on a wgmma
    body only where every expert's operands start 16-byte aligned too:
    with more than one expert, each operand's stride between experts is a
    positive multiple of ``TMA_ALIGN`` bytes.  Of those, a product that
    :func:`writes_dominate` into an output row (N elements) that is a
    multiple of ``TMA_ALIGN`` bytes -- the output map's stride -- goes to
    ``"wgmma_persistent"``, the rest to ``"wgmma"``."""
    body, xs, ys = route(x[0], y[0])
    if body == "wgmma" and any(
            t.shape[0] > 1 and (t.stride(0) <= 0 or t.stride(0) * t.element_size() % TMA_ALIGN)
            for t in (x, y)):
        return "fma", None, None
    _, M, K = x.shape
    N = y.shape[2]
    if body == "wgmma" and writes_dominate(M, K, N) and N * x.element_size() % TMA_ALIGN == 0:
        return "wgmma_persistent", xs, ys
    return body, xs, ys


def batched_body_for(x: torch.Tensor, y: torch.Tensor) -> str:
    """The body :func:`route_batched` names for the batched ``x @ y``."""
    return route_batched(x, y)[0]


def batch_stride(t: torch.Tensor, strides: tuple[int, int]) -> int:
    """Elements between ``t``'s experts: its own stride where it has more
    than one; where it has one, the extent of that expert's matrix at the
    ``strides`` the body reads -- never followed, but a rank-3 tensor map
    must hold a stride that is a multiple of 16 bytes."""
    if t.shape[0] > 1:
        return t.stride(0)
    outer = 0 if strides[1] == 1 else 1
    return t.shape[1 + outer] * strides[outer]


def _launch_batched(x, y, *, tile: str | None = None, body: str | None = None):
    """The batched entry: check the operands, allocate the (E, M, N) output
    and launch one kernel over all E experts on the body
    :func:`route_batched` names; ``tile`` as in the 2-D entry, and by
    default :func:`narrow_tile` of one expert's M and N (the persistent
    body's: of all E experts' tiles).  ``body`` forces
    ``"wgmma"`` or ``"wgmma_persistent"`` where the route names a wgmma
    body (the persistent one also needs a 16-byte output row), for timing
    the two on the same operands."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    if x.dim() != 3 or y.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must be 3-D: "
                         f"(E, M, K) and (E, K, N)")
    E, M, K = x.shape
    E2, K2, N = y.shape
    if E != E2 or K != K2:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} do not chain")
    if not 0 < E <= MAX_EXPERTS:
        raise ValueError(f"the kernel takes 0 < E <= {MAX_EXPERTS} experts, not {E}")
    if not (0 < M <= _INT_MAX and 0 < N <= _INT_MAX and K <= _INT_MAX):
        raise ValueError(f"the kernel takes 0 < M, N and K < 2**31, not "
                         f"M={M} N={N} K={K}")
    sxm, sxk = operand_strides(x[0], "x[e]", device=dev, dtypes=tuple(_DTYPE_CODE))
    syk, syn = operand_strides(y[0], "y[e]", device=dev, dtypes=(x.dtype,))
    if tile not in (None, "wide", "narrow"):
        raise ValueError(f"tile {tile!r}: 'wide', 'narrow' or None")
    routed, xs, ys = route_batched(x, y)
    if body is None:
        body = routed
    elif body not in ("wgmma", "wgmma_persistent") or routed == "fma" or (
            body == "wgmma_persistent" and N * x.element_size() % TMA_ALIGN):
        raise ValueError(f"body {body!r}: the route names {routed!r} for these operands")
    if body != "fma":
        (sxm, sxk), (syk, syn) = xs, ys
    sxe, sye = batch_stride(x, (sxm, sxk)), batch_stride(y, (syk, syn))
    narrow = (narrow_tile(M, N, body, sm_count(dev), E if body == "wgmma_persistent" else 1)
              if tile is None else tile == "narrow")
    out = torch.empty((E, M, N), dtype=x.dtype, device=dev)
    lib = build.load("matmul", _BATCHED_ARGTYPES, "matmul_batched")
    BATCHED.count_launch(body)
    err = lib.matmul_batched(x.data_ptr(), y.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
                             E, M, N, K, sxe, sxm, sxk, sye, syk, syn, int(narrow),
                             _BODY_CODE[body], torch.cuda.current_stream(dev).cuda_stream)
    if err:
        what = (f"cuTensorMapEncodeTiled returned {err - _ENCODE_ERROR}"
                if err >= _ENCODE_ERROR else f"CUDA error {err}")
        raise RuntimeError(f"matmul_batched ({body} body, E={E} M={M} K={K} N={N}, strides "
                           f"x {(sxe, sxm, sxk)} y {(sye, syk, syn)}): {what}")
    return out


KERNEL = register_kernel(
    "matmul", _launch, matmul_ref,
    source="src/repro_torch/csrc/matmul.cu",
    replaces="src/repro/kernels/matmul/kernel.py:36",
    tolerance=matmul_tolerance_ratio,
    gradient="repro_torch.models.layers.linear.matmul")


def matmul(x, y):
    """x: (M, K) @ y: (K, N) -> (M, N) in x's type, summed in fp32 and
    rounded once.  CUDA tensors run the kernel, CPU tensors the plain
    version."""
    return KERNEL(x, y)


BATCHED = register_kernel(
    "matmul_batched", _launch_batched, matmul_batched_ref,
    source="src/repro_torch/csrc/matmul.cu",
    replaces="src/repro/kernels/matmul/kernel.py:36",
    tolerance=matmul_tolerance_ratio,
    gradient="repro_torch.models.layers.linear.batched_matmul",
    note="K7's batched entry (matmul_batched in K7's source): the E experts' products "
         "of an MoE layer in one launch, where the reference runs XLA's batched "
         "einsums outside any Pallas kernel (src/repro/models/layers/moe.py:67-77)")


def matmul_batched(x, y):
    """x: (E, M, K) @ y: (E, K, N) -> (E, M, N) in x's type, each expert's
    product summed in fp32 and rounded once.  CUDA tensors run the kernel
    (one launch for every expert), CPU tensors the plain version."""
    return BATCHED(x, y)
