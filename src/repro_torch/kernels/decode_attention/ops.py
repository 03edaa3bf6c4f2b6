"""Decode attention, dense and paged: the CUDA kernels
``csrc/decode_attention.cu`` and ``csrc/paged_decode_attention.cu``, each
beside its plain version behind one wrapper with the reference's signature
(counterpart of ``repro/kernels/decode_attention/ops.py``).

Each kernel has two bodies, and :func:`body_for` (paged) or
:func:`dense_body_for` (dense) picks one before the launch: bf16 at
head_dim 64 or 128 with at most 8 query heads per kv head splits the KV
length over many blocks and merges them (``mma``: two launches from one
call, the products on the tensor cores; one split body,
``csrc/decode_split.cuh``, behind its row loaders), everything else --
every fp32 call among them -- runs the first, one-block-per-group FMA
body.  The paged kernel also reads int8 pools with fp32 scales per (block,
row, kv head), on the same two bodies by the same rule (``mma_i8``,
``fma_i8``): each row is dequantized to q's type as it is staged.  The
dense kernel also returns, when asked, each row's log-sum-exp (both
bodies): what the sequence-sharded decode merges across its shards."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      paged_decode_attention_ref)
from repro_torch.kernels.dispatch import (check_operand, check_scales,
                                          lse_tolerance_ratio, register_kernel)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float] * 2 \
    + [ctypes.c_int, ctypes.c_void_p]
_DENSE_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
MMA_HEAD_DIMS = (64, 128)    # the split body's template instances
MMA_MAX_GROUP = 8            # query heads per kv head: the n = 8 side of m16n8k16
SPLIT_KEYS = 64              # keys one block of the split body takes


def body_for(q: torch.Tensor, k_pool: torch.Tensor) -> str:
    """The body a paged call runs, decided before the launch from the
    types, head_dim and group size G = H / K alone: ``"mma"`` (split over
    the KV length, tensor cores) for bf16 at head_dim 64 or 128 and G <= 8,
    ``"fma"`` for everything else, every fp32 call among them; on an int8
    pool the same rule names the int8 bodies, ``"mma_i8"`` and
    ``"fma_i8"``."""
    G = q.shape[1] // k_pool.shape[2]
    body = "fma"
    if (q.dtype == torch.bfloat16 and q.shape[-1] in MMA_HEAD_DIMS
            and G <= MMA_MAX_GROUP):
        body = "mma"
    return body + "_i8" if k_pool.dtype == torch.int8 else body


def dense_body_for(q: torch.Tensor, k: torch.Tensor) -> str:
    """The body a dense call runs: K1's rule on the cache's kv heads
    (``k``: (B, S, K, D)), decided before the launch from the type,
    head_dim and G alone."""
    return body_for(q, k)


def num_splits(max_blocks: int, block_size: int) -> int:
    """Blocks of the split body per (sequence, kv head): the table's
    max_blocks * block_size keys in runs of ``SPLIT_KEYS``.  From the table
    width, never from ``lengths`` (a device value)."""
    return -(-max_blocks * block_size // SPLIT_KEYS)


def _launch(q, k_pool, v_pool, block_tables, lengths, *, k_scale=None,
            v_scale=None, softcap=0.0, chunk=1024, body=None):
    """Check the operands, allocate the output (and, for the split body, its
    fp32 scratch in one allocation) and launch the kernel on the current
    stream, on the body :func:`body_for` names; ``body`` overrides that
    route, to time one body against the other on the same inputs.
    ``chunk`` is the plain version's KV tile and is unused here."""
    del chunk
    B, H, D = q.shape
    N, bs, K, _ = k_pool.shape
    mb = block_tables.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    quant = check_scales(k_pool, k_scale, v_scale)
    check_operand(q, "q", device=dev, dtypes=tuple(_DTYPE_CODE), align=16)
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        check_operand(pool, name, device=dev,
                      dtypes=(torch.int8,) if quant else (q.dtype,),
                      shape=(N, bs, K, D), align=16)
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if quant:
            check_operand(sc, name, device=dev, dtypes=(torch.float32,),
                          shape=(N, bs, K), align=4)
    check_operand(block_tables, "block_tables", device=dev,
                  dtypes=(torch.int32,), shape=(B, mb))
    check_operand(lengths, "lengths", device=dev, dtypes=(torch.int32,),
                  shape=(B,))
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if (D * q.element_size()) % 16 or (quant and D % 16):
        raise ValueError(f"head_dim {D}: q and pool rows must be a multiple "
                         f"of 16 bytes")
    route = body_for(q, k_pool)
    body = body or route
    bodies = ("mma_i8", "fma_i8") if quant else ("mma", "fma")
    if body not in bodies or (body == bodies[0] and route != bodies[0]):
        raise ValueError(f"paged_decode_attention: no {body!r} body for "
                         f"{q.dtype} on a {k_pool.dtype} pool at head_dim {D}, "
                         f"G {H // K}")
    split = body == bodies[0]
    out = torch.empty_like(q)
    ns = num_splits(mb, bs)
    scratch = (torch.empty(B * H * ns * (D + 2), dtype=torch.float32,
                           device=dev) if split else None)
    lib = build.load("paged_decode_attention", _ARGTYPES)
    KERNEL.count_launch(body)
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        _DTYPE_CODE[q.dtype], int(quant), B, H, K, D, bs, mb, N, ns,
        1.0 / (D ** 0.5), float(softcap), int(split),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention: CUDA error {err}")
    return out


KERNEL = register_kernel(
    "paged_decode_attention", _launch, paged_decode_attention_ref,
    source="src/repro_torch/csrc/paged_decode_attention.cu",
    replaces="src/repro/kernels/decode_attention/kernel.py:163")


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           k_scale=None, v_scale=None, softcap: float = 0.0,
                           chunk: int = 1024):
    """One query token per sequence against the paged KV pool.

    q: (B, H, D); k_pool/v_pool: (N, bs, K, D), in q's type or int8 with
    k_scale/v_scale (N, bs, K) fp32 (each row dequantized to q's type
    before both products, as the reference does); block_tables: (B,
    max_blocks) int32; lengths: (B,) int32 valid rows.  Returns (B, H, D).
    CUDA tensors run the kernel, CPU tensors the plain version.  An int8
    pool without scales, or scales beside another pool, raises.
    """
    check_scales(k_pool, k_scale, v_scale)
    return KERNEL(q, k_pool, v_pool, block_tables, lengths, k_scale=k_scale,
                  v_scale=v_scale, softcap=softcap, chunk=chunk)


def _launch_dense(q, k, v, lengths, *, chunk=1024, return_lse=False, body=None):
    """Check the operands, allocate the output (with ``return_lse`` the
    row log-sum-exp's m and l too; for the split body its fp32 scratch in
    one allocation) and launch the dense kernel on the current stream, on
    the body :func:`dense_body_for` names; ``body`` overrides that route.
    ``chunk`` only tiles the plain version.  The
    kernel reads q and the cache in one type: a cache in a narrower type
    than q (bf16 caches under an fp32 model, as the wave path builds them)
    is widened to q's first, exactly; p then stays in q's type where the
    plain version, as the reference's attention, rounds it to the cache's,
    so on such a pair the two are one rounding of p apart.  A cache in a
    wider type than q raises."""
    del chunk
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    if (k.dtype != q.dtype and k.dtype in _DTYPE_CODE
            and k.element_size() < q.element_size()):
        k, v = k.to(q.dtype), v.to(q.dtype)
    check_operand(q, "q", device=dev, dtypes=tuple(_DTYPE_CODE), align=16)
    for name, t in (("k", k), ("v", v)):
        check_operand(t, name, device=dev, dtypes=(q.dtype,),
                      shape=(B, S, K, D), align=16)
    check_operand(lengths, "lengths", device=dev, dtypes=(torch.int32,),
                  shape=(B,))
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if (D * q.element_size()) % 16:
        raise ValueError(f"head_dim {D}: rows must be a multiple of 16 bytes")
    route = dense_body_for(q, k)
    body = body or route
    if body not in ("mma", "fma") or (body == "mma" and route != "mma"):
        raise ValueError(f"decode_attention: no {body!r} body for {q.dtype} "
                         f"at head_dim {D}, G {H // K}")
    out = torch.empty_like(q)
    ml = (torch.empty((2, B, H), dtype=torch.float32, device=dev) if return_lse
          else None)
    ns = max(1, num_splits(1, S))    # S = 0: one empty split, the output 0
    scratch = (torch.empty(B * H * ns * (D + 2), dtype=torch.float32,
                           device=dev) if body == "mma" else None)
    lib = build.load("decode_attention", _DENSE_ARGTYPES)
    # a launch that writes the log-sum-exp too counts under "<body>_lse"
    DENSE_KERNEL.count_launch(body + "_lse" if return_lse else body)
    err = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if ml is None else ml[0].data_ptr(),
        None if ml is None else ml[1].data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, H, K, D, ns, 1.0 / (D ** 0.5),
        int(body == "mma"), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention: CUDA error {err}")
    return (out, ml[0], ml[1]) if return_lse else out


DENSE_KERNEL = register_kernel(
    "decode_attention", _launch_dense, decode_attention_ref,
    source="src/repro_torch/csrc/decode_attention.cu",
    replaces="src/repro/kernels/decode_attention/kernel.py:70",
    tolerance=lse_tolerance_ratio)


def decode_attention(q, k, v, lengths, *, chunk: int = 1024, return_lse: bool = False):
    """One query token per sequence against a contiguous cache.

    q: (B, H, D); k/v: (B, S, K, D); lengths: (B,) int32 valid rows (any
    value: rows at or past S never exist, so lengths > S attends all S;
    below 1 none).  Returns (B, H, D), the output only, as the Pallas
    function does; with ``return_lse`` (out, m, l), m and l fp32 (B, H):
    the largest score (``NEG_INF`` where no row is live) and the sum of
    exp(score - m) -- the reference's ``chunked_attention`` residuals, out
    normalised by max(l, 1e-30).  CUDA tensors run the kernel, CPU tensors
    the plain version (``chunk`` is its KV tile).
    """
    return DENSE_KERNEL(q, k, v, lengths, chunk=chunk, return_lse=return_lse)
