"""Decode attention, dense and paged: the CUDA kernels
``csrc/decode_attention.cu`` and ``csrc/paged_decode_attention.cu``, each
beside its plain version behind one wrapper with the reference's signature
(counterpart of ``repro/kernels/decode_attention/ops.py``).

The paged kernel has two bodies, and :func:`body_for` picks one before the
launch: bf16 at head_dim 64 or 128 with at most 8 query heads per kv head
splits the KV length over many blocks and merges them (``mma``: two
launches from one call, the products on the tensor cores), everything
else -- every fp32 call among them -- runs the first, one-block-per-group
FMA body."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      paged_decode_attention_ref)
from repro_torch.kernels.dispatch import check_operand, register_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 \
    + [ctypes.c_int, ctypes.c_void_p]
_DENSE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_void_p]
MMA_HEAD_DIMS = (64, 128)    # the split body's template instances
MMA_MAX_GROUP = 8            # query heads per kv head: the n = 8 side of m16n8k16
SPLIT_KEYS = 64              # keys one block of the split body takes


def body_for(q: torch.Tensor, k_pool: torch.Tensor) -> str:
    """The body a paged call runs, decided before the launch from the type,
    head_dim and group size G = H / K alone: ``"mma"`` (split over the KV
    length, tensor cores) for bf16 at head_dim 64 or 128 and G <= 8,
    ``"fma"`` for everything else, every fp32 call among them."""
    G = q.shape[1] // k_pool.shape[2]
    if (q.dtype == torch.bfloat16 and q.shape[-1] in MMA_HEAD_DIMS
            and G <= MMA_MAX_GROUP):
        return "mma"
    return "fma"


def num_splits(max_blocks: int, block_size: int) -> int:
    """Blocks of the split body per (sequence, kv head): the table's
    max_blocks * block_size keys in runs of ``SPLIT_KEYS``.  From the table
    width, never from ``lengths`` (a device value)."""
    return -(-max_blocks * block_size // SPLIT_KEYS)


def _launch(q, k_pool, v_pool, block_tables, lengths, *, softcap=0.0,
            chunk=1024, body=None):
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
    check_operand(q, "q", device=dev, dtypes=tuple(_DTYPE_CODE), align=16)
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        check_operand(pool, name, device=dev, dtypes=(q.dtype,),
                      shape=(N, bs, K, D), align=16)
    check_operand(block_tables, "block_tables", device=dev,
                  dtypes=(torch.int32,), shape=(B, mb))
    check_operand(lengths, "lengths", device=dev, dtypes=(torch.int32,),
                  shape=(B,))
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if (D * q.element_size()) % 16:
        raise ValueError(f"head_dim {D}: rows must be a multiple of 16 bytes")
    route = body_for(q, k_pool)
    body = body or route
    if body not in ("mma", "fma") or (body == "mma" and route != "mma"):
        raise ValueError(f"paged_decode_attention: no {body!r} body for "
                         f"{q.dtype} at head_dim {D}, G {H // K}")
    out = torch.empty_like(q)
    ns = num_splits(mb, bs)
    scratch = (torch.empty(B * H * ns * (D + 2), dtype=torch.float32,
                           device=dev) if body == "mma" else None)
    lib = build.load("paged_decode_attention", _ARGTYPES)
    KERNEL.count_launch(body)
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        _DTYPE_CODE[q.dtype], B, H, K, D, bs, mb, N, ns,
        1.0 / (D ** 0.5), float(softcap), int(body == "mma"),
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

    q: (B, H, D); k_pool/v_pool: (N, bs, K, D); block_tables: (B, max_blocks)
    int32; lengths: (B,) int32 valid rows.  Returns (B, H, D).  CUDA tensors
    run the kernel, CPU tensors the plain version.  int8 pools (``k_scale``
    / ``v_scale``) are not ported yet and raise.
    """
    if k_scale is not None or v_scale is not None or k_pool.dtype == torch.int8:
        raise NotImplementedError(
            "int8 paged KV pools: the dequant branch is ported with the "
            "int8-pool slice")
    return KERNEL(q, k_pool, v_pool, block_tables, lengths,
                  softcap=softcap, chunk=chunk)


def _launch_dense(q, k, v, lengths, *, chunk=1024):
    """Check the operands, allocate the output and launch the dense kernel
    on the current stream (``chunk`` only tiles the plain version).  q and
    the cache must share a type: a cache in another type than q raises."""
    del chunk
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
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
    out = torch.empty_like(q)
    lib = build.load("decode_attention", _DENSE_ARGTYPES)
    DENSE_KERNEL.launches += 1
    err = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[q.dtype], B, S, H, K, D, 1.0 / (D ** 0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention: CUDA error {err}")
    return out


DENSE_KERNEL = register_kernel(
    "decode_attention", _launch_dense, decode_attention_ref,
    source="src/repro_torch/csrc/decode_attention.cu",
    replaces="src/repro/kernels/decode_attention/kernel.py:70")


def decode_attention(q, k, v, lengths, *, chunk: int = 1024):
    """One query token per sequence against a contiguous cache.

    q: (B, H, D); k/v: (B, S, K, D); lengths: (B,) int32 valid rows (any
    value: rows at or past S never exist, so lengths > S attends all S).
    Returns (B, H, D), the output only, as the Pallas function does.  CUDA
    tensors run the kernel, CPU tensors the plain version (``chunk`` is its
    KV tile).
    """
    return DENSE_KERNEL(q, k, v, lengths, chunk=chunk)
