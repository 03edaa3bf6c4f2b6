"""Decode attention, dense and paged: the CUDA kernels
``csrc/decode_attention.cu`` and ``csrc/paged_decode_attention.cu``, each
beside its plain version behind one wrapper with the reference's signature
(counterpart of ``repro/kernels/decode_attention/ops.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      paged_decode_attention_ref)
from repro_torch.kernels.dispatch import check_operand, register_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p]
_DENSE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_void_p]


def _launch(q, k_pool, v_pool, block_tables, lengths, *, softcap=0.0,
            chunk=1024):
    """Check the operands, allocate the output and launch the kernel on the
    current stream.  ``chunk`` is the plain version's KV tile and is unused
    here: the kernel walks the pool one block at a time."""
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
    out = torch.empty_like(q)
    lib = build.load("paged_decode_attention", _ARGTYPES)
    KERNEL.launches += 1
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], B, H, K, D, bs, mb, N,
        1.0 / (D ** 0.5), float(softcap),
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
