"""Paged prefill attention: the CUDA kernel
``csrc/paged_prefill_attention.cu`` beside its plain version, behind one
wrapper with the reference's signature (counterpart of
``repro/kernels/prefill_attention/ops.py``).

The kernel has two bodies, and :func:`body_for` picks one before the
launch: bf16 at head_dim 64 or 128 runs on the tensor cores (``mma``, the
dense flash kernel's core on a paged loader), everything else -- every
fp32 call among them -- on plain FMA.  An int8 pool, with fp32 scales per
(block, row, kv head), runs the same two bodies by the same rule on
loaders that dequantize each row to q's type (``mma_i8``, ``fma_i8``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import (check_operand, check_scales,
                                          register_kernel)
# one tensor-core core (csrc/mma_attention.cuh), one route: bf16 at
# head_dim 64 or 128 on "mma", everything else on "fma"
from repro_torch.kernels.flash_attention.ops import body_for as flash_body_for
from repro_torch.kernels.prefill_attention.ref import \
    paged_prefill_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float] * 2 \
    + [ctypes.c_int, ctypes.c_void_p]


def body_for(q: torch.Tensor, k_pool: torch.Tensor | None = None) -> str:
    """The body a call runs, decided before the launch from q's type and
    head_dim (K4's rule: ``"mma"`` for bf16 at head_dim 64 or 128,
    ``"fma"`` for everything else) and the pool's type: on an int8 pool
    the same rule names ``"mma_i8"`` or ``"fma_i8"``."""
    body = flash_body_for(q)
    quant = k_pool is not None and k_pool.dtype == torch.int8
    return body + "_i8" if quant else body


def _launch(q, k_pool, v_pool, block_tables, q_start, lengths, *,
            k_scale=None, v_scale=None, softcap=0.0, chunk=1024, body=None):
    """Check the operands, allocate the output and launch the kernel on the
    current stream, on the body :func:`body_for` names; ``body`` overrides
    that route, to time one body against the other on the same inputs
    (``chunk`` only tiles the plain version)."""
    del chunk
    B, C, H, D = q.shape
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
    for name, t in (("q_start", q_start), ("lengths", lengths)):
        check_operand(t, name, device=dev, dtypes=(torch.int32,), shape=(B,))
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if (D * q.element_size()) % 16 or (quant and D % 16):
        raise ValueError(f"head_dim {D}: q and pool rows must be a multiple "
                         f"of 16 bytes")
    route = body_for(q, k_pool)
    body = body or route
    bodies = ("mma_i8", "fma_i8") if quant else ("mma", "fma")
    if body not in bodies or (body == bodies[0] and route != bodies[0]):
        raise ValueError(f"paged_prefill_attention: no {body!r} body for "
                         f"{q.dtype} on a {k_pool.dtype} pool at head_dim {D}")
    out = torch.empty_like(q)
    lib = build.load("paged_prefill_attention", _ARGTYPES)
    KERNEL.count_launch(body)
    err = lib.paged_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        block_tables.data_ptr(), q_start.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[q.dtype], int(quant), B, C, H, K, D, bs,
        mb, N, 1.0 / (D ** 0.5), float(softcap), int(body == bodies[0]),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_prefill_attention: CUDA error {err}")
    return out


KERNEL = register_kernel(
    "paged_prefill_attention", _launch, paged_prefill_attention_ref,
    source="src/repro_torch/csrc/paged_prefill_attention.cu",
    replaces="src/repro/kernels/prefill_attention/kernel.py:90")


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_start,
                            lengths, *, k_scale=None, v_scale=None,
                            softcap: float = 0.0, chunk: int = 1024):
    """A chunk of C query rows per sequence against the paged KV pool,
    causal against absolute positions.

    q: (B, C, H, D); k_pool/v_pool: (N, bs, K, D), in q's type or int8 with
    k_scale/v_scale (N, bs, K) fp32 (each row dequantized to q's type
    before both products); block_tables: (B, max_blocks) int32; q_start,
    lengths: (B,) int32.  Returns (B, C, H, D).  CUDA tensors run the
    kernel, CPU tensors the plain version.  An int8 pool without scales, or
    scales beside another pool, raises.
    """
    check_scales(k_pool, k_scale, v_scale)
    return KERNEL(q, k_pool, v_pool, block_tables, q_start, lengths,
                  k_scale=k_scale, v_scale=v_scale, softcap=softcap,
                  chunk=chunk)
