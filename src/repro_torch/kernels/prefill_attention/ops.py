"""Paged prefill attention: the CUDA kernel
``csrc/paged_prefill_attention.cu`` beside its plain version, behind one
wrapper with the reference's signature (counterpart of
``repro/kernels/prefill_attention/ops.py``).

The kernel has two bodies, and :func:`body_for` picks one before the
launch: bf16 at head_dim 64 or 128 runs on the tensor cores (``mma``, the
dense flash kernel's core on a paged loader), everything else -- every
fp32 call among them -- on plain FMA."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import check_operand, register_kernel
# one tensor-core core (csrc/mma_attention.cuh), one route: bf16 at
# head_dim 64 or 128 on "mma", everything else on "fma"
from repro_torch.kernels.flash_attention.ops import body_for
from repro_torch.kernels.prefill_attention.ref import \
    paged_prefill_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 \
    + [ctypes.c_int, ctypes.c_void_p]


def _launch(q, k_pool, v_pool, block_tables, q_start, lengths, *,
            softcap=0.0, chunk=1024, body=None):
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
    check_operand(q, "q", device=dev, dtypes=tuple(_DTYPE_CODE), align=16)
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        check_operand(pool, name, device=dev, dtypes=(q.dtype,),
                      shape=(N, bs, K, D), align=16)
    check_operand(block_tables, "block_tables", device=dev,
                  dtypes=(torch.int32,), shape=(B, mb))
    for name, t in (("q_start", q_start), ("lengths", lengths)):
        check_operand(t, name, device=dev, dtypes=(torch.int32,), shape=(B,))
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if (D * q.element_size()) % 16:
        raise ValueError(f"head_dim {D}: rows must be a multiple of 16 bytes")
    route = body_for(q)
    body = body or route
    if body not in ("mma", "fma") or (body == "mma" and route != "mma"):
        raise ValueError(f"paged_prefill_attention: no {body!r} body for "
                         f"{q.dtype} at head_dim {D}")
    out = torch.empty_like(q)
    lib = build.load("paged_prefill_attention", _ARGTYPES)
    KERNEL.count_launch(body)
    err = lib.paged_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), q_start.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[q.dtype], B, C, H, K, D, bs, mb, N,
        1.0 / (D ** 0.5), float(softcap), int(body == "mma"),
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

    q: (B, C, H, D); k_pool/v_pool: (N, bs, K, D); block_tables: (B,
    max_blocks) int32; q_start, lengths: (B,) int32.  Returns (B, C, H, D).
    CUDA tensors run the kernel, CPU tensors the plain version.  int8 pools
    are not ported yet and raise.
    """
    if k_scale is not None or v_scale is not None or k_pool.dtype == torch.int8:
        raise NotImplementedError(
            "int8 paged KV pools: the dequant branch is ported with the "
            "int8-pool slice")
    return KERNEL(q, k_pool, v_pool, block_tables, q_start, lengths,
                  softcap=softcap, chunk=chunk)
