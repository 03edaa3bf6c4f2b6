"""Dense flash attention: the CUDA kernel ``csrc/flash_attention.cu``
beside its plain version, behind one wrapper with the reference's
signature (counterpart of ``repro/kernels/flash_attention/ops.py``).

The kernel has two bodies, and :func:`body_for` picks one before the
launch: bf16 at head_dim 64 or 128 runs on the tensor cores (``mma``),
everything else -- every fp32 call among them -- on plain FMA."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import check_operand, register_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] \
    + [ctypes.c_int, ctypes.c_void_p]
MMA_HEAD_DIMS = (64, 128)    # the tensor-core body's template instances


def body_for(q: torch.Tensor) -> str:
    """The body a call runs, decided before the launch from q's type and
    head_dim alone: ``"mma"`` (tensor cores) for bf16 at head_dim 64 or
    128, ``"fma"`` for everything else, every fp32 call among them."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in MMA_HEAD_DIMS:
        return "mma"
    return "fma"


def _launch(q, k, v, *, causal=True, chunk=512):
    """Check the operands, allocate the output and launch the kernel on the
    current stream, on the body :func:`body_for` names (``chunk`` only
    tiles the plain version)."""
    del chunk
    B, S, H, D = q.shape
    K = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    check_operand(q, "q", device=dev, dtypes=tuple(_DTYPE_CODE), align=16)
    for name, t in (("k", k), ("v", v)):
        check_operand(t, name, device=dev, dtypes=(q.dtype,),
                      shape=(B, S, K, D), align=16)
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if (D * q.element_size()) % 16:
        raise ValueError(f"head_dim {D}: rows must be a multiple of 16 bytes")
    if B * S * H * D >= 2**31:
        raise ValueError("q has more elements than the kernel's int indexes")
    out = torch.empty_like(q)
    lib = build.load("flash_attention", _ARGTYPES)
    body = body_for(q)
    KERNEL.count_launch(body)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, H, K, D, int(bool(causal)),
        1.0 / (D ** 0.5), int(body == "mma"), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: CUDA error {err}")
    return out


KERNEL = register_kernel(
    "flash_attention", _launch, flash_attention_ref,
    source="src/repro_torch/csrc/flash_attention.cu",
    replaces="src/repro/kernels/flash_attention/kernel.py:75")


def flash_attention(q, k, v, *, causal: bool = True, chunk: int = 512):
    """Dense GQA attention, queries and keys at positions 0 .. S-1, causal
    or not.  q: (B, S, H, D); k/v: (B, S, K, D), H % K == 0; any S.
    Returns (B, S, H, D).  CUDA tensors run the kernel, CPU tensors the
    plain version (``chunk`` is its KV tile)."""
    return KERNEL(q, k, v, causal=causal, chunk=chunk)
