"""Dense flash attention: the CUDA kernel ``csrc/flash_attention.cu``
beside its plain version, behind one wrapper with the reference's
signature (counterpart of ``repro/kernels/flash_attention/ops.py``), and
its backward, the CUDA kernel ``csrc/flash_attention_backward.cu`` beside
its plain version.

The forward has two bodies, and :func:`body_for` picks one before the
launch: bf16 at head_dim 64 or 128 runs on the tensor cores (``mma``),
everything else -- every fp32 call among them -- on plain FMA.  The
backward has two as well, picked by :func:`backward_body_for` by the
same rule: ``mma`` (P and dS carried as bf16 hi + lo pairs) and
``fma``.  :func:`flash_attention` is differentiable: a call whose inputs
require grad goes through
:class:`_FlashAttention` (the forward writes each row's log-sum-exp too,
the backward kernel rebuilds P from it); every other call -- the serving
paths -- launches the forward as it is.

Non-causal, k and v may have a length of their own (``S_kv``), in the
forward and the backward alike: the encoder-decoder's cross-attention,
the decoder's queries against the encoder's rows, served and trained.  A
causal call at ``S_kv != S`` raises (the reference never makes one), and
so does a call with no key rows for its queries."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import (check_operand, grad_tolerance_ratio,
                                          register_kernel)
from repro_torch.kernels.flash_attention.ref import (check_kv_length,
                                                     flash_attention_backward_ref,
                                                     flash_attention_ref)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] \
    + [ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float] \
    + [ctypes.c_int, ctypes.c_void_p]
MMA_HEAD_DIMS = (64, 128)    # the tensor-core body's template instances
BWD_MAX_HEAD_DIM = 128       # the backward's tiles of 64 rows x D in shared memory


def body_for(q: torch.Tensor) -> str:
    """The body a call runs, decided before the launch from q's type and
    head_dim alone: ``"mma"`` (tensor cores) for bf16 at head_dim 64 or
    128, ``"fma"`` for everything else, every fp32 call among them."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in MMA_HEAD_DIMS:
        return "mma"
    return "fma"


def backward_body_for(q: torch.Tensor) -> str:
    """The body the backward runs, decided before the launch from q's type
    and head_dim alone, as :func:`body_for` decides the forward's:
    ``"mma"`` (tensor cores) for bf16 at head_dim 64 or 128, ``"fma"``
    for everything else, every fp32 call among them."""
    return body_for(q)


def _launch(q, k, v, *, causal=True, chunk=512, with_lse=False):
    """Check the operands, allocate the output (and, ``with_lse``, the
    (B, H, S) fp32 log-sum-exp of each row) and launch the kernel on the
    current stream, on the body :func:`body_for` names (``chunk`` only
    tiles the plain version).  k and v are (B, S_kv, K, D); ``S_kv != S``
    only when not causal."""
    del chunk
    B, S, H, D = q.shape
    K = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    S_kv = check_kv_length(q, k, causal=causal)
    check_operand(q, "q", device=dev, dtypes=tuple(_DTYPE_CODE), align=16)
    for name, t in (("k", k), ("v", v)):
        check_operand(t, name, device=dev, dtypes=(q.dtype,),
                      shape=(B, S_kv, K, D), align=16)
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if (D * q.element_size()) % 16:
        raise ValueError(f"head_dim {D}: rows must be a multiple of 16 bytes")
    if max(B * S * H, B * S_kv * K) * D >= 2**31:
        raise ValueError("q or k has more elements than the kernel's int indexes")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    lib = build.load("flash_attention", _ARGTYPES)
    body = body_for(q)
    KERNEL.count_launch(body)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, S_kv, H, K, D, int(bool(causal)),
        1.0 / (D ** 0.5), int(body == "mma"), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: CUDA error {err}")
    return (out, lse) if with_lse else out


KERNEL = register_kernel(
    "flash_attention", _launch, flash_attention_ref,
    source="src/repro_torch/csrc/flash_attention.cu",
    replaces="src/repro/kernels/flash_attention/kernel.py:75",
    gradient="repro_torch.kernels.flash_attention.ops.flash_attention")


def _launch_backward(q, k, v, out, dout, lse, *, causal=True, body=None):
    """Check the operands, allocate dq / dk / dv and the fp32 scratch
    (delta (B, H, S); for G > 1 the per-query-head dk / dv shares, (B,
    S_kv, H, D) each) and launch the backward on the current stream, on the
    body :func:`backward_body_for` names; ``body`` overrides that route, to
    time one body against the other on the same inputs.  k, v, dk and dv
    are (B, S_kv, K, D); ``S_kv != S`` only when not causal."""
    B, S, H, D = q.shape
    K = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    S_kv = check_kv_length(q, k, causal=causal, what="flash_attention_backward")
    route = backward_body_for(q)
    body = body or route
    if body not in ("mma", "fma") or (body == "mma" and route != "mma"):
        raise ValueError(f"flash_attention_backward: no {body!r} body for {q.dtype} at "
                         f"head_dim {D}")
    align = 16 if body == "mma" else 1   # the tensor-core body stages rows with cp.async
    check_operand(q, "q", device=dev, dtypes=tuple(_DTYPE_CODE), align=align)
    for name, t in (("k", k), ("v", v)):
        check_operand(t, name, device=dev, dtypes=(q.dtype,), shape=(B, S_kv, K, D),
                      align=align)
    for name, t in (("out", out), ("dout", dout)):
        check_operand(t, name, device=dev, dtypes=(q.dtype,), shape=(B, S, H, D),
                      align=align)
    check_operand(lse, "lse", device=dev, dtypes=(torch.float32,), shape=(B, H, S))
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if D > BWD_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D}: the backward takes at most {BWD_MAX_HEAD_DIM}")
    if max(B * S * H, B * S_kv * K) * D >= 2**31:
        raise ValueError("q or k has more elements than the kernel's int indexes")
    # no query row reaches a key at S = 0: dk and dv are zero, and the kernel
    # returns without a launch
    dq = torch.empty_like(q)
    dk, dv = (torch.empty_like(t) if S else torch.zeros_like(t) for t in (k, v))
    scratch = torch.empty(B * H * S + (2 * B * S_kv * H * D if H != K else 0),
                          dtype=torch.float32, device=dev)
    lib = build.load("flash_attention_backward", _BWD_ARGTYPES)
    BACKWARD.count_launch(body)
    err = lib.flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, S_kv, H, K, D, int(bool(causal)), 1.0 / (D ** 0.5),
        int(body == "mma"), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_backward: CUDA error {err}")
    return dq, dk, dv


BACKWARD = register_kernel(
    "flash_attention_backward", _launch_backward, flash_attention_backward_ref,
    source="src/repro_torch/csrc/flash_attention_backward.cu",
    replaces="src/repro/kernels/flash_attention/kernel.py:75",
    note="backward, no Pallas counterpart: the reference differentiates its "
         "plain function, src/repro/models/layers/attention.py:106",
    tolerance=grad_tolerance_ratio)


class _FlashAttention(torch.autograd.Function):
    """K4 with its gradient: the forward keeps each row's log-sum-exp, the
    backward is :data:`BACKWARD` (the kernels on the card, their plain
    versions on the CPU); q at its length S, k and v at theirs, S_kv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk):
        out, lse = KERNEL(q, k, v, causal=causal, chunk=chunk, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = BACKWARD(q, k, v, out, dout.contiguous(), lse, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, chunk: int = 512):
    """Dense GQA attention, queries at positions 0 .. S-1 and keys at 0 ..
    S_kv-1, causal or not.  q: (B, S, H, D); k/v: (B, S_kv, K, D), H % K ==
    0; any S; S_kv != S only when not causal (cross-attention).
    Returns (B, S, H, D).  CUDA tensors run the kernel, CPU tensors the
    plain version (``chunk`` is its KV tile).  Differentiable, at S_kv !=
    S too: where grad is on and an input requires it, through
    :class:`_FlashAttention`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, chunk)
    return KERNEL(q, k, v, causal=causal, chunk=chunk)
