"""Chunked SSD scan: the CUDA kernel ``csrc/ssm_scan.cu`` beside its plain
version, behind one wrapper (counterpart of ``repro/kernels/ssm_scan/
ops.py``, with the oracle's carried state: ``initial_state`` in, the final
state out)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import (check_operand, register_kernel,
                                          ssm_tolerance_ratio)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
MAX_CHUNK = 128
SMEM_LIMIT = 232_448          # shared memory one block may use on Hopper


def smem_bytes(N: int, chunk: int) -> int:
    """Shared memory one block of the kernel uses (see ``ssm_scan.cu``)."""
    return 4 * (chunk * N + N * (chunk + 1) + chunk * 32 + chunk * chunk
                + N * 32 + 3 * chunk)


def _launch(q, k, v, log_decay, log_gate, *, chunk=128, initial_state=None):
    """Check the operands, allocate y and the final state, and launch the
    kernel on the current stream.  q and k may be contiguous or a stride-0
    head view over a contiguous (B, S, N) tensor; everything else must be
    contiguous."""
    B, S, H, N = k.shape
    P = v.shape[-1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes tensors on the card, not {dev}")
    check_operand(q, "q", device=dev, dtypes=tuple(_DTYPE_CODE),
                  shape=(B, S, H, N), broadcast_dim=2)
    check_operand(k, "k", device=dev, dtypes=(q.dtype,), shape=(B, S, H, N),
                  broadcast_dim=2)
    check_operand(v, "v", device=dev, dtypes=(q.dtype,), shape=(B, S, H, P))
    if log_gate is None:
        log_gate = torch.zeros_like(log_decay)
    for name, t in (("log_decay", log_decay), ("log_gate", log_gate)):
        check_operand(t, name, device=dev, dtypes=(torch.float32,),
                      shape=(B, S, H))
    if initial_state is not None:
        check_operand(initial_state, "initial_state", device=dev,
                      dtypes=(torch.float32,), shape=(B, H, N, P))
    chunk = min(chunk, S)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk}: the kernel takes 1..{MAX_CHUNK}")
    if smem_bytes(N, chunk) > SMEM_LIMIT:
        raise ValueError(f"d_state N={N} at chunk {chunk} needs "
                         f"{smem_bytes(N, chunk)} bytes of shared memory, "
                         f"over the {SMEM_LIMIT} a block may use")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    final = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    strides = q.stride()[:3] + k.stride()[:3]
    if max(strides) >= 2**31 or B * H >= 2**31:
        raise ValueError("q/k strides or B*H do not fit the kernel's int")
    lib = build.load("ssm_scan", _ARGTYPES)
    KERNEL.launches += 1
    err = lib.ssm_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
        log_gate.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), _DTYPE_CODE[q.dtype],
        B, S, H, N, P, chunk, *strides,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan: CUDA error {err}")
    return y, final


KERNEL = register_kernel(
    "ssm_scan", _launch, ssm_scan_ref,
    source="src/repro_torch/csrc/ssm_scan.cu",
    replaces="src/repro/kernels/ssm_scan/kernel.py:64",
    tolerance=ssm_tolerance_ratio)


def ssm_scan(q, k, v, log_decay, log_gate=None, *, chunk: int = 128,
             initial_state=None):
    """The chunked SSD / decayed linear-attention scan.

    q, k: (B, S, H, N) (a stride-0 head view is taken as it is); v: (B, S,
    H, P) bf16 or fp32; log_decay, log_gate: (B, S, H) fp32 (``log_gate``
    None -> 0); initial_state: (B, H, N, P) fp32 or None.  Any S.  Returns
    (y (B, S, H, P) fp32, final_state (B, H, N, P) fp32).  CUDA tensors run
    the kernel, CPU tensors the plain version.
    """
    return KERNEL(q, k, v, log_decay, log_gate, chunk=chunk,
                  initial_state=initial_state)
