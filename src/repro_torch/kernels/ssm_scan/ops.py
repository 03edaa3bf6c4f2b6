"""Chunked SSD scan: the CUDA kernel ``csrc/ssm_scan.cu`` beside its plain
version, behind one wrapper (counterpart of ``repro/kernels/ssm_scan/
ops.py``, with the oracle's carried state: ``initial_state`` in, the final
state out).

The kernel has two bodies, and :func:`body_for` picks one before the
launch: bf16 q/k/v with N = P in ``MMA_WIDTHS`` run the chunk-parallel SSD
decomposition on the tensor cores (``mma``: chunk sums, state passing and
chunk outputs, three launches of one call); everything else -- every fp32
call, and xlstm-125m's mLSTM at N = 384, P = 385 -- the chunk loop on
plain FMA, which walks N in slices of 64 columns, so any width fits
(``fma``).

The backward is the CUDA kernel ``csrc/ssm_scan_backward.cu`` beside its
plain version, with two bodies by the same rule
(:func:`backward_body_for`): every call whose forward ran on ``mma`` takes
its gradient on the tensor cores too (``mma``: the fp32 operands as bf16
hi + lo pairs), the rest on FMA, which stages whole rows of N and P up to
128 and walks wider ones in slices of 64 columns (:func:`backward_sliced`:
xlstm-125m's mLSTM, N = 384, P = 385), so any width fits.
:func:`ssm_scan` is differentiable: a call whose inputs require grad goes
through :class:`_SsmScan`; every other call -- the serving paths --
launches the forward as it is."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import (check_operand, grad_tolerance_ratio,
                                          register_kernel, ssm_tolerance_ratio)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_backward_ref, ssm_scan_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
_BWD_THREADS = 256            # csrc/ssm_scan_backward.cu's block
MAX_CHUNK = 128
SMEM_LIMIT = 232_448          # shared memory one block may use on Hopper
MMA_WIDTHS = (16, 32, 64, 128)    # the tensor-core body's instances, N = P
SLICE = 64                    # columns of N or P the sliced backward stages at a time


def body_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The body a call runs, decided before the launch from the operands
    alone: ``"mma"`` (tensor cores) for bf16 with d_state N equal to head_dim
    P and one of ``MMA_WIDTHS``, each of q, k, v starting on 16 bytes (its
    tiles are staged in 16-byte pieces); ``"fma"`` for everything else,
    every fp32 call among them."""
    N, P = k.shape[-1], v.shape[-1]
    if (q.dtype == torch.bfloat16 and N == P and N in MMA_WIDTHS
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return "mma"
    return "fma"


def backward_body_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The body of the backward, decided before the launch by the
    forward's rule (:func:`body_for`), so a call whose forward ran on
    ``"mma"`` has its backward there too: ``"mma"`` for bf16 q/k/v at N =
    P in ``MMA_WIDTHS``, each 16-byte aligned; ``"fma"`` for everything
    else, every fp32 call and every call at N or P over 128 (walked in
    slices, :func:`backward_sliced`) among them."""
    return body_for(q, k, v)


def backward_sliced(N: int, P: int) -> bool:
    """Whether the backward's FMA body walks N and P in slices of
    ``SLICE`` columns (N or P over 128), computing the chunk's scores once
    into scratch, rather than staging whole rows."""
    return N > 128 or P > 128


def _backward_scratch(body: str, B, S, H, N, P, chunk) -> int:
    """Floats of the backward's scratch (``csrc/ssm_scan_backward.cu``'s
    layout): S_c then H_{c-1}, U_c then G_c (B, H, C, N, P); totals (B, H,
    C); the state pass's per-warp shares of dT (B, H, C, 8 cdiv(N P,
    256)); the row sums, column sums and summary terms (B, H, C, chunk),
    one partial each, or, sliced, one a slice of N (rsum, lk) and a row
    tile (rsum, csum), with dA and (QK^T o W) (B, H, C, chunk, chunk);
    "mma" first H_{c-1} and G_c as bf16 hi / lo pairs (B, H, C, 2, N, P)."""
    bhc = B * H * -(-S // chunk)
    shares = -(-(N * P) // _BWD_THREADS) * (_BWD_THREADS // 32)
    rows = 3 * chunk
    if body == "fma" and backward_sliced(N, P):
        rows = (2 * -(-chunk // SLICE) + 2 * -(-N // SLICE)) * chunk + 2 * chunk * chunk
    pairs = 2 * bhc * N * P if body == "mma" else 0
    return pairs + bhc * (2 * N * P + 1 + shares + rows)


def _launch(q, k, v, log_decay, log_gate, *, chunk=128, initial_state=None,
            body=None):
    """Check the operands, allocate y, the final state and (tensor-core
    body) the per-chunk scratch, and launch the kernel on the current
    stream, on the body :func:`body_for` names; ``body`` overrides that
    route, to time one body against the other on the same inputs.  q and k
    may be contiguous or a stride-0 head view over a contiguous (B, S, N)
    tensor; everything else must be contiguous."""
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
    route = body_for(q, k, v)
    body = body or route
    if body not in ("mma", "fma") or (body == "mma" and route != "mma"):
        raise ValueError(f"ssm_scan: no {body!r} body for {q.dtype} q/k/v at "
                         f"N={N} P={P}")
    chunk = min(chunk, S)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk}: the kernel takes 1..{MAX_CHUNK}")
    lib = build.load("ssm_scan", _ARGTYPES)
    smem = lib.ssm_smem_bytes(int(body == "mma"), N, P, chunk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"d_state N={N} at chunk {chunk} needs {smem} bytes "
                         f"of shared memory, over the {SMEM_LIMIT} a block "
                         f"may use")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    final = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    strides = q.stride()[:3] + k.stride()[:3]
    if max(strides) >= 2**31 or B * H * -(-S // chunk) >= 2**31:
        raise ValueError("q/k strides or the block count do not fit the "
                         "kernel's int")
    scratch = [None] * 3
    if body == "mma":
        # one fp32 allocation: chunk sums (B, H, C, N, P), the entering
        # states as bf16 hi and lo (B, H, C, 2, N, P), totals (B, H, C)
        n = B * H * -(-S // chunk)
        base = torch.empty(n * (2 * N * P + 1), dtype=torch.float32, device=dev)
        at = base.data_ptr()
        scratch = [at, at + 8 * n * N * P, at + 4 * n * N * P]
    KERNEL.count_launch(body)
    err = lib.ssm_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
        log_gate.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), final.data_ptr(),
        *scratch,
        _DTYPE_CODE[q.dtype], B, S, H, N, P, chunk, *strides,
        int(body == "mma"), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan: CUDA error {err}")
    return y, final


KERNEL = register_kernel(
    "ssm_scan", _launch, ssm_scan_ref,
    source="src/repro_torch/csrc/ssm_scan.cu",
    replaces="src/repro/kernels/ssm_scan/kernel.py:64",
    tolerance=ssm_tolerance_ratio,
    gradient="repro_torch.kernels.ssm_scan.ops.ssm_scan")


def backward_passes(body: str, N: int, P: int) -> tuple[str, ...]:
    """The kernels the backward launches, in order, on ``body`` at N x P:
    its passes, which ``last_pass`` counts."""
    if body == "fma" and backward_sliced(N, P):
        return ("sums", "pass", "scores", "rows_sliced", "cols_sliced", "finish")
    return ("sums", "pass", "rows", "cols", "finish")


def _launch_backward(q, k, v, log_decay, log_gate, dy, d_final=None, *,
                     chunk=128, initial_state=None, body=None, last_pass=None):
    """Check the operands, allocate the gradients and the scratch, and
    launch the backward on the current stream, on the body
    :func:`backward_body_for` names; ``body`` overrides that route, to time
    one body against the other on the same inputs.  q and k as the forward
    takes them (contiguous or a stride-0 head view); dq and dk come back
    contiguous (B, S, H, N), one row a head, for autograd to sum.
    ``last_pass`` (1 .. ``len(backward_passes(...))``): the launches stop
    after that pass, leaving the later passes' outputs unwritten -- to time
    each pass as the difference of two runs; None runs them all."""
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
    gate = log_gate if log_gate is not None else torch.zeros_like(log_decay)
    for name, t in (("log_decay", log_decay), ("log_gate", gate)):
        check_operand(t, name, device=dev, dtypes=(torch.float32,), shape=(B, S, H))
    check_operand(dy, "dy", device=dev, dtypes=(torch.float32,), shape=(B, S, H, P))
    for name, t in (("initial_state", initial_state), ("d_final", d_final)):
        if t is not None:
            check_operand(t, name, device=dev, dtypes=(torch.float32,),
                          shape=(B, H, N, P))
    route = backward_body_for(q, k, v)
    body = body or route
    if body not in ("mma", "fma") or (body == "mma" and route != "mma"):
        raise ValueError(f"ssm_scan_backward: no {body!r} body for {q.dtype} q/k/v "
                         f"at N={N} P={P}")
    chunk = min(chunk, S)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk}: the kernel takes 1..{MAX_CHUNK}")
    lib = build.load("ssm_scan_backward", _BWD_ARGTYPES)
    smem = lib.ssm_backward_smem_bytes(int(body == "mma"), N, P, chunk)
    if not 0 <= smem <= SMEM_LIMIT:
        raise ValueError(f"ssm_scan_backward: no layout of the {body!r} body takes "
                         f"N={N} P={P} at chunk {chunk} (shared memory {smem}; -1: "
                         f"the state's N x P over the pass's grid, or a width the body "
                         f"has no instance of; a block may use {SMEM_LIMIT} bytes)")
    passes = len(backward_passes(body, N, P))
    if last_pass is not None and not 1 <= last_pass <= passes:
        raise ValueError(f"last_pass={last_pass}: the {body!r} body launches {passes} passes")
    if body == "mma" and dy.data_ptr() % 16:
        dy = dy.clone()     # the body reads dy in 16-byte pieces
    strides = q.stride()[:3] + k.stride()[:3]
    if max(strides) >= 2**31 or B * S * H * max(N, P) >= 2**31:
        raise ValueError("q/k strides or the gradients' sizes do not fit the "
                         "kernel's int")
    dq = torch.empty((B, S, H, N), dtype=q.dtype, device=dev)
    dk = torch.empty((B, S, H, N), dtype=q.dtype, device=dev)
    dv = torch.empty_like(v)
    d_decay = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    d_gate = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    d_init = None if initial_state is None else torch.empty_like(initial_state)
    scratch = torch.empty(_backward_scratch(body, B, S, H, N, P, chunk),
                          dtype=torch.float32, device=dev)
    BACKWARD.count_launch(body)
    err = lib.ssm_scan_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
        gate.data_ptr(), None if initial_state is None else initial_state.data_ptr(),
        dy.data_ptr(), None if d_final is None else d_final.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), d_decay.data_ptr(),
        d_gate.data_ptr(), None if d_init is None else d_init.data_ptr(),
        scratch.data_ptr(), _DTYPE_CODE[q.dtype], B, S, H, N, P, chunk, *strides,
        int(body == "mma"), last_pass or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan_backward: CUDA error {err}")
    return dq, dk, dv, d_decay, None if log_gate is None else d_gate, d_init


BACKWARD = register_kernel(
    "ssm_scan_backward", _launch_backward, ssm_scan_backward_ref,
    source="src/repro_torch/csrc/ssm_scan_backward.cu",
    replaces="src/repro/kernels/ssm_scan/kernel.py:64",
    note="backward, no Pallas counterpart: the reference differentiates its "
         "plain function, src/repro/models/layers/ssm.py:27",
    tolerance=grad_tolerance_ratio)


class _SsmScan(torch.autograd.Function):
    """K5 with its gradient: the forward as it is, the backward
    :data:`BACKWARD` (the kernels on the card, their plain versions on the
    CPU).  An output nothing used comes back as zeros (autograd's
    default), the final state's in training."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, log_gate, initial_state, chunk):
        y, final = KERNEL(q, k, v, log_decay, log_gate, chunk=chunk,
                          initial_state=initial_state)
        ctx.save_for_backward(q, k, v, log_decay, log_gate, initial_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, d_final):
        q, k, v, log_decay, log_gate, initial_state = ctx.saved_tensors
        grads = BACKWARD(q, k, v, log_decay, log_gate, dy.contiguous(),
                         d_final.contiguous(), chunk=ctx.chunk,
                         initial_state=initial_state)
        return (*grads, None)


def ssm_scan(q, k, v, log_decay, log_gate=None, *, chunk: int = 128,
             initial_state=None):
    """The chunked SSD / decayed linear-attention scan.

    q, k: (B, S, H, N) (a stride-0 head view is taken as it is); v: (B, S,
    H, P) bf16 or fp32; log_decay, log_gate: (B, S, H) fp32 (``log_gate``
    None -> 0); initial_state: (B, H, N, P) fp32 or None.  Any S.  Returns
    (y (B, S, H, P) fp32, final_state (B, H, N, P) fp32).  CUDA tensors run
    the kernel, CPU tensors the plain version.  Differentiable: where grad
    is on and an input requires it, through :class:`_SsmScan`.
    """
    inputs = (q, k, v, log_decay, log_gate, initial_state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        return _SsmScan.apply(*inputs, chunk)
    return KERNEL(q, k, v, log_decay, log_gate, chunk=chunk,
                  initial_state=initial_state)
