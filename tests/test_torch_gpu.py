"""Tests that need an NVIDIA card: each hand-written CUDA kernel against its
plain PyTorch version on the card, and the port's engine driving its path
through the kernels.  Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Elsewhere every test here skips (the ``cuda`` fixture decides, at run
time, so every pytest worker collects the same tests).

Tolerances on the card (each kernel's ``tolerance``, in
``kernels/dispatch.py``): each kernel is held against its plain version
evaluated in fp32 on the same values.  Attention: fp32 within 1e-4 (the
two sum in other orders); bf16 within 2^-7 |ref| + 2^-6 rms(ref) per
element (the kernel rounds p before the PV product and its output to
bf16).  conv2d: CONV_RTOL |ref| + CONV_RMS_ATOL rms(ref) per element
(fp32 2^-14 and 2^-14, fp16 2^-10 and 2^-12, bf16 2^-7 and 2^-12: twice
the one rounding of the output, and the fp32 sum's order).  ssm_scan: y
and the final state each within 1e-4 of their largest |ref| (fp32 out;
the FMA body differs only in the order of the sums, the tensor-core body
also by its fp32 operands split into bf16 hi + lo, 2^-18 a term), on
either body, and the tensor-core body bit for bit from launch to launch.
matmul (K7): MATMUL_RTOL |ref| + 2^-20 sqrt(K) max|ref| per element
(twice the output's one rounding: none at fp32, 2^-10 fp16, 2^-7 bf16;
and the fp32 sum's order), on either body (FMA, or wgmma for fp16 / bf16 operands TMA can read); the
flash kernel's tensor-core body (bf16, D = 64 or 128) on the attention
limit above, as are the paged kernels' tensor-core bodies (K2 on mma, K1
split over the KV length and merged), with NaN in every pool row that is
not live (the plain version reads the pool as made); K2's tensor-core
body equals K4's bit for bit on a trivial block table.  K6 on its route's
body (the tensor cores at fp16 / bf16) on every
distinct GoogLeNet conv shape at batch 1 and 8, split and unsplit, and a
split conv gives the same bits launch after launch; K3's split body on
the attention limit with NaN in every cache row at or past the length,
and equal to K1's bit for bit on the cache read as a pool through a
trivial table; on an fp32 q with a bf16 cache (the wave path's caches
under an fp32 model) the launcher widens the cache, within the fp32 limit
of the plain version on the widened values.  K1 and K2 on int8 pools (``mma_i8`` / ``fma_i8``): on the
attention limit against the plain version in fp32 on the dequantized
values, with NaN in the scales of every dead row, and bit for bit equal
to the bf16 / fp32 body on the pool dequantized to q's type.  Training
on the card: the smoke model's loss and gradients through the kernels
within 1e-3 of each leaf's largest entry of those through the plain
versions (the same fp32 arithmetic in other orders; the random model's
near-one-hot attention amplifies rounding in the backward); GoogLeNet's
backward through the kernels against the plain versions' on one forward
graph (the same ReLU masks and max-pool choices), on
``grad_tolerance_ratio``.  The backward kernels (K4's, K5's, K6's)
against their plain versions evaluated in fp32 on the same values, on
the body their route picks (K4's "mma" for bf16 at D 64 / 128, both of
its bodies on those calls; K6's ring and gather bodies by pass): each
gradient within ``GRAD_RTOL`` of its largest entry (fp32 2^-14, a bf16
gradient 2^-8, fp16 2^-10), two launches the same bits; K4's
log-sum-exp on both bodies within 1e-5 of the plain one; the launch
counts by body of a GoogLeNet and a qwen2.5-3b microbatch.  K5's FMA
body at xlstm-125m's widths (N = 384, P = 385, staged in slices of N) on
the scan's limit, the same bits launch after launch; K5's bodies keep
the bits they gave before the FMA body walked N in slices (sha1
digests); an xlstm-125m prefill and the xlstm smoke engine launch
exactly the kernels their configs say.  K5's backward at xlstm-125m's
widths on the FMA body's sliced layout (N and P in slices of 64) on
``grad_tolerance_ratio``, the normalizer's one-column slice held on its
own, two launches the same bits; an xlstm-125m training microbatch and a
2-block full-width fp32 train step against the plain versions.  A
kernel called on the card with an input that requires grad raises,
naming where its gradient is (or that it has none).  K7's batched entry
(the experts' products of an MoE layer) on K7's limit on both bodies,
ragged E, M, N and K in three layouts; each expert's output bit for bit
the 2-D entry's on that expert's operands (no expert's rows reach
another's tiles), its two tiles the same bits; and one deepseek-moe-16b
MoE layer at full width through the kernels against the plain versions
on the same routes (fp32 within 1e-5 of the largest output; bf16 within
2^-6 of it: an intermediate bf16 rounding of h that flips by one ulp
moves an output by up to an ulp of the largest).  The batched entry's
backward (``linear.batched_matmul``): dX on w^T and dW on x^T on both
bodies within K7's limit, the same bits twice, each expert's the 2-D
entry's bits on its own views -- dW, contracting over the capacity, on
the persistent body (``wgmma_persistent``: a walk of the output tiles,
stores staged in shared memory and issued by TMA), dX on the tile-per-block wgmma
body; one deepseek-moe-16b MoE layer's gradients (x, router, the three
expert weights) through the kernels against the plain versions on the
same routes.  K4's backward non-causal at a KV length of its own on both
bodies, NaN right after k and v, on ``GRAD_RTOL``; one whisper-medium
and one qwen2-vl-72b training microbatch (one layer of each stack at full
widths, fp32) through the kernels against the plain versions: the loss
within 1e-5, each gradient leaf within 1e-3 of its largest entry.
"""
import contextlib
import hashlib
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.kernels import dispatch
from repro_torch.kernels.ssm_scan.ops import body_for as ssm_body_for
from repro_torch.models.googlenet import conv_shapes
from repro_torch.models.recurrent import training_launches
from repro_torch.models.registry import fns_for
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampler import greedy

pytestmark = pytest.mark.gpu

# a drained pool's leak report
CLEAN = {"unheld_blocks": 0, "held_with_extra_refs": 0, "reserved_blocks": 0,
         "host_pending": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _pool(dev, dtype, B=3, H=8, K=2, D=64, bs=16, mb=6, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    N = 1 + B * mb
    kp = torch.randn((N, bs, K, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((N, bs, K, D), generator=g, device=dev).to(dtype)
    kp[0], vp[0] = 1e4, -1e4                 # poisoned trash block
    tables = (1 + torch.randperm(B * mb, generator=g, device=dev)
              ).reshape(B, mb).int()
    return g, kp, vp, tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_decode_kernel_matches_plain(cuda, dtype, softcap):
    g, kp, vp, tables = _pool(cuda, dtype)
    lengths = torch.tensor([1, 16, 77], dtype=torch.int32, device=cuda)
    for b, n in enumerate(lengths.tolist()):
        tables[b, -(-n // 16):] = 0
    q = torch.randn((3, 8, 64), generator=g, device=cuda).to(dtype)
    k = dispatch.kernel_table()["paged_decode_attention"]
    out = k.launch(q, kp, vp, tables, lengths, softcap=softcap)
    ref = k.plain(q.float(), kp.float(), vp.float(), tables, lengths,
                  softcap=softcap)
    torch.cuda.synchronize()
    assert dispatch.tolerance_ratio(out, ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,q_start", [(16, 0), (16, 9), (64, 27), (4, 40)])
def test_paged_prefill_kernel_matches_plain(cuda, dtype, C, q_start):
    g, kp, vp, tables = _pool(cuda, dtype, B=1)
    qs = torch.tensor([q_start], dtype=torch.int32, device=cuda)
    lens = qs + C
    tables[0, -(-(q_start + C) // 16):] = 0
    q = torch.randn((1, C, 8, 64), generator=g, device=cuda).to(dtype)
    k = dispatch.kernel_table()["paged_prefill_attention"]
    out = k.launch(q, kp, vp, tables, qs, lens)
    ref = k.plain(q.float(), kp.float(), vp.float(), tables, qs, lens)
    torch.cuda.synchronize()
    assert dispatch.tolerance_ratio(out, ref) <= 1.0


# (B, H=W, Cin, KH=KW, stride, Cout): stem1 (Cin 3, 7x7/2, asymmetric
# padding on an even map), narrow Cin 20, 5x5 and 3x3 with ragged Cout
# (24, 208), a 7x7 map, 1x1 convs, ragged M (odd maps, B*H*W not a
# multiple of 64).
CONV_CASES = [(2, 32, 3, 7, 2, 64), (2, 15, 20, 3, 2, 24), (2, 14, 16, 5, 1, 208),
              (3, 7, 32, 3, 1, 48), (2, 9, 48, 1, 1, 8), (1, 28, 64, 1, 1, 96),
              (2, 7, 832, 1, 1, 384)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d_kernel_matches_plain(cuda, dtype, case):
    B, H, Cin, KH, stride, Cout = case
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((B, H, H, Cin), generator=g, device=cuda).to(dtype)
    w = (torch.randn((KH, KH, Cin, Cout), generator=g, device=cuda)
         / (KH * KH * Cin) ** 0.5).to(dtype)
    k = dispatch.kernel_table()["conv2d"]
    for b in (torch.randn((Cout,), generator=g, device=cuda),
              torch.randn((Cout,), generator=g, device=cuda).to(dtype)):
        out = k.launch(x, w, b, stride=stride)
        ref = k.plain(x.float(), w.float(), b.float(), stride=stride)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and out.dtype == dtype
        assert k.tolerance(out, ref) <= 1.0


@pytest.mark.parametrize("head_dim,body", [(16, "fma"), (64, "mma")])
def test_engine_path_runs_the_kernels(cuda, head_dim, body):
    """The smoke model (bf16) served on the card launches both paged
    kernels and never their plain versions; every launch on the body the
    route names for its head_dim (16: FMA; 64: the tensor-core bodies)."""
    cfg = TR.smoke("qwen2.5-3b").replace(head_dim=head_dim)
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=64, batch_slots=2,
                        prefill_chunk=16)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 20 + 9 * i)
                    .astype(np.int32), max_new_tokens=5, sampler=greedy())
            for i in range(3)]
    dispatch.reset_counts()
    eng.serve(reqs)
    table = dispatch.kernel_table()
    assert all(table[n].launches > 0 and table[n].plain_calls == 0
               for n in ("paged_decode_attention", "paged_prefill_attention"))
    assert all(table[n].body_launches == {body: table[n].launches}
               for n in ("paged_decode_attention", "paged_prefill_attention"))
    assert all(len(r.output) == 5 for r in reqs)
    assert eng.pool.leak_report() == CLEAN


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,lengths", [(64, (1, 64, 33)), (100, (99, 101, 500)),
                                       (130, (0, 64, 65))])
def test_dense_decode_kernel_matches_plain(cuda, dtype, S, lengths):
    """K3 with a ragged S, lengths past S and a length-0 row."""
    g = torch.Generator(cuda).manual_seed(S)
    q = torch.randn((3, 8, 64), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((3, S, 2, 64), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kern = dispatch.kernel_table()["decode_attention"]
    out = kern.launch(q, k, v, lens)
    ref = kern.plain(q.float(), k.float(), v.float(), lens)
    torch.cuda.synchronize()
    assert kern.tolerance(out, ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,K", [(1, 4, 4), (100, 8, 2), (200, 4, 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, dtype, S, H, K, causal):
    g = torch.Generator(cuda).manual_seed(S)
    q = torch.randn((2, S, H, 64), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((2, S, K, 64), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kern = dispatch.kernel_table()["flash_attention"]
    out = kern.launch(q, k, v, causal=causal)
    ref = kern.plain(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    assert kern.tolerance(out, ref) <= 1.0


def _ssm_operands(dev, dtype, S, N, P, shared, *, B=2, H=4):
    g = torch.Generator(dev).manual_seed(S)
    hq = 1 if shared else H
    q, k = (torch.randn((B, S, hq, N), generator=g, device=dev).to(dtype)
            .expand(B, S, H, N) for _ in range(2))
    v = torch.randn((B, S, H, P), generator=g, device=dev).to(dtype)
    dt = torch.exp(torch.empty((B, S, H), device=dev).uniform_(
        -6.9, -2.3, generator=g))
    ld = -dt * torch.linspace(1.0, 16.0, H, device=dev)
    h0 = torch.randn((B, H, N, P), generator=g, device=dev)
    return (q, k, v, ld, torch.log(dt)), h0


# (body, dtype, N, P): the FMA body at fp32 and bf16 with N != P, the
# tensor-core body at each of its widths (zamba2-1.2b's 64, its smoke
# model's 16)
@pytest.mark.parametrize("body,dtype,N,P", [
    ("fma", torch.float32, 32, 48), ("fma", torch.bfloat16, 32, 48),
    ("mma", torch.bfloat16, 64, 64), ("mma", torch.bfloat16, 16, 16),
    ("mma", torch.bfloat16, 32, 32), ("mma", torch.bfloat16, 128, 128)])
@pytest.mark.parametrize("S,chunk,shared", [(100, 32, True), (128, 128, False),
                                            (7, 128, True), (300, 64, False),
                                            (45, 32, True)])
def test_ssm_scan_kernel_matches_plain(cuda, body, dtype, N, P, S, chunk, shared):
    """K5 on the body its route takes, with a ragged S (S < 16 and S not a
    multiple of 16 among them), a carried-in state, and B/C as a stride-0
    head view or per head."""
    args, h0 = _ssm_operands(cuda, dtype, S, N, P, shared)
    kern = dispatch.kernel_table()["ssm_scan"]
    assert ssm_body_for(*args[:3]) == body
    kern.reset_counts()
    out = kern.launch(*args, chunk=chunk, initial_state=h0)
    ref = kern.plain(*(a.float() for a in args), chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    assert kern.body_launches == {body: 1}
    assert kern.tolerance(out, ref) <= 1.0


@pytest.mark.parametrize("shared", [True, False])
def test_ssm_scan_mma_body_gives_the_same_bits(cuda, shared):
    """No atomics: two launches on the same inputs agree bit for bit."""
    args, h0 = _ssm_operands(cuda, torch.bfloat16, 300, 64, 64, shared)
    kern = dispatch.kernel_table()["ssm_scan"]
    first = kern.launch(*args, chunk=64, initial_state=h0, body="mma")
    second = kern.launch(*args, chunk=64, initial_state=h0, body="mma")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_ssm_scan_shared_memory_fits_each_instance(cuda):
    """The kernel's own count of a block's shared memory: the tensor-core
    body fits a block at every width and chunk (per-head N = P = 128 at
    chunk 128 the largest, 164,864 bytes), the FMA body at zamba2's width;
    a width with no tensor-core instance reads -1."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import ops
    lib = build.load("ssm_scan", ops._ARGTYPES)
    for n in ops.MMA_WIDTHS:
        for chunk in (7, 32, 64, 128):
            assert 0 < lib.ssm_smem_bytes(1, n, n, chunk) <= ops.SMEM_LIMIT
    assert lib.ssm_smem_bytes(1, 128, 128, 128) == 164_864
    assert lib.ssm_smem_bytes(1, 64, 64, 128) == 66_560
    assert lib.ssm_smem_bytes(0, 64, 64, 128) == 157_440
    assert lib.ssm_smem_bytes(1, 32, 48, 128) == -1


def test_hybrid_engine_path_runs_the_kernels(cuda):
    """The zamba2 smoke model served on the card through the contiguous
    path launches K5 per Mamba layer and prompt, K4 per shared-block
    application and prompt, K3 per application and decode step, and never
    their plain versions."""
    cfg = TR.smoke("zamba2-1.2b")
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=64, batch_slots=2)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 20 + 9 * i)
                    .astype(np.int32), max_new_tokens=5, sampler=greedy())
            for i in range(3)]
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    table = dispatch.kernel_table()
    n_seg = cfg.num_layers // cfg.shared_attn_every
    assert table["ssm_scan"].launches == cfg.num_layers * stats.prefills
    assert table["ssm_scan"].body_launches == {"mma": cfg.num_layers * stats.prefills}
    assert table["flash_attention"].launches == n_seg * stats.prefills
    assert table["decode_attention"].launches == n_seg * stats.decode_steps
    assert all(k.plain_calls == 0 for k in table.values())
    assert all(len(r.output) == 5 for r in reqs)


def _mlstm_operands(dev, dtype, S, *, N=384, H=4, with_state=False, seed=0):
    """mLSTM-like scan operands at xlstm-125m's widths: q, k per head (k /
    sqrt(N)), v with the normalizer's ones column (P = N + 1), log forget
    gates log_sigmoid(N(0, 1) + linspace(3, 6)), log input gates N(0, 1)
    clipped to [-30, 15], an fp32 initial state when asked."""
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((1, S, H, N), generator=g, device=dev)
    k = torch.randn((1, S, H, N), generator=g, device=dev) / N ** 0.5
    v = torch.cat([torch.randn((1, S, H, N), generator=g, device=dev),
                   torch.ones((1, S, H, 1), device=dev)], dim=-1)
    f = torch.randn((1, S, H), generator=g, device=dev) + torch.linspace(3.0, 6.0, H,
                                                                         device=dev)
    log_i = torch.randn((1, S, H), generator=g, device=dev).clamp(-30.0, 15.0)
    h0 = torch.randn((1, H, N, N + 1), generator=g, device=dev) if with_state else None
    return (q.to(dtype), k.to(dtype), v.to(dtype),
            torch.nn.functional.logsigmoid(f), log_i), h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,with_state", [(1000, False), (203, True), (256, True)])
def test_ssm_scan_fma_body_matches_plain_at_the_mlstm_widths(cuda, dtype, S, with_state):
    """K5 at xlstm-125m's mLSTM prefill widths (B=1, H=4, N=384, P=385,
    per-head q/k, chunk 128) on the FMA body its route takes (six slices
    of N), with a ragged S and a carried-in state: y and the final state
    within ``ssm_tolerance_ratio``, two launches the same bits."""
    args, h0 = _mlstm_operands(cuda, dtype, S, with_state=with_state, seed=S)
    kern = dispatch.kernel_table()["ssm_scan"]
    assert ssm_body_for(*args[:3]) == "fma"
    kern.reset_counts()
    out = kern.launch(*args, chunk=128, initial_state=h0)
    again = kern.launch(*args, chunk=128, initial_state=h0)
    ref = kern.plain(*(a.float() for a in args), chunk=128, initial_state=h0)
    torch.cuda.synchronize()
    assert kern.body_launches == {"fma": 2}
    assert kern.tolerance(out, ref) <= 1.0
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def _zamba_bits_case(dev, dtype, N, shared, S=300, H=8, seed=17):
    """Mamba-2-like operands made with numpy (so the same on every
    machine): q, k one group shared by every head or per head, decay
    -dt*A, gate log(dt), an initial state."""
    rng = np.random.default_rng(seed)
    hq = 1 if shared else H
    q = rng.standard_normal((1, S, hq, N), np.float32)
    k = rng.standard_normal((1, S, hq, N), np.float32)
    v = rng.standard_normal((1, S, H, N), np.float32)
    log_dt = rng.uniform(-6.9, -2.3, (1, S, H)).astype(np.float32)
    a = (1.0 + 15.0 * (np.arange(H, dtype=np.float32) + 0.5) / H).astype(np.float32)
    ld = (-np.exp(log_dt) * a).astype(np.float32)
    h0 = rng.standard_normal((1, H, N, N), np.float32)
    qt, kt = (torch.from_numpy(t).to(dev).to(dtype).expand(1, S, H, N) for t in (q, k))
    vt = torch.from_numpy(v).to(dev).to(dtype)
    return ((qt, kt, vt, torch.from_numpy(ld).to(dev), torch.from_numpy(log_dt).to(dev)),
            torch.from_numpy(h0).to(dev))


# sha1 of y's and the final state's bytes, from the kernel as it was before
# its FMA body walked N in slices (whole q and k tiles staged), on an NVIDIA
# H100 80GB HBM3
_OLD_BITS = [
    (torch.bfloat16, 64, True, None, "mma", "001bac23a719a56e970c37f1f512e5ba9f0f4b1a"),
    (torch.bfloat16, 64, True, "fma", "fma", "59db06d6c5e9fe7444a1c5fcc11c2b33af8d1386"),
    (torch.float32, 64, True, None, "fma", "281b7fe8d5d1ad4524e17150d17f9146991304bd"),
    (torch.bfloat16, 128, False, None, "mma", "bb5153f9ded813ee5021cd05174764d54d5167df"),
    (torch.float32, 128, False, None, "fma", "dd92c70eb9654a8632045f98f49786171b77bc62")]


@pytest.mark.parametrize("dtype,N,shared,force,body,digest", _OLD_BITS)
def test_ssm_scan_old_bodies_keep_their_bits(cuda, dtype, N, shared, force, body, digest):
    """zamba2-like calls (S = 300, ragged against chunk 128, a carried-in
    state) still take their old body and give its old bits."""
    import hashlib
    args, h0 = _zamba_bits_case(cuda, dtype, N, shared)
    kern = dispatch.kernel_table()["ssm_scan"]
    kern.reset_counts()
    y, fin = kern.launch(*args, chunk=128, initial_state=h0,
                         **({"body": force} if force else {}))
    torch.cuda.synchronize()
    assert kern.body_launches == {body: 1}
    got = hashlib.sha1(y.cpu().numpy().tobytes() + fin.cpu().numpy().tobytes()).hexdigest()
    assert got == digest


def test_ssm_scan_refuses_the_tensor_core_body_at_the_mlstm_widths(cuda):
    """At N = 384, P = 385 the tensor-core body has no instance and raises
    before a launch; the FMA body runs at any chunk (shared memory 214,784
    bytes at chunk 128); an N whose state tile would not fit (1024: 296,704
    bytes) raises before a launch."""
    args, _ = _mlstm_operands(cuda, torch.bfloat16, 256)
    kern = dispatch.kernel_table()["ssm_scan"]
    with pytest.raises(ValueError, match="no 'mma' body"):
        kern.launch(*args, chunk=128, body="mma")
    kern.reset_counts()
    for chunk in (53, 128):
        y, _ = kern.launch(*args, chunk=chunk)
        ref, _ = kern.plain(*(a.float() for a in args), chunk=chunk)
        torch.cuda.synchronize()
        assert kern.tolerance((y,), (ref,)) <= 1.0
    assert kern.body_launches == {"fma": 2}
    big, _ = _mlstm_operands(cuda, torch.bfloat16, 128, N=1024)
    with pytest.raises(ValueError, match="N=1024 at chunk 128 needs 296704 bytes"):
        kern.launch(*big, chunk=128)


def test_ssm_scan_fma_shared_memory(cuda):
    """The library's count of an FMA block's shared memory: at N <= 64 what
    it was when the block staged the whole of q and k (one slice), at
    xlstm-125m's N = 384 214,784 bytes (six slices, and each output's
    partial sum between them); an unknown body reads -1."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import ops
    lib = build.load("ssm_scan", ops._ARGTYPES)
    for n in (16, 32, 64):
        for chunk in (7, 53, 128):
            whole = 4 * (chunk * n + n * (chunk + 1) + chunk * 32 + chunk * chunk
                         + n * 32 + 3 * chunk)
            assert lib.ssm_smem_bytes(0, n, n + 1, chunk) == whole
    assert lib.ssm_smem_bytes(0, 384, 385, 128) == 214_784
    assert lib.ssm_smem_bytes(0, 128, 128, 128) == 182_016
    assert lib.ssm_smem_bytes(2, 64, 64, 128) == -1


def test_xlstm_prefill_runs_the_kernels(cuda):
    """One xlstm-125m prefill at full width (bf16 compute, 300 tokens):
    exactly 9 K5 launches, all on FMA (one per mLSTM block), K7 on every
    product (76 and the sLSTMs' 3 x 300 recurrent products), no plain call,
    finite logits."""
    cfg = TR.config("xlstm-125m")
    fns = fns_for(cfg)
    params = fns.prepare_params(cfg, fns.init(cfg, torch.Generator(cuda).manual_seed(0)),
                                cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 300))).to(cuda)
    dispatch.reset_counts()
    with torch.no_grad():
        logits, state = fns.prefill(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    table = dispatch.kernel_table()
    assert table["ssm_scan"].body_launches == {"fma": 9}
    assert table["matmul"].launches == 76 + 3 * 300
    assert all(k.plain_calls == 0 for k in table.values())
    assert logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert state["states"][0].mem.shape == (1, 4, 384, 385)


def test_xlstm_engine_path_runs_the_kernels(cuda):
    """The xlstm smoke model served on the card through the contiguous
    path: K5 once per mLSTM block and prompt (N = 32, P = 33: the FMA
    body), K7 on every product, never a plain version."""
    cfg = TR.smoke("xlstm-125m")
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=64, batch_slots=2)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 20 + 9 * i)
                    .astype(np.int32), max_new_tokens=5, sampler=greedy())
            for i in range(3)]
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    table = dispatch.kernel_table()
    assert table["ssm_scan"].body_launches == {"fma": 3 * stats.prefills}
    assert table["matmul"].launches == (26 * (stats.prefills + stats.decode_steps)
                                        + stats.prefill_tokens_total + stats.decode_steps)
    assert all(k.plain_calls == 0 for k in table.values())
    assert all(len(r.output) == 5 for r in reqs)


def _k7_operands(dev, M, K, N, dtype, layout, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((K, M) if "x" in layout else (M, K), generator=g, device=dev).to(dtype)
    y = torch.randn((N, K) if "y" in layout else (K, N), generator=g, device=dev).to(dtype)
    return (x.T if "x" in layout else x), (y.T if "y" in layout else y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M,K,N", [(1, 64, 130), (5, 37, 3), (16, 300, 33),
                                   (129, 70, 257), (300, 1000, 200)])
@pytest.mark.parametrize("layout", ["", "x.T", "y.T", "x.T y.T"])
def test_matmul_kernel_matches_plain(cuda, dtype, M, K, N, layout):
    x, y = _k7_operands(cuda, M, K, N, dtype, layout)
    k = dispatch.kernel_table()["matmul"]
    out = k.launch(x, y)
    ref = k.plain(x.float(), y.float())
    torch.cuda.synchronize()
    assert out.shape == (M, N) and out.dtype == dtype
    assert k.tolerance(out, ref, K) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 64, 130), (16, 300, 33), (40, 1000, 70)])
def test_matmul_tiles_agree_bit_for_bit(cuda, dtype, M, K, N):
    x, y = _k7_operands(cuda, M, K, N, dtype, "")
    k = dispatch.kernel_table()["matmul"]
    assert torch.equal(k.launch(x, y, tile="wide"), k.launch(x, y, tile="narrow"))


def _k7_aligned(dev, M, K, N, dtype, layout, seed=0):
    """Operands TMA can read: each row-major, or (``layout``) the transpose
    of a column slice of a row-major buffer whose rows are padded to 8
    elements, as a padded ``x.T`` is."""
    g = torch.Generator(dev).manual_seed(seed)

    def make(rows, cols, transposed):
        if transposed:
            buf = torch.randn((cols, -(-rows // 8) * 8), generator=g, device=dev)
            return buf.to(dtype)[:, :rows].T
        return torch.randn((rows, cols), generator=g, device=dev).to(dtype)
    return make(M, K, "x" in layout), make(K, N, "y" in layout)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M,K,N", [(1, 64, 256), (4, 2048, 1024), (513, 200, 256),
                                   (130, 1000, 264), (64, 11008, 64)])
@pytest.mark.parametrize("layout", ["", "x.T", "y.T", "x.T y.T"])
def test_matmul_wgmma_matches_plain(cuda, dtype, M, K, N, layout):
    """K7's tensor-core body on fp16 / bf16 operands that TMA can read, in
    all four layouts, ragged M, N and K past the 64-wide boxes."""
    from repro_torch.kernels.matmul.ops import body_for
    x, y = _k7_aligned(cuda, M, K, N, dtype, layout)
    assert body_for(x, y) == "wgmma"
    k = dispatch.kernel_table()["matmul"]
    dispatch.reset_counts()
    out = k.launch(x, y)
    ref = k.plain(x.float(), y.float())
    torch.cuda.synchronize()
    assert k.body_launches == {"wgmma": 1}
    assert out.shape == (M, N) and out.dtype == dtype
    assert k.tolerance(out, ref, K) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M,K,N", [(1, 2048, 256), (16, 296, 264), (513, 1000, 520)])
@pytest.mark.parametrize("layout", ["", "x.T y.T"])
def test_matmul_wgmma_tiles_agree_bit_for_bit(cuda, dtype, M, K, N, layout):
    """The wgmma body's 128 x 128 and 64 x 64 tiles issue the same
    instruction in the same k order: bit-identical outputs."""
    from repro_torch.kernels.matmul.ops import body_for
    x, y = _k7_aligned(cuda, M, K, N, dtype, layout, seed=1)
    assert body_for(x, y) == "wgmma"
    k = dispatch.kernel_table()["matmul"]
    assert torch.equal(k.launch(x, y, tile="wide"), k.launch(x, y, tile="narrow"))


@pytest.mark.parametrize("D,H,K", [(64, 4, 4), (64, 8, 1), (128, 4, 4), (128, 16, 2)])
@pytest.mark.parametrize("S", [1, 100, 1000, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_mma_matches_plain(cuda, D, H, K, S, causal):
    """K4's tensor-core body (bf16, D = 64 or 128) at G = 1 and G = 8,
    ragged and whole 64-row tiles, causal and not."""
    from repro_torch.kernels.flash_attention.ops import body_for
    g = torch.Generator(cuda).manual_seed(S + D)
    q = torch.randn((1, S, H, D), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((1, S, K, D), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    assert body_for(q) == "mma"
    kern = dispatch.kernel_table()["flash_attention"]
    dispatch.reset_counts()
    out = kern.launch(q, k, v, causal=causal)
    ref = kern.plain(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    assert kern.body_launches == {"mma": 1}
    assert kern.tolerance(out, ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_backward_runs_the_kernel(cuda, dtype):
    """dX and dW of ``linear.matmul`` through K7 (two launches on strided
    views) against autograd through the plain version in fp32."""
    from repro_torch.models.layers import linear
    x, w = _k7_operands(cuda, 37, 96, 130, dtype, "")
    x = x[:36].reshape(2, 18, 96).requires_grad_(True)
    w.requires_grad_(True)
    dy = torch.randn((2, 18, 130), device=cuda).to(dtype)
    dispatch.reset_counts()
    linear.matmul(x, w).backward(dy)
    k = dispatch.kernel_table()["matmul"]
    assert (k.launches, k.plain_calls) == (3, 0)
    x32 = x.detach().float().requires_grad_(True)
    w32 = w.detach().float().requires_grad_(True)
    with dispatch.plain_versions():
        linear.matmul(x32, w32).backward(dy.float())
    assert k.tolerance(x.grad.reshape(36, 96), x32.grad.reshape(36, 96), 130) <= 1.0
    assert k.tolerance(w.grad, w32.grad, 36) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_linear_backward_runs_the_wgmma_body(cuda, dtype):
    """``linear.matmul`` on aligned 16-bit operands: the forward and both
    backward products on the wgmma body, the backward ones launched from
    autograd's own thread (the tensor maps are encoded there too), against
    autograd through the plain version in fp32."""
    from repro_torch.models.layers import linear
    x, w = _k7_aligned(cuda, 64, 96, 136, dtype, "")
    x = x.reshape(2, 32, 96).requires_grad_(True)
    w.requires_grad_(True)
    dy = torch.randn((2, 32, 136), device=cuda).to(dtype)
    dispatch.reset_counts()
    linear.matmul(x, w).backward(dy)
    torch.cuda.synchronize()
    k = dispatch.kernel_table()["matmul"]
    assert k.body_launches == {"wgmma": 3} and k.plain_calls == 0
    x32 = x.detach().float().requires_grad_(True)
    w32 = w.detach().float().requires_grad_(True)
    with dispatch.plain_versions():
        linear.matmul(x32, w32).backward(dy.float())
    assert k.tolerance(x.grad.reshape(64, 96), x32.grad.reshape(64, 96), 136) <= 1.0
    assert k.tolerance(w.grad, w32.grad, 64) <= 1.0


def test_training_step_runs_the_kernels(cuda):
    """One train step of the smoke model on the card: every weight product
    of the forward, the recompute and the backward through K7, no plain
    call; loss and gradients agree with the plain versions."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.optimizers import adamw, constant, leaves
    from repro_torch.training.train_step import make_train_step
    cfg = TR.smoke("qwen2.5-3b").replace(compute_dtype="float32", accum_steps=2)
    batch = next(SyntheticTokens(cfg, 4, 16, seed=1))
    runs = []
    for plain in (False, True):
        params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
        grads = []
        step = make_train_step(cfg, adamw(constant(1e-3)),
                               grad_transform=lambda g: grads.append(
                                   [t.clone() for t in leaves(g)]) or g)
        dispatch.reset_counts()
        if plain:
            with dispatch.plain_versions():
                _, _, m = step(params, adamw(constant(1e-3)).init(params), batch)
        else:
            _, _, m = step(params, adamw(constant(1e-3)).init(params), batch)
            k = dispatch.kernel_table()["matmul"]
            L = cfg.num_layers
            assert k.launches == 2 * (7 * L * 2 + 1 + 2 * (7 * L + 1))
            assert all(t.plain_calls == 0 for t in dispatch.kernel_table().values())
        runs.append((float(m["loss"]), grads[0]))
    assert np.isfinite(runs[0][0])
    assert abs(runs[0][0] - runs[1][0]) <= 1e-5 * abs(runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


def _poison_dead_rows(kp, vp, tables, lengths):
    """NaN into every pool row that is not a live row of some sequence."""
    bs = kp.shape[1]
    live = torch.zeros(kp.shape[:2], dtype=torch.bool, device=kp.device)
    for b, n in enumerate(lengths.tolist()):
        pos = torch.arange(n, device=kp.device)
        live[tables[b, pos // bs].long(), pos % bs] = True
    kp[~live] = float("nan")
    vp[~live] = float("nan")


@pytest.mark.parametrize("D,H,K", [(128, 16, 2), (64, 8, 2), (64, 4, 4), (128, 6, 2)])
@pytest.mark.parametrize("lengths", [(0, 1, 64, 65), (1056, 800, 512, 300), (4096,)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_decode_split_matches_plain(cuda, D, H, K, lengths, softcap):
    """K1's split body (bf16, D = 64 or 128, G = 8, 4, 1 and a padded 3):
    a length-0 sequence, split boundaries, serving's lengths and one long
    sequence, with NaN in every row that is not live."""
    from repro_torch.kernels.decode_attention.ops import body_for
    B, bs = len(lengths), 16
    mb = max(-(-n // bs) for n in lengths) + 1
    g = torch.Generator(cuda).manual_seed(sum(lengths) + D)
    q = torch.randn((B, H, D), generator=g, device=cuda).bfloat16()
    kp, vp = (torch.randn((1 + B * mb, bs, K, D), generator=g, device=cuda).bfloat16()
              for _ in range(2))
    tables = (1 + torch.randperm(B * mb, generator=g, device=cuda)).reshape(B, mb).int()
    for b, n in enumerate(lengths):
        tables[b, -(-n // bs):] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    assert body_for(q, kp) == "mma"
    kern = dispatch.kernel_table()["paged_decode_attention"]
    ref = kern.plain(q.float(), kp.float(), vp.float(), tables, lens, softcap=softcap)
    _poison_dead_rows(kp, vp, tables, lens)
    dispatch.reset_counts()
    out = kern.launch(q, kp, vp, tables, lens, softcap=softcap)
    torch.cuda.synchronize()
    assert kern.body_launches == {"mma": 1}
    assert torch.isfinite(out.float()).all()
    assert kern.tolerance(out, ref) <= 1.0
    if lengths[0] == 0:
        assert (out[0] == 0).all()


@pytest.mark.parametrize("D,H,K", [(128, 16, 2), (64, 8, 2), (64, 4, 4)])
@pytest.mark.parametrize("C,q_start", [(4, 9), (4, 27), (64, 27), (256, 0), (256, 2048)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_prefill_mma_matches_plain(cuda, D, H, K, C, q_start, softcap):
    """K2's tensor-core body: a speculative verify's C = 4 at mid-block
    starts, a ragged last query tile, a chunk behind a long seeded history,
    with NaN in every row that is not live."""
    from repro_torch.kernels.prefill_attention.ops import body_for
    bs = 16
    mb = -(-(q_start + C) // bs) + 2
    g = torch.Generator(cuda).manual_seed(C + q_start + D)
    q = torch.randn((1, C, H, D), generator=g, device=cuda).bfloat16()
    kp, vp = (torch.randn((1 + mb, bs, K, D), generator=g, device=cuda).bfloat16()
              for _ in range(2))
    tables = (1 + torch.randperm(mb, generator=g, device=cuda)).reshape(1, mb).int()
    tables[0, -(-(q_start + C) // bs):] = 0
    qs = torch.tensor([q_start], dtype=torch.int32, device=cuda)
    lens = qs + C
    assert body_for(q) == "mma"
    kern = dispatch.kernel_table()["paged_prefill_attention"]
    ref = kern.plain(q.float(), kp.float(), vp.float(), tables, qs, lens, softcap=softcap)
    _poison_dead_rows(kp, vp, tables, lens)
    dispatch.reset_counts()
    out = kern.launch(q, kp, vp, tables, qs, lens, softcap=softcap)
    torch.cuda.synchronize()
    assert kern.body_launches == {"mma": 1}
    assert torch.isfinite(out.float()).all()
    assert kern.tolerance(out, ref) <= 1.0


@pytest.mark.parametrize("S,H,K,D", [(1024, 16, 2, 128), (1000, 32, 32, 64), (100, 8, 2, 64),
                                     (17, 16, 2, 128)])
def test_paged_prefill_mma_equals_flash_mma_on_a_trivial_table(cuda, S, H, K, D):
    """With physical block i for logical block i, q_start = 0 and lengths
    = S, the pool is the dense kernel's cache (padded to whole blocks):
    K2's tensor-core body and K4's give the same bits."""
    bs = 16
    nb = -(-S // bs)
    g = torch.Generator(cuda).manual_seed(S)
    q = torch.randn((1, S, H, D), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((1, S, K, D), generator=g, device=cuda).bfloat16() for _ in range(2))
    kp, vp = (torch.cat([t[0], t.new_zeros((nb * bs - S, K, D))]).reshape(nb, bs, K, D)
              for t in (k, v))
    tables = torch.arange(nb, dtype=torch.int32, device=cuda)[None]
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    table = dispatch.kernel_table()
    dispatch.reset_counts()
    dense = table["flash_attention"].launch(q, k, v, causal=True)
    paged = table["paged_prefill_attention"].launch(q, kp, vp, tables, zero, zero + S)
    torch.cuda.synchronize()
    assert table["flash_attention"].body_launches == {"mma": 1}
    assert table["paged_prefill_attention"].body_launches == {"mma": 1}
    assert torch.equal(paged, dense)


def _googlenet_convs():
    """GoogLeNet's distinct conv shapes at batch 1 and 8, each once:
    (name, x shape, w shape, stride)."""
    seen = {}
    for batch in (1, 8):
        for name, xs, ws, stride in conv_shapes(batch, 224):
            seen.setdefault((xs, ws, stride), name)
    return [(name, xs, ws, stride) for (xs, ws, stride), name in seen.items()]


def _conv_operands(dev, xs, ws, dtype, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(xs, generator=g, device=dev).to(dtype)
    w = (torch.randn(ws, generator=g, device=dev) / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dtype)
    return x, w, 0.1 * torch.randn((ws[3],), generator=g, device=dev)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("name,xs,ws,stride", _googlenet_convs(),
                         ids=[f"{n}-b{xs[0]}" for n, xs, _, _ in _googlenet_convs()])
def test_conv2d_route_body_matches_plain_on_googlenet_shapes(cuda, dtype, name, xs, ws,
                                                            stride):
    """K6 at fp16 / bf16 on the body its route names -- the tensor cores,
    stem1's 3-channel pixels gathered element by element -- on every
    distinct GoogLeNet conv shape at batch 1 and 8, K split into slices or
    not as the wrapper decides."""
    from repro_torch.kernels.conv2d.ops import body_for
    x, w, b = _conv_operands(cuda, xs, ws, dtype)
    body = body_for(x, w)
    assert body == "mma"
    k = dispatch.kernel_table()["conv2d"]
    ref = k.plain(x.float(), w.float(), b, stride=stride)
    dispatch.reset_counts()
    out = k.launch(x, w, b, stride=stride)
    torch.cuda.synchronize()
    assert k.body_launches == {body: 1}
    assert out.shape == ref.shape and out.dtype == dtype
    assert k.tolerance(out, ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("name", ["4a.b2", "5a.b3r", "5b.b2"])
def test_conv2d_split_k_is_bit_identical_across_launches(cuda, dtype, name):
    """A conv cut into K slices sums the partials in slice order: two
    launches on the same inputs give the same bits (no float atomics)."""
    from repro_torch.kernels.conv2d.ops import (FMA_BK, MMA_BK, body_for, conv_splits,
                                                conv_tile)
    _, xs, ws, stride = next(c for c in conv_shapes(8, 224) if c[0] == name)
    x, w, b = _conv_operands(cuda, xs, ws, dtype)
    body = body_for(x, w)
    M, N = xs[0] * -(-xs[1] // stride) * -(-xs[2] // stride), ws[3]
    assert conv_splits(M, N, ws[0] * ws[1] * ws[2], *conv_tile(body, M, N),
                       MMA_BK if body == "mma" else FMA_BK) > 1
    k = dispatch.kernel_table()["conv2d"]
    first = k.launch(x, w, b, stride=stride)
    again = k.launch(x, w, b, stride=stride)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def _dense_case(dev, lengths, S, H, K, D, seed=0):
    g = torch.Generator(dev).manual_seed(seed + S + D)
    B = len(lengths)
    q = torch.randn((B, H, D), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, S, K, D), generator=g, device=dev).bfloat16() for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("D,H,K", [(64, 32, 32), (128, 16, 2), (64, 8, 2), (128, 6, 2)])
@pytest.mark.parametrize("S,lengths", [(1088, (1033, 700, 257, 1200)), (1000, (0, 1, 64, 65)),
                                       (17, (17, 3, 0, 100))])
def test_dense_decode_split_matches_plain(cuda, D, H, K, S, lengths):
    """K3's split body (bf16, D = 64 or 128, G = 1, 8, 4 and a padded 3):
    zamba2's decode step with a slot past S, a length-0 row and split
    boundaries, a cache shorter than one split, with NaN in every cache row
    at or past the length."""
    from repro_torch.kernels.decode_attention.ops import dense_body_for
    q, k, v, lens = _dense_case(cuda, lengths, S, H, K, D)
    assert dense_body_for(q, k) == "mma"
    kern = dispatch.kernel_table()["decode_attention"]
    ref = kern.plain(q.float(), k.float(), v.float(), lens)
    for b, n in enumerate(lengths):
        k[b, min(n, S):] = float("nan")
        v[b, min(n, S):] = float("nan")
    dispatch.reset_counts()
    out = kern.launch(q, k, v, lens)
    torch.cuda.synchronize()
    assert kern.body_launches == {"mma": 1}
    assert torch.isfinite(out.float()).all()
    assert kern.tolerance(out, ref) <= 1.0
    for b, n in enumerate(lengths):
        if n == 0:
            assert (out[b] == 0).all()


def test_dense_decode_widens_a_bf16_cache_for_fp32_q(cuda):
    """fp32 q against a bf16 cache (the wave path's caches under an fp32
    model): the launcher widens the cache to fp32 and runs the FMA body,
    within the fp32 limit of the plain version on the widened values, and
    one rounding of p (2^-8 of the largest output) from the plain version
    on the pair itself, which rounds p to bf16 as the reference does."""
    q, k, v, lens = _dense_case(cuda, (1033, 700, 257, 1200), 1088, 16, 2, 128)
    q = q.float()
    kern = dispatch.kernel_table()["decode_attention"]
    dispatch.reset_counts()
    out = kern.launch(q, k, v, lens)
    torch.cuda.synchronize()
    assert kern.body_launches == {"fma": 1} and out.dtype == torch.float32
    assert kern.tolerance(out, kern.plain(q, k.float(), v.float(), lens)) <= 1.0
    mixed = kern.plain(q, k, v, lens)
    assert (out - mixed).abs().max() <= 2 ** -8 * mixed.abs().max()
    with pytest.raises(ValueError, match="dtype"):
        kern.launch(q.bfloat16(), k.float(), v.float(), lens)


@pytest.mark.parametrize("D,H,K,S,lengths", [(64, 32, 32, 1088, (1033, 700, 257, 1200)),
                                             (128, 16, 2, 1024, (0, 17, 1024, 5000)),
                                             (64, 4, 4, 96, (95, 1, 64, 96))])
def test_dense_decode_split_equals_paged_split_on_a_trivial_table(cuda, D, H, K, S, lengths):
    """The cache (B, S, K, D) read as a pool (B * S / 16, 16, K, D) through a
    table of physical block i for logical block i: K3's split body and K1's
    give the same bits (one split body, two row loaders)."""
    q, k, v, lens = _dense_case(cuda, lengths, S, H, K, D)
    B, bs = len(lengths), 16
    kp, vp = (t.reshape(B * S // bs, bs, K, D) for t in (k, v))
    tables = torch.arange(B * S // bs, dtype=torch.int32, device=cuda).reshape(B, S // bs)
    table = dispatch.kernel_table()
    dispatch.reset_counts()
    dense = table["decode_attention"].launch(q, k, v, lens)
    paged = table["paged_decode_attention"].launch(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert table["decode_attention"].body_launches == {"mma": 1}
    assert table["paged_decode_attention"].body_launches == {"mma": 1}
    assert torch.equal(dense, paged)


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library alone)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("dtype,body", [(torch.float32, "fma"), (torch.bfloat16, "mma"),
                                        (torch.bfloat16, "fma")])
@pytest.mark.parametrize("D,H,K,S,lengths", [(64, 32, 32, 1088, (1033, 700, 257, 1200, 0)),
                                             (128, 16, 2, 1056, (1033, 700, 0, 1056, 1200)),
                                             (128, 16, 2, 132, (132, 0, 200, 57)),
                                             (64, 8, 2, 17, (0, 0, 3, 17))])
def test_dense_decode_lse_matches_plain(cuda, dtype, body, D, H, K, S, lengths):
    """K3 with its row log-sum-exp on both bodies against the plain version
    evaluated in fp32 (``dispatch.lse_tolerance_ratio``: out; m and l where
    the plain l > 0; where a sequence has no live row, l 0 and m at most
    NEG_INF / 2), with NaN in every cache row at or past the length and in
    the allocator's free blocks; out's bits those of the call without the
    log-sum-exp, which counts under the body's own name."""
    q, k, v, lens = _dense_case(cuda, lengths, S, H, K, D)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    kern = dispatch.kernel_table()["decode_attention"]
    ref = kern.plain(q.float(), k.float(), v.float(), lens, return_lse=True)
    for b, n in enumerate(lengths):
        k[b, min(n, S):] = float("nan")
        v[b, min(n, S):] = float("nan")
    _chip_smoke().poison_cached_memory(torch)      # an unwritten m or l reads NaN
    dispatch.reset_counts()
    out, m, l = kern.launch(q, k, v, lens, return_lse=True, body=body)
    alone = kern.launch(q, k, v, lens, body=body)
    torch.cuda.synchronize()
    assert kern.body_launches == {body + "_lse": 1, body: 1}
    assert m.shape == l.shape == (len(lengths), H) and m.dtype == l.dtype == torch.float32
    assert kern.tolerance((out, m, l), ref) <= 1.0
    assert torch.equal(out, alone)
    for b, n in enumerate(lengths):
        if n <= 0:
            assert (out[b] == 0).all() and (l[b] == 0).all() and (m[b] <= -5e29).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [2, 4, 8])
def test_dense_decode_split_and_merge_on_the_card(cuda, dtype, M):
    """A 1056-row cache cut into M slices, K3 with its log-sum-exp on each at
    the shard's lengths, ``merge_lse``: within the attention limit of one
    call over the whole cache and of the plain version, no NaN."""
    from repro_torch.models.layers.attention import merge_lse
    cs = _chip_smoke()
    lengths = cs.MESH_SPLIT_LENGTHS
    q, k, v, lens = _dense_case(cuda, lengths, 1056, 16, 2, 128)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    kern = dispatch.kernel_table()["decode_attention"]
    whole = kern.launch(q, k, v, lens)
    ref = kern.plain(q.float(), k.float(), v.float(), lens)
    s_loc = 1056 // M
    parts = [kern.launch(q, k[:, r * s_loc:(r + 1) * s_loc].contiguous(),
                         v[:, r * s_loc:(r + 1) * s_loc].contiguous(),
                         torch.tensor(cs.shard_lengths(lengths, r * s_loc, s_loc),
                                      dtype=torch.int32, device=cuda), return_lse=True)
             for r in range(M)]
    merged = merge_lse(cs.lse_parts(torch, parts))[:, 0]
    torch.cuda.synchronize()
    assert torch.isfinite(merged.float()).all()
    assert dispatch.tolerance_ratio(merged, whole) <= 1.0
    assert dispatch.tolerance_ratio(merged, ref) <= 1.0


def test_dense_decode_without_lse_keeps_the_parent_bits(cuda):
    """Without the log-sum-exp K3 gives the bits of the build before it was
    added, on both bodies (``chip_smoke.K3_PARENT_BITS``)."""
    cs = _chip_smoke()
    assert cs.K3_PARENT_BITS and cs.k3_digests(torch) == cs.K3_PARENT_BITS


def _int8_operands(kp, vp, dtype):
    from repro_torch.models.transformer import dequantize_kv, quantize_kv
    (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)
    return k8, v8, ks, vs, dequantize_kv(k8, ks, dtype), dequantize_kv(v8, vs, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,K", [(128, 16, 2), (64, 8, 2), (64, 32, 2)])
@pytest.mark.parametrize("lengths", [(0, 1, 64, 65), (1056, 800, 512, 300)])
def test_int8_paged_decode_matches_plain(cuda, dtype, D, H, K, lengths):
    """K1 on an int8 pool, on the body its route takes (bf16 at G <= 8:
    the split body; G = 16 and fp32: FMA), with NaN in the scales of every
    dead row; the same bits as that body on the dequantized pool."""
    from repro_torch.kernels.decode_attention.ops import body_for
    B, bs = len(lengths), 16
    mb = max(-(-n // bs) for n in lengths) + 1
    g = torch.Generator(cuda).manual_seed(sum(lengths) + D + H)
    q = torch.randn((B, H, D), generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randn((1 + B * mb, bs, K, D), generator=g, device=cuda)
              for _ in range(2))
    tables = (1 + torch.randperm(B * mb, generator=g, device=cuda)).reshape(B, mb).int()
    for b, n in enumerate(lengths):
        tables[b, -(-n // bs):] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    k8, v8, ks, vs, kd, vd = _int8_operands(kp, vp, dtype)
    body = body_for(q, k8)
    assert body == ("mma_i8" if dtype == torch.bfloat16 and H // K <= 8 else "fma_i8")
    kern = dispatch.kernel_table()["paged_decode_attention"]
    ref = kern.plain(q.float(), kd.float(), vd.float(), tables, lens)
    _poison_dead_rows(ks, vs, tables, lens)
    _poison_dead_rows(kd, vd, tables, lens)
    dispatch.reset_counts()
    out = kern.launch(q, k8, v8, tables, lens, k_scale=ks, v_scale=vs)
    twin = kern.launch(q, kd, vd, tables, lens, body=body.removesuffix("_i8"))
    torch.cuda.synchronize()
    assert kern.body_launches == {body: 1, body.removesuffix("_i8"): 1}
    assert torch.isfinite(out.float()).all()
    assert kern.tolerance(out, ref) <= 1.0
    assert torch.equal(out, twin)
    if lengths[0] == 0:
        assert (out[0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,K", [(128, 16, 2), (64, 8, 2)])
@pytest.mark.parametrize("C,q_start", [(4, 9), (64, 27), (256, 256)])
def test_int8_paged_prefill_matches_plain(cuda, dtype, D, H, K, C, q_start):
    """K2 on an int8 pool, on the body its route takes (bf16: tensor
    cores; fp32: FMA), with NaN in the scales of every dead row; the same
    bits as that body on the dequantized pool."""
    from repro_torch.kernels.prefill_attention.ops import body_for
    bs = 16
    mb = -(-(q_start + C) // bs) + 2
    g = torch.Generator(cuda).manual_seed(C + q_start + D)
    q = torch.randn((1, C, H, D), generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randn((1 + mb, bs, K, D), generator=g, device=cuda) for _ in range(2))
    tables = (1 + torch.randperm(mb, generator=g, device=cuda)).reshape(1, mb).int()
    tables[0, -(-(q_start + C) // bs):] = 0
    qs = torch.tensor([q_start], dtype=torch.int32, device=cuda)
    lens = qs + C
    k8, v8, ks, vs, kd, vd = _int8_operands(kp, vp, dtype)
    body = body_for(q, k8)
    assert body == ("mma_i8" if dtype == torch.bfloat16 else "fma_i8")
    kern = dispatch.kernel_table()["paged_prefill_attention"]
    ref = kern.plain(q.float(), kd.float(), vd.float(), tables, qs, lens)
    _poison_dead_rows(ks, vs, tables, lens)
    _poison_dead_rows(kd, vd, tables, lens)
    out = kern.launch(q, k8, v8, tables, qs, lens, k_scale=ks, v_scale=vs)
    twin = kern.launch(q, kd, vd, tables, qs, lens, body=body.removesuffix("_i8"))
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert kern.tolerance(out, ref) <= 1.0
    assert torch.equal(out, twin)


def test_int8_launches_refuse_mismatched_operands(cuda):
    """An int8 pool without scales, scales of the wrong shape or type, or a
    bf16 body forced on an int8 pool raise before any launch."""
    g, kp, vp, tables = _pool(cuda, torch.float32)
    lens = torch.tensor([1, 16, 77], dtype=torch.int32, device=cuda)
    q = torch.zeros((3, 8, 64), device=cuda, dtype=torch.bfloat16)
    k8, v8, ks, vs, _, _ = _int8_operands(kp, vp, torch.bfloat16)
    kern = dispatch.kernel_table()["paged_decode_attention"]
    with pytest.raises(ValueError, match="int8 pool needs"):
        kern.launch(q, k8, v8, tables, lens)
    with pytest.raises(ValueError, match="k_scale has shape"):
        kern.launch(q, k8, v8, tables, lens, k_scale=ks[:, :8], v_scale=vs)
    with pytest.raises(ValueError, match="k_scale has dtype"):
        kern.launch(q, k8, v8, tables, lens, k_scale=ks.double(), v_scale=vs)
    with pytest.raises(ValueError, match="no 'mma' body"):
        kern.launch(q, k8, v8, tables, lens, k_scale=ks, v_scale=vs, body="mma")


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "mma"), (torch.float32, "fma")])
@pytest.mark.parametrize("q_starts", [(9, 27, 300, 1040), (0, 15, 16, 1052)])
def test_paged_prefill_at_the_verify_shape(cuda, dtype, body, q_starts):
    """K2 as a speculative verify calls it: C = 4 candidate rows for each
    of 4 sequences at their own mid-block q_start, and a padding sequence
    on an all-trash table (q_start 0, length C); NaN in every row that is
    not live."""
    from repro_torch.kernels.prefill_attention.ops import body_for
    bs, C, H, K, D = 16, 4, 16, 2, 128
    live = len(q_starts)
    mb = max(-(-(s + C) // bs) for s in q_starts) + 1
    g = torch.Generator(cuda).manual_seed(sum(q_starts))
    q = torch.randn((live + 1, C, H, D), generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randn((1 + live * mb, bs, K, D), generator=g, device=cuda).to(dtype)
              for _ in range(2))
    tables = torch.zeros((live + 1, mb), dtype=torch.int32, device=cuda)
    tables[:live] = (1 + torch.randperm(live * mb, generator=g, device=cuda)
                     ).reshape(live, mb).int()
    for b, s in enumerate(q_starts):
        tables[b, -(-(s + C) // bs):] = 0
    qs = torch.tensor(list(q_starts) + [0], dtype=torch.int32, device=cuda)
    lens = qs + C
    assert body_for(q) == body
    kern = dispatch.kernel_table()["paged_prefill_attention"]
    ref = kern.plain(q.float(), kp.float(), vp.float(), tables, qs, lens)
    _poison_dead_rows(kp, vp, tables, lens)
    dispatch.reset_counts()
    out = kern.launch(q, kp, vp, tables, qs, lens)
    torch.cuda.synchronize()
    assert kern.body_launches == {body: 1}
    assert torch.isfinite(out.float()).all()
    assert kern.tolerance(out, ref) <= 1.0


def _smoke_requests(cfg, n=3):
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, cfg.vocab_size, 20 + 9 * i).astype(np.int32),
                    max_new_tokens=5, sampler=greedy()) for i in range(n)]


def test_contiguous_dense_engine_runs_the_kernels(cuda):
    """The qwen smoke model (bf16, head_dim 64 to reach the tensor-core
    bodies) served from contiguous caches: K4 once a layer of each
    prefill, K3 once a layer of each decode step, all on the tensor-core
    bodies; no paged kernel and no plain call."""
    cfg = TR.smoke("qwen2.5-3b").replace(head_dim=64)
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, paged=False, max_len=64, batch_slots=2)
    reqs = _smoke_requests(cfg)
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    table = dispatch.kernel_table()
    L = cfg.num_layers
    assert table["flash_attention"].body_launches == {"mma": L * stats.prefills}
    assert table["decode_attention"].body_launches == {"mma": L * stats.decode_steps}
    assert table["paged_decode_attention"].launches == 0
    assert table["paged_prefill_attention"].launches == 0
    assert all(k.plain_calls == 0 for k in table.values())
    assert all(len(r.output) == 5 for r in reqs)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_speculative_engine_runs_the_kernels(cuda, cache_dtype):
    """The qwen smoke model (bf16, head_dim 64) decoding speculatively on
    the card: K2 once a layer of each verify pass, drafter seed and target
    prefill chunk, K1 once a layer of each drafter step, all on the
    tensor-core bodies (``_i8`` on an int8 pool); both pools leak-free."""
    cfg = TR.smoke("qwen2.5-3b").replace(head_dim=64)
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=64, batch_slots=2, prefill_chunk=16,
                        cache_dtype=cache_dtype, draft_cfg=cfg, draft_params=params,
                        spec_k=3)
    n = {"chunks": 0, "seeds": 0, "steps": 0}
    for key, obj, attr in (("chunks", eng, "_prefill_paged"),
                           ("seeds", eng._drafter, "_prefill"),
                           ("steps", eng._drafter, "_decode")):
        def counted(*a, _f=getattr(obj, attr), _k=key, **kw):
            n[_k] += 1
            return _f(*a, **kw)
        setattr(obj, attr, counted)
    reqs = _smoke_requests(cfg)
    dispatch.reset_counts()
    stats = eng.serve(reqs)
    table = dispatch.kernel_table()
    L = cfg.num_layers
    mma = "mma_i8" if cache_dtype == "int8" else "mma"
    assert stats.verify_steps > 0 and stats.decode_steps == 0
    assert table["paged_prefill_attention"].body_launches == {
        mma: L * (stats.verify_steps + n["seeds"] + n["chunks"])}
    assert table["paged_decode_attention"].body_launches == {mma: L * n["steps"]}
    assert all(k.plain_calls == 0 for k in table.values())
    assert all(len(r.output) == 5 for r in reqs)
    assert eng.pool.leak_report() == CLEAN
    assert eng._drafter.pool.leak_report() == CLEAN


# -- phase 19: kernels off the main thread, the host tier, service mode -------

def _on_a_thread(fn):
    """Run ``fn`` on a new thread (as the service-mode executor runs the
    kernels) and return its result, synchronised."""
    import threading
    out = {}

    def run():
        out["v"] = fn()
        torch.cuda.synchronize()
    t = threading.Thread(target=run, name="kernel-thread", daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "v" in out
    return out["v"]


@pytest.mark.parametrize("name", ["paged_decode_attention", "paged_prefill_attention",
                                  "matmul"])
def test_kernels_launched_from_another_thread_equal_the_main_threads(cuda, name):
    """K1, K2 (bf16, the tensor-core bodies) and K7 on wgmma (a TMA tensor
    map encoded on that thread), launched from a thread that is not the
    main one, give the main thread's bits, and count their launches."""
    k = dispatch.kernel_table()[name]
    g = torch.Generator(cuda).manual_seed(0)
    if name == "matmul":
        x = torch.randn((4, 2048), generator=g, device=cuda).to(torch.bfloat16)
        y = torch.randn((2048, 256), generator=g, device=cuda).to(torch.bfloat16)
        args, kw, body = (x, y), {}, "wgmma"
    else:
        _, kp, vp, tables = _pool(cuda, torch.bfloat16, B=2, H=16, K=2, D=128, mb=8)
        if name == "paged_decode_attention":
            q = torch.randn((2, 16, 128), generator=g, device=cuda).to(torch.bfloat16)
            lens = torch.tensor([100, 128], dtype=torch.int32, device=cuda)
            args = (q, kp, vp, tables, lens)
        else:
            q = torch.randn((2, 16, 16, 128), generator=g, device=cuda).to(torch.bfloat16)
            qs = torch.tensor([9, 100], dtype=torch.int32, device=cuda)
            args = (q, kp, vp, tables, qs, qs + 16)
        kw, body = {}, "mma"
    k.reset_counts()
    main = k.launch(*args, **kw)
    torch.cuda.synchronize()
    other = _on_a_thread(lambda: k.launch(*args, **kw))
    assert main.dtype == other.dtype and torch.equal(main.view(torch.int16),
                                                     other.view(torch.int16))
    assert k.body_launches == {body: 2}


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_full_width_block_spill_and_restore_is_bit_identical(cuda, cache_dtype):
    """A pool block at qwen2.5-3b's full width (36 layers, 2 kv heads of
    128, block 16), spilled through ``KVBlockTarget`` on its worker thread
    (bf16 as int16 bits; int8 with both scale leaves) and restored into
    another block, is bit-identical -- and the capture is a copy: the
    source block is overwritten before the worker runs."""
    from repro_torch.core.offload import KVBlockTarget, OffloadEngine
    from repro_torch.serving.kv_pool import HostTier
    cfg = TR.config("qwen2.5-3b")
    state = fns_for(cfg).init_paged_state(cfg, 8, 16, 1, 4, cache_dtype, device=cuda)
    g = torch.Generator(cuda).manual_seed(0)
    for t in state[:4 if cache_dtype == "int8" else 2]:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=cuda))
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=cuda))
    eng = ServingEngine.__new__(ServingEngine)   # the tier methods alone
    eng._state, eng.device = state, cuda
    names = ("k", "v", "k_scale", "v_scale") if cache_dtype == "int8" else ("k", "v")
    before = {n: getattr(state, n)[:, 3].clone() for n in names}
    leaves = eng._read_block_slices(3)
    for n in names:
        getattr(state, n)[:, 3] = getattr(state, n)[:, 4]     # reuse of the block
    tier = HostTier(4)
    with OffloadEngine([KVBlockTarget(tier)]) as io:
        tier.begin_store(b"blk")
        io.submit(("spill", b"blk", leaves))
        item = io.submit_async(("fetch", b"blk"))
        assert io.next_done(timeout=60) is item
    eng._write_blocks([5], [item.result])
    torch.cuda.synchronize()
    for n in names:
        got = getattr(state, n)[:, 5]
        assert got.dtype == before[n].dtype
        assert torch.equal(got.contiguous().view(torch.uint8),
                           before[n].contiguous().view(torch.uint8)), n


def test_service_mode_serves_on_the_card(cuda):
    """start / submit / stop on the card: 2 requests DONE, both paged
    kernels launched (from the executor thread), the pool leak-free."""
    import threading
    cfg = TR.smoke("qwen2.5-3b").replace(head_dim=64)
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=64, batch_slots=2, prefill_chunk=16,
                        host_blocks=8)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 20 + 9 * i).astype(np.int32),
                    max_new_tokens=5, sampler=greedy()) for i in range(2)]
    done = threading.Semaphore(0)
    dispatch.reset_counts()
    eng.start()
    try:
        for r in reqs:
            eng.submit(r, on_finish=lambda r: done.release())
        for _ in reqs:
            assert done.acquire(timeout=120)
    finally:
        eng.stop()
    table = dispatch.kernel_table()
    assert all(table[n].body_launches == {"mma": table[n].launches} and table[n].launches
               for n in ("paged_decode_attention", "paged_prefill_attention"))
    assert all(r.state.value == "done" and len(r.output) == 5 for r in reqs)
    eng.drain_tier_io()
    assert eng.pool.leak_report() == CLEAN
    eng.close()


# -- phase 20: replica fleets, disaggregated migration, wave mode ------------

def _counting(eng, attr, n, threads):
    """Count an engine's calls of one model function (and the threads that
    made them) into ``n[attr]`` / ``threads``."""
    import threading
    f = getattr(eng, attr)

    def counted(*a, **kw):
        n[attr] += 1
        threads.add(threading.get_ident())
        return f(*a, **kw)
    setattr(eng, attr, counted)


def test_two_replica_fleet_launches_from_two_executor_threads(cuda):
    """Two replicas of the qwen smoke model (bf16, head_dim 64) behind the
    router on one card: every model call is made on one of the two
    executor threads, K1 / K2 launch exactly once a layer of each decode
    step / prefill chunk of both engines on the tensor-core bodies, K7 on
    wgmma from both threads (each binds its own tensor-map context), and
    no kernel takes its plain version inside the fleet run."""
    import threading
    from repro_torch.serving.router import ReplicaRouter
    cfg = TR.smoke("qwen2.5-3b").replace(head_dim=64)
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    engines = [ServingEngine(cfg, params, max_len=96, batch_slots=2, prefill_chunk=16,
                             name=f"replica{i}") for i in range(2)]
    n = [{"_prefill_paged": 0, "_decode": 0} for _ in engines]
    threads = [set(), set()]
    for e, c, t in zip(engines, n, threads):
        for attr in c:
            _counting(e, attr, c, t)
    router = ReplicaRouter(engines, affinity=False, steal=False)
    reqs = _smoke_requests(cfg, n=6)
    dispatch.reset_counts()
    stats = router.serve(reqs)
    router.stop()
    torch.cuda.synchronize()
    table = dispatch.kernel_table()
    L = cfg.num_layers
    assert all(len(r.output) == 5 for r in reqs) and stats.tokens == 30
    assert all(c["_prefill_paged"] for c in n), n       # both replicas served
    assert len(threads[0] | threads[1]) == 2
    assert threading.get_ident() not in threads[0] | threads[1]
    assert table["paged_prefill_attention"].body_launches == {
        "mma": L * sum(c["_prefill_paged"] for c in n)}
    assert table["paged_decode_attention"].body_launches == {
        "mma": L * sum(c["_decode"] for c in n)}
    assert table["matmul"].body_launches.get("wgmma", 0) > 0
    assert all(k.plain_calls == 0 for k in table.values())
    for e in engines:
        assert e.pool.leak_report() == CLEAN


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_adopted_blocks_equal_their_handoff_clones_on_the_card(cuda, cache_dtype):
    """A prefill + decode fleet of the qwen smoke model on the card: every
    block the decode replica lands equals bit for bit the clone its source
    took at the handoff (int8: with both scales); the decode replica
    computes no prompt token; both pools leak-free."""
    from repro_torch.serving.router import ReplicaRouter
    cfg = TR.smoke("qwen2.5-3b").replace(head_dim=64)
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    kw = dict(max_len=64, batch_slots=2, prefill_chunk=16, cache_dtype=cache_dtype)
    pre = ServingEngine(cfg, params, name="pre", role="prefill", **kw)
    dec = ServingEngine(cfg, params, name="dec", role="decode", **kw)
    clones, checked = {}, []
    handoff, adopt = pre._handoff, dec._adopt_slot

    def capture(slot, job, req, last1):
        clones[req.rid] = [pre._read_block_slices(b) for b in req.block_ids]
        return handoff(slot, job, req, last1)

    def check(slot, req, adoption):
        adopt(slot, req, adoption)
        for bid, want in zip(req.block_ids, clones[req.rid]):
            for name, t in want.items():
                got = getattr(dec._state, name)[:, bid]
                assert torch.equal(got.contiguous().view(torch.uint8),
                                   t.contiguous().view(torch.uint8)), (req.rid, name)
        checked.append(req.rid)
    pre._handoff, dec._adopt_slot = capture, check
    router = ReplicaRouter([pre, dec], affinity=False, steal=False)
    reqs = _smoke_requests(cfg)
    base = dec.begin_window()
    stats = router.serve(reqs)
    router.stop()
    w = dec.collect_window(base, [], stats.wall_s)
    assert sorted(checked) == [0, 1, 2]
    assert w.kv_migrations == 3 and w.prefill_tokens_computed == 0
    assert all(len(r.output) == 5 for r in reqs)
    assert pre.pool.leak_report() == CLEAN and dec.pool.leak_report() == CLEAN


def test_wave_mode_runs_flash_and_dense_decode_only(cuda):
    """``serve_wave`` on the card (the qwen smoke model, bf16, head_dim
    64): K4 once a layer of each wave's prefill, K3 once a layer of each
    decode step, on the tensor-core bodies; no paged kernel, no plain
    call."""
    cfg = TR.smoke("qwen2.5-3b").replace(head_dim=64)
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, max_len=64, batch_slots=2)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 24).astype(np.int32),
                    max_new_tokens=5, sampler=greedy()) for i in range(4)]
    dispatch.reset_counts()
    stats = eng.serve_wave(reqs)
    table = dispatch.kernel_table()
    L = cfg.num_layers
    assert (stats.prefills, stats.decode_steps) == (2, 8)
    assert table["flash_attention"].body_launches == {"mma": L * 2}
    assert table["decode_attention"].body_launches == {"mma": L * 8}
    assert table["paged_decode_attention"].launches == 0
    assert table["paged_prefill_attention"].launches == 0
    assert all(k.plain_calls == 0 for k in table.values())
    assert all(len(r.output) == 5 for r in reqs)


# ---------------------------------------------------------------------------
# the backward kernels (K4's and K5's) and the detached-output guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,K,D", [(512, 16, 2, 128), (333, 32, 32, 64), (1, 4, 4, 64),
                                     (100, 8, 2, 16), (130, 6, 3, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernel_matches_plain(cuda, dtype, S, H, K, D, causal):
    """K4 with its log-sum-exp (either body), then the backward kernel on
    the body its route picks, each against its plain version in fp32 on
    the same values; two launches give the same bits (no atomics)."""
    from repro_torch.kernels.flash_attention.ops import backward_body_for
    g = torch.Generator(cuda).manual_seed(S + D)
    q = torch.randn((1, S, H, D), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((1, S, K, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn((1, S, H, D), generator=g, device=cuda).to(dtype)
    fwd = dispatch.kernel_table()["flash_attention"]
    bwd = dispatch.kernel_table()["flash_attention_backward"]
    dispatch.reset_counts()
    out, lse = fwd.launch(q, k, v, causal=causal, with_lse=True)
    assert torch.equal(out, fwd.launch(q, k, v, causal=causal))
    ref_out, ref_lse = fwd.plain(q.float(), k.float(), v.float(), causal=causal,
                                 with_lse=True)
    assert (lse - ref_lse).abs().max() <= 1e-5 * ref_lse.abs().max().clamp(min=1.0)
    grads = bwd.launch(q, k, v, out, do, lse, causal=causal)
    again = bwd.launch(q, k, v, out, do, lse, causal=causal)
    ref = bwd.plain(*(t.float() for t in (q, k, v, out, do)), lse, causal=causal)
    torch.cuda.synchronize()
    assert [t.dtype for t in grads] == [dtype] * 3
    assert bwd.body_launches == {backward_body_for(q): 2}
    assert bwd.tolerance(grads, ref) <= 1.0
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("S,H,K,D", [(512, 16, 2, 128), (512, 32, 32, 64), (333, 32, 32, 64),
                                     (77, 8, 4, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_bodies_both_match_plain_on_bf16(cuda, S, H, K, D, causal):
    """Both bodies of K4's backward on the bf16 calls the tensor-core body
    serves (D 64 / 128, the training heads of qwen2.5-3b and zamba2, a
    ragged S): each within ``GRAD_RTOL`` of the plain version, the "mma"
    body (P and dS as bf16 hi + lo pairs) no further from it than twice
    the FMA body's reach plus a tenth of the limit."""
    g = torch.Generator(cuda).manual_seed(S + H)
    q = torch.randn((1, S, H, D), generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((1, S, K, D), generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn((1, S, H, D), generator=g, device=cuda).to(torch.bfloat16)
    fwd = dispatch.kernel_table()["flash_attention"]
    bwd = dispatch.kernel_table()["flash_attention_backward"]
    out, lse = fwd.launch(q, k, v, causal=causal, with_lse=True)
    ref = bwd.plain(*(t.float() for t in (q, k, v, out, do)), lse, causal=causal)
    dispatch.reset_counts()
    ratios = {body: bwd.tolerance(bwd.launch(q, k, v, out, do, lse, causal=causal,
                                             body=body), ref) for body in ("mma", "fma")}
    torch.cuda.synchronize()
    assert bwd.body_launches == {"mma": 1, "fma": 1}
    assert max(ratios.values()) <= 1.0
    assert ratios["mma"] <= 2 * ratios["fma"] + 0.1


def _ssm_grad_case(cuda, dtype, S, N, P, shared, state):
    (q, k, v, ld, lg), h0 = _ssm_operands(cuda, dtype, S, N, P, shared, B=1, H=8)
    g = torch.Generator(cuda).manual_seed(S + 1)
    dy = torch.randn((1, S, 8, P), generator=g, device=cuda)
    df = torch.randn((1, 8, N, P), generator=g, device=cuda) if state else None
    return (q, k, v, ld, lg, dy, df), h0[:1] if state else None


@pytest.mark.parametrize("body", [None, "fma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,chunk,shared,state", [(512, 128, True, False),
                                                  (1000, 128, True, True),
                                                  (45, 32, False, True), (7, 128, True, False),
                                                  (300, 64, False, False)])
@pytest.mark.parametrize("N,P", [(64, 64), (16, 16), (32, 48), (128, 128)])
def test_ssm_scan_backward_kernel_matches_plain(cuda, dtype, S, chunk, shared, state, N, P,
                                                body):
    """K5's backward on q / k as stride-0 head views or per head, ragged S,
    with and without a carried state and a final-state gradient, on the
    body its route picks (``body`` None: bf16 at N = P 16, 64, 128 on
    "mma", the rest on "fma") and on the FMA body forced."""
    from repro_torch.kernels.ssm_scan.ops import backward_body_for
    args, h0 = _ssm_grad_case(cuda, dtype, S, N, P, shared, state)
    bwd = dispatch.kernel_table()["ssm_scan_backward"]
    bwd.reset_counts()
    grads = bwd.launch(*args, chunk=chunk, initial_state=h0, **({"body": body} if body else {}))
    ref = bwd.plain(*(t.float() if t is not None else t for t in args), chunk=chunk,
                    initial_state=h0)
    torch.cuda.synchronize()
    route = backward_body_for(*args[:3])
    assert route == ("mma" if dtype == torch.bfloat16 and N == P else "fma")
    assert bwd.body_launches == {body or route: 1}
    assert [t is None for t in grads] == [t is None for t in ref]
    assert grads[0].dtype == grads[1].dtype == grads[2].dtype == dtype
    assert bwd.tolerance(grads, ref) <= 1.0


@pytest.mark.parametrize("shared", [True, False])
def test_ssm_scan_backward_mma_body_gives_the_same_bits(cuda, shared):
    """No atomics: two launches of the "mma" body on the same inputs (a
    ragged S, an initial state and d_final) agree bit for bit."""
    args, h0 = _ssm_grad_case(cuda, torch.bfloat16, 1000, 64, 64, shared, True)
    bwd = dispatch.kernel_table()["ssm_scan_backward"]
    first = bwd.launch(*args, chunk=128, initial_state=h0, body="mma")
    second = bwd.launch(*args, chunk=128, initial_state=h0, body="mma")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second) if a is not None)


def test_ssm_scan_backward_shared_memory_fits_each_instance(cuda):
    """The backward's own count of a block's shared memory: the "mma" body
    fits a block at every width and chunk (N = P = 128 at chunk 128 the
    largest, 230,400 bytes); a width it has no instance of reads -1."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import ops
    lib = build.load("ssm_scan_backward", ops._BWD_ARGTYPES)
    for n in ops.MMA_WIDTHS:
        for chunk in (7, 32, 64, 128):
            assert 0 < lib.ssm_backward_smem_bytes(1, n, n, chunk) <= ops.SMEM_LIMIT
    assert lib.ssm_backward_smem_bytes(1, 128, 128, 128) == 230_400
    assert lib.ssm_backward_smem_bytes(1, 64, 64, 128) == 99_328
    assert lib.ssm_backward_smem_bytes(1, 32, 48, 128) == -1
    assert 0 < lib.ssm_backward_smem_bytes(0, 32, 48, 128) <= ops.SMEM_LIMIT
    # xlstm-125m's widths on the FMA body's sliced layout (any N and P whose
    # state the pass's grid spreads: 4096 x 4097 does not fit it)
    assert lib.ssm_backward_smem_bytes(0, 384, 385, 128) == 84_224
    assert lib.ssm_backward_smem_bytes(1, 384, 385, 128) == -1
    assert lib.ssm_backward_smem_bytes(0, 4096, 4097, 128) == -1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,with_state", [(512, False), (300, True), (7, True), (200, False)])
def test_ssm_scan_backward_sliced_body_matches_plain_at_the_mlstm_widths(cuda, dtype, S,
                                                                         with_state):
    """K5's backward at xlstm-125m's mLSTM widths (B=1, H=4, N=384, P=385,
    per-head q/k, chunk 128) routed to the FMA body, which walks N and P in
    slices of 64 (the last P slice one column wide): ragged S, under one
    chunk, with and without h0 and d_final; every gradient within
    ``grad_tolerance_ratio``, two launches the same bits."""
    from repro_torch.kernels.ssm_scan.ops import backward_body_for, backward_sliced
    args, h0 = _mlstm_operands(cuda, dtype, S, with_state=with_state, seed=S)
    g = torch.Generator(cuda).manual_seed(S + 7)
    dy = torch.randn((1, S, 4, 385), generator=g, device=cuda)
    df = torch.randn((1, 4, 384, 385), generator=g, device=cuda) if with_state else None
    bwd = dispatch.kernel_table()["ssm_scan_backward"]
    assert backward_body_for(*args[:3]) == "fma" and backward_sliced(384, 385)
    bwd.reset_counts()
    first = bwd.launch(*args, dy, df, chunk=128, initial_state=h0)
    again = bwd.launch(*args, dy, df, chunk=128, initial_state=h0)
    ref = bwd.plain(*(t.float() for t in args), dy, df, chunk=128, initial_state=h0)
    torch.cuda.synchronize()
    assert bwd.body_launches == {"fma": 2}
    assert [t is None for t in first] == [t is None for t in ref]
    assert bwd.tolerance(first, ref) <= 1.0
    assert all(torch.equal(a, b) for a, b in zip(first, again) if a is not None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_backward_sliced_body_carries_the_normalizer_column(cuda, dtype):
    """dy and d_final zero but in P's last column, the one-column slice of
    the normalizer (v's ones): its gradient alone reaches dq, dk, dv's last
    column and both gates, each within ``grad_tolerance_ratio``, and is
    not zero."""
    args, h0 = _mlstm_operands(cuda, dtype, 300, with_state=True, seed=11)
    g = torch.Generator(cuda).manual_seed(12)
    dy = torch.zeros((1, 300, 4, 385), device=cuda)
    dy[..., -1] = torch.randn((1, 300, 4), generator=g, device=cuda)
    df = torch.zeros((1, 4, 384, 385), device=cuda)
    df[..., -1] = torch.randn((1, 4, 384), generator=g, device=cuda)
    bwd = dispatch.kernel_table()["ssm_scan_backward"]
    out = bwd.launch(*args, dy, df, chunk=128, initial_state=h0)
    ref = bwd.plain(*(t.float() for t in args), dy, df, chunk=128, initial_state=h0)
    torch.cuda.synchronize()
    assert bwd.tolerance(out, ref) <= 1.0
    assert all(r.abs().max() > 0 for r in ref[:2] + ref[3:5])


def test_kernels_refuse_inputs_that_require_grad(cuda):
    """Each kernel entry writes through raw pointers: called with grad on
    and an input that requires it, it raises (K4, K5, K6, K7 naming their
    differentiable wrappers) instead of dropping the gradient."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.layers.linear import matmul
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((8, 64), generator=g, device=cuda, requires_grad=True)
    w = torch.randn((64, 32), generator=g, device=cuda)
    table = dispatch.kernel_table()
    with pytest.raises(RuntimeError, match="linear.matmul"):
        table["matmul"](x, w)
    assert matmul(x, w).grad_fn is not None
    with torch.no_grad():
        table["matmul"](x, w)
    q = torch.randn((1, 8, 4, 64), generator=g, device=cuda, requires_grad=True)
    k, v = (torch.randn((1, 8, 4, 64), generator=g, device=cuda) for _ in range(2))
    with pytest.raises(RuntimeError, match="flash_attention.ops.flash_attention"):
        table["flash_attention"](q, k, v)
    assert flash_attention(q, k, v).grad_fn is not None
    lengths = torch.tensor([8], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        table["decode_attention"](q[:, 0], k, v, lengths)
    xs = torch.randn((1, 8, 8, 16), generator=g, device=cuda, requires_grad=True)
    ws = torch.randn((3, 3, 16, 16), generator=g, device=cuda)
    with pytest.raises(RuntimeError, match="conv2d: an input requires grad.*conv2d.ops.conv2d"):
        table["conv2d"](xs, ws, None, stride=1)


def test_hybrid_training_step_runs_the_kernels(cuda):
    """One train step of the zamba2 smoke model on the card: K5, K4, their
    backward kernels and K7 launched exactly as the config says, no plain
    call; loss and gradients agree with the plain versions."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import hybrid
    from repro_torch.optim.optimizers import adamw, constant, leaves
    from repro_torch.training.train_step import make_train_step
    cfg = TR.smoke("zamba2-1.2b").replace(compute_dtype="float32", accum_steps=2)
    batch = next(SyntheticTokens(cfg, 4, 40, seed=1))
    n_seg, e, tail = hybrid._segments(cfg)
    layers = n_seg * e + tail
    fwd = 2 * layers + 8 * n_seg + 1
    want = {"ssm_scan": layers + n_seg * e, "ssm_scan_backward": layers,
            "flash_attention": 2 * n_seg, "flash_attention_backward": n_seg,
            "matmul": 3 * fwd + 2 * e * n_seg + 8 * n_seg}
    runs = []
    for plain in (False, True):
        params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
        grads = []
        step = make_train_step(cfg, adamw(constant(1e-3)),
                               grad_transform=lambda g: grads.append(
                                   [t.clone() for t in leaves(g)]) or g)
        dispatch.reset_counts()
        if plain:
            with dispatch.plain_versions():
                _, _, m = step(params, adamw(constant(1e-3)).init(params), batch)
        else:
            _, _, m = step(params, adamw(constant(1e-3)).init(params), batch)
            table = dispatch.kernel_table()
            assert {n: table[n].launches for n in want} == {n: 2 * c for n, c in want.items()}
            assert all(t.plain_calls == 0 for t in table.values())
            # fp32 compute: K5's backward on the body its route gives fp32, FMA
            assert table["ssm_scan_backward"].body_launches == {"fma": 2 * layers}
        runs.append((float(m["loss"]), grads[0]))
    assert np.isfinite(runs[0][0])
    assert abs(runs[0][0] - runs[1][0]) <= 1e-5 * abs(runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


def _xlstm_counts(cfg, seq):
    """K5 and its backward by body (N = 384, P = 385: "fma"), and K7's
    launches, of one xlstm training microbatch of ``seq`` tokens, from
    ``recurrent.training_launches``."""
    n = training_launches(cfg, seq)
    return ({"ssm_scan": {"fma": n["ssm_scan"]},
             "ssm_scan_backward": {"fma": n["ssm_scan_backward"]}},
            sum(n["matmul"].values()))


def test_xlstm_microbatch_runs_the_sliced_backward(cuda):
    """One microbatch of xlstm-125m at full width (12 blocks, bf16 compute),
    1 x 256 tokens: K5 and its backward on "fma" 9 times each, K7 as the
    config says, no plain call; the loss and every gradient leaf finite."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn
    cfg = TR.config("xlstm-125m")
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    batch = {k: torch.as_tensor(v).to(cuda)
             for k, v in next(SyntheticTokens(cfg, 1, 256, seed=5)).items()}
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    dispatch.reset_counts()
    loss, _ = make_loss_fn(cfg)(params, batch)
    grads = torch.autograd.grad(loss, ps)
    torch.cuda.synchronize()
    for p in ps:
        p.requires_grad_(False)
    table = dispatch.kernel_table()
    bodies, k7 = _xlstm_counts(cfg, 256)
    assert bodies == {"ssm_scan": {"fma": 9}, "ssm_scan_backward": {"fma": 9}}
    assert {n: dict(table[n].body_launches) for n in bodies} == bodies
    assert table["matmul"].launches == k7
    assert all(t.plain_calls == 0 for t in table.values())
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)


def test_xlstm_training_step_matches_the_plain_versions(cuda):
    """One fp32 train step of xlstm-125m at full width cut to 2 blocks (an
    mLSTM, then an sLSTM), 1 x 200 tokens: through the kernels (K5 and its
    sliced backward, K7 and its backward; exact counts, no plain call) and
    through the plain versions, the loss within 1e-5 and every gradient
    leaf but b_i within 1e-3 of its largest entry, as the hybrid step is
    held; the mLSTM's b_i (d log_gate summed over the sequence: the sum
    cancels 1e4-1e6 fold, so fp32 rounding moves it ~2e-3 of itself)
    within 2^-6 of its own largest entry."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.optimizers import adamw, constant, leaves
    from repro_torch.training.train_step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TR.config("xlstm-125m").replace(compute_dtype="float32", num_layers=2,
                                          accum_steps=1)
    batch = next(SyntheticTokens(cfg, 1, 200, seed=1))
    bodies, k7 = _xlstm_counts(cfg, 200)
    runs = []
    for plain in (False, True):
        params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
        b_i = [p is params["blocks"][0]["core"]["b_i"] for p in leaves(params)]
        grads = []
        step = make_train_step(cfg, adamw(constant(1e-3)),
                               grad_transform=lambda g: grads.append(
                                   [t.clone() for t in leaves(g)]) or g)
        dispatch.reset_counts()
        if plain:
            with dispatch.plain_versions():
                _, _, m = step(params, adamw(constant(1e-3)).init(params), batch)
        else:
            _, _, m = step(params, adamw(constant(1e-3)).init(params), batch)
            table = dispatch.kernel_table()
            assert {n: dict(table[n].body_launches) for n in bodies} == bodies
            assert table["matmul"].launches == k7
            assert all(t.plain_calls == 0 for t in table.values())
        runs.append((float(m["loss"]), grads[0]))
    assert np.isfinite(runs[0][0])
    assert abs(runs[0][0] - runs[1][0]) <= 1e-5 * abs(runs[1][0])
    for a, b, bias in zip(runs[0][1], runs[1][1], b_i):
        assert (a - b).abs().max() <= (2.0 ** -6 if bias else 1e-3) * b.abs().max()


def _conv_backward_cases():
    """Phase 22a's cases: every distinct conv shape of GoogLeNet's batch-8
    forward at 224 (dx where training asks for it: every conv but stem1),
    stem1 with dx (stride 2, SAME padding 2 before and 3 after), odd maps
    at strides 1 and 2, a 4 x 2 window at stride 1 (uneven pads, which the
    ring dgrad's flipped conv swaps)."""
    seen, cases = set(), []
    for name, xs, ws, stride in conv_shapes(8, 224):
        if (xs, ws, stride) not in seen:
            seen.add((xs, ws, stride))
            cases.append((xs, ws, stride, name != "stem1"))
    return cases + [((8, 224, 224, 3), (7, 7, 3, 64), 2, True),
                    ((3, 13, 11, 5), (3, 3, 5, 7), 2, True),
                    ((2, 9, 9, 3), (7, 7, 3, 10), 2, True),
                    ((1, 15, 17, 24), (5, 5, 24, 40), 1, True),
                    ((2, 10, 10, 33), (1, 1, 33, 17), 2, True),
                    ((2, 9, 10, 16), (4, 2, 16, 24), 1, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("xs,ws,stride,need_dx", _conv_backward_cases())
def test_conv2d_backward_kernel_matches_plain(cuda, dtype, xs, ws, stride, need_dx):
    """K6's backward (dgrad where asked, wgrad and db) on the bodies its
    route picks against its plain version evaluated in fp32 on the same
    values, each gradient within ``GRAD_RTOL`` of its largest entry; split
    passes give the same bits launch after launch; counted by pass and
    body."""
    from repro_torch.kernels.conv2d.ops import backward_body_for
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(xs, generator=g, device=cuda).to(dtype)
    w = (torch.randn(ws, generator=g, device=cuda) / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dtype)
    b = 0.1 * torch.randn((ws[3],), generator=g, device=cuda)
    dy = torch.randn((xs[0], -(-xs[1] // stride), -(-xs[2] // stride), ws[3]),
                     generator=g, device=cuda).to(dtype)
    bwd = dispatch.kernel_table()["conv2d_backward"]
    ref = bwd.plain(x.float(), w.float(), b, dy.float(), stride=stride, need_dx=need_dx)
    dispatch.reset_counts()
    out = bwd.launch(x, w, b, dy, stride=stride, need_dx=need_dx)
    again = bwd.launch(x, w, b, dy, stride=stride, need_dx=need_dx)
    torch.cuda.synchronize()
    dgrad, wgrad = backward_body_for(x, w, dy, stride)
    assert bwd.body_launches == ({f"dgrad_{dgrad}": 2, f"wgrad_{wgrad}": 2} if need_dx
                                 else {f"wgrad_{wgrad}": 2})
    assert (dgrad, wgrad) == ((("fma" if dtype == torch.float32 else "mma") if stride == 1
                               and ws[3] % 8 == 0 else "gather"),
                              ("fma" if dtype == torch.float32 else "mma") if ws[3] % 8 == 0
                              else "gather")
    assert (out[0] is None) == (not need_dx)
    assert [t.dtype for t in out[1:]] == [dtype, torch.float32]
    assert dispatch.grad_tolerance_ratio(out, ref) <= 1.0
    assert all(torch.equal(u, v) for u, v in zip(out, again) if u is not None)


def test_googlenet_train_step_runs_the_kernels(cuda):
    """One fp32 train step of GoogLeNet (the full graph at 64 x 64, batch
    4 in 2 microbatches) on the card: K6, its backward (dgrad for every
    conv but stem1, wgrad for all 57, both on the fp32 ring body) and K7
    launched exactly, no plain
    call; on one forward graph, the backward through the kernels within
    ``grad_tolerance_ratio`` of the backward through the plain versions."""
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.optim.optimizers import adamw, constant, leaves
    from repro_torch.training.train_step import make_loss_fn, make_train_step
    cfg = TR.smoke("googlenet")
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    batch = SyntheticImages(cfg.vocab_size, 4, 64, seed=2).sample(4)
    step = make_train_step(cfg, adamw(constant(1e-3)), accum=2)
    dispatch.reset_counts()
    _, _, m = step(params, adamw(constant(1e-3)).init(params), batch)
    table = dispatch.kernel_table()
    assert {n: dict(table[n].body_launches) for n in
            ("conv2d", "conv2d_backward", "matmul")} == {
        "conv2d": {"fma": 114}, "conv2d_backward": {"dgrad_fma": 112, "wgrad_fma": 114},
        "matmul": {"fma": 6}}
    assert all(t.plain_calls == 0 for t in table.values()) and np.isfinite(float(m["loss"]))
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = make_loss_fn(cfg)(params, {k: torch.as_tensor(v).to(cuda)
                                         for k, v in batch.items()})
    kern = torch.autograd.grad(loss, ps, retain_graph=True)
    with dispatch.plain_versions():
        plain = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    assert max(dispatch.grad_tolerance_ratio([k], [p]) for k, p in zip(kern, plain)) <= 1.0


def test_dots_step_launches_no_recompute_products(cuda):
    """qwen2.5-3b-smoke under remat "dots" on the card: K7 as often as
    under "none" (the recompute reuses the kept products), K4 again in the
    recompute; the loss and gradients equal "full"'s bit for bit."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import leaves
    cfg = TR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    ps = leaves(params)
    L, runs = cfg.num_layers, {}
    for policy in ("dots", "full"):
        for p in ps:
            p.requires_grad_(True)
        dispatch.reset_counts()
        loss = T.forward(cfg.replace(remat=policy), params, tokens)[0].square().mean()
        grads = torch.autograd.grad(loss, ps)
        table = dispatch.kernel_table()
        runs[policy] = (loss.item(), grads, table["matmul"].launches,
                        table["flash_attention"].launches)
    for p in ps:
        p.requires_grad_(False)
    assert runs["dots"][2:] == (3 * (7 * L + 1), 2 * L)
    assert runs["full"][2:] == (7 * L * 2 + 1 + 2 * (7 * L + 1), 2 * L)
    assert runs["dots"][0] == runs["full"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["dots"][1], runs["full"][1]))


def test_qwen_microbatch_runs_the_backward_tensor_core_body(cuda):
    """One microbatch of qwen2.5-3b at full width, cut to 2 layers, bf16
    compute, remat "full", 1 x 256 tokens: K4 twice a layer (forward and
    recompute) and its backward once a layer, all on "mma", no plain call;
    the loss finite and every gradient leaf finite."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn
    cfg = TR.config("qwen2.5-3b").replace(num_layers=2)
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    batch = {k: torch.as_tensor(v).to(cuda)
             for k, v in next(SyntheticTokens(cfg, 1, 256, seed=5)).items()}
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    dispatch.reset_counts()
    loss, _ = make_loss_fn(cfg)(params, batch)
    grads = torch.autograd.grad(loss, ps)
    torch.cuda.synchronize()
    for p in ps:
        p.requires_grad_(False)
    table = dispatch.kernel_table()
    L = cfg.num_layers
    assert {n: dict(table[n].body_launches) for n in
            ("flash_attention", "flash_attention_backward")} == {
        "flash_attention": {"mma": 2 * L}, "flash_attention_backward": {"mma": L}}
    assert all(t.plain_calls == 0 for t in table.values())
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)



def _k7b_operands(dev, E, M, K, N, dtype, layout="", seed=0):
    """(E, M, K) and (E, K, N) operands: row-major, or (``layout``) the
    transpose of each expert's row-major (K, M) / (N, K) matrix, M padded to
    8 elements in the buffer, as TMA reads them."""
    g = torch.Generator(dev).manual_seed(seed)
    if "x.T" in layout:
        x = torch.randn((E, K, -(-M // 8) * 8), generator=g, device=dev).to(dtype)
        x = x[:, :, :M].transpose(1, 2)
    else:
        x = torch.randn((E, M, K), generator=g, device=dev).to(dtype)
    if "y.T" in layout:
        y = torch.randn((E, N, K), generator=g, device=dev).to(dtype).transpose(1, 2)
    else:
        y = torch.randn((E, K, N), generator=g, device=dev).to(dtype)
    return x, y


K7B_SHAPES = [(1, 5, 37, 3), (3, 30, 300, 130), (5, 129, 70, 257), (64, 4, 2048, 1408),
              (64, 30, 1408, 2048), (2, 1, 64, 256), (2, 256, 128, 264)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("E,M,K,N", K7B_SHAPES)
@pytest.mark.parametrize("layout", ["", "y.T", "x.T y.T"])
def test_matmul_batched_matches_plain(cuda, dtype, E, M, K, N, layout):
    """Both bodies: fp32 and 16-bit rows TMA cannot read on FMA, the rest
    on wgmma; one launch for every expert."""
    from repro_torch.kernels.matmul.ops import batched_body_for
    x, y = _k7b_operands(cuda, E, M, K, N, dtype, layout)
    k = dispatch.kernel_table()["matmul_batched"]
    body = batched_body_for(x, y)
    rows_aligned = K % 8 == 0 and (N % 8 == 0 or "y.T" in layout)   # 16-byte rows
    assert body == ("fma" if dtype == torch.float32 or not rows_aligned else
                    "wgmma_persistent" if M * N >= K * (M + N) and N % 8 == 0 else "wgmma")
    dispatch.reset_counts()
    out = k.launch(x, y)
    ref = k.plain(x.float(), y.float())
    torch.cuda.synchronize()
    assert k.body_launches == {body: 1}
    assert out.shape == (E, M, N) and out.dtype == dtype
    assert k.tolerance(out, ref, K) <= 1.0


@pytest.mark.parametrize("dtype,K", [(torch.float32, 2048), (torch.bfloat16, 2048),
                                     (torch.bfloat16, 37)])
@pytest.mark.parametrize("E,M,N", [(1, 30, 1408), (64, 30, 1408), (64, 4, 1408),
                                   (3, 200, 300)])
def test_matmul_batched_experts_equal_2d_bits(cuda, dtype, K, E, M, N):
    """Each expert's output is the 2-D entry's bits on that expert's
    operands (the same body, tile and order; no rows of a neighbouring
    expert in a ragged tile), and the two tiles agree bit for bit."""
    x, y = _k7b_operands(cuda, E, M, K, N, dtype, seed=3)
    k = dispatch.kernel_table()["matmul_batched"]
    k2 = dispatch.kernel_table()["matmul"]
    out = k.launch(x, y)
    for e in range(E):
        assert torch.equal(out[e], k2.launch(x[e], y[e])), e
    assert torch.equal(k.launch(x, y, tile="wide"), k.launch(x, y, tile="narrow"))


@pytest.mark.parametrize("compute_dtype,limit", [("float32", 1e-5), ("bfloat16", 2.0 ** -6)])
def test_moe_layer_at_deepseek_widths_matches_plain(cuda, compute_dtype, limit):
    """One deepseek-moe-16b MoE layer (64 experts of 2048 x 1408, top-6, a
    256-row prefill chunk: capacity 30) through the kernels -- the router
    on K7's FMA body, the experts' three products one batched launch each
    -- against the plain versions on the plain run's routes."""
    from repro_torch.models.layers import moe as TM
    from repro_torch.models.layers.module import init_table
    cfg = TR.config("deepseek-moe-16b")
    m = cfg.moe
    dt = getattr(torch, compute_dtype)
    g = torch.Generator(cuda).manual_seed(0)
    p = init_table(g, TM.moe_table(cfg.d_model, m.num_experts, m.d_ff_expert), "float32",
                   cast=(("w_gate", "w_up", "w_down"), compute_dtype))
    x = torch.randn((1, 256, cfg.d_model), generator=g, device=cuda).to(dt)
    with dispatch.plain_versions():
        idx, prob, _ = TM.route(m, p, x)
        want = TM.moe_einsum(m, p, x, idx, prob)
    dispatch.reset_counts()
    got = TM.moe_einsum(m, p, x, idx, prob)
    kidx, _, _ = TM.route(m, p, x)
    torch.cuda.synchronize()
    table = dispatch.kernel_table()
    assert table["matmul_batched"].launches == 3 and table["matmul"].body_launches == {"fma": 1}
    assert all(t.plain_calls == 0 for t in table.values())
    assert TM.capacity_of(m, 256) == 30
    assert int((kidx != idx).any(-1).sum()) <= 1          # a near-tie may flip one token
    rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert got.dtype == dt and rel <= limit


def test_batched_entry_refuses_inputs_that_require_grad(cuda):
    """K7's batched entry called directly with grad on raises, naming
    ``linear.batched_matmul``, whose Function carries its gradient."""
    from repro_torch.models.layers.linear import batched_matmul
    x, y = _k7b_operands(cuda, 3, 5, 16, 24, torch.float32)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="linear.batched_matmul"):
        dispatch.kernel_table()["matmul_batched"](x, y)
    assert batched_matmul(x, y).grad_fn is not None


# (E, C, D, F) of a product x (E, C, D) @ w (E, D, F) whose backward runs:
# a training microbatch's 60 rows at deepseek's widths (gate/up, down;
# dW on the persistent body, many more tiles than resident blocks),
# contractions of 1, 7, 61 and 129 rows in dW (129 at 264 x 136 reads more
# than it writes: the tile-per-block body),
# one expert, ragged sizes TMA can read and sizes it cannot (FMA at 16
# bits)
K7B_BWD_SHAPES = [(64, 60, 2048, 1408), (64, 60, 1408, 2048), (64, 1, 2048, 1408),
                  (8, 7, 264, 136), (5, 13, 520, 1000), (5, 13, 517, 999),
                  (64, 61, 2048, 1408), (1, 60, 2048, 1408), (4, 129, 264, 136)]


def _k7b_bodies(dtype, C, D, F) -> dict:
    """The batched entry's body for the forward, dX and dW of x (E, C, D)
    @ w (E, D, F): FMA unless bf16 with 16-byte rows, then the persistent
    body where the (M x K) @ (K x N) product writes at least the elements
    it reads, else wgmma."""
    if dtype != torch.bfloat16 or D % 8 or F % 8:
        return {"fwd": "fma", "dX": "fma", "dW": "fma"}
    return {v: "wgmma_persistent" if M * N >= K * (M + N) else "wgmma"
            for v, (M, K, N) in (("fwd", (C, D, F)), ("dX", (C, F, D)), ("dW", (D, C, F)))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", K7B_BWD_SHAPES)
def test_batched_matmul_backward_matches_plain(cuda, dtype, E, C, D, F):
    """``linear.batched_matmul``'s gradients through the batched entry:
    dX = dY @ w^T (w^T k-contiguous) and dW = x^T @ dY (x^T m-contiguous),
    one launch each on the body the route names -- wgmma for 16-bit views
    TMA can read, FMA for the rest -- each within K7's limit of the plain
    version on the same operands, and the same bits on a second run."""
    from repro_torch.kernels.matmul.ops import batched_body_for
    from repro_torch.models.layers.linear import batched_matmul
    x, w = _k7b_operands(cuda, E, C, D, F, dtype, seed=5)
    dy = _k7b_operands(cuda, E, C, F, 1, dtype, seed=6)[0]
    k = dispatch.kernel_table()["matmul_batched"]
    want = _k7b_bodies(dtype, C, D, F)
    assert batched_body_for(x, w) == want["fwd"]
    assert batched_body_for(dy, w.transpose(1, 2)) == want["dX"]
    assert batched_body_for(x.transpose(1, 2), dy) == want["dW"]
    grads = []
    for _ in range(2):
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        dispatch.reset_counts()
        batched_matmul(xr, wr).backward(dy)
        torch.cuda.synchronize()
        assert k.body_launches == dict(Counter(want.values())) and k.plain_calls == 0
        grads.append((xr.grad, wr.grad))
    (dx, dw), (dx2, dw2) = grads
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert dx.dtype == dw.dtype == dtype
    assert k.tolerance(dx, k.plain(dy.float(), w.float().transpose(1, 2)), F) <= 1.0
    assert k.tolerance(dw, k.plain(x.float().transpose(1, 2), dy.float()), C) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", [(64, 60, 2048, 1408), (8, 7, 264, 136),
                                     (5, 13, 517, 999), (64, 60, 1408, 2048),
                                     (1, 60, 2048, 1408), (64, 1, 2048, 1408),
                                     (64, 61, 2048, 1408), (5, 13, 520, 1000),
                                     (64, 129, 2048, 1408)])
def test_batched_backward_experts_equal_2d_bits(cuda, dtype, E, C, D, F):
    """Each expert's dX and dW are the 2-D entry's bits on that expert's
    views (w[e].T, x[e].T): the contraction's ragged edge C fills zeros
    inside the expert, never the next expert's rows.  At bf16 every dW
    here but the unaligned one runs the persistent body: a walk of more
    tiles than resident blocks, one expert, C = 1 and 61, C = 129 (three
    slices a tile, the ring's parity across tiles), ragged M and N (N % 8
    == 0) clipped by the output map inside each expert."""
    x, w = _k7b_operands(cuda, E, C, D, F, dtype, seed=7)
    dy = _k7b_operands(cuda, E, C, F, 1, dtype, seed=8)[0]
    k = dispatch.kernel_table()["matmul_batched"]
    k2 = dispatch.kernel_table()["matmul"]
    from repro_torch.kernels.matmul.ops import batched_body_for
    assert batched_body_for(x.transpose(1, 2), dy) == _k7b_bodies(dtype, C, D, F)["dW"]
    dx = k.launch(dy, w.transpose(1, 2))
    dw = k.launch(x.transpose(1, 2), dy)
    for e in range(E):
        assert torch.equal(dx[e], k2.launch(dy[e], w[e].T)), e
        assert torch.equal(dw[e], k2.launch(x[e].T, dy[e])), e


@pytest.mark.parametrize("compute_dtype,limit", [("float32", 1e-4), ("bfloat16", 2.0 ** -5)])
def test_moe_layer_gradients_at_deepseek_widths_match_plain(cuda, compute_dtype, limit):
    """One deepseek-moe-16b MoE layer (64 experts of 2048 x 1408, top-6, a
    512-token microbatch: capacity 60) differentiated through the kernels
    -- the router's three products on K7's FMA body, the experts' products
    and their dX / dW on the batched entry -- against the plain versions on
    the same routes: x's and every weight's gradient within ``limit`` of
    its largest entry (fp32: sums in other orders through a softmax and a
    SwiGLU; bf16: dW rounds once to bf16, 2^-8, on top of the forward's
    2^-6 limit's ulp flips of h)."""
    from repro_torch.models.layers import moe as TM
    from repro_torch.models.layers.module import init_table
    cfg = TR.config("deepseek-moe-16b")
    m = cfg.moe
    dt = getattr(torch, compute_dtype)
    g = torch.Generator(cuda).manual_seed(0)
    p = init_table(g, TM.moe_table(cfg.d_model, m.num_experts, m.d_ff_expert), "float32")
    x0 = torch.randn((1, 512, cfg.d_model), generator=g, device=cuda).to(dt)
    dy = torch.randn((1, 512, cfg.d_model), generator=g, device=cuda).to(dt)
    with dispatch.plain_versions():
        idx = TM.route(m, p, x0)[0]
    topk = torch.topk

    def replayed(probs, k, *a, **kw):      # both runs on the plain run's choices
        if k == m.top_k and probs.shape[-1] == m.num_experts:
            return probs.gather(-1, idx), idx
        return topk(probs, k, *a, **kw)

    def grads():
        x = x0.clone().requires_grad_(True)
        for t in p.values():
            t.requires_grad_(True)
            t.grad = None
        with mock.patch.object(torch, "topk", replayed):
            _, prob, aux = TM.route(m, p, x)
        y = TM.moe_einsum(m, p, x, idx, prob)
        torch.autograd.backward((y, aux), (dy, torch.ones_like(aux)))
        out = {"x": x.grad, **{k: t.grad for k, t in p.items()}}
        for t in p.values():
            t.requires_grad_(False)
        return out
    with dispatch.plain_versions():
        want = grads()
    dispatch.reset_counts()
    got = grads()
    torch.cuda.synchronize()
    table = dispatch.kernel_table()
    assert TM.capacity_of(m, 512) == 60
    assert table["matmul_batched"].launches == 9 and table["matmul"].body_launches == {"fma": 3}
    assert all(t.plain_calls == 0 for t in table.values())
    slot, keep = TM.dispatch_slots(m, idx, 60)
    assert len(idx[keep].unique()) == m.num_experts      # every expert's dW is checked
    for k, v in want.items():
        rel = ((got[k].float() - v.float()).abs().max() / v.float().abs().max()).item()
        assert rel <= limit, (k, rel)


# ---------------------------------------------------------------------------
# K4 at a KV length of its own (cross-attention), whisper's decode step,
# and K5's backward stopped after a pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,S_kv,H,K", [(192, 1500, 16, 16), (192, 1037, 16, 16),
                                        (1, 1500, 16, 16), (70, 33, 8, 2), (5, 65, 4, 4)])
def test_flash_kernel_takes_a_kv_length_of_its_own(cuda, dtype, S, S_kv, H, K):
    """K4 non-causal with k and v of S_kv rows, ragged past a 64-row tile,
    fewer keys than queries, GQA, on both bodies (fp32 on FMA, bf16 at D =
    64 on mma), two sequences: the batch stride of k and v is S_kv rows,
    and no tile is staged past them (the second sequence's rows, or past
    the allocation: NaN written right after k and v would show)."""
    from repro_torch.kernels.flash_attention.ops import body_for
    g = torch.Generator(cuda).manual_seed(S + S_kv)
    q = torch.randn((2, S, H, 64), generator=g, device=cuda).to(dtype)
    buf = torch.full((2, 2 * S_kv + 64, K, 64), float("nan"), device=cuda, dtype=dtype)
    kv = torch.randn((2, 2, S_kv, K, 64), generator=g, device=cuda).to(dtype)
    k = buf[0, :2 * S_kv].view(2, S_kv, K, 64)
    v = buf[1, :2 * S_kv].view(2, S_kv, K, 64)
    k.copy_(kv[0])
    v.copy_(kv[1])
    kern = dispatch.kernel_table()["flash_attention"]
    dispatch.reset_counts()
    out = kern.launch(q, k, v, causal=False)
    ref = kern.plain(q.float(), k.float(), v.float(), causal=False)
    torch.cuda.synchronize()
    assert kern.body_launches == {body_for(q): 1}
    assert body_for(q) == ("mma" if dtype == torch.bfloat16 else "fma")
    assert kern.tolerance(out, ref) <= 1.0
    with pytest.raises(ValueError, match="causal attention takes k and v"):
        kern.launch(q, k, v, causal=True)


def test_whisper_decode_step_runs_k3_for_the_cross_attention(cuda):
    """One decode step of a whisper-medium-shaped model (2 + 2 layers,
    full widths and 1500 frames) through the kernels against the plain
    versions, from the same prefilled state: K3 twice a layer (self
    attention with its row write, cross-attention against the 1500 fixed
    rows), logits within 1e-4 of the largest at fp32 and the self caches'
    new rows written."""
    import dataclasses

    from repro_torch.models import encdec
    cfg = TR.config("whisper-medium").replace(compute_dtype="float32", num_layers=2)
    cfg = cfg.replace(encdec=dataclasses.replace(cfg.encdec, num_encoder_layers=2))
    params = encdec.prepare_params(cfg, encdec.init(cfg, torch.Generator(cuda).manual_seed(0)))
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g, device=cuda,
                         dtype=torch.int32)
    frames = torch.randn((2, 1500, cfg.d_model), generator=g, device=cuda)
    _, state = encdec.prefill(cfg, params, toks, frames, max_len=32, cache_dtype="float32")
    tok = toks[:, :1]
    with dispatch.plain_versions():
        want, ws = encdec.decode_step(cfg, params, tok, state._replace(
            self_k=state.self_k.clone(), self_v=state.self_v.clone()))
    dispatch.reset_counts()
    got, gs = encdec.decode_step(cfg, params, tok, state)
    torch.cuda.synchronize()
    table = dispatch.kernel_table()
    assert dict(table["decode_attention"].body_launches) == {"fma": 2 * cfg.num_layers}
    assert not any(k.plain_calls for k in table.values())
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    assert torch.allclose(gs.self_k[:, :, 12], ws.self_k[:, :, 12], rtol=1e-4, atol=1e-4)
    assert gs.length.tolist() == [13, 13]


@pytest.mark.parametrize("dtype,body", [(torch.float32, "fma"), (torch.bfloat16, "mma"),
                                        (torch.bfloat16, "fma")])
@pytest.mark.parametrize("S,S_kv,H,K", [(448, 1500, 16, 16), (448, 1037, 16, 16),
                                        (1, 1500, 16, 16), (70, 33, 8, 2), (5, 65, 4, 4)])
def test_flash_backward_takes_a_kv_length_of_its_own(cuda, dtype, body, S, S_kv, H, K):
    """K4's backward non-causal with k and v of S_kv rows (ragged past a
    64-row tile, fewer keys than queries, GQA), on both bodies, two
    sequences: the batch stride of k, v, dk and dv is S_kv rows and no tile
    is staged past them (NaN written right after k and v would show); each
    gradient within ``GRAD_RTOL`` of the plain version in fp32, two
    launches the same bits; a causal call at S_kv != S raises."""
    g = torch.Generator(cuda).manual_seed(S + S_kv + H)
    q, do = (torch.randn((2, S, H, 64), generator=g, device=cuda).to(dtype) for _ in range(2))
    buf = torch.full((2, 2 * S_kv + 64, K, 64), float("nan"), device=cuda, dtype=dtype)
    kv = torch.randn((2, 2, S_kv, K, 64), generator=g, device=cuda).to(dtype)
    k = buf[0, :2 * S_kv].view(2, S_kv, K, 64)
    v = buf[1, :2 * S_kv].view(2, S_kv, K, 64)
    k.copy_(kv[0])
    v.copy_(kv[1])
    fwd = dispatch.kernel_table()["flash_attention"]
    bwd = dispatch.kernel_table()["flash_attention_backward"]
    out, lse = fwd.launch(q, k, v, causal=False, with_lse=True)
    ref = bwd.plain(*(t.float() for t in (q, k, v, out, do)), lse, causal=False)
    dispatch.reset_counts()
    grads = bwd.launch(q, k, v, out, do, lse, causal=False, body=body)
    again = bwd.launch(q, k, v, out, do, lse, causal=False, body=body)
    torch.cuda.synchronize()
    assert bwd.body_launches == {body: 2}
    assert [tuple(t.shape) for t in grads] == [(2, S, H, 64), (2, S_kv, K, 64), (2, S_kv, K, 64)]
    assert bwd.tolerance(grads, ref) <= 1.0
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    with pytest.raises(ValueError, match="causal attention takes k and v"):
        bwd.launch(q, k, v, out, do, lse, causal=True)


def _microbatch_grads(cfg, params, batch):
    """Loss and every gradient of one microbatch through the kernels and
    through the plain versions, with the kernel run's launches by body and
    any plain call it made."""
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.train_step import make_loss_fn
    ps = leaves(params)
    runs = []
    for plain in (False, True):
        for t in ps:
            t.requires_grad_(True)
        dispatch.reset_counts()
        with dispatch.plain_versions() if plain else contextlib.nullcontext():
            loss, _ = make_loss_fn(cfg)(params, batch)
            grads = torch.autograd.grad(loss, ps)
        table = dispatch.kernel_table()
        runs.append((loss.item(), grads, {n: dict(t.body_launches) for n, t in table.items()
                                          if t.launches},
                     {n: t.plain_calls for n, t in table.items() if t.plain_calls}))
        for t in ps:
            t.requires_grad_(False)
    return runs


def _held_to_the_plain_versions(runs, keys, zero_bias=False):
    """The kernels' loss within 1e-5 of the plain versions', each gradient
    leaf within 1e-3 of the plain leaf's largest entry (a key bias's, whose
    exact gradient is zero without RoPE, of its query bias's)."""
    (kl, kg, _, _), (pl, pg, _, _) = runs
    assert np.isfinite(kl) and abs(kl - pl) <= 1e-5 * abs(pl)
    at = {k: i for i, k in enumerate(keys)}
    for i, key in enumerate(keys):
        ref = pg[at[key[:-1] + ("bq",)]] if zero_bias and key[-1] == "bk" else pg[i]
        assert (kg[i] - pg[i]).abs().max() <= 1e-3 * ref.abs().max(), key


def _keys(tree, prefix=()):
    if isinstance(tree, dict):
        return [k for key, v in tree.items() for k in _keys(v, prefix + (key,))]
    return [prefix]


def test_whisper_microbatch_runs_the_kernels(cuda):
    """One training microbatch of a whisper-medium-shaped model (1 encoder
    and 1 decoder layer at full widths, 1500 frames, 64 decoder tokens,
    fp32, remat "full") through the kernels against the plain versions:
    K4 (encoder, causal self, cross at S_kv = 1500) twice a layer with the
    recompute, its backward once each, K7 for every product, all on FMA,
    no plain call; the loss and every gradient leaf agree."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticTokens
    cfg = TR.config("whisper-medium").replace(compute_dtype="float32", num_layers=1)
    cfg = cfg.replace(encdec=dataclasses.replace(cfg.encdec, num_encoder_layers=1))
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    batch = {k: torch.as_tensor(v).to(cuda)
             for k, v in next(SyntheticTokens(cfg, 1, 64, seed=2)).items()}
    assert tuple(batch["frames"].shape) == (1, 1500, 1024)
    runs = _microbatch_grads(cfg, params, batch)
    fwd = 6 + 8 + 2 + 1
    assert runs[0][2] == {"flash_attention": {"fma": 6}, "flash_attention_backward": {"fma": 3},
                          "matmul": {"fma": fwd + 14 + 2 * fwd}}
    assert not runs[0][3]
    _held_to_the_plain_versions(runs, _keys(params), zero_bias=True)


def test_qwen2_vl_microbatch_runs_the_kernels(cuda):
    """One training microbatch of qwen2-vl-72b at full widths cut to one
    layer (fp32, remat "full", 1 x 64 tokens, position streams 1 and 2
    drawn apart from stream 0) through the kernels against the plain
    versions: K4 twice, its backward once, K7 for every product, all on
    FMA, no plain call; the loss and every gradient leaf agree."""
    from repro_torch.data.pipeline import SyntheticTokens
    cfg = TR.config("qwen2-vl-72b").replace(compute_dtype="float32", num_layers=1)
    params = fns_for(cfg).init(cfg, torch.Generator(cuda).manual_seed(0))
    batch = next(SyntheticTokens(cfg, 1, 64, seed=2))
    batch["positions"][1:] = np.random.default_rng(2).integers(0, 256, (2, 1, 64))
    batch = {k: torch.as_tensor(v).to(cuda) for k, v in batch.items()}
    runs = _microbatch_grads(cfg, params, batch)
    assert runs[0][2] == {"flash_attention": {"fma": 2}, "flash_attention_backward": {"fma": 1},
                          "matmul": {"fma": 8 + 7 + 2 * 8}}
    assert not runs[0][3]
    _held_to_the_plain_versions(runs, _keys(params))
    del params, runs
    torch.cuda.empty_cache()


@pytest.mark.parametrize("N,P,dtype", [(64, 64, torch.bfloat16), (64, 64, torch.float32),
                                       (384, 385, torch.float32)])
def test_ssm_scan_backward_stops_after_a_pass(cuda, N, P, dtype):
    """``last_pass`` at the final pass gives the default's bits; a run
    stopped after an earlier pass leaves the later passes' outputs as the
    allocator handed them (filled with NaN here), on the mma body, the FMA
    body's whole rows and its sliced layout (six passes)."""
    from repro_torch.kernels.ssm_scan import ops
    (q, k, v, ld, lg), _ = _ssm_operands(cuda, dtype, 300, N, P, False, B=1, H=4)
    dy = torch.randn((1, 300, 4, P), device=cuda)
    bwd = dispatch.kernel_table()["ssm_scan_backward"]
    body = ops.backward_body_for(q, k, v)
    passes = ops.backward_passes(body, N, P)
    assert len(passes) == (6 if ops.backward_sliced(N, P) else 5)
    whole = bwd.launch(q, k, v, ld, lg, dy, chunk=128)
    last = bwd.launch(q, k, v, ld, lg, dy, chunk=128, last_pass=len(passes))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(whole, last) if a is not None)
    def nan_filled(alloc):
        return lambda *a, **kw: alloc(*a, **kw).fill_(float("nan"))
    with mock.patch.object(torch, "empty", nan_filled(torch.empty)), \
            mock.patch.object(torch, "empty_like", nan_filled(torch.empty_like)):
        early = bwd.launch(q, k, v, ld, lg, dy, chunk=128, last_pass=2)
    torch.cuda.synchronize()
    dq, dk, dv, dld, dlg, _ = early          # written by the rows, cols and finish passes
    for t in (dq, dk, dv, dld, dlg):
        assert torch.isnan(t.float()).all()
    with pytest.raises(ValueError, match="last_pass"):
        bwd.launch(q, k, v, ld, lg, dy, chunk=128, last_pass=len(passes) + 1)


# -- training under a device mesh ---------------------------------------------

@pytest.mark.parametrize("M,K,N,layout", [(1024, 2048, 2752, ""), (1024, 2752, 2048, ""),
                                          (1024, 2752, 2048, "y.T"), (2048, 1024, 2752, "x.T"),
                                          (1024, 2048, 37984, "y.T")])
def test_matmul_at_a_ranks_slices_keeps_the_wgmma_body(cuda, M, K, N, layout):
    """K7 at a 1 x 4 rank's slices of qwen2.5-3b in bf16 -- the SwiGLU's
    2752 ``ff`` columns (gate / up, down, the backward's dX on W^T and dW
    on X^T) and the LM head's 37984 vocabulary columns read from the tied
    table's slice transposed -- routes to ``wgmma``, within K7's limit."""
    from repro_torch.kernels.matmul.ops import body_for
    x, y = _k7_operands(cuda, M, K, N, torch.bfloat16, layout)
    k = dispatch.kernel_table()["matmul"]
    assert body_for(x, y) == "wgmma"
    dispatch.reset_counts()
    out = k.launch(x, y)
    ref = k.plain(x.float(), y.float())
    torch.cuda.synchronize()
    assert k.body_launches == {"wgmma": 1}
    assert k.tolerance(out, ref, K) <= 1.0


def test_flash_kernel_on_a_ranks_heads_matches_plain(cuda):
    """K4 and its backward on a 1 x 4 rank's heads of qwen2.5-3b: 4 query
    heads against the one KV head their group reads (2 x 512, causal,
    bf16), each against its plain version in fp32, on the mma bodies."""
    g = torch.Generator(cuda).manual_seed(4)
    q = torch.randn((2, 512, 4, 128), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((2, 512, 1, 128), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    do = torch.randn((2, 512, 4, 128), generator=g, device=cuda).bfloat16()
    fwd = dispatch.kernel_table()["flash_attention"]
    bwd = dispatch.kernel_table()["flash_attention_backward"]
    dispatch.reset_counts()
    out, lse = fwd.launch(q, k, v, causal=True, with_lse=True)
    ref_out = fwd.plain(q.float(), k.float(), v.float(), causal=True)
    grads = bwd.launch(q, k, v, out, do, lse, causal=True)
    ref = bwd.plain(*(t.float() for t in (q, k, v, out, do)), lse, causal=True)
    torch.cuda.synchronize()
    assert fwd.body_launches == {"mma": 1} and bwd.body_launches == {"mma": 1}
    assert fwd.tolerance(out, ref_out) <= 1.0
    assert bwd.tolerance(grads, ref) <= 1.0


def test_nccl_mesh_training_step_equals_unsharded(cuda, tmp_path):
    """qwen2.5-3b-smoke (bf16 compute) trained 2 steps of 4 x 64 in 2
    microbatches by the ``Trainer`` without a mesh and on a 1 x 1 NCCL
    mesh under ``rules_for``'s training rules: every collective has one
    rank and the arithmetic is the same, so every metric and updated
    parameter is the same bits, with the same launches by body and no
    plain call."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.optimizers import leaves
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = TR.smoke("qwen2.5-3b")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh(1, 1)
        rules = rules_for(cfg, ShapeConfig("t", "train", 64, 4), mesh)
        table = dispatch.kernel_table()
        runs = []
        for i, (r, m) in enumerate(((None, None), (rules, mesh))):
            tc = TrainerConfig(num_steps=2, ckpt_every=50, ckpt_dir=str(tmp_path / str(i)),
                               device="cuda")
            tr = Trainer(cfg, iter(SyntheticTokens(cfg, 4, 64, seed=0)), tc, accum=2,
                         rules=r, mesh=m)
            tr.init_state()
            dispatch.reset_counts()
            collectives.reset_collective_counts()
            hist = tr.train()
            torch.cuda.synchronize()
            runs.append((hist, tr.params, {n: dict(k.body_launches) for n, k in table.items()
                                           if k.launches},
                         {n: k.plain_calls for n, k in table.items() if k.plain_calls},
                         collectives.collective_counts()))
    finally:
        dist.destroy_process_group()
    (h0, p0, b0, plain0, _), (h1, p1, b1, plain1, c1) = runs
    for a, b in zip(h0, h1):
        assert all(a[k] == b[k] for k in ("loss", "nll", "accuracy", "grad_norm"))
    assert all(torch.equal(a, b) for a, b in zip(leaves(p0), leaves(p1)))
    assert b0 == b1 and not plain0 and not plain1
    assert c1["all_gather"] > 0 and c1["reduce_scatter"] > 0
