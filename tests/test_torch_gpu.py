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
against their plain versions evaluated in fp32 on the same values: each
gradient within ``GRAD_RTOL`` of its largest entry (fp32 2^-14, a bf16
gradient 2^-8, fp16 2^-10); K4's log-sum-exp on both bodies within 1e-5
of the plain one.  A kernel called on the card with an input that requires
grad raises, naming where its gradient is (or that it has none).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.kernels import dispatch
from repro_torch.kernels.ssm_scan.ops import body_for as ssm_body_for
from repro_torch.models.googlenet import conv_shapes
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
    """K4 with its log-sum-exp (either body), then the backward kernel, each
    against its plain version in fp32 on the same values."""
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
    ref = bwd.plain(*(t.float() for t in (q, k, v, out, do)), lse, causal=causal)
    torch.cuda.synchronize()
    assert [t.dtype for t in grads] == [dtype] * 3
    assert bwd.body_launches == {"fma": 1}
    assert bwd.tolerance(grads, ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,chunk,shared,state", [(512, 128, True, False),
                                                  (1000, 128, True, True),
                                                  (45, 32, False, True), (7, 128, True, False),
                                                  (300, 64, False, False)])
@pytest.mark.parametrize("N,P", [(64, 64), (16, 16), (32, 48), (128, 128)])
def test_ssm_scan_backward_kernel_matches_plain(cuda, dtype, S, chunk, shared, state, N, P):
    """K5's backward on q / k as stride-0 head views or per head, ragged S,
    with and without a carried state and a final-state gradient."""
    (q, k, v, ld, lg), h0 = _ssm_operands(cuda, dtype, S, N, P, shared, B=1, H=8)
    g = torch.Generator(cuda).manual_seed(S + 1)
    dy = torch.randn((1, S, 8, P), generator=g, device=cuda)
    df = torch.randn((1, 8, N, P), generator=g, device=cuda) if state else None
    h0 = h0[:1] if state else None
    bwd = dispatch.kernel_table()["ssm_scan_backward"]
    bwd.reset_counts()
    grads = bwd.launch(q, k, v, ld, lg, dy, df, chunk=chunk, initial_state=h0)
    ref = bwd.plain(q.float(), k.float(), v.float(), ld, lg, dy, df, chunk=chunk,
                    initial_state=h0)
    torch.cuda.synchronize()
    assert bwd.body_launches == {"fma": 1}
    assert [t is None for t in grads] == [t is None for t in ref]
    assert grads[0].dtype == grads[1].dtype == grads[2].dtype == dtype
    assert bwd.tolerance(grads, ref) <= 1.0


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
        runs.append((float(m["loss"]), grads[0]))
    assert np.isfinite(runs[0][0])
    assert abs(runs[0][0] - runs[1][0]) <= 1e-5 * abs(runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


def _conv_backward_cases():
    """Phase 22a's cases: every distinct conv shape of GoogLeNet's batch-8
    forward at 224 (dx where training asks for it: every conv but stem1),
    stem1 with dx (stride 2, SAME padding 2 before and 3 after), odd maps
    at strides 1 and 2."""
    seen, cases = set(), []
    for name, xs, ws, stride in conv_shapes(8, 224):
        if (xs, ws, stride) not in seen:
            seen.add((xs, ws, stride))
            cases.append((xs, ws, stride, name != "stem1"))
    return cases + [((8, 224, 224, 3), (7, 7, 3, 64), 2, True),
                    ((3, 13, 11, 5), (3, 3, 5, 7), 2, True),
                    ((2, 9, 9, 3), (7, 7, 3, 10), 2, True),
                    ((1, 15, 17, 24), (5, 5, 24, 40), 1, True),
                    ((2, 10, 10, 33), (1, 1, 33, 17), 2, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("xs,ws,stride,need_dx", _conv_backward_cases())
def test_conv2d_backward_kernel_matches_plain(cuda, dtype, xs, ws, stride, need_dx):
    """K6's backward (dgrad where asked, wgrad and db) against its plain
    version evaluated in fp32 on the same values, each gradient within
    ``GRAD_RTOL`` of its largest entry; split passes give the same bits
    launch after launch; counted by pass."""
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
    assert bwd.body_launches == ({"dgrad": 2, "wgrad": 2} if need_dx else {"wgrad": 2})
    assert (out[0] is None) == (not need_dx)
    assert [t.dtype for t in out[1:]] == [dtype, torch.float32]
    assert dispatch.grad_tolerance_ratio(out, ref) <= 1.0
    assert all(torch.equal(u, v) for u, v in zip(out, again) if u is not None)


def test_googlenet_train_step_runs_the_kernels(cuda):
    """One fp32 train step of GoogLeNet (the full graph at 64 x 64, batch
    4 in 2 microbatches) on the card: K6, its backward (dgrad for every
    conv but stem1, wgrad for all 57) and K7 launched exactly, no plain
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
        "conv2d": {"fma": 114}, "conv2d_backward": {"dgrad": 112, "wgrad": 114},
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
