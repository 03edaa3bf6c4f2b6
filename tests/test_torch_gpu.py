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
only the order of the sums differs).  matmul (K7): MATMUL_RTOL |ref| +
2^-20 sqrt(K) max|ref| per element (twice the output's one rounding:
none at fp32, 2^-10 fp16, 2^-7 bf16; and the fp32 sum's order), on
either body (FMA, or wgmma for fp16 / bf16 operands TMA can read); the
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
trivial table.  Training
on the card: the smoke model's loss and gradients through the kernels
within 1e-3 of each leaf's largest entry of those through the plain
versions (the same fp32 arithmetic in other orders; the random model's
near-one-hot attention amplifies rounding in the backward).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.kernels import dispatch
from repro_torch.models.googlenet import conv_shapes
from repro_torch.models.registry import fns_for
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampler import greedy

pytestmark = pytest.mark.gpu


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
    assert eng.pool.leak_report() == {"unheld_blocks": 0, "reserved_blocks": 0}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,chunk,shared", [(100, 32, True), (128, 128, False),
                                            (7, 128, True), (300, 64, False)])
def test_ssm_scan_kernel_matches_plain(cuda, dtype, S, chunk, shared):
    """K5 with a ragged S, a carried-in state, and B/C as a stride-0 head
    view or per head."""
    B, H, N, P = 2, 4, 32, 48
    g = torch.Generator(cuda).manual_seed(S)
    hq = 1 if shared else H
    q, k = (torch.randn((B, S, hq, N), generator=g, device=cuda).to(dtype)
            .expand(B, S, H, N) for _ in range(2))
    v = torch.randn((B, S, H, P), generator=g, device=cuda).to(dtype)
    dt = torch.exp(torch.empty((B, S, H), device=cuda).uniform_(
        -6.9, -2.3, generator=g))
    ld = -dt * torch.linspace(1.0, 16.0, H, device=cuda)
    h0 = torch.randn((B, H, N, P), generator=g, device=cuda)
    kern = dispatch.kernel_table()["ssm_scan"]
    out = kern.launch(q, k, v, ld, torch.log(dt), chunk=chunk,
                      initial_state=h0)
    ref = kern.plain(q.float(), k.float(), v.float(), ld, torch.log(dt),
                     chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    assert kern.tolerance(out, ref) <= 1.0


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
