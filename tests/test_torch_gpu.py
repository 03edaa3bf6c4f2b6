"""Tests that need an NVIDIA card: each hand-written CUDA kernel against its
plain PyTorch version on the card, and the port's engine driving its path
through the kernels.  Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Elsewhere every test here skips (the ``cuda`` fixture decides, at run
time, so every pytest worker collects the same tests).

Tolerances on the card (``dispatch.tolerance_ratio``): each kernel is held
against its plain version evaluated in fp32 on the same values; fp32
within 1e-4 (the two sum in other orders); bf16 within 2^-7 |ref| +
2^-6 rms(ref) per element (the kernel rounds p before the PV product and
its output to bf16).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.kernels import dispatch
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


def test_engine_path_runs_the_kernels(cuda):
    """The smoke model served on the card launches both kernels and never
    their plain versions."""
    cfg = TR.smoke("qwen2.5-3b")
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
    assert all(k.launches > 0 and k.plain_calls == 0 for k in table.values())
    assert all(len(r.output) == 5 for r in reqs)
    assert eng.pool.leak_report() == {"unheld_blocks": 0, "reserved_blocks": 0}
