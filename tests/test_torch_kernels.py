"""The port's kernel wrappers on the CPU: each kernel's plain PyTorch version
against the JAX oracle (``ref.py``) and against the Pallas TPU kernel run
in interpret mode, on the same numpy inputs; plus the dispatch rules
(CPU tensors take the plain version and are counted; an int8 pool without
its scales, scales beside another pool, and non-CUDA tensors at the CUDA
launcher raise; a missing nvcc raises).  K1 and K2 on int8 pools with fp32
scales (``quantize_kv`` of the same numpy pool) are held against the
Pallas kernels' quant branch and the JAX oracles at fp32 (atol 2e-5, the
reference's own limit for its int8 paged kernels) and bf16 (2e-2), and
their int8 routes (``mma_i8`` / ``fma_i8``) are pinned.
The dense decode (K3) and flash (K4) plain versions are also held at a
ragged S, which the Pallas kernels refuse, against ``chunked_attention``
(K3 with lengths past S, as an idle serving slot has them); K5's are in
``tests/test_torch_ssm.py``.  The arithmetic of K1's split body (64-key
splits, each with its own max, merged by log-sum-exp) is emulated in fp32
and held against the Pallas kernel, and so is K3's (the same body on the
cache read as a pool through a trivial table) against the dense Pallas
kernel; the routes of K1, K2, K3 and K4 (which body a call runs) are
pinned by dtype, head_dim and group size.

Shapes follow the reference's kernel smoke cases
(``benchmarks/kernel_bench.py``): pool (1 + 2*4, 16, 2, 64), H=4 query heads
over K=2 kv heads.  Tolerances: fp32 atol 1e-5 (same arithmetic, other
summation order); bf16 atol 2e-2 (the Pallas kernel keeps scores in fp32
where the oracles round them to bf16, plus one bf16 output rounding).
"""
import ctypes
import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import \
    decode_attention as jax_pallas_dense_decode
from repro.kernels.decode_attention.kernel import \
    paged_decode_attention as jax_pallas_decode
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_dense_decode_ref
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.kernel import \
    flash_attention as jax_pallas_flash
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro.kernels.prefill_attention.kernel import \
    paged_prefill_attention as jax_pallas_prefill
from repro.kernels.prefill_attention.ref import \
    paged_prefill_attention_ref as jax_prefill_ref
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.decode_attention.ops import SPLIT_KEYS
from repro_torch.kernels.decode_attention.ops import body_for as decode_body_for
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      dense_body_for,
                                                      num_splits,
                                                      paged_decode_attention)
from repro_torch.kernels.flash_attention.ops import body_for as flash_body_for
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.prefill_attention.ops import body_for as prefill_body_for
from repro_torch.kernels.prefill_attention.ops import paged_prefill_attention
from repro_torch.models.transformer import quantize_kv

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BS, MB, K, H, D = 16, 4, 2, 4, 64


def _pool(seed, dtype, poison_trash=True):
    rng = np.random.default_rng(seed)
    N = 1 + 2 * MB
    kp = rng.standard_normal((N, BS, K, D)).astype(np.float32)
    vp = rng.standard_normal((N, BS, K, D)).astype(np.float32)
    if poison_trash:            # trash block 0 must never be attended
        kp[0], vp[0] = 1e4, -1e4
    tables = (1 + rng.permutation(2 * MB).reshape(2, MB)).astype(np.int32)
    return rng, kp, vp, tables


def _both(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(t_out, j_out, dtype):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)


DECODE_LENGTHS = [(37, 64), (15, 16), (16, 17), (1, 32), (0, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", DECODE_LENGTHS)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_decode_plain_matches_jax(dtype, lengths, softcap):
    """Block-boundary lengths, a length-0 (fully masked) row, softcap, and
    trash / past-length blocks that hold poison: the plain version equals
    the JAX oracle and the Pallas kernel (interpret mode)."""
    rng, kp, vp, tables = _pool(3, dtype)
    for b, n in enumerate(lengths):          # entries past the live blocks
        tables[b, -(-n // BS):] = 0          # point at trash
    q = rng.standard_normal((2, H, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kp, vp))
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    out = paged_decode_attention(tq, tk, tv, tt, tl, softcap=softcap)
    assert out.shape == (2, H, D) and out.dtype == tq.dtype
    assert torch.isfinite(out.float()).all()
    _close(out, jax_decode_ref(jq, jk, jv, jt, jl, softcap=softcap), dtype)
    _close(out, jax_pallas_decode(jq, jk, jv, jt, jl, softcap=softcap,
                                  interpret=True), dtype)
    if lengths[0] == 0:                      # fully masked row -> 0, not NaN
        assert (out[0] == 0).all()


PREFILL_CASES = [
    # (C, q_start per sequence, table width) — chunk at a block boundary,
    # seeded rows before the chunk, and the mid-block starts 9 and 27
    (8, (21, 48), MB),
    (16, (0, 16), MB),
    (16, (9, 27), MB),
    (4, (9, 27), 2),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,q_start,mb", PREFILL_CASES)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_prefill_plain_matches_jax(dtype, C, q_start, mb, softcap):
    """Causal against absolute positions over a partly seeded table; blocks
    past ``lengths`` point at poisoned trash and are never attended."""
    rng, kp, vp, tables = _pool(5, dtype)
    tables = np.ascontiguousarray(tables[:, :mb])
    qs = np.asarray(q_start, np.int32)
    lens = qs + C
    for b, n in enumerate(lens):
        tables[b, -(-n // BS):] = 0
    q = rng.standard_normal((2, C, H, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kp, vp))
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    args_j = (jt, jnp.asarray(qs), jnp.asarray(lens))
    args_t = (tt, torch.from_numpy(qs), torch.from_numpy(lens))
    out = paged_prefill_attention(tq, tk, tv, *args_t, softcap=softcap)
    assert out.shape == (2, C, H, D) and out.dtype == tq.dtype
    _close(out, jax_prefill_ref(jq, jk, jv, *args_j, softcap=softcap), dtype)
    _close(out, jax_pallas_prefill(jq, jk, jv, *args_j, softcap=softcap,
                                   interpret=True), dtype)


# (S, lengths of 3 sequences, Pallas bkv or None where S is ragged)
DENSE_DECODE_CASES = [
    (64, (1, 37, 64), 16),
    (64, (0, 16, 17), 32),
    (50, (1, 37, 50), None),          # ragged S
    (50, (49, 51, 200), None),        # lengths past S: every row live
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,lengths,bkv", DENSE_DECODE_CASES)
def test_dense_decode_plain_matches_jax(dtype, S, lengths, bkv):
    """K3's plain version: one token against a contiguous cache, masked at
    ``lengths``, equals the JAX oracle and, where S divides into its
    tiles, the Pallas kernel in interpret mode; a length-0 row gives 0."""
    rng = np.random.default_rng(S + lengths[0])
    q = rng.standard_normal((3, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((3, S, K, D)).astype(np.float32)
            for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    lens = np.asarray(lengths, np.int32)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    out = decode_attention(tq, tk, tv, tl, chunk=16)
    assert out.shape == (3, H, D) and out.dtype == tq.dtype
    assert torch.isfinite(out.float()).all()
    _close(out, jax_dense_decode_ref(jq, jk, jv, jl, chunk=16), dtype)
    if bkv:
        _close(out, jax_pallas_dense_decode(jq, jk, jv, jl, bkv=bkv,
                                            interpret=True), dtype)
    if lengths[0] == 0:
        assert (out[0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,bq", [(64, 16), (64, 32), (45, None), (1, None)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax(dtype, S, bq, causal):
    """K4's plain version: dense GQA attention over positions 0..S-1 equals
    the JAX oracle and, where S divides into its tiles, the Pallas kernel
    in interpret mode."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, K, D)).astype(np.float32)
            for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, chunk=16)
    assert out.shape == (2, S, H, D) and out.dtype == tq.dtype
    _close(out, jax_flash_ref(jq, jk, jv, causal=causal, chunk=16), dtype)
    if bq:
        _close(out, jax_pallas_flash(jq, jk, jv, causal=causal, bq=bq,
                                     bkv=bq, interpret=True), dtype)


def test_gqa_head_order():
    """Query head h reads kv head h // G: with every query head equal and
    the two kv heads' values constant and distinct, heads 0..G-1 return kv
    head 0's value and heads G..H-1 kv head 1's."""
    _, kp, vp, tables = _pool(7, "float32", poison_trash=False)
    vp[:, :, 0], vp[:, :, 1] = 1.0, 2.0
    q = np.ones((2, H, D), np.float32)
    lens = np.asarray([20, 40], np.int32)
    out = paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp), torch.from_numpy(tables),
                                 torch.from_numpy(lens))
    G = H // K
    assert torch.allclose(out[:, :G], torch.ones(()))
    assert torch.allclose(out[:, G:], torch.full((), 2.0))
    qc = np.ones((1, 4, H, D), np.float32)
    outp = paged_prefill_attention(
        torch.from_numpy(qc), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables[:1]), torch.tensor([5], dtype=torch.int32),
        torch.tensor([9], dtype=torch.int32))
    assert torch.allclose(outp[..., :G, :], torch.ones(()))
    assert torch.allclose(outp[..., G:, :], torch.full((), 2.0))


def test_cpu_tensors_take_the_counted_plain_version():
    table = dispatch.kernel_table()
    assert set(table) == {"conv2d", "conv2d_backward", "decode_attention",
                          "flash_attention", "flash_attention_backward", "matmul",
                          "paged_decode_attention", "paged_prefill_attention",
                          "ssm_scan", "ssm_scan_backward"}
    dec = table["paged_decode_attention"]
    dispatch.reset_counts()
    _, kp, vp, tables = _pool(1, "float32")
    q = torch.zeros((2, H, D))
    paged_decode_attention(q, torch.from_numpy(kp), torch.from_numpy(vp),
                           torch.from_numpy(tables),
                           torch.tensor([3, 4], dtype=torch.int32))
    assert (dec.launches, dec.plain_calls) == (0, 1)
    with dispatch.plain_versions():
        paged_decode_attention(q, torch.from_numpy(kp), torch.from_numpy(vp),
                               torch.from_numpy(tables),
                               torch.tensor([3, 4], dtype=torch.int32))
    assert (dec.launches, dec.plain_calls) == (0, 2)
    dispatch.reset_counts()
    assert dec.plain_calls == 0


def test_int8_pools_and_cpu_launches_raise():
    """An int8 pool needs both its scales, and scales need an int8 pool
    (the reference's ``quant = k_scale is not None`` cannot tell the cases
    apart, so the port refuses them); CPU tensors at the CUDA launcher
    raise."""
    _, kp, vp, tables = _pool(1, "float32")
    q = torch.zeros((2, H, D))
    lens = torch.tensor([3, 4], dtype=torch.int32)
    k8 = torch.zeros(kp.shape, dtype=torch.int8)
    sc = torch.ones(kp.shape[:3])
    tt = torch.from_numpy(tables)
    with pytest.raises(ValueError, match="int8 pool needs"):
        paged_decode_attention(q, k8, k8, tt, lens)
    with pytest.raises(ValueError, match="int8 pool needs"):
        paged_prefill_attention(q[:, None], k8, k8, tt, lens, lens)
    with pytest.raises(ValueError, match="for an int8 pool"):
        paged_prefill_attention(q[:, None], torch.from_numpy(kp),
                                torch.from_numpy(vp), tt, lens, lens,
                                k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="for an int8 pool"):
        paged_decode_attention(q, torch.from_numpy(kp), torch.from_numpy(vp),
                               tt, lens, k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="come together"):
        paged_decode_attention(q, k8, k8, tt, lens, k_scale=sc)
    dec = dispatch.kernel_table()["paged_decode_attention"]
    with pytest.raises(ValueError, match="on the card"):
        dec.launch(q, torch.from_numpy(kp), torch.from_numpy(vp), tt, lens)
    pre = dispatch.kernel_table()["paged_prefill_attention"]
    with pytest.raises(ValueError, match="on the card"):
        pre.launch(q[:, None], k8, k8, tt, lens, lens, k_scale=sc, v_scale=sc)


def _quant_pool(kp, vp):
    """The same numpy pool quantized by the reference and by the port:
    ((jax k, v, k_scale, v_scale), (torch ...)), bit for bit equal."""
    from repro.models.transformer import quantize_kv as jax_quantize_kv
    jk, jks = jax_quantize_kv(jnp.asarray(kp))
    jv, jvs = jax_quantize_kv(jnp.asarray(vp))
    tk, tks = quantize_kv(torch.from_numpy(kp))
    tv, tvs = quantize_kv(torch.from_numpy(vp))
    for j, t in ((jk, tk), (jks, tks), (jv, tv), (jvs, tvs)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return (jk, jv, jks, jvs), (tk, tv, tks, tvs)


# (lengths of 3 sequences, H, D): block boundaries and a length-0 row at
# the smoke heads (G = 2, D = 64: K1's split route at bf16); qwen2.5-3b's
# heads (G = 8, D = 128, the serving route); G = 16 (K1's FMA route at bf16)
INT8_DECODE_CASES = [((37, 0, 64), 4, 64), ((15, 16, 17), 16, 128),
                     ((1, 33, 64), 32, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths,heads,hd", INT8_DECODE_CASES)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_int8_paged_decode_plain_matches_jax(dtype, lengths, heads, hd,
                                             softcap):
    """K1's plain version on an int8 pool (rows dequantized to q's type
    before both products) equals the JAX oracle and the Pallas kernel's
    quant branch (interpret mode): ragged lengths, a length-0 row, trash
    entries past the live blocks in a poisoned trash block."""
    rng = np.random.default_rng(sum(lengths) + heads)
    B, N = len(lengths), 1 + len(lengths) * MB
    kp = rng.standard_normal((N, BS, K, hd)).astype(np.float32)
    vp = rng.standard_normal((N, BS, K, hd)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4                  # the trash block: never attended
    tables = (1 + rng.permutation(B * MB).reshape(B, MB)).astype(np.int32)
    for b, n in enumerate(lengths):
        tables[b, -(-n // BS):] = 0
    q = rng.standard_normal((B, heads, hd)).astype(np.float32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _quant_pool(kp, vp)
    jq, tq = _both(q, dtype)
    lens = np.asarray(lengths, np.int32)
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    out = paged_decode_attention(tq, tk, tv, tt, tl, k_scale=tks, v_scale=tvs,
                                 softcap=softcap)
    assert out.shape == (B, heads, hd) and out.dtype == tq.dtype
    assert torch.isfinite(out.float()).all()
    _close(out, jax_decode_ref(jq, jk, jv, jt, jl, k_scale=jks, v_scale=jvs,
                               softcap=softcap), dtype)
    _close(out, jax_pallas_decode(jq, jk, jv, jt, jl, k_scale=jks, v_scale=jvs,
                                  softcap=softcap, interpret=True), dtype)
    for b, n in enumerate(lengths):
        if n == 0:                           # fully masked row -> 0, not NaN
            assert (out[b] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,q_start,mb", PREFILL_CASES)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_int8_paged_prefill_plain_matches_jax(dtype, C, q_start, mb, softcap):
    """K2's plain version on an int8 pool equals the JAX oracle and the
    Pallas kernel's quant branch (interpret mode): causal against absolute
    positions over a partly seeded table, trash entries poisoned."""
    rng, kp, vp, tables = _pool(5, dtype)
    tables = np.ascontiguousarray(tables[:, :mb])
    qs = np.asarray(q_start, np.int32)
    lens = qs + C
    for b, n in enumerate(lens):
        tables[b, -(-n // BS):] = 0
    q = rng.standard_normal((2, C, H, D)).astype(np.float32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _quant_pool(kp, vp)
    jq, tq = _both(q, dtype)
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    args_j = (jt, jnp.asarray(qs), jnp.asarray(lens))
    args_t = (tt, torch.from_numpy(qs), torch.from_numpy(lens))
    out = paged_prefill_attention(tq, tk, tv, *args_t, k_scale=tks,
                                  v_scale=tvs, softcap=softcap)
    assert out.shape == (2, C, H, D) and out.dtype == tq.dtype
    _close(out, jax_prefill_ref(jq, jk, jv, *args_j, k_scale=jks,
                                v_scale=jvs, softcap=softcap), dtype)
    _close(out, jax_pallas_prefill(jq, jk, jv, *args_j, k_scale=jks,
                                   v_scale=jvs, softcap=softcap,
                                   interpret=True), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 8, 16])
def test_int8_routes_by_dtype_head_dim_and_group(dtype, D, G):
    """On an int8 pool K1 and K2 take their int8 bodies by their own rules:
    K1 bf16 at D = 64 or 128 with G <= 8 on the split body (``mma_i8``),
    K2 bf16 at D = 64 or 128 on the tensor cores (``mma_i8``), everything
    else -- every fp32 call -- on the FMA bodies (``fma_i8``)."""
    K = 2
    pool = torch.zeros((5, 16, K, D), dtype=torch.int8)
    mma = dtype == torch.bfloat16 and D in (64, 128)
    q = torch.zeros((3, G * K, D), dtype=dtype)
    assert decode_body_for(q, pool) == ("mma_i8" if mma and G <= 8 else "fma_i8")
    qc = torch.zeros((1, 4, G * K, D), dtype=dtype)
    assert prefill_body_for(qc, pool) == ("mma_i8" if mma else "fma_i8")
    assert prefill_body_for(qc, pool.to(dtype)) == prefill_body_for(qc)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    assert build.sources() == ["conv2d", "conv2d_backward", "decode_attention",
                               "flash_attention", "flash_attention_backward",
                               "matmul", "paged_decode_attention",
                               "paged_prefill_attention", "ssm_scan",
                               "ssm_scan_backward"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_build_reuses_a_cached_library_with_its_nvcc_log(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))      # no nvcc: nothing may build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "LOGS", {})
    monkeypatch.setattr(build, "CACHED", set())
    name = "paged_decode_attention"
    so = build._target(name)
    so.parent.mkdir(parents=True)
    so.write_bytes(b"")
    so.with_suffix(".log").write_text("ptxas info    : Used 40 registers")
    assert build.build([name]) == {name: so}
    assert build.LOGS[name] == "ptxas info    : Used 40 registers"
    assert build.CACHED == {name}


def test_launch_operands_must_be_16_byte_aligned():
    flat = torch.zeros(1 + 2 * BS * K * D)
    aligned = flat[:-1].view(2, BS, K, D)
    odd = flat[1:].view(2, BS, K, D)                 # 4 bytes past the start
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 4
    cpu = torch.device("cpu")
    dispatch.check_operand(aligned, "k_pool", device=cpu,
                           dtypes=(torch.float32,), align=16)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        dispatch.check_operand(odd, "k_pool", device=cpu,
                               dtypes=(torch.float32,), align=16)
    dispatch.check_operand(odd, "lengths", device=cpu, dtypes=(torch.float32,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_ratio_holds_rounding_and_rejects_a_lost_block(dtype):
    """The card's kernel-vs-plain limit: one rounding of the exact output to
    the kernel's dtype passes; dropping one 16-row block of a 1056-row
    attention (what a wrong block loop gives) fails by far."""
    g = torch.Generator().manual_seed(0)
    n = 1056
    p = torch.softmax(torch.randn((4, H, n), generator=g), dim=-1)
    v = torch.randn((n, D), generator=g)
    ref = p @ v                                      # (4, H, D) exact
    assert dispatch.tolerance_ratio(ref.to(dtype), ref) <= 0.5
    p_lost = p.clone()
    p_lost[..., 512:528] = 0
    lost = (p_lost / p_lost.sum(-1, keepdim=True)) @ v
    assert dispatch.tolerance_ratio(lost.to(dtype), ref) > 5


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("name", ["conv2d", "decode_attention",
                                  "flash_attention", "matmul",
                                  "paged_decode_attention",
                                  "paged_prefill_attention", "ssm_scan"])
def test_ctypes_argtypes_match_the_c_entry_point(name):
    """Each launcher's ctypes signature has the types, in order, of its
    kernel's ``extern "C"`` entry point (a count off by one shows only as a
    TypeError on the card)."""
    text = (build.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in m.group(1).replace("\n", " ").split(",")]
    ops = importlib.import_module(dispatch.kernel_table()[name].launch.__module__)
    argtypes = ops._DENSE_ARGTYPES if name == "decode_attention" else ops._ARGTYPES
    assert argtypes == [_C_TYPES[p] for p in params]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
def test_flash_route_by_dtype_and_head_dim(dtype, D):
    """K4's body is decided before the launch from q's type and head_dim:
    bf16 at D = 64 (zamba2's shared block) or 128 (qwen2.5-3b) takes the
    tensor cores, everything else -- every fp32 call -- the FMA body."""
    q = torch.zeros((1, 3, 8, D), dtype=dtype)
    want = "mma" if dtype == torch.bfloat16 and D in (64, 128) else "fma"
    assert flash_body_for(q) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
def test_paged_prefill_route_by_dtype_and_head_dim(dtype, D):
    """K2's body is decided before the launch from q's type and head_dim:
    bf16 at D = 64 or 128 takes the tensor cores at any group size,
    everything else -- every fp32 call -- the FMA body."""
    for H in (2, 8, 16):
        q = torch.zeros((1, 4, H, D), dtype=dtype)
        want = "mma" if dtype == torch.bfloat16 and D in (64, 128) else "fma"
        assert prefill_body_for(q) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 8, 16])
def test_paged_decode_route_by_dtype_head_dim_and_group(dtype, D, G):
    """K1's body is decided before the launch from the type, head_dim and
    G = H / K alone: bf16 at D = 64 or 128 with G <= 8 (the n = 8 side of
    the tensor-core product) splits the KV length (``mma``), everything
    else -- every fp32 call -- runs the FMA body."""
    K = 2
    q = torch.zeros((3, G * K, D), dtype=dtype)
    pool = torch.zeros((5, 16, K, D), dtype=dtype)
    want = ("mma" if dtype == torch.bfloat16 and D in (64, 128) and G <= 8
            else "fma")
    assert decode_body_for(q, pool) == want


@pytest.mark.parametrize("mb,bs,want", [(66, 16, 17), (1, 16, 1), (4, 16, 1),
                                        (5, 16, 2), (1025, 16, 257), (3, 32, 2),
                                        (1, 128, 2)])
def test_split_count_comes_from_the_table_width(mb, bs, want):
    """K1's split body runs cdiv(max_blocks * block_size, 64) blocks per
    (sequence, kv head): serving's 66-block tables give 17 splits, so 4
    sequences and 2 kv heads fill 136 blocks."""
    assert SPLIT_KEYS == 64
    assert num_splits(mb, bs) == want


def _split_merge(q, kp, vp, tables, lengths, softcap, split=SPLIT_KEYS):
    """K1's split body in fp32 plain PyTorch: per (sequence, kv head) each
    run of ``split`` keys of the table gives (m, l, acc) -- the max of its
    live scores, l = sum p and acc = p V with p = exp(s - max(m,
    NEG_INF / 2)); a split past the length gives (NEG_INF, 0, 0) -- and
    the merge takes M = max m, w = exp(min(m - M, 0)), out = sum w acc /
    max(sum w l, 1e-30)."""
    neg_inf = -1e30
    B, H, D = q.shape
    _, bs, K, _ = kp.shape
    G = H // K
    mb = tables.shape[1]
    n_split = num_splits(mb, bs)
    out = torch.zeros((B, H, D))
    for b in range(B):
        n = min(int(lengths[b]), mb * bs)
        keys = torch.arange(n_split * split)
        blk = tables[b, (keys // bs).clamp(max=mb - 1)].long()
        k_rows = kp[blk, keys % bs].float()                   # (S', K, D)
        v_rows = vp[blk, keys % bs].float()
        for kv in range(K):
            qg = q[b, kv * G:(kv + 1) * G].float()            # (G, D)
            parts = []
            for i in range(n_split):
                lo = i * split
                if lo >= n:
                    parts.append((torch.full((G,), neg_inf), torch.zeros(G),
                                  torch.zeros((G, D))))
                    continue
                live = slice(lo, min(lo + split, n))
                s = qg @ k_rows[live, kv].T / D ** 0.5
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                m = s.amax(-1)
                p = torch.exp(s - m.clamp(min=neg_inf / 2)[:, None])
                parts.append((m, p.sum(-1), p @ v_rows[live, kv]))
            big_m = torch.stack([m for m, _, _ in parts]).amax(0)
            num, den = torch.zeros((G, D)), torch.zeros(G)
            for m, l, acc in parts:
                w = torch.exp((m - big_m).clamp(max=0.0))
                num += w[:, None] * acc
                den += w * l
            out[b, kv * G:(kv + 1) * G] = num / den.clamp(min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_split_and_merge_arithmetic_matches_the_pallas_kernel(softcap):
    """K1's split body's arithmetic, emulated in fp32, equals the Pallas
    kernel (interpret mode) at lengths 0, 1, 16, 17, 64, 65 and a full
    table of 10 blocks of 16 (3 splits, the last of 32 keys); trash and
    past-length entries hold poison that no split may attend."""
    mb = 10
    rng = np.random.default_rng(11)
    lengths = [0, 1, 16, 17, 64, 65, mb * BS]
    B = len(lengths)
    N = 1 + B * mb
    kp = rng.standard_normal((N, BS, K, D)).astype(np.float32)
    vp = rng.standard_normal((N, BS, K, D)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    tables = (1 + rng.permutation(B * mb).reshape(B, mb)).astype(np.int32)
    for b, n in enumerate(lengths):
        tables[b, -(-n // BS):] = 0          # past the live blocks: trash
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    assert num_splits(mb, BS) == 3
    out = _split_merge(torch.from_numpy(q), torch.from_numpy(kp),
                       torch.from_numpy(vp), torch.from_numpy(tables),
                       torch.from_numpy(lens), softcap)
    ref = jax_pallas_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(tables), jnp.asarray(lens),
                            softcap=softcap, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL["float32"],
                               rtol=0)
    assert (out[0] == 0).all()                   # length 0 -> 0, not NaN


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 8, 16])
def test_dense_decode_route_by_dtype_head_dim_and_group(dtype, D, G):
    """K3's body is decided before the launch from the type, head_dim and
    G = H / K alone, by K1's rule: bf16 at D = 64 (zamba2, G = 1) or 128
    (qwen2.5-3b, G = 8) with G <= 8 takes the split body, everything else
    -- every fp32 call -- the FMA body."""
    K = 4
    q = torch.zeros((3, G * K, D), dtype=dtype)
    cache = torch.zeros((3, 100, K, D), dtype=dtype)
    want = ("mma" if dtype == torch.bfloat16 and D in (64, 128) and G <= 8
            else "fma")
    assert dense_body_for(q, cache) == want


@pytest.mark.parametrize("S,lengths", [(80, (0, 17, 80, 200)), (64, (1, 63, 64, 65)),
                                       (208, (0, 130, 207, 1000))])
def test_dense_split_and_merge_matches_the_pallas_kernel(S, lengths):
    """K3's split body is K1's on the cache read as a pool of 16-row blocks
    through a trivial table: cdiv(S, 64) splits from the cache length
    (S = 80 and 208: the last split ragged), lengths past S attending all
    S rows, a length-0 row giving 0.  Emulated in fp32, it equals the dense
    Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(S)
    B = len(lengths)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32) for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    tables = np.arange(B * S // BS, dtype=np.int32).reshape(B, S // BS)
    assert num_splits(S // BS, BS) == -(-S // SPLIT_KEYS)
    out = _split_merge(torch.from_numpy(q), torch.from_numpy(k).reshape(-1, BS, K, D),
                       torch.from_numpy(v).reshape(-1, BS, K, D), torch.from_numpy(tables),
                       torch.from_numpy(lens), 0.0)
    ref = jax_pallas_dense_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(lens), bkv=16, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL["float32"], rtol=0)
    for b, n in enumerate(lengths):
        if n == 0:
            assert (out[b] == 0).all()
