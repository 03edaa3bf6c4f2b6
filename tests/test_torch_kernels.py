"""The port's kernel wrappers on the CPU: each kernel's plain PyTorch version
against the JAX oracle (``ref.py``) and against the Pallas TPU kernel run
in interpret mode, on the same numpy inputs; plus the dispatch rules
(CPU tensors take the plain version and are counted; int8 pools and
non-CUDA tensors at the CUDA launcher raise; a missing nvcc raises).

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
    paged_decode_attention as jax_pallas_decode
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref as jax_decode_ref
from repro.kernels.prefill_attention.kernel import \
    paged_prefill_attention as jax_pallas_prefill
from repro.kernels.prefill_attention.ref import \
    paged_prefill_attention_ref as jax_prefill_ref
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.prefill_attention.ops import paged_prefill_attention

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
    assert set(table) == {"conv2d", "paged_decode_attention",
                          "paged_prefill_attention"}
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
    _, kp, vp, tables = _pool(1, "float32")
    q = torch.zeros((2, H, D))
    lens = torch.tensor([3, 4], dtype=torch.int32)
    k8 = torch.zeros(kp.shape, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="int8"):
        paged_decode_attention(q, k8, k8, torch.from_numpy(tables), lens)
    with pytest.raises(NotImplementedError, match="int8"):
        paged_prefill_attention(q[:, None], torch.from_numpy(kp),
                                torch.from_numpy(vp), torch.from_numpy(tables),
                                lens, lens, k_scale=torch.ones(kp.shape[:3]))
    dec = dispatch.kernel_table()["paged_decode_attention"]
    with pytest.raises(ValueError, match="on the card"):
        dec.launch(q, torch.from_numpy(kp), torch.from_numpy(vp),
                   torch.from_numpy(tables), lens)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    assert build.sources() == ["conv2d", "paged_decode_attention",
                               "paged_prefill_attention"]
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


@pytest.mark.parametrize("name", ["conv2d", "paged_decode_attention",
                                  "paged_prefill_attention"])
def test_ctypes_argtypes_match_the_c_entry_point(name):
    """Each launcher's ctypes signature has the types, in order, of its
    kernel's ``extern "C"`` entry point (a count off by one shows only as a
    TypeError on the card)."""
    text = (build.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in m.group(1).replace("\n", " ").split(",")]
    ops = importlib.import_module(dispatch.kernel_table()[name].launch.__module__)
    assert ops._ARGTYPES == [_C_TYPES[p] for p in params]
