"""The port's transformer against the JAX reference on the same weights
(handed over through ``repro_torch.interop``): chunked paged prefill of
two prompts -- the second seeded from the first one's prefix blocks --
then batched decode steps, comparing logits *and* pool contents.

Tolerances: fp32 compute with an fp32 pool, rtol 1e-4 (same arithmetic,
other summation order).  fp32 compute with an int8 pool: logits the same
(rtol 1e-4, atol 1e-4), the int8 pools equal or one quantization step
apart where a K/V element sat on a rounding edge (the count is asserted
against and reported), the scales to rtol 1e-5 (absmax of K/V rows that
differ in their last bits).  ``quantize_kv`` / ``dequantize_kv`` are
held bit for bit.  bf16 compute with a bf16 pool: within 5e-2 of
the largest magnitude (logits, pool rows).  Relative, because one bf16
ulp at the logits' magnitude (~10) is 0.0625: XLA's fused elementwise ops
(e.g. silu) round at other points than PyTorch's, and each one-ulp flip
in a hidden state moves the logits by about that much.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import transformer as JT
from repro.models.registry import fns_for as jax_fns
from repro_torch.configs import registry as TR
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.models.registry import fns_for

torch.set_num_threads(1)

BS, MB = 8, 6


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32))


def _run(mod, cfg, params, tensor, steps, cache_dtype=None):
    """Drive ``mod`` (the JAX or the torch transformer) through the same
    chunk / decode schedule; ``tensor`` makes its int arrays.  The pool is
    in the compute dtype unless ``cache_dtype`` names another."""
    cache = mod.make_paged_cache(cfg, 1 + 10, BS, 2, MB,
                                 cache_dtype or cfg.compute_dtype, **(
                                     {"device": "cpu"} if mod is T else {}))
    logits = []
    for tokens, wids, table, q_start, kv_len, last in steps["prefill"]:
        lg, cache = mod.prefill_paged(
            cfg, params, tensor(tokens), cache, tensor(wids), tensor(table),
            q_start=tensor(q_start), kv_len=tensor(kv_len), last_idx=last)
        logits.append(lg)
    cache = cache._replace(block_tables=tensor(steps["tables"]),
                           length=tensor(steps["lengths"]))
    for tok in steps["decode"]:
        lg, cache = mod.decode_step(cfg, params, tensor(tok), cache)
        logits.append(lg)
    return logits, cache


def _schedule(vocab):
    """Prompt A (20 tokens, blocks 1-3) in chunks of 8 and 12 (padded to
    16); prompt B shares A's first two blocks and is seeded past them
    (q_start 16, block 4); then 3 batched decode steps."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, vocab, 20).astype(np.int32)
    b = np.concatenate([a[:16], rng.integers(0, vocab, 7).astype(np.int32)])
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    tbl_a = i32([[1, 2, 3, 0, 0, 0]])
    tbl_b = i32([[1, 2, 4, 0, 0, 0]])
    pad = lambda t, n: np.pad(t, (0, n - len(t)))[None]  # noqa: E731
    prefill = [
        (a[None, :8], i32([1]), tbl_a, i32([0]), i32([8]), 7),
        (pad(a[8:20], 16), i32([2, 3]), tbl_a, i32([8]), i32([20]), 11),
        (pad(b[16:], 8), i32([4]), tbl_b, i32([16]), i32([23]), 6),
    ]
    return {"prefill": prefill,
            "tables": np.concatenate([tbl_a, tbl_b]).astype(np.int32),
            "lengths": i32([20, 23]),
            "decode": [rng.integers(0, vocab, (2, 1)).astype(np.int32)
                       for _ in range(3)]}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(compute_dtype):
    jcfg = JR.smoke("qwen2.5-3b").replace(compute_dtype=compute_dtype)
    tcfg = TR.smoke("qwen2.5-3b").replace(compute_dtype=compute_dtype)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = T.prepare_params(tcfg, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp)))
    steps = _schedule(jcfg.vocab_size)
    jl, jc = _run(JT, jcfg, jp, jnp.asarray, steps)
    dispatch.reset_counts()
    tl, tc = _run(T, tcfg, tp, torch.from_numpy, steps)
    counts = {n: k.plain_calls for n, k in dispatch.kernel_table().items()}
    assert counts == {"paged_prefill_attention": 3 * tcfg.num_layers,
                      "paged_decode_attention": 3 * tcfg.num_layers,
                      "conv2d": 0, "conv2d_backward": 0, "decode_attention": 0,
                      "flash_attention": 0, "ssm_scan": 0,
                      "flash_attention_backward": 0, "ssm_scan_backward": 0,
                      # 7 products a layer and the LM head, per call
                      "matmul": 6 * (7 * tcfg.num_layers + 1)}

    def close(t, j):
        if compute_dtype == "float32":
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(t - j).max() <= 5e-2 * np.abs(j).max()
    for t, j in zip(tl, jl):
        close(_f32(t), _f32(j))
    # pools: every block but the trash block (padding rows race there)
    for name in ("k", "v"):
        close(_f32(getattr(tc, name))[:, 1:], _f32(getattr(jc, name))[:, 1:])
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_param_layout_matches_reference_leaf_for_leaf():
    """Names, shapes and dtypes of ``init`` equal the reference's, including
    the stacked (L, ...) block layout."""
    jcfg, tcfg = JR.smoke("qwen2.5-3b"), TR.smoke("qwen2.5-3b")
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = fns_for(tcfg).init(tcfg, torch.Generator().manual_seed(0))
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", v
    tflat = dict(flat(tp))
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jflat[k].dtype), k
    # truncated-normal init at the reference's scale (fan-in = axis -2)
    wq = tflat["['blocks']['attn']['wq']"]
    std = 1 / np.sqrt(tcfg.num_heads)
    assert wq.abs().max() <= 2 * std + 1e-6
    assert abs(wq.std().item() / std - 0.88) < 0.1   # std of N(0,1) cut at 2


def test_bf16_crosses_by_bitcast():
    x = jnp.asarray(np.linspace(-3, 3, 11), jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(x)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_int8_cache_and_verify_layout_raise():
    """An int8 pool reaching the decode or prefill attention without its
    scales raises (the cache's layers must hand them over).  The verify
    write layout (``write_ids=None``) is ported: ``test_torch_spec.py``
    holds it against the reference."""
    cfg = TR.smoke("qwen2.5-3b")
    q8 = T.make_paged_cache(cfg, 4, BS, 1, 2, "int8", device="cpu")
    x = torch.zeros((1, BS, cfg.num_heads, cfg.resolved_head_dim))
    kv = torch.ones((1, BS, cfg.num_kv_heads, cfg.resolved_head_dim))
    with pytest.raises(ValueError, match="int8 pool needs"):
        T._paged_attend(cfg, x[:, :1], kv[:, :1], kv[:, :1], q8.k[0],
                        q8.v[0], None, q8.block_tables, q8.length, 1024)
    with pytest.raises(ValueError, match="int8 pool needs"):
        T._paged_prefill_attend(cfg, x, kv, kv, q8.k[0], q8.v[0], None,
                                torch.tensor([1]), q8.block_tables,
                                q8.length, q8.length + BS, 1024)
    assert not q8.k.any()                    # refused before any write


def _int8_inputs():
    """fp32 rows with exact .5 ties of x / scale (scale 1: amax 127), an
    all-zero row (scale 1e-6 / 127), rows at +-amax, random rows."""
    rng = np.random.default_rng(4)
    x = (3 * rng.standard_normal((5, 3, 64))).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1, 0], x[0, 1, 1:] = 127.0, np.arange(63) % 9 - 4.5
    x[0, 2, 0], x[0, 2, 1] = -12.7, 12.7
    x[1, 0] = np.where(np.arange(64) % 2, 5.0, -5.0)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantize_kv_matches_reference_bit_for_bit(dtype):
    """``quantize_kv`` gives the reference's int8 values and fp32 scales bit
    for bit on the same input (round half to even, the 1e-6 floor, the
    clip), and ``dequantize_kv`` its values."""
    x = jnp.asarray(_int8_inputs()).astype(dtype)
    jq, js = JT.quantize_kv(x)
    tq, ts = T.quantize_kv(tensor_from_numpy(np.asarray(x)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert tq[0, 0].abs().max() == 0 and ts[0, 0] == np.float32(1e-6) / 127
    np.testing.assert_array_equal(tq[0, 1, :10].numpy(),
                                  [127, -4, -4, -2, -2, 0, 0, 2, 2, 4])
    for out in (jnp.float32, jnp.bfloat16):
        jd = JT.dequantize_kv(jq, js, out)
        td = T.dequantize_kv(tq, ts, torch.float32 if out == jnp.float32
                             else torch.bfloat16)
        np.testing.assert_array_equal(_f32(td), _f32(jd))


def test_int8_prefill_then_decode_matches_jax():
    """The int8 pool through the same chunked prefill (a seeded prefix) and
    decode schedule as above, fp32 compute: logits, the quantized pools and
    their scales against the reference's ``QuantPagedKVCache``."""
    jcfg = JR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    tcfg = TR.smoke("qwen2.5-3b").replace(compute_dtype="float32")
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = T.prepare_params(tcfg, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp)))
    steps = _schedule(jcfg.vocab_size)
    jl, jc = _run(JT, jcfg, jp, jnp.asarray, steps, "int8")
    dispatch.reset_counts()
    tl, tc = _run(T, tcfg, tp, torch.from_numpy, steps, "int8")
    assert isinstance(tc, T.QuantPagedKVCache) and tc.k.dtype == torch.int8
    table = dispatch.kernel_table()
    assert table["paged_prefill_attention"].plain_calls == 3 * tcfg.num_layers
    assert table["paged_decode_attention"].plain_calls == 3 * tcfg.num_layers
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(_f32(t), _f32(j), rtol=1e-4, atol=1e-4)
    # every block but the trash block (padding rows race there)
    for name in ("k", "v"):
        t = getattr(tc, name)[:, 1:].numpy().astype(np.int32)
        j = np.asarray(getattr(jc, name))[:, 1:].astype(np.int32)
        steps_apart = np.abs(t - j)
        print(f"int8 {name} pool: {int((steps_apart > 0).sum())} of "
              f"{t.size} values one step apart")
        assert steps_apart.max() <= 1 and (steps_apart > 0).mean() < 1e-3
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tc, name)[:, 1:].numpy(),
                                   np.asarray(getattr(jc, name))[:, 1:],
                                   rtol=1e-5, atol=0)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
