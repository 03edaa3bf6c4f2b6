"""The port's GoogLeNet against the JAX package's on the CPU, at
``googlenet-smoke`` (the full graph: 57 convolutions, 9 inception modules,
1000 classes; 64x64 inputs), batch 2: JAX's weights cross through
``interop.params_from_numpy``, the images are the same numpy arrays.

Tolerances, as the largest logit difference over the largest |logit|:
fp32 1e-4 (the same products summed in other orders; measured ~1e-6);
fp16 4e-3 and bf16 3e-2.  At fp16 / bf16 the round points differ: the
port's conv (like the Pallas kernel) adds the bias in fp32 and rounds once,
the reference's XLA model path rounds the conv to the type and adds the
bias in the type, so each of the 57 convs may differ by about one ulp per
element (measured at this size: 6.9e-4 at fp16, 5.4e-3 at bf16, against
the reference's forward under ``jax.jit``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import googlenet as jgoogle
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import googlenet as tgoogle
from repro_torch.models.layers import conv as tconv
from repro_torch.models.registry import fns_for

torch.set_num_threads(1)

TOL_REL = {"float32": 1e-4, "float16": 4e-3, "bfloat16": 3e-2}
_JAX_LOGITS = {}


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = JR.smoke("googlenet"), TR.smoke("googlenet")
    jparams = jax.jit(lambda key: jgoogle.init(cfg, key))(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    images = SyntheticImages(batch=2, size=64, seed=3).sample(2)["images"]
    return cfg, tcfg, jparams, tparams, images


def _jax_logits(setup, dtype):
    cfg, _, jparams, _, images = setup
    if dtype not in _JAX_LOGITS:
        fwd = jax.jit(jgoogle.forward, static_argnums=0)
        _JAX_LOGITS[dtype] = np.asarray(fwd(cfg.replace(compute_dtype=dtype),
                                            jparams, jnp.asarray(images)))
    return _JAX_LOGITS[dtype]


def _leaves(tree, prefix=""):
    """{"a/b/w": leaf} of a nested dict (params or ParamDef tables)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _leaves(tree).items()}


def test_param_table_and_init_match_jax(setup):
    cfg, tcfg, jparams, _, _ = setup
    table = _shapes(tgoogle.model_table(tcfg))
    assert table == _shapes(jgoogle.model_table(cfg))
    assert len([k for k in table if k.endswith("/w")]) == 57
    tparams = tgoogle.init(tcfg, torch.Generator().manual_seed(0))
    assert _shapes(tparams) == _shapes(jparams)
    assert all(t.dtype == torch.float32 for t in _leaves(tparams).values())
    w = tparams["inc4a"]["b2"]["w"]                     # He init, fan-in 3*3*96
    assert abs(w.std().item() / (2.0 / (3 * 3 * 96)) ** 0.5 - 0.88) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_forward_matches_jax(setup, dtype):
    _, tcfg, _, tparams, images = setup
    ref = _jax_logits(setup, dtype)
    out = tgoogle.forward(tcfg.replace(compute_dtype=dtype), tparams,
                          torch.from_numpy(images))
    assert out.shape == (2, 1000) and out.dtype == torch.float32
    out = out.numpy()
    assert np.isfinite(out).all()
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    assert rel <= TOL_REL[dtype], rel
    if dtype != "bfloat16":
        assert (out.argmax(-1) == ref.argmax(-1)).all()


def test_predict_matches_jax(setup):
    cfg, tcfg, jparams, tparams, images = setup
    jl, jc, jp = (np.asarray(a) for a in jax.jit(jgoogle.predict, static_argnums=0)(
        cfg, jparams, jnp.asarray(images)))
    tl, tc, tp = tgoogle.predict(tcfg, tparams, torch.from_numpy(images))
    assert (tl.numpy() == jl).all()
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-4, atol=1e-9)


def test_every_conv_goes_through_the_kernel_wrapper(setup, monkeypatch):
    """One forward makes 57 calls to the conv2d kernel's wrapper, at the
    shapes ``conv_shapes`` lists (CPU tensors: its counted plain version)."""
    _, tcfg, _, tparams, images = setup
    seen = []
    op = tconv.conv2d_op

    def record(x, w, b, *, stride=1):
        seen.append((tuple(x.shape), tuple(w.shape), stride))
        return op(x, w, b, stride=stride)
    monkeypatch.setattr(tconv, "conv2d_op", record)
    dispatch.reset_counts()
    tgoogle.forward(tcfg, tparams, torch.from_numpy(images))
    k = dispatch.kernel_table()["conv2d"]
    assert (k.launches, k.plain_calls) == (0, 57)
    assert seen == [(x, w, s) for _, x, w, s in tgoogle.conv_shapes(2, 64)]
    names = [n for n, *_ in tgoogle.conv_shapes(8, 224)]
    assert len(names) == 57 and names[0] == "stem1" and names[-1] == "5b.b4"
    assert tgoogle.conv_shapes(8, 224)[-1][1] == (8, 7, 7, 832)


def test_fns_for_returns_the_cnn_entry(setup):
    _, tcfg, _, tparams, images = setup
    fns = fns_for(tcfg)
    assert fns.family == "cnn"
    logits, aux = fns.forward(tcfg, tparams, {"images": torch.from_numpy(images)})
    assert logits.shape == (2, 1000) and float(aux) == 0.0
    assert fns_for(TR.config("qwen2.5-3b")).family == "dense"
    assert fns_for(TR.config("zamba2-1.2b")).family == "hybrid"
    assert fns_for(TR.config("xlstm-125m")).family == "ssm"
    assert fns_for(TR.config("deepseek-moe-16b")) is fns_for(TR.config("qwen2.5-3b"))
    assert fns_for(TR.config("qwen2-vl-72b")) is fns_for(TR.config("qwen2.5-3b"))
    assert fns_for(TR.config("whisper-medium")).family == "audio"
    with pytest.raises(ValueError, match="not ported"):
        fns_for(TR.config("qwen2.5-3b").replace(family="diffusion"))
