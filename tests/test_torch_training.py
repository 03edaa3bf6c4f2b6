"""The port's training stack on the CPU against the JAX reference, on the
qwen2.5-3b smoke config at fp32 compute, with the same weights (handed
over through ``repro_torch.interop``) and the same numpy data: the
training forward, the losses, the optimizers and schedules, one train step
(loss and every gradient leaf, with 1 and 2 microbatches), the data
source's bytes and a checkpoint written by the reference; then mirrors of
``tests/test_training.py`` on the port's Trainer, and the port's own
hazards (an async save racing in-place updates, the prefetch thread).

Tolerances.  Logits: within 1e-4 of the largest magnitude (the same fp32
arithmetic summed in other orders; 2e-6 is read).  Gradients: each leaf
within 5e-4 of its own largest entry, and the global norm within rtol
5e-4: the random smoke model's attention is near one-hot, which amplifies
rounding in the backward -- the reference's own fp32 gradients sit up to
1.7e-4 of a leaf's largest entry from the port's evaluated in float64
(the port's fp32 ones 3e-5 from it).  Losses, norms and
optimizer updates on the same arrays: rtol 1e-6 (elementwise fp32 with
the reference's order of operations; transcendental functions may differ
by an ulp).  After a train step the parameters are compared only where
|g| > 1e-3 of the leaf's largest: AdamW's first step moves every entry by
about lr * sign(g), so where a gradient entry is near zero, order noise in
the gradient flips the step's sign.
"""
import dataclasses
import os
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import registry as JR
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.models import transformer as JT
from repro.models.registry import fns_for as jax_fns
from repro.optim import optimizers as JO
from repro.training import losses as JL
from repro.training.train_step import _split_microbatches as jax_split_microbatches
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens
from repro_torch.distributed.fault import FaultSchedule, SimulatedFault, with_retries
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.launch import train as train_launcher
from repro_torch.models import transformer as T
from repro_torch.models.registry import fns_for
from repro_torch.optim import optimizers as TO
from repro_torch.training import losses as TL
from repro_torch.training.train_step import _split_microbatches, make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

REL = 1e-4          # logits, of the largest
GRAD_REL = 5e-4     # each gradient leaf, of its largest


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_rel(t, j, rel=REL):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= rel * max(np.abs(j).max(), 1e-30)


# the dense family's smoke configs: GQA with QKV bias (qwen2.5-3b), qk_norm
# (qwen3-32b), llama3-405b, the parallel block with LayerNorm and tied
# embeddings (command-r-plus-104b); and the vlm family's, the same
# transformer under M-RoPE with three position streams (qwen2-vl-72b)
DENSE = ["qwen2.5-3b", "qwen3-32b", "llama3-405b", "command-r-plus-104b", "qwen2-vl-72b"]


def _cfgs(arch="qwen2.5-3b"):
    """The smoke config at fp32 compute and fp32 params (llama3-405b's
    configured bf16 params have their own test)."""
    jcfg = JR.smoke(arch).replace(compute_dtype="float32", param_dtype="float32")
    tcfg = TR.smoke(arch).replace(compute_dtype="float32", param_dtype="float32")
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jax_fns(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts and lists (an MoE config's
    ``dense_blocks`` is a list of blocks)."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# the model, the losses, the optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_forward_logits_match_jax(remat):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jaux = JT.forward(jcfg, jp, jnp.asarray(tokens), remat=remat)
    dispatch.reset_counts()
    tl, taux = T.forward(tcfg, tp, torch.from_numpy(tokens), remat=remat)
    assert tl.shape == (2, 24, jcfg.vocab_size) and tl.dtype == torch.float32
    _close_rel(tl, jl)
    assert float(taux) == float(jaux) == 0.0
    # 7 products per layer and the LM head, each one K7 call
    assert dispatch.kernel_table()["matmul"].plain_calls == 7 * tcfg.num_layers + 1


def test_remat_policies():
    """``full`` recomputes each block exactly (same loss and gradients as
    ``none``, bit for bit); ``dots`` too, with the block's weight products
    kept: K7 runs as often as under ``none``, K4 again in the recompute; a
    policy the reference does not know (its config's "offloadable-dots")
    runs as ``full``."""
    _, tcfg = _cfgs()
    _, tp = _params(JR.smoke("qwen2.5-3b"))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    grads = {}
    for policy in ("full", "dots", "offloadable-dots", "none"):
        cfg = tcfg.replace(remat=policy)
        for p in _flat(tp).values():
            p.grad = None
            p.requires_grad_(True)
        dispatch.reset_counts()
        loss = T.forward(cfg, tp, tokens)[0].square().mean()
        loss.backward()
        table = dispatch.kernel_table()
        calls = table["matmul"].plain_calls
        attn = (table["flash_attention"].plain_calls,
                table["flash_attention_backward"].plain_calls)
        grads[policy] = (loss.item(), {k: p.grad.clone() for k, p in _flat(tp).items()})
        L = cfg.num_layers
        full = policy in ("full", "offloadable-dots")
        want = 7 * L * 2 + 1 + 2 * (7 * L + 1) if full else 3 * (7 * L + 1)
        assert calls == want
        # K4 once a layer, again in any recompute; its backward once
        assert attn == ((L if policy == "none" else 2 * L), L)
    for p in _flat(tp).values():
        p.requires_grad_(False)
        p.grad = None
    for policy in ("full", "dots", "offloadable-dots"):
        assert grads[policy][0] == grads["none"][0]
        for k, g in grads[policy][1].items():
            torch.testing.assert_close(g, grads["none"][1][k], rtol=0, atol=0)


def test_lm_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = (4 * rng.standard_normal((2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[0, :3] = logits[0, :3].argmax(-1)           # some right answers
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    for m in (None, mask):
        jl, jm = JL.lm_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        tl, tm = TL.lm_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                     None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
        for k in ("nll", "accuracy"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6)


def test_classification_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((6, 10))).astype(np.float32)
    labels = rng.integers(0, 10, (6,)).astype(np.int32)
    labels[:2] = logits[:2].argmax(-1)
    jl, jm = JL.classification_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tl, tm = TL.classification_cross_entropy(torch.from_numpy(logits),
                                             torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tm["accuracy"].item(), float(jm["accuracy"]), rtol=1e-6)


def _opt_tree(rng):
    """A parameter tree with 1-D, 2-D and stacked 3-D leaves, and a gradient
    tree (one leaf large enough to be clipped)."""
    shapes = {"a": (7,), "b": {"w": (5, 6), "s": (3, 4, 2)}, "c": (1, 9)}

    def make(scale):
        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            return (scale * rng.standard_normal(t)).astype(np.float32)
        return walk(shapes)
    return make(1.0), make(0.3)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(name):
    rng = np.random.default_rng(5)
    params, grads_seq = _opt_tree(rng)[0], [_opt_tree(rng)[1] for _ in range(3)]
    grads_seq[1]["a"] *= 40.0                       # global norm above 1: clipped
    jopt = getattr(JO, name)(JO.warmup_cosine(1e-2, 2, 10))
    topt = getattr(TO, name)(TO.warmup_cosine(1e-2, 2, 10))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads_seq:
        jp, js, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp2, ts, tm = topt.update(params_from_numpy(g), ts, tp)
        assert tp2 is tp                             # updated in place
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        jflat, tflat = _flat(jp), _flat(tp)
        for k in jflat:
            np.testing.assert_allclose(_np(tflat[k]), _np(jflat[k]), rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 3
    jstate = jax.tree_util.tree_leaves(js)
    tstate = [ts["step"]] + [x for k in ("mu", "nu", "v") if k in ts
                             for x in TO.leaves(ts[k])]
    assert len(jstate) == len(tstate)


def test_schedules_and_clipping_match_jax():
    for args in ((3e-3, 20, 100), (1e-2, 0, 10), (5e-4, 200, 10_000)):
        j, t = JO.warmup_cosine(*args), TO.warmup_cosine(*args)
        for step in (0, 1, 7, 19, 20, 21, 55, 99, 100, 250, 10_001):
            np.testing.assert_allclose(float(t(torch.tensor(step, dtype=torch.int32))),
                                       float(j(jnp.asarray(step, jnp.int32))), rtol=1e-6)
    assert float(TO.constant(0.25)(torch.tensor(3))) == float(JO.constant(0.25)(jnp.asarray(3)))
    rng = np.random.default_rng(6)
    for scale in (0.01, 10.0):                       # below and above max_norm
        g = _opt_tree(rng)[1]
        g["a"] *= scale
        jg, jn = JO.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), 1.0)
        tg, tn = TO.clip_by_global_norm(params_from_numpy(g), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k, v in _flat(jg).items():
            np.testing.assert_allclose(_np(_flat(tg)[k]), _np(v), rtol=1e-6)


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------

def _k7_calls(cfg, remat):
    """(2-D, batched) K7 calls of one microbatch's forward and backward.
    A dense block makes 7 weight products (q, k, v, o and the SwiGLU's
    three); an MoE block 4 for attention, the router's, the shared experts'
    3 where it has them, and 3 batched expert products.  Every product runs
    again in the recompute under "full"; under "dots" the 2-D ones are
    kept and only the batched ones run again (the reference's policy keeps
    no product with a batch dim).  The LM head once; two products in the
    backward of each."""
    L = cfg.num_layers
    if cfg.moe is None:
        dense, moe_2d, n_moe = L, 0, 0
    else:
        dense, n_moe = cfg.moe.first_k_dense, L - cfg.moe.first_k_dense
        moe_2d = 5 + (3 if cfg.moe.num_shared_experts else 0)
    blocks_2d, batched = 7 * dense + moe_2d * n_moe, 3 * n_moe
    again_2d = blocks_2d if remat == "full" else 0
    again_batched = batched if remat in ("full", "dots") else 0
    return (blocks_2d + again_2d + 1 + 2 * (blocks_2d + 1),
            batched + again_batched + 2 * batched)


def _train_step_vs_jax(accum, remat="full", arch="qwen2.5-3b", **moe_kw):
    """One train step of the port and of the reference at ``remat``: loss,
    metrics (the MoE configs' aux loss among them), every gradient leaf,
    the updated parameters; K7's (2-D and batched) and K4's plain calls
    exact.  ``moe_kw`` overrides fields of an MoE config's ``moe``."""
    jcfg, tcfg = (c.replace(remat=remat) for c in _cfgs(arch))
    if moe_kw:
        jcfg, tcfg = (c.replace(moe=dataclasses.replace(c.moe, **moe_kw))
                      for c in (jcfg, tcfg))
    jp, tp = _params(jcfg)
    batch = next(JaxSyntheticTokens(jcfg, 4, 16, seed=3))
    captured = {}

    def grab(key):
        def hook(g):
            captured[key] = jax.tree_util.tree_map(np.array, g) if key == "jax" \
                else {k: v.clone() for k, v in _flat(g).items()}
            return g
        return hook
    jstep = jax_make_train_step(jcfg, JO.adamw(JO.constant(1e-3)), accum=accum,
                                grad_transform=grab("jax"))
    tstep = make_train_step(tcfg, TO.adamw(TO.constant(1e-3)), accum=accum,
                            grad_transform=grab("torch"))
    jp2, js, jm = jstep(jp, JO.adamw(JO.constant(1e-3)).init(jp),
                        jax.tree_util.tree_map(jnp.asarray, batch))
    dispatch.reset_counts()
    topt = TO.adamw(TO.constant(1e-3))
    tp2, ts, tm = tstep(tp, topt.init(tp), batch)
    L = tcfg.num_layers
    table = dispatch.kernel_table()
    assert (table["matmul"].plain_calls, table["matmul_batched"].plain_calls) == tuple(
        accum * n for n in _k7_calls(tcfg, remat))
    # attention through K4: forward (and any recompute), and its backward,
    # a layer
    assert table["flash_attention"].plain_calls == accum * L * (1 if remat == "none" else 2)
    assert table["flash_attention_backward"].plain_calls == accum * L
    for k in ("loss", "nll", "accuracy", "aux_loss", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_REL)
    jflat = _flat(captured["jax"])
    assert set(jflat) == set(captured["torch"])
    for k, g in jflat.items():
        _close_rel(captured["torch"][k], g, GRAD_REL)
    for k, p in _flat(jp2).items():
        g = np.abs(jflat[k])
        live = g > 1e-3 * g.max()
        np.testing.assert_allclose(_np(_flat(tp2)[k])[live], _np(p)[live],
                                   rtol=1e-5, atol=1e-6)
    assert all(not p.requires_grad and p.grad is None for p in _flat(tp2).values())


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_loss_and_gradients_match_jax(accum, arch):
    _train_step_vs_jax(accum, arch=arch)


# the moe family's smoke configs: DeepSeekMoE's dense first layer and shared
# experts (deepseek-moe-16b), qk_norm and normalized top-k (qwen3-moe)
MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("accum", [1, 2])
def test_moe_train_step_matches_jax(accum, remat, arch):
    """The router's aux loss in the loss, the capacity dispatch and the
    experts' batched products differentiated: loss, nll and aux loss at
    rtol 1e-5, each gradient leaf within ``GRAD_REL`` of its largest,
    the update where |g| is live.  Under "dots" the batched products run
    again in the recompute (the count says so)."""
    _train_step_vs_jax(accum, remat, arch)


def test_moe_train_step_with_dropped_choices_matches_jax():
    """capacity_factor 0.5: two rows per (batch row, expert) for 32
    choices, so choices drop, and a dropped choice adds nothing to the
    output and nothing to the gradients, as the reference's ``keep`` mask."""
    _train_step_vs_jax(1, "full", "deepseek-moe-16b", capacity_factor=0.5)


def test_llama3_405b_configured_step_matches_jax():
    """llama3-405b-smoke's own recipe -- bf16 master parameters (gradients
    kept in bf16, as the reference accumulates them) and Adafactor with
    its factored fp32 statistics -- one step at fp32 compute against the
    reference's.  Loss and metrics at rtol 1e-5 and the global norm at
    ``GRAD_REL``, as for fp32 params.  Each bf16 gradient leaf within 2^-6
    of its largest: both sides sum in fp32 and round to bf16, the port
    once a use of the weight, the reference where its casts put it, so two
    roundings may part them (up to 1.25 x 2^-7 is read).  The updated bf16
    parameters, where |g| is live, within 2^-5 of each entry: four bf16
    steps, for an update computed from gradients one or two roundings
    apart (three steps are read)."""
    jcfg, tcfg = JR.smoke("llama3-405b"), TR.smoke("llama3-405b")
    jcfg, tcfg = (c.replace(compute_dtype="float32") for c in (jcfg, tcfg))
    assert (tcfg.param_dtype, tcfg.optimizer, tcfg.accum_steps) == ("bfloat16", "adafactor", 1)
    jp, tp = _params(jcfg)
    assert all(p.dtype == torch.bfloat16 for p in _flat(tp).values())
    batch = next(JaxSyntheticTokens(jcfg, 4, 16, seed=3))
    captured = {}

    def grab(key):
        def hook(g):
            captured[key] = jax.tree_util.tree_map(np.array, g) if key == "jax" \
                else {k: v.clone() for k, v in _flat(g).items()}
            return g
        return hook
    jopt, topt = JO.adafactor(JO.constant(1e-3)), TO.adafactor(TO.constant(1e-3))
    jp2, _, jm = jax_make_train_step(jcfg, jopt, grad_transform=grab("jax"))(
        jp, jopt.init(jp), jax.tree_util.tree_map(jnp.asarray, batch))
    dispatch.reset_counts()
    tp2, _, tm = make_train_step(tcfg, topt, grad_transform=grab("torch"))(
        tp, topt.init(tp), batch)
    L = tcfg.num_layers
    table = dispatch.kernel_table()
    assert table["matmul"].plain_calls == 7 * L * 2 + 1 + 2 * (7 * L + 1)
    assert table["flash_attention_backward"].plain_calls == L
    for k in ("loss", "nll", "accuracy", "aux_loss", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_REL)
    jflat = _flat(captured["jax"])
    assert set(jflat) == set(captured["torch"])
    for k, g in jflat.items():
        assert captured["torch"][k].dtype == torch.bfloat16 and g.dtype == jnp.bfloat16
        _close_rel(captured["torch"][k], g, 2.0 ** -6)
    for k, p in _flat(jp2).items():
        g = np.abs(_np(jflat[k]))
        live = g > 1e-3 * g.max()
        got = _flat(tp2)[k]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got)[live], _np(p)[live], rtol=2.0 ** -5, atol=0)


def test_dots_train_step_matches_jax():
    """``remat="dots"`` against the reference's
    ``dots_with_no_batch_dims_saveable`` step: the same loss, gradients
    and update, with K7 launched as often as without remat."""
    _train_step_vs_jax(1, "dots")


def test_split_microbatches_matches_jax():
    batch = next(JaxSyntheticTokens(JR.smoke("qwen2.5-3b"), 6, 5, seed=1))
    ref = jax_split_microbatches(batch, 3)
    for v in (batch, {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in batch.items()}):
        out = _split_microbatches(v, 3)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))


def test_synthetic_tokens_byte_identical():
    for cfg_name, batch, seq, seed in (("qwen2.5-3b", 4, 16, 0), ("qwen2.5-3b", 3, 33, 7)):
        ours = SyntheticTokens(TR.smoke(cfg_name), batch, seq, seed=seed)
        ref = JaxSyntheticTokens(JR.smoke(cfg_name), batch, seq, seed=seed)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_written_by_the_reference_restores():
    """The reference's Checkpointer writes the trainer's whole state (fp32
    params, AdamW moments, step) plus a bf16 leaf; the port restores it
    into its own trainer-shaped tree, leaf for leaf."""
    jcfg, tcfg = _cfgs()
    jp, _ = _params(jcfg, seed=1)
    jopt = JO.adamw(JO.constant(1e-3))
    js = jopt.init(jp)
    js = dict(js, mu=jax.tree_util.tree_map(lambda p: p * 0.5, jp))
    tree = {"params": jp, "opt": js, "step": jnp.asarray(7, jnp.int32),
            "half": jnp.arange(5, dtype=jnp.float32).astype(jnp.bfloat16) / 3}
    tp = T.init(tcfg, torch.Generator().manual_seed(5))
    like = {"params": tp, "opt": TO.adamw(TO.constant(1e-3)).init(tp),
            "step": torch.zeros((), dtype=torch.int32),
            "half": torch.zeros(5, dtype=torch.bfloat16)}
    with tempfile.TemporaryDirectory() as d:
        JaxCheckpointer(d, async_save=False).save(7, tree)
        step, got = Checkpointer(d).restore_latest(like)
    assert step == 7 and int(got["step"]) == 7 and got["step"].shape == ()
    assert got["half"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got["half"]), _np(tree["half"]))
    for part in ("params", "opt"):
        jflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(tree[part])[0]}
        tflat = {"".join(f"['{x}']" for x in k): v for k, v in _flat(got[part]).items()}
        assert set(jflat) == set(tflat)
        for k, v in jflat.items():
            assert tflat[k].dtype == (torch.int32 if k == "['step']" else torch.float32)
            np.testing.assert_array_equal(_np(tflat[k]), _np(v))


def test_async_save_snapshots_before_in_place_updates():
    """``save`` returns before the disk write; the optimizer then updates
    the parameters in place.  The checkpoint holds the values at save time."""
    _, tcfg = _cfgs()
    params = T.init(tcfg, torch.Generator().manual_seed(2))
    opt = TO.adamw(TO.constant(1e-2))
    state = opt.init(params)
    saved = {k: v.clone() for k, v in _flat(params).items()}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, async_save=True)
        ck.save(1, {"params": params, "opt": state})
        for _ in range(3):
            opt.update(_grads_like(params), state, params)
        ck.wait()
        got = ck.restore(1, {"params": params, "opt": state})
    moved = 0
    for k, v in _flat(got["params"]).items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
        moved += int(not torch.equal(v, _flat(params)[k]))
    assert moved == len(saved)               # the live tensors did change
    assert int(got["opt"]["step"]) == 0 and int(state["step"]) == 3


def _grads_like(tree):
    if isinstance(tree, dict):
        return {k: _grads_like(v) for k, v in tree.items()}
    return torch.full_like(tree, 0.5)


# ---------------------------------------------------------------------------
# mirrors of tests/test_training.py on the port's Trainer (CPU)
# ---------------------------------------------------------------------------

def _trainer(tmp, steps=10, events=None, ckpt_every=4):
    cfg = TR.smoke("qwen2.5-3b")
    data = SyntheticTokens(cfg, batch=4, seq_len=16)
    tc = TrainerConfig(num_steps=steps, ckpt_every=ckpt_every, ckpt_dir=tmp,
                       async_save=False, device="cpu")
    return Trainer(cfg, iter(data), tc,
                   optimizer=TO.adamw(TO.warmup_cosine(3e-3, 3, steps)),
                   fault_schedule=FaultSchedule(events=events or {}))


def test_loss_decreases():
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, steps=25)
        hist = tr.train()
        losses = [h["loss"] for h in hist if "loss" in h]
        assert losses[-1] < losses[0]


def test_moe_loss_decreases():
    """deepseek-moe-16b-smoke through the Trainer on the CPU: the loss (the
    router's aux loss included) falls over a few steps."""
    with tempfile.TemporaryDirectory() as d:
        cfg = TR.smoke("deepseek-moe-16b")
        tc = TrainerConfig(num_steps=12, ckpt_every=100, ckpt_dir=d,
                           async_save=False, device="cpu")
        tr = Trainer(cfg, iter(SyntheticTokens(cfg, batch=4, seq_len=16)), tc,
                     optimizer=TO.adamw(TO.warmup_cosine(3e-3, 3, 12)))
        hist = [h for h in tr.train() if "loss" in h]
        assert len(hist) == 12 and all(h["aux_loss"] > 0 for h in hist)
        assert hist[-1]["loss"] < hist[0]["loss"]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
                Trainer(cfg, iter(SyntheticTokens(cfg, batch=4, seq_len=16)),
                        TrainerConfig(ckpt_dir=d))


def test_crash_recovery_resumes_from_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, steps=12, events={9: "crash"})
        hist = tr.train()
        events = [h for h in hist if "event" in h]
        assert len(events) == 1 and events[0]["event"] == "crash"
        steps_run = [h["step"] for h in hist if "loss" in h]
        assert steps_run.count(8) == 2      # step 8 re-ran after restore
        assert tr.step == 12


def test_auto_resume_continues():
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, steps=8)
        tr.train()
        tr2 = _trainer(d, steps=12)
        assert tr2.try_resume()
        assert tr2.step == 8
        for k, v in _flat(tr2.params).items():
            torch.testing.assert_close(v, _flat(tr.params)[k], rtol=0, atol=0)
        tr2.train()
        assert tr2.step == 12


def test_checkpoint_roundtrip_and_retention():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2, async_save=False)
        tree = {"a": torch.arange(6.0).reshape(2, 3),
                "b": [torch.zeros(4, dtype=torch.int32), torch.ones(())]}
        for step in (1, 2, 3, 4):
            ck.save(step, tree)
        assert ck.all_steps() == [3, 4]      # retention
        restored = ck.restore(4, tree)
        torch.testing.assert_close(restored["a"], tree["a"], rtol=0, atol=0)
        assert restored["b"][0].dtype == torch.int32
        assert restored["b"][1].shape == () and float(restored["b"][1]) == 1.0
        assert ck.latest_step() == 4


def test_checkpoint_atomicity():
    """A stray .tmp dir must never be visible as a checkpoint."""
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, async_save=False)
        ck.save(1, {"x": torch.ones(3)})
        os.makedirs(os.path.join(d, "step_00000002.tmp0"))
        assert ck.all_steps() == [1]
        assert ck.latest_step() == 1


def test_with_retries_recovers():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise SimulatedFault(0, "crash")
        return "ok"

    assert with_retries(flaky, attempts=3) == "ok"


def test_straggler_fault_is_nonfatal():
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(d, steps=6, events={2: "straggler"})
        hist = tr.train()
        assert len([h for h in hist if "loss" in h]) == 6


# ---------------------------------------------------------------------------
# the port's own: devices, families, the launcher, the prefetch thread
# ---------------------------------------------------------------------------

def test_trainer_refuses_what_is_not_ported(tmp_path):
    cfg = TR.smoke("qwen2.5-3b")
    data = iter(SyntheticTokens(cfg, batch=2, seq_len=8))
    # the vlm and audio families serve and train (whisper's cross-attention
    # through K4's backward at a KV length of its own)
    assert fns_for(TR.smoke("qwen2-vl-72b")).family == "dense"
    assert fns_for(TR.smoke("whisper-medium")).family == "audio"
    # the ssm family serves and trains (K5's backward walks N and P in slices)
    assert fns_for(TR.smoke("xlstm-125m")).family == "ssm"
    tr = Trainer(TR.smoke("xlstm-125m"), data,
                 TrainerConfig(device="cpu", ckpt_dir=str(tmp_path)))
    assert tr.fns.family == "ssm" and tr.device.type == "cpu"
    # the moe family trains (the experts' products through K7's batched entry)
    tr = Trainer(TR.smoke("deepseek-moe-16b"), data,
                 TrainerConfig(device="cpu", ckpt_dir=str(tmp_path)))
    assert tr.cfg.family == "moe" and tr.device.type == "cpu"
    for arch, family in (("qwen2-vl-72b", "vlm"), ("whisper-medium", "audio")):
        tr = Trainer(TR.smoke(arch), data, TrainerConfig(device="cpu", ckpt_dir=str(tmp_path)))
        assert tr.cfg.family == family and tr.device.type == "cpu"
    # a family no model function maps is refused
    with pytest.raises((NotImplementedError, ValueError), match="not ported"):
        Trainer(cfg.replace(family="diffusion"), data,
                TrainerConfig(device="cpu", ckpt_dir=str(tmp_path)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
            Trainer(cfg, data, TrainerConfig(ckpt_dir=str(tmp_path)))


def test_launcher_trains_the_smoke_model_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "8", "--ckpt-dir", str(tmp_path),
            "--metrics-out", str(tmp_path / "m.json")]
    before = {t.ident for t in threading.enumerate()}
    assert train_launcher.main(args) == 0
    out = capsys.readouterr().out
    assert "steps=3" in out and "first_loss=" in out and "tokens/s=" in out
    assert os.path.exists(tmp_path / "m.json")
    assert not [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive() and t.name == "prefetch"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
            train_launcher.main(args[:3] + args[5:])    # --device left at cuda


def test_prefetcher_thread_ends_on_close():
    """The worker is a named daemon thread and ends on ``close()`` while
    blocked on a full queue; an exhausted source ends the iteration."""
    before = {t.ident for t in threading.enumerate()}

    def endless():
        while True:
            yield {"x": np.zeros(2)}
    pf = Prefetcher(endless(), depth=1)
    assert next(pf)["x"].shape == (2,)
    time.sleep(0.2)                          # the worker now waits on a full queue
    spawned = [t for t in threading.enumerate() if t.ident not in before]
    assert spawned and all(t.daemon and t.name == "prefetch" for t in spawned)
    pf.close()
    assert not pf.thread.is_alive()
    assert list(Prefetcher(iter([1, 2, 3]))) == [1, 2, 3]


def test_launcher_accum_default_matches_reference():
    """``--accum`` defaults as in the reference launcher (1 microbatch a
    step), whose parser is built inside its ``main``: the default is read
    from the reference's source."""
    import ast
    import inspect

    import repro.launch.train as jax_train_launcher
    ref = [next(ast.literal_eval(kw.value) for kw in node.keywords if kw.arg == "default")
           for node in ast.walk(ast.parse(inspect.getsource(jax_train_launcher)))
           if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
           and node.args and getattr(node.args[0], "value", None) == "--accum"]
    assert ref == [1]
    assert train_launcher.parse(["--arch", "qwen2.5-3b"]).accum == ref[0]
    assert train_launcher.parse(["--arch", "qwen2.5-3b", "--accum", "8"]).accum == 8
