"""What the sharded-training tests hold (``tests/test_torch_sharded_training*.py``):
the port's sharded step on gloo ranks (``torch_mesh_ranks.train_body``)
against the reference's sharded step (``torch_mesh_ranks.JAX_TRAIN``, 8 XLA
host devices) and against the port's own step without a mesh, all at fp32
compute on the reference's initial weights and one numpy batch.

Tolerances, the LM training tests' (``tests/test_torch_training.py``):
* loss, nll, accuracy, aux loss: rtol 1e-5 (the same fp32 sums in other
  orders; the model axis splits the vocabulary's log-sum-exp and the
  heads' and columns' products);
* each gradient leaf within ``GRAD_REL`` = 5e-4 of its largest entry, the
  global norm within rtol ``GRAD_REL``: the random smoke models' attention
  is near one-hot, which amplifies rounding in the backward;
* AdamW's updated parameters at rtol 1e-5 / atol 1e-6 where the gradient
  is over 1e-3 of the leaf's largest (its first step moves an entry by
  about lr sign(g), and order noise flips the sign of a gradient near
  zero); its moments within ``GRAD_REL`` of their largest;
* Adafactor's update of a leaf compared as a direction where its step is
  set by the gradient: each side's update divided by its own largest
  entry there, within ``GRAD_REL``, where the entry, its row's and its
  column's RMS are over 1e-3 of the leaf's largest gradient.  A factored
  step is the entry over its row and column factors, so in a column whose
  gradient sits at rounding level (qwen2-vl's key bias) it is order noise
  over order noise; and the RMS clip divides the whole leaf by the RMS of
  its update, which those columns then set, so the rest moves by a scale
  (0.6% for the key bias), not a direction.  Its factored moments within
  ``GRAD_REL`` of their largest.
"""
from __future__ import annotations

import copy
import contextlib
from unittest import mock

import numpy as np
import torch

from repro_torch.training.train_step import BUCKET_BYTES
from torch_mesh_ranks import _tree_from

GRAD_REL = 5e-4
METRICS = ("loss", "nll", "accuracy", "aux_loss", "lr")


def flat(tree, prefix=()):
    """{path: leaf} of a nested dict / list."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def ref_tree(z, prefix, like):
    return flat(_tree_from(z, prefix, like))


def close_rel(got, want, rel=GRAD_REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def port_step(arch, z, *, accum, opt, exact_conv=False):
    """The port's step without a mesh on the reference's initial weights
    and batch: (params, optimizer state, gradients, metrics), flat."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.conv2d.ref import conv2d_backward_ref, conv2d_ref
    from repro_torch.models.registry import fns_for
    from repro_torch.optim import optimizers as O
    from repro_torch.training.train_step import make_train_step
    cfg = R.smoke(arch).replace(compute_dtype="float32")
    params = _tree_from(z, "init/", fns_for(cfg).init(cfg, torch.Generator().manual_seed(1)))
    batch = {k[len("batch/"):]: z[k] for k in z.files if k.startswith("batch/")}
    optimizer = (O.adafactor if opt == "adafactor" else O.adamw)(O.constant(1e-3))
    got = {}
    step = make_train_step(cfg, optimizer, accum=accum, grad_transform=lambda g: got.update(
        g=copy.deepcopy(g)) or g)
    table = dispatch.kernel_table()
    with contextlib.ExitStack() as stack:
        if exact_conv:
            stack.enter_context(mock.patch.object(
                table["conv2d"], "plain", lambda x, w, b, *, stride=1: conv2d_ref(
                    x.double(), w.double(), b.double(), stride=stride).to(x.dtype)))

            def exact_bwd(x, w, b, dy, *, stride=1, need_dx=True):
                dx, dw, db = conv2d_backward_ref(x.double(), w.double(), b.double(),
                                                 dy.double(), stride=stride, need_dx=need_dx)
                return None if dx is None else dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype)
            stack.enter_context(mock.patch.object(table["conv2d_backward"], "plain", exact_bwd))
        p2, st, m = step(params, optimizer.init(params), batch)
    st = {k: v for k, v in st.items() if k != "step"}
    return flat(p2), flat(st), flat(got["g"]), {k: float(v) for k, v in m.items()}


def port_npz(tmp, arch, B, S):
    """``train.npz`` as the rank body reads it, from the port's own init
    (seed 0) and a numpy batch: for the port's sharded step against its
    step without a mesh, where no reference run is needed."""
    from repro_torch.checkpoint.checkpoint import _leaf_name, _leaves_with_path
    from repro_torch.configs import registry as R
    from repro_torch.models.registry import fns_for
    cfg = R.smoke(arch)
    params = fns_for(cfg).init(cfg, torch.Generator().manual_seed(0))
    out = {"init/" + _leaf_name(p): t.numpy() for p, t in _leaves_with_path(params)}
    rng = np.random.default_rng(5)
    out["batch/tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out["batch/labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    np.savez(tmp / "train.npz", **out)
    return np.load(tmp / "train.npz")


def check_case(z, info, ranks, plain, tag, *, opt, collectives):
    """Every rank's metrics, the rank's bytes, the collectives; rank 0's
    gathered gradients, parameters and optimizer state: against the
    reference's sharded step (``tag`` in ``z`` / ``info``) and the port's
    step without a mesh (``plain``)."""
    want = info[tag]["metrics"]
    p_plain, s_plain, g_plain, m_plain = plain
    init = {k: v.numpy() for k, v in flat(_tree_from(z, "init/", ranks[0]["param"])).items()}
    for r in ranks:
        for k in METRICS:
            np.testing.assert_allclose(r["metrics"][k], want[k], rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(r["metrics"][k], m_plain[k], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], want["grad_norm"], rtol=GRAD_REL)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], m_plain["grad_norm"],
                                   rtol=GRAD_REL)
        assert r["collectives"] == collectives, (r["collectives"], collectives)
        # the rank holds its share of the parameters and optimizer state
        assert r["held"] == r["share"], (r["held"], r["share"])
        assert _same_rules(r["rules"], info[tag]["rules"])
    # a mesh axis of more than one rank slices the tree, or nothing does
    sizes = [int(n) for n in tag.split("_")[0].split("x")]
    sliced = sizes[1] > 1 or tag.endswith("_fsdp")
    assert all((r["held"] < r["whole"]) == sliced for r in ranks)
    r0 = ranks[0]
    g_ref = ref_tree(z, tag + "/grad/", r0["grad"])
    g_got = flat(r0["grad"])
    assert set(g_got) == set(g_ref) == set(g_plain)
    for k in g_ref:
        close_rel(g_got[k], g_ref[k], what=("grad", k))
        close_rel(g_got[k], g_plain[k], what=("grad vs plain", k))
    p_ref = ref_tree(z, tag + "/param/", r0["param"])
    p_got = flat(r0["param"])
    for k in p_ref:
        g = np.abs(g_ref[k].numpy())
        if opt == "adamw":
            live = g > 1e-3 * g.max()
            for other in (p_ref[k], p_plain[k]):
                np.testing.assert_allclose(p_got[k].numpy()[live], other.numpy()[live],
                                           rtol=1e-5, atol=1e-6, err_msg=str(k))
        else:
            live = _adafactor_live(g)
            u = (p_got[k].numpy() - init[k])[live]
            for other in (p_ref[k], p_plain[k]):
                v = (other.numpy() - init[k])[live]
                close_rel(u / max(np.abs(u).max(), 1e-30), v / max(np.abs(v).max(), 1e-30),
                          what=("update direction", k))
    s_ref = ref_tree(z, tag + "/opt/", r0["opt"])
    s_got = flat(r0["opt"])
    assert set(s_got) == set(s_ref) == set(s_plain)
    for k in s_ref:
        close_rel(s_got[k], s_ref[k], what=("state", k))
        close_rel(s_got[k], s_plain[k], what=("state vs plain", k))


def _adafactor_live(g):
    """Where Adafactor's step is set by the gradient and not by its
    rounding: the entry, its row's and its column's RMS all over 1e-3 of
    the leaf's largest gradient (a factored leaf's step is the entry over
    its row and column factors)."""
    top = max(g.max(), 1e-30)
    live = g > 1e-3 * top
    if g.ndim >= 2 and g.shape[-1] > 1 and g.shape[-2] > 1:
        sq = np.square(g.astype(np.float64))
        live &= np.sqrt(sq.mean(-1, keepdims=True)) > 1e-3 * top
        live &= np.sqrt(sq.mean(-2, keepdims=True)) > 1e-3 * top
    return live


def _same_rules(a, b):
    """The port's rules against the reference's, tuples as JSON lists."""
    norm = lambda v: tuple(v) if isinstance(v, list) else v
    return {k: norm(v) for k, v in a.items()} == {k: norm(v) for k, v in b.items()}


def _names(entry):
    return () if entry is None else (entry if isinstance(entry, (tuple, list)) else (entry,))


def _fsdp_gathers(axes_tree, rules, model="model") -> int:
    """All-gathers an FSDP gather of these leaves makes: one a data-like
    mesh axis a leaf's spec names."""
    n = 0
    for ax in flat(axes_tree).values() if isinstance(axes_tree, dict) else ():
        for entry in rules.spec(list(ax)):
            n += sum(1 for a in _names(entry) if a != model)
    return n


def expected_collectives(cfg, rules, sizes: dict, *, accum: int, opt: str) -> dict:
    """The collectives of one step, by name, from the model's structure.

    A microbatch of the transformer families (``seq_sp`` and the
    vocabulary on ``model``; remat "full", whose recompute stops after the
    last tensor the backward needs, so a block's last reduce-scatter is
    not run again):
      forward -- the lookup's reduce-scatter; a block's two all-gathers
      (before q / k / v and before the FFN) and two reduce-scatters
      (after o and after the FFN), an MoE block's shared experts in place
      of the FFN's, its router's two sums (token fractions, mean
      probabilities) on each row axis, its three all-to-alls; the LM
      head's all-gather; the cross-entropy's five all-reduces (the max,
      the sum of exponentials, the label's logit, and accuracy's max and
      lowest index); FSDP: an all-gather a leaf and data axis where a
      leaf is used (in the block, again in its recompute);
      backward -- each all-gather's reduce-scatter and the reverse, the
      log-sum-exp's and the label's all-reduce, the mean probabilities'
      all-reduce a row axis, two all-to-alls (the rows out and back; the
      expert ids carry none).
    A step adds (counting mesh axes of more than one rank only): for each
    set of axes some gradients are summed over (the axes their spec does
    not name), one all-reduce an axis and bucket, the leaves cut into
    buckets of ``BUCKET_BYTES`` in order; one a mesh axis for the
    metrics; one a mesh axis that slices some leaf for the global norm;
    and Adafactor's factored means and update RMS, one a sliced axis of
    the dims they average."""
    from collections import Counter
    from repro_torch.models.registry import fns_for
    from repro_torch.models.layers.module import tree_map
    axes = tree_map(lambda d: d.axes, fns_for(cfg).table(cfg))
    c = Counter()
    if cfg.family in ("dense", "moe", "vlm"):
        r = rules.rules
        assert r["seq_sp"] == "model" and r["vocab"] == "model"
        rows = len(_names(r["batch"])) + 1
        first_k = cfg.moe.first_k_dense if cfg.moe else 0
        n_moe = cfg.num_layers - first_k if cfg.moe else 0
        n_dense = cfg.num_layers - n_moe
        shared = bool(cfg.moe and cfg.moe.num_shared_experts)
        moe_ag = 1 + (1 if shared else 0)
        moe_rs = 1 + (1 if shared else 0)
        # forward + recompute + backward, a microbatch
        ag = (n_dense * 2 + n_moe * moe_ag) * 2          # forward and recompute
        rs = (n_dense * 2 + n_moe * moe_rs) * 2 - cfg.num_layers   # last one not re-run
        ag_b = n_dense * 2 + n_moe * moe_rs               # backward of the reduce-scatters
        rs_b = n_dense * 2 + n_moe * moe_ag               # backward of the all-gathers
        fs = (_fsdp_gathers(axes["embed"], rules) + _fsdp_gathers(axes["ln_f"], rules))
        blk = [axes["dense_blocks"][i] for i in range(first_k)] if first_k else []
        per_block = [_fsdp_gathers(b, rules) for b in blk]
        stack = {k: v[1:] for k, v in flat(axes["blocks"]).items()}   # one layer's
        per_block += [_fsdp_gathers(stack, rules)] * (cfg.num_layers - first_k)
        c["all_gather"] += accum * (ag + ag_b + 1 + 1 + fs + 2 * sum(per_block))
        c["reduce_scatter"] += accum * (rs + rs_b + 1 + 1 + fs + sum(per_block))
        c["all_reduce"] += accum * (5 + 2 + n_moe * (2 * rows * 2 + rows))
        if n_moe:
            c["all_to_all"] += accum * n_moe * (3 + 3 + 2)
    # the step: gradient sums, metrics, global norm, Adafactor
    mesh_axes = tuple(a for a in sizes if sizes[a] > 1)
    specs = [rules.spec(list(ax)) for ax in flat(axes).values()]
    named = [set(a for e in sp for a in _names(e)) for sp in specs]
    groups: dict = {}
    for d, n in zip(flat(fns_for(cfg).table(cfg)).values(), named):
        over = tuple(a for a in mesh_axes if a not in n)
        if over:
            groups.setdefault(over, []).append(
                4 * int(np.prod(d.shape)) // int(np.prod([sizes[a] for a in n] or [1])))
    for over, nbytes in groups.items():
        buckets, size = 0, BUCKET_BYTES
        for b in nbytes:
            if size + b > BUCKET_BYTES:
                buckets, size = buckets + 1, 0
            size += b
        c["all_reduce"] += len(over) * buckets
    c["all_reduce"] += len(mesh_axes)
    c["all_reduce"] += sum(1 for a in mesh_axes if any(a in n for n in named))
    if opt == "adafactor":
        for sp, ax in zip(specs, flat(axes).values()):
            sliced = [tuple(a for a in _names(sp[d] if d < len(sp) else None) if sizes[a] > 1)
                      for d in range(len(ax))]
            if len(ax) >= 2:
                c["all_reduce"] += len(sliced[-1]) + 2 * len(sliced[-2])
            c["all_reduce"] += sum(len(x) for x in sliced)
    return {k: v for k, v in c.items() if v}
