"""The pieces of the sharded train step, on 4 gloo ranks, in fp64 where the
arithmetic allows it:

* each differentiable collective's gradient against autograd of the same
  function on the whole tensor: all-reduce, all-gather along a dim (its
  consumer partial -- a reduce-scatter backward -- and replicated -- the
  rank's slice; a reduce-scatter of a replicated gradient counts it once a
  rank, 4 times), reduce-scatter and all-to-all;
* the vocabulary-parallel cross-entropy against ``lm_cross_entropy`` on the
  whole logits (its fp32 arithmetic), rows whole and ``seq_sp``'s own
  rows, with argmax ties across the slices;
* the global norm and Adafactor on a (2, 2) mesh's slices against the
  whole tensors, a dim cut on two mesh axes among them (Adafactor computes
  in fp32 whatever the gradient's type);
* ``shard_tree`` / ``gather_tree``: the round trip, contiguous clones of
  the rank's share, ``shard_of`` of a multi-axis entry.
"""
import numpy as np
import pytest
import torch

from repro_torch.optim import optimizers as O
from repro_torch.training.losses import lm_cross_entropy
from torch_mesh_ranks import collectives_grad_body, pieces_body, run_world

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coll_grad")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8, 8))
    c = rng.standard_normal((4, 8, 8))
    np.savez(tmp / "coll.npz", x=x, c=c)
    return torch.from_numpy(x), torch.from_numpy(c), run_world(collectives_grad_body, 4, tmp)


def _whole_grad(fn, X, *args):
    """d/dX of ``fn(X, *args)`` (a scalar) by autograd on the whole."""
    X = X.clone().requires_grad_()
    fn(X, *args).backward()
    return X.grad


@pytest.mark.parametrize("name", ["all_reduce", "gather_partial", "gather_replicated",
                                  "gather_partial_of_replicated", "reduce_scatter",
                                  "all_to_all"])
def test_collective_gradients_match_autograd_on_the_whole(coll, name):
    X, Cw, ranks = coll
    Xs = X[:, :, :2]                   # each rank's (8, 2) slice of a (8, 8) whole
    if name == "all_reduce":           # y = sum_r x_r; loss = sum_r sum(y c_r)
        want = _whole_grad(lambda X: sum((X.sum(0) * Cw[r]).sum() for r in range(4)), X)
        got = [r[name] for r in ranks]
        want = [want[i] for i in range(4)]
    elif name.startswith("gather"):    # y = cat_r x_r along dim 1
        cols = lambda X: torch.cat(list(X), dim=1)
        if name == "gather_partial":
            loss = lambda X: sum((cols(X) * Cw[r][:, :8]).sum() for r in range(4))
        else:                          # every rank the same consumer: counted once
            loss = lambda X: (cols(X) * Cw[0][:, :8]).sum()
        g = _whole_grad(loss, Xs)
        want = [g[i] * (4 if name == "gather_partial_of_replicated" else 1) for i in range(4)]
        got = [r[name] for r in ranks]
    elif name == "reduce_scatter":     # y_r = (sum x)[2r:2r+2]
        loss = lambda X: sum((X.sum(0)[2 * r:2 * r + 2] * Cw[r][:2]).sum() for r in range(4))
        g = _whole_grad(loss, X)
        want, got = [g[i] for i in range(4)], [r[name] for r in ranks]
    else:                              # y_r = cat_j x_j[2r:2r+2]
        loss = lambda X: sum((torch.cat([X[j][2 * r:2 * r + 2] for j in range(4)])
                              * Cw[r]).sum() for r in range(4))
        g = _whole_grad(loss, X)
        want, got = [g[i] for i in range(4)], [r[name] for r in ranks]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pieces")
    rng = np.random.default_rng(3)
    B, S, V = 2, 8, 128
    logits = (3 * rng.standard_normal((B, S, V))).astype(np.float32)
    logits[0, 0, [5, 70]] = 40.0        # a tie across slices (0 and 2)
    logits[0, 1, [33, 34]] = 40.0       # within slice 1
    logits[1, 2, [127, 0]] = 40.0       # the last slice against the first
    labels = rng.integers(0, V, (B, S)).astype(np.int64)
    labels[0, 0], labels[0, 1], labels[1, 2] = 5, 34, 0
    arrays = {"w": (4, 6), "v": (4, 3, 6), "s": (5,), "m": (8, 3)}
    data = {k: rng.standard_normal(s) for k, s in arrays.items()}
    data.update({"g_" + k: rng.standard_normal(s) for k, s in arrays.items()})
    np.savez(tmp / "pieces.npz", logits=logits, labels=labels, **data)
    return logits, labels, data, run_world(pieces_body, 4, tmp)


@pytest.mark.parametrize("seq_sp", [False, True])
def test_vocab_parallel_cross_entropy_matches_whole(pieces, seq_sp):
    """The ranks' loss, nll and accuracy shares sum to the whole's (rows
    whole: model rank 0 counts them all; ``seq_sp``: each its S / 4), ties
    broken at the lowest index across the slices; each rank's gradient is
    its vocabulary slice of the whole's."""
    logits, labels, _, ranks = pieces
    x = torch.from_numpy(logits).requires_grad_()
    loss, m = lm_cross_entropy(x, torch.from_numpy(labels))
    loss.backward()
    assert float(m["accuracy"]) == pytest.approx(2 / 16)    # 33 beats 34: lowest index
    got = [r[f"ce_{seq_sp}"] for r in ranks]
    np.testing.assert_allclose(float(sum(g["loss"] for g in got)), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(sum(g["nll"] for g in got)), float(m["nll"]), rtol=1e-6)
    assert float(sum(g["acc"] for g in got)) == pytest.approx(float(m["accuracy"]), abs=1e-7)
    V = logits.shape[-1]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["grad"].numpy(), x.grad[..., r * V // 4:(r + 1) * V // 4],
                                   rtol=0, atol=1e-6 * float(x.grad.abs().max()))
    if not seq_sp:
        assert all(float(g["loss"]) == 0 for g in got[1:])


def test_global_norm_and_adafactor_on_slices_match_whole(pieces):
    """On a (2, 2) mesh -- ``w`` cut on both axes, ``v`` on its first and
    last dims, ``m``'s first dim on both axes, ``s`` whole -- the global
    norm counts each leaf once, and Adafactor's factored means and update
    RMS over the sliced dims give the whole tensors' step (within fp32's
    rounding: the optimizer casts each gradient to fp32, and a mean of the
    slices' means rounds otherwise than the whole's)."""
    _, _, data, ranks = pieces
    whole = {k: torch.from_numpy(data[k]) for k in ("w", "v", "s", "m")}
    grads = {k: torch.from_numpy(data["g_" + k]) for k in whole}
    norm = O.global_norm(grads)
    opt = O.adafactor(O.constant(1e-2))
    params = {k: v.clone() for k, v in whole.items()}
    _, _, met = opt.update({k: v.clone() for k, v in grads.items()}, opt.init(params), params)
    for r in ranks:
        assert float(r["norm"]) == pytest.approx(float(norm), rel=1e-12)
        assert float(r["adafactor_norm"]) == pytest.approx(float(met["grad_norm"]), rel=1e-12)
        for k in whole:
            torch.testing.assert_close(r["adafactor"][k], params[k], rtol=1e-6, atol=1e-9)


def test_shard_tree_round_trip(pieces):
    """``gather_tree(shard_tree(t))`` is ``t``; each slice is a contiguous
    clone holding only its share; an entry on ("data", "model") cuts a dim
    in 4, major to minor."""
    *_, ranks = pieces
    for rank, r in enumerate(ranks):
        assert r["round_trip"] and r["contiguous"]
        assert r["local_shapes"] == {"w": (2, 3), "v": (2, 3, 3), "s": (5,), "m": (2, 3)}
        assert r["shard_of_ab"] == (4, rank)


@pytest.mark.parametrize("M,K,N,layout", [(1024, 2048, 2752, "w"), (1024, 2752, 2048, "w"),
                                          (1024, 2752, 2048, "w.T"), (2048, 1024, 2752, "x.T"),
                                          (1024, 2048, 37984, "w.T")])
def test_a_ranks_slices_route_to_wgmma(M, K, N, layout):
    """K7's route on a 1 x 4 rank's bf16 operands of qwen2.5-3b: the
    SwiGLU's ``ff`` slice of 2752 columns and the vocabulary slice of 37984
    rows, each ``shard_tree``'s contiguous clone, read as they are or
    transposed in place (W^T for dX, X^T for dW, the tied table's slice
    for the LM head), keep ``wgmma``: no slice falls to the FMA body."""
    from repro_torch.distributed.sharding import MeshShape, ShardingRules, shard_tree
    from repro_torch.kernels.matmul.ops import body_for
    mesh = MeshShape(("data", "model"), (1, 4))
    rules = ShardingRules({"ff": "model"})
    if layout == "x.T":                 # X^T of a (K, M) activation, dY a weight-shaped slice
        x = torch.zeros((K, M), dtype=torch.bfloat16).T
        w = shard_tree({"w": torch.zeros((K, 4 * N), dtype=torch.bfloat16)},
                       {"w": (None, "ff")}, rules, mesh, coordinate=(0, 3))["w"]
    else:
        whole = (K, 4 * N) if layout == "w" else (4 * N, K)
        axes = (None, "ff") if layout == "w" else ("ff", None)
        w = shard_tree({"w": torch.zeros(whole, dtype=torch.bfloat16)}, {"w": axes}, rules,
                       mesh, coordinate=(0, 3))["w"]
        w = w if layout == "w" else w.T
        x = torch.zeros((M, K), dtype=torch.bfloat16)
    assert w.shape == (K, N) and body_for(x, w) == "wgmma"


def test_the_stream_stays_whole_where_the_model_axis_does_not_divide_s(tmp_path):
    """qwen2.5-3b-smoke on a (1, 4) mesh at S = 18: ``rules_for`` leaves
    ``seq_sp`` off (4 does not divide 18), so the stream is whole on every
    rank, the products read it as it is, the row-parallel sums and the
    lookup are all-reduced and model rank 0 counts the loss; the step
    against the port's without a mesh, each rank holding its share."""
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import MeshShape, rules_for
    from torch_mesh_ranks import train_body
    from torch_sharded_checks import GRAD_REL, close_rel, flat, port_npz, port_step
    cfg = R.smoke("qwen2.5-3b")
    assert rules_for(cfg, ShapeConfig("t", "train", 18, 4),
                     MeshShape(("data", "model"), (1, 4))).rules["seq_sp"] is None
    z = port_npz(tmp_path, "qwen2.5-3b", 4, 18)
    ranks = run_world(train_body, 4, tmp_path, "qwen2.5-3b", 1, 4, False, 2, "adamw", False)
    p_plain, s_plain, g_plain, m_plain = port_step("qwen2.5-3b", z, accum=2, opt="adamw")
    for r in ranks:
        for k in ("loss", "nll", "accuracy", "aux_loss"):
            np.testing.assert_allclose(r["metrics"][k], m_plain[k], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], m_plain["grad_norm"],
                                   rtol=GRAD_REL)
        assert set(r["collectives"]) == {"all_reduce"}
        assert r["held"] == r["share"] < r["whole"]
    g = flat(ranks[0]["grad"])
    for k in g_plain:
        close_rel(g[k], g_plain[k], what=k)
    for k, p in flat(ranks[0]["param"]).items():
        gk = np.abs(g_plain[k].numpy())
        live = gk > 1e-3 * gk.max()
        np.testing.assert_allclose(p.numpy()[live], p_plain[k].numpy()[live], rtol=1e-5,
                                   atol=1e-6)


class _Mesh:
    """Axis names and sizes, and this rank's index on each (``plan`` reads
    no more of a mesh)."""

    def __init__(self, sizes: dict, rank: int = 0):
        self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())
        self.rank = rank

    def get_local_rank(self, name):
        return self.rank


@pytest.mark.parametrize("case", ["heads", "kv_straddle", "moe_without_seq_sp"])
def test_plan_refuses_what_is_not_cut_yet(case):
    """Tensor parallelism the port does not cut yet raises (11b'): heads
    the model axis does not divide; a replicated KV head that two ranks'
    query heads straddle (6 query heads on 3 KV heads at M = 2); experts
    on a model axis where ``seq_sp`` is off."""
    from repro_torch.configs import registry as R
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import ShardingRules, use_rules
    rules = {"heads": "model", "kv_heads": None, "ff": "model", "vocab": "model",
             "experts": "model", "seq_sp": "model", "batch": None}
    cfg = R.smoke("qwen2.5-3b")
    if case == "heads":
        rules["heads"] = None
    elif case == "kv_straddle":
        cfg = cfg.replace(num_heads=6, num_kv_heads=3)
    else:
        cfg, rules["seq_sp"] = R.smoke("deepseek-moe-16b"), None
    with use_rules(ShardingRules(rules), _Mesh({"data": 1, "model": 2 if case ==
                                                 "kv_straddle" else 4})):
        with pytest.raises(NotImplementedError):
            TP.plan(cfg)
