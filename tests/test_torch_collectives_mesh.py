"""The sequence-sharded decode under a mesh: K3's plain version with its row
log-sum-exp, ``merge_lse``, the mesh branch of
``seq_sharded_decode_attention`` on gloo ranks against the reference's on
its own (2, 4) mesh of 8 XLA host devices, the split-and-merge of one
cache on one process, and qwen2.5-3b-smoke served by the contiguous engine
on a (1, 4) mesh against the same engine without one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.attention import AttnResiduals as JAttnResiduals
from repro.models.layers.attention import chunked_attention as j_chunked
from repro.models.layers.attention import merge_lse as j_merge_lse
from repro_torch.configs import registry as R
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import MeshShape, ShardingRules, rules_for, use_rules
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import transformer as T
from repro_torch.models.layers.attention import AttnResiduals, merge_lse
from repro_torch.models.registry import fns_for
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampler import greedy
from torch_mesh_ranks import decode_body, engine_body, run_jax, run_world

NEG_INF = -1e30
# the reference test's shapes and lengths (tests/test_distributed_multidev.py)
B, S, H, K, D = 4, 32, 8, 2, 16
LENGTHS = (5, 17, 31, 24)
# the mesh branch against the reference's mesh branch, by cache type: fp32
# at the reference test's own limit; bf16 q and caches: both sides compute
# each shard's attention in bf16 and merge in fp32, so they part only where
# a bf16 rounding of a product or of p falls otherwise (1 bf16 ulp of |out|
# <= 4: 2^-6); int8 caches with fp32 q: dequantized in fp32 on both sides
MESH_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6, "int8": 1e-5}


def _jnp(a, dtype):
    return jnp.asarray(np.asarray(a)).astype(dtype)


# ---------------------------------------------------------------------------
# K3's plain version with its log-sum-exp, and the merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_lse_plain_matches_reference_residuals(dtype):
    """``decode_attention_ref(..., return_lse=True)`` against the
    reference's ``chunked_attention(..., return_residuals=True)``: local
    lengths of 0, past S, and across chunk boundaries.  An empty row gives
    out 0, l 0 and m = NEG_INF."""
    rng = np.random.default_rng(1)
    Bq, Sc = 5, 24
    lengths = np.array([0, 7, 24, 30, 13], np.int32)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Bq, H, D), (Bq, Sc, K, D), (Bq, Sc, K, D)))
    tdt = getattr(torch, dtype)
    out, m, l = decode_attention_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                     torch.from_numpy(lengths), chunk=8, return_lse=True)
    jdt = getattr(jnp, dtype)
    j_out, res = j_chunked(_jnp(q[:, None], jdt), _jnp(k, jdt), _jnp(v, jdt), causal=False,
                           q_positions=jnp.zeros((Bq, 1), jnp.int32),
                           kv_positions=jnp.arange(Sc, dtype=jnp.int32),
                           kv_len=jnp.asarray(lengths), chunk=8, return_residuals=True)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(out.float().numpy(), np.asarray(j_out[:, 0], np.float32),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(res.m[..., 0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(res.l[..., 0]), rtol=1e-5, atol=0)
    assert m.dtype == l.dtype == torch.float32 and m.shape == l.shape == (Bq, H)
    assert (l[0] == 0).all() and (m[0] <= NEG_INF / 2).all() and (out[0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lse_matches_reference(dtype):
    """Four partials, one of them empty (l = 0, m = NEG_INF, out 0), merged
    by the port and by the reference."""
    rng = np.random.default_rng(2)
    outs = rng.standard_normal((4, 3, 1, H, D)).astype(np.float32)
    ms = rng.standard_normal((4, 3, H, 1)).astype(np.float32) * 3
    ls = rng.uniform(0.5, 20, (4, 3, H, 1)).astype(np.float32)
    outs[2], ms[2], ls[2] = 0.0, NEG_INF, 0.0
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = merge_lse([AttnResiduals(out=torch.from_numpy(o).to(tdt), m=torch.from_numpy(m),
                                   l=torch.from_numpy(l)) for o, m, l in zip(outs, ms, ls)])
    want = j_merge_lse([JAttnResiduals(out=_jnp(o, jdt), m=jnp.asarray(m), l=jnp.asarray(l))
                        for o, m, l in zip(outs, ms, ls)])
    assert got.dtype == tdt and got.shape == (3, 1, H, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-6 if dtype == "float32" else 2.0 ** -7, rtol=0)


def shard_and_merge(q, k, v, lengths, M: int, **kw):
    """The mesh branch's arithmetic on one process: the cache cut into M
    contiguous slices, K3 (with its log-sum-exp) on each at the offset
    lengths, the partials merged."""
    s_loc = k.shape[1] // M
    parts = []
    for r in range(M):
        sl = slice(r * s_loc, (r + 1) * s_loc)
        out, m, l = decode_attention_ref(q, k[:, sl].contiguous(), v[:, sl].contiguous(),
                                         C.local_lengths(lengths - 1, r * s_loc, s_loc),
                                         return_lse=True, **kw)
        parts.append(AttnResiduals(out=out[:, None], m=m[..., None], l=l[..., None]))
    return merge_lse(parts)[:, 0]


@pytest.mark.parametrize("M", [2, 4, 8])
def test_split_and_merge_matches_one_call(M):
    """A cache cut into M slices, each attended with its log-sum-exp and the
    partials merged, equals one call over the whole cache (fp32, to 1e-6):
    lengths of 0, 1, a slice boundary, S and past S -- shards with no live
    row give no NaN."""
    rng = np.random.default_rng(3)
    Sc = 64
    lengths = torch.tensor([0, 1, Sc // M, Sc // M + 1, 37, Sc, Sc + 9], dtype=torch.int32)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((len(lengths), H, D), (len(lengths), Sc, K, D),
                         (len(lengths), Sc, K, D)))
    got = shard_and_merge(q, k, v, lengths, M, chunk=16)
    want = decode_attention_ref(q, k, v, lengths, chunk=16)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_local_lengths():
    """The rows of each sequence live on the rank at ``offset`` once the new
    row is written: clamp(lengths + 1 - offset, 0, s_loc)."""
    lengths = torch.tensor([5, 17, 31, 24, -1, 100], dtype=torch.int32)
    got = [C.local_lengths(lengths, r * 8, 8).tolist() for r in range(4)]
    assert got == [[6, 8, 8, 8, 0, 8], [0, 8, 8, 8, 0, 8], [0, 2, 8, 8, 0, 8],
                   [0, 0, 8, 1, 0, 8]]
    assert C.local_lengths(lengths, 0, 8).dtype == torch.int32


# ---------------------------------------------------------------------------
# the mesh branch on gloo ranks against the reference's (2, 4) mesh
# ---------------------------------------------------------------------------

_JAX_DECODE = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.distributed.sharding import ShardingRules, use_rules
from repro.distributed.collectives import seq_sharded_decode_attention
z = np.load(OUT + "/inputs.npz")
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rules = ShardingRules({"batch": ("data",), "kv_seq": "model"})
res = {}
for case, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16),
                 ("int8", jnp.float32)):
    a = {n: jnp.asarray(z[n]).astype(dt) for n in ("q", "ck", "cv", "nk", "nv")}
    lengths = jnp.asarray(z["lengths"])
    with mesh, use_rules(rules, mesh):
        if case == "int8":
            f = jax.jit(lambda q, ck, cv, nk, nv, ln, ks, vs: seq_sharded_decode_attention(
                q, ck, cv, nk, nv, ln, k_scale=ks, v_scale=vs))
            out = f(a["q"], jnp.asarray(z["ck_q"]), jnp.asarray(z["cv_q"]), a["nk"], a["nv"],
                    lengths, jnp.asarray(z["ks"]), jnp.asarray(z["vs"]))
        else:
            f = jax.jit(lambda *x: seq_sharded_decode_attention(*x))
            out = f(a["q"], a["ck"], a["cv"], a["nk"], a["nv"], lengths)
    for i, o in enumerate(out):
        o = np.asarray(o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o)
        res[f"{case}_{i}"] = o
np.savez(OUT + "/ref.npz", **res)
print(json.dumps({"devices": jax.device_count()}))
"""


@pytest.fixture(scope="module")
def mesh_decode(tmp_path_factory):
    """The reference test's inputs (from a numpy seed) through the
    reference on 8 XLA host devices and through the port on 8 gloo ranks,
    both on a (2, 4) mesh; returns (reference arrays, each rank's
    results)."""
    tmp = tmp_path_factory.mktemp("mesh_decode")
    rng = np.random.default_rng(0)
    z = {n: rng.standard_normal(s).astype(np.float32) for n, s in (
        ("q", (B, 1, H, D)), ("ck", (B, S, K, D)), ("cv", (B, S, K, D)),
        ("nk", (B, 1, K, D)), ("nv", (B, 1, K, D)))}
    z["lengths"] = np.array(LENGTHS, np.int32)
    for c, sc in (("ck", "ks"), ("cv", "vs")):
        qv, s = T.quantize_kv(torch.from_numpy(z[c]))
        z[c + "_q"], z[sc] = qv.numpy(), s.numpy()
    np.savez(tmp / "inputs.npz", **z)
    assert run_jax(_JAX_DECODE, tmp)["devices"] == 8
    ref = dict(np.load(tmp / "ref.npz"))
    return ref, run_world(decode_body, 8, tmp)


@pytest.mark.parametrize("case", ["float32", "bfloat16", "int8"])
def test_mesh_decode_matches_reference_mesh(mesh_decode, case):
    """Each rank's output within ``MESH_TOL`` of the reference's for its
    batch slice (no NaN: sequence 0's 6 live rows leave three of its four
    shards empty), and its slots of the updated caches (and, int8, their
    scales) bit-equal to the reference's; one all-gather a call."""
    ref, ranks = mesh_decode
    for rank, got in enumerate(ranks):
        d, m = divmod(rank, 4)
        b, s = slice(2 * d, 2 * d + 2), slice(8 * m, 8 * m + 8)
        res = got[case]
        assert torch.isfinite(res[0]).all()
        np.testing.assert_allclose(res[0].numpy(), ref[f"{case}_0"][b],
                                   atol=MESH_TOL[case], rtol=0)
        for i in range(1, len(res)):
            assert np.array_equal(res[i].numpy(), ref[f"{case}_{i}"][b, s]), (rank, i)
        assert got[case + "_gathers"] == {"all_gather": 1}
    assert len(ranks[0][case]) == (5 if case == "int8" else 3)


# ---------------------------------------------------------------------------
# the contiguous engine under a (1, 4) mesh
# ---------------------------------------------------------------------------

PROMPTS = ((3, 9, 27, 1, 5), tuple(range(40, 53)), (7,) * 6)
NEW_TOKENS, MAX_LEN = 6, 32


def test_engine_under_mesh_matches_unsharded(tmp_path):
    """qwen2.5-3b-smoke through the contiguous engine on a (1, 4) gloo mesh,
    ``rules_for``'s decode rules (kv_seq on model): every rank emits the
    greedy tokens of the same engine without a mesh, holds 8 of the 32
    rows of each cache, and issues one all-gather a layer a decode step."""
    cfg = R.smoke("qwen2.5-3b")
    params = fns_for(cfg).init(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, paged=False, max_len=MAX_LEN, batch_slots=2,
                        device="cpu")
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=NEW_TOKENS, sampler=greedy())
            for i, p in enumerate(PROMPTS)]
    eng.serve(reqs)
    want = [list(r.output) for r in reqs]
    ranks = run_world(engine_body, 4, tmp_path, "qwen2.5-3b", PROMPTS, NEW_TOKENS, MAX_LEN)
    for got in ranks:
        assert got["rules"]["kv_seq"] == "model"
        assert got["tokens"] == want
        assert got["cache"] == (cfg.num_layers, 2, MAX_LEN // 4, cfg.num_kv_heads,
                                cfg.resolved_head_dim)
        assert got["collectives"] == {"all_gather": cfg.num_layers * got["decode_steps"]}


class _Rank:
    """A mesh's shape and one rank's coordinate, with no process group."""

    def __init__(self, names, shape, coordinate):
        self.mesh_dim_names, self.shape, self._c = names, shape, coordinate

    def get_local_rank(self, name):
        return self._c[self.mesh_dim_names.index(name)]


def test_prefill_and_caches_take_the_ranks_rows():
    """Under kv_seq on a model axis of 4, ``make_cache`` allocates a rank's
    8 of 32 rows, and ``prefill`` writes the prompt's rows that fall among
    them; 4 does not divide 30 rows."""
    cfg = R.smoke("qwen2.5-3b")
    params = fns_for(cfg).init(cfg, torch.Generator().manual_seed(0))
    toks = torch.tensor([[3, 9, 27, 1, 5, 8, 11, 2, 4, 6, 12]], dtype=torch.int32)
    _, whole = T.prefill(cfg, params, toks, max_len=32, cache_dtype="float32")
    rules = ShardingRules({"kv_seq": "model"})
    for r in range(4):
        with use_rules(rules, _Rank(("data", "model"), (1, 4), (0, r))):
            _, part = T.prefill(cfg, params, toks, max_len=32, cache_dtype="float32")
            cache = T.make_cache(cfg, 2, 32, device="cpu")
            with pytest.raises(ValueError, match="divide"):
                T.make_cache(cfg, 2, 30, device="cpu")
        assert torch.equal(part.k, whole.k[:, :, 8 * r:8 * r + 8])
        assert torch.equal(part.v, whole.v[:, :, 8 * r:8 * r + 8])
        assert torch.equal(part.length, whole.length)
        assert cache.k.shape[2] == 8


def test_mesh_needs_a_process_group():
    """The mesh branch, ``make_host_mesh``, a paged engine under kv_seq
    rules and a paged engine for a family without paged functions under a
    mesh refuse what they cannot run."""
    from repro_torch.launch.mesh import make_host_mesh
    q, n = torch.zeros((1, 1, 2, 16)), torch.zeros((1, 1, 2, 16))
    c = torch.zeros((1, 8, 2, 16))
    lens = torch.zeros((1,), dtype=torch.int32)
    rules = rules_for(R.smoke("qwen2.5-3b"), ShapeConfig("d", "decode", 32, 1),
                      MeshShape(("data", "model"), (1, 4)))
    with use_rules(rules, _Rank(("data", "model"), (1, 4), (0, 1))):
        with pytest.raises(RuntimeError, match="process group"):
            C.seq_sharded_decode_attention(q, c, c, n, n, lens)
        with pytest.raises(ValueError, match="paged"):
            cfg = R.smoke("qwen2.5-3b")
            ServingEngine(cfg, fns_for(cfg).init(cfg, torch.Generator().manual_seed(0)),
                          paged=True, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(1, 1)
    with pytest.raises(ValueError, match="without sharding rules"):
        with use_rules(None, MeshShape(("m",), (1,))):
            C.seq_sharded_decode_attention(q, c, c, n, n, lens)
    # a family with no paged functions is refused a paged engine under a
    # mesh too, where the rules leave kv_seq whole
    cfg = R.smoke("zamba2-1.2b")
    with use_rules(ShardingRules({"kv_seq": None}), _Rank(("data", "model"), (1, 1), (0, 0))):
        with pytest.raises(ValueError, match="no paged-KV support"):
            ServingEngine(cfg, fns_for(cfg).init(cfg, torch.Generator().manual_seed(0)),
                          paged=True, device="cpu")
