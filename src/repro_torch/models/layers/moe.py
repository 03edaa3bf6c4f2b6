"""Mixture-of-Experts: the router and the capacity dispatch (counterpart of
``repro/models/layers/moe.py``).

Routing (top-k and the Switch aux loss) is plain PyTorch around one weight
product, the router's, in fp32 through K7 (its FMA body on the card).
Every expert's three products run K7's batched entry
(:func:`~repro_torch.models.layers.linear.batched_matmul`): one launch for
all E experts, where a loop over the experts would make E launches a
product.  Two dispatch strategies, as the reference's without a mesh:

  * :func:`moe_einsum` -- the GShard capacity dispatch within each batch
    row, the one the models run (:func:`moe_apply`).  The reference writes
    it as one-hot einsums; here the same dispatch is an index scatter of
    the kept tokens into the (E, B, C) expert rows and a gather back, which
    gives the same numbers: each expert row holds one token or zeros, and
    each token sums its kept terms once, in fp32, rounded once.  Their
    gradients are written out (:class:`_Dispatch`, :class:`_Combine`) as
    the reference's einsums differentiate: a token sums the gradients of
    its kept rows in fp32, in choice order, rounded once, and each kept
    row's gradient is written once -- never an accumulating scatter in the
    compute type, whose order on the card is not fixed.
  * :func:`moe_dense` -- every expert on every token, masked combine: the
    O(E x T) oracle, for the tests.
  * :func:`moe_ep` -- expert parallelism under a mesh, the reference's
    production dispatch: each rank of the ``experts`` mesh axis takes its
    slice of the sequence, sends each kept choice and its local expert id
    to the rank that owns its expert with fixed-capacity ``all_to_all``s,
    runs its ``E / M`` local experts on K7's batched entry, and sends the
    rows back with one more; the slices are then gathered back along the
    axis (in training the rows stay the rank's: the stream is sequence
    sharded already).  Differentiable: each all-to-all's backward is the
    same swap of the gradient, and the local experts' dX / dW run K7's
    batched entry.

:func:`moe_apply` picks ``moe_ep`` by the reference's rule and
:func:`moe_einsum` otherwise.  DeepSeekMoE's shared experts and first-k
dense layers live in the block (:mod:`repro_torch.models.transformer`), as
in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (all_gather_dim, all_to_all,
                                                 require_process_group)
from repro_torch.distributed.tensor_parallel import sum_over
from repro_torch.distributed.sharding import axis_sizes, current_mesh, current_rules
from repro_torch.models.layers.linear import batched_matmul, matmul
from repro_torch.models.layers.module import weight


def moe_table(d_model: int, num_experts: int, d_ff_expert: int):
    """Router and stacked expert SwiGLU weights, the reference's names and
    shapes."""
    e, d, f = num_experts, d_model, d_ff_expert
    return {
        "router": weight((d, e), ("embed", None), stddev=0.02),
        "w_gate": weight((e, d, f), ("experts", "embed", "ff_expert")),
        "w_up": weight((e, d, f), ("experts", "embed", "ff_expert")),
        "w_down": weight((e, f, d), ("experts", "ff_expert", "embed")),
    }


def route(cfg_moe, params, x: torch.Tensor, *, tp=None):
    """Top-k routing decisions and the Switch-style load-balance aux loss.

    x: (B, S, D) activations.  Returns idx (B, S, k) int64 expert ids, in
    descending probability; prob (B, S, k) fp32 combine weights (divided by
    their sum where ``norm_topk_prob``); the aux loss, a 0-dim fp32 tensor.
    The router's logits are ``x.float() @ router.float()``: an fp32 product
    through K7.  Under a training plan ``tp`` x holds the rank's rows: the
    token fractions and mean probabilities the aux loss multiplies are
    summed over every rank's rows (:meth:`Plan.row_axes`) first, so the
    aux loss is the whole batch's, the same on every rank."""
    e = cfg_moe.num_experts
    logits = matmul(x.float(), params["router"].float())        # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    prob, idx = torch.topk(probs, cfg_moe.top_k, dim=-1)
    if cfg_moe.norm_topk_prob:
        prob = prob / torch.clamp(prob.sum(-1, keepdim=True), min=1e-9)
    # aux = E * mean_e( frac_tokens(e) * mean_prob(e) )  (Switch eq. 4)
    one_hot = F.one_hot(idx, e).float()                        # (B, S, k, E)
    if tp is None:
        frac = one_hot.sum(2).mean((0, 1))                      # (E,)
        mean_p = probs.mean((0, 1))                             # (E,)
    else:
        axes = tp.row_axes()
        n = x.shape[0] * x.shape[1]
        for ax in axes:
            n *= axis_sizes(tp.mesh)[ax]
        frac = sum_over(one_hot.sum(2).sum((0, 1)), axes, tp.mesh) / n
        mean_p = sum_over(probs.sum((0, 1)), axes, tp.mesh) / n
    aux = e * (frac * mean_p).sum() / cfg_moe.top_k
    return idx, prob.float(), aux * cfg_moe.router_aux_loss_weight


def expert_ffn(w_gate, w_up, w_down, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, D) -> (E, C, D); each expert's SwiGLU, its three products
    one launch each of K7's batched entry.  ``.to(dt)`` is a no-op for
    weights cast at load (:func:`transformer.prepare_params`)."""
    dt = xs.dtype
    g = batched_matmul(xs, w_gate.to(dt))
    u = batched_matmul(xs, w_up.to(dt))
    return batched_matmul(F.silu(g) * u, w_down.to(dt))


# ---------------------------------------------------------------------------
# dense oracle
# ---------------------------------------------------------------------------

def moe_dense(cfg_moe, params, x, idx, prob):
    """O(E x T) oracle: every expert on every token, masked combine in fp32
    (the reference's ``moe_dense``)."""
    B, S, D = x.shape
    e = cfg_moe.num_experts
    xs = x.reshape(1, B * S, D).expand(e, B * S, D)
    ys = expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xs)
    combine = (F.one_hot(idx, e).float() * prob[..., None]).sum(2)   # (B, S, E)
    return torch.einsum("ebsd,bse->bsd", ys.reshape(e, B, S, D).float(),
                        combine).to(x.dtype)


# ---------------------------------------------------------------------------
# GShard capacity dispatch
# ---------------------------------------------------------------------------

def capacity_of(cfg_moe, S: int) -> int:
    """Rows per (batch row, expert): ``max(1, ceil(S k cf / E))`` with S the
    sequence length of the call -- 1 for a decode step (S = 1) and for a
    speculative verify pass (S = k_spec + 1 = 4 at top-6 of 64), 30 for a
    256-row prefill chunk of deepseek-moe-16b, its padding rows counted."""
    return max(1, math.ceil(S * cfg_moe.top_k * cfg_moe.capacity_factor
                            / cfg_moe.num_experts))


def dispatch_slots(cfg_moe, idx: torch.Tensor, capacity: int):
    """Where each choice goes: (slot, keep), both (B, S, k).

    A choice (b, s, j) of expert e = idx[b, s, j] takes position ``pos``
    among batch row b's choices of e in the flattened (s, j) order (within a
    token, j runs in descending probability), and is kept where pos <
    capacity -- the reference's cumsum over one-hot choices.  Its slot is
    its row of the (E, B, C) expert input, flattened: (e B + b) C + pos."""
    B, S, k = idx.shape
    flat = F.one_hot(idx.reshape(B, S * k), cfg_moe.num_experts)   # (B, S*k, E)
    pos = ((flat.cumsum(1) - 1) * flat).sum(-1).reshape(B, S, k)
    b = torch.arange(B, device=idx.device).view(B, 1, 1)
    return (idx * B + b) * capacity + pos, pos < capacity


class _Dispatch(torch.autograd.Function):
    """x (T, D) -> the (rows, D) expert input: row ``slot[t, j]`` holds token
    t where ``keep[t, j]``, zeros elsewhere (a row holds at most one
    token).  Backward: each token's kept rows of ``dxs`` summed in fp32 in
    choice order and rounded once to x's type, a dropped choice adding
    exactly zero -- the reference's contraction of ``einsum("bsec,bsd->
    ebcd", disp_tok, x)`` over (e, c)."""

    @staticmethod
    def forward(ctx, x, slot, keep, rows):
        ctx.save_for_backward(slot, keep)
        token = torch.arange(x.shape[0], device=x.device).view(-1, 1).expand_as(slot)
        xs = x.new_zeros((rows, x.shape[1]))
        xs[slot[keep]] = x[token[keep]]
        return xs

    @staticmethod
    def backward(ctx, dxs):
        slot, keep = ctx.saved_tensors
        g = dxs[torch.where(keep, slot, 0)].float()              # (T, k, D)
        g = torch.where(keep[..., None], g, 0.0)
        dx = g[:, 0]
        for j in range(1, g.shape[1]):                           # choice order
            dx = dx + g[:, j]
        return dx.to(dxs.dtype), None, None, None


class _Combine(torch.autograd.Function):
    """ys (rows, D) -> (T, k, D): each choice's expert row where ``keep``,
    zeros where it was dropped.  Backward: each kept row's gradient
    written once into a zero (rows, D) gradient, with no accumulation (the
    kept choices' slots are distinct)."""

    @staticmethod
    def forward(ctx, ys, slot, keep):
        ctx.save_for_backward(slot, keep)
        ctx.rows = ys.shape[0]
        out = ys[torch.where(keep, slot, 0)]
        return torch.where(keep[..., None], out, 0)

    @staticmethod
    def backward(ctx, drows):
        slot, keep = ctx.saved_tensors
        dys = drows.new_zeros((ctx.rows, drows.shape[-1]))
        dys[slot[keep]] = drows[keep]
        return dys, None, None


def moe_einsum(cfg_moe, params, x, idx, prob, *, capacity: int | None = None):
    """Capacity dispatch within per-batch-row groups (the reference's
    ``moe_einsum``).  x: (B, S, D); idx/prob: (B, S, k).  Each kept token
    is copied into its expert's row, the E experts run on (E, B C, D) rows
    (zeros where no token arrived), and each token sums ``prob`` (in x's
    type) times its kept experts' rows in fp32, rounded once to x's type;
    a dropped choice adds nothing."""
    B, S, D = x.shape
    e = cfg_moe.num_experts
    if capacity is None:
        capacity = capacity_of(cfg_moe, S)
    slot, keep = dispatch_slots(cfg_moe, idx, capacity)
    k = slot.shape[-1]
    slot, keep = slot.reshape(B * S, k), keep.reshape(B * S, k)
    xs = _Dispatch.apply(x.reshape(B * S, D), slot, keep, e * B * capacity)
    ys = expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                    xs.view(e, B * capacity, D)).reshape(e * B * capacity, D)
    rows = _Combine.apply(ys, slot, keep).float()                # (B S, k, D)
    w = torch.where(keep, prob.reshape(B * S, k).to(x.dtype), 0).float()
    out = (rows * w[..., None]).sum(1)
    return out.to(x.dtype).reshape(B, S, D)


# ---------------------------------------------------------------------------
# expert parallelism: all-to-all dispatch across the ranks of a mesh axis
# ---------------------------------------------------------------------------

def _positions_within(dest: torch.Tensor, num_dest: int):
    """For each entry, its arrival rank among the entries of the same
    destination, in index order.  dest: (N,) int in [0, num_dest).  Returns
    (pos (N,), counts (num_dest,)), int64."""
    n = dest.shape[0]
    order = torch.argsort(dest, stable=True)
    counts = torch.bincount(dest, minlength=num_dest)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=dest.device) - starts[dest[order]]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos, counts


def _scatter_rows(rows: torch.Tensor, slot: torch.Tensor, num: int) -> torch.Tensor:
    """A (num, ...) buffer of zeros with ``rows[i]`` at ``slot[i]``; a slot
    of ``num`` is dropped (the reference's write into one spare row, then
    cut off)."""
    buf = rows.new_zeros((num + 1, *rows.shape[1:]))
    buf[slot] = rows
    return buf[:num]


def _gather_rows(rows: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``rows[slot]``, zeros where ``slot`` is ``len(rows)`` (dropped)."""
    return torch.cat([rows, rows.new_zeros((1, *rows.shape[1:]))])[slot]


def _ep_local(x_loc, idx_loc, prob_loc, w_gate, w_up, w_down, *, cfg_moe, group,
              model_size: int, rank: int):
    """One rank's body: dispatch its tokens' choices to the experts'
    owners, run its local experts, return the rows, combine (the
    reference's ``_ep_local``)."""
    Bl, Sl, D = x_loc.shape
    k = cfg_moe.top_k
    e_local = cfg_moe.num_experts // model_size
    T = Bl * Sl
    xf = x_loc.reshape(T, D)
    ef = idx_loc.reshape(T * k).long()
    pf = prob_loc.reshape(T * k)
    tok_of = torch.arange(T, device=x_loc.device).repeat_interleave(k)

    # first level: a fixed capacity of c_send rows for each destination rank
    dest = ef // e_local
    c_send = max(1, math.ceil(T * k * cfg_moe.capacity_factor / model_size))
    pos, _ = _positions_within(dest, model_size)
    keep = pos < c_send
    slot = torch.where(keep, dest * c_send + pos, model_size * c_send)
    R = model_size * c_send
    recv = all_to_all(_scatter_rows(xf[tok_of], slot, R), group)
    recv_eid = all_to_all(_scatter_rows(ef % e_local, slot, R), group)

    # second level: a fixed capacity of c_exp rows for each local expert (an
    # unfilled send row arrives as zeros for local expert 0 and takes a place)
    c_exp = max(1, math.ceil(R * cfg_moe.capacity_factor / max(e_local, 1)))
    pos2, _ = _positions_within(recv_eid, e_local)
    keep2 = pos2 < c_exp
    slot2 = torch.where(keep2, recv_eid * c_exp + pos2, e_local * c_exp)
    buf = _scatter_rows(recv, slot2, e_local * c_exp)
    if w_gate.shape[0] != e_local:       # whole weights: take the rank's experts
        mine = slice(rank * e_local, (rank + 1) * e_local)
        w_gate, w_up, w_down = w_gate[mine], w_up[mine], w_down[mine]
    ys = expert_ffn(w_gate, w_up, w_down,
                    buf.view(e_local, c_exp, D)).reshape(e_local * c_exp, D)

    # the rows go back through the same slots
    ret = all_to_all(_gather_rows(ys, slot2), group)
    contrib = _gather_rows(ret, slot).float() * pf[:, None]
    return contrib.view(T, k, D).sum(1).to(x_loc.dtype).view(Bl, Sl, D)


def moe_ep(cfg_moe, params, x, idx, prob, *, mesh, model_axis: str,
           local_rows: bool = False):
    """Expert-parallel dispatch over the mesh axis ``model_axis`` of M
    ranks.  x: (B, S, D), idx / prob: (B, S, k): this rank's batch, the same
    on every rank of the axis (S % M == 0, E % M == 0).  Each rank takes
    the sequence slice ``[rank S / M, (rank + 1) S / M)`` (the reference's
    reshard of ``seq`` onto the axis), runs :func:`_ep_local` -- its rows
    and their local expert ids out and the rows back, three
    ``all_to_all``s on the axis's group -- and the slices are all-gathered
    back: returns (B, S, D) in x's type, the same on every rank (the
    gather's consumer is replicated, so its backward takes the rank's
    slice).  ``local_rows``: x, idx and prob are the rank's slice already
    (training's sequence-sharded stream) and so is the output.  The
    expert weights are whole, or the rank's E / M experts (sharded
    training).  Differentiable; a mesh with no initialised process group
    raises."""
    require_process_group()
    M = axis_sizes(mesh)[model_axis]
    rank = mesh.get_local_rank(model_axis)
    group = mesh.get_group(model_axis)
    B, S, D = x.shape
    if (not local_rows and S % M) or cfg_moe.num_experts % M:
        raise ValueError(f"moe_ep: S {S} and {cfg_moe.num_experts} experts must divide "
                         f"into {M} ranks")
    w = (params["w_gate"], params["w_up"], params["w_down"])
    if local_rows:
        return _ep_local(x, idx, prob, *w, cfg_moe=cfg_moe, group=group, model_size=M,
                         rank=rank)
    part = slice(rank * (S // M), (rank + 1) * (S // M))
    y = _ep_local(x[:, part], idx[:, part], prob[:, part], *w, cfg_moe=cfg_moe,
                  group=group, model_size=M, rank=rank)
    return all_gather_dim(y, 1, group, consumer="replicated")


def moe_apply(cfg_moe, params, x, idx, prob):
    """The reference's strategy choice: :func:`moe_ep` under a mesh whose
    ``experts`` axis (the current rules') has more than one rank and
    divides both the sequence and the experts, :func:`moe_einsum`
    otherwise (a decode step, one card).  Differentiable."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is not None and rules is not None:
        model_axis = rules.rules.get("experts")
        if isinstance(model_axis, str):
            msize = axis_sizes(mesh).get(model_axis, 1)
            S = x.shape[1]
            if msize > 1 and S % msize == 0 and S >= msize \
                    and cfg_moe.num_experts % msize == 0:
                return moe_ep(cfg_moe, params, x, idx, prob, mesh=mesh,
                              model_axis=model_axis)
    return moe_einsum(cfg_moe, params, x, idx, prob)
