"""xLSTM LM: interleaved mLSTM / sLSTM residual blocks (counterpart of
``repro/models/recurrent.py``).  Block i is the sLSTM when
``i % slstm_every == 1`` (xlstm-125m: 9 mLSTM and 3 sLSTM blocks), each
block with its own pre-norm and residual; a list of blocks, unrolled, as
the reference's.

Kernels on the path (the CUDA kernels on the card, their plain versions on
the CPU): every mLSTM prefill's and training forward's scan through
``ssm_scan`` (K5, one launch a block and prompt or microbatch; in training
its backward kernel once more) and every weight product through
``matmul`` (K7, and its backward in training).  The reference computes
the scan with its plain ``chunked_linear_attn``.  :func:`forward` is the
training forward (``registry._rc_forward``): like the reference's it
ignores ``remat`` and ``chunk``, so nothing is recomputed in the
backward.

Decode state: ``{"states": [MLSTMState | SLSTMState, ...], "length": (B,)
int32}``, O(1) in the sequence length.  :func:`decode_step` returns new
state tensors, as the reference does.  The mLSTM conv histories of
:func:`init_decode_state` are fp32 whatever ``cache_dtype`` says, as the
reference's; so in a bf16 model the engine's decode (its batched state
built there) computes from the first mLSTM block's conv on in fp32, with
the fp32 weights, exactly as the reference's does.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.common import dtype_of
from repro_torch.models.layers import xlstm as X
from repro_torch.models.layers.embedding import embed, embedding_table
from repro_torch.models.layers.embedding import logits as lm_logits
from repro_torch.models.layers.module import init_table, tree_map
from repro_torch.models.layers.norms import apply_norm, norm_table


def _is_slstm(cfg, i: int) -> bool:
    return i % cfg.xlstm.slstm_every == 1


def lm_table(cfg):
    blocks = []
    for i in range(cfg.num_layers):
        core = X.slstm_table(cfg) if _is_slstm(cfg, i) else X.mlstm_table(cfg)
        blocks.append({"norm": norm_table(cfg), "core": core})
    return {
        "embed": embedding_table(cfg.vocab_size, cfg.d_model,
                                 cfg.tie_embeddings),
        "blocks": blocks,
        "ln_f": norm_table(cfg),
    }


def training_launches(cfg, seq: int) -> dict:
    """Kernel launches of one training microbatch of ``seq`` tokens,
    forward and backward, from the config: ``ssm_scan`` (K5) and its
    backward once an mLSTM block; ``matmul`` (K7) for every weight product
    -- seven an mLSTM block (up, q, k, v, w_i, w_f, down), four an sLSTM
    block (w_in, up_gate, up, down) and its recurrent product once a token,
    the LM head -- and twice again in the backward (dX, dW), but for the
    first cell step's recurrent product, whose h is a constant (dW alone).
    K7's come as ``"wide"`` (the mLSTM's up, q, k, v and down, the sLSTM's
    four: bf16 operands TMA reads, so K7's tensor-core route at bf16
    compute) and ``"narrow"`` (w_i and w_f, 4 columns; the fp32 recurrent
    products; the fp32 LM head: its FMA route at any compute)."""
    n_s = sum(_is_slstm(cfg, i) for i in range(cfg.num_layers))
    n_m = cfg.num_layers - n_s
    wide = 5 * n_m + 4 * n_s
    narrow = 2 * n_m + seq * n_s + 1
    return {"ssm_scan": n_m, "ssm_scan_backward": n_m,
            "matmul": {"wide": 3 * wide, "narrow": 3 * narrow - n_s}}


def init(cfg, generator: torch.Generator):
    """Parameters in ``cfg.param_dtype`` on ``generator``'s device, with the
    reference's names and shapes (a list of per-block tables)."""
    return init_table(generator, lm_table(cfg), cfg.param_dtype)


def prepare_params(cfg, params, device=None):
    """Move ``params`` to ``device`` and cast nothing.  The hybrid casts its
    product weights to the compute dtype once; here a weight's type depends
    on the step: the reference casts each to the block input's type, which
    at the engine's decode is fp32 from the first mLSTM block's conv on (the
    fp32 conv history promotes it), and then reads the fp32 weights.  So
    each weight is cast at use, and at a bf16 prefill that costs one cast
    of the ~110 M block weights (0.5 GB moved)."""
    del cfg
    return tree_map(lambda t: t.to(device) if device is not None else t,
                    params)


def _apply(cfg, params, tokens, *, states=None, step=False, collect=False):
    x = embed(params["embed"], tokens, dtype_of(cfg.compute_dtype))
    new_states = []
    for i, bp in enumerate(params["blocks"]):
        h = apply_norm(cfg, bp["norm"], x)
        st = None if states is None else states[i]
        if _is_slstm(cfg, i):
            out, nst = X.slstm_forward(cfg, bp["core"], h, st,
                                       return_state=True)
        elif step:
            out, nst = X.mlstm_step(cfg, bp["core"], h, st)
        else:
            out, nst = X.mlstm_forward(cfg, bp["core"], h, st,
                                       return_state=True)
        x = x + out
        new_states.append(nst if step or collect else None)
    return apply_norm(cfg, params["ln_f"], x), new_states


def forward(cfg, params, tokens, positions=None, *, remat=True, chunk=1024):
    """tokens (B, S) -> full logits (B, S, V) fp32 and the aux loss (0):
    the training forward, differentiable through K5 and K7 (``remat``
    and ``chunk`` ignored, as the reference's)."""
    del positions, remat, chunk
    x, _ = _apply(cfg, params, tokens)
    lg = lm_logits(params["embed"], x, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg, torch.zeros((), dtype=torch.float32, device=lg.device)


def prefill(cfg, params, tokens, positions=None, *, cache_dtype="bfloat16",
            max_len=None, chunk=1024):
    """Prefill the prompt ``tokens`` (B, S).  Returns ((B, V) fp32 logits of
    the last token, the decode state after it)."""
    del positions, cache_dtype, max_len, chunk
    B = tokens.shape[0]
    x, states = _apply(cfg, params, tokens, collect=True)
    lg = lm_logits(params["embed"], x[:, -1:], cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg[:, 0], {"states": states,
                      "length": torch.full((B,), tokens.shape[1],
                                           dtype=torch.int32,
                                           device=tokens.device)}


def decode_step(cfg, params, tokens, state, *, chunk=2048):
    """tokens: (B, 1).  Logits (B, V) fp32 and the new state."""
    del chunk
    x, states = _apply(cfg, params, tokens, states=state["states"], step=True)
    lg = lm_logits(params["embed"], x, cfg.tie_embeddings,
                   cfg.final_logit_softcap)
    return lg[:, 0], {"states": states, "length": state["length"] + 1}


def init_decode_state(cfg, batch: int, max_len: int, cache_dtype="bfloat16",
                      *, device="cuda"):
    del max_len, cache_dtype
    states: list[Any] = []
    for i in range(cfg.num_layers):
        if _is_slstm(cfg, i):
            states.append(X.slstm_init_state(cfg, batch, device=device))
        else:
            states.append(X.mlstm_init_state(cfg, batch, device=device))
    return {"states": states,
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}
