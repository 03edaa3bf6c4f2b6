"""Plain PyTorch version of dense flash attention (counterpart of
``repro/kernels/flash_attention/ref.py``): the chunked online-softmax
attention, queries and keys at positions 0 .. S-1."""
from __future__ import annotations

from repro_torch.models.layers.attention import chunked_attention


def flash_attention_ref(q, k, v, *, causal=True, chunk=512):
    """q: (B, S, H, D); k/v: (B, S, K, D), H % K == 0.  Returns (B, S, H, D)."""
    return chunked_attention(q, k, v, causal=causal, chunk=chunk)
