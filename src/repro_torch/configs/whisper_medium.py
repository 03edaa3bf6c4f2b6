"""whisper-medium [audio] — 24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865 — encoder-decoder; the conv/log-mel frontend is a STUB
(``input_specs`` provides precomputed frame embeddings (B, 1500, 1024)).
Decoder shapes (decode_32k) run: enc-dec is not encoder-only.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import (ArchAssignment, EncDecConfig, ModelConfig,
                                full_attention_skips)

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64,
    qkv_bias=True, use_layernorm=True, norm_eps=1e-5,
    encdec=EncDecConfig(num_encoder_layers=24, num_encoder_frames=1500),
    accum_steps=8,
)

SMOKE = CONFIG.replace(
    name="whisper-medium-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16, accum_steps=1,
    encdec=EncDecConfig(num_encoder_layers=2, num_encoder_frames=32))

ASSIGNMENT = ArchAssignment(model=CONFIG, skipped=full_attention_skips())
