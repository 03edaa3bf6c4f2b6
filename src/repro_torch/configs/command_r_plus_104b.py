"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, Cohere parallel attn+FFN block,
LayerNorm.  [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ArchAssignment, ModelConfig, full_attention_skips

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000, head_dim=128,
    qkv_bias=False, rope_theta=75_000_000.0, tie_embeddings=True,
    parallel_block=True, use_layernorm=True, norm_eps=1e-5,
    optimizer="adafactor", accum_steps=8,
)

SMOKE = CONFIG.replace(
    name="command-r-plus-104b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, accum_steps=1)

ASSIGNMENT = ArchAssignment(model=CONFIG, skipped=full_attention_skips())
