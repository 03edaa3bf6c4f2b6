"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ArchAssignment, ModelConfig, full_attention_skips

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
    norm_eps=1e-6, accum_steps=8,
)

SMOKE = CONFIG.replace(
    name="qwen2.5-3b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, accum_steps=1)

ASSIGNMENT = ArchAssignment(model=CONFIG, skipped=full_attention_skips())
