"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA, no QKV bias.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchAssignment, ModelConfig, full_attention_skips

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    d_ff=25600, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    accum_steps=8,
)

SMOKE = CONFIG.replace(
    name="qwen3-32b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, accum_steps=1)

ASSIGNMENT = ArchAssignment(model=CONFIG, skipped=full_attention_skips())
