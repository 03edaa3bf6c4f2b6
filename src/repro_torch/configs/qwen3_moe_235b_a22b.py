"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
d_ff_expert=1536 vocab=151936, MoE 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import (ArchAssignment, ModelConfig, MoEConfig,
                                full_attention_skips)

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0, norm_eps=1e-6,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536,
                  norm_topk_prob=True),
    optimizer="adafactor", accum_steps=8,
)

SMOKE = CONFIG.replace(
    name="qwen3-moe-235b-a22b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16, accum_steps=1,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                  norm_topk_prob=True, capacity_factor=4.0))

ASSIGNMENT = ArchAssignment(model=CONFIG, skipped=full_attention_skips())
