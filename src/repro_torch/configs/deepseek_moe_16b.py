"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16)
d_ff_expert=1408 vocab=102400, MoE 64 routed top-6 + 2 shared experts,
fine-grained, first layer dense (d_ff=10944).  [arXiv:2401.06066; hf]"""
from repro_torch.configs.base import (ArchAssignment, ModelConfig, MoEConfig,
                                full_attention_skips)

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    rope_theta=10_000.0, norm_eps=1e-6,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, d_ff_shared=1408,
                  first_k_dense=1, d_ff_dense=10944,
                  norm_topk_prob=False),
    accum_steps=8,
)

SMOKE = CONFIG.replace(
    name="deepseek-moe-16b-smoke", num_layers=3, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=32, vocab_size=256, head_dim=16, accum_steps=1,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                  num_shared_experts=2, d_ff_shared=32,
                  first_k_dense=1, d_ff_dense=128,
                  norm_topk_prob=False, capacity_factor=4.0))

ASSIGNMENT = ArchAssignment(model=CONFIG, skipped=full_attention_skips())
