"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + weight-shared attention
blocks.  Sub-quadratic (SSM state is O(1) in seq), so long_500k RUNS.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import (ArchAssignment, ModelConfig, SSMConfig)

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    shared_attn_every=6,      # 6 full segments + 2 tail mamba layers
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=128),
    rope_theta=10_000.0, norm_eps=1e-5, subquadratic=True, accum_steps=8,
)

SMOKE = CONFIG.replace(
    name="zamba2-1.2b-smoke", num_layers=5, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
    shared_attn_every=2, accum_steps=1,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk_size=32))

ASSIGNMENT = ArchAssignment(model=CONFIG)   # all four shapes run
