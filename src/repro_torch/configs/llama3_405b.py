"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab.  [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ArchAssignment, ModelConfig, full_attention_skips

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128,
    rope_theta=500_000.0, norm_eps=1e-5,
    # Pure-bf16 training (PaLM/T5-style): bf16 master + Adafactor's factored
    # fp32 statistics.  fp32 master + Adam state for 405B params would need
    # ~19 GB/chip on a 256-chip v5e pod (16 GB HBM) — see DESIGN.md.
    optimizer="adafactor", accum_steps=16, param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="llama3-405b-smoke", num_layers=3, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, accum_steps=1)

ASSIGNMENT = ArchAssignment(model=CONFIG, skipped=full_attention_skips())
