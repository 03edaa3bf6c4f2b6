"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE (temporal/height/width streams), dynamic resolution.
The vision frontend is a STUB per the assignment: ``input_specs`` provides
the 3-stream M-RoPE position ids; patch tokens embed via the vocabulary.
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchAssignment, ModelConfig, full_attention_skips

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    qkv_bias=True, m_rope=True, m_rope_sections=(16, 24, 24),
    rope_theta=1_000_000.0, norm_eps=1e-6,
    optimizer="adafactor", accum_steps=8,
)

SMOKE = CONFIG.replace(
    name="qwen2-vl-72b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=32,
    m_rope_sections=(4, 6, 6), accum_steps=1)

ASSIGNMENT = ArchAssignment(model=CONFIG, skipped=full_attention_skips())
