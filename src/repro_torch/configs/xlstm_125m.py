"""xlstm-125m [ssm] — 12L d_model=768 4H vocab=50304 — interleaved
sLSTM + mLSTM blocks (block i is sLSTM when i % 4 == 1), no separate FFN
(projection factors live inside the blocks).  Recurrent O(1) state, so
long_500k RUNS.  [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchAssignment, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=192,
    xlstm=XLSTMConfig(slstm_every=4, mlstm_proj_factor=2.0,
                      slstm_proj_factor=4.0 / 3.0, conv1d_kernel=4),
    norm_eps=1e-6, subquadratic=True, tie_embeddings=True, accum_steps=8,
)

SMOKE = CONFIG.replace(
    name="xlstm-125m-smoke", num_layers=4, d_model=64, num_heads=4,
    num_kv_heads=4, vocab_size=256, head_dim=16, accum_steps=1,
    xlstm=XLSTMConfig(slstm_every=4, mlstm_proj_factor=2.0,
                      slstm_proj_factor=4.0 / 3.0, conv1d_kernel=4))

ASSIGNMENT = ArchAssignment(model=CONFIG)   # all four shapes run
