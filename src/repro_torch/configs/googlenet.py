"""googlenet [cnn] — the paper's own evaluation model (BVLC GoogLeNet,
Inception-v1, ILSVRC-2012, input 224x224, 1000 classes).  Not part of the
assigned 40 LM cells; exercised by the paper-reproduction benchmarks
(Figs. 6-8) through the NCSw-style offload engine."""
from repro_torch.configs.base import ArchAssignment, ModelConfig

CONFIG = ModelConfig(
    name="googlenet", family="cnn",
    num_layers=9,                 # inception modules
    d_model=1024,                 # final feature width
    num_heads=1, num_kv_heads=1, d_ff=0,
    vocab_size=1000,              # ILSVRC classes
    param_dtype="float32", compute_dtype="float32",
)

# FP16 inference config (the paper's VPU precision)
CONFIG_FP16 = CONFIG.replace(name="googlenet-fp16", compute_dtype="float16")

SMOKE = CONFIG.replace(name="googlenet-smoke")   # same graph, 64x64 inputs

ASSIGNMENT = ArchAssignment(model=CONFIG, shapes=())
