"""Config dataclasses for the repro framework.

Every assigned architecture is expressed as a :class:`ModelConfig` plus a set of
:class:`ShapeConfig` entries (the assigned input shapes).  Configs are plain
frozen dataclasses so they hash, print, and diff cleanly; nothing here touches
jax device state.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (GShard-style capacity dispatch + EP)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    # Layers [0, first_k_dense) use a dense FFN instead of MoE (DeepSeekMoE).
    first_k_dense: int = 0
    d_ff_dense: int = 0
    capacity_factor: float = 1.25
    # Normalize the top-k router probabilities to sum to one (Qwen3-MoE /
    # DeepSeek style).
    norm_topk_prob: bool = True
    router_aux_loss_weight: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) settings."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM settings: interleaved mLSTM / sLSTM blocks."""

    slstm_every: int = 4          # block i is sLSTM when i % slstm_every == 1
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv1d_kernel: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (Whisper-style) settings; the modality frontend is a
    STUB — ``input_specs`` provides precomputed frame embeddings."""

    num_encoder_layers: int = 24
    num_encoder_frames: int = 1500   # 30s of audio after the conv stem


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | hybrid | moe | vlm | ssm | audio | cnn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- attention options ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    m_rope: bool = False             # Qwen2-VL multimodal 3D RoPE
    m_rope_sections: tuple[int, ...] = (16, 24, 24)
    parallel_block: bool = False     # Cohere-style parallel attn+FFN residual
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0          # 0 -> disabled
    # --- block pattern (hybrid archs) ---
    # dense/moe archs: all layers identical.  zamba2: mamba backbone with a
    # shared attention block every `shared_attn_every` layers.
    shared_attn_every: int = 0
    # --- sub-configs ---
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    encdec: EncDecConfig | None = None
    # --- embeddings / norms ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    use_layernorm: bool = False      # LayerNorm (whisper/cohere) vs RMSNorm
    final_logit_softcap: float = 0.0
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # --- training-time knobs ---
    remat: str = "full"              # none | full | offloadable-dots
    optimizer: str = "adamw"         # adamw | adafactor
    # gradient-accumulation microbatches for the train_4k cell (keeps the
    # global batch while bounding live activation/dispatch memory)
    accum_steps: int = 1
    # sub-quadratic attention available (drives long_500k applicability)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell.

    ``kind`` selects which step function gets lowered:
      * ``train``    -> ``train_step``   (tokens + labels, full fwd/bwd/update)
      * ``prefill``  -> ``prefill_step`` (tokens -> logits + KV cache)
      * ``decode``   -> ``serve_step``   (1 new token against seq_len KV/state)
    """

    name: str
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int
    # number of grad-accumulation microbatches (train only; 1 = disabled)
    accum: int = 1

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES: tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME: Mapping[str, ShapeConfig] = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class ArchAssignment:
    """An architecture together with its assigned shape cells and notes about
    shape applicability (see DESIGN.md §Arch-applicability)."""

    model: ModelConfig
    shapes: tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    skipped: Mapping[str, str] = field(default_factory=dict)

    def runnable_shapes(self) -> tuple[ShapeConfig, ...]:
        return tuple(SHAPES_BY_NAME[s] for s in self.shapes if s not in self.skipped)


def full_attention_skips() -> Mapping[str, str]:
    return {
        "long_500k": (
            "pure full-attention architecture: 524k-token context requires "
            "sub-quadratic attention per the assignment; skipped and noted in "
            "DESIGN.md §Arch-applicability"
        )
    }
