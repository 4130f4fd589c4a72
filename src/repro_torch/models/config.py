"""Model configuration dataclasses: the port's copy of
``repro.models.config`` (``MoEConfig``, ``ModelConfig``, and the shape
cells ``ShapeConfig`` / ``SHAPES`` that ``roofline.analysis`` reads).

Configs are plain frozen dataclasses, so they hash and compare. Every
family of the reference's zoo has a model in the port
(``repro_torch.models.api``), and every field the families read is kept.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """GShard-style top-k mixture-of-experts settings."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    """One generation/embedding model architecture.

    ``family`` selects the block implementation:
      dense   — GQA transformer (llama3 / phi4 / nemotron / mistral)
      moe     — GQA transformer with MoE MLPs (qwen3-moe / granite-moe)
      vlm     — dense transformer backbone + stub patch frontend, M-RoPE
      audio   — whisper-style encoder-decoder, stub conv/mel frontend
      ssm     — xLSTM (mLSTM + sLSTM blocks)
      hybrid  — zamba2 (Mamba2 blocks + shared attention block)
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    activation: str = "swiglu"           # swiglu | sq_relu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_type: str = "rope"              # rope | mrope | sinusoidal | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    moe: Optional[MoEConfig] = None
    # --- SSM / recurrent families ---
    ssm_state: int = 0                   # Mamba2 state size N
    ssm_expand: int = 2                  # Mamba2 expansion factor
    ssm_chunk: int = 256                 # SSD chunk length
    ssm_groups: int = 1                  # Mamba2 B/C groups
    slstm_every: int = 0                 # xLSTM: 1 sLSTM block per this many
    mlstm_chunk: int = 0                 # 0 = full parallel; >0 chunkwise
    conv_width: int = 4                  # Mamba2 causal conv width
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0           # shared attn block per N mamba layers
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500
    # --- attention extras ---
    attn_window: int = 0                 # 0 = full causal; >0 sliding window
    attn_logit_softcap: float = 0.0
    # --- runtime ---
    dtype: str = "bfloat16"
    remat: str = "full"                  # none | dots | full
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def uses_tokens(self) -> bool:
        """Whether the primary input is token ids (vs precomputed embeddings)."""
        return self.family not in ("vlm",)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Parameter count of the port's model, from its shapes on the
        ``meta`` device (nothing is allocated)."""
        from repro_torch.models import api  # local import to avoid cycle

        return api.count_params(api.build(self, device="meta"))

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts only routed experts)."""
        total = self.param_count()
        if self.moe is None:
            return total
        d, m = self.d_model, self.moe
        per_expert = 3 * d * m.expert_d_ff
        dead = self.n_layers * (m.num_experts - m.top_k) * per_expert
        return total - dead


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
