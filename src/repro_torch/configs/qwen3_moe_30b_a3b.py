"""Qwen3-30B-A3B [moe] — hf:Qwen/Qwen3-30B-A3B.  128 experts, top-8,
head_dim 128 (q_dim 4096 > d_model 2048, per the released config)."""
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                   # == expert_d_ff; dense d_ff unused
    vocab_size=151936,
    activation="swiglu",
    rope_type="rope",
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=64,
    vocab_size=512,
    activation="swiglu",
    rope_type="rope",
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=64,
                  capacity_factor=8.0),
)
