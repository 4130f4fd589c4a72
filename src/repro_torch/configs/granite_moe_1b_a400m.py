"""Granite-3.0-1B-A400M [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.
32 experts, top-8."""
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                   # == expert_d_ff
    vocab_size=49155,
    activation="swiglu",
    rope_type="rope",
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=32, top_k=8, expert_d_ff=512),
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    d_ff=48,
    vocab_size=512,
    activation="swiglu",
    rope_type="rope",
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=48,
                  capacity_factor=8.0),
)
