"""Zamba2-2.7B [hybrid] — arXiv:2411.15242.  54 Mamba2 blocks + one shared
attention/MLP block applied every 6 layers.  The shared block uses a sliding
window (TPU adaptation; keeps long_500k decode sub-quadratic — DESIGN.md §4)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,                 # shared block MLP
    vocab_size=32000,
    activation="gelu",
    rope_type="rope",
    rope_theta=10000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_chunk=256,
    shared_attn_every=6,
    attn_window=4096,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    activation="gelu",
    rope_type="rope",
    rope_theta=10000.0,
    ssm_state=16,
    ssm_expand=2,
    ssm_chunk=32,
    shared_attn_every=2,
    attn_window=64,
)
