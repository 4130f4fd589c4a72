"""Phi-4-mini-3.8B [dense] — arXiv:2412.08905.  RoPE + SwiGLU + GQA."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
    rope_type="rope",
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="phi4-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=3,
    n_kv_heads=1,
    d_ff=192,
    vocab_size=512,
    activation="swiglu",
    rope_type="rope",
    rope_theta=10000.0,
)
