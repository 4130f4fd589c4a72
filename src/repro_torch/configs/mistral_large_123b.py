"""Mistral-Large-123B [dense] — hf:mistralai/Mistral-Large-Instruct-2407."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    activation="swiglu",
    rope_type="rope",
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="mistral-smoke",
    family="dense",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    activation="swiglu",
    rope_type="rope",
    rope_theta=1000000.0,
)
