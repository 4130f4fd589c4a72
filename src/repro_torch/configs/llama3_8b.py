"""Llama-3-8B [dense] — arXiv:2407.21783.  GQA, 128k vocab, SwiGLU."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    activation="swiglu",
    rope_type="rope",
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    activation="swiglu",
    rope_type="rope",
    rope_theta=500000.0,
)
