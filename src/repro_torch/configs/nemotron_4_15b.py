"""Nemotron-4-15B [dense] — arXiv:2402.16819.  GQA + squared-ReLU MLP."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="sq_relu",
    rope_type="rope",
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="nemotron-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    activation="sq_relu",
    rope_type="rope",
    rope_theta=10000.0,
)
