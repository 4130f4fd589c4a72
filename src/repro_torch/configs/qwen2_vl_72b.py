"""Qwen2-VL-72B [vlm] — arXiv:2409.12191.  M-RoPE, dynamic-resolution patch
frontend stubbed per the brief (input_specs provides precomputed patch
embeddings)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    activation="swiglu",
    rope_type="mrope",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),   # t/h/w bands over half head_dim = 64
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    activation="swiglu",
    rope_type="mrope",
    rope_theta=1e6,
    mrope_sections=(4, 6, 6),      # half head_dim = 16
)
