"""Whisper-large-v3 [audio] — arXiv:2212.04356.  Encoder-decoder; conv/mel
frontend stubbed (input_specs provides precomputed frame embeddings).
MHA (n_kv_heads == n_heads), GELU, sinusoidal positions."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    activation="gelu",
    rope_type="sinusoidal",
    is_encoder_decoder=True,
    encoder_layers=32,
    encoder_seq=1500,           # 30 s of audio at 50 frames/s
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    activation="gelu",
    rope_type="sinusoidal",
    is_encoder_decoder=True,
    encoder_layers=2,
    encoder_seq=64,
)
