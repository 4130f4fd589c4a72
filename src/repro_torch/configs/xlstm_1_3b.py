"""xLSTM-1.3B [ssm] — arXiv:2405.04517.  xLSTM[7:1] block ratio: one sLSTM
block per 8 layers, mLSTM otherwise."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                 # mLSTM blocks carry their own up/down projections
    vocab_size=50304,
    rope_type="none",
    slstm_every=8,          # 7 mLSTM : 1 sLSTM
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    rope_type="none",
    slstm_every=2,
)
