"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks.  [arXiv:2405.04517; unverified]

Block ratio approximates the paper's mLSTM:sLSTM mix: an sLSTM block every
6 layers (positions 5, 11), mLSTM elsewhere.  mLSTM uses projection factor
2 (internal up/down projection; no separate FFN, hence d_ff=0).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=6,
    tie_embeddings=True,
    max_seq_len=1_048_576,  # recurrent state: context-length free
)

SMOKE = ModelConfig(
    name="xlstm-125m-smoke",
    family="ssm",
    num_layers=4,
    d_model=32,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=211,
    slstm_every=2,
    tie_embeddings=True,
    dtype="float32",
)
