"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
ssm_state=16 — parallel attn+mamba heads.  [arXiv:2411.13676; hf]

Attention and Mamba heads process the input in parallel inside each block;
their normalized outputs are averaged (paper's fusion).  Sliding-window
attention everywhere except three global layers (first/middle/last).
Hymba's 128 meta tokens are omitted (noted in DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    ssm_state=16,
    ssm_conv=4,
    max_seq_len=1_048_576,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    num_layers=3,
    d_model=40,
    num_heads=5,
    num_kv_heads=5,
    head_dim=8,
    d_ff=96,
    vocab_size=211,
    sliding_window=8,
    ssm_state=8,
    ssm_conv=4,
    dtype="float32",
)
