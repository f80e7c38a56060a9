"""whisper-large-v3 [audio]: 32L d_model=1280 20H d_ff=5120 vocab=51866 —
encoder-decoder, conv frontend (stub).  [arXiv:2212.04356; unverified]

32 encoder + 32 decoder layers; the two-conv mel frontend is a STUB
(input_specs() provides 1500 precomputed frame embeddings).  RoPE replaces
whisper's learned positional embeddings (noted in DESIGN.md).  MHA
(kv=20).  Decoder context is mechanically extended for the assigned
decode_32k cell; whisper's real decoder ceiling is 448 tokens.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    encoder_layers=32,
    encoder_seq_len=1500,
    cross_attention=True,
    frontend="conv_stub",
    mlp_act="gelu",
    norm_type="layernorm",
    max_seq_len=32_768,
)

SMOKE = ModelConfig(
    name="whisper-large-v3-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=211,
    encoder_layers=2,
    encoder_seq_len=16,
    cross_attention=True,
    frontend="conv_stub",
    mlp_act="gelu",
    norm_type="layernorm",
    dtype="float32",
)
