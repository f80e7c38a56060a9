"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]

Qwen3 uses head_dim=128 independent of d_model (64 x 128 = 8192 attention
width over a 5120 residual stream) and per-head q/k RMSNorm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    max_seq_len=40_960,
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=503,
    qk_norm=True,
    rope_theta=1_000_000.0,
    dtype="float32",
)
