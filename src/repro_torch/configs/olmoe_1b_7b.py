"""olmoe-1b-7b [moe]: 16L d_model=2048 16H d_ff=1024 vocab=50304,
MoE 64e top-8 — 64 experts top-8.  [arXiv:2409.02060; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    num_experts=64,
    experts_per_token=8,
    max_seq_len=32_768,
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke",
    family="moe",
    num_layers=2,
    d_model=48,
    num_heads=4,
    num_kv_heads=4,
    head_dim=12,
    d_ff=32,
    vocab_size=211,
    qk_norm=True,
    num_experts=8,
    experts_per_token=2,
    moe_capacity_factor=4.0,
    dtype="float32",
)
