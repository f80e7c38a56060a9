"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 backbone.  [arXiv:2404.16821; hf]

Per assignment the InternViT-6B frontend is a STUB: input_specs() provides
256 precomputed patch embeddings (448 px, patch 14, 0.5 pixel-shuffle)
projected into the backbone's d_model.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    frontend="vit_stub",
    num_vision_tokens=256,
    max_seq_len=32_768,
)

SMOKE = ModelConfig(
    name="internvl2-26b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=211,
    frontend="vit_stub",
    num_vision_tokens=8,
    dtype="float32",
)
