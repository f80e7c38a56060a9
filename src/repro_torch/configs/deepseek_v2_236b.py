"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400,
MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

MLA dims: q_lora 1536, kv_lora 512, nope 128 + rope 64 per head, v 128.
First layer is dense-FFN (d_ff 12288).  The compressed (c_kv, k_rope)
cache + absorbed decode follow the paper's inference scheme.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    experts_per_token=6,
    first_dense_layers=1,
    dense_d_ff=12288,
    max_seq_len=131_072,
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=48,
    vocab_size=211,
    attn_type="mla",
    kv_lora_rank=16,
    q_lora_rank=24,
    rope_head_dim=8,
    nope_head_dim=16,
    v_head_dim=16,
    num_experts=8,
    num_shared_experts=2,
    experts_per_token=2,
    first_dense_layers=1,
    dense_d_ff=128,
    moe_capacity_factor=4.0,
    dtype="float32",
)
