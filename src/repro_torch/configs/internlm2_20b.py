"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA.  [arXiv:2403.17297; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)

SMOKE = ModelConfig(
    name="internlm2-20b-smoke",
    family="dense",
    num_layers=3,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=211,
    dtype="float32",
)
