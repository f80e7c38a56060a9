"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global, 128k context claim (1b ships 32k; we
honour the assignment's long-context role via the sliding-window local
layers).  [hf:google/gemma-3-1b-pt; unverified]

head_dim=256 (gemma3 fixes head_dim, 4 x 256 = 1024 over a 1152 stream);
tied embeddings; 512-token sliding window on local layers.  Single rope
theta (10k) for both local and global layers — gemma3's dual-theta rope
is noted as a simplification in DESIGN.md.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    qk_norm=True,
    sliding_window=512,
    local_global_ratio=5,
    tie_embeddings=True,
    rope_theta=10_000.0,
    max_seq_len=131_072,
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke",
    family="dense",
    num_layers=6,
    d_model=48,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    qk_norm=True,
    sliding_window=8,
    local_global_ratio=5,
    tie_embeddings=True,
    dtype="float32",
)
