"""Model configuration for the architecture pool."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention options ---
    attn_type: str = "gqa"  # gqa | mla
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None  # local-attention window
    local_global_ratio: int = 0  # gemma3: N local layers per 1 global (0 = all global)

    # --- MLA (deepseek-v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    first_dense_layers: int = 0  # leading dense-FFN layers (deepseek-v2: 1)
    dense_d_ff: int = 0  # d_ff of those leading dense layers

    # --- SSM / hybrid / xLSTM ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_heads: int = 0  # mamba heads (hymba); 0 -> num_heads
    slstm_every: int = 0  # xlstm: an sLSTM block every N layers (0 = none)

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq_len: int = 0  # frames after the conv frontend (whisper: 1500)
    cross_attention: bool = False

    # --- modality frontend stubs ---
    frontend: str | None = None  # vit_stub | conv_stub
    num_vision_tokens: int = 0  # vlm: patch embeddings prepended to text

    # --- misc ---
    mlp_act: str = "silu"  # silu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    max_seq_len: int = 32_768
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a shardable multiple (Megatron-style vocab
        padding; the pad logits are masked to -inf in logits_from)."""
        unit = 256
        return -(-self.vocab_size // unit) * unit

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if decode over very long contexts is architecturally sane
        (SSM state, hybrid, or sliding-window local attention dominant)."""
        return self.family in ("ssm", "hybrid") or self.local_global_ratio > 0

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_attn_out = self.num_heads * hd
        if self.attn_type == "mla":
            q = self.d_model * (self.q_lora_rank or self.num_heads * (self.nope_head_dim + self.rope_head_dim))
            if self.q_lora_rank:
                q += self.q_lora_rank * self.num_heads * (self.nope_head_dim + self.rope_head_dim)
            kv = d * (self.kv_lora_rank + self.rope_head_dim)
            kv += self.kv_lora_rank * self.num_heads * (self.nope_head_dim + self.v_head_dim)
            o = self.num_heads * self.v_head_dim * d
            attn = q + kv + o
        else:
            attn = d * n_attn_out + 2 * d * self.num_kv_heads * hd + n_attn_out * d
        if self.is_moe:
            ffn = 3 * d * self.d_ff * (self.num_experts + self.num_shared_experts)
            ffn += d * self.num_experts  # router
        else:
            ffn = 3 * d * self.d_ff
        if self.family == "ssm":
            # xlstm blocks: in/out proj + gates, rough
            ffn = 2 * d * 2 * d
        per_layer = attn + ffn
        total = self.num_layers * per_layer
        if self.first_dense_layers and self.is_moe:
            total += self.first_dense_layers * (3 * d * (self.dense_d_ff or self.d_ff) - 3 * d * self.d_ff * (self.num_experts + self.num_shared_experts))
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            total += self.encoder_layers * (attn + 3 * d * self.d_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed top-k + shared)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = 3 * d * self.d_ff * self.num_experts * self.num_layers
        active_experts = 3 * d * self.d_ff * self.experts_per_token * self.num_layers
        return int(full - all_experts + active_experts)
