"""Core layers of the port: norms, RoPE, GQA attention, SwiGLU MLP.

The dense subset of ``repro.models.layers``, as functions over the
parameter modules of ``models/transformer.py`` (``p.wq`` where the
reference reads ``params["wq"]``).  Compute runs in the config dtype with
f32 norms, rope and softmax, at the reference's rounding points:

* norms upcast to f32 and cast back (``rmsnorm``, ``layernorm``);
* rope works in f32 and casts back to x's dtype;
* a projection is ``x @ w.to(x.dtype)``.  The reference keeps f32 weights
  and casts them at the call site; the port holds them in the config
  dtype already, which rounds them the same way once, so the result is
  the same — the cast is then a no-op.

Attention is the kernels: :func:`attention_scores_blockwise` keeps the
reference's name and calls K3 (``kernels/flash_attention``); the
reference's ``decode_attention_jnp`` has its counterpart in K4's wrapper,
``kernels.decode_attention.ops.decode_attention_cache``, which
``models/decode.py`` calls.  On CPU tensors each runs its plain version.
MLA and MoE are not ported (ROADMAP port queue item 25).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops

_NOT_PORTED = "not ported to repro_torch yet: ROADMAP port queue item 25 (LLM side stack)"


# --------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_init(dim: int, norm_type: str = "rmsnorm", device=None) -> dict[str, torch.Tensor]:
    """f32 scale (and bias for layernorm), as the reference stores them."""
    params = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if norm_type != "rmsnorm":
        params["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return params


def apply_norm(p, x: torch.Tensor, norm_type: str = "rmsnorm") -> torch.Tensor:
    """``p``: a ``transformer.Norm`` (``scale``, and ``bias`` for layernorm)."""
    if p.bias is not None:
        return layernorm(x, p.scale, p.bias)
    return rmsnorm(x, p.scale)


# ---------------------------------------------------------------------- rope
def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., dim/2) f32."""
    half = dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(theta, exponent)  # a Python base: no host-to-device copy (and sync)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (S, hd/2) (or broadcastable)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ----------------------------------------------------------------- attention
def attention_scores_blockwise(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KVH, hd)
    v: torch.Tensor,  # (B, S, KVH, hd)
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash attention over the model's layout -> (B, S, H, hd) in q's dtype.

    K3 (``csrc/flash_attention.cu``) on the card; on the CPU its plain
    version, which mirrors the reference's dense / blockwise branches.  The
    reference's ``block`` (its KV block) has no counterpart: the kernel has
    its own tiles, and every choice computes the same function."""
    if k.shape[1] != q.shape[1] or v.shape[-1] != q.shape[-1]:
        # cross attention (S_k != S_q) and MLA's value width belong to the
        # enc-dec and MLA paths
        raise NotImplementedError(f"attention with S_k != S_q or dv != hd is {_NOT_PORTED}")
    return flash_ops.flash_attention_bshd(q, k, v, causal=causal, window=window, scale=scale)


# ------------------------------------------------------------- GQA attention
def gqa_project_qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KVH,hd) with rope + qk-norm."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = (x @ p.wq.to(dt)).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p.wk.to(dt)).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p.wv.to(dt)).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm.scale)
        k = rmsnorm(k, p.k_norm.scale)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def gqa_apply(p, cfg, x: torch.Tensor, positions: torch.Tensor, causal: bool = True,
              window: int | None = None) -> torch.Tensor:
    """Full-sequence GQA attention (forward / prefill)."""
    b, s, _ = x.shape
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    out = attention_scores_blockwise(q, k, v, causal=causal, window=window)
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return out @ p.wo.to(x.dtype)


def mla_apply(*args, **kwargs):
    raise NotImplementedError(f"MLA attention is {_NOT_PORTED}")


# ----------------------------------------------------------------------- MLP
def mlp_apply(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    dt = x.dtype
    g = x @ p.w_gate.to(dt)
    u = x @ p.w_up.to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * u) @ p.w_down.to(dt)


def moe_apply(*args, **kwargs):
    raise NotImplementedError(f"MoE is {_NOT_PORTED}")
