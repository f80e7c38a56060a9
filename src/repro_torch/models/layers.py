"""Core layers of the port: norms, RoPE, GQA and MLA attention, SwiGLU MLP,
MoE.

``repro.models.layers`` as functions over the parameter modules of
``models/transformer.py`` (``p.wq`` where the reference reads
``params["wq"]``).  Compute runs in the config dtype with
f32 norms, rope and softmax, at the reference's rounding points:

* norms upcast to f32 and cast back (``rmsnorm``, ``layernorm``);
* rope works in f32 and casts back to x's dtype;
* a projection is ``x @ w.to(x.dtype)``.  The reference keeps f32 weights
  and casts them at the call site; the port holds them in the config
  dtype already, which rounds them the same way once, so the result is
  the same — the cast is then a no-op.  The MoE router is the exception:
  the reference multiplies f32 activations by its f32 router, so the
  port keeps the router in f32.

Attention is the kernels: :func:`attention_scores_blockwise` keeps the
reference's name and calls K3 (``kernels/flash_attention``); the
reference's ``decode_attention_jnp`` has its counterpart in K4's wrapper,
``kernels.decode_attention.ops.decode_attention_cache``, which
``models/decode.py`` calls.  On CPU tensors each runs its plain version.
MLA's full-sequence attention is K3 at q/k width 192 and v width 128; its
absorbed decode (``models/decode.py``) is plain torch, as the reference
computes it in jnp.

MoE is the reference's single-device dispatch (:func:`moe_apply`); its
expert-parallel ``shard_map`` branch belongs to the mesh (ROADMAP item
23).  :func:`moe_aux_loss` is the reference's load-balancing loss, which
the reference defines and its train step does not call.  The dispatch makes no host sync,
so a decode step with MoE layers can be captured as one CUDA graph
(``serving/engine.py``): no ``bincount``, ``nonzero``, boolean-mask
indexing, ``repeat_interleave`` with tensor repeats or ``.item()``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops

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
    k: torch.Tensor,  # (B, S_k, KVH, hd)
    v: torch.Tensor,  # (B, S_k, KVH, dv) — dv != hd for MLA
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash attention over the model's layout -> (B, S, H, dv) in q's dtype.

    K3 (``csrc/flash_attention.cu``) on the card; on the CPU its plain
    version, which mirrors the reference's dense / blockwise branches.  The
    key length S_k is S but in cross attention (whisper's decoder over its
    encoder frames).  The reference's ``block`` (its KV block) has no
    counterpart: the kernel has its own tiles, and every choice computes
    the same function."""
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


# ---------------------------------------------------------------- MLA (DSv2)
def mla_compress(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Host of the MLA cache: x -> (c_kv (B,S,R), k_rope (B,S,rope_hd))."""
    dt = x.dtype
    kv = x @ p.wkv_a.to(dt)
    c_kv, k_rope = kv.split([cfg.kv_lora_rank, cfg.rope_head_dim], dim=-1)
    c_kv = rmsnorm(c_kv, p.kv_norm.scale)
    cos, sin = rope_cos_sin(positions, cfg.rope_head_dim, cfg.rope_theta)
    k_rope = apply_rope(k_rope[..., None, :], cos, sin)[..., 0, :]
    return c_kv, k_rope


def mla_queries(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,D) -> q_nope (B,S,H,nope_hd), q_rope (B,S,H,rope_hd)."""
    b, s, _ = x.shape
    dt = x.dtype
    if cfg.q_lora_rank:
        q = rmsnorm(x @ p.wq_a.to(dt), p.q_norm.scale) @ p.wq_b.to(dt)
    else:
        q = x @ p.wq.to(dt)
    q = q.reshape(b, s, cfg.num_heads, cfg.nope_head_dim + cfg.rope_head_dim)
    q_nope, q_rope = q.split([cfg.nope_head_dim, cfg.rope_head_dim], dim=-1)
    cos, sin = rope_cos_sin(positions, cfg.rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def mla_expand_kv(p, cfg, c_kv: torch.Tensor):
    """c_kv (B,S,R) -> k_nope (B,S,H,nope_hd), v (B,S,H,v_hd), views of one
    product."""
    b, s, _ = c_kv.shape
    kv = (c_kv @ p.wkv_b.to(c_kv.dtype)).reshape(b, s, cfg.num_heads, cfg.nope_head_dim + cfg.v_head_dim)
    return kv.split([cfg.nope_head_dim, cfg.v_head_dim], dim=-1)


def mla_apply_with_latent(p, cfg, x: torch.Tensor, positions: torch.Tensor, causal: bool = True,
                          window: int | None = None):
    """Full-sequence MLA attention -> (output (B,S,D), c_kv, k_rope): the
    output of :func:`mla_apply` and the compressed rows prefill caches.
    Attention is K3 at q/k width nope + rope (192 at full width) and v
    width v_hd (128)."""
    b, s, _ = x.shape
    q_nope, q_rope = mla_queries(p, cfg, x, positions)
    c_kv, k_rope = mla_compress(p, cfg, x, positions)
    k_nope, v = mla_expand_kv(p, cfg, c_kv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, cfg.num_heads, cfg.rope_head_dim)], dim=-1)
    scale = (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5
    out = attention_scores_blockwise(q, k, v, causal=causal, window=window, scale=scale)
    out = out.reshape(b, s, cfg.num_heads * cfg.v_head_dim)
    return out @ p.wo.to(x.dtype), c_kv, k_rope


def mla_apply(p, cfg, x: torch.Tensor, positions: torch.Tensor, causal: bool = True,
              window: int | None = None) -> torch.Tensor:
    """Full-sequence MLA attention (forward / prefill)."""
    return mla_apply_with_latent(p, cfg, x, positions, causal, window)[0]


# ----------------------------------------------------------------------- MLP
def mlp_apply(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    dt = x.dtype
    g = x @ p.w_gate.to(dt)
    u = x @ p.w_up.to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * u) @ p.w_down.to(dt)


# ----------------------------------------------------------------------- MoE
def moe_capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens (the reference's formula)."""
    k = cfg.experts_per_token
    return max(int(cfg.moe_capacity_factor * t * k / cfg.num_experts), min(t * k, 8))


def moe_gates(xt: torch.Tensor, router: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's experts: f32 router softmax, top-k, the k weights
    renormalised by max(sum, 1e-9), as the reference -> (w (T, k) f32,
    idx (T, k))."""
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)  # (T, E)
    w, idx = torch.topk(gates, k, dim=-1)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx


def moe_route(xt: torch.Tensor, router: torch.Tensor, e: int, k: int, cap: int):
    """Token-choice top-k routing of ``xt`` (T, D) over ``e`` experts.

    Returns (flat_w (T·k,) f32 gate weights, keep (T·k,) bool, slot (T·k,)
    int64): assignment ``n = t·k + j`` is token t's j-th expert
    (:func:`moe_gates`); it is kept when it ranks below ``cap`` among its
    expert's assignments in that order (a stable argsort), and then fills
    row ``slot`` of the expert buffer (expert · cap + rank); a dropped one
    points at row e · cap, one past the buffer."""
    n = xt.shape[0] * k
    w, idx = moe_gates(xt, router, k)
    flat_e, flat_w = idx.reshape(n), w.reshape(n)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # counts by scatter_add_ (torch.bincount reads its max on the host)
    counts = torch.zeros(e, dtype=torch.int64, device=xt.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    ranks_sorted = torch.arange(n, device=xt.device) - starts[sorted_e]
    pos = torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, torch.full_like(pos, e * cap))
    return flat_w, keep, slot


def _moe_dispatch_compute(xt: torch.Tensor, router: torch.Tensor, experts, e: int, k: int, cap: int,
                          act: str, dt: torch.dtype) -> torch.Tensor:
    """Dispatch ``xt`` (T, D) into an (E·cap, D) buffer, run every expert's
    FFN as three batched products, and combine -> (T, D) in ``dt``.

    The buffer has one row more, row E·cap, where every dropped assignment
    writes (the reference's ``mode="drop"`` scatter); it is sliced off
    before the products, so its value (written by colliding indices) is
    never read."""
    t, d = xt.shape
    flat_w, keep, slot = moe_route(xt, router, e, k, cap)
    token_of = torch.arange(t * k, device=xt.device) // k
    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=xt.device)
    buf.index_copy_(0, slot, xt[token_of].to(dt))
    buf = buf[: e * cap].view(e, cap, d)
    g = torch.bmm(buf, experts.w_gate.to(dt))
    u = torch.bmm(buf, experts.w_up.to(dt))
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    out_buf = torch.bmm(g * u, experts.w_down.to(dt)).view(e * cap, d)
    zero = torch.zeros((), dtype=dt, device=xt.device)
    gathered = torch.where(keep[:, None], out_buf[slot.clamp(max=e * cap - 1)], zero)
    return (gathered * flat_w[:, None].to(dt)).view(t, k, d).sum(dim=1)


def moe_apply(p, cfg, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Token-choice top-k MoE with per-expert capacity (Switch-style), the
    reference's single-device path: every expert's FFN runs over its
    ``cap`` buffer rows, and the shared experts (``n_shared · d_ff`` wide)
    are one more MLP over every token."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    y = _moe_dispatch_compute(xt, p.router, p.experts, cfg.num_experts, cfg.experts_per_token,
                              moe_capacity(cfg, t), act, x.dtype)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, xt, act)
    return y.reshape(b, s, d)


def moe_aux_loss(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch/OLMoE style), f32:
    ``E * Σ_e frac_e prob_e``, frac_e the share of the top-k assignments
    that go to expert e (counted by ``scatter_add_``, no host sync) and
    prob_e the mean router probability of e.  ``p``: a ``transformer.MoE``."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    gates = torch.softmax(x.reshape(b * s, d).float() @ p.router.float(), dim=-1)
    idx = torch.topk(gates, k, dim=-1).indices.reshape(-1)
    frac = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, idx, torch.ones(idx.shape, dtype=torch.float32, device=x.device)) / (b * s * k)
    prob = gates.mean(dim=0)
    return e * torch.sum(frac * prob)
