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

Inside a training mesh's tensor shard (``sharding.tensor_shard``: a data
shard's model group, each device holding its slice of every "model"-ruled
leaf) attention runs on each model device's whole heads
(:func:`gqa_tp`, MLA's :func:`mla_tp_latent`) and the MLP on its columns, each
with its input broadcast to the group and its partial outputs summed with
the ring on the lead (Megatron's f and g); a layer whose heads do not
split over the group runs on the lead over its leaves gathered
(``TensorShard.whole``).

MoE (:func:`moe_apply`) is the reference's single-device dispatch, and
under a current mesh with "model" and rules set, its expert-parallel
branch, taken under exactly the reference's condition: each data shard's
tokens are broadcast to the shard's model devices, each routes them to
its own E/TP experts on its stream (``local_expert_range``), and the
partial outputs are summed over "model" with the ring
(``distributed/collectives.py``).  :func:`moe_aux_loss` is the
reference's load-balancing loss, which the reference defines and its
train step does not call.  The dispatch makes no host sync,
so a decode step with MoE layers can be captured as one CUDA graph
(``serving/engine.py``): no ``bincount``, ``nonzero``, boolean-mask
indexing, ``repeat_interleave`` with tensor repeats or ``.item()``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
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
def project_heads(p, cfg, x, kv_x, wq, wk, wv, positions):
    """x @ wq and kv_x @ wk / wv as heads of ``hd`` (as many as the
    matrices' columns hold), with qk-norm and rope when ``positions`` is
    given (self attention; cross attention has neither)."""
    b, s, _ = x.shape
    hd, dt = cfg.resolved_head_dim, x.dtype
    q = (x @ wq.to(dt)).reshape(b, s, -1, hd)
    k = (kv_x @ wk.to(dt)).reshape(b, kv_x.shape[1], -1, hd)
    v = (kv_x @ wv.to(dt)).reshape(b, kv_x.shape[1], -1, hd)
    if positions is None:
        return q, k, v
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm.scale)
        k = rmsnorm(k, p.k_norm.scale)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_project_qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KVH,hd) with rope + qk-norm."""
    return project_heads(p, cfg, x, x, p.wq, p.wk, p.wv, positions)


def heads_split(cfg, tp: int) -> bool:
    """Attention runs on each of ``tp`` model devices' whole heads: the
    query heads split evenly, and each device's share keeps GQA's map onto
    its KV heads (whole groups, or a part of one group)."""
    h = cfg.num_heads
    if h % tp:
        return False
    local, group = h // tp, h // cfg.num_kv_heads
    return local % group == 0 or group % local == 0


def tp_kv_heads(cfg, tp: int, m: int) -> tuple[int, int]:
    """(first, count) of the KV heads that model device ``m`` of ``tp``
    reads (:func:`heads_split` holds): its own slice's when the KV heads
    split over ``tp``, else the one KV head its query heads, a part of one
    group, map to."""
    local, group = cfg.num_heads // tp, cfg.num_heads // cfg.num_kv_heads
    return m * local // group, max(local // group, 1)


def tp_kv_weights(p, cfg, shard) -> list:
    """Per device of ``shard``'s model group, the columns of ``wk`` and
    ``wv`` for its KV heads (:func:`tp_kv_heads`): its own slices when the
    KV heads split over the group, else those columns of the leaves
    gathered whole on every device."""
    if cfg.num_kv_heads % shard.tp == 0:
        return [(pm.wk, pm.wv) for pm in shard.members(p)]
    hd = cfg.resolved_head_dim
    wks, wvs = shard.gather(p.wk), shard.gather(p.wv)
    out = []
    for m, (wk, wv) in enumerate(zip(wks, wvs)):
        lo, n = tp_kv_heads(cfg, shard.tp, m)
        out.append((wk[:, lo * hd:(lo + n) * hd], wv[:, lo * hd:(lo + n) * hd]))
    return out


def gqa_tp_kv(p, cfg, x: torch.Tensor, positions, causal: bool, window: int | None, shard,
              kv_x: torch.Tensor | None = None) -> tuple[torch.Tensor, list]:
    """GQA attention head-parallel over ``shard``'s model group
    (``sharding.TensorShard``; :func:`heads_split` holds): ``x`` (and the
    cross attention's keys' source ``kv_x``, whose attention has no rope)
    broadcast to the group, device m projecting its H/TP query heads with
    its column slice of ``wq`` and its KV heads (:func:`tp_kv_weights`),
    running K3 on them, and multiplying by its row slice of ``wo``; the
    partial outputs summed with the ring on the lead.  Returns (that sum,
    per device its (k, v), (B, S_k, n, hd) after rope, on that device:
    what prefill writes into its cache slice)."""
    b, s, _ = x.shape
    hd, dt, local = cfg.resolved_head_dim, x.dtype, cfg.num_heads // shard.tp
    devices = shard.devices
    xs = C.broadcast(x, devices)
    kvs = xs if kv_x is None else C.broadcast(kv_x, devices)
    parts, kv_out = [], []
    for dev, pm, (wk, wv), xm, kvm in zip(devices, shard.members(p), tp_kv_weights(p, cfg, shard), xs, kvs):
        with dev.scope():
            q, k, v = project_heads(pm, cfg, xm, kvm, pm.wq, wk, wv, positions if kv_x is None else None)
            out = attention_scores_blockwise(q, k, v, causal=causal, window=window)
            parts.append(out.reshape(b, s, local * hd) @ pm.wo.to(dt))
            kv_out.append((k, v))
    return C.ring_sum(parts, devices), kv_out


def gqa_tp(p, cfg, x: torch.Tensor, positions, causal: bool, window: int | None, shard,
           kv_x: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`gqa_tp_kv`'s summed output alone."""
    return gqa_tp_kv(p, cfg, x, positions, causal, window, shard, kv_x)[0]


def gqa_apply(p, cfg, x: torch.Tensor, positions: torch.Tensor, causal: bool = True,
              window: int | None = None) -> torch.Tensor:
    """Full-sequence GQA attention (forward / prefill).  Inside a training
    mesh's tensor shard (``sharding.tensor_shard``) head-parallel
    (:func:`gqa_tp`), or, when the heads do not split, on the lead over the
    gathered leaves."""
    shard = S.current_tensor_shard()
    if shard is not None and shard.is_split(p):
        if heads_split(cfg, shard.tp):
            return gqa_tp(p, cfg, x, positions, causal, window, shard)
        p = shard.whole(p)
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


def mla_tp_latent(p, cfg, x: torch.Tensor, positions: torch.Tensor, causal: bool, window: int | None,
                  shard) -> tuple[torch.Tensor, list]:
    """MLA head-parallel over ``shard``'s model group: the lead computes
    the replicated compressions (``wq_a`` -> ``q_norm``, ``wkv_a`` ->
    ``kv_norm``, k_rope), broadcast to the group; device m expands its
    H/TP heads with its column slices of ``wq_b`` (or ``wq``) and
    ``wkv_b`` (head-major columns: whole heads), runs K3 on them and
    multiplies by its row slice of ``wo``; the partial outputs summed with
    the ring on the lead.  Returns (that sum, per device its copy of
    (c_kv (B, S, R), k_rope (B, S, rope_hd)): what prefill writes into its
    slice of the latent cache)."""
    b, s, _ = x.shape
    dt, local = x.dtype, cfg.num_heads // shard.tp
    q_in = rmsnorm(x @ p.wq_a.to(dt), p.q_norm.scale) if cfg.q_lora_rank else x
    c_kv, k_rope = mla_compress(p, cfg, x, positions)
    devices = shard.devices
    cos, sin = rope_cos_sin(positions, cfg.rope_head_dim, cfg.rope_theta)
    parts, latent = [], []
    for dev, pm, qm, cm, rm in zip(devices, shard.members(p), C.broadcast(q_in, devices),
                                   C.broadcast(c_kv, devices), C.broadcast(k_rope, devices)):
        with dev.scope():
            q = (qm @ (pm.wq_b if cfg.q_lora_rank else pm.wq).to(dt)).reshape(
                b, s, local, cfg.nope_head_dim + cfg.rope_head_dim)
            q_nope, q_rope = q.split([cfg.nope_head_dim, cfg.rope_head_dim], dim=-1)
            kv = (cm @ pm.wkv_b.to(dt)).reshape(b, s, local, cfg.nope_head_dim + cfg.v_head_dim)
            k_nope, v = kv.split([cfg.nope_head_dim, cfg.v_head_dim], dim=-1)
            q = torch.cat([q_nope, apply_rope(q_rope, cos, sin)], dim=-1)
            k = torch.cat([k_nope, rm[:, :, None, :].expand(b, s, local, cfg.rope_head_dim)], dim=-1)
            scale = (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5
            out = attention_scores_blockwise(q, k, v, causal=causal, window=window, scale=scale)
            parts.append(out.reshape(b, s, local * cfg.v_head_dim) @ pm.wo.to(dt))
            latent.append((cm, rm))
    return C.ring_sum(parts, devices), latent


def mla_apply(p, cfg, x: torch.Tensor, positions: torch.Tensor, causal: bool = True,
              window: int | None = None) -> torch.Tensor:
    """Full-sequence MLA attention (forward / prefill).  Inside a training
    mesh's tensor shard head-parallel (:func:`mla_tp_latent`), or, when the heads
    do not split, on the lead over the gathered leaves."""
    shard = S.current_tensor_shard()
    if shard is not None and shard.is_split(p):
        if cfg.num_heads % shard.tp == 0:
            return mla_tp_latent(p, cfg, x, positions, causal, window, shard)[0]
        p = shard.whole(p)
    return mla_apply_with_latent(p, cfg, x, positions, causal, window)[0]


# ----------------------------------------------------------------------- MLP
def _swiglu(p, x: torch.Tensor, act: str) -> torch.Tensor:
    dt = x.dtype
    g = x @ p.w_gate.to(dt)
    u = x @ p.w_up.to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * u) @ p.w_down.to(dt)


def mlp_apply(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The gated MLP.  Inside a training mesh's tensor shard column- then
    row-parallel: ``x`` broadcast to the model group, device m's MLP over
    its column slices of ``w_gate``/``w_up`` and row slice of ``w_down``,
    the partial outputs summed with the ring on the lead."""
    shard = S.current_tensor_shard()
    if shard is None or not shard.is_split(p):
        return _swiglu(p, x, act)
    parts = []
    for dev, pm, xm in zip(shard.devices, shard.members(p), C.broadcast(x, shard.devices)):
        with dev.scope():
            parts.append(_swiglu(pm, xm, act))
    return C.ring_sum(parts, shard.devices)


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
                          act: str, dt: torch.dtype, local_expert_range=None) -> torch.Tensor:
    """Dispatch ``xt`` (T, D) into an (E·cap, D) buffer, run every expert's
    FFN as three batched products, and combine -> (T, D) in ``dt``.

    With ``local_expert_range=(lo, n_local)`` only experts lo..lo+n_local
    run (``experts`` holds just those): an assignment is "mine" when it is
    kept and its expert is in the range, fills row (expert - lo)·cap +
    rank, and every other one points at row n_local·cap, as the
    reference's out-of-range slot; the caller sums the partial outputs
    over the expert groups.

    The buffer has one row more, the out-of-range row, where every dropped
    assignment writes (the reference's ``mode="drop"`` scatter); it is
    sliced off before the products, so its value (written by colliding
    indices) is never read, and the reference's zeroing of the rows that
    are not mine changes nothing."""
    t, d = xt.shape
    flat_w, keep, slot = moe_route(xt, router, e, k, cap)
    rows = e * cap
    if local_expert_range:
        lo, n_local = local_expert_range
        rows = n_local * cap
        local = slot - lo * cap
        keep = keep & (local >= 0) & (local < rows)  # mine
        slot = torch.where(keep, local, torch.full_like(local, rows))
    token_of = torch.arange(t * k, device=xt.device) // k
    buf = torch.zeros((rows + 1, d), dtype=dt, device=xt.device)
    buf.index_copy_(0, slot, xt[token_of].to(dt))
    buf = buf[:rows].view(rows // cap, cap, d)
    g = torch.bmm(buf, experts.w_gate.to(dt))
    u = torch.bmm(buf, experts.w_up.to(dt))
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    out_buf = torch.bmm(g * u, experts.w_down.to(dt)).view(rows, d)
    zero = torch.zeros((), dtype=dt, device=xt.device)
    gathered = torch.where(keep[:, None], out_buf[slot.clamp(max=rows - 1)], zero)
    return (gathered * flat_w[:, None].to(dt)).view(t, k, d).sum(dim=1)


def _expert_parallel(cfg, b: int, s: int):
    """(mesh, its data axes, data size) when the reference would take its
    expert-parallel branch for a (b, s) input — rules set, a current mesh
    with "model", experts divisible over it, and at least 256 tokens a
    data shard — else None.  Inside a training-mesh shard ``b`` is the
    shard's rows; a shard of a data-split mesh that the reference would
    route over the whole batch raises (its routing spans the shards)."""
    rules, mesh = S.get_rules(), S.current_mesh()
    in_shard = S.current_expert_shard() is not None
    data_axes, data_size = S.data_axes_and_size(mesh, rules) if mesh is not None else ((), 1)
    b_global = b * data_size if in_shard else b
    use_ep = (
        rules is not None
        and mesh is not None
        and "model" in mesh.shape
        and cfg.num_experts % mesh.shape["model"] == 0
        and b_global % data_size == 0
        and b_global >= data_size
        and (b_global // data_size) * s >= 256
    )
    if use_ep:
        return mesh, data_axes, data_size
    if in_shard and data_size > 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE routing over the whole batch of a data-split mesh (no expert-parallel branch: "
            f"{b_global} x {s} tokens over {data_size} data shards) is not ported; the training mesh runs MoE "
            "layers through the expert-parallel branch only")
    return None


def _expert_members(p) -> list:
    """The current expert shard's (``sharding.expert_shard``) members for
    MoE module ``p``: per model device (device, router, its experts), the
    router gathered on every device where it is stored split over
    "model" (under FSDP: the gathered leaves)."""
    members = [(dev, m.router, m.experts) for dev, m in S.current_expert_shard()[p]]
    shard = S.current_tensor_shard()
    if shard is not None and shard.is_split(p.router):
        members = [(dev, router, experts) for (dev, _, experts), router in zip(members, shard.gather(p.router))]
    return members


def _moe_over_group(xt: torch.Tensor, members: list, cfg, cap: int, n_local: int, act: str,
                    dt: torch.dtype) -> torch.Tensor:
    """Tokens ``xt`` (T, D) broadcast to ``members`` (model order), device m
    routing all of them at capacity ``cap`` to its experts m·n_local ..
    (m+1)·n_local - 1 on its stream; the partial outputs summed with the
    ring on the first."""
    e, k = cfg.num_experts, cfg.experts_per_token
    devices = [dev for dev, _, _ in members]
    parts = []
    for m, ((dev, router, experts), xm) in enumerate(zip(members, C.broadcast(xt, devices))):
        with dev.scope():
            parts.append(_moe_dispatch_compute(xm, router, experts, e, k, cap, act, dt,
                                               local_expert_range=(m * n_local, n_local)))
    return C.ring_sum(parts, devices)


def _moe_apply_ep(p, cfg, x: torch.Tensor, act: str, mesh, data_axes, data_size: int) -> torch.Tensor:
    """The expert-parallel branch: per data shard, its tokens broadcast to
    the shard's model devices, device m routing them to experts
    m·E/TP .. (m+1)·E/TP - 1 on its stream, the partial outputs summed
    with the ring; capacity per data shard's tokens, as the reference's.
    Off a training shard ``x`` is the whole batch and each device uses a
    slice of ``p``'s experts; in one, ``x`` is the shard's rows and each
    device its own copy's."""
    b, s, d = x.shape
    n_local = cfg.num_experts // mesh.shape["model"]
    xt = x.reshape(b * s, d)
    if S.current_expert_shard() is not None:
        t_local = b * s
        shards = [(xt, _expert_members(p))]
    else:
        t_local = (b // data_size) * s
        sliced = [SimpleNamespace(**{name: getattr(p.experts, name)[m * n_local:(m + 1) * n_local]
                                     for name in ("w_gate", "w_up", "w_down")})
                  for m in range(mesh.shape["model"])]
        shards = [(xt[i * t_local:(i + 1) * t_local], [(dev, p.router, sliced[m]) for m, dev in enumerate(devs)])
                  for i, devs in enumerate(mesh.model_groups(data_axes))]
    cap = moe_capacity(cfg, t_local)
    ys = [_moe_over_group(x_shard, members, cfg, cap, n_local, act, x.dtype) for x_shard, members in shards]
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, xt, act)
    return y.reshape(b, s, d)


def moe_apply_whole(p, cfg, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``x`` (B, S, D) routed as one batch, one capacity over its B·S
    tokens — as the reference routes a data-split mesh's global batch
    below its expert-parallel threshold — on the current expert shard's
    model group (``sharding.expert_shard``; the caller gathered every data
    shard's rows on its lead): each model device routes every token to its
    own experts and the partial outputs are ring-summed, so rows move and
    the experts stay split."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    shard = S.current_tensor_shard()
    n_local = cfg.num_experts // (1 if shard is None else shard.tp)
    y = _moe_over_group(xt, _expert_members(p), cfg, moe_capacity(cfg, b * s), n_local, act, x.dtype)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, xt, act)
    return y.reshape(b, s, d)


def moe_apply(p, cfg, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Token-choice top-k MoE with per-expert capacity (Switch-style).  Off
    a mesh, the reference's single-device path: every expert's FFN runs
    over its ``cap`` buffer rows, and the shared experts (``n_shared ·
    d_ff`` wide) are one more MLP over every token; under a mesh, where
    the reference takes it, the expert-parallel branch
    (:func:`_moe_apply_ep`)."""
    b, s, d = x.shape
    ep = _expert_parallel(cfg, b, s)
    if ep is not None:
        return _moe_apply_ep(p, cfg, x, act, *ep)
    p = S.whole(p)  # in a tensor shard, router and experts gathered on the lead
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
