"""Serving paths of the port: cache init, prefill, and single-token decode.

``repro.models.decode`` for the dense-GQA, MoE, MLA, encoder-decoder,
VLM, hybrid and xLSTM families.  The cache is a dict of layer-stacked
tensors, as in the reference (:data:`CACHE_DIM_SEMANTICS` names each
leaf's axes):

  gqa    : k/v (L, B, S, KVH, hd)
  mla    : c_kv (L, B, S, R), k_rope (L, B, S, rope_hd) over the main
           layers, prefix_c_kv / prefix_k_rope over the dense-FFN prefix —
           the compressed cache, decoded in the absorbed form
           (:func:`_mla_decode`)
  encdec : the gqa self-attention cache + the encoder's cross K/V,
           cross_k/cross_v (L, B, S_enc, KVH, hd), written by prefill and
           read-only in decode
  vlm    : the gqa cache; prefill runs the projected patch embeddings
           ahead of the prompt, so they fill its first rows
  hybrid : the gqa cache + Mamba's ssm (L, B, D_in, N) f32 and conv
           (L, B, conv - 1, D_in) states
  xlstm  : mlstm_c (L, B, H, hd, hd), mlstm_n (L, B, H, hd) and
           slstm_h/c/n/m (L, B, D), all f32 and with no sequence axis: an
           mLSTM layer leaves its sLSTM state at zero and the other way

What differs:

* **In place.**  The reference's cache is immutable: the decode scan
  returns each layer's slice with the new row scattered in.  Here
  :func:`decode_step` writes the new row into ``cache["k"][l]`` /
  ``cache["v"][l]`` in place and returns the same dict, and
  :func:`prefill` writes each layer's rows into one cache allocated up
  front.  A write at a position past the cache is dropped, as JAX drops an
  out-of-bounds scatter (an idle serving slot's length keeps counting).
  The recurrent states (:data:`RECURRENT`) are written in place too
  (``copy_``), every step, whatever the lengths.
* **Kernels.**  Prefill attention is K3 (the encoder's non-causal, the
  cross attention's with S_k = S_enc) and GQA decode attention is K4
  (the cross attention's with every length S_enc), which reads each layer
  slice through its strides: no step copies the cache.  Mamba's scan is
  K6 (``models/ssm.py``).  MLA's absorbed decode, the mLSTM and the sLSTM
  are plain torch in f32, as the reference computes them in jnp.
* **Capturable.**  :func:`decode_step` makes no host sync and keeps every
  buffer it reads in place, so ``serving/engine.py`` captures it as one
  CUDA graph.
* ``lax.scan`` over layers and ``lax.cond`` on ``is_local`` become a
  Python loop and a Python branch.
* **On a mesh.**  The reference lowers the same functions under GSPMD on
  any mesh.  Here :func:`make_mesh_prefill` and
  :func:`make_mesh_decode_step` drive the logical devices of a mesh
  explicitly, as the training mesh does: the weights placed under the
  serving specs (``zero.place_params``), the cache split by heads over
  "model" and by rows over the data axes (:func:`cache_pspecs`,
  :func:`init_mesh_cache`, :func:`place_cache`), attention head-parallel
  on each model device's cache slice; or, where the heads do not split,
  the cache split by sequence, each device running K4 over its keys and
  the partial softmaxes merged by their log-sum-exp
  (:func:`_gqa_decode_seq`).  MLA's latent cache, which has no head dim,
  splits by sequence beside its heads over "model": prefill runs K3 on
  each device's heads (``layers.mla_tp_latent``) and decode the absorbed
  form head-parallel, each device scoring every head against its own keys
  (:func:`_mla_decode_tp`), so no weight moves.  The recurrent states
  (the xLSTM's, hymba's Mamba states beside its attention cache) are held
  as the reference's specs place them, a state's heads and channels over
  "model" where they split evenly, else whole on each model device; each
  layer's recurrent branch runs on the data shard's lead and writes every
  holder's slice or replica (:meth:`_MeshServing.recur`).  An
  encoder-decoder's encoder runs on each data shard's model group, and its
  cross K/V cache is split by heads beside a head-split self-attention
  cache, else whole on each model device (the encoder's sequence is never
  split).  What they do not serve yet raises (:func:`mesh_serving_gap`).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def kv_cache_heads(cfg: ModelConfig, kv_repeat: int = 1) -> int:
    return cfg.num_kv_heads * kv_repeat


# Semantic dimension labels per cache leaf (the reference's).
CACHE_DIM_SEMANTICS: dict[str, tuple[str, ...]] = {
    "k": ("layers", "batch", "seq", "kv_heads", "head"),
    "v": ("layers", "batch", "seq", "kv_heads", "head"),
    "c_kv": ("layers", "batch", "seq", "rank"),
    "k_rope": ("layers", "batch", "seq", "rank"),
    "prefix_c_kv": ("layers", "batch", "seq", "rank"),
    "prefix_k_rope": ("layers", "batch", "seq", "rank"),
    "ssm": ("layers", "batch", "inner", "state"),
    "conv": ("layers", "batch", "window", "inner"),
    "mlstm_c": ("layers", "batch", "rec_heads", "hd", "hd"),
    "mlstm_n": ("layers", "batch", "rec_heads", "hd"),
    "slstm_h": ("layers", "batch", "inner"),
    "slstm_c": ("layers", "batch", "inner"),
    "slstm_n": ("layers", "batch", "inner"),
    "slstm_m": ("layers", "batch", "inner"),
    "cross_k": ("layers", "batch", "enc_seq", "kv_heads", "head"),
    "cross_v": ("layers", "batch", "enc_seq", "kv_heads", "head"),
}

# the leaves every decode step rewrites whole, whatever the lengths
RECURRENT = frozenset(k for k, dims in CACHE_DIM_SEMANTICS.items() if "seq" not in dims and "enc_seq" not in dims)


def cache_leaves(
    cfg: ModelConfig, batch: int, max_len: int, kv_repeat: int = 1, dtype: torch.dtype = torch.bfloat16,
    cross_dtype: torch.dtype | None = None,
) -> dict[str, tuple[tuple, torch.dtype]]:
    """:func:`init_cache`'s leaves as {name: (shape, dtype)}, in its order,
    nothing allocated (a trace counts what a meta tensor holds)."""
    T.check_supported(cfg)
    kind = T.main_block_kind(cfg)
    n, f32 = cfg.num_layers, torch.float32
    if kind == "xlstm":
        d, mh = cfg.d_model, cfg.num_heads
        mhd = 2 * d // mh
        out = {"mlstm_c": ((n, batch, mh, mhd, mhd), f32), "mlstm_n": ((n, batch, mh, mhd), f32)}
        out.update({name: ((n, batch, d), f32) for name in ssm.SLSTM_STATE})
        return out
    if cfg.attn_type != "mla":
        hd = cfg.resolved_head_dim
        shape = (cfg.num_layers, batch, max_len, kv_cache_heads(cfg, kv_repeat), hd)
        out = {"k": (shape, dtype), "v": (shape, dtype)}
        if kind == "hybrid":
            d_in = 2 * cfg.d_model
            out["ssm"] = ((n, batch, d_in, cfg.ssm_state), f32)
            out["conv"] = ((n, batch, cfg.ssm_conv - 1, d_in), dtype)
        if cfg.is_encdec:
            cross = (cfg.num_layers, batch, cfg.encoder_seq_len, cfg.num_kv_heads, hd)
            out["cross_k"] = out["cross_v"] = (cross, cross_dtype or dtype)
        return out
    n_prefix = cfg.first_dense_layers if cfg.is_moe else 0
    out = {}
    for prefix, n in (("", cfg.num_layers - n_prefix), ("prefix_", n_prefix)):
        if n:
            out[prefix + "c_kv"] = ((n, batch, max_len, cfg.kv_lora_rank), dtype)
            out[prefix + "k_rope"] = ((n, batch, max_len, cfg.rope_head_dim), dtype)
    return out


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, kv_repeat: int = 1,
    dtype: torch.dtype = torch.bfloat16, device: str | torch.device | None = "cuda",
    cross_dtype: torch.dtype | None = None,
) -> dict[str, torch.Tensor]:
    """Zero-filled cache for ``batch`` sequences of up to ``max_len``; the
    cross K/V of an encoder-decoder in ``cross_dtype`` (default ``dtype``);
    the recurrent states in f32, but the hybrid's conv window in ``dtype``
    (the xLSTM's take neither ``max_len`` nor ``dtype``)."""
    leaves = cache_leaves(cfg, batch, max_len, kv_repeat, dtype, cross_dtype)
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=dev) for name, (shape, dt) in leaves.items()}


def _layer_caches(params: T.TransformerLM, cache: dict):
    """(block, is_local, its cache slices by leaf name) for every layer in
    order: the dense prefix (MLA's prefix_c_kv / prefix_k_rope, named
    c_kv / k_rope), then the main layers (every leaf but the prefix's and
    the cross K/V)."""
    prefix = {k.removeprefix("prefix_"): v for k, v in cache.items() if k.startswith("prefix_")}
    main = {k: v for k, v in cache.items() if not k.startswith(("prefix_", "cross_"))}
    for i, blk in enumerate(params.dense_prefix or ()):
        yield blk, None, {k: v[i] for k, v in prefix.items()}
    for i, (blk, is_local) in enumerate(zip(params.layers, params.is_local)):
        yield blk, is_local, {k: v[i] for k, v in main.items()}


def _blocks(params: T.TransformerLM) -> list:
    """(the block list's name, its cache leaves' prefix, the index in it)
    for every layer in :func:`_layer_caches`' order: the dense prefix
    (MLA's prefix_c_kv / prefix_k_rope), then the main layers."""
    prefix = [("dense_prefix", "prefix_", i) for i in range(len(params.dense_prefix or ()))]
    return prefix + [("layers", "", i) for i in range(len(params.layers))]


def _at(cache: dict, at: tuple, *names) -> tuple:
    """A device's cache slices ``names`` of the layer ``at`` (its leaves'
    prefix, the index in its stack: :func:`_blocks`)."""
    prefix, layer = at
    return tuple(cache[prefix + name][layer] for name in names)


# ------------------------------------------------------------------ helpers
def _scatter_rows_(cache: torch.Tensor, rows: torch.Tensor, lengths: torch.Tensor) -> None:
    """cache (B, S, ...) <- rows (B, ...) at per-sequence positions, in
    place; positions >= S are dropped (JAX's scatter drops them too), and
    so are negative ones: a slice of a sequence-split cache holding keys
    [off, off + S) is written at ``lengths - off``, and only the slice
    that holds the position writes it."""
    b, s = cache.shape[:2]
    idx = torch.arange(b, device=cache.device)
    pos = lengths.clamp(min=0, max=s - 1)
    keep = ((lengths >= 0) & (lengths < s)).view(b, *([1] * (rows.dim() - 1)))
    cache[idx, pos] = torch.where(keep, rows.to(cache.dtype), cache[idx, pos])


def _gqa_decode(p_attn, cfg, x, k_cache, v_cache, lengths, window, kv_repeat):
    """x: (B, D); k/v_cache: this layer's (B, S, KVHe, hd) views of the
    stacked cache, updated in place."""
    bsz, _ = x.shape
    q, k, v = (t[:, 0] for t in L.gqa_project_qkv(p_attn, cfg, x[:, None], lengths[:, None]))
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=1)
        v = v.repeat_interleave(kv_repeat, dim=1)
    _scatter_rows_(k_cache, k, lengths)
    _scatter_rows_(v_cache, v, lengths)
    out = decode_ops.decode_attention_cache(q, k_cache, v_cache, lengths + 1, window=window)
    out = out.reshape(bsz, cfg.num_heads * cfg.resolved_head_dim)
    return out @ p_attn.wo.to(x.dtype)


def _mla_decode(p_attn, cfg, x, ckv_cache, krope_cache, lengths):
    """Absorbed-form MLA decode (DeepSeek-V2 inference scheme): scores
    combine q_nope·W_uk against c_kv and q_rope against k_rope, values are
    (probs @ c_kv)·W_uv, all in f32.  x: (B, D); the caches are this
    layer's (B, S, R) / (B, S, rope_hd) views, updated in place."""
    bsz, _ = x.shape
    dt = x.dtype
    nope, vd = cfg.nope_head_dim, cfg.v_head_dim
    q_nope, q_rope = L.mla_queries(p_attn, cfg, x[:, None, :], lengths[:, None])
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]  # (B, H, nope) / (B, H, rd)
    c_kv_new, k_rope_new = L.mla_compress(p_attn, cfg, x[:, None, :], lengths[:, None])
    _scatter_rows_(ckv_cache, c_kv_new[:, 0], lengths)
    _scatter_rows_(krope_cache, k_rope_new[:, 0], lengths)

    w_b = p_attn.wkv_b.to(dt).reshape(cfg.kv_lora_rank, cfg.num_heads, nope + vd)
    w_uk, w_uv = w_b[..., :nope].float(), w_b[..., nope:].float()  # (R, H, nope) / (R, H, v)
    ckv = ckv_cache.float()
    q_c = torch.einsum("bhn,rhn->bhr", q_nope.float(), w_uk)
    scores = torch.einsum("bhr,bsr->bhs", q_c, ckv)
    scores = scores + torch.einsum("bhr,bsr->bhs", q_rope.float(), krope_cache.float())
    scores = scores * (nope + cfg.rope_head_dim) ** -0.5
    pos = torch.arange(ckv.shape[1], device=x.device)
    scores = scores.masked_fill(pos[None, None, :] >= (lengths + 1)[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    o_c = torch.einsum("bhs,bsr->bhr", probs, ckv)
    out = torch.einsum("bhr,rhv->bhv", o_c, w_uv).to(dt)
    return out.reshape(bsz, cfg.num_heads * vd) @ p_attn.wo.to(dt)


def _window(cfg: ModelConfig, is_local) -> int | None:
    """The reference's choice: with a local/global pattern the flag picks;
    without one every layer takes ``cfg.sliding_window``."""
    if cfg.sliding_window is not None and is_local is not None:
        return cfg.sliding_window if is_local else None
    return cfg.sliding_window


def _lead_leaves(p, *names) -> list:
    """``p``'s leaves ``names`` whole on the lead: inside a tensor shard
    each one stored split is gathered there (``TensorShard.gather``), the
    others are ``p``'s own."""
    shard = S.current_tensor_shard()
    out = []
    for name in names:
        w = getattr(p, name)
        out.append(w if shard is None or not shard.is_split(w) else shard.gather(w, (0,))[0])
    return out


def _cross_decode(p_cross, cfg, x, cross_k, cross_v):
    """One cross-attention insertion, one token: K4 over this layer's
    (B, S_enc, KVH, hd) cross cache with every length S_enc, made on the
    device (no host copy: the step stays capturable).  Inside a tensor
    shard (a mesh's cross cache whole on each model device) it runs on the
    lead, ``wq`` and ``wo`` gathered there."""
    h = L.apply_norm(p_cross.norm, x, cfg.norm_type)
    bsz, _ = h.shape
    hd, dt = cfg.resolved_head_dim, h.dtype
    wq, wo = _lead_leaves(p_cross.attn, "wq", "wo")
    q = (h @ wq.to(dt)).reshape(bsz, cfg.num_heads, hd)
    lens = torch.full((bsz,), cross_k.shape[1], dtype=torch.int32, device=x.device)
    out = decode_ops.decode_attention_cache(q, cross_k, cross_v, lens)
    return x + out.reshape(bsz, cfg.num_heads * hd) @ wo.to(dt)


def _cross_decode_tp(p_cross, cfg, x, layer_caches: list, shard):
    """One token's cross attention head-parallel over ``shard``'s model
    group, over a cross cache split by heads: the normed ``x`` (B, D)
    broadcast, device m computing q for its H/TP heads from its columns
    of ``wq``, running K4 over its slice (``layer_caches[m]``: this
    layer's (B, S_enc, KVH/TP, hd) cross k and v) with every length S_enc
    and multiplying by its rows of ``wo``; the partial outputs summed with
    the ring on the lead.  Nothing is written."""
    h = L.apply_norm(p_cross.norm, x, cfg.norm_type)
    bsz, hd, local = h.shape[0], cfg.resolved_head_dim, cfg.num_heads // shard.tp
    parts = []
    for dev, pm, hm, (kc, vc) in zip(shard.devices, shard.members(p_cross.attn), C.broadcast(h, shard.devices),
                                     layer_caches):
        with dev.scope():
            q = (hm @ pm.wq.to(hm.dtype)).reshape(bsz, local, hd)
            lens = torch.full((bsz,), kc.shape[1], dtype=torch.int32, device=hm.device)
            out = decode_ops.decode_attention_cache(q, kc, vc, lens)
            parts.append(out.reshape(bsz, local * hd) @ pm.wo.to(hm.dtype))
    return x + C.ring_sum(parts, shard.devices)


def _write_(cache_l: dict, names, values) -> None:
    for name, value in zip(names, values):
        cache_l[name].copy_(value)


def _state_names(p) -> tuple:
    """The cache leaves block ``p``'s recurrent branch keeps: Mamba's
    (hybrid), the sLSTM's or the mLSTM's (xLSTM, by ``is_slstm``)."""
    if p.kind == "hybrid":
        return ("ssm", "conv")
    return ssm.SLSTM_STATE if p.is_slstm else ("mlstm_c", "mlstm_n")


def _recurrent(p, cfg, h, state=None):
    """Block ``p``'s recurrent branch (Mamba, or the xLSTM layer's sLSTM or
    mLSTM) over ``h``: the whole prompt (B, S, D) from zero with ``state``
    None, else one token (B, D) from ``state`` (its leaves by
    :func:`_state_names`) -> (y, the new state in that order).  Inside a
    tensor shard the branch's leaves are gathered whole on the lead
    (``sharding.whole``)."""
    if p.kind == "hybrid":
        m = S.whole(p.mamba)
        if state is None:
            return ssm.mamba_apply(m, h, cfg.ssm_state)
        return ssm.mamba_step(m, h, state["ssm"], state["conv"].to(h.dtype), cfg.ssm_state)
    if p.is_slstm:
        if state is None:
            return ssm.slstm_apply(S.whole(p.slstm), h, cfg.num_heads)
        return ssm.slstm_step(S.whole(p.slstm), h, tuple(state[k] for k in ssm.SLSTM_STATE))
    if state is None:
        return ssm.mlstm_apply(S.whole(p.mlstm), h, cfg.num_heads)
    return ssm.mlstm_step(S.whole(p.mlstm), h, state["mlstm_c"], state["mlstm_n"], cfg.num_heads)


def _block_decode(p, cfg, x, cache_l, is_local, lengths, kv_repeat):
    """One block, one token.  x: (B, D); cache_l: this layer's slices by
    leaf name, updated in place (the recurrent branch writes only its own
    leaves)."""
    if p.kind == "xlstm":
        y, state = _recurrent(p, cfg, L.apply_norm(p.pre_norm, x, cfg.norm_type), cache_l)
        _write_(cache_l, _state_names(p), state)
        return x + y
    h = L.apply_norm(p.attn_norm, x, cfg.norm_type)
    if cfg.attn_type == "mla":
        y = _mla_decode(p.attn, cfg, h, cache_l["c_kv"], cache_l["k_rope"], lengths)
    else:
        y = _gqa_decode(p.attn, cfg, h, cache_l["k"], cache_l["v"], lengths, _window(cfg, is_local), kv_repeat)
    if p.kind == "hybrid":
        m_out, state = _recurrent(p, cfg, h, cache_l)
        _write_(cache_l, _state_names(p), state)
        y = T.hybrid_mix(p, cfg, y, m_out)
    x = x + y
    h2 = L.apply_norm(p.mlp_norm, x, cfg.norm_type)
    return x + T.ffn(p, cfg, h2)


@torch.no_grad()
def decode_step(
    params: T.TransformerLM,
    cfg: ModelConfig,
    token,  # (B,) int
    cache: dict,
    lengths: torch.Tensor,  # (B,) int — cache fill before this token
    kv_repeat: int = 1,
) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """One decode step.  Returns (logits (B, V), the cache — updated in
    place —, new lengths)."""
    token = T.as_tokens(params, token)
    lengths = torch.as_tensor(lengths, device=token.device)
    x = T.embed_tokens(params, cfg, token[:, None])[:, 0]  # (B, D)
    for i, (blk, is_local, cache_l) in enumerate(_layer_caches(params, cache)):
        x = _block_decode(blk, cfg, x, cache_l, is_local, lengths, kv_repeat)
        if params.cross is not None:  # each decoder layer, then its cross layer
            x = _cross_decode(params.cross[i], cfg, x, cache["cross_k"][i], cache["cross_v"][i])
    logits = T.logits_from(params, cfg, x[:, None, :])[:, 0]
    return logits, cache, lengths + 1


# ------------------------------------------------------------------ prefill
def _gqa_prefill(p_attn, cfg, h, positions, window, k_cache, v_cache, kv_repeat):
    """GQA attention over the full prompt h (B, S, D); writes this layer's
    k / v rows (repeated ``kv_repeat`` times) into ``k_cache`` /
    ``v_cache`` (B, S_max, KVHe, hd)."""
    b, s, _ = h.shape
    q, k, v = L.gqa_project_qkv(p_attn, cfg, h, positions)
    out = L.attention_scores_blockwise(q, k, v, causal=True, window=window)
    y = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim) @ p_attn.wo.to(h.dtype)
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    k_cache[:, :s] = k
    v_cache[:, :s] = v
    return y


def _block_prefill(p, cfg, x, positions, is_local, cache_l, kv_repeat):
    """One block over the full prompt; writes this layer's cache: k / v
    (GQA) or c_kv / k_rope (MLA) rows, the hybrid's Mamba states, the
    xLSTM layer's mLSTM or sLSTM state (the other stays at zero)."""
    if p.kind == "xlstm":
        y, state = _recurrent(p, cfg, L.apply_norm(p.pre_norm, x, cfg.norm_type))
        _write_(cache_l, _state_names(p), state)
        return x + y
    h = L.apply_norm(p.attn_norm, x, cfg.norm_type)
    if cfg.attn_type == "mla":
        s = h.shape[1]
        y, c_kv, k_rope = L.mla_apply_with_latent(p.attn, cfg, h, positions, causal=True)
        cache_l["c_kv"][:, :s] = c_kv
        cache_l["k_rope"][:, :s] = k_rope
    else:
        y = _gqa_prefill(p.attn, cfg, h, positions, _window(cfg, is_local), cache_l["k"], cache_l["v"], kv_repeat)
    if p.kind == "hybrid":
        m_out, state = _recurrent(p, cfg, h)
        _write_(cache_l, _state_names(p), state)
        y = T.hybrid_mix(p, cfg, y, m_out)
    x = x + y
    h2 = L.apply_norm(p.mlp_norm, x, cfg.norm_type)
    return x + T.ffn(p, cfg, h2)


@torch.no_grad()
def prefill(
    params: T.TransformerLM,
    cfg: ModelConfig,
    tokens,  # (B, S) int
    max_len: int,
    kv_repeat: int = 1,
    cache_dtype: torch.dtype = torch.bfloat16,
    encoder_frames=None,
    vision_embeds=None,
) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """Run the prompt, build the cache.  Returns (last-token logits, cache,
    lengths).  A VLM's ``vision_embeds`` (B, N_vis, D) run ahead of the
    prompt and count in the lengths; an encoder-decoder's
    ``encoder_frames`` (B, S_enc, D) go through the encoder, and its cross
    K/V are stored in the model's dtype, as the reference stores them."""
    tokens = T.as_tokens(params, tokens)
    x = T.embed_inputs(params, cfg, tokens, vision_embeds)
    bsz, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, bsz, max_len, kv_repeat, cache_dtype, device=x.device, cross_dtype=x.dtype)
    if cfg.is_encdec:
        if encoder_frames is None:
            raise ValueError("encoder-decoder prefill needs encoder_frames")
        enc_out = T.encode(params, cfg, encoder_frames)
        for i, cross in enumerate(params.cross):
            cache["cross_k"][i], cache["cross_v"][i] = T._encoder_kv(cross, cfg, enc_out)
        del enc_out
    for i, (blk, is_local, cache_l) in enumerate(_layer_caches(params, cache)):
        x = _block_prefill(blk, cfg, x, positions, is_local, cache_l, kv_repeat)
        if params.cross is not None:
            x = T._cross_attend(params.cross[i], cfg, x, (cache["cross_k"][i], cache["cross_v"][i]))
    logits = T.logits_from(params, cfg, x[:, -1:, :])[:, 0]
    lengths = torch.full((bsz,), s, dtype=torch.int32, device=x.device)
    return logits, cache, lengths


# ------------------------------------------------------------- on a mesh
# Serving on a mesh of logical devices (``launch/mesh.py``) in the
# reference's layout: the weights under the serving specs
# (``sharding.param_pspecs``, placed by ``zero.place_params``), the KV cache
# split as ``serving.kv_cache.choose_cache_policy`` says — by heads over
# "model" (each KV head stored ``kv_repeat`` times) and by rows over the
# data axes, or by sequence over "model" (and the data axes at a batch
# smaller than they are) — and the recurrent states by rows and by their
# heads or channels, and an encoder-decoder's cross K/V by rows and, beside
# a cache split by heads, by heads, each device holding its slice
# (:func:`cache_pspecs`).
def mesh_serving_gap(cfg: ModelConfig, policy, pspecs: dict, mesh) -> str | None:
    """Why the mesh's prefill and decode do not serve ``cfg`` under
    ``policy`` (a ``CachePolicy``) with the parameters under ``pspecs`` on
    ``mesh``, or None when they do: the next slices of ROADMAP 26b take
    parameters under FSDP (a spec tree naming the current rules' data
    axes, ``sharding.splits_over_data``; checked first), MLA whose query
    heads do not split over "model" or whose latent cache splits by
    sequence over the data axes too (a batch below the data size), and a
    GQA cache split by sequence over the data axes while its heads split
    over "model".  The checks on the KV cache's layout hold for a model
    that attends (an encoder-decoder's self-attention cache among them;
    its cross cache follows them, split by heads beside a head-split
    cache, else whole on each model device): the xLSTM keeps recurrent
    states alone."""
    tp = mesh.shape.get("model", 1)
    attends = T.main_block_kind(cfg) != "xlstm"
    what = None
    if S.splits_over_data(pspecs, mesh):
        what = "parameters under FSDP at 2 bytes (maybe_fsdp_pspecs)"
    elif cfg.attn_type == "mla":
        if not L.heads_split(cfg, tp):
            what = f"MLA's {cfg.num_heads} query heads over {tp} model devices, which do not split"
        elif policy.seq_axes != ("model",):
            what = (f"MLA's latent cache split by sequence over {'/'.join(policy.seq_axes)} (a batch below the "
                    "data size)")
    elif attends and policy.seq_axes and policy.shard_heads:
        what = (f"a KV cache split by sequence over {'/'.join(policy.seq_axes)} while its heads split over "
                "'model'")
    elif attends and not policy.seq_axes and not (policy.shard_heads and policy.shard_batch):
        what = "a KV cache that splits neither by heads nor by rows"
    elif attends and not policy.seq_axes and not L.heads_split(cfg, tp):
        what = f"{cfg.num_heads} query heads over {tp} model devices, which split no whole GQA groups"
    if what is None:
        return None
    return (f"{cfg.name}: {what} is not served on a mesh yet (ROADMAP 26b: the serving mesh's next slices); "
            "prefill and decode on a mesh serve GQA caches split by heads and rows, or by sequence, MLA's "
            "latent cache split by sequence over 'model' beside its heads, the recurrent states and the "
            "encoder-decoder's cross cache")


def _semantic_axes(policy) -> dict:
    """Each cache dim's semantic axis -> the mesh axes ``policy`` splits it
    over (the current rules' batch axes for rows)."""
    rules = S.get_rules() or S.SINGLE_POD_RULES
    data_axes = rules["batch"]
    if not isinstance(data_axes, tuple):
        data_axes = (data_axes,)
    seq = []
    for logical in policy.seq_axes:
        if logical == "data":
            seq.extend(a for a in data_axes if a)
        else:
            seq.append("model")
    return {
        "batch": (data_axes if len(data_axes) > 1 else data_axes[0]) if policy.shard_batch else None,
        "seq": (tuple(seq) if len(seq) > 1 else seq[0]) if seq else None,
        "kv_heads": "model" if policy.shard_heads else None,
        "inner": "model",
        "rec_heads": "model",
    }


def _axes_size(axes, mesh) -> int:
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)) if axes is not None else ():
        n *= mesh.shape[a]
    return n


def _leaf_axes(key: str, ndim: int, policy) -> list:
    sem = _semantic_axes(policy)
    return [sem.get(x) if x else None for x in CACHE_DIM_SEMANTICS.get(key, (None,) * ndim)]


def cache_pspecs(cache: dict, policy, mesh) -> dict:
    """The reference's spec of each cache leaf (``launch/specs.py``
    ``cache_structs_and_specs``): each dim by its semantic axis
    (:data:`CACHE_DIM_SEMANTICS`) — rows over the current rules' batch axes
    with ``policy.shard_batch``, the sequence over ``policy.seq_axes``, KV
    heads over "model" with ``policy.shard_heads``, a recurrent state's
    channels and heads over "model" — where the dim splits evenly."""
    specs = {}
    for key, leaf in cache.items():
        axes = _leaf_axes(key, len(leaf.shape), policy)
        specs[key] = S.P(*[ax if ax is not None and dim % _axes_size(ax, mesh) == 0 and dim >= _axes_size(ax, mesh)
                         else None for dim, ax in zip(leaf.shape, axes)])
    return specs


# a recurrent state's heads and channels: kept whole on every model device where they do not split evenly, as
# the reference's spec leaves them (4 mLSTM heads over 8 or 16)
_REPLICABLE = frozenset({"inner", "rec_heads"})


def _placed_specs(cache: dict, policy, mesh) -> dict:
    """:func:`cache_pspecs`, raising where a dim the policy splits does not
    split evenly (the mesh's steps hold every split dim as slices), but a
    recurrent state's heads or channels, which stay whole there."""
    specs = cache_pspecs(cache, policy, mesh)
    for key, leaf in cache.items():
        sem = CACHE_DIM_SEMANTICS.get(key, (None,) * len(leaf.shape))
        for d, (got, want, name) in enumerate(zip(specs[key], _leaf_axes(key, len(leaf.shape), policy), sem)):
            if got != want and name not in _REPLICABLE:
                raise ValueError(f"{key}: dim {d} of {tuple(leaf.shape)} does not split over {want} "
                                 f"({_axes_size(want, mesh)} devices)")
    return specs


def _spec_part(spec, shape, mesh, pos: int) -> tuple:
    """The slices of a tensor of ``shape`` that ``spec`` gives the device at
    flat position ``pos`` of ``mesh``: each dim split over its axes' sizes
    (row-major over a tuple of axes)."""
    out = []
    for dim, axes in zip(shape, list(spec) + [None] * (len(shape) - len(spec))):
        if axes is None:
            out.append(slice(None))
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        i, width = mesh.index(pos, axes), dim // _axes_size(axes, mesh)
        out.append(slice(i * width, (i + 1) * width))
    return tuple(out)


def init_mesh_cache(cfg: ModelConfig, mesh, policy, batch: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16, cross_dtype: torch.dtype | None = None) -> list[dict]:
    """A zero-filled cache (:func:`init_cache`'s leaves in its dtypes: k and
    v in ``dtype``, the recurrent states in f32, the hybrid's conv window in
    ``dtype``, an encoder-decoder's cross K/V in ``cross_dtype``, default
    ``dtype``) for ``batch`` sequences of up to ``max_len`` on ``mesh``:
    per device, in ``mesh.flat`` order, its slice of each leaf
    (:func:`cache_pspecs`), made on its stream.  The whole is never made (a
    trace would count it)."""
    whole = {k: SimpleNamespace(shape=shape, dtype=dt) for k, (shape, dt) in
             cache_leaves(cfg, batch, max_len, policy.kv_repeat, dtype, cross_dtype).items()}
    specs = _placed_specs(whole, policy, mesh)
    out = []
    for dev in mesh.flat:
        with dev.scope():
            out.append({k: torch.zeros(_part_shape(specs[k], v.shape, mesh), dtype=v.dtype, device=dev.device)
                        for k, v in whole.items()})
    return out


def _part_shape(spec, shape, mesh) -> tuple:
    """The shape of a device's part of a tensor of ``shape`` under
    ``spec``."""
    return tuple(n // _axes_size(ax, mesh) for n, ax in zip(shape, list(spec) + [None] * (len(shape) - len(spec))))


def place_cache(cache: dict, mesh, policy) -> list[dict]:
    """A single-device cache placed on ``mesh``: per device its slice of
    every leaf (:func:`cache_pspecs`), a copy made on its stream."""
    specs = _placed_specs(cache, policy, mesh)
    devices = mesh.flat
    caller = C._enter(devices)
    out = []
    for pos, dev in enumerate(devices):
        with dev.scope():
            mine = {}
            for k, v in cache.items():
                C._used_on(v, dev)
                part = v[_spec_part(specs[k], v.shape, mesh, pos)]
                mine[k] = torch.empty(part.shape, dtype=v.dtype, device=dev.device).copy_(part)
            out.append(mine)
    C._leave(devices, caller, [])
    return out


def gather_cache(placed: list[dict], mesh, policy, cfg: ModelConfig | None = None) -> dict:
    """The inverse of :func:`place_cache`: the whole cache on the first
    device's torch device, each leaf joined from the devices' slices.  A
    recurrent state's heads or channels are whole on each device where
    they do not split, so their width comes from ``cfg`` (needed for those
    leaves alone)."""
    devices = mesh.flat
    dev = devices[0].device
    caller = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    C._leave(devices, caller, [])  # the caller's stream reads after every device's writes
    widths = None if cfg is None else cache_leaves(cfg, 1, 1, policy.kv_repeat)
    out = {}
    for k, first in placed[0].items():
        shape = []
        for d, (n, ax, name) in enumerate(zip(first.shape, _leaf_axes(k, first.ndim, policy),
                                              CACHE_DIM_SEMANTICS.get(k, (None,) * first.ndim))):
            if name in _REPLICABLE:
                if widths is None:
                    raise ValueError(f"{k}: gathering a recurrent state needs the model's config (cfg=)")
                shape.append(widths[k][0][d])
            else:
                shape.append(n * _axes_size(ax, mesh))
        spec = cache_pspecs({k: SimpleNamespace(shape=tuple(shape))}, policy, mesh)[k]
        whole = torch.empty(shape, dtype=first.dtype, device=dev)
        for pos in range(mesh.size):
            part = placed[pos][k]
            whole[_spec_part(spec, shape, mesh, pos)].copy_(part)
            if caller is not None:
                part.record_stream(caller)
        out[k] = whole
    return out


def _model_dims(model: T.TransformerLM, pspecs: dict, tp: int) -> dict:
    """{parameter name: the dim of its layer's leaf stored split over
    "model", or None} under ``pspecs`` (``zero.Layout.model_dim``)."""
    out = {}
    for name, _ in model.named_parameters():
        spec = tuple(S.spec_at(pspecs, name))
        md = next((j for j, a in enumerate(spec) if a == "model"), None)
        out[name] = md - (T._jax_path(name)[1] is not None) if md is not None and tp > 1 else None
    return out


def _cache_heads(k: torch.Tensor, cfg: ModelConfig, tp: int, m: int, kv_repeat: int) -> torch.Tensor:
    """Model device ``m``'s cache heads from its KV heads ``k`` (..., n, hd;
    ``layers.tp_kv_heads``): cache head j of the repeated layout holds KV
    head j // kv_repeat, and device m holds cache heads m·c .. (m+1)·c - 1."""
    lo, n = L.tp_kv_heads(cfg, tp, m)
    c = cfg.num_kv_heads * kv_repeat // tp
    want = [(m * c + i) // kv_repeat - lo for i in range(c)]
    reps = c // n
    if want != [i // reps for i in range(c)]:
        raise ValueError(f"{cfg.name}: cache heads {m * c}..{(m + 1) * c - 1} of device {m} are not its KV heads "
                         f"{lo}..{lo + n - 1} repeated")
    return k if reps == 1 else k.repeat_interleave(reps, dim=-2)


class _MeshServing:
    """What the mesh's prefill and decode steps share: ``cfg`` on ``mesh``
    under the serving specs ``pspecs`` and the cache ``policy``, the
    current rules' batch axes; raises ``NotImplementedError`` for what the
    slice does not serve (:func:`mesh_serving_gap`).

    Its loop (:meth:`run`) walks the dense prefix, then the main layers
    (:func:`_blocks`).  ``shards`` are the model groups (flat positions,
    model order) that compute rows: every data index's with
    ``policy.shard_batch``, else the first alone (the rows do not split; the reference repeats them on
    every data index, and each group of ``groups`` holds the rows' cache:
    keys where the sequence splits over the data axes too, recurrent
    states as replicas).  ``seq``: the mesh axes of a cache split by
    sequence, or None.  ``state_dims``: each recurrent leaf's dim (of a
    layer's slice) split over "model", or None where the model devices
    keep it whole."""

    def __init__(self, cfg: ModelConfig, mesh, pspecs: dict, policy):
        rules = S.get_rules()
        if rules is None:
            raise ValueError("serving on a mesh needs logical-axis rules: build the step inside `use_rules(...)`")
        self.cfg, self.mesh, self.pspecs, self.policy, self.rules = cfg, mesh, pspecs, policy, rules
        self.data_axes, self.data_size = S.data_axes_and_size(mesh, rules)
        self.tp = mesh.shape.get("model", 1)
        gap = mesh_serving_gap(cfg, policy, pspecs, mesh)
        if gap is not None:
            raise NotImplementedError(gap)
        batch_axes = self.data_axes if isinstance(self.data_axes, tuple) else (self.data_axes,)
        stray = [a for a, n in mesh.shape.items() if n > 1 and a not in batch_axes and a != "model"]
        if stray:
            raise ValueError(f"mesh axes {stray} are neither the rules' batch axes {batch_axes} nor 'model'")
        self.devices = mesh.flat
        pos_of = {id(dev): pos for pos, dev in enumerate(self.devices)}
        self.groups = [[pos_of[id(dev)] for dev in group] for group in mesh.model_groups(self.data_axes)]
        self.row_split = self.data_size if policy.shard_batch else 1
        self.shards = self.groups if policy.shard_batch else self.groups[:1]
        self.leads = [self.devices[group[0]] for group in self.shards]
        self.seq = _semantic_axes(policy)["seq"]
        if isinstance(self.seq, str):
            self.seq = (self.seq,)
        self.attends = T.main_block_kind(cfg) != "xlstm"
        specs = cache_pspecs({k: SimpleNamespace(shape=shape) for k, (shape, _) in
                              cache_leaves(cfg, self.data_size, 1, policy.kv_repeat).items() if k in RECURRENT},
                             policy, mesh)
        self.state_dims = {k: next((d - 1 for d, ax in enumerate(spec) if ax == "model" and self.tp > 1), None)
                           for k, spec in specs.items()}

    def holders(self, i: int) -> list:
        """The model groups holding data shard ``i``'s cache rows: its own,
        or where the rows do not split over the data axes, every group."""
        return [self.shards[i]] if self.policy.shard_batch else self.groups

    def take_state(self, i: int, cache: list, layer: int, names) -> dict:
        """Data shard ``i``'s state of ``layer`` (the leaves ``names``) whole
        on its lead: gathered from its model group where a leaf splits over
        "model", else the lead's own copy."""
        group = self.shards[i]
        out = {}
        for name in names:
            d = self.state_dims[name]
            if d is None:
                out[name] = cache[group[0]][name][layer]
            else:
                out[name] = C.all_gather([cache[q][name][layer] for q in group], [self.devices[q] for q in group],
                                         d, (0,), self.tp)[0]
        return out

    def put_state(self, i: int, cache: list, layer: int, names, state) -> None:
        """Data shard ``i``'s new state of ``layer`` (``state``, the leaves
        ``names`` whole on its lead) written to every device holding its
        rows (:meth:`holders`): each its slice over "model", or the whole
        to each replica, copied from the lead (a trace counts what the lead
        sends, "send", for every holder of the whole mesh)."""
        lead, lead_pos = self.leads[i], self.shards[i][0]
        for name, value in zip(names, state):
            d = self.state_dims[name]
            value = value.to(cache[lead_pos][name].dtype)  # moved as stored (the conv window in the cache's dtype)
            for q in (q for group in self.holders(i) for q in group):
                part = value
                if d is not None:
                    w = value.shape[d] // self.tp
                    part = value.narrow(d, self.mesh.index(q, ("model",)) * w, w)
                if self.devices[q] is not lead:
                    part = C.send(part, [lead, self.devices[q]], 0, 1, fanout=self.mesh.stands_for(q, lead_pos))
                with self.devices[q].scope():
                    cache[q][name][layer].copy_(part)

    def recur(self, i: int, cache: list, layer: int, blk, h: torch.Tensor) -> torch.Tensor:
        """Data shard ``i``'s recurrent branch of ``blk`` (``layer``) on its
        lead, the branch's leaves gathered there: over a prompt ``h`` (B, S,
        D) from zero, or a token (B, D) from the layer's state
        (:meth:`take_state`), the single device's functions unchanged; the
        new state sent to every holder (:meth:`put_state`).  Returns y."""
        names = _state_names(blk)
        state = None if h.dim() == 3 else self.take_state(i, cache, layer, names)
        y, state = _recurrent(blk, self.cfg, h, state)
        self.put_state(i, cache, layer, names, state)
        return y

    def width(self, mine: dict) -> int:
        """The keys one device's slice of a cache split by sequence holds
        (``mine``: its cache), or 0 where the sequence does not split."""
        if self.seq is None:
            return 0
        return next(v.shape[2] for k, v in mine.items() if CACHE_DIM_SEMANTICS[k][2] == "seq")

    def offset(self, pos: int, width: int) -> int:
        """The first key of the cache slice of ``width`` keys that the
        device at flat position ``pos`` holds: its index over the
        sequence's mesh axes (row-major, as :func:`cache_pspecs` splits
        them) times the width; 0 where the sequence does not split."""
        return 0 if self.seq is None else self.mesh.index(pos, self.seq) * width

    def contexts(self, copies: list) -> tuple:
        """Per data shard its ``TensorShard`` (None for a model group of
        one) and its MoE modules' expert groups, over the placed
        ``copies``."""
        if len(copies) != self.mesh.size:
            raise ValueError(f"{len(copies)} parameter copies on a mesh of {self.mesh.size} devices")
        dims = _model_dims(copies[0], self.pspecs, self.tp)
        moe = [name for name, mod in copies[0].named_modules() if isinstance(mod, T.MoE)]
        shards, experts = [], []
        for group in self.shards:
            devs = [self.devices[q] for q in group]
            shards.append(S.TensorShard(devs, [copies[q] for q in group], dims, self.tp) if len(group) > 1 else None)
            experts.append({copies[group[0]].get_submodule(n): [(self.devices[q], copies[q].get_submodule(n))
                                                                for q in group] for n in moe})
        return shards, experts

    def rows(self, value, i: int, b: int, dtype=None) -> torch.Tensor:
        """Data shard ``i``'s ``b`` rows of ``value`` (a tensor, or
        array-like) copied onto its lead (the caller is in its scope)."""
        dev = self.leads[i]
        value = torch.as_tensor(value)
        if value.shape[0] != b * self.row_split:
            raise ValueError(f"{value.shape[0]} rows do not split over {self.row_split} data shards")
        part = value[i * b:(i + 1) * b]
        if part.device.type == dev.device.type:
            C._used_on(part, dev)
        return torch.empty(part.shape, dtype=dtype or part.dtype, device=dev.device).copy_(part)

    def moe_route_whole(self, bsz: int, s: int) -> bool:
        """A MoE layer routes the whole batch of ``bsz`` x ``s`` tokens
        at once: the reference's expert-parallel branch is not taken for
        it (``layers._expert_parallel`` on the global batch)."""
        return self.cfg.is_moe and L._expert_parallel(self.cfg, bsz, s) is None

    def ffn(self, copies, shards, experts, stack: str, layer: int, hs: list, whole: bool) -> list:
        """Each data shard's FFN output of block ``layer`` of ``stack``
        (:func:`_blocks`) over its normed rows ``hs``: per shard under its
        tensor shard (the MLP's columns, or the MoE's expert-parallel
        branch over its own tokens); with ``whole``, a MoE routes every
        shard's rows at once, as the reference routes the global batch
        below its expert-parallel threshold: the rows gathered on the first
        shard's lead, routed on its model group with the experts split
        (``layers.moe_apply_whole``), each shard's rows sent back."""
        if not whole or getattr(copies[0], stack)[layer].moe is None:
            out = []
            for i, group in enumerate(self.shards):
                blk = getattr(copies[group[0]], stack)[layer]
                with self.leads[i].scope(), S.tensor_shard(shards[i]), S.expert_shard(experts[i]):
                    out.append(T.ffn(blk, self.cfg, hs[i]))
            return out
        b = hs[0].shape[0]
        lead = self.leads[0]
        xs = hs[0] if len(hs) == 1 else C.all_gather(hs, self.leads, 0, (0,), self.row_split)[0]
        with lead.scope(), S.tensor_shard(shards[0]), S.expert_shard(experts[0]):
            y = L.moe_apply_whole(getattr(copies[self.shards[0][0]], stack)[layer].moe, self.cfg,
                                  xs.reshape(-1, 1, xs.shape[-1]), self.cfg.mlp_act).reshape(xs.shape)
            out = [y[:b]]
        for i in range(1, len(hs)):
            out.append(C.send(y[i * b:(i + 1) * b], [lead, self.leads[i]], 0, 1))
        return out

    def run(self, params, embed, attend, bsz: int, s: int, cache: list, cross=None) -> torch.Tensor:
        """Every layer over the data shards, under each shard's tensor
        shard on its lead, the dense prefix first (:func:`_blocks`):
        ``embed(i, group, lead copy)`` gives shard i's residual rows; a
        layer runs, per shard, its attention norm, ``attend(i, group,
        shard, at, p_attn, h, window)`` (the attention output, on the lead;
        it writes the cache slices of the layer ``at``, :func:`_at`), a
        hybrid's Mamba branch over the same normed rows (:meth:`recur`, joined by
        ``transformer.hybrid_mix``), the residual and the MLP norm, then
        every shard's FFN (:meth:`ffn`; the MoE routes the whole batch of
        ``bsz`` x ``s`` tokens at once where the reference would); an
        xLSTM layer its norm and its recurrent branch alone.  An
        encoder-decoder's layer then runs its cross attention, per shard
        (the reference's order): ``cross(i, group, shard, layer, p_cross,
        x)`` gives the new residual rows.  ``cache``: the per-device slices
        the recurrent branches read and write.  Returns the logits of each
        shard's last position, joined in the shards' row order on the
        mesh's first device (vocab-parallel under its tensor shard)."""
        cfg = self.cfg
        shards, experts = self.contexts(params)
        xs = []
        for i, group in enumerate(self.shards):
            with self.leads[i].scope(), S.tensor_shard(shards[i]):
                xs.append(embed(i, group, params[group[0]]))
        whole = self.moe_route_whole(bsz, s)
        for stack, prefix, layer in _blocks(params[0]):
            window = _window(cfg, params[0].is_local[layer] if stack == "layers" else None)
            hs = []
            for i, group in enumerate(self.shards):
                blk = getattr(params[group[0]], stack)[layer]
                with self.leads[i].scope(), S.tensor_shard(shards[i]):
                    if blk.kind == "xlstm":
                        h = L.apply_norm(blk.pre_norm, xs[i], cfg.norm_type)
                        xs[i] = xs[i] + self.recur(i, cache, layer, blk, h)
                        continue
                    h = L.apply_norm(blk.attn_norm, xs[i], cfg.norm_type)
                    y = attend(i, group, shards[i], (prefix, layer), blk.attn, h, window)
                    if blk.kind == "hybrid":
                        y = T.hybrid_mix(blk, cfg, y, self.recur(i, cache, layer, blk, h))
                    xs[i] = xs[i] + y
                    hs.append(L.apply_norm(blk.mlp_norm, xs[i], cfg.norm_type))
            if hs:
                for i, y in enumerate(self.ffn(params, shards, experts, stack, layer, hs, whole)):
                    with self.leads[i].scope():
                        xs[i] = xs[i] + y
            del hs
            if cross is not None:  # each decoder layer, then its cross layer
                for i, group in enumerate(self.shards):
                    with self.leads[i].scope(), S.tensor_shard(shards[i]):
                        xs[i] = cross(i, group, shards[i], layer, params[group[0]].cross[layer], xs[i])
        parts = []
        for i, group in enumerate(self.shards):
            last = xs[i][:, -1:] if xs[i].dim() == 3 else xs[i][:, None]
            with self.leads[i].scope(), S.tensor_shard(shards[i]):
                parts.append(T.logits_from(params[group[0]], cfg, last)[:, 0])
        return parts[0] if len(parts) == 1 else C.all_gather(parts, self.leads, 0, (0,), self.row_split)[0]


def make_mesh_prefill(cfg: ModelConfig, mesh, pspecs: dict, policy):
    """The mesh's prefill: ``prefill_fn(params, tokens, max_len,
    cache_dtype=bf16, vision_embeds=None, encoder_frames=None) ->
    (last-token logits (B, V) on the mesh's first device, the cache — per
    device its slice, as :func:`init_mesh_cache` —, lengths (B,) on the
    first device)`` over
    ``zero.place_params``' copies (``params``, one a device in
    ``mesh.flat`` order, under ``pspecs``).  Build it inside the rules'
    ``use_rules``; ``policy``: ``choose_cache_policy``'s for the cell.

    The rows (tokens, a VLM's vision embeddings) split over the data
    shards.  Each shard runs on its model group
    (``sharding.tensor_shard``): the residual stream on its lead; the
    embedding on each device's vocab rows; attention on each model
    device's H/TP heads (``layers.gqa_tp_kv``: K3 on its query heads and
    KV heads), which writes its K/V rows, repeated to its cache heads,
    into its own cache slice; the MLP on its columns; the logits on its
    vocab rows.  Layer by layer every shard's attention runs, then the
    FFN: a MoE layer takes the expert-parallel branch per shard where the
    reference's global batch would, else routes every shard's rows at once
    on the first shard's model group (:meth:`_MeshServing.ffn`).

    With a cache split by sequence (heads that do not split over "model")
    attention runs whole on the shard's lead over the leaves gathered there
    (``sharding.whole``; K3 on every head), and each model device receives
    its key slice of the layer's K and V (``collectives.send``).  MLA's
    latent cache splits by sequence while its heads split over "model":
    the dense prefix, then the main layers, each head-parallel on the
    stored slices (``layers.mla_tp_latent``: K3 on each device's H/TP
    heads), each model device writing its key slice of the prompt's c_kv /
    k_rope rows (broadcast to the group for its heads) into its cache; no
    weight moves.  A recurrent branch (the xLSTM layer's mLSTM or sLSTM, hymba's Mamba
    beside its attention) runs whole on the lead too, the single device's
    function over the prompt (K6 for Mamba), and each device holding the
    rows receives its slice of the final state, or the whole
    (:meth:`_MeshServing.recur`).  Rows that do not split over the data
    axes raise, as the reference's prefill cannot shard them either.

    An encoder-decoder's ``encoder_frames`` (B, S_enc, D) split over the
    data shards as the tokens do; each shard's encoder runs on its model
    group under its tensor shard (``transformer.encode``: attention
    head-parallel where the heads split, else whole on the lead; the MLP
    on its columns).  Each layer's cross attention, after the FFN: with
    the heads split, head-parallel (``layers.gqa_tp_kv(kv_x=)``), each
    model device writing the K/V of its heads into its own cross slice;
    with a cache split by sequence the cross cache is whole on each model
    device: each projects the encoder's output (copied to the group once)
    with the columns of ``wk`` / ``wv`` it stores, the columns are
    gathered over the group into every device's replica, and K3 runs on
    the lead over its replica, ``wq`` and ``wo`` gathered there.  The
    cross K/V are stored in the model's dtype, as the single device
    stores them."""
    plan = _MeshServing(cfg, mesh, pspecs, policy)

    @torch.no_grad()
    def prefill_fn(params, tokens, max_len: int, cache_dtype: torch.dtype = torch.bfloat16, vision_embeds=None,
                   encoder_frames=None):
        tokens = torch.as_tensor(tokens)
        bsz, n_text = tokens.shape
        b = bsz // plan.data_size
        s = n_text + (0 if vision_embeds is None else vision_embeds.shape[1])
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_len}")
        if plan.row_split != plan.data_size:
            raise ValueError(f"a prefill of {bsz} rows does not split over {plan.data_size} data shards "
                             f"(cache policy {policy}): prefill at the data size or more, then place the cache")
        if cfg.is_encdec and encoder_frames is None:
            raise ValueError("encoder-decoder prefill needs encoder_frames")
        with mesh, S.use_rules(plan.rules):
            caller = C._enter(plan.devices)
            caches = init_mesh_cache(cfg, mesh, policy, bsz, max_len, cache_dtype, cross_dtype=T.torch_dtype(cfg.dtype))
            width = plan.width(caches[0])
            positions, encoded = [], []

            def embed(i, group, lead):
                tok = plan.rows(tokens, i, b, torch.long)
                vis = None if vision_embeds is None else plan.rows(vision_embeds, i, b)
                positions.append(torch.arange(s, device=plan.leads[i].device))
                if cfg.is_encdec:  # the encoder's output on the lead; with the cross cache whole, on every device
                    enc = T.encode(lead, cfg, plan.rows(encoder_frames, i, b))
                    encoded.append(C.broadcast(enc, [plan.devices[q] for q in group]) if plan.seq else [enc])
                return T.embed_inputs(lead, cfg, tok, vis)

            def write_keys(group, at, names, parts) -> None:
                """Each model device's keys [lo, lo + n) of the prompt's rows
                ``parts`` (per device its copies, in ``names``' order) into its
                cache slices of the layer ``at``."""
                for q_pos, rows in zip(group, parts):
                    lo = plan.offset(q_pos, width)
                    n = min(s, lo + width) - lo
                    if n <= 0:
                        continue
                    with plan.devices[q_pos].scope():
                        for leaf, row in zip(_at(caches[q_pos], at, *names), rows):
                            leaf[:, :n] = row[:, lo:lo + n]

            def attend_mla(i, group, shard, at, p_attn, h):
                if shard is None:
                    y, c_kv, k_rope = L.mla_apply_with_latent(p_attn, cfg, h, positions[i], causal=True)
                    latent = [(c_kv, k_rope)]
                else:  # head-parallel: each device K3 on its heads, its copy of the latent rows
                    y, latent = L.mla_tp_latent(p_attn, cfg, h, positions[i], True, None, shard)
                write_keys(group, at, ("c_kv", "k_rope"), latent)
                return y

            def attend_seq(i, group, shard, at, p_attn, h, window):
                layer = at[1]
                p = S.whole(p_attn)
                q, k, v = L.gqa_project_qkv(p, cfg, h, positions[i])
                out = L.attention_scores_blockwise(q, k, v, causal=True, window=window)
                y = out.reshape(*h.shape[:2], cfg.num_heads * cfg.resolved_head_dim) @ p.wo.to(h.dtype)
                if policy.kv_repeat > 1:
                    k = k.repeat_interleave(policy.kv_repeat, dim=2)
                    v = v.repeat_interleave(policy.kv_repeat, dim=2)
                for q_pos in group:  # each model device its keys [lo, lo + n) of the prompt
                    lo = plan.offset(q_pos, width)
                    n = min(s, lo + width) - lo
                    if n <= 0:
                        continue
                    kk, vv = k[:, lo:lo + n], v[:, lo:lo + n]
                    dev = plan.devices[q_pos]
                    if q_pos != group[0]:
                        pair = [plan.devices[group[0]], dev]
                        kk, vv = C.send(kk, pair, 0, 1), C.send(vv, pair, 0, 1)
                    with dev.scope():
                        caches[q_pos]["k"][layer][:, :n] = kk
                        caches[q_pos]["v"][layer][:, :n] = vv
                return y

            def attend(i, group, shard, at, p_attn, h, window):
                if cfg.attn_type == "mla":
                    return attend_mla(i, group, shard, at, p_attn, h)
                if plan.seq is not None:
                    return attend_seq(i, group, shard, at, p_attn, h, window)
                layer = at[1]
                if shard is None:
                    mine = caches[group[0]]
                    return _gqa_prefill(p_attn, cfg, h, positions[i], window, mine["k"][layer], mine["v"][layer],
                                        policy.kv_repeat)
                y, kvs = L.gqa_tp_kv(p_attn, cfg, h, positions[i], True, window, shard)
                for m, (q, (k, v)) in enumerate(zip(group, kvs)):
                    with plan.devices[q].scope():
                        caches[q]["k"][layer][:, :s] = _cache_heads(k, cfg, plan.tp, m, policy.kv_repeat)
                        caches[q]["v"][layer][:, :s] = _cache_heads(v, cfg, plan.tp, m, policy.kv_repeat)
                return y

            def cross(i, group, shard, layer, p_cross, x):
                mine = [(caches[q]["cross_k"][layer], caches[q]["cross_v"][layer]) for q in group]
                if shard is None:
                    k, v = T._encoder_kv(p_cross, cfg, encoded[i][0])
                    mine[0][0].copy_(k)
                    mine[0][1].copy_(v)
                    return T._cross_attend(p_cross, cfg, x, mine[0])
                h = L.apply_norm(p_cross.norm, x, cfg.norm_type)
                if plan.seq is None:  # the heads split: each device's K/V into its slice
                    y, kvs = L.gqa_tp_kv(p_cross.attn, cfg, h, None, False, None, shard, kv_x=encoded[i][0])
                    for dev, (kc, vc), (k, v) in zip(shard.devices, mine, kvs):
                        with dev.scope():
                            kc.copy_(k)
                            vc.copy_(v)
                    return x + y
                # the cross cache whole on each model device: the stored columns' K/V gathered into every replica
                for n, name in enumerate(("wk", "wv")):
                    parts = []
                    for dev, pm, e in zip(shard.devices, shard.members(p_cross.attn), encoded[i]):
                        with dev.scope():
                            parts.append(e @ getattr(pm, name).to(e.dtype))
                    if shard.is_split(getattr(p_cross.attn, name)):
                        parts = C.all_gather(parts, shard.devices, -1, None, plan.tp)
                    for dev, kv, part in zip(shard.devices, mine, parts):
                        with dev.scope():
                            kv[n].copy_(part.view(kv[n].shape))
                    del parts
                wq, wo = _lead_leaves(p_cross.attn, "wq", "wo")
                hd, dt = cfg.resolved_head_dim, h.dtype
                q = (h @ wq.to(dt)).reshape(*h.shape[:2], cfg.num_heads, hd)
                out = L.attention_scores_blockwise(q, *mine[0], causal=False)
                return x + out.reshape(*h.shape[:2], cfg.num_heads * hd) @ wo.to(dt)

            logits = plan.run(params, embed, attend, bsz, s, caches, cross if cfg.is_encdec else None)
            with plan.devices[0].scope():
                lengths = torch.full((bsz,), s, dtype=torch.int32, device=plan.devices[0].device)
            C._leave(plan.devices, caller, [logits, lengths])
        return logits, caches, lengths

    return prefill_fn


def _gqa_decode_tp(p_attn, cfg, x, layer_caches: list, lens: list, window, shard, kv_repeat):
    """One token's GQA attention head-parallel over ``shard``'s model
    group: ``x`` (B, D) broadcast, device m computing q for its H/TP heads
    and k, v for its KV heads (``layers.tp_kv_weights``), scattering its
    token's row, repeated to its cache heads, into its cache slice
    (``layer_caches[m]``: this layer's (k, v), (B, S, c, hd)) at its
    lengths (``lens[m]``: (lengths, lengths + 1) on that device), running
    K4 on its query heads over its slice and multiplying by its row slice
    of ``wo``; the partial outputs summed with the ring on the lead."""
    bsz, hd, local = x.shape[0], cfg.resolved_head_dim, cfg.num_heads // shard.tp
    parts = []
    for m, (dev, pm, (wk, wv), xm, (kc, vc), (ln, ln1)) in enumerate(zip(
            shard.devices, shard.members(p_attn), L.tp_kv_weights(p_attn, cfg, shard),
            C.broadcast(x, shard.devices), layer_caches, lens)):
        with dev.scope():
            q, k, v = L.project_heads(pm, cfg, xm[:, None], xm[:, None], pm.wq, wk, wv, ln[:, None])
            _scatter_rows_(kc, _cache_heads(k[:, 0], cfg, shard.tp, m, kv_repeat), ln)
            _scatter_rows_(vc, _cache_heads(v[:, 0], cfg, shard.tp, m, kv_repeat), ln)
            out = decode_ops.decode_attention_cache(q[:, 0], kc, vc, ln1, window=window)
            parts.append(out.reshape(bsz, local * hd) @ pm.wo.to(x.dtype))
    return C.ring_sum(parts, shard.devices)


def _gqa_decode_seq(p_attn, cfg, x, lengths, plan, holders: list, layer_caches: dict, lens: dict, window,
                    kv_repeat):
    """One token's GQA attention over a cache split by sequence: on the
    lead, over the leaves gathered there (``sharding.whole``), q (as f32)
    and the token's k, v from ``x`` (B, D) at ``lengths`` (the global
    cache fill); q, k and v copied to every device of ``holders`` (model
    groups of flat positions, the lead's group first), each writing the row
    where its slice holds the position (:func:`_scatter_rows_` at
    ``lens[pos][0]``, the lengths less its slice's first key) and running
    K4 with its log-sum-exp over its slice (``lens[pos][1]`` valid-key
    lengths; ``layer_caches[pos]``: this layer's (k, v)).  The partials
    merge in f32 (``decode_attention.ops.merge_partials``): within each
    group on its lead, then over the groups' leads on the first; a gather
    of partials holds a slice for each device of the whole axis (a
    RoleMesh's trace counts the mesh's).  Returns the output times ``wo``
    on the lead, in ``x``'s dtype."""
    bsz, hd, dt = x.shape[0], cfg.resolved_head_dim, x.dtype
    p = S.whole(p_attn)
    q, k, v = (t[:, 0] for t in L.gqa_project_qkv(p, cfg, x[:, None], lengths[:, None]))
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=1)
        v = v.repeat_interleave(kv_repeat, dim=1)
    flat = [q_pos for group in holders for q_pos in group]
    copies = dict(zip(flat, C.copy_leaves([q.float(), k, v], [plan.devices[q_pos] for q_pos in flat])))
    packed = {}
    for q_pos in flat:
        qm, km, vm = copies[q_pos]
        kc, vc = layer_caches[q_pos]
        with plan.devices[q_pos].scope():
            _scatter_rows_(kc, km, lens[q_pos][0])
            _scatter_rows_(vc, vm, lens[q_pos][0])
            out, lse = decode_ops.decode_attention_cache(qm, kc, vc, lens[q_pos][1], window=window, return_lse=True)
            packed[q_pos] = torch.cat([out, lse[..., None]], -1)[None]  # (1, B, H, hd + 1)

    def merge(parts: list, devices: list, slices: int, last: bool):
        whole = C.all_gather(parts, devices, 0, (0,), slices)[0]
        with devices[0].scope():
            if last:
                return decode_ops.merge_partials(whole[..., :hd], whole[..., hd], dtype=dt)
            out, lse = decode_ops.merge_partials(whole[..., :hd], whole[..., hd], return_lse=True)
            return torch.cat([out, lse[..., None]], -1)[None]

    tp = plan.mesh.shape.get("model", 1)
    leads = [plan.devices[group[0]] for group in holders]
    merged = [merge([packed[q_pos] for q_pos in group], [plan.devices[q_pos] for q_pos in group], tp,
                    len(holders) == 1) for group in holders]
    out = merged[0] if len(holders) == 1 else merge(merged, leads, plan.data_size, True)
    return out.reshape(bsz, cfg.num_heads * hd) @ p.wo.to(dt)


def _mla_decode_tp(p_attn, cfg, x, lengths, shard, layer_caches: list, lens: list, offsets: list):
    """One token's MLA attention in the absorbed form (:func:`_mla_decode`'s
    arithmetic, in f32) head-parallel over ``shard``'s model group, over a
    latent cache split by sequence over it; no parameter moves.  On the
    lead, from ``x`` (B, D) at ``lengths`` (the global cache fill): the
    replicated compressions, the queries' input (``wq_a`` -> ``q_norm``)
    and the token's latent row (``wkv_a`` -> ``kv_norm``, k_rope), copied
    to the group.  Device m (``layer_caches[m]``: this layer's (c_kv,
    k_rope) slice holding keys ``offsets[m]`` on; ``lens[m]``: (lengths,
    lengths + 1) less that first key) writes the row where its slice holds
    the position and computes, for its H/TP heads from its columns of
    ``wq_b`` (or ``wq``) and ``wkv_b``, q_c = q_nope W_uk and q_rope (rope
    at the global lengths).  Those are gathered over the group; each device
    scores every head against its own keys (masked at its lengths + 1 with
    -1e30) and packs its f32 partial o_c (B, H, R) with the log-sum-exp.
    Device m receives head block m of every device's partial and merges
    them (``decode_attention.ops.merge_partials``: a slice with no valid
    key weighs 0), then multiplies by its columns of W_uv and its rows of
    ``wo``; the outputs are summed with the ring on the lead."""
    bsz, dt = x.shape[0], x.dtype
    nope, rd, vd, r = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    local, devices = cfg.num_heads // shard.tp, shard.devices
    q_in = L.rmsnorm(x @ p_attn.wq_a.to(dt), p_attn.q_norm.scale) if cfg.q_lora_rank else x
    c_kv, k_rope = L.mla_compress(p_attn, cfg, x[:, None, :], lengths[:, None])
    members = shard.members(p_attn)
    qs, w_uv = [], []
    for dev, pm, (qm, cm, rm), (ckv, krope), (ln, _), off in zip(
            devices, members, C.copy_leaves([q_in, c_kv[:, 0], k_rope[:, 0]], devices), layer_caches, lens, offsets):
        with dev.scope():
            _scatter_rows_(ckv, cm, ln)
            _scatter_rows_(krope, rm, ln)
            q = (qm @ (pm.wq_b if cfg.q_lora_rank else pm.wq).to(dt)).reshape(bsz, 1, local, nope + rd)
            q_nope, q_rope = q.split([nope, rd], dim=-1)
            cos, sin = L.rope_cos_sin((ln + off)[:, None], rd, cfg.rope_theta)
            w_b = pm.wkv_b.to(dt).reshape(r, local, nope + vd)  # (R, H/TP, nope + v): W_uk | W_uv
            w_uv.append(w_b[..., nope:])
            q_c = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_b[..., :nope].float())
            qs.append(torch.cat([q_c, L.apply_rope(q_rope, cos, sin)[:, 0].float()], -1))  # (B, H/TP, R + rd)
    parts = []
    for dev, q_all, (ckv, krope), (_, ln1) in zip(devices, C.all_gather(qs, devices, 1, None, shard.tp),
                                                  layer_caches, lens):
        with dev.scope():
            ckv_f = ckv.float()
            scores = torch.einsum("bhr,bsr->bhs", q_all[..., :r], ckv_f)
            scores = scores + torch.einsum("bhr,bsr->bhs", q_all[..., r:], krope.float())
            scores = scores * (nope + rd) ** -0.5
            pos = torch.arange(ckv.shape[1], device=dev.device)
            scores = scores.masked_fill(pos[None, None, :] >= ln1[:, None, None], -1e30)
            o_c = torch.einsum("bhs,bsr->bhr", torch.softmax(scores, dim=-1), ckv_f)
            parts.append(torch.cat([o_c, torch.logsumexp(scores, dim=-1)[..., None]], -1))  # (B, H, R + 1)
    outs = []
    for m, (dev, pm, w) in enumerate(zip(devices, members, w_uv)):
        # head block m of every device's partial (a slice for each device of the whole axis)
        block = C.all_gather([part[None, :, m * local:(m + 1) * local] for part in parts], devices, 0, (m,),
                             shard.tp)[0]
        with dev.scope():
            o_c = decode_ops.merge_partials(block[..., :r], block[..., r])  # (B, H/TP, R) f32
            out = torch.einsum("bhr,rhv->bhv", o_c, w.float()).to(dt)
            outs.append(out.reshape(bsz, local * vd) @ pm.wo.to(dt))
    return C.ring_sum(outs, devices)


def make_mesh_decode_step(cfg: ModelConfig, mesh, pspecs: dict, policy):
    """The mesh's decode step: ``decode_fn(params, token, cache, lengths)
    -> (logits (B, V) on the mesh's first device, the cache — each device's
    slice updated in place —, lengths + 1 on the first device)`` over
    ``zero.place_params``' copies and :func:`make_mesh_prefill`'s (or
    :func:`place_cache`'s) cache.  Build it inside the rules' ``use_rules``.

    Each data shard takes its rows of ``token`` and ``lengths``; on its
    model group attention is head-parallel (:func:`_gqa_decode_tp`: K4 on
    each device's query heads over its cache slice), the MLP and the
    vocabulary as in prefill.  A MoE layer with one token a row is under
    the reference's expert-parallel threshold, so it routes the whole
    batch at once: one capacity over all B tokens, and the reference's
    drops.  It runs eagerly (no CUDA graph: ``DecodeGraph`` is
    single-device).

    With a cache split by sequence attention is :func:`_gqa_decode_seq`:
    the token's q, k, v on the shard's lead, K4 on every device holding
    keys of its rows, the partial softmaxes merged back on the lead.
    MLA's is :func:`_mla_decode_tp`: the absorbed form head-parallel on
    the stored slices, each device scoring every head against its own
    keys, the partials exchanged by head blocks and merged (no kernel, as
    on one device; no weight moves).
    Where the rows do not split over the data axes (a batch smaller than
    they are, the sequence split over them too) the first data index's
    model group runs the layers once and every device of the mesh runs
    K4 on its slice; the reference repeats the layers on every data
    index.  A recurrent branch takes the layer's state whole on the lead
    (gathered from the model group where it splits), runs the single
    device's step (K6 at S = 1 for Mamba) and writes the new state back to
    every device holding the rows: each its slice, or the whole to each
    replica (every data index's where the rows do not split).  An
    encoder-decoder's cross attention reads its cross cache and writes
    nothing: head-parallel over a cross cache split by heads
    (:func:`_cross_decode_tp`: K4 on each device's heads, every length
    S_enc), else on the lead over its replica (:func:`_cross_decode`, ``wq``
    and ``wo`` gathered there); where the rows do not split, the first
    group's lead, as for self attention."""
    plan = _MeshServing(cfg, mesh, pspecs, policy)

    @torch.no_grad()
    def decode_fn(params, token, cache: list, lengths):
        token, lengths = torch.as_tensor(token), torch.as_tensor(lengths)
        bsz = token.shape[0]
        b = bsz // plan.row_split
        with mesh, S.use_rules(plan.rules):
            caller = C._enter(plan.devices)
            lens, glob = [None] * len(plan.devices), {}
            width = plan.width(cache[0])

            def embed(i, group, lead):
                tok = plan.rows(token, i, b, torch.long)
                if not plan.attends:
                    return T.embed_tokens(lead, cfg, tok[:, None])[:, 0]
                ln = plan.rows(lengths, i, b)
                glob[i] = ln
                holders = [q for g in plan.holders(i) for q in g]
                copies = [[ln]] if len(holders) == 1 else C.copy_leaves([ln], [plan.devices[q] for q in holders])
                for q, [mine] in zip(holders, copies):
                    with plan.devices[q].scope():
                        off = plan.offset(q, width)
                        mine = mine if off == 0 else mine - off
                        lens[q] = (mine, mine + 1)
                return T.embed_tokens(lead, cfg, tok[:, None])[:, 0]

            def attend(i, group, shard, at, p_attn, h, window):
                if cfg.attn_type == "mla":
                    mine = [_at(cache[q], at, "c_kv", "k_rope") for q in group]
                    if shard is None:
                        return _mla_decode(p_attn, cfg, h, *mine[0], lens[group[0]][0])
                    return _mla_decode_tp(p_attn, cfg, h, glob[i], shard, mine, [lens[q] for q in group],
                                          [plan.offset(q, width) for q in group])
                layer = at[1]
                if plan.seq is not None:
                    holders = plan.holders(i)
                    layer_caches = {q: (cache[q]["k"][layer], cache[q]["v"][layer]) for g in holders for q in g}
                    return _gqa_decode_seq(p_attn, cfg, h, glob[i], plan, holders, layer_caches, lens, window,
                                           policy.kv_repeat)
                if shard is None:
                    mine = cache[group[0]]
                    return _gqa_decode(p_attn, cfg, h, mine["k"][layer], mine["v"][layer], lens[group[0]][0],
                                       window, policy.kv_repeat)
                return _gqa_decode_tp(p_attn, cfg, h, [(cache[q]["k"][layer], cache[q]["v"][layer]) for q in group],
                                      [lens[q] for q in group], window, shard, policy.kv_repeat)

            def cross(i, group, shard, layer, p_cross, x):
                if shard is not None and plan.seq is None:
                    return _cross_decode_tp(p_cross, cfg, x, [(cache[q]["cross_k"][layer], cache[q]["cross_v"][layer])
                                                              for q in group], shard)
                mine = cache[group[0]]
                return _cross_decode(p_cross, cfg, x, mine["cross_k"][layer], mine["cross_v"][layer])

            logits = plan.run(params, embed, attend, bsz, 1, cache, cross if cfg.is_encdec else None)
            with plan.devices[0].scope():
                if lengths.device.type == plan.devices[0].device.type:
                    C._used_on(lengths, plan.devices[0])
                new_lengths = lengths.to(plan.devices[0].device) + 1
            C._leave(plan.devices, caller, [logits, new_lengths])
        return logits, cache, new_lengths

    return decode_fn
