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
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
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


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, kv_repeat: int = 1,
    dtype: torch.dtype = torch.bfloat16, device: str | torch.device | None = "cuda",
    cross_dtype: torch.dtype | None = None,
) -> dict[str, torch.Tensor]:
    """Zero-filled cache for ``batch`` sequences of up to ``max_len``; the
    cross K/V of an encoder-decoder in ``cross_dtype`` (default ``dtype``);
    the recurrent states in f32, but the hybrid's conv window in ``dtype``
    (the xLSTM's take neither ``max_len`` nor ``dtype``)."""
    T.check_supported(cfg)
    dev = resolve_device(device)
    kind = T.main_block_kind(cfg)
    n, f32 = cfg.num_layers, dict(dtype=torch.float32, device=dev)
    if kind == "xlstm":
        d, mh = cfg.d_model, cfg.num_heads
        mhd = 2 * d // mh
        cache = {"mlstm_c": torch.zeros((n, batch, mh, mhd, mhd), **f32),
                 "mlstm_n": torch.zeros((n, batch, mh, mhd), **f32)}
        for name in ssm.SLSTM_STATE:
            cache[name] = torch.zeros((n, batch, d), **f32)
        return cache
    if cfg.attn_type != "mla":
        hd = cfg.resolved_head_dim
        shape = (cfg.num_layers, batch, max_len, kv_cache_heads(cfg, kv_repeat), hd)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if kind == "hybrid":
            d_in = 2 * cfg.d_model
            cache["ssm"] = torch.zeros((n, batch, d_in, cfg.ssm_state), **f32)
            cache["conv"] = torch.zeros((n, batch, cfg.ssm_conv - 1, d_in), dtype=dtype, device=dev)
        if cfg.is_encdec:
            cross = (cfg.num_layers, batch, cfg.encoder_seq_len, cfg.num_kv_heads, hd)
            for name in ("cross_k", "cross_v"):
                cache[name] = torch.zeros(cross, dtype=cross_dtype or dtype, device=dev)
        return cache
    n_prefix = cfg.first_dense_layers if cfg.is_moe else 0
    cache = {}
    for prefix, n in (("", cfg.num_layers - n_prefix), ("prefix_", n_prefix)):
        if n:
            cache[prefix + "c_kv"] = torch.zeros((n, batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=dev)
            cache[prefix + "k_rope"] = torch.zeros((n, batch, max_len, cfg.rope_head_dim), dtype=dtype,
                                                   device=dev)
    return cache


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


# ------------------------------------------------------------------ helpers
def _scatter_rows_(cache: torch.Tensor, rows: torch.Tensor, lengths: torch.Tensor) -> None:
    """cache (B, S, ...) <- rows (B, ...) at per-sequence positions, in
    place; positions >= S are dropped (JAX's scatter drops them too)."""
    b, s = cache.shape[:2]
    idx = torch.arange(b, device=cache.device)
    pos = lengths.clamp(max=s - 1)
    keep = (lengths < s).view(b, *([1] * (rows.dim() - 1)))
    cache[idx, pos] = torch.where(keep, rows.to(cache.dtype), cache[idx, pos])


def _gqa_decode(p_attn, cfg, x, k_cache, v_cache, lengths, window, kv_repeat):
    """x: (B, D); k/v_cache: this layer's (B, S, KVHe, hd) views of the
    stacked cache, updated in place."""
    bsz, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = (x @ p_attn.wq.to(dt)).reshape(bsz, cfg.num_heads, hd)
    k = (x @ p_attn.wk.to(dt)).reshape(bsz, cfg.num_kv_heads, hd)
    v = (x @ p_attn.wv.to(dt)).reshape(bsz, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p_attn.q_norm.scale)
        k = L.rmsnorm(k, p_attn.k_norm.scale)
    cos, sin = L.rope_cos_sin(lengths, hd, cfg.rope_theta)  # (B, hd/2)
    q = L.apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
    k = L.apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=1)
        v = v.repeat_interleave(kv_repeat, dim=1)
    _scatter_rows_(k_cache, k, lengths)
    _scatter_rows_(v_cache, v, lengths)
    out = decode_ops.decode_attention_cache(q, k_cache, v_cache, lengths + 1, window=window)
    out = out.reshape(bsz, cfg.num_heads * hd)
    return out @ p_attn.wo.to(dt)


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


def _cross_decode(p_cross, cfg, x, cross_k, cross_v):
    """One cross-attention insertion, one token: K4 over this layer's
    (B, S_enc, KVH, hd) cross cache with every length S_enc, made on the
    device (no host copy: the step stays capturable)."""
    h = L.apply_norm(p_cross.norm, x, cfg.norm_type)
    bsz, _ = h.shape
    hd, dt = cfg.resolved_head_dim, h.dtype
    q = (h @ p_cross.attn.wq.to(dt)).reshape(bsz, cfg.num_heads, hd)
    lens = torch.full((bsz,), cross_k.shape[1], dtype=torch.int32, device=x.device)
    out = decode_ops.decode_attention_cache(q, cross_k, cross_v, lens)
    return x + out.reshape(bsz, cfg.num_heads * hd) @ p_cross.attn.wo.to(dt)


def _write_(cache_l: dict, names, values) -> None:
    for name, value in zip(names, values):
        cache_l[name].copy_(value)


def _block_decode(p, cfg, x, cache_l, is_local, lengths, kv_repeat):
    """One block, one token.  x: (B, D); cache_l: this layer's slices by
    leaf name, updated in place."""
    if p.kind == "xlstm":
        h = L.apply_norm(p.pre_norm, x, cfg.norm_type)
        if p.is_slstm:
            y, state = ssm.slstm_step(p.slstm, h, tuple(cache_l[k] for k in ssm.SLSTM_STATE))
            _write_(cache_l, ssm.SLSTM_STATE, state)
        else:
            y, state = ssm.mlstm_step(p.mlstm, h, cache_l["mlstm_c"], cache_l["mlstm_n"], cfg.num_heads)
            _write_(cache_l, ("mlstm_c", "mlstm_n"), state)
        return x + y
    h = L.apply_norm(p.attn_norm, x, cfg.norm_type)
    if cfg.attn_type == "mla":
        y = _mla_decode(p.attn, cfg, h, cache_l["c_kv"], cache_l["k_rope"], lengths)
    else:
        y = _gqa_decode(p.attn, cfg, h, cache_l["k"], cache_l["v"], lengths, _window(cfg, is_local), kv_repeat)
    if p.kind == "hybrid":
        m_out, state = ssm.mamba_step(p.mamba, h, cache_l["ssm"], cache_l["conv"].to(h.dtype), cfg.ssm_state)
        _write_(cache_l, ("ssm", "conv"), state)
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
def _block_prefill(p, cfg, x, positions, is_local, cache_l, kv_repeat):
    """One block over the full prompt; writes this layer's cache: k / v
    (GQA) or c_kv / k_rope (MLA) rows, the hybrid's Mamba states, the
    xLSTM layer's mLSTM or sLSTM state (the other stays at zero)."""
    if p.kind == "xlstm":
        h = L.apply_norm(p.pre_norm, x, cfg.norm_type)
        if p.is_slstm:
            y, state = ssm.slstm_apply(p.slstm, h, cfg.num_heads)
            _write_(cache_l, ssm.SLSTM_STATE, state)
        else:
            y, state = ssm.mlstm_apply(p.mlstm, h, cfg.num_heads)
            _write_(cache_l, ("mlstm_c", "mlstm_n"), state)
        return x + y
    h = L.apply_norm(p.attn_norm, x, cfg.norm_type)
    b, s, _ = h.shape
    if cfg.attn_type == "mla":
        y, row_a, row_b = L.mla_apply_with_latent(p.attn, cfg, h, positions, causal=True)
        names = ("c_kv", "k_rope")
    else:
        q, row_a, row_b = L.gqa_project_qkv(p.attn, cfg, h, positions)
        out = L.attention_scores_blockwise(q, row_a, row_b, causal=True, window=_window(cfg, is_local))
        y = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim) @ p.attn.wo.to(h.dtype)
        if kv_repeat > 1:
            row_a = row_a.repeat_interleave(kv_repeat, dim=2)
            row_b = row_b.repeat_interleave(kv_repeat, dim=2)
        names = ("k", "v")
    cache_l[names[0]][:, :s] = row_a
    cache_l[names[1]][:, :s] = row_b
    if p.kind == "hybrid":
        m_out, state = ssm.mamba_apply(p.mamba, h, cfg.ssm_state)
        _write_(cache_l, ("ssm", "conv"), state)
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
