"""Dense transformer LM of the port: ``repro.models.transformer`` for the
dense-GQA family (gemma3's local:global stacks included).

The reference stacks every layer's parameters under a leading L axis and
runs the layers under ``lax.scan``, choosing the local or global variant
with ``lax.cond``.  Here :class:`TransformerLM` holds one submodule per
layer and the layers run as a Python loop; the local/global choice is a
Python branch on the static ``layer_flags``.  Parameters are inference
weights (no gradients): matrices and the embedding in the config dtype,
norm scales in f32 (see ``models/layers.py`` on why that matches the
reference's cast-at-the-call-site).

MoE, MLA, SSM, hybrid, encoder-decoder and VLM stacks are not ported
(ROADMAP port queue item 25) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ------------------------------------------------------------------- flags
def layer_flags(cfg: ModelConfig) -> dict[str, np.ndarray]:
    """Static per-layer structure flags."""
    n = cfg.num_layers
    flags: dict[str, np.ndarray] = {}
    if cfg.local_global_ratio > 0:
        # gemma3 pattern: N local then 1 global, repeating.
        period = cfg.local_global_ratio + 1
        flags["is_local"] = np.array(
            [(i % period) != cfg.local_global_ratio for i in range(n)], dtype=bool
        )
    if cfg.family == "hybrid":
        # hymba: global attention on first / middle / last layers, SWA elsewhere.
        glob = {0, n // 2, n - 1}
        flags["is_local"] = np.array([i not in glob for i in range(n)], dtype=bool)
    if cfg.slstm_every > 0:
        flags["is_slstm"] = np.array(
            [(i + 1) % cfg.slstm_every == 0 for i in range(n)], dtype=bool
        )
    return flags


def main_block_kind(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "xlstm"
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.is_moe:
        return "moe"
    return "dense"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the stacks the port does not run yet."""
    kind = main_block_kind(cfg)
    if kind != "dense" or cfg.attn_type != "gqa" or cfg.is_encdec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {kind}/{cfg.attn_type} stack"
            f"{' with encoder' if cfg.is_encdec else ''}"
            f"{' with ' + cfg.frontend if cfg.frontend else ''} is not ported to repro_torch yet: "
            "ROADMAP port queue item 25 (LLM side stack)"
        )


# -------------------------------------------------------------- parameters
def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Norm(nn.Module):
    """rmsnorm (``scale``) or layernorm (``scale`` + ``bias``), f32."""

    def __init__(self, dim: int, norm_type: str, device=None):
        super().__init__()
        init = L.norm_init(dim, norm_type, device)
        self.scale = nn.Parameter(init["scale"], requires_grad=False)
        self.bias = nn.Parameter(init["bias"], requires_grad=False) if "bias" in init else None


class Attention(nn.Module):
    """GQA projections, (in, out) like the reference's ``x @ w``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        hd, d = cfg.resolved_head_dim, cfg.d_model
        self.wq = _weight((d, cfg.num_heads * hd), dtype, device)
        self.wk = _weight((d, cfg.num_kv_heads * hd), dtype, device)
        self.wv = _weight((d, cfg.num_kv_heads * hd), dtype, device)
        self.wo = _weight((cfg.num_heads * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = Norm(hd, "rmsnorm", device)
            self.k_norm = Norm(hd, "rmsnorm", device)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.w_gate = _weight((d_model, d_ff), dtype, device)
        self.w_up = _weight((d_model, d_ff), dtype, device)
        self.w_down = _weight((d_ff, d_model), dtype, device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.attn_norm = Norm(cfg.d_model, cfg.norm_type, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp_norm = Norm(cfg.d_model, cfg.norm_type, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)


class TransformerLM(nn.Module):
    """Embedding, one :class:`Block` per layer, final norm and (untied) LM
    head.  Built uninitialised: fill it with :func:`init_lm` or
    :func:`from_jax_params`."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.embed = _weight((cfg.padded_vocab_size, cfg.d_model), dtype, device)
        self.layers = nn.ModuleList(Block(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, device)
        self.lm_head = None if cfg.tie_embeddings else _weight((cfg.d_model, cfg.padded_vocab_size), dtype, device)
        flags = layer_flags(cfg)
        # per layer: True local, False global, None no local/global pattern
        self.is_local = [bool(f) for f in flags["is_local"]] if "is_local" in flags else [None] * cfg.num_layers


def _dense_matrices(model: TransformerLM):
    """(parameter, fan-in scale) in the reference's draw order."""
    for blk in model.layers:
        for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                  blk.mlp.w_gate, blk.mlp.w_up, blk.mlp.w_down):
            yield w, w.shape[0] ** -0.5
    if model.lm_head is not None:
        yield model.lm_head, model.lm_head.shape[0] ** -0.5


@torch.no_grad()
def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device: str | torch.device | None = "cuda") -> TransformerLM:
    """Random weights with the reference's distributions (``init_lm``):
    embedding N(0, 1) * d_model^-0.5, each matrix N(0, 1) * fan_in^-0.5,
    norms at 1 (and 0).  Drawn in f32 on ``device`` from ``generator``
    (a generator on that device; default: seed 0) and stored in the config
    dtype.  The numbers differ from the JAX ones for the same seed — load
    those with :func:`from_jax_params`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} but weights on {dev}")
    model = TransformerLM(cfg, dev)
    draws = [(model.embed, cfg.d_model**-0.5), *_dense_matrices(model)]
    for w, scale in draws:
        noise = torch.empty(w.shape, dtype=torch.float32, device=dev).normal_(generator=generator)
        w.copy_(noise.mul_(scale))
    return model


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))  # a writable copy


@torch.no_grad()
def from_jax_params(params: dict, cfg: ModelConfig) -> TransformerLM:
    """A CPU :class:`TransformerLM` holding the reference's parameters.

    ``params`` is ``repro.models.transformer.init_lm``'s pytree with numpy
    (or array-like) leaves; the leaves under ``layers`` carry a leading L
    axis, which is unstacked into one :class:`Block` per layer."""
    model = TransformerLM(cfg, "cpu")
    model.embed.copy_(_np(params["embed"]))
    model.final_norm.scale.copy_(_np(params["final_norm"]["scale"]))
    if model.final_norm.bias is not None:
        model.final_norm.bias.copy_(_np(params["final_norm"]["bias"]))
    if model.lm_head is not None:
        model.lm_head.copy_(_np(params["lm_head"]))
    stacked = params["layers"]
    for i, blk in enumerate(model.layers):
        for norm_name in ("attn_norm", "mlp_norm"):
            norm = getattr(blk, norm_name)
            norm.scale.copy_(_np(stacked[norm_name]["scale"][i]))
            if norm.bias is not None:
                norm.bias.copy_(_np(stacked[norm_name]["bias"][i]))
        pa = stacked["attn"]
        for name in ("wq", "wk", "wv", "wo"):
            getattr(blk.attn, name).copy_(_np(pa[name][i]))
        if cfg.qk_norm:
            blk.attn.q_norm.scale.copy_(_np(pa["q_norm"]["scale"][i]))
            blk.attn.k_norm.scale.copy_(_np(pa["k_norm"]["scale"][i]))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(blk.mlp, name).copy_(_np(stacked["mlp"][name][i]))
    return model


# ---------------------------------------------------------- full-seq blocks
def _attn_full(p_attn, cfg: ModelConfig, x, positions, is_local, causal=True):
    """Attention with the per-layer sliding window (the reference's lax.cond)."""
    if cfg.sliding_window is None or is_local is None:
        return L.gqa_apply(p_attn, cfg, x, positions, causal=causal)
    window = cfg.sliding_window if is_local else None
    return L.gqa_apply(p_attn, cfg, x, positions, causal=causal, window=window)


def _block_full(p: Block, cfg: ModelConfig, x, positions, is_local, causal=True):
    """One dense block, full sequence, no cache."""
    h = L.apply_norm(p.attn_norm, x, cfg.norm_type)
    x = x + _attn_full(p.attn, cfg, h, positions, is_local, causal)
    h = L.apply_norm(p.mlp_norm, x, cfg.norm_type)
    return x + L.mlp_apply(p.mlp, h, cfg.mlp_act)


# ------------------------------------------------------------------ forward
def embed_tokens(params: TransformerLM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    x = params.embed[tokens].to(dt)
    if cfg.tie_embeddings:
        # sqrt(d_model) rounded to the config dtype, as a Python scalar (a
        # device tensor made here would cost a blocking copy every step)
        return x * torch.tensor(cfg.d_model**0.5, dtype=dt).item()
    return x


def logits_from(params: TransformerLM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(params.final_norm, x, cfg.norm_type)
    if cfg.tie_embeddings:
        logits = x @ params.embed.to(x.dtype).T
    else:
        logits = x @ params.lm_head.to(x.dtype)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # mask vocab-padding logits
        pad = torch.arange(cfg.padded_vocab_size, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def as_tokens(params: TransformerLM, tokens) -> torch.Tensor:
    """Token ids (tensor or array-like) on the parameters' device."""
    return torch.as_tensor(tokens, device=params.embed.device).long()


@torch.no_grad()
def forward(
    params: TransformerLM,
    cfg: ModelConfig,
    tokens,  # (B, S) int
    vision_embeds=None,
    encoder_frames=None,
) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    if vision_embeds is not None or encoder_frames is not None:
        raise NotImplementedError("VLM and encoder-decoder inputs are not ported to repro_torch yet: "
                                  "ROADMAP port queue item 25 (LLM side stack)")
    tokens = as_tokens(params, tokens)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for blk, is_local in zip(params.layers, params.is_local):
        x = _block_full(blk, cfg, x, positions, is_local)
    return logits_from(params, cfg, x)
