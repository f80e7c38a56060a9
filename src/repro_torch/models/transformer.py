"""Transformer LM of the port: ``repro.models.transformer`` for the dense
GQA family (gemma3's local:global stacks included), MoE (OLMoE), MLA +
MoE with a dense-FFN prefix (DeepSeek-V2), the encoder-decoder (whisper:
a non-causal encoder over stub frame embeddings, and a cross-attention
insertion after every decoder layer) and the VLM backbone (internvl2:
stub patch embeddings through ``vis_proj``, prepended to the text), the
xLSTM stack (xlstm-125m: mLSTM layers with sLSTM ones at
``is_slstm``) and the hybrid (hymba-1.5b: attention and Mamba heads side by
side in each block; ``models/ssm.py``).

The reference stacks every layer's parameters under a leading L axis and
runs the layers under ``lax.scan``, choosing the local or global variant
with ``lax.cond``.  Here :class:`TransformerLM` holds one submodule per
layer and the layers run as a Python loop; the local/global choice is a
Python branch on the static ``layer_flags`` (as is an xLSTM layer's
mLSTM/sLSTM choice, held on its block).  DeepSeek-V2's leading
dense-FFN layers, a separately scanned group in the reference
(``params["dense_prefix"]``), are ``TransformerLM.dense_prefix``; whisper's
``params["encoder"]`` and ``params["cross"]`` are ``TransformerLM.encoder``
and ``TransformerLM.cross``.
Parameters are inference weights (no gradients) by default: matrices and
the embedding in the config dtype, norm scales and the MoE router in f32
(see ``models/layers.py`` on why that matches the reference's
cast-at-the-call-site).  The training state's model (``train=True`` in
:func:`init_lm` and :func:`from_jax_params`) holds every leaf in f32 with
``requires_grad``, as the reference keeps its f32 master parameters —
Mamba's ``a_log``, ``dt_bias`` and ``d_skip`` included — and compute
still casts each to the config dtype at its use; :func:`forward_train`
is the forward with gradients, each block rematerialised in the backward
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).  Each submodule is named as the reference's
pytree leaf it holds (``moe.experts.w_gate`` is
``params["layers"]["moe"]["experts"]["w_gate"][i]``), which is how
:func:`from_jax_params` carries weights across and :func:`to_jax_layout`
carries them back.

A GQA dense-FFN prefix, which no configuration has, is not ported (ROADMAP
§3) and raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm
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
    """Raise for the one stack the port does not run: a dense-FFN prefix
    under GQA, which no configuration has (the reference's prefill and
    decode disagree on its cache, ROADMAP §3)."""
    if cfg.is_moe and cfg.first_dense_layers and cfg.attn_type != "mla":
        raise NotImplementedError(
            f"{cfg.name}: the {main_block_kind(cfg)}/{cfg.attn_type} stack with a dense prefix "
            "is not ported to repro_torch yet: ROADMAP port queue item 25 (LLM side stack)"
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


class MLAAttention(nn.Module):
    """MLA projections (DeepSeek-V2): the compressed KV path ``wkv_a`` ->
    ``kv_norm`` -> ``wkv_b``, queries through ``wq_a`` -> ``q_norm`` ->
    ``wq_b`` (or ``wq`` without a q LoRA rank), output ``wo``."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        qd = cfg.nope_head_dim + cfg.rope_head_dim
        self.wkv_a = _weight((d, cfg.kv_lora_rank + cfg.rope_head_dim), dtype, device)
        self.kv_norm = Norm(cfg.kv_lora_rank, "rmsnorm", device)
        self.wkv_b = _weight((cfg.kv_lora_rank, h * (cfg.nope_head_dim + cfg.v_head_dim)), dtype, device)
        self.wo = _weight((h * cfg.v_head_dim, d), dtype, device)
        if cfg.q_lora_rank:
            self.wq_a = _weight((d, cfg.q_lora_rank), dtype, device)
            self.q_norm = Norm(cfg.q_lora_rank, "rmsnorm", device)
            self.wq_b = _weight((cfg.q_lora_rank, h * qd), dtype, device)
        else:
            self.wq = _weight((d, h * qd), dtype, device)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.w_gate = _weight((d_model, d_ff), dtype, device)
        self.w_up = _weight((d_model, d_ff), dtype, device)
        self.w_down = _weight((d_ff, d_model), dtype, device)


class Experts(nn.Module):
    """Every routed expert's SwiGLU weights, stacked: (E, D, F) / (E, F, D)."""

    def __init__(self, n: int, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.w_gate = _weight((n, d_model, d_ff), dtype, device)
        self.w_up = _weight((n, d_model, d_ff), dtype, device)
        self.w_down = _weight((n, d_ff, d_model), dtype, device)


class MoE(nn.Module):
    """f32 router, routed experts, and the shared experts as one MLP of
    width ``n_shared · d_ff`` (or None)."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.router = _weight((d, cfg.num_experts), torch.float32, device)
        self.experts = Experts(cfg.num_experts, d, f, dtype, device)
        n_shared = cfg.num_shared_experts
        self.shared = MLP(d, n_shared * f, dtype, device) if n_shared else None


def _fixed(t: torch.Tensor) -> nn.Parameter:
    """A parameter :func:`init_lm` leaves at its construction value."""
    return nn.Parameter(t, requires_grad=False)


class Mamba(nn.Module):
    """Mamba's selective SSM (the reference's ``mamba_init``): ``in_proj``,
    ``x_proj`` and ``out_proj`` in the config dtype; the depthwise conv
    ``conv_w`` (conv, 1, d_inner), ``dt_bias`` (0), ``a_log`` (log 1..N per
    channel) and ``d_skip`` (1) in f32, as the reference computes with them."""

    def __init__(self, d_model: int, d_inner: int, state: int, conv: int, dtype, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = _weight((d_model, 2 * d_inner), dtype, device)
        self.conv_w = _weight((conv, 1, d_inner), torch.float32, device)
        self.x_proj = _weight((d_inner, 2 * state + 1), dtype, device)
        self.dt_bias = _fixed(torch.zeros(d_inner, **f32))
        self.a_log = _fixed(torch.log(torch.arange(1, state + 1, **f32)).expand(d_inner, state).contiguous())
        self.d_skip = _fixed(torch.ones(d_inner, **f32))
        self.out_proj = _weight((d_inner, d_model), dtype, device)


class MLSTM(nn.Module):
    """The mLSTM's projections (the reference's ``mlstm_init``, projection
    factor 2): ``up_proj``, ``wq``/``wk``/``wv``, ``w_gates`` (input and
    forget gate per head), ``o_gate``, ``down_proj`` and ``out_norm``."""

    def __init__(self, d_model: int, num_heads: int, dtype, device=None):
        super().__init__()
        d_in = 2 * d_model
        self.up_proj = _weight((d_model, d_in), dtype, device)
        self.wq = _weight((d_in, d_in), dtype, device)
        self.wk = _weight((d_in, d_in), dtype, device)
        self.wv = _weight((d_in, d_in), dtype, device)
        self.w_gates = _weight((d_in, 2 * num_heads), dtype, device)
        self.o_gate = _weight((d_model, d_in), dtype, device)
        self.down_proj = _weight((d_in, d_model), dtype, device)
        self.out_norm = Norm(d_in, "rmsnorm", device)


class SLSTM(nn.Module):
    """The sLSTM's weights (the reference's ``slstm_init``): ``w_in`` and
    ``w_rec`` (the i, f, z, o pre-activations), ``down_proj``, ``out_norm``."""

    def __init__(self, d_model: int, dtype, device=None):
        super().__init__()
        self.w_in = _weight((d_model, 4 * d_model), dtype, device)
        self.w_rec = _weight((d_model, 4 * d_model), dtype, device)
        self.down_proj = _weight((d_model, d_model), dtype, device)
        self.out_norm = Norm(d_model, "rmsnorm", device)


class Block(nn.Module):
    """One layer of ``kind``:

    * "dense", "dense_ffn", "moe", "hybrid": attention (GQA or MLA) and an
      FFN — ``mlp`` (width d_ff; DeepSeek's prefix "dense_ffn": dense_d_ff)
      or, for "moe", ``moe``; the other is None.  "hybrid" adds the
      :class:`Mamba` heads beside the attention and a norm on each output;
    * "xlstm": ``pre_norm`` and both an :class:`MLSTM` and an
      :class:`SLSTM`, as the reference stacks every layer;
      ``is_slstm`` picks the one the layer runs."""

    def __init__(self, cfg: ModelConfig, dtype, device=None, kind: str = "dense", is_slstm: bool = False):
        super().__init__()
        self.kind = kind
        self.is_slstm = is_slstm
        if kind == "xlstm":
            self.pre_norm = Norm(cfg.d_model, cfg.norm_type, device)
            self.mlstm = MLSTM(cfg.d_model, cfg.num_heads, dtype, device)
            self.slstm = SLSTM(cfg.d_model, dtype, device)
            return
        self.attn_norm = Norm(cfg.d_model, cfg.norm_type, device)
        self.attn = (MLAAttention if cfg.attn_type == "mla" else Attention)(cfg, dtype, device)
        self.mlp_norm = Norm(cfg.d_model, cfg.norm_type, device)
        self.moe = MoE(cfg, dtype, device) if kind == "moe" else None
        d_ff = (cfg.dense_d_ff or cfg.d_ff) if kind == "dense_ffn" else cfg.d_ff
        self.mlp = MLP(cfg.d_model, d_ff, dtype, device) if kind != "moe" else None
        if kind == "hybrid":
            self.mamba = Mamba(cfg.d_model, 2 * cfg.d_model, cfg.ssm_state, cfg.ssm_conv, dtype, device)
            self.attn_out_norm = Norm(cfg.d_model, cfg.norm_type, device)
            self.mamba_out_norm = Norm(cfg.d_model, cfg.norm_type, device)


class Encoder(nn.Module):
    """Whisper's encoder: dense blocks run non-causally over the frame
    embeddings, and a final norm."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, dtype, device) for _ in range(cfg.encoder_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, device)


class CrossBlock(nn.Module):
    """One decoder layer's cross-attention insertion: a norm and GQA
    projections (no rope), queries from the decoder, keys and values from
    the encoder's output."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.norm = Norm(cfg.d_model, cfg.norm_type, device)
        self.attn = Attention(cfg, dtype, device)


class TransformerLM(nn.Module):
    """Embedding, the dense-FFN prefix (MoE configs with
    ``first_dense_layers``; else None), one :class:`Block` per main layer,
    final norm and (untied) LM head; with an encoder (``is_encdec``) the
    :class:`Encoder` and one :class:`CrossBlock` per main layer, with the
    ViT stub frontend the (D, D) ``vis_proj``; else None.  Built
    uninitialised: fill it with :func:`init_lm` or :func:`from_jax_params`.
    ``param_dtype`` (default: the config dtype) is the matrices' and the
    embedding's dtype; the training state's model takes f32."""

    def __init__(self, cfg: ModelConfig, device=None, param_dtype: torch.dtype | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = param_dtype or torch_dtype(cfg.dtype)
        kind = main_block_kind(cfg)
        n_prefix = cfg.first_dense_layers if cfg.is_moe else 0
        self.embed = _weight((cfg.padded_vocab_size, cfg.d_model), dtype, device)
        flags = layer_flags(cfg)
        is_slstm = flags.get("is_slstm", np.zeros(cfg.num_layers, bool))
        self.dense_prefix = nn.ModuleList(
            Block(cfg, dtype, device, "dense_ffn") for _ in range(n_prefix)) if n_prefix else None
        self.layers = nn.ModuleList(Block(cfg, dtype, device, kind, bool(is_slstm[i]))
                                    for i in range(n_prefix, cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, device)
        self.lm_head = None if cfg.tie_embeddings else _weight((cfg.d_model, cfg.padded_vocab_size), dtype, device)
        self.encoder = Encoder(cfg, dtype, device) if cfg.is_encdec else None
        self.cross = nn.ModuleList(CrossBlock(cfg, dtype, device) for _ in self.layers) if cfg.is_encdec else None
        self.vis_proj = _weight((cfg.d_model, cfg.d_model), dtype, device) if cfg.frontend == "vit_stub" else None
        # per layer: True local, False global, None no local/global pattern
        self.is_local = [bool(f) for f in flags["is_local"]] if "is_local" in flags else [None] * len(self.layers)


@torch.no_grad()
def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device: str | torch.device | None = "cuda", train: bool = False) -> TransformerLM:
    """Random weights with the reference's distributions (``init_lm``):
    embedding N(0, 1) * d_model^-0.5, each matrix N(0, 1) * fan_in^-0.5 —
    the router and every projection (in, out) over its first dimension, an
    expert stack (E, in, out) over its second — with the sLSTM's ``w_rec``
    at a tenth of that and Mamba's ``conv_w`` N(0, 1) * 0.2; norms at 1
    (and 0), Mamba's ``dt_bias``, ``a_log`` and ``d_skip`` as built.  Drawn
    in f32 on ``device`` from ``generator``
    (a generator on that device; default: seed 0) and stored in the config
    dtype, or with ``train`` kept in f32 with ``requires_grad``.  The numbers differ from the JAX ones for the same seed — load
    those with :func:`from_jax_params`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} but weights on {dev}")
    model = TransformerLM(cfg, dev, torch.float32 if train else None)
    for name, w in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "embed":
            scale = cfg.d_model**-0.5
        elif leaf == "conv_w":
            scale = 0.2
        elif w.dim() >= 2 and leaf != "a_log":
            scale = w.shape[-2] ** -0.5 * (0.1 if leaf == "w_rec" else 1.0)
        else:
            continue  # norms keep their 1 (and 0), Mamba's fixed leaves their values
        noise = torch.empty(w.shape, dtype=torch.float32, device=dev).normal_(generator=generator)
        w.copy_(noise.mul_(scale))
        del noise
    return model.requires_grad_(train)


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))  # a writable copy


def _jax_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """A parameter's path in the reference's pytree and its layer index:
    the leaves under ``layers``, ``dense_prefix``, ``encoder.layers`` and
    ``cross`` carry a leading layer axis, which the index in the name picks
    (``encoder.layers.3.attn.wq`` is ``params["encoder"]["layers"]["attn"]
    ["wq"][3]``)."""
    parts = name.split(".")
    for i, part in enumerate(parts):
        if part.isdigit():
            return tuple(parts[:i] + parts[i + 1:]), int(part)
    return tuple(parts), None


def jax_ndim(name: str, t: torch.Tensor) -> int:
    """The rank of parameter ``name``'s leaf in the reference's layout: a
    layer's leaves are stacked under a leading layer axis."""
    return t.dim() + (_jax_path(name)[1] is not None)


@torch.no_grad()
def load_jax_layout(named, tree: dict, what: str = "model") -> None:
    """Copy the reference-layout ``tree`` (numpy or array-like leaves, each
    layer group stacked under a leading layer axis) into the tensors of
    ``named``, (parameter name, tensor) pairs, in place.  Each name is its
    path in the tree, the layer index taken out (:func:`_jax_path`).
    Raises if a leaf of ``tree`` has no tensor."""
    carried = set()
    for name, w in named:
        path, index = _jax_path(name)
        leaf = tree
        for part in path:
            leaf = leaf[part]
        w.copy_(_np(leaf if index is None else leaf[index]))
        carried.add(path)
    missing = set(_leaf_paths(tree)) - carried
    if missing:
        raise ValueError(f"{what}: reference leaves with no parameter in the port: {sorted(missing)}")


def from_jax_params(params: dict, cfg: ModelConfig, train: bool = False) -> TransformerLM:
    """A CPU :class:`TransformerLM` holding the reference's parameters
    (with ``train``: the training state's f32 model).

    ``params`` is ``repro.models.transformer.init_lm``'s pytree with numpy
    (or array-like) leaves (:func:`load_jax_layout`)."""
    model = TransformerLM(cfg, "cpu", torch.float32 if train else None)
    load_jax_layout(model.named_parameters(), params, cfg.name)
    return model.requires_grad_(train)


@torch.no_grad()
def stack_jax_layout(named) -> dict:
    """(parameter name, tensor) pairs as the reference's nested pytree,
    each layer group's tensors stacked under a leading layer axis."""
    groups: dict[tuple[str, ...], list] = {}  # path -> its layers' tensors, in layer order
    stacked = set()
    for name, w in named:
        path, index = _jax_path(name)
        groups.setdefault(path, []).append(w.detach())
        if index is not None:
            stacked.add(path)
    tree: dict = {}
    for path, ws in groups.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = torch.stack(ws) if path in stacked else ws[0]
    return tree


def to_jax_layout(model: TransformerLM) -> dict:
    """The inverse of :func:`from_jax_params`: the parameters as the
    reference's nested pytree (``init_lm``'s keys), each layer group's
    leaves stacked under a leading layer axis; torch tensors on the model's
    device in its dtypes (a model on the ``meta`` device gives the layout's
    shapes alone)."""
    return stack_jax_layout(model.named_parameters())


def _leaf_paths(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaf_paths(value, prefix + (key,))
        else:
            yield prefix + (key,)


# ---------------------------------------------------------- full-seq blocks
def _attn_full(p_attn, cfg: ModelConfig, x, positions, is_local, causal=True):
    """Attention with the per-layer sliding window (the reference's lax.cond)."""
    if cfg.attn_type == "mla":
        return L.mla_apply(p_attn, cfg, x, positions, causal=causal)
    if cfg.sliding_window is None or is_local is None:
        return L.gqa_apply(p_attn, cfg, x, positions, causal=causal)
    window = cfg.sliding_window if is_local else None
    return L.gqa_apply(p_attn, cfg, x, positions, causal=causal, window=window)


def ffn(p: Block, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """The block's FFN over h (..., D): its MoE, or its MLP."""
    if p.moe is not None:
        return L.moe_apply(p.moe, cfg, h.reshape(-1, 1, h.shape[-1]), cfg.mlp_act).reshape(h.shape)
    return L.mlp_apply(p.mlp, h, cfg.mlp_act)


def hybrid_mix(p: Block, cfg: ModelConfig, attn_out: torch.Tensor, mamba_out: torch.Tensor) -> torch.Tensor:
    """A hybrid block's fusion: the mean of the normed attention and Mamba
    outputs."""
    return 0.5 * (L.apply_norm(p.attn_out_norm, attn_out, cfg.norm_type)
                  + L.apply_norm(p.mamba_out_norm, mamba_out, cfg.norm_type))


def _block_full(p: Block, cfg: ModelConfig, x, positions, is_local, causal=True):
    """One block, full sequence, no cache."""
    if p.kind == "xlstm":
        h = L.apply_norm(p.pre_norm, x, cfg.norm_type)
        if p.is_slstm:
            return x + ssm.slstm_apply(p.slstm, h, cfg.num_heads)[0]
        return x + ssm.mlstm_apply(p.mlstm, h, cfg.num_heads)[0]
    h = L.apply_norm(p.attn_norm, x, cfg.norm_type)
    y = _attn_full(p.attn, cfg, h, positions, is_local, causal)
    if p.kind == "hybrid":
        y = hybrid_mix(p, cfg, y, ssm.mamba_apply(p.mamba, h, cfg.ssm_state)[0])
    x = x + y
    h = L.apply_norm(p.mlp_norm, x, cfg.norm_type)
    return x + ffn(p, cfg, h)


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


def embed_inputs(params: TransformerLM, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds=None) -> torch.Tensor:
    """The token embeddings, with the VLM's projected patch embeddings
    (B, N_vis, D) prepended: (B, N_vis + S, D)."""
    x = embed_tokens(params, cfg, tokens)
    if vision_embeds is None:
        return x
    if params.vis_proj is None:
        raise ValueError(f"{cfg.name} has no vision frontend for vision_embeds")
    dt = x.dtype
    vis = torch.as_tensor(vision_embeds, device=x.device).to(dt) @ params.vis_proj.to(dt)
    return torch.cat([vis, x], dim=1)


def _run(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` under ``torch.utils.checkpoint`` (its
    activations recomputed in the backward, as the reference's
    ``jax.checkpoint`` around each scanned layer)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params: TransformerLM, cfg: ModelConfig, frames, remat: bool = False) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings (B, S_enc, D)
    (the stub frontend's output), non-causal (K3 with causal off)."""
    x = torch.as_tensor(frames, device=params.embed.device).to(torch_dtype(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    for blk in params.encoder.layers:
        x = _run(_block_full, remat, blk, cfg, x, positions, None, False)
    return L.apply_norm(params.encoder.final_norm, x, cfg.norm_type)


def _encoder_kv(p_cross: CrossBlock, cfg: ModelConfig, enc_out: torch.Tensor):
    """One decoder layer's cross-attention K/V (B, S_enc, KVH, hd) from the
    encoder's output, in its dtype (the reference computes every layer's at
    once, the same products)."""
    b, se, _ = enc_out.shape
    hd, dt = cfg.resolved_head_dim, enc_out.dtype
    k = (enc_out @ p_cross.attn.wk.to(dt)).reshape(b, se, cfg.num_kv_heads, hd)
    v = (enc_out @ p_cross.attn.wv.to(dt)).reshape(b, se, cfg.num_kv_heads, hd)
    return k, v


def _cross_attend(p_cross: CrossBlock, cfg: ModelConfig, x: torch.Tensor, enc_kv) -> torch.Tensor:
    """One cross-attention insertion (decoder side): K3 with S_k = S_enc,
    non-causal, no rope."""
    h = L.apply_norm(p_cross.norm, x, cfg.norm_type)
    b, s, _ = h.shape
    hd, dt = cfg.resolved_head_dim, h.dtype
    q = (h @ p_cross.attn.wq.to(dt)).reshape(b, s, cfg.num_heads, hd)
    k, v = enc_kv
    out = L.attention_scores_blockwise(q, k, v, causal=False)
    return x + out.reshape(b, s, cfg.num_heads * hd) @ p_cross.attn.wo.to(dt)


def _decoder_layer(blk: Block, cross: CrossBlock, cfg: ModelConfig, x, positions, enc_out):
    """One encoder-decoder layer: the decoder block, then its cross
    attention over the encoder's output."""
    x = _block_full(blk, cfg, x, positions, None)
    return _cross_attend(cross, cfg, x, _encoder_kv(cross, cfg, enc_out))


def _forward(params: TransformerLM, cfg: ModelConfig, tokens, vision_embeds, encoder_frames,
             remat: bool) -> torch.Tensor:
    tokens = as_tokens(params, tokens)
    x = embed_inputs(params, cfg, tokens, vision_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.is_encdec:
        if encoder_frames is None:
            raise ValueError("encoder-decoder model needs encoder_frames")
        enc_out = encode(params, cfg, encoder_frames, remat)
        for blk, cross in zip(params.layers, params.cross):
            x = _run(_decoder_layer, remat, blk, cross, cfg, x, positions, enc_out)
        return logits_from(params, cfg, x)
    for blk in params.dense_prefix or ():
        x = _run(_block_full, remat, blk, cfg, x, positions, None)
    for blk, is_local in zip(params.layers, params.is_local):
        x = _run(_block_full, remat, blk, cfg, x, positions, is_local)
    return logits_from(params, cfg, x)


@torch.no_grad()
def forward(
    params: TransformerLM,
    cfg: ModelConfig,
    tokens,  # (B, S) int
    vision_embeds=None,  # (B, N_vis, D) for the VLM
    encoder_frames=None,  # (B, S_enc, D) for the encoder-decoder
) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S_total, V); S_total counts the
    vision tokens."""
    return _forward(params, cfg, tokens, vision_embeds, encoder_frames, remat=False)


def forward_train(params: TransformerLM, cfg: ModelConfig, tokens, vision_embeds=None,
                  encoder_frames=None) -> torch.Tensor:
    """:func:`forward` with gradients: each layer (an encoder-decoder layer
    with its cross attention) runs under ``torch.utils.checkpoint``, so the
    backward recomputes its activations, as the reference's
    ``jax.checkpoint`` does."""
    return _forward(params, cfg, tokens, vision_embeds, encoder_frames, remat=True)
