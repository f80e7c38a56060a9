"""Meta-tensor input specs + sharding assignments per (arch, shape): the
port's ``repro.launch.specs``.

Everything here is allocation-free: parameters (``TransformerLM`` on the
meta device), optimiser state (``adamw_init``), caches
(``decode.init_cache``) and batches are meta tensors made by the real
constructors, so the dry run traces the exact program that training and
serving run (``launch/hlo_analysis.py``).  The spec trees are the
reference's, ``sharding.P`` tuples of mesh-axis names over the reference's
layout (each layer group stacked under a leading layer axis).

What the port runs on a mesh, which is what the dry run traces:

* **train** — on one device the single-device step (``make_train_step``:
  nothing to reduce or gather); on more, the training mesh's step
  (``make_train_step(grad_pspecs=...)``) over ``zero.place_train_state``'s
  state: every leaf whose spec has "model" on a dim stored as its slice
  (the reference's layout: attention's heads, the MLP's columns and rows,
  the vocabulary, expert stacks, routers, the recurrent stacks'
  projections), ZeRO-1 moment slices of each device's part.  Above
  :data:`FSDP_THRESHOLD_BYTES` (``maybe_fsdp_pspecs``) the parameters'
  specs are the moments' and the state is placed under them: each device
  stores only its data part of every leaf, each layer gathers its leaves
  before use and the gathers' backward reduces their gradients back
  (FSDP, ``zero.Layout``).  So the placed bytes are the reference
  layout's for every cell.  It is traced on the mesh's
  :class:`~repro_torch.launch.mesh.RoleMesh`: one device of each role
  stands for all of them (a layer whose owner is not on it is gathered
  from a stand-in, and counted).
* **prefill / decode** — on one device ``decode.prefill`` and
  ``decode.decode_step``; on more, the mesh's steps
  (``decode.make_mesh_prefill``, ``decode.make_mesh_decode_step``) over
  ``zero.place_params``' copies: every leaf whose serving spec has
  "model" on a dim stored as its slice in the config's dtype, and for
  decode the cache placed per device (``decode.init_mesh_cache``: its
  data shard's rows, its model index's cache heads after ``kv_repeat`` or
  its keys of a sequence-split cache, its slice or replica of each
  recurrent state, an encoder-decoder's cross K/V by its heads or whole),
  an encoder-decoder's prefill given its ``encoder_frames``, traced on the
  mesh's
  :class:`~repro_torch.launch.mesh.RoleMesh`.  The argument bytes of the
  busiest device are the spec trees' (``reference_argument_bytes``: every
  parameter at the reference's 2 bytes, every cache entry at its leaf's
  dtype in the reference's ``init_cache`` — the recurrent states f32 —,
  plus the tokens over the data axes) plus ``dtype_surplus_bytes``, what
  the port's f32 leaves add (its norm scales, MoE routers and Mamba's
  conv, dt, A and D, where the reference casts every leaf to bf16).
  A cell of parameters under FSDP, MLA at a batch below the data size
  (its latent cache split by sequence over the data axes too) or whose
  heads do not split over "model", or a GQA cache split by sequence over
  the data axes while its heads split over "model"
  (``decode.mesh_serving_gap``) keeps its spec trees and a ``skip``
  reason, and is not traced.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.distributed import sharding as shmod
from repro_torch.distributed import zero
from repro_torch.distributed.sharding import P
from repro_torch.distributed.zero import zero_pspecs
from repro_torch.launch.mesh import RoleMesh
from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kv_cache import CachePolicy, choose_cache_policy
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import TrainConfig, make_train_step

META = torch.device("meta")


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def param_structs(cfg: ModelConfig, dtype: torch.dtype | None = None) -> T.TransformerLM:
    """The model on the meta device: matrices and the embedding in
    ``dtype`` (default the config's), as ``init_lm`` builds it."""
    return T.TransformerLM(cfg, META, dtype)


# Per-device weight budget above which parameters get additional data-axis
# (FSDP/ZeRO-3-style) sharding in the reference's layout.
FSDP_THRESHOLD_BYTES = 4 << 30


def maybe_fsdp_pspecs(cfg: ModelConfig, params, pspecs, mesh, bytes_per_param: int):
    tp = dict(mesh.shape)["model"]
    per_dev = cfg.param_count() * bytes_per_param / tp
    if per_dev <= FSDP_THRESHOLD_BYTES:
        return pspecs, False
    return zero_pspecs(params, pspecs, mesh), True


def batch_pspec() -> P:
    rules = shmod.get_rules() or shmod.SINGLE_POD_RULES
    return P(rules["batch"])


@dataclasses.dataclass
class LoweringSpec:
    """Everything the dry run traces for one cell."""

    fn: Any
    args: tuple  # meta tensors (and the models holding them)
    in_specs: tuple  # one spec tree per argument: the reference's in_shardings' specs
    donate_argnums: tuple = ()
    skip: str | None = None  # why the port runs no such layout (then nothing is traced)
    argument_bytes: int = 0  # what the port places, on its busiest device
    reference_argument_bytes: int | None = None  # per device under the spec trees (cells on a mesh)
    # serving cells on a mesh: what the port's leaves wider than the reference's bf16 (its f32 norm scales, MoE
    # routers and Mamba's f32 leaves) add per device, so that argument_bytes == reference_argument_bytes + dtype_surplus_bytes
    dtype_surplus_bytes: int | None = None
    device_args: list = dataclasses.field(default_factory=list)  # per device: the placed tensors


def _spec_bytes(shapes, specs, mesh, bytes_per: int) -> int:
    """Per-device bytes of a reference-layout tree of ``shapes`` under
    ``specs`` (each dim split over the product of its axes' sizes), at
    ``bytes_per`` bytes an element."""
    if isinstance(specs, dict):
        return sum(_spec_bytes(shapes[k], specs[k], mesh, bytes_per) for k in specs)
    n = 1
    parts = list(specs) + [None] * (len(shapes.shape) - len(specs))
    for dim, axes in zip(shapes.shape, parts):
        split = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a is not None:
                split *= mesh.shape[a]
        n *= -(-dim // split)
    return n * bytes_per


# ------------------------------------------------------------------ train
MICRO_BATCH_PER_DEVICE = 4  # activation-memory budget knob


def _data_axis_size(mesh) -> int:
    return shmod.data_axes_and_size(mesh, shmod.get_rules() or shmod.SINGLE_POD_RULES)[1]


def train_cell(cfg: ModelConfig, shape: InputShape, mesh) -> LoweringSpec:
    data_size = _data_axis_size(mesh)
    accum = max(1, shape.global_batch // (data_size * MICRO_BATCH_PER_DEVICE))
    micro = shape.global_batch // accum
    tcfg = TrainConfig(grad_accum=accum)

    params = param_structs(cfg, torch.float32).requires_grad_(True)
    pspecs = shmod.param_pspecs(params)
    mspecs = zero_pspecs(params, pspecs, mesh)
    pspecs, _ = maybe_fsdp_pspecs(cfg, params, pspecs, mesh, bytes_per_param=4)
    state_specs = {"params": pspecs, "opt": {"m": mspecs, "v": mspecs, "count": P()}, "step": P()}

    bp = batch_pspec()

    def bshape(*tail):
        return (accum, micro, *tail) if accum > 1 else (micro, *tail)

    def bspec(*tail):
        lead = (None,) if accum > 1 else ()
        return P(*(lead + tuple(bp) + tail))

    n_vis = cfg.num_vision_tokens if cfg.frontend == "vit_stub" else 0
    batch: dict[str, Any] = {"tokens": _struct(bshape(shape.seq_len + 1 - n_vis), torch.int32)}
    batch_specs: dict[str, Any] = {"tokens": bspec()}
    if n_vis:
        batch["vision_embeds"] = _struct(bshape(n_vis, cfg.d_model), torch.bfloat16)
        batch_specs["vision_embeds"] = bspec(None, None)
    if cfg.is_encdec:
        batch["encoder_frames"] = _struct(bshape(cfg.encoder_seq_len, cfg.d_model), torch.bfloat16)
        batch_specs["encoder_frames"] = bspec(None, None)

    step = torch.zeros((), dtype=torch.int32, device=META)
    state = {"params": params, "opt": adamw_init(dict(params.named_parameters())), "step": step}
    shapes = zero._shapes(params)
    scalars = 2 * 4  # count and step, int32
    batch_bytes = sum(_nbytes(t) for t in batch.values())
    ref_bytes = (_spec_bytes(shapes, pspecs, mesh, 4) + 2 * _spec_bytes(shapes, mspecs, mesh, 4) + scalars
                 + batch_bytes // data_size)
    if mesh.size == 1:
        step_fn, placed = make_train_step(cfg, tcfg), [state]
    else:
        roles = RoleMesh(mesh)
        with roles:
            step_fn = make_train_step(cfg, tcfg, grad_pspecs=mspecs, param_pspecs=pspecs)
            state = zero.place_train_state(state, roles, mspecs, param_specs=pspecs)
        placed = [{"params": state["params"][q], "step": state["step"][q],
                   "opt": {k: state["opt"][k][q] for k in ("m", "v", "count")}} for q in range(roles.size)]
    per_device = [[*d["params"].parameters(), *d["opt"]["m"].values(), *d["opt"]["v"].values(),
                   d["opt"]["count"], d["step"]] for d in placed]
    return LoweringSpec(
        fn=step_fn,
        args=(state, batch),
        in_specs=(state_specs, batch_specs),
        donate_argnums=(0,),
        argument_bytes=max(sum(_nbytes(t) for t in ts) for ts in per_device) + batch_bytes // data_size,
        reference_argument_bytes=ref_bytes,
        device_args=per_device,
    )


# ---------------------------------------------------------------- prefill
def _serving(cfg: ModelConfig, shape: InputShape, mesh):
    """(data size, cache policy, the model on meta, its serving specs,
    why the mesh's steps do not serve the cell or None) of a prefill or
    decode cell."""
    data_size = _data_axis_size(mesh)
    tp = dict(mesh.shape)["model"]
    policy = choose_cache_policy(cfg, tp, shape.global_batch, data_size)
    params = param_structs(cfg)
    pspecs = shmod.param_pspecs(params)
    pspecs, _ = maybe_fsdp_pspecs(cfg, params, pspecs, mesh, bytes_per_param=2)
    skip = None if mesh.size == 1 else D.mesh_serving_gap(cfg, policy, pspecs, mesh)
    return data_size, policy, params, pspecs, skip


def _placed_params(params, pspecs, mesh) -> tuple:
    """(the mesh's RoleMesh, ``params`` placed on it under ``pspecs``)."""
    roles = RoleMesh(mesh)
    return roles, zero.place_params(params, roles, pspecs)


def _param_spec_bytes(params, pspecs, mesh) -> tuple[int, int]:
    """(per-device bytes of the serving weights under ``pspecs`` at the
    reference's 2 bytes a parameter, what the port's leaves wider than
    that add: its f32 norm scales, MoE routers and Mamba's conv, dt, A
    and D)."""
    shapes = T.stack_jax_layout(params.named_parameters())

    def surplus(shapes, specs) -> int:
        if isinstance(specs, dict):
            return sum(surplus(shapes[k], specs[k]) for k in specs)
        return _spec_bytes(shapes, specs, mesh, max(shapes.element_size() - 2, 0))

    return _spec_bytes(shapes, pspecs, mesh, 2), surplus(shapes, pspecs)


def prefill_cell(cfg: ModelConfig, shape: InputShape, mesh) -> LoweringSpec:
    data_size, policy, params, pspecs, skip = _serving(cfg, shape, mesh)

    n_vis = cfg.num_vision_tokens if cfg.frontend == "vit_stub" else 0
    tokens = _struct((shape.global_batch, shape.seq_len - n_vis), torch.int32)
    max_len = shape.seq_len

    kw_structs: dict[str, Any] = {}
    kw_specs: dict[str, Any] = {}
    bp = batch_pspec()
    if n_vis:
        kw_structs["vision_embeds"] = _struct((shape.global_batch, n_vis, cfg.d_model), torch.bfloat16)
        kw_specs["vision_embeds"] = P(*(tuple(bp) + (None, None)))
    if cfg.is_encdec:
        kw_structs["encoder_frames"] = _struct((shape.global_batch, cfg.encoder_seq_len, cfg.d_model),
                                               torch.bfloat16)
        kw_specs["encoder_frames"] = P(*(tuple(bp) + (None, None)))
    inputs = sum(_nbytes(t) for t in [tokens, *kw_structs.values()])

    if mesh.size == 1 or skip:
        def prefill_fn(params, tokens, kw=None):
            return D.prefill(params, cfg, tokens, max_len=max_len, kv_repeat=policy.kv_repeat, **(kw or {}))

        first, placed, ref_bytes, surplus, data_size = params, [params], None, None, 1
    else:
        roles, placed = _placed_params(params, pspecs, mesh)
        step = D.make_mesh_prefill(cfg, roles, pspecs, policy)

        def prefill_fn(params, tokens, kw=None):
            return step(params, tokens, max_len=max_len, **(kw or {}))

        weights, surplus = _param_spec_bytes(params, pspecs, mesh)
        first, ref_bytes = placed, weights + inputs // data_size
    args, in_specs = (first, tokens), (pspecs, bp)
    if kw_structs:
        args, in_specs = args + (kw_structs,), in_specs + (kw_specs,)
    per_device = [list(c.parameters()) for c in placed]
    return LoweringSpec(
        fn=prefill_fn, args=args, in_specs=in_specs, skip=skip,
        argument_bytes=max(sum(_nbytes(t) for t in ts) for ts in per_device) + inputs // data_size,
        reference_argument_bytes=ref_bytes,
        dtype_surplus_bytes=surplus,
        device_args=per_device,
    )


# ----------------------------------------------------------------- decode
def cache_structs_and_specs(cfg: ModelConfig, shape: InputShape, policy: CachePolicy, mesh):
    cache = D.init_cache(cfg, shape.global_batch, shape.seq_len, kv_repeat=policy.kv_repeat, device=META)
    return cache, D.cache_pspecs(cache, policy, mesh)


def _cache_spec_bytes(cache: dict, specs: dict, mesh) -> int:
    """Per-device bytes of the reference's cache under ``specs``, each leaf
    at the reference's own dtype (``init_cache``'s: the KV cache and the
    hybrid's conv window in bf16, the recurrent states in f32)."""
    return sum(_spec_bytes(leaf, specs[k], mesh, leaf.element_size()) for k, leaf in cache.items())


def decode_cell(cfg: ModelConfig, shape: InputShape, mesh) -> LoweringSpec:
    data_size, policy, params, pspecs, skip = _serving(cfg, shape, mesh)
    cache, cache_specs = cache_structs_and_specs(cfg, shape, policy, mesh)

    token = _struct((shape.global_batch,), torch.int32)
    lengths = _struct((shape.global_batch,), torch.int32)
    split = shape.global_batch >= data_size  # else every device takes the rows whole
    bspec = batch_pspec() if split else P()
    inputs = _nbytes(token) + _nbytes(lengths)

    if mesh.size == 1 or skip:
        def serve_step(params, token, cache, lengths):
            return D.decode_step(params, cfg, token, cache, lengths, kv_repeat=policy.kv_repeat)

        args = (params, token, cache, lengths)
        per_device = [list(params.parameters()) + list(cache.values())]
        ref_bytes, surplus, data_size = None, None, 1
    else:
        roles, placed = _placed_params(params, pspecs, mesh)
        serve_step = D.make_mesh_decode_step(cfg, roles, pspecs, policy)
        caches = D.init_mesh_cache(cfg, roles, policy, shape.global_batch, shape.seq_len)
        args = (placed, token, caches, lengths)
        per_device = [list(c.parameters()) + list(mine.values()) for c, mine in zip(placed, caches)]
        weights, surplus = _param_spec_bytes(params, pspecs, mesh)
        data_size = data_size if split else 1
        ref_bytes = weights + _cache_spec_bytes(cache, cache_specs, mesh) + inputs // data_size
    return LoweringSpec(
        fn=serve_step,
        args=args,
        in_specs=(pspecs, bspec, cache_specs, bspec),
        donate_argnums=(2,),
        skip=skip,
        argument_bytes=max(sum(_nbytes(t) for t in ts) for ts in per_device) + inputs // data_size,
        reference_argument_bytes=ref_bytes,
        dtype_surplus_bytes=surplus,
        device_args=per_device,
    )


def build_cell(cfg: ModelConfig, shape_name: str | InputShape, mesh) -> LoweringSpec:
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if shape.kind == "train":
        return train_cell(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_cell(cfg, shape, mesh)
    return decode_cell(cfg, shape, mesh)
