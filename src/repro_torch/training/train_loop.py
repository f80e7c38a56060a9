"""LM training step and loop of the port: ``repro.training.train_loop`` —
the loss (f32 logits, z-loss), gradient accumulation, f32 master weights
with compute in the config dtype, checkpoint/restart, preemption and
straggler accounting.

The state is ``{"params", "opt", "step"}`` as the reference's:
``params`` the training state's :class:`~repro_torch.models.transformer.
TransformerLM` (f32 leaves that require grad), ``opt`` AdamW's ``m``
and ``v`` (f32, keyed by parameter name) and int32 ``count``, ``step``
an int32 tensor.  :func:`state_tree` gives it in the reference's pytree
layout (every layer group stacked under a leading layer axis), which is
what a checkpoint holds, so either package resumes from the other's.

Gradients come from ``torch.autograd.grad`` through
:func:`~repro_torch.models.transformer.forward_train`, each layer
rematerialised in the backward as the reference's ``jax.checkpoint``
does.  On the card attention is K3 forward and K3 backward
(``kernels/flash_attention``) and Mamba's scan (hymba-1.5b) K6 forward
and K6's backward (``kernels/selective_scan``); every model the port
configures trains there.

``make_train_step(grad_pspecs=...)`` under a current mesh
(``launch/mesh.py``) is the training mesh: data-parallel over the
rules' batch axes, tensor-parallel over "model" in the reference's layout
(every leaf whose spec names "model" stored as its slice: attention's
heads, the MLP's columns, the vocabulary, MoE's experts), ZeRO-1
moments (``distributed/zero.py``), FSDP where the parameters' specs name
the data axes too (each leaf stored as its data part and gathered layer
by layer), the gradients reduced with the ring
(``distributed/collectives.py``); its state is
``zero.place_train_state``'s, the parameters of each logical device.
Multi-host training is not ported: one process, host 0 of 1.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt_mod
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.distributed import zero
from repro_torch.distributed.fault_tolerance import PreemptionHandler, StragglerMonitor
from repro_torch.kernels import _build
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update, cosine_schedule

log = logging.getLogger("repro_torch.train")

def token_losses(params: T.TransformerLM, cfg: ModelConfig, tokens, targets, **fwd_kw) -> torch.Tensor:
    """Each token's next-token cross-entropy over f32 logits, with a 1e-4
    z-loss (B, S).  The VLM's logits at its vision tokens are cropped.
    Inside a training mesh's tensor shard that splits the vocabulary, over
    the split logits (:func:`_vocab_parallel_losses`)."""
    x = T.hidden_train(params, cfg, tokens, **fwd_kw)
    if cfg.frontend == "vit_stub" and fwd_kw.get("vision_embeds") is not None:
        x = x[:, fwd_kw["vision_embeds"].shape[1]:]
    shard = T.vocab_split(params, cfg)
    if shard is not None:
        return _vocab_parallel_losses(params, cfg, x, targets, shard)
    logits = T.logits_from(params, cfg, x).float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None])[..., 0] - logz
    return -ll + 1e-4 * torch.square(logz)


def _vocab_parallel_losses(params, cfg: ModelConfig, x, targets, shard) -> torch.Tensor:
    """:func:`token_losses` over the model group's vocab slices
    (``transformer.logits_parts``), never whole on one device: the rows'
    maxima all-gathered (the max's gradient is none), each device's sum of
    exps and its owned targets' logits (zero for the others) summed with
    the ring on the lead; logz = max + log(sum)."""
    parts = T.logits_parts(params, cfg, x, shard)
    devices = shard.devices
    maxes = []
    for dev, logits, _ in parts:
        with dev.scope():
            maxes.append(logits.detach().float().amax(-1, keepdim=True))
    maxes = C.all_gather(maxes, devices, -1, None, shard.tp)
    sums, picked = [], []
    for (dev, logits, start), mx, [t] in zip(parts, maxes, C.copy_leaves([targets], devices)):
        with dev.scope():
            logits, width = logits.float(), logits.shape[-1]
            top = mx.amax(-1, keepdim=True)
            sums.append(torch.exp(logits - top).sum(-1))
            local = t - start
            own = (local >= 0) & (local < width)
            got = torch.gather(logits, -1, local.clamp(0, width - 1)[..., None])[..., 0]
            picked.append(got.masked_fill(~own, 0))
    logz = maxes[0].amax(-1) + torch.log(C.ring_sum(sums, devices))
    ll = C.ring_sum(picked, devices) - logz
    return -ll + 1e-4 * torch.square(logz)


def lm_loss(params: T.TransformerLM, cfg: ModelConfig, tokens, targets, loss_mask=None, **fwd_kw):
    """:func:`token_losses`' mean over tokens, or over ``loss_mask``'s
    weight."""
    per_tok = token_losses(params, cfg, tokens, targets, **fwd_kw)
    if loss_mask is None:
        return per_tok.mean()
    return (per_tok * loss_mask).sum() / torch.clamp(loss_mask.sum(), min=1.0)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_accum: int = 1  # microbatches per optimizer step
    checkpoint_every: int = 500
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 3


def _batch_tensors(batch: dict, device) -> dict:
    """A batch's arrays as tensors on ``device``: token ids as int64."""
    return {key: torch.as_tensor(value).to(device, torch.int64 if key == "tokens" else torch.float32)
            for key, value in batch.items()}


def make_train_step(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    loss_fn: Callable | None = None,
    grad_pspecs=None,
    param_pspecs=None,
) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` = {tokens (B, S+1) int, optionally loss_mask, vision_embeds,
    encoder_frames}, arrays or tensors.  With ``grad_accum > 1`` the batch's
    leading axis is (accum, B_micro, ...) and gradients average over the
    microbatches in f32 accumulators, one microbatch at a time, as the
    reference's ``lax.scan``.  The state is updated in place (AdamW on the
    leaves, ``m`` and ``v``) and returned; metrics are 0-d tensors
    (``loss``, ``grad_norm``) on the state's device, not read back.

    ``grad_pspecs`` (``zero.zero_pspecs``' tree) makes it the training
    mesh's step over the mesh current here, under the rules current here
    (:func:`_mesh_train_step`); ``param_pspecs``, the parameters' tree the
    state was placed under (``zero.place_train_state``), makes it FSDP
    where it names the data axes."""
    schedule = cosine_schedule(tcfg.warmup_steps, tcfg.total_steps)
    if grad_pspecs is not None:
        mesh = S.current_mesh()
        if mesh is None:
            raise ValueError("grad_pspecs needs a current mesh: make the step inside `with make_mesh(...):`")
        return _mesh_train_step(cfg, tcfg, loss_fn, grad_pspecs, param_pspecs, mesh, S.get_rules(), schedule)
    loss_fn = loss_fn or lm_loss

    def compute_loss(params, batch):
        tokens = batch["tokens"]
        fwd_kw = {key: batch[key] for key in ("vision_embeds", "encoder_frames") if key in batch}
        return loss_fn(params, cfg, tokens[:, :-1], tokens[:, 1:], batch.get("loss_mask"), **fwd_kw)

    def value_and_grad(params, leaves, batch):
        loss = compute_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf this batch does not reach (the other cell of an xLSTM layer,
        # vis_proj without images) gets zeros, as jax.grad gives
        return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]

    def train_step(state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        names, leaves = zip(*params.named_parameters())
        # weight decay where the reference's leaf (a layer's stacked under a
        # leading layer axis) has ndim >= 2
        decay = {n: T.jax_ndim(n, p) >= 2 for n, p in zip(names, leaves)}
        batch = _batch_tensors(batch, leaves[0].device)
        if tcfg.grad_accum > 1:
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            for i in _build.repeat(tcfg.grad_accum):
                mb_loss, mb_grads = value_and_grad(params, leaves, {k: v[i] for k, v in batch.items()})
                loss = loss + mb_loss / tcfg.grad_accum
                for acc, g in zip(grads, mb_grads):
                    acc.add_(g / tcfg.grad_accum)
                del mb_grads
        else:
            loss, grads = value_and_grad(params, leaves, batch)
        _, new_opt, gnorm = adamw_update(dict(zip(names, grads)), opt, dict(zip(names, leaves)),
                                         tcfg.optimizer, schedule(step), decay=decay)
        del grads
        state = {"params": params, "opt": new_opt, "step": step + 1}
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _split_rows(batch: dict, n: int) -> list[dict]:
    """``batch``'s arrays cut into ``n`` equal contiguous parts of rows."""
    parts = [{} for _ in range(n)]
    for key, value in batch.items():
        if value.shape[0] % n:
            raise ValueError(f"{key}: {value.shape[0]} rows do not split over {n} data shards")
        pieces = torch.chunk(value, n) if torch.is_tensor(value) else np.split(np.asarray(value), n)
        for part, piece in zip(parts, pieces):
            part[key] = piece
    return parts


def _mesh_train_step(cfg: ModelConfig, tcfg: TrainConfig, loss_fn, grad_pspecs, param_pspecs, mesh, rules,
                     schedule):
    """The training mesh's step: ``train_step(state, batch) -> (state,
    metrics)`` over ``zero.place_train_state``'s state.

    The batch (each microbatch under ``grad_accum``) splits over the
    rules' batch axes.  Each data shard's forward and backward span its
    model group (``sharding.tensor_shard``): the residual stream and the
    replicated leaves' compute on its lead (model index 0), on that
    device's stream; attention on each model device's heads, the MLP on
    its columns, the vocabulary on its rows, each on its own stream; a
    split leaf the compute cannot use as its slice gathered before use; an
    MoE layer's expert-parallel branch on the shard's model devices
    (``sharding.expert_shard``).  Under FSDP (``param_pspecs`` naming the
    data axes) each layer, the embedding, the final norm and the LM head
    gather their leaves' data parts just before use
    (``sharding.gathered``), and the gathers' backward brings each part's
    gradient back to the device that stores it, summed over the shards in
    order; each shard's backward takes every device's parts.  Then, with
    the host never waiting:

    * a replicated leaf's gradients from the shard's other model devices
      (qk-norm scales in head-parallel attention) are summed into the
      lead's (an FSDP one's over each data index's model devices);
    * the gradients are summed with ``psum_in_chunks`` — a "model"-split
      leaf's (each device's slice) over the data devices of its model
      index, every other leaf's over the shards' leads, which then copy it
      to their other model devices (an FSDP part's is whole already);
    * the global norm and clip come from the reduced gradients (the same
      bits on every device, each device's in ``metrics["grad_norms"]``; a
      split leaf's squares summed over "model", an FSDP part's over its
      data column too);
    * each device runs AdamW (``optimizer.adamw_update``, the reference's
      order of operations) on its ZeRO slice of each parameter, ``m`` and
      ``v``;
    * the updated slices are all-gathered into every copy (an FSDP part
      is updated in place, with nothing to gather).

    The loss keeps the reference's denominators: with a ``loss_mask``,
    sum(per_tok * mask) / max(sum(mask), 1) over the whole (micro)batch,
    the mask sums reduced before the shards scale their sums; without one,
    the mean, as the mean of the equal shards' means.  A custom
    ``loss_fn`` is taken to be a mean over rows: each shard's is divided by
    the number of shards."""
    data_axes, data_size = S.data_axes_and_size(mesh, rules)
    batch_axes = data_axes if isinstance(data_axes, tuple) else (data_axes,)
    stray = [a for a, n in mesh.shape.items() if n > 1 and a not in batch_axes and a != "model"]
    if stray:
        raise ValueError(f"mesh axes {stray} are neither the rules' batch axes {batch_axes} nor 'model'")
    devices = mesh.flat
    pos_of = {id(dev): pos for pos, dev in enumerate(devices)}
    shards = [[pos_of[id(dev)] for dev in group] for group in mesh.model_groups(data_axes)]
    leads = [group[0] for group in shards]
    accum = tcfg.grad_accum

    def shard_loss(params, batch, denom):
        tokens = batch["tokens"]
        fwd_kw = {key: batch[key] for key in ("vision_embeds", "encoder_frames") if key in batch}
        if loss_fn is not None:
            return loss_fn(params, cfg, tokens[:, :-1], tokens[:, 1:], batch.get("loss_mask"), **fwd_kw) / data_size
        per_tok = token_losses(params, cfg, tokens[:, :-1], tokens[:, 1:], **fwd_kw)
        if denom is None:
            return per_tok.mean() / data_size
        return (per_tok * batch["loss_mask"]).sum() / torch.clamp(denom, min=1.0)

    def train_step(state, batch):
        copies = state["params"]
        if len(copies) != mesh.size:
            raise ValueError(f"a state of {len(copies)} copies on a mesh of {mesh.size} devices")
        with mesh, S.use_rules(rules):
            layout = zero.Layout(copies[0], mesh, grad_pspecs, rules, param_pspecs)
            named = [dict(c.named_parameters()) for c in copies]
            names = layout.names
            # FSDP leaves (each device's data part), and the rest: "model"-split or replicated
            fsdp = [n for n in names if layout.fsdp_dim[n] is not None]
            split = [n for n in names if layout.model_dim[n] is not None and layout.fsdp_dim[n] is None]
            replicated = [n for n in names if layout.model_dim[n] is None and layout.fsdp_dim[n] is None]
            held = [[n for n in fsdp if layout.holds(n, q)] for q in range(len(devices))]
            caller = C._enter(devices)
            mb_batches = [batch] if accum == 1 else [{k: v[i] for k, v in batch.items()} for i in range(accum)]
            moe_names = [name for name, mod in copies[0].named_modules() if isinstance(mod, T.MoE)]
            ep_groups = [{copies[group[0]].get_submodule(mn): [(devices[q], copies[q].get_submodule(mn)) for q in group]
                          for mn in moe_names} for group in shards]
            tensor_shards = [S.TensorShard([devices[q] for q in group], [copies[q] for q in group], layout.model_dim,
                                           layout.tp) if len(group) > 1 else None for group in shards]
            data_shards = S.DataShards(devices, copies, layout) if fsdp else None
            grads: list[dict] = [{} for _ in devices]
            losses = {}
            for m in _build.repeat(len(mb_batches)):
                mb = mb_batches[m]
                parts = _split_rows(mb, data_size)
                tensors = {}
                for i, lead in enumerate(leads):
                    with devices[lead].scope():
                        tensors[i] = _batch_tensors(parts[i], devices[lead].device)
                denoms = None
                if "loss_mask" in mb and loss_fn is None:
                    sums = []
                    for i, lead in enumerate(leads):
                        with devices[lead].scope():
                            sums.append(tensors[i]["loss_mask"].sum())
                    denoms = C.ring_allreduce(sums, [devices[q] for q in leads])
                for i, group in enumerate(shards):
                    lead = group[0]
                    with (devices[lead].scope(), S.expert_shard(ep_groups[i]), S.tensor_shard(tensor_shards[i]),
                          S.data_shards(data_shards)):
                        # the group's own leaves, and every FSDP part its layers gather from the others
                        leaves = [(q, n, named[q][n]) for q in group for n in names]
                        leaves += [(q, n, named[q][n]) for q in range(len(devices)) if q not in group for n in held[q]]
                        loss = shard_loss(copies[lead], tensors[i], None if denoms is None else denoms[i])
                        with warnings.catch_warnings():
                            # an FSDP part's gradient comes from a gather run on another device's stream: the
                            # engine's wait for it is the order wanted
                            warnings.filterwarnings("ignore", "The AccumulateGrad node's stream does not match")
                            got = torch.autograd.grad(loss, [w for _, _, w in leaves], allow_unused=True)
                        part = loss.detach() if accum == 1 else loss.detach() / accum
                        losses[i] = part if i not in losses else losses[i] + part
                        # on the lead's stream, where autograd leaves every gradient ready; an FSDP part's
                        # summed over the shards (and microbatches) in order, on its own device's stream
                        if fsdp:
                            C._enter(devices)
                        members = []  # the last model device's sums on the lead's stream
                        for (q, n, w), g in zip(leaves, got):
                            if g is None:
                                continue
                            if layout.fsdp_dim[n] is not None:
                                with devices[q].scope():
                                    C._used_on(g, devices[q])
                                    if n not in grads[q]:
                                        grads[q][n] = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                                    grads[q][n].add_(g if accum == 1 else g / accum)
                            elif accum > 1 and q == group[-1] != lead:
                                members.append((q, n, w, g))
                            elif accum > 1:
                                if n not in grads[q]:
                                    grads[q][n] = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                                grads[q][n].add_(g / accum)
                            else:
                                grads[q][n] = g
                        # on a RoleMesh the last model device stands for those the group leaves out
                        with _build.counted(layout.tp - len(group) + 1):
                            for q, n, w, g in members:
                                if n not in grads[q]:
                                    grads[q][n] = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                                grads[q][n].add_(g / accum)
                        del got, members
            C.barrier(devices)  # every backward's gradients, on whichever stream made them
            for group in shards:
                # replicated leaves the shard's other model devices used too
                extra = [n for n in replicated if any(n in grads[q] for q in group[1:])]
                for q in group:  # zeros where a device computed none of a leaf it reduces
                    with devices[q].scope():
                        for n in (split + replicated if q == group[0] else split + extra) + held[q]:
                            if n not in grads[q]:
                                grads[q][n] = torch.zeros(named[q][n].shape, dtype=torch.float32,
                                                          device=named[q][n].device)
                if extra:
                    trees = C.psum_in_chunks([[grads[q][n] for n in extra] for q in group], [devices[q] for q in group])
                    grads[group[0]].update(zip(extra, trees[0]))
                # an FSDP leaf replicated over "model" (a norm's scale): each model device's share of it
                rep = [n for n in held[group[0]] if layout.model_dim[n] is None]
                if len(group) > 1 and rep:
                    trees = C.psum_in_chunks([[grads[q][n] for n in rep] for q in group], [devices[q] for q in group])
                    for q, tree in zip(group, trees):
                        grads[q].update(zip(rep, tree))
            # an FSDP part's gradient is whole: the gathers' backward reduced it to its device
            reduced = [dict(g) for g in grads]
            for group_names, groups in ((replicated, [leads]), (split, [layout.column(q) for q in shards[0]])):
                if not group_names:
                    continue
                for group in groups:
                    trees = C.psum_in_chunks([[grads[q][n] for n in group_names] for q in group],
                                             [devices[q] for q in group])
                    for q, tree in zip(group, trees):
                        reduced[q].update(zip(group_names, tree))
            for group in shards:  # a lead's reduced leaves to its shard's other model devices
                if len(group) > 1 and replicated:
                    got = C.copy_leaves([reduced[group[0]][n] for n in replicated], [devices[q] for q in group[1:]])
                    for q, mine in zip(group[1:], got):
                        reduced[q].update(zip(replicated, mine))
            del grads
            loss_total = C.ring_allreduce([losses[i] for i in range(len(leads))], [devices[q] for q in leads])[0]
            # the global norm: every leaf's squares; a split leaf's summed over "model", an FSDP part's
            # over its data column too
            norms, sq_split, sq_fsdp = [], [], []
            for q, dev in enumerate(devices):
                with dev.scope():
                    norms.append(_sum_squares([reduced[q][n] for n in replicated], dev))
                    if split:
                        sq_split.append(_sum_squares([reduced[q][n] for n in split], dev))
                    if fsdp:
                        sq_fsdp.append([_sum_squares([reduced[q][n] for n in held[q] if layout.model_dim[n] is None], dev),
                                        _sum_squares([reduced[q][n] for n in held[q] if layout.model_dim[n] is not None],
                                                     dev)])
            if split:
                for group in shards:
                    total = C.ring_allreduce([sq_split[q] for q in group], [devices[q] for q in group])
                    for q, t in zip(group, total):
                        with devices[q].scope():
                            norms[q] = norms[q] + t
            if fsdp:
                for group in shards:  # over "model", then each column's sum over the data axes
                    total = C.ring_allreduce([sq_fsdp[q][1] for q in group], [devices[q] for q in group])
                    for q, t in zip(group, total):
                        with devices[q].scope():
                            sq_fsdp[q] = sq_fsdp[q][0] + t
                for q0 in shards[0]:
                    column = layout.column(q0)
                    total = C.ring_allreduce([sq_fsdp[q] for q in column], [devices[q] for q in column])
                    for q, t in zip(column, total):
                        with devices[q].scope():
                            norms[q] = norms[q] + t
            new_counts, new_steps = [], []
            for q, dev in enumerate(devices):
                with dev.scope():
                    gnorm = norms[q].sqrt()
                    norms[q] = gnorm
                    own = {n: layout.moment_slice(n, q, named[q][n].shape) for n in state["opt"]["m"][q]}
                    p_sl = {n: zero.take(named[q][n], sl) for n, sl in own.items()}
                    g_sl = {n: zero.take(reduced[q][n], sl) for n, sl in own.items()}
                    decay = {n: T.jax_ndim(n, named[q][n]) >= 2 for n in own}
                    _, new_opt, _ = adamw_update(
                        g_sl, {"m": state["opt"]["m"][q], "v": state["opt"]["v"][q], "count": state["opt"]["count"][q]},
                        p_sl, tcfg.optimizer, schedule(state["step"][q]), decay=decay, norm=gnorm)
                    new_counts.append(new_opt["count"])
                    new_steps.append(state["step"][q] + 1)
            del reduced
            # the all-gather: each device's updated slices into every copy of its column (an FSDP
            # part is the whole of what its device stores: nothing to gather)
            sharded = [n for n in split + replicated if layout.zero_dim[n] is not None]

            def owned(n, s, t):
                sl = layout.moment_slice(n, s, named[s][n].shape)
                return None if sl is None else zero.take(t, sl)

            if sharded:
                C.all_gather_([{n: named[q][n] for n in sharded} for q in range(len(devices))], devices,
                              [layout.column(q) for q in range(len(devices))], owned)
            C._leave(devices, caller, [loss_total, *norms])
        state = {"params": copies, "opt": {"m": state["opt"]["m"], "v": state["opt"]["v"], "count": new_counts},
                 "step": new_steps}
        return state, {"loss": loss_total, "grad_norm": norms[0], "grad_norms": norms}

    return train_step


def _sum_squares(ts: list, dev) -> torch.Tensor:
    """The sum of the squares of every element of ``ts`` (f32, 0 for
    none), on ``dev``."""
    if not ts:
        return torch.zeros((), dtype=torch.float32, device=dev.device)
    return torch.stack(torch._foreach_norm(ts)).square().sum()


def init_train_state(cfg: ModelConfig, key=None, device: str | torch.device | None = "cuda") -> dict:
    """{params, opt, step}: the f32 training model drawn from ``key`` (a
    seed or a ``torch.Generator`` on the device; default seed 0), AdamW's
    zeros, step 0."""
    dev = resolve_device(device)
    gen = key if isinstance(key, torch.Generator) else torch.Generator(device=dev).manual_seed(
        0 if key is None else int(key))
    params = T.init_lm(cfg, gen, dev, train=True)
    return {"params": params, "opt": adamw_init(dict(params.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def state_tree(state: dict) -> dict:
    """The state in the reference's pytree layout: ``params``, ``opt``'s
    ``m`` and ``v`` as ``init_lm``'s nested dicts (each layer group stacked
    under a leading layer axis), ``count`` and ``step`` int32 scalars —
    what ``train`` checkpoints (tensors on the state's device, or on
    ``meta`` for the shapes alone)."""
    opt = state["opt"]
    return {
        "params": T.to_jax_layout(state["params"]),
        "opt": {"m": T.stack_jax_layout(opt["m"].items()), "v": T.stack_jax_layout(opt["v"].items()),
                "count": opt["count"]},
        "step": state["step"],
    }


@torch.no_grad()
def load_state_tree(state: dict, tree: dict) -> dict:
    """Copy a reference-layout state tree (numpy leaves, e.g. a restored
    checkpoint) into ``state`` in place; returns ``state``."""
    opt = state["opt"]
    T.load_jax_layout(state["params"].named_parameters(), tree["params"], "params")
    T.load_jax_layout(opt["m"].items(), tree["opt"]["m"], "opt.m")
    T.load_jax_layout(opt["v"].items(), tree["opt"]["v"], "opt.v")
    opt["count"].fill_(int(np.asarray(tree["opt"]["count"])))
    state["step"].fill_(int(np.asarray(tree["step"])))
    return state


def train(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    data_iter,
    num_steps: int,
    key=None,
    state: dict | None = None,
    preemption: PreemptionHandler | None = None,
    log_every: int = 10,
    device: str | torch.device | None = "cuda",
    on_step: Callable | None = None,
) -> tuple[dict, list[dict]]:
    """Single-host training loop with checkpoint/restart, preemption and
    straggler accounting; resumes from ``tcfg.checkpoint_dir`` if it holds
    a checkpoint (one the reference wrote included).  ``history`` holds
    the reference's dicts, {step, loss, sec}; ``on_step(i, state,
    metrics)``, if given, sees each step's state and metrics."""
    dev = resolve_device(device) if state is None else state["params"].embed.device
    if state is None:
        state = init_train_state(cfg, key, dev)
        if tcfg.checkpoint_dir and ckpt_mod.latest_step(tcfg.checkpoint_dir) is not None:
            tree, at = ckpt_mod.restore(tcfg.checkpoint_dir, None, state_tree_shapes(state))
            load_state_tree(state, tree)
            log.info("restored checkpoint at step %d", at)

    step_fn = make_train_step(cfg, tcfg)
    preemption = preemption or PreemptionHandler(install=False)
    monitor = StragglerMonitor()
    history: list[dict] = []
    start = int(state["step"])
    for i in range(start, start + num_steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.observe(i, dt)
        history.append({"step": i, "loss": loss, "sec": dt})
        if on_step is not None:
            on_step(i, state, metrics)
        if i % log_every == 0:
            log.info("step %d loss %.4f (%.3fs)", i, loss, dt)
        should_ckpt = tcfg.checkpoint_dir and (
            (i + 1) % tcfg.checkpoint_every == 0 or preemption.should_stop
        )
        if should_ckpt:
            ckpt_mod.save(tcfg.checkpoint_dir, i + 1, state_tree(state), keep=tcfg.keep_checkpoints)
        if preemption.should_stop:
            log.warning("stopping at step %d on preemption request", i)
            break
    return state, history


def state_tree_shapes(state: dict) -> dict:
    """:func:`state_tree`'s layout with shape-only leaves (``meta``
    tensors): a restore target that copies nothing."""
    def meta(named):
        return T.stack_jax_layout((name, torch.empty(t.shape, device="meta")) for name, t in named)

    opt, scalar = state["opt"], torch.empty((), device="meta")
    return {"params": meta(state["params"].named_parameters()),
            "opt": {"m": meta(opt["m"].items()), "v": meta(opt["v"].items()), "count": scalar},
            "step": scalar}
