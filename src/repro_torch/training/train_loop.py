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
configures trains there.  ``grad_pspecs`` (the reference's ZeRO
sharding constraints) has no meaning on one device and raises (the mesh
is ROADMAP item 23).
Multi-host training is not ported: one process, host 0 of 1.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt_mod
from repro_torch.distributed.fault_tolerance import PreemptionHandler, StragglerMonitor
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update, cosine_schedule

log = logging.getLogger("repro_torch.train")

def lm_loss(params: T.TransformerLM, cfg: ModelConfig, tokens, targets, loss_mask=None, **fwd_kw):
    """Next-token cross-entropy over f32 logits, with a 1e-4 z-loss; mean
    over tokens, or over ``loss_mask``'s weight.  The VLM's logits at its
    vision tokens are cropped."""
    logits = T.forward_train(params, cfg, tokens, **fwd_kw).float()
    if cfg.frontend == "vit_stub" and fwd_kw.get("vision_embeds") is not None:
        logits = logits[:, fwd_kw["vision_embeds"].shape[1]:]
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None])[..., 0] - logz
    per_tok = -ll + 1e-4 * torch.square(logz)
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
) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` = {tokens (B, S+1) int, optionally loss_mask, vision_embeds,
    encoder_frames}, arrays or tensors.  With ``grad_accum > 1`` the batch's
    leading axis is (accum, B_micro, ...) and gradients average over the
    microbatches in f32 accumulators, one microbatch at a time, as the
    reference's ``lax.scan``.  The state is updated in place (AdamW on the
    leaves, ``m`` and ``v``) and returned; metrics are 0-d tensors
    (``loss``, ``grad_norm``) on the state's device, not read back."""
    if grad_pspecs is not None:
        raise NotImplementedError("grad_pspecs shards gradients over a mesh; the port trains on one device "
                                  "(the mesh is ROADMAP item 23)")
    loss_fn = loss_fn or lm_loss
    schedule = cosine_schedule(tcfg.warmup_steps, tcfg.total_steps)

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
            for i in range(tcfg.grad_accum):
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
