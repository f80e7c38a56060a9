"""AdamW and the cosine schedule of the port: ``repro.training.optimizer``
over trees of tensors (nested dicts, lists or tuples; a dict's leaves in
sorted-key order, as ``jax.tree.leaves`` orders them).

The arithmetic is the reference's: f32 ``m`` and ``v``, the global-norm
clip, bias corrections from an f32 ``count``, weight decay only on leaves
with ``ndim >= 2``, the update in f32 and cast back to the leaf's dtype,
and a schedule that gives lr 0 at step 0.  The reference counts ``ndim``
in its own layout, where every layer group is stacked under a leading
layer axis, so a layer's norm scale (L, D) is decayed and the final norm's
(D,) is not; the train step passes that as ``decay``.  ``torch.optim.AdamW`` is not
used: it decays every leaf and rounds in another order.

Where the reference returns new trees, :func:`adamw_update` updates the
parameters, ``m`` and ``v`` in place (under ``no_grad``) and returns the
same objects: a 1B-parameter model's f32 leaves, grads, ``m`` and ``v``
are 16 GB, and a second copy of three of them would not be needed.  The
update runs as ``torch._foreach_*`` passes over groups of leaves of at
most :data:`GROUP_BYTES`, which bounds its temporaries (the clipped grads,
the denominator and the step of one group).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

# f32 bytes of the leaves one pass of the update takes at a time
GROUP_BYTES = 512 * 2**20


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree) -> list:
    """The tensors of ``tree``: a dict's in sorted-key order, a list's or
    tuple's in order, depth first."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn, tree):
    """``tree``'s structure with ``fn`` applied to each leaf."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key]) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, node) for node in tree)
    return fn(tree)


def adamw_init(params) -> dict:
    """f32 zeros for ``m`` and ``v`` in ``params``' structure, and an int32
    ``count`` of 0, on the parameters' device."""
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor)."""
    leaves = [g.float() for g in tree_leaves(tree)]
    norms = torch._foreach_norm(leaves, 2)
    return torch.stack(norms).square().sum().sqrt()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(``grads`` scaled by min(1, max_norm / max(norm, 1e-9)), the norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def _groups(n_bytes: list[int]) -> list[list[int]]:
    """Consecutive leaf indices in groups of at most GROUP_BYTES (a larger
    leaf is a group of its own)."""
    groups, cur, size = [], [], 0
    for i, nb in enumerate(n_bytes):
        if cur and size + nb > GROUP_BYTES:
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nb
    if cur:
        groups.append(cur)
    return groups


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig, lr_scale=1.0, decay=None):
    """One AdamW step; ``lr_scale`` multiplies cfg.lr (the schedule's
    output); ``decay``, a tree of bools in ``params``' structure, says
    which leaves weight decay applies to (default: ``ndim >= 2``).
    Updates ``params``, ``state["m"]`` and ``state["v"]`` in place ->
    (params, {"m", "v", "count": count + 1}, the grads' global norm before
    the clip)."""
    flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
    flat_d = [p.ndim >= 2 for p in flat_p] if decay is None else tree_leaves(decay)
    flat_m, flat_v = tree_leaves(state["m"]), tree_leaves(state["v"])
    if not (len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v)):
        raise ValueError(f"{len(flat_p)} params, {len(flat_g)} grads, {len(flat_m)} m, {len(flat_v)} v")
    gnorm = global_norm(flat_g)
    clip = _clip_scale(gnorm, cfg.grad_clip)
    count = state["count"] + 1
    count_f = count.float()
    b1c = 1.0 - torch.pow(cfg.b1, count_f)
    b2c = 1.0 - torch.pow(cfg.b2, count_f)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=count.device)
    for idx in _groups([p.numel() * 4 for p in flat_p]):
        ps = [flat_p[i] for i in idx]
        ms, vs = [flat_m[i] for i in idx], [flat_v[i] for i in idx]
        gs = torch._foreach_mul([flat_g[i].float() for i in idx], clip)
        torch._foreach_mul_(ms, cfg.b1)
        torch._foreach_add_(ms, gs, alpha=1 - cfg.b1)
        torch._foreach_mul_(vs, cfg.b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - cfg.b2)
        del gs
        denom = torch._foreach_div(vs, b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        step = torch._foreach_div(ms, b1c)
        torch._foreach_div_(step, denom)
        del denom
        p32 = [p if p.dtype == torch.float32 else p.float() for p in ps]
        decayed = [j for j, i in enumerate(idx) if flat_d[i]]
        if decayed and cfg.weight_decay:
            torch._foreach_add_([step[j] for j in decayed], [p32[j] for j in decayed], alpha=cfg.weight_decay)
        torch._foreach_mul_(step, lr)
        torch._foreach_sub_(p32, step)
        for p, new in zip(ps, p32):
            if new is not p:
                p.copy_(new)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    return params, new_state, gnorm


def cosine_schedule(warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an int tensor) -> the lr scale, f32: a linear warmup from 0
    (0 at step 0), then a cosine from 1 down to ``min_ratio``."""
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        return warm * cos

    return fn
