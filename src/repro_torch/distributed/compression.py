"""Gradient compression with error feedback for the cross-pod hop: the
port of ``repro.distributed.compression``.

The production meshes reduce gradients over "data" (in-pod, fast) and
"pod" (inter-pod links, the scarce resource).  int8 + a per-tensor scale
cuts the pod-axis all-reduce bytes 4x against f32; error feedback carries
the quantization residual into the next step's gradient so the noise does
not bias the trajectory.

The arithmetic is the reference's: ``torch.round`` rounds half to even as
``jnp.round`` does, and ``x / scale`` is divided, not multiplied by a
reciprocal, so ``q``, ``scale`` and the residual are its bits.
:func:`compressed_psum_pod` takes one part per device of the pod axis, as
``collectives.ring_allreduce`` does.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization.  Returns (q, scale)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_quantize(x: torch.Tensor, error: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantization: quantize (x + carried error), carry the
    new residual.  Returns (q, scale, new_error)."""
    corrected = x + error
    q, scale = quantize_int8(corrected)
    new_error = corrected - dequantize_int8(q, scale)
    return q, scale, new_error


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compress_gradients(grads, error_state):
    """Tree-wise EF-int8 compression.  Returns ((q_tree, scale_tree),
    new_error_state)."""
    qs, scales, errs = [], [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(error_state)):
        q, s, ne = ef_quantize(g.float(), e)
        qs.append(q)
        scales.append(s)
        errs.append(ne)
    return (tree_unflatten(grads, qs), tree_unflatten(grads, scales)), tree_unflatten(grads, errs)


def decompress_gradients(compressed):
    q_tree, scale_tree = compressed
    return tree_unflatten(q_tree, (dequantize_int8(q, s) for q, s in zip(tree_leaves(q_tree), tree_leaves(scale_tree))))


def compressed_psum_pod(parts: list, errors: list, devices) -> tuple[list, list]:
    """All-reduce ``parts`` (``parts[i]`` on ``devices[i]``) moving int8
    instead of f32.

    Each device quantizes its part locally (with error feedback), every
    device gathers every int8 payload and f32 scale (n/4 bytes a part
    against f32's n), then dequantizes and sums locally.  Returns (the
    sums, the new errors), one per device."""
    p = len(devices)
    caller = C._enter(devices)
    quant = []
    for part, err, dev in zip(parts, errors, devices):
        with dev.scope():
            quant.append(ef_quantize(part.float(), err))
    C.barrier(devices)
    totals = []
    for dev in devices:
        with dev.scope():
            all_q = torch.empty((p, *quant[0][0].shape), dtype=torch.int8, device=quant[0][0].device)
            all_s = torch.empty(p, dtype=torch.float32, device=all_q.device)
            for j, (q, s, _) in enumerate(quant):  # the all-gather: one copy per source
                C._used_on(q, dev)
                C._used_on(s, dev)
                all_q[j].copy_(q)
                all_s[j].copy_(s)
            scales = all_s.reshape((-1,) + (1,) * (all_q.dim() - 1))
            totals.append((all_q.float() * scales).sum(dim=0))
    new_errors = [e for _, _, e in quant]
    C._leave(devices, caller, totals + new_errors)
    return totals, new_errors


def compression_ratio(grads) -> float:
    """Wire-bytes ratio of EF-int8 vs f32 for a gradient tree."""
    leaves = tree_leaves(grads)
    f32 = sum(g.numel() * 4 for g in leaves)
    int8 = sum(g.numel() * 1 + 4 for g in leaves)
    return f32 / int8
