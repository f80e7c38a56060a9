"""Plain PyTorch version of the fused resample + affine kernel."""

from __future__ import annotations

import torch


def resize_affine_planar(
    x: torch.Tensor,  # (B, H, W) f32 planes
    y0: torch.Tensor,  # (OH,) int32 upper source row per output row
    y1: torch.Tensor,  # (OH,) int32 lower source row
    wy: torch.Tensor,  # (OH,) f32 weight of the lower row
    x0: torch.Tensor,  # (OW,) int32 left source column per output column
    x1: torch.Tensor,  # (OW,) int32 right source column
    wx: torch.Tensor,  # (OW,) f32 weight of the right column
    scale: torch.Tensor,  # (B,) f32 per-plane multiplier
    bias: torch.Tensor,  # (B,) f32 per-plane offset
    round_uint8: bool = False,
) -> torch.Tensor:
    """Bilinear gather resample -> optional clip+round to [0, 255] -> affine.

    The expression tree is that of ``repro.core.device_compiler.
    _resize_affine_jnp`` (and of ``preprocessing.ops._bilinear_resize``),
    one rounding per operation, so ``csrc/fused_preproc.cu`` matches it
    bit for bit."""
    y0, y1, x0, x1 = (t.long() for t in (y0, y1, x0, x1))
    wy = wy[:, None]
    wx = wx[None, :]
    rows0 = x[:, y0]
    rows1 = x[:, y1]
    a = rows0[:, :, x0]
    b = rows0[:, :, x1]
    c = rows1[:, :, x0]
    d = rows1[:, :, x1]
    top = a + (b - a) * wx
    bot = c + (d - c) * wx
    out = top + (bot - top) * wy
    if round_uint8:
        out = torch.clamp(torch.round(out), 0.0, 255.0)
    return out * scale[:, None, None] + bias[:, None, None]
