"""Plain PyTorch version of the blocks-to-RGB kernel."""

from __future__ import annotations

import torch


def rgb_unrounded(luma: torch.Tensor, chroma: torch.Tensor, mat: torch.Tensor, grid) -> torch.Tensor:
    """(N, 3, hs, ws) f32 RGB before the final round and clamp.

    Unblockify, 2x2 nearest chroma upsample (4:2:0), crop, then the
    reference's level shift and colour conversion (``repro.core.
    device_compiler``'s split-decode tail) as explicit elementwise ops, one
    rounding each, in its order: ``y + 128``, ``(c + 128) - 128``, and per
    output row ``(m[r,0] y1 + m[r,1] cb1) + m[r,2] cr1`` with all three
    terms.  ``csrc/blocks_to_rgb.cu`` computes the same roundings."""
    p, hs, ws = grid.point, grid.hs, grid.ws
    n = luma.shape[0] // (grid.n_br * grid.n_bc)
    y = (
        luma.reshape(n, grid.n_br, grid.n_bc, p, p)
        .permute(0, 1, 3, 2, 4)
        .reshape(n, grid.n_br * p, grid.n_bc * p)
    )
    c = (
        chroma.reshape(n, 2, grid.cbr, grid.cbc, p, p)
        .permute(0, 1, 2, 4, 3, 5)
        .reshape(n, 2, grid.cbr * p, grid.cbc * p)
    )
    if grid.subsample:  # 2x2 nearest upsample back to the (scaled) luma grid
        c = c.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    y1 = y[:, :hs, :ws] + 128.0
    cb1 = (c[:, 0, :hs, :ws] + 128.0) - 128.0
    cr1 = (c[:, 1, :hs, :ws] + 128.0) - 128.0
    return torch.stack(
        [(mat[r, 0] * y1 + mat[r, 1] * cb1) + mat[r, 2] * cr1 for r in range(3)], dim=1
    )


def blocks_to_rgb(luma: torch.Tensor, chroma: torch.Tensor, mat: torch.Tensor, grid) -> torch.Tensor:
    """(N, 3, hs, ws) f32 on the decoded uint8 pixel grid: round half to
    even, clamp to [0, 255]."""
    return torch.clamp(torch.round(rgb_unrounded(luma, chroma, mat, grid)), 0.0, 255.0)
