"""Decoded blocks to RGB pixels: the wrapper around ``csrc/blocks_to_rgb.cu``.

K1 (``kernels/idct``) leaves a split-decode batch as dense rows, one
decoded ``point x point`` block each; :func:`blocks_to_rgb` turns them into
the planar RGB batch the fused preprocessing stage takes, in one pass:
unblockify, crop, 2x2 nearest chroma upsample (4:2:0), level shift, JFIF
YCbCr -> RGB, round, clamp.  It stands for the XLA fusion around the
reference's IDCT call, not for a TPU kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocks_to_rgb import plain

POINTS = (8, 4, 2)  # the split-decode program's IDCT sizes (factor 1, 2, 4)


class BlockGrid(NamedTuple):
    """Where a split-decode item's decoded blocks land: the luma and chroma
    block grids, the block side, the (scaled) image size, 4:2:0 or not."""

    n_br: int
    n_bc: int
    cbr: int
    cbc: int
    point: int
    hs: int
    ws: int
    subsample: bool


def _check_grid(grid: BlockGrid) -> None:
    if grid.point not in POINTS:
        raise ValueError(f"point must be one of {POINTS}, got {grid.point}")
    p, up = grid.point, 2 if grid.subsample else 1
    if not (0 < grid.hs <= grid.n_br * p and 0 < grid.ws <= grid.n_bc * p):
        raise ValueError(f"{grid.hs}x{grid.ws} pixels outside the luma blocks of {grid}")
    if grid.hs > up * grid.cbr * p or grid.ws > up * grid.cbc * p:
        raise ValueError(f"{grid.hs}x{grid.ws} pixels outside the chroma blocks of {grid}")


def blocks_to_rgb(
    luma: torch.Tensor,  # (N * n_br * n_bc, point^2) f32 decoded luma blocks
    chroma: torch.Tensor,  # (N * 2 * cbr * cbc, point^2) f32: each image's Cb, then Cr
    mat: torch.Tensor,  # (3, 3) f32 YCbCr -> RGB, rows R, G, B
    grid: BlockGrid,
) -> torch.Tensor:
    """-> (N, 3, hs, ws) f32 RGB on the decoded uint8 grid.

    On a CUDA tensor this launches ``csrc/blocks_to_rgb.cu`` on the current
    stream (and raises if it cannot); on a CPU tensor it runs the plain
    version, which the kernel equals value for value."""
    _check_grid(grid)
    p2, n_luma, n_chroma = grid.point**2, grid.n_br * grid.n_bc, 2 * grid.cbr * grid.cbc
    for name, t in (("luma", luma), ("chroma", chroma), ("mat", mat)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != luma.device:
            raise ValueError(f"{name} on {t.device} but luma on {luma.device}")
    if luma.dim() != 2 or luma.shape[1] != p2 or luma.shape[0] % n_luma:
        raise ValueError(f"luma must be (N * {n_luma}, {p2}), got {tuple(luma.shape)}")
    n = luma.shape[0] // n_luma
    if tuple(chroma.shape) != (n * n_chroma, p2):
        raise ValueError(f"chroma must be ({n * n_chroma}, {p2}), got {tuple(chroma.shape)}")
    if tuple(mat.shape) != (3, 3):
        raise ValueError(f"mat must be (3, 3), got {tuple(mat.shape)}")
    if luma.device.type == "cpu":
        return plain.blocks_to_rgb(luma, chroma, mat, grid)
    if luma.device.type != "cuda":
        raise ValueError(f"blocks_to_rgb runs on cuda or cpu tensors, got {luma.device}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (luma, chroma, mat)):
        raise ValueError("blocks_to_rgb needs contiguous, 16-byte aligned operands")
    if n > 65535 or grid.hs > 65535:
        raise ValueError(f"at most 65535 images and rows per launch, got {n} x {grid.hs}")
    out = torch.empty((n, 3, grid.hs, grid.ws), dtype=torch.float32, device=luma.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(luma.device).cuda_stream
    status = lib.repro_blocks_to_rgb(
        luma.data_ptr(), chroma.data_ptr(), mat.data_ptr(), out.data_ptr(), n,
        grid.n_br, grid.n_bc, grid.cbr, grid.cbc, grid.point, grid.hs, grid.ws,
        int(grid.subsample), stream)
    _build.check(lib, status, "blocks_to_rgb")
    _build.count_launch(blocks_to_rgb)
    return out


blocks_to_rgb.launches = 0  # kernel launches (CPU calls do not count)
