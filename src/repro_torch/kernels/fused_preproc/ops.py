"""Fused resize + normalize: the wrapper around ``csrc/fused_preproc.cu``.

Bilinear resampling (half-pixel centres) reads through per-axis tap
tables ``(i0, i1, w1)`` built with the shared numpy ``bilinear_coords``;
a crop before the resize is an index offset and a crop after it is a
slice of the tables, so both cost nothing.  :func:`resize_affine_planar`
is the launch point (the device compiler builds its tables once per
program); :func:`fused_resize_affine` and :func:`fused_resize_normalize`
keep the reference package's matrix-based public API.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.fused_preproc import plain
from repro_torch.preprocessing.ops import bilinear_coords


BAND_ROWS = 16  # output rows per block
TILE_COLS = 1024  # output columns per pass over a band (a multiple of 4)
STAGE_BYTES = 33 * 1024  # a band's input rows in shared memory: 6 blocks an SM


def band_plan(y0: np.ndarray, y1: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> list[dict]:
    """What ``csrc/fused_preproc.cu`` stages, worked out as the kernel does
    it from the tap tables: for each band of :data:`BAND_ROWS` output rows
    and tile of :data:`TILE_COLS` output columns, the sub-bands ``[r0, r1)``
    whose input rows ``[lo, hi]`` and columns ``[cmin, cmax]`` fit the
    stage together (a row padded to a multiple of 4 floats past its offset
    within 16 bytes).  ``staged`` is False where not even one output row's
    two input rows fit: that row reads device memory directly."""
    oh, ow = len(y0), len(x0)
    rows_lo, rows_hi = np.minimum(y0, y1), np.maximum(y0, y1)
    plan = []
    for t0 in range(0, ow, TILE_COLS):
        cols = slice(t0, min(ow, t0 + TILE_COLS))
        cmin, cmax = int(min(x0[cols].min(), x1[cols].min())), int(max(x0[cols].max(), x1[cols].max()))
        pitch = (cmax - cmin + 1 + 3 + 3) // 4 * 4
        cap = STAGE_BYTES // 4 // pitch
        for band in range(0, oh, BAND_ROWS):
            r0, stop = band, min(oh, band + BAND_ROWS)
            while r0 < stop:
                lo, hi, r1 = int(rows_lo[r0]), int(rows_hi[r0]), r0 + 1
                while r1 < stop and max(hi, rows_hi[r1]) - min(lo, rows_lo[r1]) + 1 <= cap:
                    lo, hi, r1 = min(lo, int(rows_lo[r1])), max(hi, int(rows_hi[r1])), r1 + 1
                plan.append(dict(t0=t0, r0=r0, r1=r1, lo=lo, hi=hi, cmin=cmin, cmax=cmax,
                                 pitch=pitch, staged=hi - lo + 1 <= cap))
                r0 = r1
    return plan


@functools.lru_cache(maxsize=64)
def bilinear_matrix(in_dim: int, out_dim: int) -> np.ndarray:
    """(out_dim, in_dim) bilinear interpolation matrix, half-pixel centers
    (two nonzeros per row) — the reference kernel's operand."""
    i0, i1, w1 = bilinear_coords(in_dim, out_dim, np)
    mat = np.zeros((out_dim, in_dim), dtype=np.float32)
    rows = np.arange(out_dim)
    mat[rows, i0] += np.float32(1.0) - w1
    mat[rows, i1] += w1
    return mat


def bilinear_taps(
    in_dim: int, out_dim: int, start: int = 0, count: int | None = None, offset: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(i0, i1, w1)`` for output samples ``[start, start + count)`` of an
    ``in_dim -> out_dim`` resample, source indices shifted by ``offset``
    (a crop before the resample)."""
    count = out_dim - start if count is None else count
    # numpy promotes bilinear_coords' float32 - int32 weight to float64;
    # the difference is exact, so float32 gives the device path's weights
    i0, i1, w1 = bilinear_coords(in_dim, out_dim, np)
    sl = slice(start, start + count)
    return (
        np.ascontiguousarray(i0[sl] + np.int32(offset)),
        np.ascontiguousarray(i1[sl] + np.int32(offset)),
        np.ascontiguousarray(w1[sl], dtype=np.float32),
    )


def taps_from_matrix(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recover ``(i0, i1, w1)`` from a (possibly crop-sliced) interpolation
    matrix: the first and last nonzero of each row and the last one's
    weight (0 where the row has a single tap)."""
    mat = np.asarray(mat, np.float32)
    nz = mat != 0
    if not nz.any(axis=1).all():
        raise ValueError("interpolation matrix has an all-zero row")
    i0 = nz.argmax(axis=1).astype(np.int32)
    i1 = (mat.shape[1] - 1 - nz[:, ::-1].argmax(axis=1)).astype(np.int32)
    rows = np.arange(mat.shape[0])
    w1 = np.where(i1 != i0, mat[rows, i1], np.float32(0.0)).astype(np.float32)
    return i0, i1, w1


def resize_affine_planar(
    x: torch.Tensor,  # (B, H, W) f32 planes
    y0: torch.Tensor,
    y1: torch.Tensor,
    wy: torch.Tensor,
    x0: torch.Tensor,
    x1: torch.Tensor,
    wx: torch.Tensor,
    scale: torch.Tensor,  # (B,)
    bias: torch.Tensor,  # (B,)
    round_uint8: bool = False,
) -> torch.Tensor:
    """(B, H, W) -> (B, OH, OW): resample through the tap tables, optionally
    re-quantize to the uint8 grid, then ``* scale[b] + bias[b]``.

    On a CUDA tensor this launches ``csrc/fused_preproc.cu`` on the current
    stream (and raises if it cannot); on a CPU tensor it runs the plain
    version."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, H, W) float32, got {tuple(x.shape)} {x.dtype}")
    planes, h, w = x.shape
    oh, ow = y0.shape[0], x0.shape[0]
    for name, t, n, dt in (
        ("y0", y0, oh, torch.int32), ("y1", y1, oh, torch.int32), ("wy", wy, oh, torch.float32),
        ("x0", x0, ow, torch.int32), ("x1", x1, ow, torch.int32), ("wx", wx, ow, torch.float32),
        ("scale", scale, planes, torch.float32), ("bias", bias, planes, torch.float32),
    ):
        if t.shape != (n,) or t.dtype != dt:
            raise ValueError(f"{name} must be ({n},) {dt}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device} but x on {x.device}")
    if x.device.type == "cpu":
        return plain.resize_affine_planar(x, y0, y1, wy, x0, x1, wx, scale, bias, round_uint8)
    if x.device.type != "cuda":
        raise ValueError(f"resize_affine_planar runs on cuda or cpu tensors, got {x.device}")
    if not all(t.is_contiguous() for t in (x, y0, y1, wy, x0, x1, wx, scale, bias)):
        raise ValueError("resize_affine_planar needs contiguous operands")
    if planes > 65535:
        raise ValueError(f"at most 65535 planes per launch, got {planes}")
    out = torch.empty((planes, oh, ow), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.repro_resize_affine_planar_f32(
        x.data_ptr(), planes, h, w,
        y0.data_ptr(), y1.data_ptr(), wy.data_ptr(), oh,
        x0.data_ptr(), x1.data_ptr(), wx.data_ptr(), ow,
        scale.data_ptr(), bias.data_ptr(), int(round_uint8),
        out.data_ptr(), BAND_ROWS, min(ow, TILE_COLS), STAGE_BYTES // 4, stream,
    )
    _build.check(lib, status, "resize_affine_planar")
    _build.count_launch(resize_affine_planar)
    return out


resize_affine_planar.launches = 0  # kernel launches (CPU calls do not count)


def _taps_tensors(taps, device) -> list[torch.Tensor]:
    return [torch.from_numpy(t).to(device) for t in taps]


def fused_resize_affine(
    x: torch.Tensor,  # (B, H, W) float32 planes (B = batch*channels)
    ry: np.ndarray,  # (OH, H) row interpolation matrix (may be crop-sliced)
    rxt: np.ndarray,  # (W, OW) col interpolation matrix, transposed
    scale: torch.Tensor | np.ndarray,  # (B,) per-plane folded multiplier
    bias: torch.Tensor | np.ndarray,  # (B,) per-plane folded offset
    round_uint8: bool = False,
) -> torch.Tensor:
    """The reference wrapper's API: resize every plane through
    (possibly crop-sliced) interpolation matrices and apply a per-plane
    affine — here as a gather over the matrices' two taps per row."""
    dev = x.device
    ys = _taps_tensors(taps_from_matrix(ry), dev)
    xs = _taps_tensors(taps_from_matrix(np.asarray(rxt).T), dev)
    s = torch.as_tensor(np.asarray(scale, np.float32) if not torch.is_tensor(scale) else scale)
    b = torch.as_tensor(np.asarray(bias, np.float32) if not torch.is_tensor(bias) else bias)
    return resize_affine_planar(
        x, *ys, *xs, s.to(dev, torch.float32), b.to(dev, torch.float32), round_uint8
    )


def fused_resize_normalize(
    x: np.ndarray | torch.Tensor,  # (C, H, W) float input planes
    out_h: int,
    out_w: int,
    scale: np.ndarray,  # (C,) folded multiplier (e.g. 1/255/std)
    bias: np.ndarray,  # (C,) folded offset (e.g. -mean/std)
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Resize (C,H,W) -> (C,out_h,out_w) bilinearly and apply a per-channel
    affine in one pass, on ``device``.  ``device=None`` keeps a tensor
    input where it is and sends a numpy input to the card."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
        device = "cuda" if device is None else device
    if device is not None:
        x = x.to(resolve_device(device))
    x = x.to(torch.float32).contiguous()
    _, h, w = x.shape
    dev = x.device
    return resize_affine_planar(
        x,
        *_taps_tensors(bilinear_taps(h, out_h), dev),
        *_taps_tensors(bilinear_taps(w, out_w), dev),
        torch.from_numpy(np.asarray(scale, np.float32)).to(dev),
        torch.from_numpy(np.asarray(bias, np.float32)).to(dev),
    )
