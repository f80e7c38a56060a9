"""Fused dequantize + (scaled) IDCT: the wrapper around ``csrc/idct.cu``.

``point`` selects the IDCT size (paper §6.4, libjpeg's scaled DCT):
``point=8`` is the full 8x8 IDCT; ``point=4``/``2``/``1`` use the
truncated DCT basis ``A = sqrt(k/8) * Ck^T`` on the low-frequency corner
and reconstruct each block straight to ``point x point`` pixels.  Either
way one block row is one product with the fused matrix
``(kron(A, A) . diag(q))^T`` of shape (64, point^2) — dequantization is
folded into the transform for free.

Two launch points run the one kernel template:
:func:`idct_zigzag_rows` reads the split-decode program's staged int16
zigzag rows in place (a strided view of the batch) against
:func:`zigzag_matrix`, the fused matrix with its rows in zigzag order;
:func:`idct_rows` takes f32 rows in natural order and keeps, through
:func:`dequant_idct`, the reference package's public API.  The device
compiler calls them with matrices built once per program.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.idct import plain
from repro_torch.preprocessing import dct as dct_np

SCALED_POINTS = (8, 4, 2, 1)  # supported IDCT sizes (8 = full resolution)
# The leading coefficients of a row that the kernel reads, by (input order,
# point): every row of the fused matrix past them is zero, since the scaled
# IDCT uses only the point x point low-frequency corner (zigzag positions
# <= 24 at point 4, <= 4 at point 2; natural indices <= 27 and <= 9).
# A multiple of 8, one tensor-core k-step.
# Zigzag rows come only from the split-decode program (points 8/4/2).
K_ROWS = {
    ("zigzag", 8): 64, ("zigzag", 4): 32, ("zigzag", 2): 8,
    ("natural", 8): 64, ("natural", 4): 32, ("natural", 2): 16, ("natural", 1): 8,
}


def scaled_basis(point: int) -> np.ndarray:
    """(point, 8) truncated-DCT-basis row transform ``sqrt(k/8) * Ck^T P_k``,
    shared bit-for-bit with the host reference decode."""
    return dct_np.scaled_idct_basis(point)


@functools.lru_cache(maxsize=64)
def _m2q(qtable_bytes: bytes, point: int) -> np.ndarray:
    q = np.frombuffer(qtable_bytes, dtype=np.int32).reshape(8, 8)
    a = scaled_basis(point)
    m2 = np.kron(a, a)  # row-major vec: vec(A X A^T) = (A ⊗ A) vec(X)
    m2q = m2 * q.reshape(-1)[None, :]  # fold dequantization into the transform
    return np.ascontiguousarray(m2q.T).astype(np.float32)


def idct_matrix(qtable: np.ndarray, point: int = 8) -> np.ndarray:
    """(64, point^2) f32 fused dequant+IDCT matrix for one quant table.

    The reference kernel's matrix (``repro.kernels.idct.ops._m2q_t``)
    without its zero padding to 64 output columns."""
    if point not in SCALED_POINTS:
        raise ValueError(f"point must be one of {SCALED_POINTS}, got {point}")
    return _m2q(np.ascontiguousarray(qtable, dtype=np.int32).tobytes(), point)


def zigzag_matrix(qtable: np.ndarray, point: int = 8) -> np.ndarray:
    """:func:`idct_matrix` with its rows in zigzag order: a staged zigzag
    row times it is the natural-order row times the natural matrix."""
    return np.ascontiguousarray(idct_matrix(qtable, point)[dct_np.ZIGZAG])


def _check_matrix(m: torch.Tensor, x: torch.Tensor, order: str) -> None:
    points = [point for o, point in K_ROWS if o == order]
    if m.dim() != 2 or m.shape[0] != 64 or math.isqrt(m.shape[1]) ** 2 != m.shape[1] \
            or math.isqrt(m.shape[1]) not in points:
        raise ValueError(f"matrix must be (64, point^2) for a point in {points} "
                         f"({order} rows), got {tuple(m.shape)}")
    if m.dtype != torch.float32:
        raise TypeError(f"the matrix must be float32, got {m.dtype}")
    if x.device != m.device:
        raise ValueError(f"rows on {x.device} but matrix on {m.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 runs on cuda or cpu tensors, got {x.device}")


def row_view(x: torch.Tensor) -> tuple[list[int], list[int]]:
    """The row sizes and strides (in elements, four of each, outermost
    first, padded with size 1) that K1 reads ``x``'s rows through: its
    dims but the last, which must hold each row's values contiguously.
    Raises unless the base and every row stride are 16-byte aligned, as
    the kernel's 16-byte ``cp.async`` copies need, and unless its offsets
    and output indices fit the kernel's 32-bit arithmetic."""
    if x.stride(-1) != 1:
        raise ValueError(f"K1 needs each row's values contiguous, got strides {tuple(x.stride())}")
    sizes, strides = list(x.shape[:-1]), list(x.stride()[:-1])
    if len(sizes) > 4:
        raise ValueError(f"K1 takes at most four row dimensions, got {tuple(x.shape)}")
    if x.data_ptr() % 16 or any(s * x.element_size() % 16 for s in strides):
        raise ValueError(f"K1 needs a 16-byte aligned base and row strides, got base "
                         f"{x.data_ptr()} and strides {tuple(x.stride())} ({x.dtype})")
    if sum((n - 1) * s for n, s in zip(sizes, strides)) + 64 >= 2**31 or math.prod(sizes) >= 2**25:
        raise ValueError(f"too large for one launch: rows {tuple(x.shape[:-1])}, strides "
                         f"{tuple(strides)} (offsets, rows x 64 below 2^31)")
    return [1] * (4 - len(sizes)) + sizes, [0] * (4 - len(strides)) + strides


def _launch(x: torch.Tensor, m: torch.Tensor, order: str) -> torch.Tensor:
    """K1 on the card over ``x``'s rows, read in place through their view."""
    sizes, strides = row_view(x)
    if not m.is_contiguous():
        raise ValueError("K1 needs a contiguous matrix")
    n = math.prod(sizes)
    p2 = m.shape[1]
    point = math.isqrt(p2)
    out = torch.empty((n, p2), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.repro_idct_rows(
        x.data_ptr(), int(x.dtype == torch.int16), *sizes, *strides, K_ROWS[order, point],
        m.data_ptr(), out.data_ptr(), p2, stream)
    _build.check(lib, status, "idct_rows")
    _build.count_launch(idct_rows)
    idct_rows.launches_by_point[point] += 1
    return out


def idct_rows(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, 64) f32 rows in natural order -> (N, P) f32 through the fused
    matrix ``m`` (64, P), zero past row ``K_ROWS["natural", point]``.

    On a CUDA tensor this launches ``csrc/idct.cu`` on the current stream
    (and raises if it cannot); on a CPU tensor it runs the plain version.
    """
    if x.dim() != 2 or x.shape[1] != 64:
        raise ValueError(f"coefficient rows must be (N, 64), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"idct_rows takes float32 rows, got {x.dtype}")
    _check_matrix(m, x, "natural")
    if x.device.type == "cpu":
        return plain.idct_rows(x, m)
    if not x.is_contiguous():
        raise ValueError("idct_rows needs contiguous rows")
    return _launch(x, m, "natural")


def idct_zigzag_rows(x: torch.Tensor, m_zz: torch.Tensor) -> torch.Tensor:
    """Staged int16 zigzag rows, read in place -> (rows, P) f32 through
    ``m_zz`` (64, P), :func:`zigzag_matrix`'s rows for one quant table.

    ``x`` is (..., 64) with up to four row dimensions, any strides that
    keep a row's 64 values contiguous: a view of the split-decode program's
    staged batch (``zz[:, 0]``, ``zz[:, 1:, :cbr, :cbc]``,
    ``zz[:, :n_luma]``, ...).  The output's rows are the view's rows in
    order.  On a CUDA tensor this launches ``csrc/idct.cu`` on the current
    stream (and raises if it cannot); on a CPU tensor it runs the plain
    version."""
    if x.dim() < 2 or x.shape[-1] != 64:
        raise ValueError(f"zigzag rows must be (..., 64), got {tuple(x.shape)}")
    if x.dtype != torch.int16:
        raise TypeError(f"idct_zigzag_rows takes int16 rows, got {x.dtype}")
    _check_matrix(m_zz, x, "zigzag")
    if x.device.type == "cpu":
        return plain.idct_zigzag_rows(x, m_zz)
    return _launch(x, m_zz, "zigzag")


# K1's launches through either entry (CPU calls do not count)
idct_rows.launches = 0
idct_rows.launches_by_point = dict.fromkeys(SCALED_POINTS, 0)  # the same, by IDCT size


def dequant_idct(
    coeffs: np.ndarray | torch.Tensor,  # (N, 8, 8) quantized coefficients
    qtable: np.ndarray,  # (8, 8) int quantization table
    point: int = 8,  # IDCT size: 8 full, 4 half-res, 2 quarter-res, 1 DC
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Dequantize + 2-D (scaled) IDCT a stack of 8x8 coefficient blocks.

    Returns (N, point, point) f32 level-shifted pixels (the caller adds
    128) on ``device``.  ``device=None`` keeps a tensor input where it is
    and sends a numpy input to the card."""
    x = coeffs
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(coeffs))
        device = "cuda" if device is None else device
    if device is not None:
        x = x.to(resolve_device(device))
    n = x.shape[0]
    flat = x.reshape(n, 64).to(torch.float32).contiguous()
    m = torch.from_numpy(idct_matrix(qtable, point)).to(flat.device)
    return idct_rows(flat, m).reshape(n, point, point)
