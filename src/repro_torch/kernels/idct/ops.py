"""Fused dequantize + (scaled) IDCT: the wrapper around ``csrc/idct.cu``.

``point`` selects the IDCT size (paper §6.4, libjpeg's scaled DCT):
``point=8`` is the full 8x8 IDCT; ``point=4``/``2``/``1`` use the
truncated DCT basis ``A = sqrt(k/8) * Ck^T`` on the low-frequency corner
and reconstruct each block straight to ``point x point`` pixels.  Either
way one block row is one product with the fused matrix
``(kron(A, A) . diag(q))^T`` of shape (64, point^2) — dequantization is
folded into the transform for free.

:func:`idct_rows` is the launch point (the device compiler calls it with
matrices built once per program); :func:`dequant_idct` keeps the
reference package's public API.
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


def idct_rows(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, 64) f32 rows -> (N, P) f32 through the fused matrix ``m`` (64, P).

    On a CUDA tensor this launches ``csrc/idct.cu`` on the current stream
    (and raises if it cannot); on a CPU tensor it runs the plain version.
    """
    if x.dim() != 2 or x.shape[1] != 64:
        raise ValueError(f"coefficient rows must be (N, 64), got {tuple(x.shape)}")
    if m.dim() != 2 or m.shape[0] != 64 or m.shape[1] not in (1, 4, 16, 64):
        raise ValueError(f"matrix must be (64, point^2), got {tuple(m.shape)}")
    if x.dtype != torch.float32 or m.dtype != torch.float32:
        raise TypeError(f"idct_rows takes float32, got {x.dtype} / {m.dtype}")
    if x.device != m.device:
        raise ValueError(f"rows on {x.device} but matrix on {m.device}")
    if x.device.type == "cpu":
        return plain.idct_rows(x, m)
    if x.device.type != "cuda":
        raise ValueError(f"idct_rows runs on cuda or cpu tensors, got {x.device}")
    if not (x.is_contiguous() and m.is_contiguous()):
        raise ValueError("idct_rows needs contiguous rows and matrix")
    n, p2 = x.shape[0], m.shape[1]
    if n >= 2**31 // 64:
        raise ValueError(f"too many rows for one launch: {n}")
    out = torch.empty((n, p2), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.repro_idct_rows_f32(x.data_ptr(), m.data_ptr(), out.data_ptr(), n, p2, stream)
    _build.check(lib, status, "idct_rows")
    idct_rows.launches += 1
    idct_rows.launches_by_point[math.isqrt(p2)] += 1
    return out


idct_rows.launches = 0  # kernel launches (CPU calls do not count)
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
