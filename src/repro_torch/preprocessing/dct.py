"""Shared 8x8 DCT machinery for the JPEG-family codec.

The 2-D DCT-II of an 8x8 block X is  C @ X @ C.T  with C the orthonormal
DCT-II matrix; the inverse is C.T @ Y @ C.  Expressing the transform as two
8x8 matmuls is exactly what makes it MXU-friendly on TPU (see
kernels/idct/), and it is also the fastest vectorized form in numpy.
"""

from __future__ import annotations

import numpy as np

BLOCK = 8

# Standard JPEG (Annex K) luminance / chrominance quantization tables.
QTABLE_LUMA = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.int32,
)
QTABLE_CHROMA = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.int32,
)


def dct_matrix(n: int = BLOCK) -> np.ndarray:
    """Orthonormal DCT-II matrix (float64 for encode fidelity)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    mat = np.cos((2 * i + 1) * k * np.pi / (2 * n))
    mat *= np.sqrt(2.0 / n)
    mat[0] *= np.sqrt(0.5)
    return mat


DCT_MAT = dct_matrix()


def scaled_idct_basis(point: int) -> np.ndarray:
    """(point, 8) truncated-DCT-basis row transform for the scaled IDCT.

    ``A = sqrt(point/8) * C_point^T P_point`` applied two-sided
    (``A X A^T``) maps an 8x8 coefficient block straight to a
    ``point x point`` pixel block at 1/(8/point) resolution — libjpeg's
    scaled DCT (paper §6.4).  ``point=8`` recovers the full IDCT exactly
    and ``point=1`` the DC/8 progressive first-scan image, so the whole
    multi-resolution family is this one definition.  Shared by the host
    reference decode (jpeg.decode_scaled) and the MXU kernel
    (kernels/idct) so both sides use bit-identical basis weights.
    """
    if point not in (8, 4, 2, 1):
        raise ValueError(f"point must be 8, 4, 2 or 1, got {point}")
    a = np.zeros((point, 8), dtype=np.float64)
    a[:, :point] = np.sqrt(point / 8.0) * dct_matrix(point).T
    return a


def zigzag_order(n: int = BLOCK) -> np.ndarray:
    """Indices that map a flattened 8x8 block into zigzag scan order."""
    idx = np.empty((n, n), dtype=np.int64)
    order = sorted(
        ((r, c) for r in range(n) for c in range(n)),
        key=lambda rc: (rc[0] + rc[1], rc[1] if (rc[0] + rc[1]) % 2 else rc[0]),
    )
    for pos, (r, c) in enumerate(order):
        idx[r, c] = pos
    flat_to_zz = np.argsort(idx.reshape(-1))
    return flat_to_zz  # array of 64 flat indices in zigzag order


ZIGZAG = zigzag_order()
UNZIGZAG = np.argsort(ZIGZAG)


def quality_scale(qtable: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg-style quality scaling of a base quantization table."""
    quality = int(np.clip(quality, 1, 100))
    if quality < 50:
        scale = 5000 // quality
    else:
        scale = 200 - 2 * quality
    q = (qtable * scale + 50) // 100
    return np.clip(q, 1, 255).astype(np.int32)


def blockify(plane: np.ndarray, block: int = BLOCK) -> tuple[np.ndarray, int, int]:
    """Pad a 2-D plane to a multiple of ``block`` and return (n_br, n_bc, 8, 8)."""
    h, w = plane.shape
    ph = (block - h % block) % block
    pw = (block - w % block) % block
    if ph or pw:
        plane = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    hh, ww = plane.shape
    n_br, n_bc = hh // block, ww // block
    blocks = plane.reshape(n_br, block, n_bc, block).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(blocks), n_br, n_bc


def unblockify(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    """Inverse of :func:`blockify`; crops padding back off."""
    n_br, n_bc, b, _ = blocks.shape
    plane = blocks.transpose(0, 2, 1, 3).reshape(n_br * b, n_bc * b)
    return plane[:h, :w]


def fdct_blocks(blocks: np.ndarray) -> np.ndarray:
    """Forward 2-D DCT over a (..., 8, 8) stack of blocks."""
    return DCT_MAT @ blocks @ DCT_MAT.T


def idct_blocks(coeffs: np.ndarray) -> np.ndarray:
    """Inverse 2-D DCT over a (..., 8, 8) stack of coefficient blocks."""
    return DCT_MAT.T @ coeffs @ DCT_MAT


def rgb_to_ycbcr(img: np.ndarray) -> np.ndarray:
    """JFIF RGB -> YCbCr, float64 in, float64 out (full range, offset 128)."""
    img = img.astype(np.float64)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return np.stack([y, cb, cr], axis=-1)


def ycbcr_to_rgb(img: np.ndarray) -> np.ndarray:
    y, cb, cr = img[..., 0], img[..., 1] - 128.0, img[..., 2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.stack([r, g, b], axis=-1)
