"""A real (simplified) JPEG-family codec with partial decoding.

This is a faithful reimplementation of the JPEG *pipeline* — RGB->YCbCr,
optional 4:2:0 chroma subsampling, 8x8 blockwise DCT, quality-scaled
quantization (Annex-K tables), zigzag scan, sparse coefficient coding,
entropy coding — with one deliberate substitution: the bit-level Huffman
entropy stage is replaced by a byte-aligned sparse layout compressed with
zstd (whose FSE/Huffman stages are real entropy coders).  This keeps the
codec bit-exact-invertible against our encoder while staying vectorizable
in numpy.

Partial-decoding features (paper §6.4, Table 4):

* **ROI decoding** — the stream is segmented into independently decodable
  *bands* of macroblock rows (the analogue of JPEG restart intervals), with
  a byte-offset index in the header.  Decoding an ROI touches only the
  bands that intersect it and runs the inverse transform only on
  intersecting blocks (paper Algorithm 1).
* **Early stopping** — raster-order decode of the top N pixel rows only.
* **Progressive / multi-resolution** — ``dc_only=True`` reconstructs the
  1/8-scale image from DC coefficients alone (the analogue of decoding the
  first spectral-selection scan of a progressive JPEG).
* **Split decode** — :func:`decode_to_coefficients` performs only the
  host-side entropy stage and returns quantized coefficient blocks +
  quantization tables, so the dense dequantize+IDCT stage can be placed on
  the accelerator (kernels/idct) per the placement optimizer (§6.3).
"""

from __future__ import annotations

import dataclasses
import functools
import struct

import numpy as np

from repro_torch.preprocessing import compression, dct, scratch as scratch_mod

MAGIC = b"SJPG"
VERSION = 2  # v2: band payloads framed by preprocessing.compression method tags
_HDR = struct.Struct("<4sBIIBBBBHH")  # magic, ver, h, w, ch, quality, subsample, band_rows, n_br, n_bc



@dataclasses.dataclass(frozen=True)
class JpegHeader:
    height: int
    width: int
    channels: int
    quality: int
    subsample: bool  # True = 4:2:0
    band_rows: int  # luma block-rows per band (restart-interval analogue)
    n_br: int  # luma block rows
    n_bc: int  # luma block cols
    band_offsets: tuple[int, ...]  # byte offset of each band payload
    payload_start: int

    @property
    def n_bands(self) -> int:
        return len(self.band_offsets)


@functools.lru_cache(maxsize=1024)
def _chroma_grid(n_br: int, n_bc: int, subsample: bool) -> tuple[int, int]:
    if subsample:
        return (n_br + 1) // 2, (n_bc + 1) // 2
    return n_br, n_bc


def chroma_grid(hdr) -> tuple[int, int]:
    """Chroma (block_rows, block_cols) — equals the luma grid for 4:4:4.

    Accepts anything with ``n_br``/``n_bc``/``subsample`` attributes (a
    :class:`JpegHeader` or the cost model's ``CoeffGeometry``); this is
    THE 4:2:0 grid formula — staging, decode and costing all call it.
    Memoized on the scalar grid key: the host staging hot path re-derives
    the same grid for every item of a shape-uniform corpus."""
    return _chroma_grid(hdr.n_br, hdr.n_bc, bool(hdr.subsample))


def _plane_grids(hdr: JpegHeader) -> list[tuple[int, int]]:
    """(block_rows, block_cols) per plane, honouring 4:2:0 subsampling."""
    grids = [(hdr.n_br, hdr.n_bc)]
    if hdr.channels == 3:
        grids += [chroma_grid(hdr)] * 2
    return grids


def _band_plane_rows(hdr: JpegHeader, band: int) -> list[tuple[int, int]]:
    """Half-open luma/chroma block-row ranges covered by ``band``."""
    r0 = band * hdr.band_rows
    r1 = min(r0 + hdr.band_rows, hdr.n_br)
    out = [(r0, r1)]
    if hdr.channels == 3:
        grids = _plane_grids(hdr)
        cbr = grids[1][0]
        if hdr.subsample:
            c0 = r0 // 2
            c1 = min((r1 + 1) // 2, cbr)
        else:
            c0, c1 = r0, r1
        out += [(c0, c1), (c0, c1)]
    return out


def _qtables(quality: int, channels: int) -> list[np.ndarray]:
    qs = [dct.quality_scale(dct.QTABLE_LUMA, quality)]
    if channels == 3:
        qc = dct.quality_scale(dct.QTABLE_CHROMA, quality)
        qs += [qc, qc]
    return qs


def _quantize_plane(plane: np.ndarray, qtable: np.ndarray) -> tuple[np.ndarray, int, int]:
    """Plane (float, level-shifted) -> zigzagged int16 (n_blocks, 64)."""
    blocks, n_br, n_bc = dct.blockify(plane)
    coeffs = dct.fdct_blocks(blocks)
    quant = np.round(coeffs / qtable).astype(np.int32)
    quant = np.clip(quant, -32768, 32767).astype(np.int16)
    zz = quant.reshape(-1, 64)[:, dct.ZIGZAG]
    return zz, n_br, n_bc


def _encode_rows_sparse(zz_rows: np.ndarray) -> bytes:
    """Sparse-code a set of zigzagged blocks (n_blocks, 64) -> bytes."""
    n_blocks = zz_rows.shape[0]
    dc = zz_rows[:, 0].astype("<i2")
    ac = zz_rows[:, 1:]
    blk_idx, pos = np.nonzero(ac)
    counts = np.bincount(blk_idx, minlength=n_blocks).astype(np.uint8)
    # counts can exceed 255 only if >255 nonzero ACs per 63-slot block: impossible.
    vals = ac[blk_idx, pos].astype("<i2")
    parts = [
        struct.pack("<I", n_blocks),
        dc.tobytes(),
        counts.tobytes(),
        (pos + 1).astype(np.uint8).tobytes(),
        vals.tobytes(),
    ]
    return b"".join(parts)


def _decode_rows_sparse(
    buf, off: int, scratch: "scratch_mod.BandScratch | None" = None
) -> tuple[np.ndarray, int]:
    """Inverse of :func:`_encode_rows_sparse`; returns (n_blocks, 64) int16.

    With ``scratch`` the coefficient buffer is an arena slice (released by
    the caller's band_scratch scope) instead of a fresh allocation."""
    (n_blocks,) = struct.unpack_from("<I", buf, off)
    off += 4
    dc = np.frombuffer(buf, dtype="<i2", count=n_blocks, offset=off)
    off += 2 * n_blocks
    counts = np.frombuffer(buf, dtype=np.uint8, count=n_blocks, offset=off)
    off += n_blocks
    nnz = int(counts.sum())
    pos = np.frombuffer(buf, dtype=np.uint8, count=nnz, offset=off)
    off += nnz
    vals = np.frombuffer(buf, dtype="<i2", count=nnz, offset=off)
    off += 2 * nnz
    if scratch is not None:
        zz = scratch.alloc((n_blocks, 64), np.int16)
    else:
        zz = np.zeros((n_blocks, 64), dtype=np.int16)
    zz[:, 0] = dc
    blk_idx = np.repeat(np.arange(n_blocks), counts)
    zz[blk_idx, pos.astype(np.int64)] = vals
    return zz, off


def encode(
    img: np.ndarray,
    quality: int = 75,
    subsample: bool = False,
    band_rows: int = 4,
) -> bytes:
    """Encode an (H, W, 3) or (H, W) uint8 image."""
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8 image, got {img.dtype}")
    grayscale = img.ndim == 2
    if grayscale:
        img = img[..., None]
    h, w, channels = img.shape
    if channels not in (1, 3):
        raise ValueError(f"expected 1 or 3 channels, got {channels}")

    if channels == 3:
        ycc = dct.rgb_to_ycbcr(img)
        planes = [ycc[..., 0]]
        if subsample:
            for c in (1, 2):
                p = ycc[..., c]
                ph = (2 - h % 2) % 2
                pw = (2 - w % 2) % 2
                if ph or pw:
                    p = np.pad(p, ((0, ph), (0, pw)), mode="edge")
                planes.append(p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean(axis=(1, 3)))
        else:
            planes += [ycc[..., 1], ycc[..., 2]]
    else:
        planes = [img[..., 0].astype(np.float64)]

    qtables = _qtables(quality, channels)
    zz_planes, grids = [], []
    for plane, qt in zip(planes, qtables):
        zz, n_br, n_bc = _quantize_plane(plane - 128.0, qt)
        zz_planes.append(zz.reshape(n_br, n_bc, 64))
        grids.append((n_br, n_bc))

    n_br, n_bc = grids[0]
    n_bands = (n_br + band_rows - 1) // band_rows
    hdr_stub = JpegHeader(h, w, channels, quality, subsample, band_rows, n_br, n_bc, (), 0)

    bands = []
    for band in range(n_bands):
        ranges = _band_plane_rows(hdr_stub, band)
        raw_parts = []
        for zz_p, (r0, r1) in zip(zz_planes, ranges):
            rows = zz_p[r0:r1].reshape(-1, 64)
            raw_parts.append(_encode_rows_sparse(rows))
        bands.append(compression.compress(b"".join(raw_parts), level=3))

    header = _HDR.pack(MAGIC, VERSION, h, w, channels, quality, int(subsample), band_rows, n_br, n_bc)
    offsets, cur = [], 0
    for b in bands:
        offsets.append(cur)
        cur += len(b)
    offset_blob = struct.pack(f"<I{n_bands}I", n_bands, *offsets)
    return header + offset_blob + b"".join(bands)


def peek_header(data: bytes) -> JpegHeader:
    magic, ver, h, w, ch, q, sub, band_rows, n_br, n_bc = _HDR.unpack_from(data, 0)
    if magic != MAGIC or ver != VERSION:
        raise ValueError("not an SJPG stream")
    off = _HDR.size
    (n_bands,) = struct.unpack_from("<I", data, off)
    off += 4
    band_offsets = struct.unpack_from(f"<{n_bands}I", data, off)
    off += 4 * n_bands
    return JpegHeader(h, w, ch, q, bool(sub), band_rows, n_br, n_bc, tuple(band_offsets), off)


def _decode_band_coeffs(
    data: bytes,
    hdr: JpegHeader,
    band: int,
    scratch: "scratch_mod.BandScratch | None" = None,
) -> list[np.ndarray]:
    """Entropy-decode one band -> per-plane zigzagged (rows, n_bc, 64) int16.

    With ``scratch`` both the decompressed payload and the coefficient
    buffers come from the caller's arena scope (no per-band allocations)."""
    start = hdr.payload_start + hdr.band_offsets[band]
    end = hdr.payload_start + (
        hdr.band_offsets[band + 1] if band + 1 < hdr.n_bands else len(data) - hdr.payload_start
    )
    blob = memoryview(data)[start:end]
    raw = None
    if scratch is not None:
        size = compression.decompressed_size(blob)
        if size is not None:
            buf = scratch.alloc_bytes(size)
            n = compression.decompress_into(blob, buf)
            raw = buf[:n]
    if raw is None:
        raw = memoryview(compression.decompress(bytes(blob)))
    grids = _plane_grids(hdr)
    ranges = _band_plane_rows(hdr, band)
    out, off = [], 0
    for (n_br_p, n_bc_p), (r0, r1) in zip(grids, ranges):
        zz, off = _decode_rows_sparse(raw, off, scratch=scratch)
        out.append(zz.reshape(r1 - r0, n_bc_p, 64))
    return out


def decode_to_coefficients(
    data: bytes,
    roi: tuple[int, int, int, int] | None = None,
    max_rows: int | None = None,
) -> tuple[JpegHeader, list[np.ndarray], list[np.ndarray], list[tuple[int, int]]]:
    """Host-side entropy stage only (the SPLIT-DECODE path).

    Returns ``(header, planes_zz, qtables, row_ranges)`` where ``planes_zz[p]``
    is an int16 array of shape (rows_p, n_bc_p, 64) of *quantized, zigzagged*
    coefficients for the decoded luma block-row range, and ``row_ranges[p]``
    the half-open block-row range each plane covers.  Dequantization and the
    IDCT — the dense, MXU-friendly stage — are left to the caller so they can
    be placed on host or device (kernels/idct/ops.py).
    """
    hdr = peek_header(data)
    lo_row, hi_row = 0, hdr.n_br
    if roi is not None:
        y0, x0, y1, x1 = roi
        snap = 16 if hdr.subsample else 8
        y0 = max(0, (y0 // snap) * snap)
        y1 = min(hdr.height, ((y1 + snap - 1) // snap) * snap)
        lo_row, hi_row = y0 // 8, (y1 + 7) // 8
    if max_rows is not None:
        hi_row = min(hi_row, (max_rows + 7) // 8)
    lo_band = lo_row // hdr.band_rows
    hi_band = (hi_row + hdr.band_rows - 1) // hdr.band_rows
    hi_band = min(hi_band, hdr.n_bands)

    per_plane: list[list[np.ndarray]] = [[] for _ in _plane_grids(hdr)]
    plane_ranges: list[list[int]] = [[1 << 30, 0] for _ in per_plane]
    # per-band payload + coefficient scratch lives in the thread-local
    # FrameArena for the duration of the loop: steady-state decode makes
    # zero per-band system allocations (only the concatenated result below
    # is caller-owned memory)
    with scratch_mod.band_scratch() as scratch:
        for band in range(lo_band, hi_band):
            coeffs = _decode_band_coeffs(data, hdr, band, scratch=scratch)
            ranges = _band_plane_rows(hdr, band)
            for p, (c, (r0, r1)) in enumerate(zip(coeffs, ranges)):
                per_plane[p].append(c)
                plane_ranges[p][0] = min(plane_ranges[p][0], r0)
                plane_ranges[p][1] = max(plane_ranges[p][1], r1)
        planes_zz = [
            np.concatenate(chunks, axis=0) if chunks else np.zeros((0, g[1], 64), np.int16)
            for chunks, g in zip(per_plane, _plane_grids(hdr))
        ]
    qtables = _qtables(hdr.quality, hdr.channels)
    row_ranges = [tuple(r) for r in plane_ranges]
    return hdr, planes_zz, qtables, row_ranges


@functools.lru_cache(maxsize=1024)
def _staged_coeff_shape(
    channels: int, n_br: int, n_bc: int, subsample: bool, layout: str
) -> tuple[int, ...]:
    if layout == "padded":
        return (channels, n_br, n_bc, 64)
    if layout == "packed":
        n = n_br * n_bc
        if channels == 3:
            cbr, cbc = _chroma_grid(n_br, n_bc, subsample)
            n += 2 * cbr * cbc
        return (n, 64)
    raise ValueError(f"layout must be 'padded' or 'packed', got {layout!r}")


def staged_coeff_shape(hdr: JpegHeader, layout: str = "padded") -> tuple[int, ...]:
    """Shape of the single int16 staging tensor for the split-decode path.

    ``"padded"`` pads chroma blocks up to the luma grid:
    ``(channels, n_br, n_bc, 64)`` — for 4:4:4 this is exact (zero waste);
    for 4:2:0 it quadruples the chroma share.  ``"packed"`` concatenates
    the planes' blocks: ``(n_blocks_total, 64)`` — compact for 4:2:0
    (chroma is stored at its native quarter-density) at the price of the
    device program slicing the planes back apart by static offsets.

    Memoized per (channels, grid, subsample, layout): the staging hot
    path calls this once per item, and a shape-uniform corpus resolves to
    one cached tuple instead of re-deriving the grid arithmetic.
    """
    return _staged_coeff_shape(
        hdr.channels, hdr.n_br, hdr.n_bc, bool(hdr.subsample), layout
    )


def stage_coefficients(
    planes_zz: list[np.ndarray], hdr: JpegHeader, layout: str = "padded"
) -> np.ndarray:
    """Pack per-plane zigzag coefficient blocks into ONE staging tensor.

    The pipelined engine / request scheduler stage one ndarray per item,
    so 4:2:0's ragged chroma (quarter-density blocks) must flatten into a
    single tensor either by padding to the luma grid or by packing planes
    end to end — :func:`staged_coeff_shape` documents the trade; the cost
    model (core/cost_model.coeff_staging_bytes) prices both.
    """
    shape = staged_coeff_shape(hdr, layout)
    if layout == "packed":
        return np.concatenate(
            [np.ascontiguousarray(p, dtype=np.int16).reshape(-1, 64) for p in planes_zz],
            axis=0,
        )
    if not hdr.subsample or hdr.channels == 1:
        return np.stack(planes_zz).astype(np.int16, copy=False)
    out = np.zeros(shape, dtype=np.int16)
    out[0] = planes_zz[0]
    cbr, cbc = chroma_grid(hdr)
    for p in (1, 2):
        out[p, :cbr, :cbc] = planes_zz[p]
    return out


def _idct_plane(zz: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Dequantize + IDCT a (rows, cols, 64) zigzagged plane -> pixel plane."""
    rows, cols, _ = zz.shape
    coeffs = zz.reshape(-1, 64)[:, dct.UNZIGZAG].reshape(rows, cols, 8, 8)
    coeffs = coeffs.astype(np.float64) * qtable
    pix = dct.idct_blocks(coeffs)
    return dct.unblockify(pix, rows * 8, cols * 8)


def decode(
    data: bytes,
    roi: tuple[int, int, int, int] | None = None,
    max_rows: int | None = None,
    dc_only: bool = False,
) -> np.ndarray:
    """Full decode to uint8 pixels (optionally partial).

    ``roi=(y0, x0, y1, x1)`` decodes only the bands intersecting the ROI and
    runs the IDCT only on intersecting block columns, returning the ROI crop
    (snapped outward to the macroblock grid).  ``max_rows`` early-stops after
    the top ``max_rows`` pixel rows.  ``dc_only`` returns the 1/8-resolution
    DC image (progressive first-scan analogue).
    """
    hdr, planes_zz, qtables, row_ranges = decode_to_coefficients(data, roi=roi, max_rows=max_rows)

    col_slices = [slice(None)] * len(planes_zz)
    if roi is not None:
        _, x0, _, x1 = roi
        snap = 16 if hdr.subsample else 8
        x0 = max(0, (x0 // snap) * snap)
        x1 = min(hdr.width, ((x1 + snap - 1) // snap) * snap)
        col_slices[0] = slice(x0 // 8, (x1 + 7) // 8)
        for p in range(1, len(planes_zz)):
            col_slices[p] = slice(x0 // 16, (x1 + 15) // 16) if hdr.subsample else col_slices[0]

    if dc_only:
        recon_planes = []
        for zz, qt, cs in zip(planes_zz, qtables, col_slices):
            dc_img = zz[:, cs, 0].astype(np.float64) * qt[0, 0] / 8.0 + 128.0
            recon_planes.append(dc_img)
    else:
        recon_planes = [
            _idct_plane(zz[:, cs], qt) + 128.0
            for zz, qt, cs in zip(planes_zz, qtables, col_slices)
        ]

    if hdr.channels == 3 and hdr.subsample:
        y = recon_planes[0]
        up = []
        for c in recon_planes[1:]:
            c2 = np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)
            up.append(c2[: y.shape[0], : y.shape[1]])
        recon_planes = [y] + up
    ycc = np.stack(recon_planes, axis=-1)
    rgb = dct.ycbcr_to_rgb(ycc) if hdr.channels == 3 else ycc

    scale = 8 if dc_only else 1
    if roi is not None:
        y0 = row_ranges[0][0] * 8
        # crop within decoded region to the snapped ROI
        ry0, rx0, ry1, rx1 = roi
        snap = 16 if hdr.subsample else 8
        sy0 = max(0, (ry0 // snap) * snap)
        sy1 = min(hdr.height, ((ry1 + snap - 1) // snap) * snap)
        sx0 = max(0, (rx0 // snap) * snap)
        sx1 = min(hdr.width, ((rx1 + snap - 1) // snap) * snap)
        rgb = rgb[(sy0 - y0) // scale : (sy1 - y0 + scale - 1) // scale]
        h_lim = (sy1 - sy0 + scale - 1) // scale
        w_lim = (sx1 - sx0 + scale - 1) // scale
        rgb = rgb[:h_lim, :w_lim]
    else:
        row0 = row_ranges[0][0] * 8
        h_decoded = min(hdr.height, row_ranges[0][1] * 8) - row0
        if max_rows is not None:
            h_decoded = min(h_decoded, max_rows)
        rgb = rgb[: (h_decoded + scale - 1) // scale, : (hdr.width + scale - 1) // scale]

    out = np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    return out[..., 0] if hdr.channels == 1 else out


def scaled_size(dim: int, factor: int) -> int:
    """Output extent of one axis under a 1/factor scaled decode (ceil)."""
    return -(-dim // factor)


def decode_scaled(data: bytes, factor: int = 2) -> np.ndarray:
    """Reduced-resolution decode straight from coefficients (paper §6.4).

    Runs the truncated-DCT-basis scaled IDCT (``dct.scaled_idct_basis``)
    at ``point = 8 // factor`` so each coefficient block reconstructs to a
    ``point x point`` pixel block — the numpy golden reference for the
    device split-decode program's scaled variants (libjpeg draft-mode
    analogue).  ``factor`` must be 1, 2 or 4; the output is
    ``(ceil(h/factor), ceil(w/factor))`` and ``factor=1`` reproduces
    :func:`decode` exactly.
    """
    if factor not in (1, 2, 4):
        raise ValueError(f"factor must be 1, 2 or 4, got {factor}")
    hdr, planes_zz, qtables, _ = decode_to_coefficients(data)
    point = 8 // factor
    basis = dct.scaled_idct_basis(point)
    recon = []
    for zz, qt in zip(planes_zz, qtables):
        rows, cols, _ = zz.shape
        coeffs = zz.reshape(-1, 64)[:, dct.UNZIGZAG].reshape(rows, cols, 8, 8)
        pix = basis @ (coeffs.astype(np.float64) * qt) @ basis.T
        recon.append(dct.unblockify(pix, rows * point, cols * point) + 128.0)
    hs = scaled_size(hdr.height, factor)
    ws = scaled_size(hdr.width, factor)
    y = recon[0][:hs, :ws]
    planes = [y]
    if hdr.channels == 3:
        for c in recon[1:]:
            if hdr.subsample:
                c = np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)
            planes.append(c[:hs, :ws])
    img = np.stack(planes, axis=-1)
    if hdr.channels == 3:
        img = dct.ycbcr_to_rgb(img)
    out = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return out[..., 0] if hdr.channels == 1 else out
