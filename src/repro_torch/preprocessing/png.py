"""Lossless "PNG-analog" codec: per-row delta filtering + zstd.

Real PNG = per-scanline prediction filters + DEFLATE.  We keep the same
structure (up-predictor filtering, then a general-purpose entropy coder)
so the decode cost profile is honest: an inherently sequential, branchy,
host-side entropy stage followed by a cheap vectorizable unfilter.

Supports *early stopping* (decode only the top N pixel rows) via
row-banded zstd frames, mirroring the paper's Table 4 entry for PNG.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from repro_torch.preprocessing import compression, scratch as scratch_mod

MAGIC = b"SPNG"
VERSION = 2  # v2: band payloads framed by preprocessing.compression method tags
_HDR = struct.Struct("<4sBIIBH")  # magic, version, h, w, channels, band_rows



@dataclasses.dataclass(frozen=True)
class PngHeader:
    height: int
    width: int
    channels: int
    band_rows: int
    band_offsets: tuple[int, ...]
    payload_start: int


def encode(img: np.ndarray, band_rows: int = 32) -> bytes:
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    # "Up" filter: delta each row against the previous one (first row raw).
    filtered = img.copy()
    filtered[1:] = img[1:] - img[:-1]  # uint8 wraparound = modular delta
    bands = []
    for r0 in range(0, h, band_rows):
        bands.append(compression.compress(filtered[r0 : r0 + band_rows].tobytes(), level=6))
    header = _HDR.pack(MAGIC, VERSION, h, w, c, band_rows)
    offsets, cur = [], 0
    for b in bands:
        offsets.append(cur)
        cur += len(b)
    blob = struct.pack(f"<I{len(bands)}I", len(bands), *offsets)
    return header + blob + b"".join(bands)


def peek_header(data: bytes) -> PngHeader:
    magic, ver, h, w, c, band_rows = _HDR.unpack_from(data, 0)
    if magic != MAGIC or ver != VERSION:
        raise ValueError("not an SPNG stream")
    off = _HDR.size
    (n_bands,) = struct.unpack_from("<I", data, off)
    off += 4
    offsets = struct.unpack_from(f"<{n_bands}I", data, off)
    off += 4 * n_bands
    return PngHeader(h, w, c, band_rows, tuple(offsets), off)


def decode(data: bytes, max_rows: int | None = None) -> np.ndarray:
    hdr = peek_header(data)
    h = hdr.height if max_rows is None else min(hdr.height, max_rows)
    n_bands_needed = (h + hdr.band_rows - 1) // hdr.band_rows
    chunks = []
    # band payloads decompress into thread-local FrameArena scratch —
    # steady-state decode allocates nothing per band (ROADMAP: arena codecs)
    with scratch_mod.band_scratch() as scratch:
        for band in range(n_bands_needed):
            start = hdr.payload_start + hdr.band_offsets[band]
            end = (
                hdr.payload_start + hdr.band_offsets[band + 1]
                if band + 1 < len(hdr.band_offsets)
                else len(data)
            )
            blob = memoryview(data)[start:end]
            raw = None
            size = compression.decompressed_size(blob)
            if size is not None:
                buf = scratch.alloc_bytes(size)
                n = compression.decompress_into(blob, buf)
                raw = buf[:n]
            if raw is None:
                raw = compression.decompress(bytes(blob))
            rows = min(hdr.band_rows, hdr.height - band * hdr.band_rows)
            chunks.append(
                np.frombuffer(raw, dtype=np.uint8).reshape(rows, hdr.width, hdr.channels)
            )
        filtered = np.concatenate(chunks, axis=0)
    img = np.cumsum(filtered.astype(np.int64), axis=0).astype(np.uint8)  # undo Up filter
    img = img[:h]
    return img[..., 0] if hdr.channels == 1 else img
