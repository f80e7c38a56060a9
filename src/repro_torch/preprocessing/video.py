"""H.264-flavoured video codec model.

Keeps the structural properties the paper exploits (§6.4):

* GOP structure — I-frames (intra, JPEG-style transform coding) every
  ``gop`` frames, P-frames coded as quantized DCT *residuals* against the
  previously reconstructed frame (zero-motion prediction; motion search
  is not modelled — it does not change the decode-cost structure SMOL
  exploits).
* A **deblocking filter** applied at decode to every 8-pixel block
  boundary, which can be disabled for *reduced-fidelity decoding* — the
  paper's H.264/HEVC trade-off: faster decode, slight quality loss.
* Frame-offset index for seeking; decoding frame ``t`` only requires the
  frames from the preceding I-frame.

Like :mod:`repro_torch.preprocessing.jpeg`, the bit-level entropy coder is
zstd over a byte-aligned sparse coefficient layout.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from repro_torch.preprocessing import compression, dct
from repro_torch.preprocessing.jpeg import _decode_rows_sparse, _encode_rows_sparse

MAGIC = b"SVID"
VERSION = 2  # v2: frame payloads framed by preprocessing.compression method tags
_HDR = struct.Struct("<4sBIIIBBB")  # magic, ver, T, h, w, channels, quality, gop


I_FRAME, P_FRAME = 0, 1


@dataclasses.dataclass(frozen=True)
class VideoHeader:
    num_frames: int
    height: int
    width: int
    channels: int
    quality: int
    gop: int
    frame_offsets: tuple[int, ...]
    frame_types: tuple[int, ...]
    payload_start: int


def _plane_qtables(quality: int) -> list[np.ndarray]:
    return [
        dct.quality_scale(dct.QTABLE_LUMA, quality),
        dct.quality_scale(dct.QTABLE_CHROMA, quality),
        dct.quality_scale(dct.QTABLE_CHROMA, quality),
    ]


def _code_planes(planes: list[np.ndarray], qtables: list[np.ndarray]) -> tuple[bytes, list[np.ndarray]]:
    """Transform-code a list of float planes; return payload + reconstruction."""
    parts, recon = [], []
    for plane, qt in zip(planes, qtables):
        blocks, n_br, n_bc = dct.blockify(plane)
        coeffs = dct.fdct_blocks(blocks)
        quant = np.clip(np.round(coeffs / qt), -32768, 32767).astype(np.int16)
        zz = quant.reshape(-1, 64)[:, dct.ZIGZAG]
        parts.append(struct.pack("<HH", n_br, n_bc) + _encode_rows_sparse(zz))
        deq = quant.astype(np.float64) * qt
        recon.append(dct.unblockify(dct.idct_blocks(deq), *plane.shape))
    return b"".join(parts), recon


def _decode_planes(raw: memoryview, shapes: list[tuple[int, int]], qtables: list[np.ndarray]) -> list[np.ndarray]:
    out, off = [], 0
    for (h, w), qt in zip(shapes, qtables):
        n_br, n_bc = struct.unpack_from("<HH", raw, off)
        off += 4
        zz, off = _decode_rows_sparse(raw, off)
        quant = zz[:, dct.UNZIGZAG].reshape(n_br, n_bc, 8, 8).astype(np.float64)
        out.append(dct.unblockify(dct.idct_blocks(quant * qt), h, w))
    return out


def deblock_plane(plane: np.ndarray, strength: float = 0.5) -> np.ndarray:
    """In-loop-style deblocking: low-pass the two pixels astride each 8-px
    block boundary.  Vectorized over all boundaries at once."""
    out = plane.copy()
    h, w = plane.shape
    rows = np.arange(8, h, 8)
    if rows.size:
        a, b = out[rows - 1], out[rows]
        avg = 0.5 * (a + b)
        out[rows - 1] = a + strength * (avg - a)
        out[rows] = b + strength * (avg - b)
    cols = np.arange(8, w, 8)
    if cols.size:
        a, b = out[:, cols - 1], out[:, cols]
        avg = 0.5 * (a + b)
        out[:, cols - 1] = a + strength * (avg - a)
        out[:, cols] = b + strength * (avg - b)
    return out


def encode(frames: np.ndarray, quality: int = 75, gop: int = 8) -> bytes:
    """Encode (T, H, W, 3) uint8 frames."""
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T,H,W,3) uint8, got {frames.shape} {frames.dtype}")
    t_total, h, w, _ = frames.shape
    qtables = _plane_qtables(quality)
    payloads, types = [], []
    prev_recon: list[np.ndarray] | None = None
    for t in range(t_total):
        ycc = dct.rgb_to_ycbcr(frames[t])
        planes = [ycc[..., c] - 128.0 for c in range(3)]
        if t % gop == 0 or prev_recon is None:
            payload, recon = _code_planes(planes, qtables)
            types.append(I_FRAME)
        else:
            residuals = [p - r for p, r in zip(planes, prev_recon)]
            payload, res_recon = _code_planes(residuals, qtables)
            recon = [r + rr for r, rr in zip(prev_recon, res_recon)]
            types.append(P_FRAME)
        prev_recon = recon
        payloads.append(compression.compress(payload, level=3))

    header = _HDR.pack(MAGIC, VERSION, t_total, h, w, 3, quality, gop)
    offsets, cur = [], 0
    for p in payloads:
        offsets.append(cur)
        cur += len(p)
    blob = struct.pack(f"<I{t_total}I{t_total}B", t_total, *offsets, *types)
    return header + blob + b"".join(payloads)


def peek_header(data: bytes) -> VideoHeader:
    magic, ver, t_total, h, w, c, quality, gop = _HDR.unpack_from(data, 0)
    if magic != MAGIC or ver != VERSION:
        raise ValueError("not an SVID stream")
    off = _HDR.size
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    offsets = struct.unpack_from(f"<{n}I", data, off)
    off += 4 * n
    types = struct.unpack_from(f"<{n}B", data, off)
    off += n
    return VideoHeader(t_total, h, w, c, quality, gop, tuple(offsets), tuple(types), off)


def _frame_payload(data: bytes, hdr: VideoHeader, t: int) -> memoryview:
    start = hdr.payload_start + hdr.frame_offsets[t]
    end = (
        hdr.payload_start + hdr.frame_offsets[t + 1]
        if t + 1 < hdr.num_frames
        else len(data)
    )
    return memoryview(compression.decompress(data[start:end]))


def decode(
    data: bytes,
    frame_indices: list[int] | None = None,
    max_frames: int | None = None,
    deblock: bool = True,
) -> np.ndarray:
    """Decode to (T, H, W, 3) uint8.

    ``deblock=False`` is the reduced-fidelity fast path (paper §6.4).
    ``frame_indices`` decodes only the requested frames (each seeks from the
    preceding I-frame — the real cost structure of GOP seeking).
    """
    hdr = peek_header(data)
    qtables = _plane_qtables(hdr.quality)
    shapes = [(hdr.height, hdr.width)] * 3

    if frame_indices is None:
        n = hdr.num_frames if max_frames is None else min(hdr.num_frames, max_frames)
        wanted = list(range(n))
    else:
        wanted = sorted(set(frame_indices))

    # Figure out the full set of frames we must reconstruct (GOP closure).
    needed: set[int] = set()
    for t in wanted:
        start = (t // hdr.gop) * hdr.gop
        needed.update(range(start, t + 1))

    recon_cache: dict[int, list[np.ndarray]] = {}
    out = np.empty((len(wanted), hdr.height, hdr.width, 3), dtype=np.uint8)
    want_pos = {t: i for i, t in enumerate(wanted)}
    prev: list[np.ndarray] | None = None
    for t in sorted(needed):
        raw = _frame_payload(data, hdr, t)
        if hdr.frame_types[t] == I_FRAME:
            recon = _decode_planes(raw, shapes, qtables)
        else:
            if prev is None:
                raise ValueError(f"P-frame {t} without reconstructed predecessor")
            res = _decode_planes(raw, shapes, qtables)
            recon = [p + r for p, r in zip(prev, res)]
        prev = recon
        recon_cache[t] = recon
        if t in want_pos:
            planes = [deblock_plane(p) for p in recon] if deblock else recon
            ycc = np.stack([p + 128.0 for p in planes], axis=-1)
            rgb = dct.ycbcr_to_rgb(ycc)
            out[want_pos[t]] = np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    return out
