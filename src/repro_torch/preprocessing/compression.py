"""Entropy-coding backend shared by the SJPG/SPNG/SVID codecs.

The codecs' bit-level entropy stage is zstd (whose FSE/Huffman stages are
real entropy coders).  ``zstandard`` is an *optional* dependency
(``pip install repro[compression]``): when it is absent, payloads are
stored uncompressed behind the same framing, so every codec keeps
round-tripping — only the compression ratio degrades.  Decoding a
zstd-compressed stream without ``zstandard`` installed raises a clear
error at the point of use, not at import time.

Each payload is framed with a one-byte method tag so streams are
self-describing across environments:

    0x00  stored (raw bytes follow)
    0x01  zstd frame follows
"""

from __future__ import annotations

import threading as _threading

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - exercised on bare environments
    _zstd = None

STORED = 0x00
ZSTD = 0x01

# zstd contexts are NOT thread-safe; SMOL's engine decodes from a
# producer pool -> thread-local contexts, keyed by compression level.
_TLS = _threading.local()


def have_zstd() -> bool:
    return _zstd is not None


def _cctx(level: int):
    cache = getattr(_TLS, "cctx", None)
    if cache is None:
        cache = _TLS.cctx = {}
    ctx = cache.get(level)
    if ctx is None:
        ctx = cache[level] = _zstd.ZstdCompressor(level=level)
    return ctx


def _dctx():
    if not hasattr(_TLS, "dctx"):
        _TLS.dctx = _zstd.ZstdDecompressor()
    return _TLS.dctx


def compress(raw: bytes, level: int = 3) -> bytes:
    """Frame ``raw`` with the best available entropy coder."""
    if _zstd is not None:
        return bytes((ZSTD,)) + _cctx(level).compress(raw)
    return bytes((STORED,)) + raw


def decompressed_size(blob) -> int | None:
    """Decoded payload size in bytes, or None when not cheaply knowable.

    STORED frames know it exactly; zstd frames carry a content-size field
    when the compressor wrote one (``zstandard.frame_content_size``).
    Callers use this to pre-size arena scratch for :func:`decompress_into`.
    """
    if len(blob) == 0:
        raise ValueError("empty compressed payload")
    method = blob[0]
    if method == STORED:
        return len(blob) - 1
    if method == ZSTD and _zstd is not None:
        probe = getattr(_zstd, "frame_content_size", None)
        if probe is not None:
            size = probe(bytes(memoryview(blob)[1:]))
            return int(size) if size is not None and size >= 0 else None
    return None


def decompress_into(blob, out) -> int:
    """Decode ``blob`` into the caller-provided buffer ``out`` (a writable
    uint8 ndarray/memoryview of at least :func:`decompressed_size` bytes).
    Returns the number of bytes written.

    This is the allocation-free path for arena-backed codec scratch
    (preprocessing/scratch.py): STORED frames copy straight into the arena
    slice; zstd frames decode via ``decompress_into`` when the installed
    ``zstandard`` exposes it, else decode-then-copy (one transient bytes
    object — still no per-band numpy allocation downstream).
    """
    import numpy as _np

    if len(blob) == 0:
        raise ValueError("empty compressed payload")
    method = blob[0]
    payload = memoryview(blob)[1:]
    dest = _np.frombuffer(memoryview(out), dtype=_np.uint8) if not isinstance(out, _np.ndarray) else out
    if method == STORED:
        n = len(payload)
        dest[:n] = _np.frombuffer(payload, dtype=_np.uint8)
        return n
    if method == ZSTD:
        if _zstd is None:
            raise RuntimeError(
                "stream is zstd-compressed but the 'zstandard' package is not "
                "installed; install the [compression] extra to decode it"
            )
        # decode-then-copy: zstandard's zero-copy decompress_into varies
        # across versions, and the transient bytes object is the zstd
        # library's own buffer either way — the win here is removing the
        # per-band *numpy* allocations downstream
        data = _dctx().decompress(bytes(payload))
        dest[: len(data)] = _np.frombuffer(data, dtype=_np.uint8)
        return len(data)
    raise ValueError(f"unknown compression method tag {method:#x}")


def decompress(blob: bytes) -> bytes:
    """Inverse of :func:`compress`; raises if the method is unavailable."""
    if len(blob) == 0:
        raise ValueError("empty compressed payload")
    method = blob[0]
    payload = bytes(blob[1:])
    if method == STORED:
        return payload
    if method == ZSTD:
        if _zstd is None:
            raise RuntimeError(
                "stream is zstd-compressed but the 'zstandard' package is not "
                "installed; install the [compression] extra to decode it"
            )
        return _dctx().decompress(payload)
    raise ValueError(f"unknown compression method tag {method:#x}")
