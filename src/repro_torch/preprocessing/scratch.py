"""Arena-backed scratch for codec band payloads (ROADMAP: arena codecs).

The SJPG/SPNG codecs decode band-by-band: each band needs a decompressed
payload buffer and (for SJPG) a dense coefficient buffer, all dead as soon
as the bands are concatenated into the caller's result.  Before this
module, every band hit the system allocator; at serving rates that
allocator traffic is exactly what "Beyond Inference" measures dominating
host-side cost.  Now per-band scratch is a bump-pointer slice from a
thread-local :class:`repro_torch.runtime.memory.FrameArena` — steady-state decode
touches the allocator zero times (each producer worker thread owns its own
arena, so there is no cross-worker lock traffic either).

Usage (inside a codec):

    with band_scratch() as scratch:
        buf = scratch.alloc_bytes(n)          # uint8 view
        zz = scratch.alloc((blocks, 64), np.int16)  # zero-filled typed view
        ...  # slices all release when the block exits

The arena import is deferred so ``repro_torch.preprocessing`` stays importable
without ``repro_torch.runtime`` (the runtime package imports preprocessing at
init time).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import numpy as np

_TLS = threading.local()


def _arena():
    arena = getattr(_TLS, "arena", None)
    if arena is None:
        from repro_torch.runtime.memory import FrameArena

        arena = _TLS.arena = FrameArena(block_bytes=1 << 20)
    return arena


def arena_stats():
    """This thread's codec-scratch arena occupancy (ArenaStats)."""
    return _arena().stats()


class BandScratch:
    """Scoped allocator over the thread-local arena; releases on exit."""

    def __init__(self):
        self._slices = []

    def alloc_bytes(self, nbytes: int) -> np.ndarray:
        """Uninitialized uint8 scratch of ``nbytes`` (an arena slice view).

        Requests round up to 64-byte multiples so successive slices stay
        aligned for typed views (arena blocks bump-allocate)."""
        nbytes = int(nbytes)
        sl = _arena().alloc(-(-nbytes // 64) * 64)
        self._slices.append(sl)
        return sl.array[:nbytes]

    def alloc(self, shape: tuple[int, ...], dtype, zero: bool = True) -> np.ndarray:
        """Typed scratch view; zero-filled by default (arena memory is
        recycled, so callers relying on np.zeros semantics need the fill)."""
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        raw = self.alloc_bytes(nbytes)
        view = raw[:nbytes].view(dtype).reshape(shape)
        if zero:
            view.fill(0)
        return view

    def release(self) -> None:
        slices, self._slices = self._slices, []
        for sl in reversed(slices):
            sl.release()


@contextmanager
def band_scratch():
    scratch = BandScratch()
    try:
        yield scratch
    finally:
        scratch.release()
