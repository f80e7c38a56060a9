"""High-throughput memory subsystem for the pipelined engine (paper §6.1 (c)).

The paper's engine "efficiently manages memory and threading for high
throughput execution": buffers are preallocated, pinned, and reused rather
than allocated per item.  "Beyond Inference" (AbouElhamayed et al., 2024)
measures why that matters — at serving rates, allocator traffic and copies
on the host side routinely dominate end-to-end latency.  This module is the
allocation story for every hot path (decode → resize → stage → batch →
device):

* :class:`BufferPool` — size-bucketed pool of reusable fixed-shape buffers
  with strict lease/release semantics (a buffer backs at most one live
  lease; double release raises).  The engine draws its batch staging
  buffers here — page-locked (CUDA pinned) host memory when the engine
  feeds a card, so host-to-device copies are asynchronous.
* :class:`FrameArena` — block arena for *variable-size* intermediates
  (decoded frames whose dims vary per item).  Allocation is a bump-pointer
  slice; blocks recycle when their last slice is released, so steady-state
  traffic never touches the system allocator.
* :class:`MemoryBudget` — admission controller bounding total in-flight
  decoded bytes.  Producers admit before decoding; consumers release after
  staging.  Under pressure, admission blocks (backpressure) or fails fast
  (load shedding), instead of queueing without bound.  Budgets are
  **hierarchical** for multi-tenant serving: :meth:`MemoryBudget.child`
  carves a per-tenant child out of a global parent — every child admission
  charges both levels atomically, each child is *guaranteed* its
  ``floor_bytes`` (siblings can never consume a tenant's floor), and bytes
  beyond the floor compete for the unfloored headroom under a
  weight-proportional soft cap.  One tenant's burst therefore saturates
  its own quota, not the server.
* :class:`MemoryConfig` — one config object the runtime threads through
  engine, scheduler, and facade.

Everything is thread-safe; the pool and arena are shared by all producer
workers and the consumer.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np


def _round_up_pow2(n: int, floor: int) -> int:
    b = max(int(n), 1, int(floor))
    return 1 << (b - 1).bit_length()


# --------------------------------------------------------------------- config
@dataclasses.dataclass
class MemoryConfig:
    """Memory-and-threading policy, threaded through the whole runtime.

    ``pooling=False`` reproduces the naive allocate-per-batch baseline (the
    bench sweeps both to keep the pooled path honest).
    """

    pooling: bool = True
    bucket_min_bytes: int = 4096  # smallest pool bucket (pow-2 rounding floor)
    max_buffers_per_bucket: int = 8  # release beyond this frees instead of hoards
    arena_block_bytes: int = 1 << 20
    budget_bytes: int | None = None  # cap on in-flight decoded bytes; None = off
    max_pending: int | None = None  # scheduler admission: max in-flight requests
    admission: str = "block"  # "block" (backpressure) | "reject" (shed load)
    admission_timeout_s: float = 30.0
    # outstanding H2D staging buffers for double-buffered dispatch; 0 = auto
    # (the engine sizes the pool to its dispatch ring + 1)
    transfer_slots: int = 0
    # corpus-level rendition cache (runtime/rendition_cache.py): byte cap
    # on materialized physical representations (staged coefficient tensors,
    # transcoded pixel renditions).  None/0 = cache off — the serving hot
    # path is then byte-identical to the cacheless runtime (no lookups, no
    # allocations).  When budget_bytes is also set, the cache capacity is a
    # MemoryBudget child of the serving hierarchy: cache bytes compete for
    # unfloored headroom under rendition_cache_weight and can never eat a
    # tenant's guaranteed floor.
    rendition_cache_bytes: int | None = None
    rendition_cache_weight: float = 1.0
    # cost-aware admission floor: measured host seconds a hit saves, per
    # MiB of entry; 0.0 admits anything that fits the byte budget
    rendition_cache_min_utility: float = 0.0

    def __post_init__(self):
        if self.admission not in ("block", "reject"):
            raise ValueError(f"admission must be 'block' or 'reject', got {self.admission!r}")
        if self.transfer_slots < 0:
            raise ValueError(f"transfer_slots must be >= 0, got {self.transfer_slots}")
        if self.rendition_cache_bytes is not None and self.rendition_cache_bytes < 0:
            raise ValueError(
                f"rendition_cache_bytes must be >= 0 or None, got {self.rendition_cache_bytes}"
            )
        if self.rendition_cache_weight <= 0:
            raise ValueError(
                f"rendition_cache_weight must be positive, got {self.rendition_cache_weight}"
            )
        if self.rendition_cache_min_utility < 0:
            raise ValueError(
                "rendition_cache_min_utility must be >= 0, "
                f"got {self.rendition_cache_min_utility}"
            )

    def build_pool(self, pinned: bool = False) -> "BufferPool | None":
        return (
            BufferPool(
                bucket_min_bytes=self.bucket_min_bytes,
                max_buffers_per_bucket=self.max_buffers_per_bucket,
                pinned=pinned,
            )
            if self.pooling
            else None
        )

    def build_budget(self) -> "MemoryBudget | None":
        return MemoryBudget(self.budget_bytes) if self.budget_bytes else None

    def build_transfer_pool(self, default_slots: int, pinned: bool = False) -> "TransferPool":
        """Staging-buffer pool for the engine's dispatch pipeline.

        Wraps :meth:`build_pool` (or fresh per-lease allocation when pooling
        is off) behind the bounded slot count double-buffered dispatch needs.
        ``pinned`` backs every staging buffer with page-locked host memory,
        so a CUDA runtime's host-to-device copies can be ``non_blocking``.
        """
        return TransferPool(
            self.transfer_slots or default_slots,
            buffers=self.build_pool(pinned),
            pinned=pinned,
        )


# ----------------------------------------------------------------------- pool
def _host_buffer(nbytes: int, pinned: bool) -> np.ndarray:
    """A flat uint8 host buffer; page-locked (CUDA pinned) when ``pinned``.

    The numpy view keeps the pinned torch tensor that owns the memory
    alive."""
    if not pinned:
        return np.empty(nbytes, dtype=np.uint8)
    import torch

    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()


@dataclasses.dataclass(frozen=True)
class PoolStats:
    """Occupancy snapshot; the zero-net-growth invariant is checked on these."""

    buffers_allocated: int  # system allocations ever made (growth must plateau)
    bytes_allocated: int
    leases_issued: int
    leases_active: int
    leases_reused: int  # issued minus fresh allocations
    bytes_in_use: int
    high_water_bytes: int

    @property
    def reuse_rate(self) -> float:
        return self.leases_reused / self.leases_issued if self.leases_issued else 0.0


class BufferLease:
    """One checked-out buffer.  Release exactly once (context manager works)."""

    __slots__ = ("array", "_pool", "_bucket", "_raw", "_released")

    def __init__(self, array: np.ndarray, pool: "BufferPool", bucket: int, raw: np.ndarray):
        self.array = array
        self._pool = pool
        self._bucket = bucket
        self._raw = raw
        self._released = False

    def release(self) -> None:
        if self._released:
            raise RuntimeError("buffer lease released twice")
        self._released = True
        self._pool._give_back(self._bucket, self._raw)

    def __enter__(self) -> np.ndarray:
        return self.array

    def __exit__(self, *exc) -> None:
        self.release()


class BufferPool:
    """Size-bucketed pool of reusable buffers with lease/release semantics.

    Buckets are power-of-two byte sizes; a lease carves a typed view of the
    requested shape out of a flat uint8 buffer.  A buffer backs at most one
    live lease — it leaves the free list on lease and only re-enters it on
    release — so double-issue is structurally impossible; the invariant is
    additionally asserted.
    """

    def __init__(
        self, bucket_min_bytes: int = 4096, max_buffers_per_bucket: int = 8, pinned: bool = False
    ):
        self.bucket_min_bytes = bucket_min_bytes
        self.max_buffers_per_bucket = max_buffers_per_bucket
        self.pinned = pinned
        self._free: dict[int, list[np.ndarray]] = {}
        self._live: set[int] = set()  # id(raw) of checked-out buffers
        self._lock = threading.Lock()
        self._buffers_allocated = 0
        self._bytes_allocated = 0
        self._leases_issued = 0
        self._leases_reused = 0
        self._bytes_in_use = 0
        self._high_water = 0

    def lease(self, shape: tuple[int, ...], dtype: Any) -> BufferLease:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        bucket = _round_up_pow2(nbytes, self.bucket_min_bytes)
        with self._lock:
            free = self._free.setdefault(bucket, [])
            if free:
                raw = free.pop()
                self._leases_reused += 1
            else:
                raw = _host_buffer(bucket, self.pinned)
                self._buffers_allocated += 1
                self._bytes_allocated += bucket
            if id(raw) in self._live:  # pragma: no cover - structurally unreachable
                raise RuntimeError("buffer double-issued: still backing a live lease")
            self._live.add(id(raw))
            self._leases_issued += 1
            self._bytes_in_use += bucket
            self._high_water = max(self._high_water, self._bytes_in_use)
        view = raw[:nbytes].view(dtype).reshape(shape)
        return BufferLease(view, self, bucket, raw)

    def _give_back(self, bucket: int, raw: np.ndarray) -> None:
        with self._lock:
            self._live.discard(id(raw))
            self._bytes_in_use -= bucket
            free = self._free.setdefault(bucket, [])
            if len(free) < self.max_buffers_per_bucket:
                free.append(raw)
            else:  # beyond the hoard cap: let the allocator have it back
                self._buffers_allocated -= 1
                self._bytes_allocated -= bucket

    def stats(self) -> PoolStats:
        with self._lock:
            return PoolStats(
                buffers_allocated=self._buffers_allocated,
                bytes_allocated=self._bytes_allocated,
                leases_issued=self._leases_issued,
                leases_active=len(self._live),
                leases_reused=self._leases_reused,
                bytes_in_use=self._bytes_in_use,
                high_water_bytes=self._high_water,
            )


# -------------------------------------------------------------- transfer pool
@dataclasses.dataclass(frozen=True)
class TransferPoolStats:
    slots: int  # maximum concurrently-leased staging buffers
    leases_issued: int
    leases_active: int
    blocked_seconds: float  # time lessees spent waiting on a free slot
    pool: "PoolStats | None" = None  # backing BufferPool occupancy, if pooled


class TransferLease:
    """One pinned staging slot: a host buffer plus its bounded-slot token.

    Releasing returns the buffer to the backing :class:`BufferPool` (when
    pooled) and frees the slot for the next staging batch.  Strict
    release-once, same as :class:`BufferLease`.
    """

    __slots__ = ("array", "_pool", "_inner", "_released")

    def __init__(self, array: np.ndarray, pool: "TransferPool", inner: "BufferLease | None"):
        self.array = array
        self._pool = pool
        self._inner = inner
        self._released = False

    def release(self) -> None:
        if self._released:
            raise RuntimeError("transfer lease released twice")
        self._released = True
        if self._inner is not None:
            self._inner.release()
        self._pool._give_back()

    def __enter__(self) -> np.ndarray:
        return self.array

    def __exit__(self, *exc) -> None:
        self.release()


class TransferPool:
    """Bounded pool of host→device staging buffers (double-buffered dispatch).

    The engine's dispatch pipeline keeps several batches alive at once: the
    one being filled by the consumer, the one(s) queued for the dispatcher,
    and the ones in flight on the device.  This pool bounds that set to
    ``slots`` buffers — ``lease`` blocks when every slot is staged or in
    flight, which is exactly the backpressure that stops the consumer from
    racing ahead of the device.  Buffer storage reuses :class:`BufferPool`
    when one is supplied; otherwise each lease allocates fresh (the
    pooling-off baseline).
    """

    def __init__(self, slots: int, buffers: "BufferPool | None" = None, pinned: bool = False):
        if slots < 1:
            raise ValueError(f"transfer slots must be >= 1, got {slots}")
        self.slots = int(slots)
        self.buffers = buffers
        self.pinned = pinned
        self._sem = threading.Semaphore(self.slots)
        self._lock = threading.Lock()
        self._leases_issued = 0
        self._leases_active = 0
        self._blocked_seconds = 0.0

    def lease(
        self, shape: tuple[int, ...], dtype: Any, timeout: float | None = None
    ) -> "TransferLease | None":
        """Lease one staging buffer, blocking for a free slot.

        Returns ``None`` on timeout so callers waiting on a dead producer
        can notice instead of hanging on the semaphore forever.
        """
        import time

        t0 = time.perf_counter()
        if not self._sem.acquire(timeout=timeout):
            with self._lock:
                self._blocked_seconds += time.perf_counter() - t0
            return None
        waited = time.perf_counter() - t0
        if self.buffers is not None:
            inner = self.buffers.lease(shape, dtype)
            array = inner.array
        else:
            inner = None
            dt = np.dtype(dtype)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            array = _host_buffer(nbytes, self.pinned).view(dt).reshape(shape)
            array[...] = 0
        with self._lock:
            self._blocked_seconds += waited
            self._leases_issued += 1
            self._leases_active += 1
        return TransferLease(array, self, inner)

    def _give_back(self) -> None:
        with self._lock:
            self._leases_active -= 1
        self._sem.release()

    def stats(self) -> TransferPoolStats:
        with self._lock:
            return TransferPoolStats(
                slots=self.slots,
                leases_issued=self._leases_issued,
                leases_active=self._leases_active,
                blocked_seconds=self._blocked_seconds,
                pool=self.buffers.stats() if self.buffers is not None else None,
            )


# ---------------------------------------------------------------------- arena
@dataclasses.dataclass(frozen=True)
class ArenaStats:
    blocks_allocated: int  # must plateau under steady-state reuse
    blocks_free: int
    bytes_in_use: int
    high_water_bytes: int


class ArenaSlice:
    """One arena allocation; ``array`` is a uint8 view, release recycles."""

    __slots__ = ("array", "_arena", "_block", "_released")

    def __init__(self, array: np.ndarray, arena: "FrameArena", block: "_ArenaBlock"):
        self.array = array
        self._arena = arena
        self._block = block
        self._released = False

    def release(self) -> None:
        if self._released:
            raise RuntimeError("arena slice released twice")
        self._released = True
        self._arena._release(self._block, self.array.nbytes)


class _ArenaBlock:
    __slots__ = ("buf", "offset", "refs")

    def __init__(self, nbytes: int):
        self.buf = np.empty(nbytes, dtype=np.uint8)
        self.offset = 0
        self.refs = 0


class FrameArena:
    """Bump-pointer block arena for variable-size decoded frames.

    Slices bump within the current block; each block counts its live
    slices and returns to the free list when the last one is released and
    the arena has moved on.  Oversize requests (> block size) get a
    dedicated block that is freed, not recycled.
    """

    def __init__(self, block_bytes: int = 1 << 20, max_free_blocks: int = 8):
        self.block_bytes = block_bytes
        self.max_free_blocks = max_free_blocks
        self._current: _ArenaBlock | None = None
        self._free: list[_ArenaBlock] = []
        self._lock = threading.Lock()
        self._blocks_allocated = 0
        self._bytes_in_use = 0
        self._high_water = 0

    def alloc(self, nbytes: int) -> ArenaSlice:
        nbytes = int(nbytes)
        with self._lock:
            if nbytes > self.block_bytes:
                block = _ArenaBlock(nbytes)  # dedicated, freed on release
                self._blocks_allocated += 1
                block.offset = nbytes
                block.refs = 1
                view = block.buf[:nbytes]
            else:
                cur = self._current
                if cur is None or cur.offset + nbytes > self.block_bytes:
                    self._retire_current()
                    cur = self._take_block()
                    self._current = cur
                view = cur.buf[cur.offset : cur.offset + nbytes]
                cur.offset += nbytes
                cur.refs += 1
                block = cur
            self._bytes_in_use += nbytes
            self._high_water = max(self._high_water, self._bytes_in_use)
        return ArenaSlice(view, self, block)

    def _take_block(self) -> _ArenaBlock:
        if self._free:
            block = self._free.pop()
            block.offset = 0
            block.refs = 0
            return block
        self._blocks_allocated += 1
        return _ArenaBlock(self.block_bytes)

    def _retire_current(self) -> None:
        # caller holds the lock; a full current block with no live refs can
        # recycle immediately, otherwise its last release recycles it
        cur = self._current
        self._current = None
        if cur is not None and cur.refs == 0:
            self._recycle(cur)

    def _recycle(self, block: _ArenaBlock) -> None:
        if len(self._free) < self.max_free_blocks:
            self._free.append(block)
        else:
            self._blocks_allocated -= 1

    def _release(self, block: _ArenaBlock, nbytes: int) -> None:
        with self._lock:
            self._bytes_in_use -= nbytes
            block.refs -= 1
            if block.refs == 0 and block is not self._current:
                if block.buf.nbytes != self.block_bytes:  # oversize: free outright
                    self._blocks_allocated -= 1
                else:
                    self._recycle(block)

    def stats(self) -> ArenaStats:
        with self._lock:
            return ArenaStats(
                blocks_allocated=self._blocks_allocated,
                blocks_free=len(self._free),
                bytes_in_use=self._bytes_in_use,
                high_water_bytes=self._high_water,
            )


# --------------------------------------------------------------------- budget
@dataclasses.dataclass(frozen=True)
class BudgetStats:
    max_bytes: int
    in_flight_bytes: int
    high_water_bytes: int
    admitted: int
    rejected: int
    blocked_seconds: float
    name: str = "root"
    floor_bytes: int = 0
    weight: float = 1.0


class MemoryBudget:
    """Bounds total in-flight decoded bytes across producers.

    ``admit`` blocks until the bytes fit (backpressure); ``try_admit``
    fails fast (load shedding).  A single request larger than the whole
    budget is admitted when nothing else is in flight, so oversized items
    degrade to serial execution instead of deadlocking the pipeline.

    **Hierarchy** (multi-tenant): :meth:`child` creates a per-tenant child
    budget under this one.  A child admission charges the child *and* every
    ancestor atomically (they share one lock), and releases walk back up
    the same chain.  Two guarantees hold at all times:

    * **floors** — each child is guaranteed ``floor_bytes``: admissions
      that keep the child at or under its floor only need floor headroom,
      which the parent pre-reserves (the sum of floors may not exceed the
      parent's ``max_bytes``).  Bytes *beyond* the floor compete for the
      parent's unfloored headroom, from which every sibling's unused floor
      is excluded — so a bursting tenant can exhaust the shared headroom
      but never a sibling's guarantee.  The oversize-when-idle escape
      hatch is disabled on budgets with floored children for the same
      reason: an untenanted request bigger than the unfloored headroom is
      rejected outright rather than parked on floor-reserved bytes.
    * **weighted soft caps** — a child without an explicit ``max_bytes``
      gets ``floor + weight / Σweights × (parent_max − Σfloors)``,
      re-derived as siblings register, so quota defaults track the same
      weights the scheduler serves by.
    """

    def __init__(
        self,
        max_bytes: int,
        name: str = "root",
        *,
        parent: "MemoryBudget | None" = None,
        weight: float = 1.0,
        floor_bytes: int = 0,
    ):
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("budget max_bytes must be positive")
        if weight <= 0:
            raise ValueError(f"budget weight must be positive, got {weight}")
        if floor_bytes < 0:
            raise ValueError("floor_bytes must be >= 0")
        self.max_bytes = int(max_bytes) if max_bytes is not None else None
        self.name = name
        self.weight = float(weight)
        self.floor_bytes = int(floor_bytes)
        self._parent = parent
        self._children: list[MemoryBudget] = []
        self._in_flight = 0
        # one condition for the whole hierarchy: child admissions must read
        # and update ancestor occupancy atomically
        self._cond = parent._cond if parent is not None else threading.Condition()
        self._admitted = 0
        self._rejected = 0
        self._blocked_seconds = 0.0
        self._high_water = 0

    # ------------------------------------------------------------- hierarchy
    def child(
        self,
        name: str,
        weight: float = 1.0,
        floor_bytes: int = 0,
        max_bytes: int | None = None,
    ) -> "MemoryBudget":
        """Create a per-tenant child budget under this one.

        ``max_bytes=None`` leaves the child's cap weight-derived (see class
        docstring); an explicit value is a hard per-tenant quota.  Floors
        are validated here: they must collectively fit inside this budget.
        """
        with self._cond:
            if self.max_bytes is not None:
                floors = sum(c.floor_bytes for c in self._children) + floor_bytes
                if floors > self.max_bytes:
                    raise ValueError(
                        f"child floors ({floors}B) exceed parent budget "
                        f"({self.max_bytes}B)"
                    )
            kid = MemoryBudget(
                max_bytes if max_bytes is not None else None,
                name,
                parent=self,
                weight=weight,
                floor_bytes=floor_bytes,
            )
            self._children.append(kid)
            return kid

    def remove_child(self, kid: "MemoryBudget") -> None:
        """Detach ``kid``, returning its floor/weight to the hierarchy.

        Supports a long-lived root whose consumers come and go — e.g. a
        serving session's tenant children being replaced across restarts
        while a rendition-cache child persists.  The child must be drained
        (nothing in flight) or its ancestor accounting would leak.
        """
        with self._cond:
            if kid._in_flight:
                raise RuntimeError(
                    f"cannot remove child {kid.name!r} with "
                    f"{kid._in_flight}B in flight"
                )
            self._children.remove(kid)
            kid._parent = None
            self._cond.notify_all()

    def _effective_cap(self) -> int | None:
        """This budget's cap: explicit, or weight-derived under the parent.

        Caller holds the shared lock."""
        if self.max_bytes is not None:
            return self.max_bytes
        if self._parent is None or self._parent.max_bytes is None:
            return None  # unbounded child of an unbounded parent
        siblings = self._parent._children
        total_w = sum(c.weight for c in siblings)
        total_floors = sum(c.floor_bytes for c in siblings)
        headroom = max(0, self._parent.max_bytes - total_floors)
        return self.floor_bytes + int(headroom * self.weight / total_w)

    def _unfloored_in_use(self) -> int:
        """Bytes in flight that are NOT covered by a child floor: direct
        (unattributed) admissions plus each child's spill past its floor.
        Caller holds the shared lock."""
        child_total = sum(c._in_flight for c in self._children)
        direct = self._in_flight - child_total
        spill = sum(max(0, c._in_flight - c.floor_bytes) for c in self._children)
        return direct + spill

    def _fits_spill(self, spill: int) -> bool:
        """Does ``spill`` unfloored bytes fit under this budget (and up)?"""
        if self.max_bytes is not None:
            total_floors = sum(c.floor_bytes for c in self._children)
            headroom = self.max_bytes - total_floors
            if self._unfloored_in_use() + spill > headroom:
                # degenerate oversize rule: a request bigger than the whole
                # budget passes only when the budget is idle — and only
                # when no child floors exist: admitting it would occupy
                # floor-reserved bytes, and a floored tenant's within-floor
                # admissions (guaranteed by contract) would then bounce
                if not (self._in_flight == 0 and spill > headroom and total_floors == 0):
                    return False
        if self._parent is not None:
            # this budget's spill is unfloored use from the parent's view
            # only past THIS budget's floor
            new = self._in_flight + spill
            parent_spill = max(0, new - self.floor_bytes) - max(
                0, self._in_flight - self.floor_bytes
            )
            return self._parent._fits_spill(parent_spill)
        return True

    def _fits(self, nbytes: int) -> bool:
        cap = self._effective_cap()
        if cap is not None:
            if self._in_flight + nbytes > cap and not (
                self._in_flight == 0 and nbytes > cap
            ):
                return False
        if self._parent is not None:
            new = self._in_flight + nbytes
            spill = max(0, new - self.floor_bytes) - max(
                0, self._in_flight - self.floor_bytes
            )
            return self._parent._fits_spill(spill)
        if self._children:
            # root-level direct admissions (the untenanted default path)
            # compete for unfloored headroom only — they can never eat a
            # tenant's guaranteed floor
            return self._fits_spill(nbytes)
        return True

    def _charge(self, nbytes: int) -> None:
        """Record an admission here and in every ancestor (lock held)."""
        node = self
        while node is not None:
            node._in_flight += nbytes
            node._high_water = max(node._high_water, node._in_flight)
            node = node._parent
        self._admitted += 1

    def try_admit(self, nbytes: int) -> bool:
        with self._cond:
            if self._fits(nbytes):
                self._charge(nbytes)
                return True
            self._rejected += 1
            return False

    def admit(self, nbytes: int, timeout: float | None = None) -> bool:
        import time

        t0 = time.perf_counter()
        with self._cond:
            ok = self._cond.wait_for(lambda: self._fits(nbytes), timeout)
            self._blocked_seconds += time.perf_counter() - t0
            if not ok:
                # a timed-out blocking admit is backpressure, not load
                # shedding — callers polling in slices would otherwise
                # inflate `rejected` by orders of magnitude.  Only
                # try_admit (the shedding path) counts rejections.
                return False
            self._charge(nbytes)
            return True

    def release(self, nbytes: int) -> None:
        with self._cond:
            node = self
            while node is not None:
                node._in_flight -= nbytes
                if node._in_flight < 0:
                    raise RuntimeError("budget released more bytes than admitted")
                node = node._parent
            self._cond.notify_all()

    @property
    def in_flight_bytes(self) -> int:
        with self._cond:
            return self._in_flight

    def stats(self) -> BudgetStats:
        with self._cond:
            return BudgetStats(
                max_bytes=self.max_bytes if self.max_bytes is not None else 0,
                in_flight_bytes=self._in_flight,
                high_water_bytes=self._high_water,
                admitted=self._admitted,
                rejected=self._rejected,
                blocked_seconds=self._blocked_seconds,
                name=self.name,
                floor_bytes=self.floor_bytes,
                weight=self.weight,
            )
