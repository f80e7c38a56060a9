"""Corpus-level cache of materialized physical representations.

The planner picks the best (format, resolution) rendition per query, but
every repeat query over a hot corpus pays full entropy decode again — the
exact host-side bottleneck the paper measures.  "Physical
Representation-based Predicate Optimization" (PAPERS.md) shows that
materializing the representation the workload actually consumes is the
dominant win for repeated visual queries.  :class:`RenditionCache` is that
materialization layer for the serving runtime:

* **entries** are the host stage's products, not source bytes — staged
  coefficient tensors (``jpeg.stage_coefficients`` output, the split-decode
  staging layout) and planner-chosen transcoded pixel renditions (the
  post-host-chain staged tensor).  A hit skips entropy decode *and* the
  staging copy entirely.
* **capacity** is a :class:`~repro_torch.runtime.memory.MemoryBudget` — normally
  a ``child(...)`` of the serving admission hierarchy, so cache bytes
  respect tenant weights/floors and can never starve in-flight admission
  (a sibling tenant's floor is guaranteed against the cache by the budget
  itself).
* **admission is cost-aware**: every entry carries the measured host
  seconds a future hit saves (the planner's ``measure_entropy_decode_time``
  calibration for coefficient entries, the decode-time calibration for
  pixel renditions).  Under pressure the cache evicts the lowest
  seconds-saved-per-byte entries first — and refuses an admission whose
  utility is below every resident victim's.

Keys are ``(kind, corpus uid, format key, layout/chain signature)``.  The
staged coefficient tensor is **factor-invariant** (the full coefficient
set is always staged; only the device-side IDCT math scales), so one entry
serves every scaled-decode factor of the same (format, layout) — which is
exactly what lets a cascade's stage-1 refetch reuse the stage-0 entry
instead of re-decoding at full resolution.

Thread-safe; shared by all host workers.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Mapping

import numpy as np

from repro_torch.runtime.memory import MemoryBudget

# entry kinds
COEFF = "coeff"  # staged zigzag coefficient tensor (split-decode host stage)
PIXEL = "pixel"  # transcoded pixel rendition (post-host-chain staged tensor)

# The host stage functions the cache serves are closures with no tenant
# argument (the scheduler's staging signature predates tenancy); the host
# workers tag their thread instead, so cache traffic can be attributed per
# tenant without widening every host_fn signature.
_CURRENT_TENANT = threading.local()


def set_current_tenant(name: str | None) -> None:
    """Tag the calling host-worker thread's tenant for cache accounting."""
    _CURRENT_TENANT.name = name


def current_tenant() -> str | None:
    return getattr(_CURRENT_TENANT, "name", None)


def item_uid(item: Any) -> Any | None:
    """Corpus identity of one item, or None when the item is uncacheable.

    An explicit ``StoredImage.uid`` wins; otherwise object identity is
    used, tagged so ids recycled by the allocator can never alias (the
    cache registers a weakref finalizer invalidating identity-keyed
    entries when the object dies).  Only stored corpus items — things
    that can decode themselves — are cacheable: a raw pixel array has no
    decode to skip, and anything that cannot be weakref'd cannot be
    invalidated safely.
    """
    uid = getattr(item, "uid", None)
    if uid is not None:
        return ("uid", uid)
    if not (hasattr(item, "decode") or hasattr(item, "decode_to_coefficients")):
        return None
    try:
        weakref.ref(item)
    except TypeError:
        return None
    return ("id", id(item))


@dataclasses.dataclass(frozen=True)
class CacheTenantStats:
    """One tenant's share of cache traffic."""

    hits: int = 0
    misses: int = 0
    bytes_saved: int = 0


@dataclasses.dataclass(frozen=True)
class RenditionCacheStats:
    """Counters + occupancy snapshot of one :class:`RenditionCache`."""

    hits: int
    misses: int
    evictions: int
    admitted: int
    rejected: int
    resident_bytes: int
    resident_entries: int
    capacity_bytes: int
    bytes_saved: int  # decode bytes a hit did not re-materialize
    seconds_saved: float  # measured host seconds hits skipped
    tenants: Mapping[str, CacheTenantStats]


class _Entry:
    __slots__ = ("key", "array", "nbytes", "cost_seconds", "last_used")

    def __init__(self, key, array: np.ndarray, cost_seconds: float):
        self.key = key
        self.array = array
        self.nbytes = int(array.nbytes)
        self.cost_seconds = float(cost_seconds)
        self.last_used = time.monotonic()

    @property
    def utility(self) -> float:
        """Host seconds a future hit saves, per resident byte."""
        return self.cost_seconds / max(self.nbytes, 1)


class RenditionCache:
    """Byte-budgeted store of materialized renditions (module docstring).

    ``budget`` bounds resident bytes — every admission charges it (and,
    when it is a child, the whole serving hierarchy) and every eviction
    releases.  ``min_utility`` optionally floors admission at a
    seconds-saved-per-megabyte rate; 0.0 admits anything that fits.
    """

    def __init__(
        self,
        budget: MemoryBudget,
        telemetry: Any = None,
        min_utility: float = 0.0,
    ):
        self._budget = budget
        self._telemetry = telemetry
        self._min_utility = float(min_utility)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Any, _Entry]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._admitted = 0
        self._rejected = 0
        self._bytes_saved = 0
        self._seconds_saved = 0.0
        self._tenants: dict[str, list] = {}  # name -> [hits, misses, bytes_saved]
        # hit-rate per format key, feeding the planner's cache-aware term
        self._fmt_traffic: dict[str, list] = {}  # fmt.key -> [hits, misses]
        self._span_seq = 0

    # ------------------------------------------------------------------ keys
    @staticmethod
    def coeff_key(item: Any, fmt_key: str, layout: str) -> tuple | None:
        """Key of ``item``'s staged coefficient tensor.

        Deliberately factor-free: staging is factor-invariant, so the one
        entry serves every scaled-IDCT factor of (format, layout) — the
        subsample mode is part of the format key (e.g. ``_420``)."""
        uid = item_uid(item)
        if uid is None:
            return None
        return (COEFF, uid, fmt_key, layout)

    @staticmethod
    def pixel_key(item: Any, fmt_key: str, chain_sig: str) -> tuple | None:
        """Key of ``item``'s transcoded pixel rendition after one host
        chain (``chain_sig`` is the reprs of the host-placed ops)."""
        uid = item_uid(item)
        if uid is None:
            return None
        return (PIXEL, uid, fmt_key, chain_sig)

    # ---------------------------------------------------------------- lookup
    def get(self, key: tuple, tenant: str | None = None) -> np.ndarray | None:
        """Resident rendition for ``key``, or None (counted as a miss)."""
        t0 = time.perf_counter()
        if tenant is None:
            tenant = current_tenant()
        with self._lock:
            entry = self._entries.get(key)
            fmt_key = key[2]
            traffic = self._fmt_traffic.setdefault(fmt_key, [0, 0])
            tstats = self._tenants.setdefault(tenant, [0, 0, 0]) if tenant else None
            if entry is None:
                self._misses += 1
                traffic[1] += 1
                if tstats is not None:
                    tstats[1] += 1
                return None
            self._hits += 1
            traffic[0] += 1
            entry.last_used = time.monotonic()
            self._entries.move_to_end(key)
            self._bytes_saved += entry.nbytes
            self._seconds_saved += entry.cost_seconds
            if tstats is not None:
                tstats[0] += 1
                tstats[2] += entry.nbytes
            arr = entry.array
        self._emit_span("hit", key, t0, tenant)
        return arr

    # ----------------------------------------------------------------- admit
    def put(
        self,
        key: tuple,
        array: np.ndarray,
        cost_seconds: float,
        tenant: str | None = None,
        item: Any = None,
    ) -> bool:
        """Admit one freshly-materialized rendition under the cost-aware
        policy.  Returns False when it does not pay its way (utility below
        the floor or below every resident victim's) or cannot fit.

        ``item`` (when identity-keyed) gets a weakref finalizer so a
        garbage-collected source can never leave a stale entry behind.
        """
        t0 = time.perf_counter()
        if tenant is None:
            tenant = current_tenant()
        array = np.ascontiguousarray(array)
        nbytes = int(array.nbytes)
        utility = float(cost_seconds) / max(nbytes, 1)
        if self._min_utility and utility * (1 << 20) < self._min_utility:
            with self._lock:
                self._rejected += 1
            return False
        with self._lock:
            if key in self._entries:
                return True  # racing workers staged the same item
            if not self._admit_bytes_locked(nbytes, utility):
                self._rejected += 1
                return False
            array.setflags(write=False)  # hits hand out the one shared copy
            self._entries[key] = _Entry(key, array, cost_seconds)
            self._admitted += 1
        if item is not None and key[1][0] == "id":
            # identity-keyed source: drop its entries when the object dies
            weakref.finalize(item, self._invalidate_uid, key[1])
        self._emit_span("admit", key, t0, tenant, nbytes=nbytes)
        return True

    def _admit_bytes_locked(self, nbytes: int, utility: float) -> bool:
        """Charge ``nbytes`` to the budget, evicting lower-utility entries
        as needed.  Lock held; returns False when the bytes cannot (or
        should not) be made to fit."""
        cap = self._budget.max_bytes
        if cap is not None and nbytes > cap:
            return False  # bigger than the whole cache: never evict for it
        if self._budget.try_admit(nbytes):
            return True
        # evict lowest-utility first (ties: least recently used), but only
        # victims the newcomer genuinely beats — churning equal-value
        # residents would thrash the cache under a steady repeat workload
        victims = sorted(
            self._entries.values(), key=lambda e: (e.utility, e.last_used)
        )
        for v in victims:
            if v.utility > utility:
                return False  # the newcomer does not beat what remains
            del self._entries[v.key]
            self._budget.release(v.nbytes)
            self._evictions += 1
            if self._budget.try_admit(nbytes):
                return True
        # every eligible victim is gone and the bytes still do not fit —
        # the serving hierarchy is under pressure; shrinking was correct,
        # admitting is not
        return False

    def _invalidate_uid(self, uid: tuple) -> None:
        with self._lock:
            stale = [k for k in self._entries if k[1] == uid]
            for k in stale:
                entry = self._entries.pop(k)
                self._budget.release(entry.nbytes)
                self._evictions += 1

    # ------------------------------------------------------------ management
    def clear(self) -> None:
        with self._lock:
            total = sum(e.nbytes for e in self._entries.values())
            self._evictions += len(self._entries)
            self._entries.clear()
            if total:
                self._budget.release(total)

    def hit_rate(self, fmt_key: str) -> float:
        """Measured hit fraction of lookups for one format (0.0 cold) —
        the planner's cache-aware discount term."""
        with self._lock:
            traffic = self._fmt_traffic.get(fmt_key)
            if not traffic or (traffic[0] + traffic[1]) == 0:
                return 0.0
            return traffic[0] / (traffic[0] + traffic[1])

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def stats(self) -> RenditionCacheStats:
        with self._lock:
            budget = self._budget.stats()
            return RenditionCacheStats(
                hits=self._hits,
                misses=self._misses,
                evictions=self._evictions,
                admitted=self._admitted,
                rejected=self._rejected,
                resident_bytes=sum(e.nbytes for e in self._entries.values()),
                resident_entries=len(self._entries),
                capacity_bytes=budget.max_bytes,
                bytes_saved=self._bytes_saved,
                seconds_saved=self._seconds_saved,
                tenants={
                    name: CacheTenantStats(hits=t[0], misses=t[1], bytes_saved=t[2])
                    for name, t in self._tenants.items()
                },
            )

    # ------------------------------------------------------------- telemetry
    def _emit_span(
        self, event: str, key: tuple, t0: float, tenant: str | None, **args
    ) -> None:
        tel = self._telemetry
        if tel is None or not getattr(tel.config, "spans", False):
            return
        with self._lock:
            self._span_seq += 1
            seq = self._span_seq
        tel.emit_span(
            "cache",
            f"{event}[{key[0]}:{key[2]}]",
            tenant,
            seq,
            t0,
            time.perf_counter(),
            **args,
        )
