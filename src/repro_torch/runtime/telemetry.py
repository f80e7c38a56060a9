"""End-to-end request tracing + streaming latency histograms.

The paper's measurement study (§7) exists because aggregate counters hide
where time goes; "Beyond Inference" (PAPERS.md) shows the same blind spot
at serving time — queueing, batching, and staging overheads dominate
end-to-end latency yet are invisible to busy-seconds totals.  This module
is the runtime's answer: one :class:`Telemetry` object threaded through
ingress → host decode → staging → batch formation → device dispatch →
drain, recording

* **streaming histograms** (always on, HDR-style): per-stage and
  per-(tenant, stage) latency distributions over log-spaced buckets —
  p50/p95/p99 without retaining samples, at one ``math.log`` + one array
  increment per observation.  ``summary()`` digests them into the
  ``stats().latency`` section; :meth:`metrics_text` renders Prometheus
  text exposition for scrape-based dashboards.
* **stage-occupancy accumulators** (always on): the windowed
  host/device busy-seconds the online recalibrators consume
  (:meth:`measurement_window`) — the scheduler's previous ad-hoc
  ``time.perf_counter()`` snapshot bookkeeping now lives here, fed by the
  same observations the histograms see.
* **span capture** (opt-in via :class:`TelemetryConfig`): full per-request
  span timelines — queue/decode/stage/dispatch/drain tile the request's
  wall latency exactly, batch spans link their member requests and carry
  replica id + cold-start compile visibility — recorded into *per-thread
  ring buffers* (no locks, no allocation on the hot path beyond the ring
  itself, created lazily per thread).  :meth:`dump_trace` writes Chrome
  trace-event JSON loadable in Perfetto, with tenants and the replica mesh
  as track groups.

The request stages tile the timeline contiguously (each span's end is the
next span's start), so ``queue + decode + stage + dispatch`` equals the
request's measured wall latency to the clock's resolution — the invariant
the acceptance test holds to within 10%.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from typing import Any, Iterable, Mapping

import numpy as np

#: the shared telemetry clock — every stage timestamp in the runtime comes
#: from this one monotonic source, so spans from different threads compose
clock = time.perf_counter

# The request timeline, in pipeline order.  Each stage's span starts where
# the previous one ended:
#   queue    submit()            -> WFQ host-worker pickup
#   decode   pickup              -> host stage done (entropy decode +
#                                   host-placed preprocessing, or the
#                                   split-decode coefficient staging)
#   stage    host done           -> copied into the batch staging buffer
#   dispatch staged              -> device batch complete (includes the
#                                   batch-formation wait for co-members)
#   drain    batch complete      -> released by drain() in uid order
REQUEST_STAGES = ("queue", "decode", "stage", "dispatch", "drain")
E2E_STAGE = "e2e"  # submit -> batch complete (what SLO gates bind on)

# ------------------------------------------------------------- histograms
# Log-spaced bucket geometry, shared by every histogram so they merge by
# plain vector addition: 2^(1/8) growth from 1 µs covers 1 µs .. ~4700 s in
# 256 buckets with <= ~4.5% quantile error at the bucket's geometric mid.
_LO = 1e-6
_NBUCKETS = 256
_LN_GROWTH = math.log(2.0) / 8.0
_GROWTH = math.exp(_LN_GROWTH)
#: inclusive upper bound of bucket i (seconds)
BUCKET_BOUNDS = _LO * _GROWTH ** np.arange(1, _NBUCKETS + 1)


def bucket_index(seconds: float) -> int:
    """Histogram bucket for a latency observation (shared geometry)."""
    if seconds <= _LO:
        return 0
    idx = int(math.log(seconds / _LO) / _LN_GROWTH)
    return idx if idx < _NBUCKETS else _NBUCKETS - 1


@dataclasses.dataclass(frozen=True)
class HistogramSummary:
    """One histogram's digest: the shape of a latency distribution without
    the samples (what ``stats().latency`` and dashboards carry)."""

    count: int
    mean: float
    p50: float
    p95: float
    p99: float
    max: float


_EMPTY_SUMMARY = HistogramSummary(0, 0.0, 0.0, 0.0, 0.0, 0.0)


class StreamingHistogram:
    """Log-bucketed streaming latency histogram (HDR-style).

    ``record`` is one log, one clamp, one array increment — no locks, no
    allocation, no sample retention.  Concurrent records may very rarely
    lose a count to a racing increment (CPython ``+=`` on an array element
    is not atomic); quantiles are estimates over bucket geometry anyway, so
    the accounting stays honest.  Quantiles interpolate at the bucket's
    geometric midpoint and are clamped to the observed min/max, so
    single-value distributions report exactly.
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        # a plain list: scalar increments are ~3x cheaper than on a numpy
        # array, and this is the per-observation hot path
        self.counts = [0] * _NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def record(self, seconds: float) -> None:
        self.record_at(bucket_index(seconds), seconds)

    def record_at(self, idx: int, seconds: float) -> None:
        """Record with a precomputed bucket index (one ``math.log`` shared
        across the global + per-tenant histograms of one observation)."""
        if seconds < 0.0:
            seconds = 0.0
        self.counts[idx] += 1
        self.count += 1
        self.sum += seconds
        if seconds < self.min:
            self.min = seconds
        if seconds > self.max:
            self.max = seconds

    def quantile(self, q: float) -> float:
        """Estimated value at quantile ``q`` in [0, 1]."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            cum += int(c)
            if cum > rank:
                mid = _LO * _GROWTH ** (i + 0.5)
                return min(max(mid, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def merge(self, other: "StreamingHistogram") -> None:
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def summary(self) -> HistogramSummary:
        if self.count == 0:
            return _EMPTY_SUMMARY
        return HistogramSummary(
            count=self.count,
            mean=self.mean,
            p50=self.quantile(0.50),
            p95=self.quantile(0.95),
            p99=self.quantile(0.99),
            max=self.max,
        )


# ------------------------------------------------------------------ config
@dataclasses.dataclass
class TelemetryConfig:
    """Telemetry policy knobs (``RuntimeConfig.telemetry``).

    ``histograms``: the always-on default — per-stage/per-tenant streaming
    latency histograms (and the Prometheus/``stats().latency`` surfaces
    they feed).  Off disables distribution recording entirely; the
    stage-occupancy accumulators recalibration consumes stay live either
    way (they replaced bookkeeping the scheduler already paid for).

    ``spans``: opt-in full span capture into per-thread ring buffers —
    the :meth:`Telemetry.dump_trace` Perfetto surface.  Off means zero
    ring-buffer allocations (the overhead guard CI asserts).

    ``sample_rate``: fraction of requests whose spans are captured when
    ``spans`` is on (1.0 = every request; 0.01 = one in a hundred —
    deterministic by uid, so a sampled request keeps its *whole* timeline).

    ``ring_capacity``: span slots per ring (per recording thread); the ring
    overwrites its oldest spans rather than growing or blocking.
    """

    histograms: bool = True
    spans: bool = False
    sample_rate: float = 1.0
    ring_capacity: int = 4096

    def __post_init__(self):
        if not 0.0 < self.sample_rate <= 1.0:
            raise ValueError(
                f"telemetry sample_rate must be in (0, 1], got {self.sample_rate}"
            )
        if self.ring_capacity < 16:
            raise ValueError(
                f"telemetry ring_capacity must be >= 16, got {self.ring_capacity}"
            )


# -------------------------------------------------------------------- spans
@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded span (a ring-buffer entry, decoded)."""

    kind: str  # "request" | "batch" | "compile" | "cache"
    name: str  # stage name, or "batch"
    tenant: str | None
    uid: int  # request uid, or batch sequence number
    t0: float
    t1: float
    args: Mapping[str, Any]


class _SpanRing:
    """Fixed-capacity overwrite ring owned by exactly one thread.

    The owning thread appends without any lock; ``snapshot`` (called from
    the export path) reads racily — at worst it sees a half-epoch mix of
    old and new spans, never a torn record (slot writes are single
    reference stores).
    """

    __slots__ = ("buf", "idx")

    def __init__(self, capacity: int):
        self.buf: list[Span | None] = [None] * capacity
        self.idx = 0

    def append(self, span: Span) -> None:
        self.buf[self.idx % len(self.buf)] = span
        self.idx += 1

    @property
    def dropped(self) -> int:
        return max(0, self.idx - len(self.buf))

    def snapshot(self) -> list[Span]:
        return [s for s in self.buf if s is not None]


class ReqTimes:
    """Per-request stage timestamps, written in pipeline order.

    One of these rides with the request through the scheduler; the stage
    durations (and the span timeline) fall out as adjacent differences, so
    the per-stage breakdown tiles the wall latency exactly.
    """

    __slots__ = ("submit", "pick", "decoded", "staged", "done", "worker")

    def __init__(self, submit: float):
        self.submit = submit
        self.pick = 0.0
        self.decoded = 0.0
        self.staged = 0.0
        self.done = 0.0
        self.worker = -1


# -------------------------------------------------------------- telemetry
class Telemetry:
    """The runtime's tracing + metrics hub (one per SmolRuntime).

    Hot-path discipline: histogram records touch only that histogram's own
    array; span appends touch only the calling thread's ring.  The single
    lock guards *registry* mutations (first sight of a tenant/stage pair,
    ring registration) and the occupancy accumulators — never per-span or
    per-record on an already-seen key.
    """

    clock = staticmethod(clock)

    def __init__(self, config: TelemetryConfig | None = None):
        self.config = config or TelemetryConfig()
        self._lock = threading.Lock()
        # (tenant | None, stage) -> histogram; tenant None = runtime-wide
        self._hists: dict[tuple[str | None, str], StreamingHistogram] = {}
        # tenant -> [host_busy_s, host_items, device_busy_s, device_items]
        self._occupancy: dict[str, list] = {}
        # consumer-key -> last-seen occupancy totals (recalibration windows)
        self._windows: dict[Any, tuple] = {}
        self._local = threading.local()
        self._rings: list[_SpanRing] = []
        #: rings created so far — the telemetry-off overhead guard asserts 0
        self.ring_allocations = 0
        self._batch_seq = 0

    # ----------------------------------------------------------- histograms
    def _hist(self, tenant: str | None, stage: str) -> StreamingHistogram:
        key = (tenant, stage)
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(key, StreamingHistogram())
        return h

    def record(self, stage: str, seconds: float, tenant: str | None = None) -> None:
        """One latency observation: the runtime-wide stage histogram, plus
        the per-tenant one when ``tenant`` is given."""
        if not self.config.histograms:
            return
        idx = bucket_index(seconds)
        self._hist(None, stage).record_at(idx, seconds)
        if tenant is not None:
            self._hist(tenant, stage).record_at(idx, seconds)

    # ----------------------------------------------------- occupancy windows
    def _occ(self, tenant: str) -> list:
        occ = self._occupancy.get(tenant)
        if occ is None:
            with self._lock:
                occ = self._occupancy.setdefault(tenant, [0.0, 0, 0.0, 0])
        return occ

    def observe_host(self, tenant: str, seconds: float) -> None:
        """One item through the host stage: decode histogram + the host
        occupancy accumulator the recalibrators window over."""
        occ = self._occ(tenant)
        with self._lock:
            occ[0] += seconds
            occ[1] += 1
        self.record("decode", seconds, tenant)

    def observe_device_batch(self, seconds: float, per_tenant: Mapping[str, int]) -> None:
        """One device batch: occupancy attributed to tenants in proportion
        to the slots they filled (the recalibration device signal)."""
        total = sum(per_tenant.values())
        if total == 0:
            return
        with self._lock:
            for tenant, n in per_tenant.items():
                occ = self._occupancy.setdefault(tenant, [0.0, 0, 0.0, 0])
                occ[2] += seconds * n / total
                occ[3] += n

    def occupancy_totals(self, tenant: str | None = None) -> tuple[float, int, float, int]:
        """(host_busy_s, host_items, device_busy_s, device_items) — for one
        tenant, or summed runtime-wide."""
        with self._lock:
            if tenant is not None:
                occ = self._occupancy.get(tenant, (0.0, 0, 0.0, 0))
                return (occ[0], occ[1], occ[2], occ[3])
            totals = [0.0, 0, 0.0, 0]
            for occ in self._occupancy.values():
                for i in range(4):
                    totals[i] += occ[i]
            return tuple(totals)

    def measurement_window(
        self, consumer: Any, tenant: str | None = None
    ) -> tuple[float, int, float, int]:
        """Occupancy deltas since ``consumer``'s previous call (windowed —
        the recalibration feed; each consumer key gets its own window)."""
        cur = self.occupancy_totals(tenant)
        key = (consumer, tenant)
        with self._lock:
            prev = self._windows.get(key, (0.0, 0, 0.0, 0))
            self._windows[key] = cur
        return tuple(c - p for c, p in zip(cur, prev))

    # ---------------------------------------------------------------- spans
    def sampled(self, uid: int) -> bool:
        """Span-capture decision for one request, deterministic by uid so a
        sampled request records its whole timeline."""
        if not self.config.spans:
            return False
        rate = self.config.sample_rate
        return rate >= 1.0 or uid % max(1, round(1.0 / rate)) == 0

    def _ring(self) -> _SpanRing:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _SpanRing(self.config.ring_capacity)
            self._local.ring = ring
            with self._lock:
                self._rings.append(ring)
                self.ring_allocations += 1
        return ring

    def emit_span(
        self,
        kind: str,
        name: str,
        tenant: str | None,
        uid: int,
        t0: float,
        t1: float,
        **args: Any,
    ) -> None:
        self._ring().append(Span(kind, name, tenant, uid, t0, t1, args))

    def next_batch_id(self) -> int:
        with self._lock:
            self._batch_seq += 1
            return self._batch_seq

    # ------------------------------------------------- request-level helpers
    def complete_request(
        self, tenant: str, uid: int, tm: ReqTimes, replica: int | None = None
    ) -> None:
        """Record a completed request's whole stage timeline: the four
        pipeline histograms + e2e, and (when sampled) one span per stage."""
        if self.config.histograms:
            self.record("queue", tm.pick - tm.submit, tenant)
            # decode already recorded live by observe_host
            self.record("stage", tm.staged - tm.decoded, tenant)
            self.record("dispatch", tm.done - tm.staged, tenant)
            self.record(E2E_STAGE, tm.done - tm.submit, tenant)
        if self.sampled(uid):
            self.emit_span("request", "queue", tenant, uid, tm.submit, tm.pick)
            self.emit_span(
                "request", "decode", tenant, uid, tm.pick, tm.decoded, worker=tm.worker
            )
            self.emit_span("request", "stage", tenant, uid, tm.decoded, tm.staged)
            self.emit_span(
                "request", "dispatch", tenant, uid, tm.staged, tm.done, replica=replica
            )

    def observe_drain(self, tenant: str, uid: int, t_done: float, t_released: float) -> None:
        """The reorder-buffer wait: batch completion -> drain() release."""
        self.record("drain", t_released - t_done, tenant)
        if self.sampled(uid):
            self.emit_span("request", "drain", tenant, uid, t_done, t_released)

    # ---------------------------------------------------------------- export
    def spans(self) -> list[Span]:
        """Every captured span across all ring buffers, start-time order."""
        with self._lock:
            rings = list(self._rings)
        out: list[Span] = []
        for ring in rings:
            out.extend(ring.snapshot())
        out.sort(key=lambda s: s.t0)
        return out

    def summary(self) -> dict[str, Any]:
        """Digest every histogram: ``{"stages": {stage: HistogramSummary},
        "tenants": {tenant: {stage: HistogramSummary}}}`` (the
        ``stats().latency`` feed)."""
        with self._lock:
            items = list(self._hists.items())
        stages: dict[str, HistogramSummary] = {}
        tenants: dict[str, dict[str, HistogramSummary]] = {}
        for (tenant, stage), hist in items:
            if tenant is None:
                stages[stage] = hist.summary()
            else:
                tenants.setdefault(tenant, {})[stage] = hist.summary()
        return {"stages": stages, "tenants": tenants}

    def dump_trace(self, path: str) -> int:
        """Write captured spans as Chrome trace-event JSON (Perfetto/
        ``chrome://tracing`` loadable).  Returns the span count written.

        Track layout: each tenant is a process ("tenant:<name>") whose
        requests render one track per uid (the five stage spans tile it);
        the replica mesh is one process whose batch spans sit on one track
        per replica, each batch's args linking its member request uids.
        """
        spans = self.spans()
        events: list[dict[str, Any]] = []
        pids: dict[str, int] = {}

        def pid_of(label: str) -> int:
            if label not in pids:
                pids[label] = len(pids) + 1
                events.append(
                    {
                        "name": "process_name",
                        "ph": "M",
                        "pid": pids[label],
                        "tid": 0,
                        "args": {"name": label},
                    }
                )
            return pids[label]

        named_tids: set[tuple[int, int]] = set()
        for s in spans:
            if s.kind == "batch":
                pid = pid_of("replica mesh")
                tid = int(s.args.get("replica", 0))
                thread_label = f"replica{tid}"
            elif s.kind == "compile":
                # program build/capture events get their own process so the
                # cold-start cost is visually separable from serving tracks
                pid = pid_of("compiler")
                tid = 0
                thread_label = "compile"
            elif s.kind == "cache":
                # rendition-cache hits/admits/evictions: one process, one
                # track per tenant ("" = untenanted), so cache traffic is
                # readable next to the request tracks it shortens
                pid = pid_of("rendition cache")
                tid = abs(hash(s.tenant or "")) % 1024
                thread_label = f"tenant:{s.tenant or 'default'}"
            else:
                pid = pid_of(f"tenant:{s.tenant}")
                tid = s.uid
                thread_label = f"request {s.uid}"
            if (pid, tid) not in named_tids:
                named_tids.add((pid, tid))
                events.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": tid,
                        "args": {"name": thread_label},
                    }
                )
            args = {k: v for k, v in s.args.items()}
            if s.kind == "request":
                args["uid"] = s.uid
            events.append(
                {
                    "name": s.name,
                    "cat": s.kind,
                    "ph": "X",
                    "ts": s.t0 * 1e6,
                    "dur": max(0.0, (s.t1 - s.t0) * 1e6),
                    "pid": pid,
                    "tid": tid,
                    "args": args,
                }
            )
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return len(spans)

    def metrics_text(self, extra_lines: Iterable[str] = ()) -> str:
        """Prometheus text exposition of every latency histogram.

        One histogram family, ``smol_stage_latency_seconds``, labelled by
        ``stage`` and ``tenant`` ("" = runtime-wide): cumulative
        ``_bucket{le=...}`` series over the log-spaced bounds (empty
        buckets elided — absent series are legal), plus ``_sum`` /
        ``_count``.  ``extra_lines`` lets the caller append counter
        families (the facade adds scheduler/tenant counters).
        """
        lines = [
            "# HELP smol_stage_latency_seconds Per-stage request latency.",
            "# TYPE smol_stage_latency_seconds histogram",
        ]
        with self._lock:
            items = sorted(
                self._hists.items(), key=lambda kv: (kv[0][1], kv[0][0] or "")
            )
        for (tenant, stage), hist in items:
            label = f'stage="{stage}",tenant="{tenant or ""}"'
            cum = 0
            counts = hist.counts
            for i in np.flatnonzero(counts):
                cum += int(counts[i])
                lines.append(
                    "smol_stage_latency_seconds_bucket"
                    f'{{{label},le="{BUCKET_BOUNDS[i]:.6g}"}} {cum}'
                )
            lines.append(
                f'smol_stage_latency_seconds_bucket{{{label},le="+Inf"}} {hist.count}'
            )
            lines.append(f"smol_stage_latency_seconds_sum{{{label}}} {hist.sum:.9g}")
            lines.append(f"smol_stage_latency_seconds_count{{{label}}} {hist.count}")
        lines.extend(extra_lines)
        return "\n".join(lines) + "\n"
