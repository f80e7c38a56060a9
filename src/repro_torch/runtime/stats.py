"""Versioned, typed runtime statistics.

:meth:`SmolRuntime.stats` used to return an ad-hoc nested dict whose shape
drifted every PR; consumers (benchmarks, the serving engine, dashboards)
had no schema to program against.  :class:`RuntimeStats` is that schema:
one frozen dataclass per section, a ``schema_version`` that bumps on any
breaking shape change, and ``to_dict()`` producing a JSON-safe mapping for
wire/file use (``json.dumps(stats.to_dict())`` always works).

Dict-style access (``stats["scheduler"]``) still resolves — against the
typed attributes, with a ``DeprecationWarning`` — so pre-schema consumers
migrate gradually.
"""

from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Any, Mapping

from repro_torch.core.device_compiler import ProgramCacheStats
from repro_torch.distributed.fault_tolerance import ElasticPlan
from repro_torch.runtime.scheduler import ReplicaSnapshot, SchedulerStats, TenantStats
from repro_torch.runtime.telemetry import HistogramSummary

# v2: added the ``latency`` section (per-stage / per-tenant streaming
# histogram summaries from runtime.telemetry).
# v3: added the ``cascade`` section (per-stage exit counters + measured
# pass fractions of the cascade serving mode, progressive refetch).
# v4: added the ``cache`` section (rendition-cache hit/miss/eviction
# counters, resident bytes, bytes/seconds saved, per-tenant breakdown).
# v5: added the ``warmup`` section (the serving plan's program set: ready
# buckets, captured CUDA graphs and their replays, warm failures).
SCHEMA_VERSION = 5


@dataclasses.dataclass(frozen=True)
class WarmupSection:
    """Program-set warmup of the plan currently serving (present when
    ``RuntimeConfig.warmup`` is not off).

    ``failures`` counts every background warm that failed since the
    runtime was built (``errors`` holds each one's bucket and exception);
    a failed bucket stays unready and dispatch falls forward to a larger
    warm bucket, so a non-zero count is a fault to look at, never a silent
    fallback.  ``graphs`` maps each captured bucket to its capture seconds,
    ``replays`` to the replays its graph ran (CUDA only; empty on the CPU).
    """

    mode: str
    buckets: tuple[int, ...]
    ready: tuple[int, ...]
    fully_warm: bool
    failures: int
    errors: tuple[str, ...]
    graphs: Mapping[int, float] = dataclasses.field(default_factory=dict)
    replays: Mapping[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class DeviceProgramSection:
    """The compiled device-preprocessing program currently serving."""

    backend: str
    impl: str
    fused: bool
    stages: tuple[str, ...]
    dispatch_count: int
    dispatches_per_batch: int


@dataclasses.dataclass(frozen=True)
class SplitDecodeSection:
    """Split-decode policy outcome (present when the policy is not off)."""

    policy: str
    factor: int  # 0 = the plan fell back to the pixel path
    point: int
    layout: str | None
    staging_bytes: int


@dataclasses.dataclass(frozen=True)
class TenantSection:
    """One tenant's serving counters + the plan it is bound to."""

    stats: TenantStats
    budget: Any | None  # BudgetStats when a byte budget is configured
    plan: str | None = None
    split: int | None = None


@dataclasses.dataclass(frozen=True)
class SchedulerSection:
    stats: SchedulerStats
    budget: Any | None  # serving-side BudgetStats


@dataclasses.dataclass(frozen=True)
class EngineSection:
    """Batch-path memory occupancy (pool/budget snapshots)."""

    pool: Any | None
    budget: Any | None


@dataclasses.dataclass(frozen=True)
class MeshSection:
    """The replica mesh: per-replica dispatch counters and, after a
    failure, the elastic plan sizing what survived."""

    replicas: tuple[ReplicaSnapshot, ...]
    alive: int
    sharded: bool
    elastic_plan: ElasticPlan | None = None


@dataclasses.dataclass(frozen=True)
class LatencySection:
    """Streaming-histogram latency digests (schema v2).

    ``stages`` maps stage name (queue/decode/stage/dispatch/drain/e2e) to
    the runtime-wide distribution summary; ``tenants`` nests the same per
    tenant.  Summaries come from log-bucketed streaming histograms, so
    quantiles are bucket-geometry estimates, not exact order statistics.
    """

    stages: Mapping[str, HistogramSummary]
    tenants: Mapping[str, Mapping[str, HistogramSummary]]


@dataclasses.dataclass(frozen=True)
class CascadeStageStats:
    """One cascade stage's serving counters."""

    stage: int
    items: int  # items that entered this stage
    exits: int  # items whose prediction exited here
    pass_fraction: float  # measured fraction of all items reaching this stage


@dataclasses.dataclass(frozen=True)
class CascadeSection:
    """Cascade serving-mode counters (schema v3, progressive refetch).

    ``stages`` carries per-stage exit counts and the measured pass
    fractions (stage 0's is 1.0 by construction); ``refetched_items`` is
    the number of pass-throughs internally resubmitted to the expensive
    stage; ``factor`` / ``threshold`` are the cheap stage's current
    scaled-decode factor and confidence threshold.
    """

    stages: tuple[CascadeStageStats, ...]
    refetched_items: int
    factor: int
    threshold: float


@dataclasses.dataclass(frozen=True)
class CacheTenantSection:
    """One tenant's share of rendition-cache traffic."""

    hits: int
    misses: int
    bytes_saved: int


@dataclasses.dataclass(frozen=True)
class CacheSection:
    """Rendition-cache counters (schema v4, runtime/rendition_cache.py).

    ``resident_bytes``/``resident_entries`` snapshot occupancy against
    ``capacity_bytes`` (the cache's MemoryBudget cap — a child of the
    serving hierarchy when one is configured); ``bytes_saved`` /
    ``seconds_saved`` accumulate the decode work hits skipped, per the
    entries' measured admission cost.
    """

    hits: int
    misses: int
    evictions: int
    admitted: int
    rejected: int
    resident_bytes: int
    resident_entries: int
    capacity_bytes: int
    bytes_saved: int
    seconds_saved: float
    tenants: Mapping[str, CacheTenantSection] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class RuntimeStats:
    """Versioned snapshot of the whole runtime (see module docstring)."""

    schema_version: int = SCHEMA_VERSION
    num_workers: int = 0
    measured_dispatch_overhead_s: float | None = None
    program_cache: ProgramCacheStats | None = None
    engine: EngineSection | None = None
    scheduler: SchedulerSection | None = None
    tenants: Mapping[str, TenantSection] = dataclasses.field(default_factory=dict)
    mesh: MeshSection | None = None
    device_program: DeviceProgramSection | None = None
    split_decode: SplitDecodeSection | None = None
    latency: LatencySection | None = None
    cascade: CascadeSection | None = None  # cascade serving mode (schema v3)
    cache: CacheSection | None = None  # rendition cache (schema v4)
    warmup: WarmupSection | None = None  # program-set warmup (schema v5)
    # cold-compile observability (additive, still schema v2): request-path
    # compiles after warmup finished, and cumulative compile wall time
    programs_compiled_post_warmup: int = 0
    program_compile_seconds_total: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        """JSON-safe mapping (stable wire format for the schema version)."""
        return _jsonify(self)

    # transitional dict-style access for pre-schema consumers
    def __getitem__(self, key: str) -> Any:
        if not any(f.name == key for f in dataclasses.fields(self)):
            raise KeyError(key)
        warnings.warn(
            "dict-style access to SmolRuntime.stats() is deprecated; "
            f"read the RuntimeStats attribute (stats.{key}) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        return getattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default


def _jsonify(x: Any) -> Any:
    """Recursively convert dataclasses/containers to JSON-safe values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _jsonify(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, Mapping):
        return {str(k): _jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [_jsonify(v) for v in x]
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if hasattr(x, "item"):  # numpy scalar
        return x.item()
    return str(x)  # dtypes, exceptions, ... — degrade to a label
