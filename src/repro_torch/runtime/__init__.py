"""End-to-end SMOL query runtime on torch: plan → place → pipeline → serve.

:class:`SmolRuntime` is the facade every deployment path goes through —
the batch API (``run(corpus)``), the request-level serving API
(``start_serving()``/``submit()``/``drain()``), and the online
recalibration loop that re-solves the host/device placement split (and the
producer-pool size) from measured stage occupancy.  The memory subsystem
(:mod:`.memory`) owns pooled (pinned on CUDA) staging buffers, a frame
arena and a hierarchical in-flight-bytes admission budget, and
:mod:`.workers` owns host-stage threading (work stealing + bounded
backpressure).

Serving is **multi-tenant**: declare :class:`TenantConfig`\\ s on
:class:`RuntimeConfig` and ``submit(query, tenant=...)`` — the scheduler
serves tenants by weighted fair queuing, admission quotas and byte
budgets are per tenant, tenants may pin their own model (own compiled
program, own recalibrated host/device split), and the compiled-program
cache LRU-evicts beyond its bound.  With ``RuntimeConfig.warmup="full"``
every batch bucket's program is warmed at startup — on a CUDA device
captured as one CUDA graph and replayed by every later dispatch.
:meth:`SmolRuntime.stats` returns the versioned :class:`RuntimeStats`
schema.  :class:`MeshConfig` serves from replica groups of logical devices
(``repro_torch.device.mesh_devices``; on a card each has its own stream),
optionally sharded, with ``fail_replica`` draining a replica's work onto
the survivors.
"""

from repro_torch.core.placement import SplitDecodeOption
from repro_torch.distributed.fault_tolerance import ElasticPlan, FaultInjector, ReplicaFailure
from repro_torch.runtime.facade import (
    CompiledPlan,
    DeviceCompilerConfig,
    MeshConfig,
    RecalConfig,
    RunReport,
    RuntimeConfig,
    SmolRuntime,
)
from repro_torch.runtime.query import (
    AggregationQuery,
    AggregationQueryResult,
    CascadeQuery,
    CascadeQueryResult,
    CascadeStageSpec,
    ClassificationQuery,
    ClassificationResult,
    Query,
    QueryResult,
)
from repro_torch.runtime.memory import (
    ArenaStats,
    BudgetStats,
    BufferLease,
    BufferPool,
    FrameArena,
    MemoryBudget,
    MemoryConfig,
    PoolStats,
    TransferLease,
    TransferPool,
    TransferPoolStats,
)
from repro_torch.runtime.recalibration import (
    CascadeRecalibrationEvent,
    CascadeRecalibrator,
    RecalibrationEvent,
    Recalibrator,
    StageMeasurement,
    WorkerRecalibrationEvent,
    WorkerRecalibrator,
)
from repro_torch.runtime.scheduler import (
    DEFAULT_TENANT,
    CompletedRequest,
    ReplicaSnapshot,
    RequestRoute,
    RequestScheduler,
    SchedulerSaturated,
    SchedulerStats,
    TenantConfig,
    TenantStats,
)
from repro_torch.runtime.stats import (
    CascadeSection,
    CascadeStageStats,
    DeviceProgramSection,
    EngineSection,
    LatencySection,
    MeshSection,
    RuntimeStats,
    SchedulerSection,
    SplitDecodeSection,
    TenantSection,
    WarmupSection,
)
from repro_torch.runtime.telemetry import (
    HistogramSummary,
    StreamingHistogram,
    Telemetry,
    TelemetryConfig,
)
from repro_torch.runtime.workers import HostStream, WorkerPool

__all__ = [
    "AggregationQuery",
    "AggregationQueryResult",
    "ArenaStats",
    "BudgetStats",
    "BufferLease",
    "BufferPool",
    "CascadeQuery",
    "CascadeQueryResult",
    "CascadeRecalibrationEvent",
    "CascadeRecalibrator",
    "CascadeSection",
    "CascadeStageSpec",
    "CascadeStageStats",
    "ClassificationQuery",
    "ClassificationResult",
    "CompiledPlan",
    "CompletedRequest",
    "DEFAULT_TENANT",
    "DeviceCompilerConfig",
    "DeviceProgramSection",
    "ElasticPlan",
    "EngineSection",
    "FaultInjector",
    "FrameArena",
    "HistogramSummary",
    "HostStream",
    "LatencySection",
    "MemoryBudget",
    "MemoryConfig",
    "MeshConfig",
    "MeshSection",
    "PoolStats",
    "Query",
    "QueryResult",
    "RecalConfig",
    "RecalibrationEvent",
    "Recalibrator",
    "ReplicaFailure",
    "ReplicaSnapshot",
    "RequestRoute",
    "RequestScheduler",
    "RunReport",
    "RuntimeConfig",
    "RuntimeStats",
    "SchedulerSaturated",
    "SchedulerSection",
    "SchedulerStats",
    "SmolRuntime",
    "SplitDecodeOption",
    "SplitDecodeSection",
    "StageMeasurement",
    "StreamingHistogram",
    "Telemetry",
    "TelemetryConfig",
    "TenantConfig",
    "TenantSection",
    "TenantStats",
    "TransferLease",
    "TransferPool",
    "TransferPoolStats",
    "WarmupSection",
    "WorkerPool",
    "WorkerRecalibrationEvent",
    "WorkerRecalibrator",
]
