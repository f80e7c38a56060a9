"""End-to-end SMOL batch runtime on torch: plan → place → pipeline.

:class:`SmolRuntime` is the facade of the batch API (``run(corpus)``); the
memory subsystem (:mod:`.memory`) owns pooled (pinned on CUDA) staging
buffers, a frame arena and an in-flight-bytes admission budget, and
:mod:`.workers` owns host-stage threading (work stealing + bounded
backpressure).
"""

from repro_torch.core.placement import SplitDecodeOption
from repro_torch.runtime.facade import (
    CompiledPlan,
    DeviceCompilerConfig,
    MeshConfig,
    RecalConfig,
    RunReport,
    RuntimeConfig,
    SmolRuntime,
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
from repro_torch.runtime.workers import WorkerPool

__all__ = [
    "ArenaStats",
    "BudgetStats",
    "BufferLease",
    "BufferPool",
    "CompiledPlan",
    "DeviceCompilerConfig",
    "FrameArena",
    "MemoryBudget",
    "MemoryConfig",
    "MeshConfig",
    "PoolStats",
    "RecalConfig",
    "RunReport",
    "RuntimeConfig",
    "SmolRuntime",
    "SplitDecodeOption",
    "TransferLease",
    "TransferPool",
    "TransferPoolStats",
    "WorkerPool",
]
