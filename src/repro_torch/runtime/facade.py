"""SmolRuntime — the end-to-end query runtime, on torch/CUDA.

One object owns the whole vertical slice the paper describes:

    spec (𝒟 models, ℱ formats, constraints)
      └─ plan      Planner.generate/select over 𝒟 × ℱ          (§3)
      └─ place     choose_split: host ops vs device ops         (§6.3)
      └─ compile   host_fn / device program for the placement
      └─ execute   PipelinedEngine batch run                    (§6.1)
      └─ serve     RequestScheduler submit()/drain()
      └─ adapt     Recalibrator re-solves the split from
                   measured stage occupancy                     (§6.3, online)

Model execution is supplied as ``model_fns[name] -> callable`` taking an
(N, C, H, W) float32 tensor on the runtime's device; everything upstream of
that call (decode, preprocessing, placement, batching, pipelining) is the
runtime's job.

This port covers ``repro.runtime.facade.SmolRuntime``: the batch path,
program-set warmup (one CUDA graph per batch bucket on a card), online
recalibration, the serving path with tenants, typed queries, telemetry,
the rendition cache and the replica mesh.  The mesh's devices are logical
ones (``repro_torch.device.mesh_devices``): each card, or the CPU, split
into ``REPRO_TORCH_FORCE_DEVICE_COUNT`` parts, each part with its own CUDA
stream on a card — so two replicas on one card are two sets of programs
and graphs on two streams, fed from the one fair queue.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
import warnings
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import device_compiler, planner as planner_mod
from repro_torch.core import placement as placement_mod
from repro_torch.core.cost_model import CoeffGeometry
from repro_torch.core.device_compiler import DevicePreprocProgram, ProgramCache
from repro_torch.core.engine import EngineStats, PipelinedEngine
from repro_torch.core.placement import (
    DEFAULT_DEVICE_SPEEDUP,
    SPLIT_DECODE_POLICIES,
    Placement,
    SplitDecodeOption,
)
from repro_torch.core.planner import ModelSpec, Planner, QueryPlan
from repro_torch.device import LogicalDevice, mesh_devices, resolve_device
from repro_torch.distributed.collectives import replica_groups
from repro_torch.distributed.sharding import batch_sharding
from repro_torch.preprocessing import ops as P
from repro_torch.preprocessing.formats import ImageFormat, StoredImage
from repro_torch.preprocessing.ops import TensorMeta
from repro_torch.core.aggregation import control_variate_aggregate
from repro_torch.core.cascade import _softmax_conf
from repro_torch.runtime.memory import MemoryBudget, MemoryConfig
from repro_torch.runtime.rendition_cache import RenditionCache
from repro_torch.runtime.query import (
    AggregationQuery,
    AggregationQueryResult,
    CascadeQuery,
    CascadeQueryResult,
    ClassificationQuery,
    ClassificationResult,
    Query,
    QueryResult,
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
    RequestRoute,
    RequestScheduler,
    TenantConfig,
)
from repro_torch.runtime.stats import (
    CacheSection,
    CacheTenantSection,
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
from repro_torch.runtime.telemetry import Telemetry, TelemetryConfig


@dataclasses.dataclass
class DeviceCompilerConfig:
    """Device preprocessing compiler knobs (core/device_compiler.py).

    ``backend``: "fused" lowers the device-op suffix + DNN into one fused
    program; "reference" keeps the per-op apply_device chain inside one
    program.

    ``fused_impl``: fused-stage implementation — "auto" (the CUDA kernel on
    a CUDA device, the plain version on the CPU), "kernel" or "plain".

    ``split_decode`` (§6.4): stop the host at the entropy stage and run
    dequant+(scaled-)IDCT (kernels/idct) inside the device program.
    "off" = pixel path; "full" = full-resolution IDCT whenever the stream
    is eligible (SJPG, 3-channel — 4:4:4 and 4:2:0 both); "scaled" =
    decode straight to the largest reduced resolution that still covers
    the plan's resize target; "auto" = the per-factor coefficient-FLOP +
    staging-byte cost model picks.  Booleans are a deprecated legacy
    spelling (False = "off", True = "full").

    ``dispatch_overhead_s``: per-dispatch-group launch overhead charged by
    the placement cost model.  None (default) measures it at first
    planning — one empty device dispatch, synchronized; 0.0 reproduces the
    overhead-free arithmetic.
    """

    backend: str = "fused"
    fused_impl: str = "auto"
    split_decode: bool | str = "off"
    dispatch_overhead_s: float | None = None

    def __post_init__(self):
        if self.backend not in ("fused", "reference"):
            raise ValueError(
                f"backend must be 'fused' or 'reference', got {self.backend!r}"
            )
        if isinstance(self.split_decode, bool):
            warnings.warn(
                "boolean split_decode is deprecated; use the policy string "
                "('off'|'full'|'scaled'|'auto')",
                DeprecationWarning,
                stacklevel=3,
            )
            self.split_decode = "full" if self.split_decode else "off"
        if self.split_decode not in SPLIT_DECODE_POLICIES:
            raise ValueError(
                f"split_decode must be one of {SPLIT_DECODE_POLICIES}, "
                f"got {self.split_decode!r}"
            )
        if self.fused_impl not in device_compiler.FUSED_IMPLS:
            raise ValueError(f"fused_impl must be auto|kernel|plain, got {self.fused_impl!r}")


@dataclasses.dataclass
class RecalConfig:
    """Online-recalibration knobs (§6.3).

    ``every``: items between recalibrations in run(); 0 = off.
    ``alpha``/``hysteresis``: measurement EWMA smoothing and the move
    threshold.  ``workers``/``max_workers``: the producer-pool sizing knob
    recalibrated next to the host/device split.
    """

    every: int = 0
    alpha: float = 0.5
    hysteresis: float = 0.1
    workers: bool = True
    max_workers: int = 16

    def __post_init__(self):
        if self.every < 0:
            raise ValueError(f"recal every must be >= 0, got {self.every}")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"recal alpha must be in (0, 1], got {self.alpha}")
        if self.hysteresis < 0:
            raise ValueError(f"recal hysteresis must be >= 0, got {self.hysteresis}")
        if self.max_workers < 1:
            raise ValueError(f"recal max_workers must be >= 1, got {self.max_workers}")


@dataclasses.dataclass
class MeshConfig:
    """Replicated multi-device serving (the device mesh).

    ``replicas``: data-parallel replica groups, each holding its own
    programs (and on a card its own CUDA graphs and stream), fed from the
    shared tenant-weighted fair queue.  ``devices``: ordinals into
    ``repro_torch.device.mesh_devices`` to build the mesh from (None =
    all of them); they are partitioned into ``replicas`` contiguous equal
    groups.  ``sharded``: when a replica group has more than one device,
    split each batch's leading dim across the group instead of leaving the
    surplus devices idle.

    The default (1 replica, no explicit devices, unsharded) builds and
    dispatches exactly as the single-device runtime always has.  CPU tests
    and one card exercise real meshes via
    ``REPRO_TORCH_FORCE_DEVICE_COUNT=n`` (n logical devices per physical
    one).
    """

    replicas: int = 1
    devices: tuple[int, ...] | None = None
    sharded: bool = False

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"mesh replicas must be >= 1, got {self.replicas}")
        if self.devices is not None:
            self.devices = tuple(int(d) for d in self.devices)
            if len(set(self.devices)) != len(self.devices):
                raise ValueError(f"duplicate mesh device ordinals: {self.devices}")


# legacy flat RuntimeConfig kwarg -> (sub-config field, sub-config attr)
_LEGACY_CONFIG_ALIASES = {
    "device_backend": ("device", "backend"),
    "fused_impl": ("device", "fused_impl"),
    "split_decode": ("device", "split_decode"),
    "device_dispatch_overhead_s": ("device", "dispatch_overhead_s"),
    "recalibrate_every": ("recal", "every"),
    "recal_alpha": ("recal", "alpha"),
    "recal_hysteresis": ("recal", "hysteresis"),
    "recal_workers": ("recal", "workers"),
    "max_recal_workers": ("recal", "max_workers"),
}


@dataclasses.dataclass
class RuntimeConfig:
    """Runtime configuration: flat serving/planning knobs + typed
    sub-configs for the device compiler (``device``), online
    recalibration (``recal``) and the replica mesh (``mesh``).

    The pre-structured flat kwargs (``device_backend``, ``fused_impl``,
    ``split_decode``, ``device_dispatch_overhead_s``,
    ``recalibrate_every``, ``recal_*``, ``max_recal_workers``) still
    construct — mapped into the sub-configs with one aggregated
    ``DeprecationWarning`` — and still read as attributes (snapshots taken
    at construction).  New code should set and read the sub-configs.
    """

    batch_size: int = 32
    num_workers: int = 4
    max_wait_ms: float = 5.0  # dynamic-batching latency knob (serving path)
    min_accuracy: float | None = None
    min_throughput: float | None = None
    estimator: str = "smol"
    host_ops_per_sec: float = 2.0e9
    device_ops_per_sec: float | None = None
    # memory & threading subsystem: staging-buffer pooling, in-flight byte
    # budget, scheduler admission policy
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    # device preprocessing compiler (backend / fused impl / split decode)
    device: DeviceCompilerConfig = dataclasses.field(default_factory=DeviceCompilerConfig)
    # online recalibration (split EWMA + worker-count knob)
    recal: RecalConfig = dataclasses.field(default_factory=RecalConfig)
    # replicated multi-device serving
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # tracing + metrics: always-on streaming latency histograms, opt-in
    # per-request span capture (Perfetto export) — runtime/telemetry.py
    telemetry: TelemetryConfig = dataclasses.field(default_factory=TelemetryConfig)
    # --- multi-tenant serving ---
    # per-tenant quotas / weights / pinned models; () = single-tenant.
    # Every TenantConfig becomes a scheduler tenant (weighted-fair service,
    # per-tenant admission) and, when the memory budget is set, a child
    # MemoryBudget carved out of it.
    tenants: tuple[TenantConfig, ...] = ()
    # bound on the compiled device-program cache (LRU eviction beyond it);
    # multi-model tenants churn programs — and every replica holds its own
    # program instance — so the cache must not grow without bound
    program_cache_entries: int = 16
    # program-set warmup (kills cold starts on the request path):
    #   "off"  — one program per plan; its first dispatch is its cold start
    #   "lazy" — build + pin one program per batch bucket at compile time;
    #            each still pays its cold start on first use (eagerly)
    #   "full" — additionally warm every bucket at startup (on CUDA: capture
    #            it as one CUDA graph, replayed by every later dispatch), so
    #            steady-state serving never pays a cold start
    warmup: str = "off"
    # dispatch batches from a dedicated engine thread so batch N+1's H2D
    # staging overlaps batch N's compute (False = synchronous staging)
    double_buffer: bool = True
    # deprecated flat spellings of the sub-config fields above
    device_backend: dataclasses.InitVar[str | None] = None
    fused_impl: dataclasses.InitVar[str | None] = None
    split_decode: dataclasses.InitVar[bool | str | None] = None
    device_dispatch_overhead_s: dataclasses.InitVar[float | None] = None
    recalibrate_every: dataclasses.InitVar[int | None] = None
    recal_alpha: dataclasses.InitVar[float | None] = None
    recal_hysteresis: dataclasses.InitVar[float | None] = None
    recal_workers: dataclasses.InitVar[bool | None] = None
    max_recal_workers: dataclasses.InitVar[int | None] = None

    def __post_init__(
        self,
        device_backend,
        fused_impl,
        split_decode,
        device_dispatch_overhead_s,
        recalibrate_every,
        recal_alpha,
        recal_hysteresis,
        recal_workers,
        max_recal_workers,
    ):
        legacy = {
            "device_backend": device_backend,
            "fused_impl": fused_impl,
            "split_decode": split_decode,
            "device_dispatch_overhead_s": device_dispatch_overhead_s,
            "recalibrate_every": recalibrate_every,
            "recal_alpha": recal_alpha,
            "recal_hysteresis": recal_hysteresis,
            "recal_workers": recal_workers,
            "max_recal_workers": max_recal_workers,
        }
        used = {k: v for k, v in legacy.items() if v is not None}
        if used:
            warnings.warn(
                f"RuntimeConfig kwargs {sorted(used)} are deprecated; set the "
                "structured sub-configs instead (device=DeviceCompilerConfig(...), "
                "recal=RecalConfig(...))",
                DeprecationWarning,
                stacklevel=3,
            )
            # route every legacy kwarg through the sub-config constructors
            # so their validation (and the bool split_decode mapping) runs
            patch: dict[str, dict[str, Any]] = {}
            for name, value in used.items():
                sub, attr = _LEGACY_CONFIG_ALIASES[name]
                patch.setdefault(sub, {})[attr] = value
            with warnings.catch_warnings():
                # the aggregated warning above covers the bool mapping too
                warnings.simplefilter("ignore", DeprecationWarning)
                for sub, kwargs in patch.items():
                    setattr(self, sub, dataclasses.replace(getattr(self, sub), **kwargs))
        if self.program_cache_entries < 1:
            raise ValueError("program_cache_entries must be >= 1")
        if self.warmup not in ("off", "lazy", "full"):
            raise ValueError(
                f"warmup must be 'off', 'lazy' or 'full', got {self.warmup!r}"
            )
        self.tenants = tuple(self.tenants)
        names = [t.name for t in self.tenants]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate tenant names: {names}")
        # read-only views under the legacy names (instance attrs shadow the
        # InitVar class defaults): snapshots of the resolved sub-configs,
        # kept so pre-redesign readers — `cfg.split_decode` et al. — work
        self.device_backend = self.device.backend
        self.fused_impl = self.device.fused_impl
        self.split_decode = self.device.split_decode
        self.device_dispatch_overhead_s = self.device.dispatch_overhead_s
        self.recalibrate_every = self.recal.every
        self.recal_alpha = self.recal.alpha
        self.recal_hysteresis = self.recal.hysteresis
        self.recal_workers = self.recal.workers
        self.max_recal_workers = self.recal.max_workers


def _physical(device: torch.device) -> torch.device:
    """``device`` with its index filled in (a card's current one)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _ModelCopies:
    """An ``nn.Module`` model on every physical device a mesh spans: the
    original on the runtime's own, a copy made at first use on each
    other, picked by the input's device."""

    def __init__(self, model: torch.nn.Module, home: torch.device):
        self._copies = {home: model}
        self._model = model
        self._lock = threading.Lock()

    def __call__(self, x: torch.Tensor) -> Any:
        model = self._copies.get(x.device)
        if model is None:
            with self._lock:
                if x.device not in self._copies:
                    self._copies[x.device] = copy.deepcopy(self._model).to(x.device)
                model = self._copies[x.device]
        return model(x)


@dataclasses.dataclass
class CompiledPlan:
    plan: QueryPlan
    placement: Placement
    host_fn: Callable[[Any], np.ndarray]
    device_fn: Callable[[Any], Any]  # the compiled device program (callable)
    out_shape: tuple[int, ...]
    out_dtype: Any
    # the device preprocessing compiler's product: ONE program for
    # device-placed preprocessing + DNN (device_fn is this program)
    device_program: DevicePreprocProgram | None = None
    # the full replica set: one program instance per replica group (the
    # batch-path engine and single-replica serving use device_programs[0]
    # == device_fn; the scheduler's replica dispatchers use all of them)
    device_programs: tuple[DevicePreprocProgram, ...] = ()
    # non-None when this plan runs the split-decode placement: the costed
    # scaled-IDCT factor / staging layout the program was compiled for
    coeff: SplitDecodeOption | None = None
    # bucket programs, one ProgramSet per replica target (empty when
    # RuntimeConfig.warmup == "off"): partial batches dispatch the smallest
    # covering bucket's program (on CUDA its captured graph once warm)
    program_sets: tuple[Any, ...] = ()
    # Built lazily: only the batch path needs the engine's staging buffers;
    # the serving path feeds the RequestScheduler directly.
    engine: PipelinedEngine | None = None


@dataclasses.dataclass
class RunReport:
    plan_key: str
    stats: EngineStats
    chunk_stats: list[EngineStats]
    recalibrations: list[RecalibrationEvent]

    @property
    def throughput(self) -> float:
        return self.stats.throughput


class _CascadeContext:
    """Live serving state of one tenant's two-stage cascade.

    Holds the compiled stage targets (cheap = scaled split decode, built
    with its own ProgramSets; expensive = full-resolution pixel path), the
    scheduler bindings routed requests dispatch through, the cheap stage's
    current decode factor, and the exit counters the stats section and the
    :class:`CascadeRecalibrator` read.  ``win_*`` counters reset on every
    recalibration window; lifetime counters never do.
    """

    def __init__(
        self,
        tenant: str,
        threshold: float,
        cheap: CompiledPlan,
        expensive: CompiledPlan,
        cheap_binding: Any,
        expensive_binding: Any,
        factor: int,
        candidates: tuple[int, ...],
        recal: CascadeRecalibrator,
    ):
        self.tenant = tenant
        self.threshold = threshold
        self.cheap = cheap
        self.expensive = expensive
        self.cheap_binding = cheap_binding
        self.expensive_binding = expensive_binding
        self.factor = factor
        self.candidates = candidates
        self.recal = recal
        self.lock = threading.Lock()
        self.stage_items = [0, 0]  # items that entered each stage
        self.stage_exits = [0, 0]  # items whose prediction exited there
        self.refetched = 0
        self.win_items = 0  # recalibration-window deltas
        self.win_refetched = 0


class SmolRuntime:
    """Facade wiring planner → placement → pipelined engine → serving.

    ``device`` is where device programs and ``model_fns`` run: ``"cuda"``
    (the default; raises when no card is visible) or ``"cpu"`` (every kernel
    runs its plain version).  Building a runtime turns TF32 off for cuDNN
    convolutions and CUDA matmuls: the port computes in fp32 throughout.
    """

    def __init__(
        self,
        models: Sequence[ModelSpec],
        formats: Sequence[ImageFormat],
        model_fns: Mapping[str, Callable],
        calibration: Sequence[StoredImage],
        config: RuntimeConfig | None = None,
        decode_time: Callable[[ImageFormat], float] | None = None,
        device: str | torch.device | None = "cuda",
    ):
        if not calibration:
            raise ValueError("need at least one calibration StoredImage")
        missing = [m.name for m in models if m.name not in model_fns]
        if missing:
            raise ValueError(f"no model_fn for models: {missing}")
        cfg = config or RuntimeConfig()
        known = {m.name for m in models}
        bad = [t.name for t in cfg.tenants if t.model is not None and t.model not in known]
        if bad:
            raise ValueError(f"tenants pin unknown models: {bad}")
        self.device = resolve_device(device)
        # fp32 parity with the reference: cuDNN defaults to TF32 convolutions
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.models = list(models)
        self.formats = list(formats)
        self.model_fns = dict(model_fns)
        self.calibration = list(calibration)
        self.config = cfg
        # one telemetry hub for the whole runtime: scheduler, engine and
        # worker pool all record into it (shared clocks, shared histograms)
        self.telemetry = Telemetry(cfg.telemetry)
        self._decode_time_override = decode_time
        self._decode_time_cache: dict[str, float] = {}
        self._decoded_meta_cache: dict[str, TensorMeta] = {}
        # split-decode calibration: measured entropy-stage seconds/item and
        # coefficient-stream geometry, per format (None = ineligible)
        self._entropy_time_cache: dict[str, float] = {}
        self._coeff_geom_cache: dict[str, CoeffGeometry | None] = {}
        self._plan: QueryPlan | None = None
        self._planner: Planner | None = None
        self._compiled: CompiledPlan | None = None
        # device-program cache, keyed on (op specs, in_meta, batch, backend,
        # impl, model, device): placement moves that revisit a split point
        # reuse the already-built program instead of rebuilding it.  Bounded:
        # multi-tenant/multi-model serving churns programs, so entries
        # beyond program_cache_entries are LRU-evicted (an active tenant's
        # program is re-looked-up on every rebind and stays resident).
        self._device_programs = ProgramCache(self.config.program_cache_entries)
        # nn.Module models copied onto the mesh's other physical devices
        self._model_copies: dict[str, _ModelCopies] = {}
        # the replica targets, resolved at the first compile and kept: a
        # recompile never sees another mesh than the scheduler was built for
        self._targets: list[Any] | None = None
        # measured per-dispatch launch overhead (lazily filled when the
        # config leaves device_dispatch_overhead_s at None)
        self._measured_dispatch_s: float | None = None
        # cold-start observability: every DevicePreprocProgram this runtime
        # builds reports its cold start (its first eager dispatch, or its
        # warm-up run + graph capture) through _on_program_compiled.  _warmup_done flips once
        # start_serving() finishes — compiles after that are request-path
        # cold starts, which warmup="full" promises to eliminate.
        self._warmup_done = False
        self._programs_compiled_post_warmup = 0
        self._program_compile_seconds = 0.0
        self._compile_span_seq = 0
        self._recalibrator: Recalibrator | None = None
        # multi-tenant state: tenants pinning their own model get their own
        # plan, compiled program, and recalibrator (per-tenant splits)
        self._tenant_cfgs: dict[str, TenantConfig] = {t.name: t for t in self.config.tenants}
        self._tenant_plans: dict[str, QueryPlan] = {}
        self._tenant_compiled: dict[str, CompiledPlan] = {}
        self._tenant_recals: dict[str, Recalibrator] = {}
        self._scheduler: RequestScheduler | None = None
        self.recalibrations: list[RecalibrationEvent] = []
        # live producer-pool size; starts at config and tracks the worker-
        # count recalibration knob
        self._num_workers = self.config.num_workers
        self._worker_recal: WorkerRecalibrator | None = None
        self.worker_recalibrations: list[WorkerRecalibrationEvent] = []
        # --- typed query serving (§3.2 query classes) ---
        # uid -> query kind for drain() to wrap results; cascade uids also
        # record (exit_stage, refetched) once the scheduler resolves them
        self._typed_queries: dict[int, str] = {}
        self._cascade_results: dict[int, tuple[int, bool]] = {}
        # live cascade contexts keyed on (tenant, stage models, threshold);
        # aggregation (cheap, expensive) stage targets keyed on tenant
        self._cascades: dict[tuple, _CascadeContext] = {}
        self._agg_targets: dict[str, tuple] = {}
        self._legacy_submit_warned = False
        self.cascade_recalibrations: list[CascadeRecalibrationEvent] = []
        # --- rendition cache (corpus-level materialized representations) ---
        # The serving byte budget is built once here (not per start_serving)
        # so the cache capacity can be carved out of the SAME hierarchy the
        # scheduler admits against: cache bytes compete for unfloored
        # headroom under the configured weight and can never eat a tenant's
        # guaranteed floor.  With the cache off, nothing is allocated and
        # every host stage compiles to its cacheless closure.
        mem = cfg.memory
        self._serving_budget = mem.build_budget()
        self._cache_budget: MemoryBudget | None = None
        self._rendition_cache: RenditionCache | None = None
        if mem.rendition_cache_bytes:
            if self._serving_budget is not None:
                self._cache_budget = self._serving_budget.child(
                    "rendition_cache",
                    weight=mem.rendition_cache_weight,
                    max_bytes=mem.rendition_cache_bytes,
                )
            else:
                self._cache_budget = MemoryBudget(
                    mem.rendition_cache_bytes, name="rendition_cache"
                )
            self._rendition_cache = RenditionCache(
                self._cache_budget,
                telemetry=self.telemetry,
                min_utility=mem.rendition_cache_min_utility,
            )
        # --- background warmer (ProgramSet.warm off the startup path) ---
        self._warm_cond = threading.Condition()
        self._warm_queue: list[Any] = []
        self._warm_pending = 0
        self._warm_thread: threading.Thread | None = None
        # (bucket, exception) of every background warm that failed
        self._warm_failures: list[tuple[int, BaseException]] = []

    # ----------------------------------------------------------- calibration
    def _decode_time(self, fmt: ImageFormat) -> float:
        if self._decode_time_override is not None:
            return self._decode_time_override(fmt)
        if fmt.key not in self._decode_time_cache:
            self._decode_time_cache[fmt.key] = planner_mod.measure_decode_time(
                self.calibration, fmt
            )
        return self._decode_time_cache[fmt.key]

    def _decoded_meta(self, fmt: ImageFormat) -> TensorMeta:
        if fmt.key not in self._decoded_meta_cache:
            sample = self.calibration[0].decode(fmt)
            self._decoded_meta_cache[fmt.key] = TensorMeta(
                tuple(sample.shape), str(sample.dtype), "HWC"
            )
        return self._decoded_meta_cache[fmt.key]

    def _coeff_geometry(self, fmt: ImageFormat) -> CoeffGeometry | None:
        """Coefficient-stream geometry of one format's calibration sample
        (None for non-SJPG codecs — the pixel path serves those)."""
        if fmt.key not in self._coeff_geom_cache:
            geom = None
            if fmt.codec == "jpeg":
                from repro_torch.preprocessing import jpeg as jpeg_mod

                header = jpeg_mod.peek_header(self.calibration[0].variants[fmt])
                geom = CoeffGeometry.from_header(header)
            self._coeff_geom_cache[fmt.key] = geom
        return self._coeff_geom_cache[fmt.key]

    def _entropy_time(self, fmt: ImageFormat) -> float:
        """Measured seconds/item of the host entropy stage for ``fmt``."""
        if fmt.key not in self._entropy_time_cache:
            self._entropy_time_cache[fmt.key] = planner_mod.measure_entropy_decode_time(
                self.calibration, fmt
            )
        return self._entropy_time_cache[fmt.key]

    def _cache_hit_rate(self, fmt: ImageFormat) -> float:
        """Measured rendition-cache hit fraction for ``fmt`` (0.0 when the
        cache is off or cold) — the planner's cache-aware discount."""
        cache = self._rendition_cache
        return cache.hit_rate(fmt.key) if cache is not None else 0.0

    @property
    def rendition_cache(self) -> RenditionCache | None:
        """The corpus-level rendition cache (None when disabled)."""
        return self._rendition_cache

    @staticmethod
    def measure_exec_throughput(
        model_fn: Callable,
        input_size: int,
        batch_size: int = 32,
        iters: int = 4,
        device: str | torch.device | None = "cuda",
    ) -> float:
        """items/sec of one model_fn on synthetic batches (paper §4),
        timed between device synchronizations."""
        dev = resolve_device(device)
        x = torch.zeros((batch_size, 3, input_size, input_size), dtype=torch.float32, device=dev)
        with torch.inference_mode():
            model_fn(x)  # first launches outside the clock
            device_compiler.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                model_fn(x)
            device_compiler.synchronize(dev)
        return batch_size * iters / (time.perf_counter() - t0)

    def _dispatch_overhead(self) -> float:
        """Per-dispatch launch overhead for the placement cost model:
        explicit config wins, else one empty dispatch is timed once."""
        if self.config.device.dispatch_overhead_s is not None:
            return self.config.device.dispatch_overhead_s
        if self._measured_dispatch_s is None:
            self._measured_dispatch_s = device_compiler.measure_dispatch_overhead(
                device=self.device
            )
        return self._measured_dispatch_s

    # -------------------------------------------------------------- planning
    def planner(self) -> Planner:
        # one Planner per runtime: its inputs are fixed at construction and
        # it memoizes 𝒟 × ℱ generation, so plan()/pareto() stay O(1) after
        # the first call
        if self._planner is None:
            self._planner = Planner(
                self.models,
                self.formats,
                decode_time=self._decode_time,
                decoded_meta=self._decoded_meta,
                host_ops_per_sec=self.config.host_ops_per_sec,
                device_ops_per_sec=self.config.device_ops_per_sec,
                estimator=self.config.estimator,
                device_dispatch_overhead_s=self._dispatch_overhead(),
                device_fused=self.config.device.backend == "fused",
                split_decode=self.config.device.split_decode,
                entropy_decode_time=self._entropy_time,
                coeff_geometry=self._coeff_geometry,
                cache_hit_rate=(
                    self._cache_hit_rate if self._rendition_cache is not None else None
                ),
            )
        return self._planner

    def plan(self, force: bool = False) -> QueryPlan:
        if self._plan is None or force:
            self._plan = self.planner().select(
                min_accuracy=self.config.min_accuracy,
                min_throughput=self.config.min_throughput,
            )
        return self._plan

    def pareto(self) -> list[QueryPlan]:
        return self.planner().pareto()

    # ------------------------------------------------------------- compiling
    def _coeff_stage_fns(
        self,
        plan: QueryPlan,
        coeff: SplitDecodeOption,
        device: Any = None,
        batch_size: int | None = None,
    ):
        """Split-decode path (§6.4): host stops after the entropy stage and
        stages one quantized-coefficient tensor per item
        (``jpeg.stage_coefficients`` — 4:2:0's quarter-density chroma packs
        or pads per ``coeff.layout``); the device program runs
        dequant+(scaled-)IDCT at ``coeff.factor`` (kernels/idct) -> chroma
        upsample -> color conversion -> fused preproc -> DNN.  Returns None
        when the plan's stream is not eligible (non-SJPG codec, grayscale)
        — callers fall back to the pixel path."""
        fmt = plan.fmt
        if fmt.codec != "jpeg":
            return None
        from repro_torch.preprocessing import jpeg as jpeg_mod

        header = jpeg_mod.peek_header(self.calibration[0].variants[fmt])
        chain = list(plan.dag_plan.ops)
        try:
            program = device_compiler.compile_coeff_program(
                header,
                chain,
                self._model_fn(plan.model.name, device),
                batch_size or self.config.batch_size,
                factor=coeff.factor,
                layout=coeff.layout,
                impl=self.config.device.fused_impl,
                model_key=plan.model.name,
                cache=self._device_programs,
                device=device or self.device,
            )
        except ValueError:
            return None
        program.compile_listener = self._on_program_compiled
        out_shape = tuple(program.in_meta.shape)  # staged_coeff_shape(header, layout)
        out_dtype = np.dtype(program.in_meta.dtype)
        layout = coeff.layout
        cache = self._rendition_cache

        if cache is None:

            def host_fn(item):
                if not hasattr(item, "decode_to_coefficients"):
                    raise TypeError(
                        "split decode requires StoredImage items with a jpeg variant"
                    )
                hdr_i, planes_zz, _, _ = item.decode_to_coefficients(fmt)
                arr = jpeg_mod.stage_coefficients(planes_zz, hdr_i, layout)
                if arr.shape != out_shape:
                    raise ValueError(
                        f"entropy stage produced {arr.shape}, expected {out_shape}; "
                        "the corpus must be shape-uniform with the calibration set"
                    )
                return arr

        else:
            # cache-aware host stage: the staged tensor is factor-invariant
            # (full coefficient set, device math scales), so the entry is
            # keyed without the factor and one admission serves every
            # scaled-decode program of this (format, layout) — including a
            # cascade's full-resolution stage-1 refetch.  The admission
            # cost is the measured entropy-stage seconds a hit saves.
            fmt_key = fmt.key
            cost_s = self._entropy_time(fmt)

            def host_fn(item):
                if not hasattr(item, "decode_to_coefficients"):
                    raise TypeError(
                        "split decode requires StoredImage items with a jpeg variant"
                    )
                key = cache.coeff_key(item, fmt_key, layout)
                if key is not None:
                    hit = cache.get(key)
                    if hit is not None and hit.shape == out_shape:
                        return hit
                hdr_i, planes_zz, _, _ = item.decode_to_coefficients(fmt)
                arr = jpeg_mod.stage_coefficients(planes_zz, hdr_i, layout)
                if arr.shape != out_shape:
                    raise ValueError(
                        f"entropy stage produced {arr.shape}, expected {out_shape}; "
                        "the corpus must be shape-uniform with the calibration set"
                    )
                if key is not None:
                    cache.put(key, arr, cost_s, item=item)
                return arr

        return host_fn, program, out_shape, out_dtype

    def _stage_fns(
        self,
        plan: QueryPlan,
        placement: Placement,
        device: Any = None,
        batch_size: int | None = None,
    ):
        fmt = plan.fmt
        host_ops = list(placement.host_ops)
        device_ops = list(placement.device_ops)
        in_meta = self._decoded_meta(fmt)
        out_meta = P.chain_out_meta(host_ops, in_meta)
        out_shape, out_dtype = tuple(out_meta.shape), np.dtype(out_meta.dtype)
        model_fn = self._model_fn(plan.model.name, device)

        in_shape = tuple(in_meta.shape)
        cache = self._rendition_cache
        # cache key ingredient: the host chain's identity — the same stored
        # item transcoded through a different host placement is a different
        # pixel rendition
        chain_sig = "|".join(repr(op) for op in host_ops)
        cost_s = self._decode_time(fmt) if cache is not None else 0.0
        fmt_key = fmt.key

        def stage_pixels(item):
            if hasattr(item, "decode"):
                x = item.decode(fmt)
                # enforce the shape contract at decode, not at the stage
                # boundary: a full-host placement would otherwise normalize
                # any input through its resize and mask corpus drift that a
                # device-heavy placement rejects
                if tuple(np.shape(x)) != in_shape:
                    raise ValueError(
                        f"decoded {tuple(np.shape(x))}, expected {in_shape}; "
                        "the corpus must be shape-uniform with the calibration set"
                    )
            else:
                x = item
            x = P.apply_chain_host(host_ops, x)
            x = np.asarray(x, dtype=out_dtype)
            if x.shape != out_shape:
                raise ValueError(
                    f"host stage produced {x.shape}, expected {out_shape}; "
                    "the corpus must be shape-uniform with the calibration set"
                )
            return x

        if cache is None:
            host_fn = stage_pixels
        else:

            def host_fn(item):
                # only stored items are cacheable (raw arrays have no
                # corpus identity and already skipped the decode)
                key = (
                    cache.pixel_key(item, fmt_key, chain_sig)
                    if hasattr(item, "decode")
                    else None
                )
                if key is not None:
                    hit = cache.get(key)
                    if hit is not None and hit.shape == out_shape:
                        return hit
                x = stage_pixels(item)
                if key is not None:
                    cache.put(key, x, cost_s, item=item)
                return x

        program = device_compiler.compile_device_program(
            device_ops,
            out_meta,
            model_fn,
            batch_size or self.config.batch_size,
            backend=self.config.device.backend,
            impl=self.config.device.fused_impl,
            model_key=plan.model.name,
            cache=self._device_programs,
            device=device or self.device,
        )
        program.compile_listener = self._on_program_compiled
        return host_fn, program, out_shape, out_dtype

    def _on_program_compiled(
        self, prog: DevicePreprocProgram, first_dispatch_seconds: float
    ) -> None:
        """Compile listener: a program just paid its cold start (its first
        eager dispatch, or on CUDA its warm-up run + graph capture).  Feeds
        the cold-compile counters (``metrics_text``) and emits a "compile"
        span when span capture is on — warmup-pass compiles are tagged,
        request-path ones count."""
        self._program_compile_seconds += prog.build_seconds + first_dispatch_seconds
        if self._warmup_done and not prog._warming:
            self._programs_compiled_post_warmup += 1
        tel = self.telemetry
        if tel.config.spans:
            t1 = time.perf_counter()
            self._compile_span_seq += 1
            tel.emit_span(
                "compile",
                f"compile[bs={prog.batch_size}]",
                None,
                self._compile_span_seq,
                t1 - first_dispatch_seconds,
                t1,
                impl=prog.impl,
                backend=prog.backend,
                batch=prog.batch_size,
                warmup=prog._warming,
                build_s=prog.build_seconds,
            )

    @property
    def programs_compiled_post_warmup(self) -> int:
        """Device programs that paid their cold start on the request path —
        after ``start_serving()`` finished and outside any warmup pass.
        Stays 0 under ``warmup="full"``; that is the cold-start guarantee."""
        return self._programs_compiled_post_warmup

    @property
    def program_compile_seconds_total(self) -> float:
        """Cumulative build + cold-start (first dispatch, graph capture)
        seconds across every program this runtime built, warmup included."""
        return self._program_compile_seconds

    def compile(self, plan: QueryPlan | None = None, force: bool = False) -> CompiledPlan:
        if self._compiled is not None and plan is None and not force:
            return self._compiled
        plan = plan or self.plan()
        compiled = self._compile_placement(plan, plan.placement)
        self._recalibrator = self._make_recalibrator(plan)
        if self._worker_recal is None:
            self._worker_recal = WorkerRecalibrator(
                num_workers=self._num_workers,
                max_workers=max(self.config.recal.max_workers, self._num_workers),
                alpha=self.config.recal.alpha,
            )
        return compiled

    def _make_recalibrator(self, plan: QueryPlan) -> Recalibrator:
        device_rate = self.config.device_ops_per_sec or (
            self.config.host_ops_per_sec * DEFAULT_DEVICE_SPEEDUP
        )
        geom = (
            self._coeff_geometry(plan.fmt)
            if self.config.device.split_decode != "off"
            else None
        )
        if geom is not None and geom.channels != 3:
            geom = None
        return Recalibrator(
            plan.dag_plan.ops,
            self._decoded_meta(plan.fmt),
            host_decode_time=self._decode_time(plan.fmt),
            dnn_device_time=1.0 / plan.model.exec_throughput,
            host_ops_per_sec=self.config.host_ops_per_sec,
            device_ops_per_sec=device_rate,
            alpha=self.config.recal.alpha,
            hysteresis=self.config.recal.hysteresis,
            device_dispatch_overhead_s=self._dispatch_overhead(),
            device_fused=self.config.device.backend == "fused",
            split_decode=self.config.device.split_decode if geom is not None else "off",
            coeff_geometry=geom,
            host_entropy_time=self._entropy_time(plan.fmt) if geom is not None else None,
        )

    _COEFF_FROM_PLAN = object()  # sentinel: use plan.coeff (vs an override)

    def _replica_targets(self) -> list[Any]:
        """One compilation/dispatch target per replica group, resolved once
        (at the first compile) and reused for the runtime's life.

        The single-replica default with no explicit devices keeps the
        single-device path: the runtime's device, programs on the caller's
        current stream.  Otherwise each replica group resolves to its
        logical device (its own stream on a card) — or, in sharded mode,
        a :class:`BatchSharding` splitting the batch across the group.
        """
        if self._targets is None:
            self._targets = self._resolve_targets()
        return self._targets

    def _resolve_targets(self) -> list[Any]:
        mesh = self.config.mesh
        if mesh.replicas == 1 and mesh.devices is None and not mesh.sharded:
            return [self.device]
        devs = mesh_devices(self.device)
        if mesh.devices is not None:
            try:
                devs = [devs[i] for i in mesh.devices]
            except IndexError:
                raise ValueError(
                    f"mesh.devices={mesh.devices} out of range for "
                    f"{len(devs)} visible device(s)"
                ) from None
        groups = replica_groups(devs, mesh.replicas)
        targets: list[Any] = []
        for group in groups:
            if len(group) > 1 and mesh.sharded:
                if self.config.batch_size % len(group):
                    raise ValueError(
                        f"batch_size {self.config.batch_size} does not split over "
                        f"a sharded group of {len(group)} devices"
                    )
                targets.append(batch_sharding(group))
            else:
                # unsharded groups dispatch on their first device (surplus
                # members idle — enable mesh.sharded to use them)
                targets.append(group[0])
        return targets

    @staticmethod
    def _target_label(target: Any) -> str:
        if hasattr(target, "device_set"):  # a sharded replica group
            ids = sorted(d.id for d in target.device_set)
            return f"sharded[{ids[0]}-{ids[-1]}]"
        if isinstance(target, LogicalDevice):
            return target.label
        return str(target)

    def _model_fn(self, name: str, target: Any) -> Callable:
        """``name``'s model for a program on ``target``.  An ``nn.Module``
        is used as is on the runtime's own physical device; a mesh that
        spans others gets one copy of it per other physical device."""
        fn = self.model_fns[name]
        members = getattr(target, "devices", (target or self.device,))
        phys = {_physical(getattr(d, "device", d)) for d in members}
        if phys <= {_physical(self.device)} or not isinstance(fn, torch.nn.Module):
            return fn
        if name not in self._model_copies:
            self._model_copies[name] = _ModelCopies(fn, _physical(self.device))
        return self._model_copies[name]

    def _build_compiled(
        self, plan: QueryPlan, placement: Placement, coeff: Any = _COEFF_FROM_PLAN
    ) -> CompiledPlan:
        """Compile one (plan, placement) into stage functions + programs —
        shared by the default plan and per-tenant pinned plans (all hit the
        same bounded program cache).  ``coeff`` overrides the plan's costed
        split-decode option (recalibration moves between the pixel path,
        factors and layouts without replanning).  One program instance is
        built per replica target (cache-keyed on the logical device), so
        every replica dispatcher owns a program bound to its own device or
        group.
        """
        if coeff is SmolRuntime._COEFF_FROM_PLAN:
            coeff = plan.coeff
        targets = self._replica_targets()
        staged = None
        used_coeff: SplitDecodeOption | None = None
        if coeff is not None:
            staged = self._coeff_stage_fns(plan, coeff, device=targets[0])
            if staged is not None:
                used_coeff = coeff
                # the whole dense pipeline (dequant+IDCT onward) runs device-
                # side: pin the placement at split 0 so stats/recalibration
                # attribute stage time the way the program actually executes
                placement = placement_mod.placement_for_split(
                    list(plan.dag_plan.ops),
                    self._decoded_meta(plan.fmt),
                    0,
                    host_decode_time=self._decode_time(plan.fmt),
                    dnn_device_time=1.0 / plan.model.exec_throughput,
                    host_ops_per_sec=self.config.host_ops_per_sec,
                    device_ops_per_sec=self.config.device_ops_per_sec,
                    device_dispatch_overhead_s=self._dispatch_overhead(),
                    device_fused=self.config.device.backend == "fused",
                )
        if staged is None:
            staged = self._stage_fns(plan, placement, device=targets[0])
        host_fn, program, out_shape, out_dtype = staged
        programs = [program]
        for target in targets[1:]:
            if used_coeff is not None:
                _, prog, _, _ = self._coeff_stage_fns(plan, used_coeff, device=target)
            else:
                _, prog, _, _ = self._stage_fns(plan, placement, device=target)
            programs.append(prog)
        program_sets: tuple[Any, ...] = ()
        if self.config.warmup != "off":
            program_sets = tuple(
                self._build_program_set(plan, placement, used_coeff, target, prog)
                for target, prog in zip(targets, programs)
            )
            pinned = self._device_programs.stats().pinned
            if pinned > self.config.program_cache_entries:
                warnings.warn(
                    f"program_cache_entries={self.config.program_cache_entries} "
                    f"is smaller than the {pinned} pinned warmup programs; the "
                    "cache will hold above its bound — raise "
                    "program_cache_entries to cover the warmup set",
                    RuntimeWarning,
                    stacklevel=3,
                )
            if self.config.warmup == "full":
                # warm only the largest bucket on the caller's thread (on
                # CUDA: capture its graph; a failure raises here) — serving
                # can start on the full-size program immediately — and hand
                # the rest to the background warmer.  The sets are built
                # require_ready, so dispatchers fall back to a ready
                # covering bucket instead of paying a cold start mid-request.
                for ps in program_sets:
                    ps.warm(buckets=(ps.max_batch,))
                    self._warm_async(ps)
        return CompiledPlan(
            plan, placement, host_fn, programs[0], out_shape, out_dtype,
            device_program=programs[0], coeff=used_coeff,
            device_programs=tuple(programs), program_sets=program_sets,
        )

    def _build_program_set(
        self,
        plan: QueryPlan,
        placement: Placement,
        coeff: SplitDecodeOption | None,
        target: Any,
        full_program: DevicePreprocProgram,
    ):
        """Bucket programs for one replica target.

        One program per power-of-two batch bucket (plus the exact batch
        size), every one pinned in the program cache so LRU churn from
        other tenants can't undo the warmup while this plan is bound.
        Sharded targets keep only buckets their group size divides.
        """
        group = len(getattr(target, "device_set", ())) or 1
        programs: dict[int, DevicePreprocProgram] = {}
        # descending: the already-built full-size program is pinned before
        # smaller-bucket builds can LRU-evict it from a tight cache
        for bucket in reversed(device_compiler.batch_buckets(self.config.batch_size)):
            if bucket % group:
                continue  # sharded batches need the batch axis divisible
            if bucket == self.config.batch_size:
                prog = full_program
            elif coeff is not None:
                staged = self._coeff_stage_fns(
                    plan, coeff, device=target, batch_size=bucket
                )
                if staged is None:  # pragma: no cover - full-size compile worked
                    continue
                prog = staged[1]
            else:
                _, prog, _, _ = self._stage_fns(
                    plan, placement, device=target, batch_size=bucket
                )
            self._device_programs.pin(prog.key)
            programs[bucket] = prog
        return device_compiler.ProgramSet(
            programs=programs,
            geometry=(tuple(full_program.in_meta.shape), full_program.in_meta.dtype),
            device=target,
            # under warmup="full" the small buckets warm in the background;
            # readiness gating preserves the zero-post-warmup-compile
            # guarantee while they do
            require_ready=self.config.warmup == "full",
        )

    # ------------------------------------------------------- background warm
    def _warm_async(self, ps) -> None:
        """Queue ``ps``'s remaining buckets for the background warmer.

        The warmer is one daemon thread shared by every plan this runtime
        compiles — warmup traffic is strictly sequential.  On CUDA it
        captures each bucket's graph on its own side stream while
        dispatcher threads serve.  It exits once its queue is empty (the
        next queued set starts a new one), so no warmer outlives its work.
        """
        with self._warm_cond:
            self._warm_queue.append(ps)
            self._warm_pending += 1
            if self._warm_thread is None:
                self._warm_thread = threading.Thread(
                    target=self._warm_loop, name="smol-warmup", daemon=True
                )
                self._warm_thread.start()
            self._warm_cond.notify_all()

    def _warm_loop(self) -> None:
        while True:
            with self._warm_cond:
                if not self._warm_queue:
                    self._warm_thread = None
                    return
                ps = self._warm_queue.pop(0)
            seen = len(ps.failures)
            try:
                ps.warm()
            except Exception:  # noqa: BLE001 — recorded below, never hidden
                # a failed background warm must not kill the warmer; the
                # affected bucket stays unready and dispatch falls forward
                # to a larger warm bucket.  Every failure is kept with its
                # exception and counted in stats().warmup.
                with self._warm_cond:
                    self._warm_failures.extend(ps.failures[seen:])
            finally:
                with self._warm_cond:
                    self._warm_pending -= 1
                    if self._warm_pending == 0:
                        self._warm_cond.notify_all()

    def wait_warm(self, timeout: float = 60.0) -> bool:
        """Block until background bucket warmup has drained (True) or
        ``timeout`` seconds elapsed (False).  Serving is already correct
        before this returns — it gates only full-bucket-granularity
        batching, not correctness."""
        with self._warm_cond:
            return self._warm_cond.wait_for(
                lambda: self._warm_pending == 0, timeout=timeout
            )

    def _release_program_sets(self, compiled: CompiledPlan | None) -> None:
        """Unpin a replaced plan's warm programs — pins live only while
        their plan is bound; the programs stay cached but become evictable.
        A program no bound set still pins drops its captured CUDA graph, so
        the graph's memory pool is freed; a later warm captures it anew."""
        if compiled is None:
            return
        cache = self._device_programs
        for ps in compiled.program_sets:
            for key in ps.keys():
                cache.unpin(key)
            ps.release(keep=lambda prog: cache.pinned(prog.key))

    def _compile_placement(
        self, plan: QueryPlan, placement: Placement, coeff: Any = _COEFF_FROM_PLAN
    ) -> CompiledPlan:
        old = self._compiled
        self._compiled = self._build_compiled(plan, placement, coeff=coeff)
        # unpin AFTER the rebuild: programs shared between the plans stay
        # pinned across the swap instead of racing an eviction window
        self._release_program_sets(old)
        return self._compiled

    # --------------------------------------------------------------- tenants
    def tenant_plan(self, tenant: str) -> QueryPlan:
        """The plan serving ``tenant``: its pinned model's best feasible
        plan, or the shared selected plan when the tenant pins nothing."""
        cfg = self._tenant_cfgs.get(tenant)
        if cfg is None or cfg.model is None:
            return self.plan()
        if tenant not in self._tenant_plans:
            plans = [p for p in self.planner().generate() if p.model.name == cfg.model]
            if self.config.min_accuracy is not None:
                ok = [p for p in plans if p.estimate.accuracy >= self.config.min_accuracy]
                plans = ok or plans  # fall back: a pinned model must serve
            if not plans:
                raise ValueError(f"tenant {tenant!r}: no feasible plan for {cfg.model!r}")
            self._tenant_plans[tenant] = max(plans, key=lambda p: p.estimate.throughput)
        return self._tenant_plans[tenant]

    def compile_tenant(self, tenant: str, force: bool = False) -> CompiledPlan:
        """Compiled plan for one tenant.  Model-pinned tenants get their own
        program (and their own Recalibrator — per-tenant splits); everyone
        else shares the default compiled plan."""
        cfg = self._tenant_cfgs.get(tenant)
        if cfg is None or cfg.model is None:
            return self.compile()
        if tenant not in self._tenant_compiled or force:
            plan = self.tenant_plan(tenant)
            old = self._tenant_compiled.get(tenant)
            self._tenant_compiled[tenant] = self._build_compiled(plan, plan.placement)
            self._release_program_sets(old)
            self._tenant_recals[tenant] = self._make_recalibrator(plan)
        return self._tenant_compiled[tenant]

    def engine(self) -> PipelinedEngine:
        compiled = self.compile()
        if compiled.engine is None:
            compiled.engine = PipelinedEngine(
                compiled.host_fn,
                compiled.device_fn,
                compiled.out_shape,
                compiled.out_dtype,
                batch_size=self.config.batch_size,
                num_workers=self._num_workers,
                memory=self.config.memory,
                telemetry=self.telemetry,
                double_buffer=self.config.double_buffer,
                program_set=(
                    compiled.program_sets[0] if compiled.program_sets else None
                ),
            )
            if self.config.tenants:
                # per-tenant children of the engine budget: batch-path
                # admission charges the tenant that decoded the bytes
                compiled.engine.configure_tenants(self.config.tenants)
        compiled.engine.num_workers = self._num_workers
        return compiled.engine

    # ---------------------------------------------------------- recalibrate
    def recalibrate(self, measurement: StageMeasurement | EngineStats) -> bool:
        """Feed one stage-occupancy observation back; returns True when the
        split moved (in which case the plan was recompiled)."""
        if self._compiled is None or self._recalibrator is None:
            raise RuntimeError("compile() before recalibrate()")
        if isinstance(measurement, EngineStats):
            measurement = StageMeasurement.from_engine_stats(measurement)
        placement, changed = self._recalibrator.update(
            self._compiled.placement, measurement, coeff=self._compiled.coeff
        )
        self.recalibrations.append(self._recalibrator.events[-1])
        if changed:
            self._compile_placement(
                self._compiled.plan, placement, coeff=self._recalibrator.chosen_coeff
            )
            if self._scheduler is not None:
                # drains in-flight work, then swaps fns + staging signature
                # (the device side is one program, cached so revisited
                # splits swap in without a rebuild)
                self._scheduler.rebind(
                    self._compiled.host_fn,
                    list(self._compiled.device_programs) or self._compiled.device_fn,
                    out_shape=self._compiled.out_shape,
                    out_dtype=self._compiled.out_dtype,
                    program_sets=self._compiled.program_sets or None,
                )
        # second knob: resize the producer pool from the same measurement
        # (no recompile — the engine reads num_workers per run, the
        # scheduler grows/drains its thread set online)
        if self.config.recal.workers and self._worker_recal is not None:
            new_workers, workers_changed = self._worker_recal.update(measurement)
            self.worker_recalibrations.append(self._worker_recal.events[-1])
            if workers_changed:
                self._num_workers = new_workers
                if self._compiled is not None and self._compiled.engine is not None:
                    self._compiled.engine.num_workers = new_workers
                if self._scheduler is not None:
                    self._scheduler.resize_workers(new_workers)
        return changed

    # --------------------------------------------------------------- running
    def run(
        self,
        corpus: Sequence[Any],
        return_outputs: bool = True,
        tenants: Sequence[str] | None = None,
    ) -> tuple[list[Any], RunReport]:
        """Batch path: plan → place → pipeline the whole corpus.

        With ``config.recalibrate_every = k > 0`` the corpus is processed in
        k-item chunks and the split is re-solved between chunks from the
        engine's measured stage occupancy (adaptive §6.3).  ``tenants``
        (one name per item) runs the corpus multi-tenant: byte admission
        charges each item's tenant and the stats carry per-tenant staging
        accounting.
        """
        compiled = self.compile()
        n_before = len(self.recalibrations)
        chunk = self.config.recal.every
        if chunk <= 0 or chunk >= len(corpus):
            outputs, stats = self.engine().run(
                corpus, return_outputs=return_outputs, tenants=tenants
            )
            chunk_stats = [stats]
        else:
            outputs = []
            chunk_stats = []
            for lo in range(0, len(corpus), chunk):
                part = corpus[lo : lo + chunk]
                part_tenants = tenants[lo : lo + chunk] if tenants is not None else None
                out, stats = self.engine().run(
                    part, return_outputs=return_outputs, tenants=part_tenants
                )
                outputs.extend(out)
                chunk_stats.append(stats)
                if lo + chunk < len(corpus):
                    self.recalibrate(stats)
            stats = EngineStats(
                "pipelined",
                sum(s.num_items for s in chunk_stats),
                sum(s.wall_seconds for s in chunk_stats),
                sum(s.batches for s in chunk_stats),
                host_busy_seconds=sum(s.host_busy_seconds for s in chunk_stats),
                device_busy_seconds=sum(s.device_busy_seconds for s in chunk_stats),
            )
        report = RunReport(
            plan_key=compiled.plan.key,
            stats=stats,
            chunk_stats=chunk_stats,
            recalibrations=self.recalibrations[n_before:],
        )
        return outputs, report

    # --------------------------------------------------------------- serving
    def start_serving(self) -> None:
        compiled = self.compile()
        if self._scheduler is None:
            mem = self.config.memory
            targets = self._replica_targets()
            self._scheduler = RequestScheduler(
                compiled.host_fn,
                # one compiled program per replica (replica 0's program is
                # the same one the batch-path engine gets)
                list(compiled.device_programs) or compiled.device_fn,
                compiled.out_shape,
                compiled.out_dtype,
                max_batch=self.config.batch_size,
                num_workers=self._num_workers,
                max_wait_ms=self.config.max_wait_ms,
                max_pending=mem.max_pending,
                admission=mem.admission,
                admission_timeout_s=mem.admission_timeout_s,
                # the budget built at __init__ — the rendition cache is a
                # child of the same hierarchy, so cache residency and
                # in-flight admission share one accounting root
                budget=self._serving_budget,
                tenants=self.config.tenants,
                num_replicas=len(targets),
                replica_labels=[self._target_label(t) for t in targets],
                telemetry=self.telemetry,
                program_sets=compiled.program_sets or None,
            )
            # tenants pinning their own model serve through their own
            # compiled plan: batches never mix across bindings
            for tcfg in self.config.tenants:
                if tcfg.model is not None:
                    tc = self.compile_tenant(tcfg.name)
                    self._scheduler.bind_tenant(
                        tcfg.name,
                        tc.host_fn,
                        list(tc.device_programs) or tc.device_fn,
                        tc.out_shape,
                        tc.out_dtype,
                        program_sets=tc.program_sets or None,
                    )
        self._scheduler.start()
        # everything compiled from here on is a post-warmup (request-path)
        # compile — the observability counters and the bench gate key on it
        self._warmup_done = True

    def fail_replica(self, index: int) -> None:
        """Fault hook: take serving replica ``index`` out of the mesh (see
        :meth:`RequestScheduler.fail_replica`)."""
        if self._scheduler is None:
            raise RuntimeError("start_serving() before fail_replica()")
        self._scheduler.fail_replica(index)

    def submit(
        self, item: Any, tenant: str = DEFAULT_TENANT
    ) -> int | AggregationQueryResult:
        """Submit one typed query (§3.2 query classes).

        - :class:`ClassificationQuery` — returns the uid; ``drain()``
          yields a :class:`ClassificationResult`.
        - :class:`CascadeQuery` — returns the uid; stage 1 serves from the
          cheap scaled rendition and uncertain items are internally
          refetched at full resolution; ``drain()`` yields a
          :class:`CascadeQueryResult` (prediction + exit stage).
        - :class:`AggregationQuery` — runs synchronously (the full cheap
          scan plus sampled target refetches ride the serving scheduler)
          and returns the :class:`AggregationQueryResult` directly.

        Bare (non-Query) items keep the pre-PR-9 behaviour — submitted to
        the tenant's plan target, drained as raw ``CompletedRequest`` — via
        a deprecation alias that warns once per runtime.
        """
        if self._scheduler is None:
            raise RuntimeError("start_serving() before submit()")
        if isinstance(item, Query):
            if isinstance(item, ClassificationQuery):
                uid = self._scheduler.submit(item.image, tenant=tenant)
                self._typed_queries[uid] = "classify"
                return uid
            if isinstance(item, CascadeQuery):
                return self._submit_cascade(item, tenant)
            if isinstance(item, AggregationQuery):
                return self._run_aggregation(item, tenant)
            raise TypeError(f"unsupported query type: {type(item).__name__}")
        if not self._legacy_submit_warned:
            self._legacy_submit_warned = True
            warnings.warn(
                "bare-image submit() is deprecated; wrap the item in a typed "
                "query (ClassificationQuery / CascadeQuery / AggregationQuery)"
                " — warned once per runtime",
                DeprecationWarning,
                stacklevel=2,
            )
        return self._scheduler.submit(item, tenant=tenant)

    def drain(
        self, timeout: float | None = None
    ) -> list[CompletedRequest | QueryResult]:
        """Completed requests since the last call, in uid order.

        Typed queries come back as :class:`QueryResult` subclasses; bare
        legacy submissions stay raw ``CompletedRequest`` objects.
        """
        if self._scheduler is None:
            raise RuntimeError("start_serving() before drain()")
        done = self._scheduler.drain(timeout=timeout)
        if not self._typed_queries:
            return done
        out: list[CompletedRequest | QueryResult] = []
        for r in done:
            kind = self._typed_queries.pop(r.uid, None)
            if kind is None:
                out.append(r)
                continue
            scores = None if r.error is not None else np.asarray(r.output)
            pred = int(np.argmax(scores)) if scores is not None else None
            if kind == "classify":
                out.append(
                    ClassificationResult(
                        uid=r.uid,
                        tenant=r.tenant,
                        latency=r.latency,
                        error=r.error,
                        prediction=pred,
                        scores=scores,
                    )
                )
            else:  # cascade
                exit_stage, refetched = self._cascade_results.pop(r.uid, (0, False))
                out.append(
                    CascadeQueryResult(
                        uid=r.uid,
                        tenant=r.tenant,
                        latency=r.latency,
                        error=r.error,
                        prediction=pred,
                        scores=scores,
                        exit_stage=exit_stage,
                        refetched=refetched,
                    )
                )
        return out

    # ------------------------------------------------- cascades & aggregates
    def _binding_for(self, compiled: CompiledPlan) -> Any:
        """A scheduler binding dispatching through ``compiled``'s programs."""
        return self._scheduler.make_binding(
            compiled.host_fn,
            list(compiled.device_programs) or compiled.device_fn,
            compiled.out_shape,
            compiled.out_dtype,
            program_sets=compiled.program_sets or None,
        )

    def _plan_for_model(self, model: str | None, tenant: str) -> QueryPlan:
        """Best feasible plan for one cascade stage's model (``None`` = the
        tenant's own plan) — same resolution rule as pinned tenants."""
        if model is None:
            return self.tenant_plan(tenant)
        plans = [p for p in self.planner().generate() if p.model.name == model]
        if self.config.min_accuracy is not None:
            ok = [p for p in plans if p.estimate.accuracy >= self.config.min_accuracy]
            plans = ok or plans  # a named stage model must serve
        if not plans:
            raise ValueError(f"cascade stage: no feasible plan for model {model!r}")
        return max(plans, key=lambda p: p.estimate.throughput)

    def _coeff_cost_args(self, plan: QueryPlan) -> dict[str, Any]:
        device_rate = self.config.device_ops_per_sec or (
            self.config.host_ops_per_sec * DEFAULT_DEVICE_SPEEDUP
        )
        return dict(
            host_entropy_time=self._entropy_time(plan.fmt),
            dnn_device_time=1.0 / plan.model.exec_throughput,
            device_ops_per_sec=device_rate,
            device_dispatch_overhead_s=self._dispatch_overhead(),
        )

    def _cheap_option(self, plan: QueryPlan, factor: int) -> SplitDecodeOption | None:
        """The split-decode option pricing ``plan`` at one scaled factor
        (None when the stream is ineligible or the factor invalid)."""
        geom = self._coeff_geometry(plan.fmt)
        if geom is None or geom.channels != 3:
            return None
        opts = placement_mod.enumerate_coeff_options(
            list(plan.dag_plan.ops),
            geom,
            factors=(factor,),
            **self._coeff_cost_args(plan),
        )
        return opts[0] if opts else None

    def _cheap_compiled(self, plan: QueryPlan) -> tuple[CompiledPlan, int, tuple[int, ...]]:
        """Cheap-stage target: scaled split decode at the planner-chosen
        reduced factor; ineligible streams (non-SJPG, grayscale) fall back
        to the plan's own compiled path.  Returns
        ``(compiled, factor, candidate_factors)``."""
        geom = self._coeff_geometry(plan.fmt)
        if geom is not None and geom.channels != 3:
            geom = None
        if geom is None:
            return self._build_compiled(plan, plan.placement), 1, (1,)
        chain = list(plan.dag_plan.ops)
        cost_args = self._coeff_cost_args(plan)
        options = placement_mod.enumerate_coeff_options(chain, geom, **cost_args)
        if not options:
            return self._build_compiled(plan, plan.placement), 1, (1,)
        chosen = placement_mod.choose_coeff_option(
            chain, geom, policy="scaled", **cost_args
        )
        if chosen is None or chosen.factor == 1:
            # no reduced factor fits this stream (e.g. a pre-scaled stored
            # rendition already near the resize target): the cheap stage IS
            # the plan's own pixel path — a full-res coefficient program
            # would only move the IDCT onto the device, not shrink the work
            return self._build_compiled(plan, plan.placement), 1, (1,)
        compiled = self._build_compiled(plan, plan.placement, coeff=chosen)
        if compiled.coeff is None:  # the stream refused the coeff program
            return compiled, 1, (1,)
        candidates = tuple(sorted({o.factor for o in options}))
        return compiled, compiled.coeff.factor, candidates

    def _expensive_compiled(self, plan: QueryPlan) -> CompiledPlan:
        """Full-resolution stage target for cascade/aggregation refetches.

        Without the rendition cache this is the plan's own pixel path.
        With it, the stage compiles as a *factor-1 coefficient* program
        when the stream is eligible: the staged tensor is factor-invariant
        and its cache key carries no factor, so a refetched item's host
        stage is a pure hit on the entry the cheap scaled stage already
        admitted — full resolution without a second entropy decode.
        """
        if self._rendition_cache is not None:
            option = self._cheap_option(plan, 1)
            if option is not None:
                compiled = self._build_compiled(plan, plan.placement, coeff=option)
                if compiled.coeff is not None:
                    return compiled
        return self._build_compiled(plan, plan.placement, coeff=None)

    def _cascade_ctx(self, tenant: str, query: CascadeQuery) -> _CascadeContext:
        stage0, stage1 = query.stages
        key = (tenant, stage0.model, stage1.model, stage0.threshold)
        ctx = self._cascades.get(key)
        if ctx is not None:
            return ctx
        cheap_plan = self._plan_for_model(stage0.model, tenant)
        exp_plan = self._plan_for_model(stage1.model, tenant)
        cheap, factor, candidates = self._cheap_compiled(cheap_plan)
        # the expensive stage serves the full-resolution tensor — a
        # different compiled target (and ProgramSet bucket family) than the
        # cheap scaled program, so refetches land on warm programs.  With
        # the rendition cache on it compiles factor-1 split decode, whose
        # host stage reuses the stage-0 cached coefficient entry.
        expensive = self._expensive_compiled(exp_plan)
        recal = CascadeRecalibrator(
            factor,
            stage0.threshold,
            candidates=candidates,
            alpha=self.config.recal.alpha,
            hysteresis=self.config.recal.hysteresis,
            tenant=tenant,
        )
        ctx = _CascadeContext(
            tenant,
            stage0.threshold,
            cheap,
            expensive,
            self._binding_for(cheap),
            self._binding_for(expensive),
            factor,
            candidates,
            recal,
        )
        self._cascades[key] = ctx
        return ctx

    def _submit_cascade(self, query: CascadeQuery, tenant: str) -> int:
        """Stage 1 on the cheap rendition; uncertain items refetch.

        The stage-0 route's ``on_result`` inspects the max-softmax
        confidence inside the scheduler's completion path: confident items
        exit with the cheap scores, the rest return a (full-res item,
        stage-1 route) directive and the scheduler resubmits them to the
        expensive binding under the same uid/tenant (uid order and fair-
        share billing both survive the refetch).
        """
        ctx = self._cascade_ctx(tenant, query)
        image = query.image
        results = self._cascade_results

        def on_stage1(uid: int, out: Any):
            with ctx.lock:
                ctx.stage_items[1] += 1
                ctx.stage_exits[1] += 1
            return None

        def on_stage0(uid: int, out: Any):
            _, conf = _softmax_conf(np.asarray(out)[None, :])
            passed = float(conf[0]) < ctx.threshold
            with ctx.lock:
                ctx.stage_items[0] += 1
                ctx.win_items += 1
                if passed:
                    ctx.refetched += 1
                    ctx.win_refetched += 1
                else:
                    ctx.stage_exits[0] += 1
            if not passed:
                results[uid] = (0, False)
                return None
            results[uid] = (1, True)
            return image, RequestRoute(
                binding=ctx.expensive_binding, on_result=on_stage1, stage=1
            )

        uid = self._scheduler.submit(
            image,
            tenant=tenant,
            route=RequestRoute(
                binding=ctx.cheap_binding, on_result=on_stage0, stage=0
            ),
        )
        self._typed_queries[uid] = "cascade"
        return uid

    def _scan(
        self,
        items: Sequence[Any],
        binding: Any,
        tenant: str,
        value_fn: Callable[[np.ndarray], float],
        timeout: float = 600.0,
    ) -> np.ndarray:
        """Score ``items`` through one routed binding, returning
        ``value_fn`` of each score row in submission order.  Results come
        back through per-item sinks (out-of-band of ``drain()``), so an
        aggregation query never perturbs concurrent serving consumers."""
        n = len(items)
        vals = np.zeros(n, dtype=np.float64)
        if n == 0:
            return vals
        errs: list[BaseException] = []
        remaining = [n]
        lock = threading.Lock()
        all_done = threading.Event()

        def make_sink(i: int):
            def sink(uid: int, out: Any, err: BaseException | None) -> None:
                with lock:
                    if err is not None:
                        errs.append(err)
                    else:
                        vals[i] = value_fn(np.asarray(out))
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        all_done.set()

            return sink

        for i, item in enumerate(items):
            self._scheduler.submit(
                item, tenant=tenant, route=RequestRoute(binding=binding, sink=make_sink(i))
            )
        if not all_done.wait(timeout=timeout):
            raise RuntimeError(
                f"aggregation scan timed out: {remaining[0]}/{n} items outstanding"
            )
        if errs:
            raise errs[0]
        return vals

    def _run_aggregation(
        self, query: AggregationQuery, tenant: str
    ) -> AggregationQueryResult:
        """The s(x) full scan rides the cheapest rendition over the whole
        corpus; ``control_variate_aggregate`` then drives sampled target-
        model refetches at full resolution until the CI closes."""
        t0 = time.perf_counter()
        ctx = self._agg_targets.get(tenant)
        if ctx is None:
            plan = self.tenant_plan(tenant)
            cheap, _factor, _cands = self._cheap_compiled(plan)
            expensive = self._expensive_compiled(plan)
            ctx = (cheap, expensive, self._binding_for(cheap), self._binding_for(expensive))
            self._agg_targets[tenant] = ctx
        _cheap, _expensive, cheap_binding, exp_binding = ctx
        value_fn = query.value_fn or (lambda row: float(np.argmax(row)))
        corpus = list(query.corpus)
        s_all = self._scan(corpus, cheap_binding, tenant, value_fn)

        def target_fn(indices: np.ndarray) -> np.ndarray:
            sel = [corpus[i] for i in np.asarray(indices).tolist()]
            return self._scan(sel, exp_binding, tenant, value_fn)

        res = control_variate_aggregate(
            s_all,
            target_fn,
            eps=query.eps,
            delta=query.delta,
            batch=query.batch,
            min_samples=query.min_samples,
            max_samples=query.max_samples,
            seed=query.seed,
        )
        return AggregationQueryResult(
            uid=-1,
            tenant=tenant,
            latency=time.perf_counter() - t0,
            estimate=res.estimate,
            ci_halfwidth=res.ci_halfwidth,
            num_target_invocations=res.num_target_invocations,
            num_specialized_invocations=res.num_specialized_invocations,
            variance_reduction=res.variance_reduction,
        )

    def cascade_recalibrate(self, tenant: str = DEFAULT_TENANT) -> bool:
        """Re-pick the cascade's cheap-stage decode factor from the pass-
        through rate measured since the last call.

        The measured window combines the cascade exit counters with the
        tenant's telemetry occupancy window (its own consumer key — the
        split recalibrator's window is untouched): the expensive stage is
        priced from the planner estimate and the cheap stage from the
        measured occupancy net of the refetch share.  On a factor move the
        cheap stage is recompiled at the new factor and the stage binding
        swapped in place; in-flight routes finish on the old programs.
        """
        ctx = None
        for key in reversed(list(self._cascades)):
            if key[0] == tenant:
                ctx = self._cascades[key]
                break
        if ctx is None:
            raise RuntimeError(f"no cascade has served tenant {tenant!r}")
        host_busy, _h_items, dev_busy, _d_items = self.telemetry.measurement_window(
            ("cascade", id(self)), tenant
        )
        with ctx.lock:
            items, refetched = ctx.win_items, ctx.win_refetched
            ctx.win_items = 0
            ctx.win_refetched = 0
        if items <= 0:
            return False
        full_spi = 1.0 / max(ctx.expensive.plan.estimate.throughput, 1e-9)
        total_busy = host_busy + dev_busy
        if total_busy > 0:
            # window busy-time = items*cheap + refetched*full, solved for cheap
            cheap_spi = max((total_busy - refetched * full_spi) / items, 1e-9)
        else:
            cheap_spi = 1.0 / max(ctx.cheap.plan.estimate.throughput, 1e-9)
        ctx.recal.observe(ctx.factor, items, refetched, cheap_spi, full_spi)
        n_events = len(ctx.recal.events)
        new_factor, changed = ctx.recal.update()
        if changed:
            # factor 1 is the pixel path, not a full-res coefficient program
            option = (
                self._cheap_option(ctx.cheap.plan, new_factor)
                if new_factor > 1
                else None
            )
            if option is None and new_factor > 1:
                changed = False  # stream can't serve that factor: hold
                ctx.recal.factor = ctx.factor
            else:
                old = ctx.cheap
                fresh = self._build_compiled(
                    ctx.cheap.plan, ctx.cheap.plan.placement, coeff=option
                )
                ctx.cheap = fresh
                ctx.cheap_binding = self._binding_for(fresh)
                self._release_program_sets(old)
                ctx.factor = new_factor
        if len(ctx.recal.events) > n_events:
            event = ctx.recal.events[-1]
            if not changed and event.changed:
                event = dataclasses.replace(event, new_factor=event.old_factor)
            self.cascade_recalibrations.append(event)
        return changed

    def flush(self, timeout: float = 60.0) -> None:
        if self._scheduler is not None:
            self._scheduler.flush(timeout=timeout)

    def stop_serving(self) -> None:
        if self._scheduler is not None:
            self._scheduler.stop()
        # cascade/aggregation stage targets pin their own warm programs;
        # drop the pins when serving stops (contexts rebuild lazily)
        for ctx in self._cascades.values():
            self._release_program_sets(ctx.cheap)
            self._release_program_sets(ctx.expensive)
        for cheap, expensive, _cb, _eb in self._agg_targets.values():
            self._release_program_sets(cheap)
            self._release_program_sets(expensive)
        self._cascades.clear()
        self._agg_targets.clear()

    def serving_recalibrate(self, tenant: str | None = None) -> bool:
        """Recalibrate a split from the serving scheduler's measurements.

        ``tenant=None`` (or a tenant sharing the default plan) feeds the
        scheduler-wide window into the shared recalibrator.  A model-pinned
        tenant recalibrates from *its own* measurement window against its
        own Recalibrator — per-tenant splits — and rebinds only that
        tenant's plan on a move.
        """
        if self._scheduler is None:
            raise RuntimeError("start_serving() before serving_recalibrate()")
        cfg = self._tenant_cfgs.get(tenant) if tenant is not None else None
        if cfg is None or cfg.model is None:
            return self.recalibrate(self._scheduler.measurement(tenant))
        compiled = self.compile_tenant(tenant)
        recal = self._tenant_recals[tenant]
        measurement = self._scheduler.measurement(tenant)
        placement, changed = recal.update(compiled.placement, measurement, coeff=compiled.coeff)
        self.recalibrations.append(dataclasses.replace(recal.events[-1], tenant=tenant))
        if changed:
            fresh = self._build_compiled(compiled.plan, placement, coeff=recal.chosen_coeff)
            self._tenant_compiled[tenant] = fresh
            self._release_program_sets(compiled)
            self._scheduler.bind_tenant(
                tenant,
                fresh.host_fn,
                list(fresh.device_programs) or fresh.device_fn,
                fresh.out_shape,
                fresh.out_dtype,
                program_sets=fresh.program_sets or None,
            )
        return changed

    # ----------------------------------------------------------------- stats
    @property
    def num_workers(self) -> int:
        """Live producer-pool size (tracks the recalibration knob)."""
        return self._num_workers

    def stats(self) -> RuntimeStats:
        """Versioned, typed snapshot across the runtime's hot paths.

        Returns :class:`~repro_torch.runtime.stats.RuntimeStats` —
        ``schema_version``, per-tenant sections, the replica ``mesh``
        section (per-replica dispatch counters + the elastic plan after a
        failure), ``program_cache`` counters, the compiled
        ``device_program``, the ``split_decode`` outcome, and engine/
        scheduler memory occupancy.  ``stats().to_dict()`` is the JSON-safe
        wire form; dict-style access still resolves with a
        ``DeprecationWarning``.
        """
        tenants: dict[str, TenantSection] = {}
        scheduler_section: SchedulerSection | None = None
        mesh_section: MeshSection | None = None
        if self._scheduler is not None:
            sched = self._scheduler
            for name, tstats in sched.tenants.items():
                tbudget = sched.tenant_budget(name)
                cfg = self._tenant_cfgs.get(name)
                compiled = (
                    self._tenant_compiled.get(name)
                    if cfg is not None and cfg.model is not None
                    else self._compiled
                )
                tenants[name] = TenantSection(
                    stats=dataclasses.replace(tstats),
                    budget=tbudget.stats() if tbudget is not None else None,
                    plan=compiled.plan.key if compiled is not None else None,
                    split=compiled.placement.split if compiled is not None else None,
                )
            scheduler_section = SchedulerSection(
                stats=dataclasses.replace(sched.stats),
                budget=sched.budget.stats() if sched.budget is not None else None,
            )
            mesh_section = MeshSection(
                replicas=tuple(sched.replica_snapshots()),
                alive=sched.alive_replicas,
                sharded=self.config.mesh.sharded,
                elastic_plan=sched.elastic_plan,
            )
        device_program = None
        if self._compiled is not None and self._compiled.device_program is not None:
            prog = self._compiled.device_program
            device_program = DeviceProgramSection(
                backend=prog.backend,
                impl=prog.impl,
                fused=prog.fused,
                stages=tuple(prog.stages),
                dispatch_count=prog.dispatch_count,
                dispatches_per_batch=prog.dispatches_per_batch,
            )
        split_decode = None
        if self.config.device.split_decode != "off" and self._compiled is not None:
            coeff = self._compiled.coeff
            split_decode = SplitDecodeSection(
                policy=self.config.device.split_decode,
                # factor 0 = the plan fell back to the pixel path
                factor=coeff.factor if coeff is not None else 0,
                point=coeff.point if coeff is not None else 0,
                layout=coeff.layout if coeff is not None else None,
                staging_bytes=coeff.staging_bytes if coeff is not None else 0,
            )
        engine = self._compiled.engine if self._compiled is not None else None
        engine_section = (
            EngineSection(pool=engine.pool_stats(), budget=engine.budget_stats())
            if engine is not None
            else None
        )
        cascade_section = None
        if self._cascades:
            ctxs = list(self._cascades.values())
            items = [0, 0]
            exits = [0, 0]
            refetched = 0
            for ctx in ctxs:
                for s in range(2):
                    items[s] += ctx.stage_items[s]
                    exits[s] += ctx.stage_exits[s]
                refetched += ctx.refetched
            latest = ctxs[-1]
            cascade_section = CascadeSection(
                stages=(
                    CascadeStageStats(0, items[0], exits[0], 1.0),
                    CascadeStageStats(
                        1,
                        items[1],
                        exits[1],
                        items[1] / items[0] if items[0] else 0.0,
                    ),
                ),
                refetched_items=refetched,
                factor=latest.factor,
                threshold=latest.threshold,
            )
        cache_section = None
        if self._rendition_cache is not None:
            cs = self._rendition_cache.stats()
            cache_section = CacheSection(
                hits=cs.hits,
                misses=cs.misses,
                evictions=cs.evictions,
                admitted=cs.admitted,
                rejected=cs.rejected,
                resident_bytes=cs.resident_bytes,
                resident_entries=cs.resident_entries,
                capacity_bytes=cs.capacity_bytes,
                bytes_saved=cs.bytes_saved,
                seconds_saved=cs.seconds_saved,
                tenants={
                    name: CacheTenantSection(
                        hits=t.hits, misses=t.misses, bytes_saved=t.bytes_saved
                    )
                    for name, t in cs.tenants.items()
                },
            )
        digest = self.telemetry.summary()
        latency = LatencySection(stages=digest["stages"], tenants=digest["tenants"])
        return RuntimeStats(
            num_workers=self._num_workers,
            measured_dispatch_overhead_s=self._measured_dispatch_s,
            program_cache=self._device_programs.stats(),
            engine=engine_section,
            scheduler=scheduler_section,
            tenants=tenants,
            mesh=mesh_section,
            device_program=device_program,
            split_decode=split_decode,
            latency=latency,
            cascade=cascade_section,
            cache=cache_section,
            warmup=self._warmup_section(),
            programs_compiled_post_warmup=self._programs_compiled_post_warmup,
            program_compile_seconds_total=self._program_compile_seconds,
        )

    def _warmup_section(self) -> WarmupSection | None:
        if self.config.warmup == "off":
            return None
        with self._warm_cond:
            failed = list(self._warm_failures)
        compiled = self._compiled
        ps = compiled.program_sets[0] if compiled is not None and compiled.program_sets else None
        graphs = ps.graphs() if ps is not None else {}
        return WarmupSection(
            mode=self.config.warmup,
            buckets=ps.buckets if ps is not None else (),
            ready=(
                tuple(b for b, p in ps.programs.items() if ps._is_ready(p))
                if ps is not None
                else ()
            ),
            fully_warm=ps.fully_warm if ps is not None else False,
            failures=len(failed),
            errors=tuple(f"bucket {b}: {type(e).__name__}: {e}" for b, e in failed),
            graphs={b: g.capture_seconds for b, g in graphs.items()},
            replays={b: g.replays for b, g in graphs.items()},
        )

    # ------------------------------------------------------------- telemetry
    def dump_trace(self, path: str) -> int:
        """Write captured request/batch spans as Chrome trace-event JSON
        (load in Perfetto / ``chrome://tracing``).  Requires span capture
        (``RuntimeConfig.telemetry.spans=True``); returns the span count
        written (0 when capture is off or nothing was sampled)."""
        return self.telemetry.dump_trace(path)

    def metrics_text(self) -> str:
        """Prometheus text exposition: the per-stage/per-tenant latency
        histograms plus the runtime's request counters — one string, ready
        to serve from a ``/metrics`` endpoint."""
        extra: list[str] = []
        if self._scheduler is not None:
            extra.append(
                "# HELP smol_requests_total Requests by tenant and terminal state."
            )
            extra.append("# TYPE smol_requests_total counter")
            for name, ts in sorted(self._scheduler.tenants.items()):
                for status, count in (
                    ("completed", ts.completed),
                    ("failed", ts.failed),
                    ("rejected", ts.rejected),
                ):
                    extra.append(
                        f'smol_requests_total{{tenant="{name}",status="{status}"}} '
                        f"{count}"
                    )
        cache = self._device_programs.stats()
        extra.append("# HELP smol_program_cache_events_total Program-cache events.")
        extra.append("# TYPE smol_program_cache_events_total counter")
        for event, count in (
            ("hit", cache.hits),
            ("miss", cache.misses),
            ("eviction", cache.evictions),
        ):
            extra.append(
                f'smol_program_cache_events_total{{event="{event}"}} {count}'
            )
        extra.append(
            "# HELP smol_programs_compiled_post_warmup_total Device programs "
            "JIT-compiled on the request path after warmup finished (0 under "
            "warmup=full in steady state)."
        )
        extra.append("# TYPE smol_programs_compiled_post_warmup_total counter")
        extra.append(
            f"smol_programs_compiled_post_warmup_total "
            f"{self._programs_compiled_post_warmup}"
        )
        extra.append(
            "# HELP smol_program_compile_seconds_total Cumulative build + "
            "first-dispatch compile seconds across all device programs."
        )
        extra.append("# TYPE smol_program_compile_seconds_total counter")
        extra.append(
            f"smol_program_compile_seconds_total "
            f"{self._program_compile_seconds:.6f}"
        )
        if self._rendition_cache is not None:
            cs = self._rendition_cache.stats()
            extra.append(
                "# HELP smol_rendition_cache_events_total Rendition-cache "
                "events by kind."
            )
            extra.append("# TYPE smol_rendition_cache_events_total counter")
            for event, count in (
                ("hit", cs.hits),
                ("miss", cs.misses),
                ("eviction", cs.evictions),
                ("admission", cs.admitted),
                ("rejection", cs.rejected),
            ):
                extra.append(
                    f'smol_rendition_cache_events_total{{event="{event}"}} {count}'
                )
            extra.append(
                "# HELP smol_rendition_cache_resident_bytes Bytes resident "
                "in the rendition cache."
            )
            extra.append("# TYPE smol_rendition_cache_resident_bytes gauge")
            extra.append(f"smol_rendition_cache_resident_bytes {cs.resident_bytes}")
            extra.append(
                "# HELP smol_rendition_cache_saved_seconds_total Measured "
                "host decode seconds cache hits skipped."
            )
            extra.append("# TYPE smol_rendition_cache_saved_seconds_total counter")
            extra.append(
                f"smol_rendition_cache_saved_seconds_total {cs.seconds_saved:.6f}"
            )
        return self.telemetry.metrics_text(extra)
