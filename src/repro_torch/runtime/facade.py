"""SmolRuntime — the end-to-end batch query runtime, on torch/CUDA.

One object owns the vertical slice the paper describes:

    spec (𝒟 models, ℱ formats, constraints)
      └─ plan      Planner.generate/select over 𝒟 × ℱ          (§3)
      └─ place     choose_split: host ops vs device ops         (§6.3)
      └─ compile   host_fn / device program for the placement
      └─ execute   PipelinedEngine batch run                    (§6.1)

Model execution is supplied as ``model_fns[name] -> callable`` taking an
(N, C, H, W) float32 tensor on the runtime's device; everything upstream of
that call (decode, preprocessing, placement, batching, pipelining) is the
runtime's job.

This port covers the batch path of ``repro.runtime.facade.SmolRuntime``.
The reference's serving path, online recalibration, program-set warmup,
replica mesh, tenants, telemetry and rendition cache keep their config
fields and raise :class:`NotImplementedError` naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.core.placement import SPLIT_DECODE_POLICIES, Placement, SplitDecodeOption
from repro_torch.core.planner import ModelSpec, Planner, QueryPlan
from repro_torch.device import resolve_device
from repro_torch.preprocessing import ops as P
from repro_torch.preprocessing.formats import ImageFormat, StoredImage
from repro_torch.preprocessing.ops import TensorMeta
from repro_torch.runtime.memory import MemoryConfig


def _not_ported(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet (ROADMAP.md, port queue: {item})"
    )


_ITEM_RECAL = "'Recalibration + ProgramSet warmup'"
_ITEM_SERVING = "'Serving path'"
_ITEM_MESH = "'Mesh'"


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
    """Online-recalibration knobs (§6.3).  ``every > 0`` is not ported yet.

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
    """Replicated multi-device serving.  Only the default (one replica, no
    explicit devices, unsharded) is ported."""

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
    """Runtime configuration: flat planning knobs + typed sub-configs for
    the device compiler (``device``), online recalibration (``recal``) and
    the replica mesh (``mesh``) — the reference's fields, so a config
    carries over.  The deprecated flat kwargs still construct, mapped into
    the sub-configs with one aggregated ``DeprecationWarning``.
    """

    batch_size: int = 32
    num_workers: int = 4
    max_wait_ms: float = 5.0  # dynamic-batching latency knob (serving path)
    min_accuracy: float | None = None
    min_throughput: float | None = None
    estimator: str = "smol"
    host_ops_per_sec: float = 2.0e9
    device_ops_per_sec: float | None = None
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    device: DeviceCompilerConfig = dataclasses.field(default_factory=DeviceCompilerConfig)
    recal: RecalConfig = dataclasses.field(default_factory=RecalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # tracing + metrics (the reference's TelemetryConfig): not ported — None
    telemetry: Any = None
    # multi-tenant serving (the reference's TenantConfigs): not ported — ()
    tenants: tuple = ()
    program_cache_entries: int = 16
    # AOT program-set warmup: only "off" is ported
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
            patch: dict[str, dict[str, Any]] = {}
            for name, value in used.items():
                sub, attr = _LEGACY_CONFIG_ALIASES[name]
                patch.setdefault(sub, {})[attr] = value
            with warnings.catch_warnings():
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
        self.device_backend = self.device.backend
        self.fused_impl = self.device.fused_impl
        self.split_decode = self.device.split_decode
        self.device_dispatch_overhead_s = self.device.dispatch_overhead_s
        self.recalibrate_every = self.recal.every
        self.recal_alpha = self.recal.alpha
        self.recal_hysteresis = self.recal.hysteresis
        self.recal_workers = self.recal.workers
        self.max_recal_workers = self.recal.max_workers


def _check_ported(cfg: RuntimeConfig) -> None:
    """Raise for the configuration a later slice of the port brings."""
    if cfg.recal.every > 0:
        raise _not_ported("online recalibration (RecalConfig.every > 0)", _ITEM_RECAL)
    if cfg.warmup != "off":
        raise _not_ported(f"program-set warmup (warmup={cfg.warmup!r})", _ITEM_RECAL)
    mesh = cfg.mesh
    if mesh.replicas > 1 or mesh.devices is not None or mesh.sharded:
        raise _not_ported("the replica mesh (MeshConfig other than the default)", _ITEM_MESH)
    if cfg.tenants:
        raise _not_ported("multi-tenant runs (RuntimeConfig.tenants)", _ITEM_SERVING)
    if cfg.telemetry is not None:
        raise _not_ported("telemetry (RuntimeConfig.telemetry)", _ITEM_SERVING)
    if cfg.memory.rendition_cache_bytes:
        raise _not_ported("the rendition cache (MemoryConfig.rendition_cache_bytes)", _ITEM_SERVING)


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
    # non-None when this plan runs the split-decode placement: the costed
    # scaled-IDCT factor / staging layout the program was compiled for
    coeff: SplitDecodeOption | None = None
    # built lazily by SmolRuntime.engine()
    engine: PipelinedEngine | None = None


@dataclasses.dataclass
class RunReport:
    plan_key: str
    stats: EngineStats
    chunk_stats: list[EngineStats]
    recalibrations: list[Any]  # always empty until recalibration is ported

    @property
    def throughput(self) -> float:
        return self.stats.throughput


class SmolRuntime:
    """Facade wiring planner → placement → device program → pipelined engine.

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
        _check_ported(cfg)
        self.device = resolve_device(device)
        # fp32 parity with the reference: cuDNN defaults to TF32 convolutions
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.models = list(models)
        self.formats = list(formats)
        self.model_fns = dict(model_fns)
        self.calibration = list(calibration)
        self.config = cfg
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
        # device-program cache keyed on (op specs, in_meta, batch, backend,
        # impl, model, device): revisited plans reuse their program
        self._device_programs = ProgramCache(self.config.program_cache_entries)
        self._measured_dispatch_s: float | None = None

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
        # it memoizes 𝒟 × ℱ generation
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
    def _coeff_stage_fns(self, plan: QueryPlan, coeff: SplitDecodeOption):
        """Split-decode path (§6.4): the host stops after the entropy stage
        and stages one quantized-coefficient tensor per item; the device
        program runs dequant+(scaled-)IDCT onward.  Returns None when the
        plan's stream is not eligible — callers fall back to pixels."""
        fmt = plan.fmt
        if fmt.codec != "jpeg":
            return None
        from repro_torch.preprocessing import jpeg as jpeg_mod

        header = jpeg_mod.peek_header(self.calibration[0].variants[fmt])
        try:
            program = device_compiler.compile_coeff_program(
                header,
                list(plan.dag_plan.ops),
                self.model_fns[plan.model.name],
                self.config.batch_size,
                factor=coeff.factor,
                layout=coeff.layout,
                impl=self.config.device.fused_impl,
                model_key=plan.model.name,
                cache=self._device_programs,
                device=self.device,
            )
        except ValueError:
            return None
        out_shape = tuple(program.in_meta.shape)  # staged_coeff_shape(header, layout)
        out_dtype = np.dtype(program.in_meta.dtype)
        layout = coeff.layout

        def host_fn(item):
            if not hasattr(item, "decode_to_coefficients"):
                raise TypeError("split decode requires StoredImage items with a jpeg variant")
            hdr_i, planes_zz, _, _ = item.decode_to_coefficients(fmt)
            arr = jpeg_mod.stage_coefficients(planes_zz, hdr_i, layout)
            if arr.shape != out_shape:
                raise ValueError(
                    f"entropy stage produced {arr.shape}, expected {out_shape}; "
                    "the corpus must be shape-uniform with the calibration set"
                )
            return arr

        return host_fn, program, out_shape, out_dtype

    def _stage_fns(self, plan: QueryPlan, placement: Placement):
        fmt = plan.fmt
        host_ops = list(placement.host_ops)
        device_ops = list(placement.device_ops)
        in_meta = self._decoded_meta(fmt)
        out_meta = P.chain_out_meta(host_ops, in_meta)
        out_shape, out_dtype = tuple(out_meta.shape), np.dtype(out_meta.dtype)
        in_shape = tuple(in_meta.shape)

        def host_fn(item):
            if hasattr(item, "decode"):
                x = item.decode(fmt)
                # enforce the shape contract at decode, not at the stage
                # boundary: a full-host placement would otherwise normalize
                # any input through its resize
                if tuple(np.shape(x)) != in_shape:
                    raise ValueError(
                        f"decoded {tuple(np.shape(x))}, expected {in_shape}; "
                        "the corpus must be shape-uniform with the calibration set"
                    )
            else:
                x = item
            x = np.asarray(P.apply_chain_host(host_ops, x), dtype=out_dtype)
            if x.shape != out_shape:
                raise ValueError(
                    f"host stage produced {x.shape}, expected {out_shape}; "
                    "the corpus must be shape-uniform with the calibration set"
                )
            return x

        program = device_compiler.compile_device_program(
            device_ops,
            out_meta,
            self.model_fns[plan.model.name],
            self.config.batch_size,
            backend=self.config.device.backend,
            impl=self.config.device.fused_impl,
            model_key=plan.model.name,
            cache=self._device_programs,
            device=self.device,
        )
        return host_fn, program, out_shape, out_dtype

    def compile(self, plan: QueryPlan | None = None, force: bool = False) -> CompiledPlan:
        if self._compiled is not None and plan is None and not force:
            return self._compiled
        plan = plan or self.plan()
        self._compiled = self._build_compiled(plan, plan.placement)
        return self._compiled

    def _build_compiled(self, plan: QueryPlan, placement: Placement) -> CompiledPlan:
        """Compile one (plan, placement) into a host stage + device program."""
        staged = None
        used_coeff: SplitDecodeOption | None = None
        if plan.coeff is not None:
            staged = self._coeff_stage_fns(plan, plan.coeff)
            if staged is not None:
                used_coeff = plan.coeff
                # the whole dense pipeline (dequant+IDCT onward) runs device-
                # side: pin the placement at split 0 so stats attribute stage
                # time the way the program actually executes
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
            staged = self._stage_fns(plan, placement)
        host_fn, program, out_shape, out_dtype = staged
        return CompiledPlan(
            plan, placement, host_fn, program, out_shape, out_dtype,
            device_program=program, coeff=used_coeff,
        )

    def engine(self) -> PipelinedEngine:
        compiled = self.compile()
        if compiled.engine is None:
            compiled.engine = PipelinedEngine(
                compiled.host_fn,
                compiled.device_fn,
                compiled.out_shape,
                compiled.out_dtype,
                batch_size=self.config.batch_size,
                num_workers=self.config.num_workers,
                memory=self.config.memory,
                double_buffer=self.config.double_buffer,
            )
        return compiled.engine

    # --------------------------------------------------------------- running
    def run(
        self, corpus: Sequence[Any], return_outputs: bool = True
    ) -> tuple[list[Any], RunReport]:
        """Batch path: plan → place → pipeline the whole corpus.  Outputs
        are host numpy arrays, one per item."""
        compiled = self.compile()
        outputs, stats = self.engine().run(corpus, return_outputs=return_outputs)
        report = RunReport(
            plan_key=compiled.plan.key, stats=stats, chunk_stats=[stats], recalibrations=[]
        )
        return outputs, report

    # --------------------------------------------------------------- serving
    def start_serving(self) -> None:
        raise _not_ported("SmolRuntime.start_serving", _ITEM_SERVING)

    def submit(self, item: Any, tenant: str = "default") -> int:
        raise _not_ported("SmolRuntime.submit", _ITEM_SERVING)

    def drain(self, timeout: float | None = None) -> list:
        raise _not_ported("SmolRuntime.drain", _ITEM_SERVING)
