"""SMOL's plan generator + selector (paper §3, Figure 2).

Inputs: a set of DNNs 𝒟, a set of natively available input formats ℱ, a
calibration set, optional accuracy/throughput constraints.  The planner

1. generates query plans over 𝒟 × ℱ,
2. optimizes each plan's preprocessing DAG (core/dag.py) and operator
   placement (core/placement.py),
3. estimates accuracy (validation set) and throughput (the min cost
   model, core/cost_model.py) per plan,
4. returns the Pareto-optimal set — or the best plan under a constraint.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import dag as dag_mod
from repro_torch.core import placement as placement_mod
from repro_torch.core.cost_model import PlanEstimate, StageThroughputs, pareto_frontier
from repro_torch.preprocessing import ops as P
from repro_torch.preprocessing.formats import ImageFormat, StoredImage
from repro_torch.preprocessing.ops import TensorMeta


@dataclasses.dataclass
class ModelSpec:
    """One member of 𝒟."""

    name: str
    input_size: int  # square DNN input resolution
    exec_throughput: float  # measured items/sec on synthetic batches
    accuracy_by_format: dict[str, float]  # format.key -> validation accuracy
    pass_fraction: float = 1.0  # for cascade members: fraction reaching it


@dataclasses.dataclass
class QueryPlan:
    model: ModelSpec
    fmt: ImageFormat
    dag_plan: dag_mod.DagPlan
    placement: placement_mod.Placement
    estimate: PlanEstimate
    # split-decode placement (§6.4 x §6.3): when set, the cost model decided
    # the host should stop at the entropy stage and the device program
    # should decode from coefficients at `coeff.factor` reduced resolution
    coeff: placement_mod.SplitDecodeOption | None = None

    @property
    def key(self) -> str:
        return f"{self.model.name}@{self.fmt.key}"

    def __repr__(self) -> str:
        e = self.estimate
        return f"QueryPlan({self.key}: {e.throughput:.0f} im/s, acc={e.accuracy:.4f})"


def standard_chain(input_size: int) -> list[P.PreprocOp]:
    """The ResNet-style preprocessing chain (paper §2) for a target input."""
    resize_short = round(input_size * 256 / 224)
    return [
        P.ResizeShortSide(resize_short),
        P.CenterCrop(input_size),
        P.ToFloat(),
        P.Normalize(),
        P.ChannelsFirst(),
    ]


def measure_decode_time(
    samples: Sequence[StoredImage],
    fmt: ImageFormat,
    roi_for: Callable[[tuple[int, int, int, int]], tuple[int, int, int, int]] | None = None,
    repeats: int = 1,
) -> float:
    """Measured seconds/item to decode ``fmt`` on one host worker."""
    t0 = time.perf_counter()
    n = 0
    for _ in range(repeats):
        for s in samples:
            roi = None
            if roi_for is not None:
                h, w = s.native_shape[:2]
                roi = roi_for((0, 0, h, w))
            s.decode(fmt, roi=roi)
            n += 1
    return (time.perf_counter() - t0) / n


def measure_entropy_decode_time(
    samples: Sequence[StoredImage],
    fmt: ImageFormat,
    repeats: int = 1,
) -> float:
    """Measured seconds/item of the split-decode placement's host stage:
    the entropy decode PLUS the coefficient staging copy
    (``jpeg.stage_coefficients``) the runtime host_fn performs per item —
    pricing only the decode would overestimate coefficient-path host
    throughput exactly when frames are large and staging copies bind."""
    from repro_torch.core.cost_model import CoeffGeometry, coeff_staging_layout
    from repro_torch.preprocessing import jpeg as jpeg_mod

    t0 = time.perf_counter()
    n = 0
    for _ in range(repeats):
        for s in samples:
            hdr, planes_zz, _, _ = s.decode_to_coefficients(fmt)
            # the one shared layout rule: time the staging copy the
            # runtime host_fn will actually perform
            layout = coeff_staging_layout(CoeffGeometry.from_header(hdr))
            jpeg_mod.stage_coefficients(planes_zz, hdr, layout)
            n += 1
    return (time.perf_counter() - t0) / n


def central_roi(input_size: int, resize_short: int):
    """ROI covering the central crop in original coordinates (Algorithm 1)."""

    def fn(full: tuple[int, int, int, int]):
        _, _, h, w = full
        scale = min(h, w) / resize_short
        crop = input_size * scale
        t = (h - crop) / 2
        l = (w - crop) / 2
        return (int(t), int(l), int(np.ceil(t + crop)), int(np.ceil(l + crop)))

    return fn


class Planner:
    """Generates, optimizes and ranks plans over 𝒟 × ℱ."""

    def __init__(
        self,
        models: Sequence[ModelSpec],
        formats: Sequence[ImageFormat],
        decode_time: Callable[[ImageFormat], float],
        decoded_meta: Callable[[ImageFormat], TensorMeta],
        host_ops_per_sec: float = 2.0e9,
        device_ops_per_sec: float | None = None,
        use_roi_decode: bool = False,
        estimator: str = "smol",
        device_dispatch_overhead_s: float = 0.0,
        device_fused: bool = True,
        split_decode: str = "off",
        entropy_decode_time: Callable[[ImageFormat], float] | None = None,
        coeff_geometry: "Callable[[ImageFormat], object | None] | None" = None,
        cache_hit_rate: Callable[[ImageFormat], float] | None = None,
    ):
        self.models = list(models)
        self.formats = list(formats)
        self.decode_time = decode_time
        self.decoded_meta = decoded_meta
        self.host_ops_per_sec = host_ops_per_sec
        self.device_ops_per_sec = device_ops_per_sec
        self.use_roi_decode = use_roi_decode
        self.estimator = estimator
        # fused-dispatch cost model (§6.2 x §6.3): per-dispatch-group launch
        # overhead; device_fused says whether the device compiler's fusion
        # groups apply (one group = one dispatch) or the per-op legacy model
        self.device_dispatch_overhead_s = device_dispatch_overhead_s
        self.device_fused = device_fused
        # split decode (§6.4): "off" keeps the pixel path; "full"/"scaled"
        # force the coefficient placement (full- / reduced-resolution IDCT);
        # "auto" lets the per-factor coefficient-FLOP + staging-byte cost
        # model decide per plan.  The callbacks supply the measured entropy-
        # stage time and the stream geometry (both per format, both cached
        # by the runtime facade); without them the policy stays inert.
        if split_decode not in placement_mod.SPLIT_DECODE_POLICIES:
            raise ValueError(
                f"split_decode must be one of {placement_mod.SPLIT_DECODE_POLICIES}, "
                f"got {split_decode!r}"
            )
        self.split_decode = split_decode
        self.entropy_decode_time = entropy_decode_time
        self.coeff_geometry = coeff_geometry
        # rendition-cache term: measured hit fraction per format (0.0 when
        # no cache is configured).  The host-stage costs below are
        # discounted by it, so a plan whose renditions are resident beats
        # a nominally-cheaper cold plan.  NOTE: hit rates evolve with the
        # workload — generate() memoizes, so callers wanting fresh
        # cache-aware rankings go through replan()/cache_aware_throughput.
        self.cache_hit_rate = cache_hit_rate
        self._generated: list[QueryPlan] | None = None  # inputs are immutable

    def _cached_host_time(self, fmt: ImageFormat, seconds: float) -> float:
        """Host-stage seconds/item net of the rendition-cache hit rate."""
        if self.cache_hit_rate is None:
            return seconds
        from repro_torch.core.cost_model import cached_host_seconds

        return cached_host_seconds(seconds, self.cache_hit_rate(fmt))

    def _place_and_estimate(
        self,
        model: ModelSpec,
        fmt: ImageFormat,
        dag_plan: dag_mod.DagPlan,
        accuracy: float,
        t_decode: float,
        t_dnn: float,
        host_ops_per_sec: float | None = None,
        device_ops_per_sec: float | None = None,
    ) -> QueryPlan:
        """Shared tail of planning: split the chain, estimate, wrap."""
        # cache-aware term: repeat traffic over a hot corpus serves the
        # host stage's product straight from the rendition cache, so the
        # expected decode cost is the miss fraction of the cold cost
        t_decode = self._cached_host_time(fmt, t_decode)
        placement = placement_mod.choose_split(
            dag_plan.ops,
            self.decoded_meta(fmt),
            host_decode_time=t_decode,
            dnn_device_time=t_dnn,
            host_ops_per_sec=host_ops_per_sec or self.host_ops_per_sec,
            device_ops_per_sec=device_ops_per_sec or self.device_ops_per_sec,
            device_dispatch_overhead_s=self.device_dispatch_overhead_s,
            device_fused=self.device_fused,
        )
        coeff = self._coeff_option(
            dag_plan, fmt, t_dnn, host_ops_per_sec, device_ops_per_sec, placement
        )
        if coeff is not None:
            stages = StageThroughputs(
                preproc=coeff.est_host_throughput,
                exec_stages=(coeff.est_device_throughput,),
                pass_fractions=(model.pass_fraction,),
            )
        else:
            stages = StageThroughputs(
                preproc=placement.est_host_throughput,
                exec_stages=(placement.est_device_throughput,),
                pass_fractions=(model.pass_fraction,),
            )
        est = PlanEstimate(
            throughput=stages.estimate(self.estimator),
            accuracy=accuracy,
            stages=stages,
        )
        return QueryPlan(model, fmt, dag_plan, placement, est, coeff=coeff)

    def _coeff_option(
        self,
        dag_plan: dag_mod.DagPlan,
        fmt: ImageFormat,
        t_dnn: float,
        host_ops_per_sec: float | None,
        device_ops_per_sec: float | None,
        pixel_placement: placement_mod.Placement,
    ) -> placement_mod.SplitDecodeOption | None:
        """Split-decode candidate for one plan under the configured policy.

        Prices every valid scaled-IDCT factor against its per-factor
        coefficient FLOPs + staging bytes and the measured entropy-stage
        time.  ``"full"``/``"scaled"`` force the coefficient placement;
        ``"auto"`` only takes it when it beats the best pixel-path split —
        which is exactly how scaled decode moves the split device-ward.
        """
        if self.split_decode == "off" or fmt.codec != "jpeg":
            return None
        if self.coeff_geometry is None or self.entropy_decode_time is None:
            return None
        geom = self.coeff_geometry(fmt)
        if geom is None or geom.channels != 3:
            return None
        # derive the fallback device rate from the SAME effective host rate
        # choose_split used, or the pixel and coefficient candidates would
        # be priced against different accelerators under replan() overrides
        device_rate = device_ops_per_sec or self.device_ops_per_sec
        if device_rate is None:
            host_rate = host_ops_per_sec or self.host_ops_per_sec
            device_rate = host_rate * placement_mod.DEFAULT_DEVICE_SPEEDUP
        option = placement_mod.choose_coeff_option(
            dag_plan.ops,
            geom,
            # the staged coefficient tensor is exactly what the rendition
            # cache holds for this (format, layout): discount the entropy
            # stage by the measured hit rate
            host_entropy_time=self._cached_host_time(fmt, self.entropy_decode_time(fmt)),
            dnn_device_time=t_dnn,
            device_ops_per_sec=device_rate,
            device_dispatch_overhead_s=self.device_dispatch_overhead_s,
            policy=self.split_decode,
        )
        if option is None:
            return None
        if self.split_decode == "auto" and option.est_throughput <= pixel_placement.est_throughput:
            return None
        return option

    def _plan_one(self, model: ModelSpec, fmt: ImageFormat) -> QueryPlan | None:
        acc = model.accuracy_by_format.get(fmt.key)
        if acc is None:
            return None  # model was not trained/evaluated for this format
        chain = standard_chain(model.input_size)
        dag_plan = dag_mod.optimize(chain, self.decoded_meta(fmt))
        return self._place_and_estimate(
            model, fmt, dag_plan, acc, self.decode_time(fmt), 1.0 / model.exec_throughput
        )

    def replan(
        self,
        plan: QueryPlan,
        decode_time: float | None = None,
        exec_throughput: float | None = None,
        host_ops_per_sec: float | None = None,
        device_ops_per_sec: float | None = None,
    ) -> QueryPlan:
        """Re-derive one plan's placement + estimate from fresher measurements.

        The recalibration entry point (§6.3, adaptive): the runtime feeds
        back measured stage throughputs and gets an updated host/device
        split without regenerating the 𝒟 × ℱ space.
        """
        t_decode = decode_time if decode_time is not None else self.decode_time(plan.fmt)
        t_dnn = 1.0 / (exec_throughput or plan.model.exec_throughput)
        return self._place_and_estimate(
            plan.model,
            plan.fmt,
            plan.dag_plan,
            plan.estimate.accuracy,
            t_decode,
            t_dnn,
            host_ops_per_sec=host_ops_per_sec,
            device_ops_per_sec=device_ops_per_sec,
        )

    def generate(self) -> list[QueryPlan]:
        if self._generated is None:
            plans = []
            for m in self.models:
                for f in self.formats:
                    p = self._plan_one(m, f)
                    if p is not None:
                        plans.append(p)
            self._generated = plans
        return list(self._generated)

    def pareto(self) -> list[QueryPlan]:
        return pareto_frontier(
            self.generate(), key=lambda p: (p.estimate.throughput, p.estimate.accuracy)
        )

    def select(
        self,
        min_accuracy: float | None = None,
        min_throughput: float | None = None,
    ) -> QueryPlan:
        """Constraint-aware selection (paper §3.1):

        * accuracy floor -> max throughput subject to accuracy,
        * throughput floor -> max accuracy subject to throughput,
        * no constraint -> highest-throughput plan.
        """
        plans = self.generate()
        if not plans:
            raise ValueError("no feasible plans")
        if min_accuracy is not None:
            ok = [p for p in plans if p.estimate.accuracy >= min_accuracy]
            if not ok:
                raise ValueError(f"no plan reaches accuracy {min_accuracy}")
            return max(ok, key=lambda p: p.estimate.throughput)
        if min_throughput is not None:
            ok = [p for p in plans if p.estimate.throughput >= min_throughput]
            if not ok:
                raise ValueError(f"no plan reaches throughput {min_throughput}")
            return max(ok, key=lambda p: p.estimate.accuracy)
        return max(plans, key=lambda p: p.estimate.throughput)
