"""Online re-solving of the host/device split point (adaptive §6.3).

The placement optimizer picks a split from *a-priori* cost estimates
(weighted op counts over assumed host/device op rates).  Those rates drift
at runtime — host contention, accelerator batch effects, input mix — so the
engine feeds measured stage occupancy (:class:`repro_torch.core.engine.EngineStats`)
back into a :class:`Recalibrator`, which

1. decomposes the measured host time into decode + host-op components and
   the measured device time into device-op + DNN components (attributing
   proportionally to the current model's predictions),
2. EWMA-updates the four underlying rate parameters, and
3. re-runs :func:`repro_torch.core.placement.choose_split` under the updated
   rates, moving the split only when the predicted gain clears a
   hysteresis margin (so measurement noise does not thrash recompiles).

Under multi-tenant serving the split is **per tenant**: each model-pinned
tenant gets its own :class:`Recalibrator` fed from that tenant's windowed
stage measurements (``RequestScheduler.measurement(tenant)``), so tenants
with different models/plans converge to different host/device splits
instead of fighting over one global split point.

Under the split-decode placement (§6.4) the recalibrator additionally
learns the **coefficient path's** costs: the measured host time is the
entropy stage alone (``host_entropy_time``) and the measured device time
covers dequant+(scaled-)IDCT + chroma upsample + color conversion + the
scaled preprocessing chain + the DNN.  ``resolve`` then compares the best
pixel-path split against every valid scaled-IDCT factor
(:func:`repro_torch.core.placement.choose_coeff_option`), so drifting rates can
move the runtime between the pixel path, full-resolution split decode and
reduced-resolution split decode — per-factor coefficient-FLOP and
staging-byte costs included.

Next to the split there is a second knob: the **host worker count**.
:class:`WorkerRecalibrator` sizes the producer pool from the same stage
measurements.  It learns the observed throughput-vs-workers curve online:
each window contributes an (active pool size, host seconds/item) sample,
a linear contention fit ``host_spi(w) = a + b*w`` extrapolates how decode
cost grows with concurrency (the GIL-efficiency curve), and the pool
jumps **straight to the knee** — the smallest count whose extrapolated
host throughput saturates the device — instead of walking one worker per
window.  EWMA smoothing and the asymmetric dead band are retained, so a
window straddling a boundary still cannot flap the count.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import placement as placement_mod
from repro_torch.core.cost_model import CoeffGeometry
from repro_torch.core.placement import Placement, SplitDecodeOption
from repro_torch.preprocessing.ops import PreprocOp, TensorMeta, chain_flops, chain_out_meta


@dataclasses.dataclass(frozen=True)
class StageMeasurement:
    """One observation of pipeline stage occupancy, in seconds/item."""

    host_seconds_per_item: float  # decode + host-placed preprocessing ops
    device_seconds_per_item: float  # device-placed preprocessing ops + DNN

    @classmethod
    def from_engine_stats(cls, stats) -> "StageMeasurement":
        return cls(
            host_seconds_per_item=stats.host_seconds_per_item,
            device_seconds_per_item=stats.device_seconds_per_item,
        )


@dataclasses.dataclass
class RecalibrationEvent:
    old_split: int
    new_split: int
    host_ops_per_sec: float
    device_ops_per_sec: float
    host_decode_time: float
    dnn_device_time: float
    predicted_throughput: float
    # which tenant's measurement window drove this event ("" = the shared
    # single-stream path).  Multi-tenant serving runs one Recalibrator per
    # model-pinned tenant, so each tenant's host/device split is learned
    # from that tenant's own observed stage occupancy.
    tenant: str = ""
    # split-decode factor before/after this event: 0 = pixel path, 1/2/4 =
    # coefficient placement at that scaled-IDCT factor
    old_factor: int = 0
    new_factor: int = 0

    @property
    def changed(self) -> bool:
        return self.new_split != self.old_split or self.new_factor != self.old_factor


@dataclasses.dataclass
class WorkerRecalibrationEvent:
    old_workers: int
    new_workers: int
    ideal_workers: float  # smoothed host/device occupancy ratio
    knee_workers: float = 0.0  # contention-fitted saturation point (0 = n/a)

    @property
    def changed(self) -> bool:
        return self.new_workers != self.old_workers


class WorkerRecalibrator:
    """Online tuner for the host producer-pool size (knee-seeking).

    One device stream is saturated when ``num_workers * device_spi >=
    host_spi`` (each worker contributes one item per ``host_spi`` seconds;
    the device consumes one per ``device_spi``).  Under perfect scaling
    the ideal count is the ratio — but host decode does not scale
    perfectly (GIL handoffs, memory bandwidth), so each measurement window
    also contributes an ``(active pool size, host seconds/item)`` sample
    and a linear contention fit ``host_spi(w) = a + b*w`` extrapolates the
    curve.  The **knee** is the smallest pool size whose extrapolated
    per-worker cost still saturates the device (``w * device_spi >=
    host_spi(w)``), and the recalibrator jumps straight there instead of
    walking one worker per window.  The move itself stays damped: ratios
    are EWMA-smoothed and the count only moves when the smoothed ideal
    leaves the asymmetric ±dead-band around the current value, so a window
    straddling a boundary cannot flap between adjacent counts.
    """

    def __init__(
        self,
        num_workers: int,
        min_workers: int = 1,
        max_workers: int = 16,
        alpha: float = 0.5,
        dead_band: float = 0.5,
    ):
        if not (min_workers <= num_workers <= max_workers):
            raise ValueError(
                f"need min_workers <= num_workers <= max_workers, "
                f"got {min_workers} <= {num_workers} <= {max_workers}"
            )
        self.num_workers = num_workers
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.alpha = alpha
        self.dead_band = dead_band
        self._smoothed: float | None = None
        self._dev_spi: float | None = None
        # EWMA of host seconds/item keyed by the pool size that produced
        # the window — the observed points of the throughput-vs-workers
        # curve — plus a staleness counter per point: a sample from a
        # transient phase (cold caches at the initial pool size) must not
        # skew the contention fit forever, so points not refreshed within
        # MAX_SAMPLE_AGE windows are dropped from the fit
        self._spi_by_workers: dict[int, float] = {}
        self._spi_age: dict[int, int] = {}
        self.events: list[WorkerRecalibrationEvent] = []

    MAX_SAMPLE_AGE = 8  # windows a curve point survives without refresh

    def _ewma(self, old: float | None, new: float) -> float:
        return new if old is None else (1.0 - self.alpha) * old + self.alpha * new

    def _knee(self) -> float:
        """Smallest pool size saturating the device under the fitted curve.

        With one observed pool size the curve degenerates to perfect
        scaling (knee = host/device ratio); with two or more, a least-
        squares line ``host_spi(w) = a + b*w`` models contention and the
        knee solves ``w * dev_spi = a + b*w``.  When contention grows as
        fast as capacity (``b >= dev_spi``) adding workers can never catch
        up — the knee is wherever the fit says marginal workers stop
        paying, capped at max_workers.
        """
        d = self._dev_spi or 0.0
        pts = sorted(self._spi_by_workers.items())
        if d <= 0 or not pts:
            return float(self.num_workers)
        if len(pts) == 1:
            return pts[0][1] / d
        n = len(pts)
        sw = sum(w for w, _ in pts)
        ss = sum(s for _, s in pts)
        sww = sum(w * w for w, _ in pts)
        sws = sum(w * s for w, s in pts)
        denom = n * sww - sw * sw
        b = (n * sws - sw * ss) / denom if denom else 0.0
        a = (ss - b * sw) / n
        if b < 0.0:  # super-linear scaling is noise; treat as perfect
            b = 0.0
            a = ss / n
        if d <= b:
            return float(self.max_workers)
        return max(a / (d - b), float(self.min_workers))

    def update(self, m: StageMeasurement) -> tuple[int, bool]:
        """Fold one stage measurement in; returns (num_workers, changed)."""
        old = self.num_workers
        if m.device_seconds_per_item <= 0 or m.host_seconds_per_item <= 0:
            # degenerate window (e.g. zero measured host busy-time, or no
            # completions): hold rather than steer on garbage
            self.events.append(WorkerRecalibrationEvent(old, old, self._smoothed or float(old)))
            return old, False
        ideal = m.host_seconds_per_item / m.device_seconds_per_item
        self._smoothed = self._ewma(self._smoothed, ideal)
        self._dev_spi = self._ewma(self._dev_spi, m.device_seconds_per_item)
        self._spi_by_workers[old] = self._ewma(
            self._spi_by_workers.get(old), m.host_seconds_per_item
        )
        self._spi_age[old] = 0  # refreshed this window; age the others out
        for w in list(self._spi_age):
            if w == old:
                continue
            self._spi_age[w] += 1
            if self._spi_age[w] > self.MAX_SAMPLE_AGE:
                self._spi_age.pop(w, None)
                self._spi_by_workers.pop(w, None)
        knee = self._knee()
        # ceil with an epsilon: a knee of 6.999999 (fit round-off) is 7
        target = max(self.min_workers, min(self.max_workers, -int(-(knee - 1e-6) // 1)))
        # dead-band damping: jump only when the smoothed ideal clearly
        # leaves the asymmetric band around the current count — grow when
        # the pool is starving the device, shrink only when one fewer
        # worker would still over-provision by the same margin
        new = old
        if self._smoothed > old + self.dead_band and target > old:
            new = target
        elif self._smoothed < old - 1.0 - self.dead_band and target < old:
            new = target
        self.num_workers = new
        self.events.append(WorkerRecalibrationEvent(old, new, self._smoothed, knee))
        return new, new != old


class Recalibrator:
    """Tracks stage-rate estimates for one plan's preprocessing chain."""

    def __init__(
        self,
        chain: Sequence[PreprocOp],
        in_meta: TensorMeta,
        host_decode_time: float,
        dnn_device_time: float,
        host_ops_per_sec: float,
        device_ops_per_sec: float,
        alpha: float = 0.5,
        hysteresis: float = 0.1,
        device_dispatch_overhead_s: float = 0.0,
        device_fused: bool = True,
        split_decode: str = "off",
        coeff_geometry: CoeffGeometry | None = None,
        host_entropy_time: float | None = None,
    ):
        self.chain = list(chain)
        self.in_meta = in_meta
        self.host_decode_time = host_decode_time
        self.dnn_device_time = dnn_device_time
        self.host_ops_per_sec = host_ops_per_sec
        self.device_ops_per_sec = device_ops_per_sec
        self.alpha = alpha  # EWMA weight of the newest observation
        self.hysteresis = hysteresis
        # the split re-solve must use the same fused-dispatch cost model the
        # planner used, or recalibration would undo the fusion-aware choice
        self.device_dispatch_overhead_s = device_dispatch_overhead_s
        self.device_fused = device_fused
        # split-decode recalibration (§6.4): with a stream geometry and a
        # measured entropy-stage time, resolve() also prices the coefficient
        # placement at every valid scaled-IDCT factor and may move the
        # runtime between pixel and coefficient paths (or between factors)
        self.split_decode = split_decode
        self.coeff_geometry = coeff_geometry
        self.host_entropy_time = host_entropy_time
        # the coefficient option update() last chose (None = pixel path);
        # the facade reads this after a changed update to recompile
        self.chosen_coeff: SplitDecodeOption | None = None
        self.events: list[RecalibrationEvent] = []

    # ------------------------------------------------------------- internals
    def _split_metas(self, split: int) -> tuple[float, float]:
        """(host-op flops, device-op flops) for a given split of the chain."""
        host_ops, device_ops = self.chain[:split], self.chain[split:]
        f_host = chain_flops(host_ops, self.in_meta)
        mid = chain_out_meta(host_ops, self.in_meta)
        f_dev = chain_flops(device_ops, mid)
        return f_host, f_dev

    def _ewma(self, old: float, new: float) -> float:
        return (1.0 - self.alpha) * old + self.alpha * new

    def _observe_device(self, f_dev: float, measured_s: float) -> None:
        """Attribute one measured device time between the DNN and ``f_dev``
        device-op flops (in proportion to the current model's predictions),
        EWMA-updating both parameters.  Shared by the pixel and coefficient
        paths so both learn the same rate model."""
        pred_ops = f_dev / self.device_ops_per_sec
        pred_total = self.dnn_device_time + pred_ops
        if pred_total <= 0:
            self.dnn_device_time = measured_s
            return
        dnn_share = self.dnn_device_time / pred_total
        t_dnn = measured_s * dnn_share
        t_ops = measured_s - t_dnn
        self.dnn_device_time = self._ewma(self.dnn_device_time, t_dnn)
        if f_dev > 0 and t_ops > 0:
            self.device_ops_per_sec = self._ewma(self.device_ops_per_sec, f_dev / t_ops)

    # --------------------------------------------------------------- updates
    def observe(self, split: int, m: StageMeasurement) -> None:
        """Fold one measurement into the rate model.

        The measured host time covers decode + ops[:split]; the measured
        device time covers ops[split:] + the DNN.  Each aggregate is
        attributed to its components in proportion to the current model's
        predictions, then each component parameter is EWMA-updated.
        """
        f_host, f_dev = self._split_metas(split)

        if m.host_seconds_per_item > 0:
            pred_ops = f_host / self.host_ops_per_sec
            pred_total = self.host_decode_time + pred_ops
            if pred_total <= 0:
                self.host_decode_time = m.host_seconds_per_item
            else:
                decode_share = self.host_decode_time / pred_total
                t_decode = m.host_seconds_per_item * decode_share
                t_ops = m.host_seconds_per_item - t_decode
                self.host_decode_time = self._ewma(self.host_decode_time, t_decode)
                if f_host > 0 and t_ops > 0:
                    self.host_ops_per_sec = self._ewma(self.host_ops_per_sec, f_host / t_ops)

        if m.device_seconds_per_item > 0:
            self._observe_device(f_dev, m.device_seconds_per_item)

    def observe_coeff(self, option: SplitDecodeOption, m: StageMeasurement) -> None:
        """Fold one measurement taken under the coefficient placement.

        The measured host time is the entropy stage alone; the measured
        device time covers the coefficient-domain decode + the scaled
        preprocessing chain + the DNN, attributed between the DNN and the
        per-factor coefficient/chain FLOPs the same way the pixel path
        attributes its device ops.
        """
        if m.host_seconds_per_item > 0:
            self.host_entropy_time = (
                m.host_seconds_per_item
                if self.host_entropy_time is None
                else self._ewma(self.host_entropy_time, m.host_seconds_per_item)
            )
        if m.device_seconds_per_item > 0:
            self._observe_device(option.coeff_flops + option.chain_flops, m.device_seconds_per_item)

    def resolve(self) -> Placement:
        """Re-run the split search under the current rate estimates."""
        return placement_mod.choose_split(
            self.chain,
            self.in_meta,
            host_decode_time=self.host_decode_time,
            dnn_device_time=self.dnn_device_time,
            host_ops_per_sec=self.host_ops_per_sec,
            device_ops_per_sec=self.device_ops_per_sec,
            device_dispatch_overhead_s=self.device_dispatch_overhead_s,
            device_fused=self.device_fused,
        )

    def resolve_coeff(self) -> SplitDecodeOption | None:
        """Best coefficient placement under the current rate estimates."""
        if (
            self.split_decode == "off"
            or self.coeff_geometry is None
            or self.host_entropy_time is None
        ):
            return None
        return placement_mod.choose_coeff_option(
            self.chain,
            self.coeff_geometry,
            host_entropy_time=self.host_entropy_time,
            dnn_device_time=self.dnn_device_time,
            device_ops_per_sec=self.device_ops_per_sec,
            device_dispatch_overhead_s=self.device_dispatch_overhead_s,
            policy=self.split_decode,
        )

    def update(
        self,
        current: Placement,
        m: StageMeasurement,
        coeff: SplitDecodeOption | None = None,
    ) -> tuple[Placement, bool]:
        """observe + resolve with hysteresis.

        ``coeff`` names the coefficient placement the measurement was taken
        under (None = pixel path).  Returns ``(placement, changed)``; after
        a changed update, :attr:`chosen_coeff` says whether the new
        placement is the pixel path (None) or a coefficient option (whose
        factor may differ from the old one).  Either move only happens when
        the re-solved candidate's predicted throughput beats the current
        configuration's prediction (under the *updated* rates) by the
        hysteresis margin.
        """
        if coeff is not None:
            self.observe_coeff(coeff, m)
        else:
            self.observe(current.split, m)
        best = self.resolve()
        best_coeff = self.resolve_coeff()
        forced = self.split_decode in ("full", "scaled")
        use_coeff = best_coeff is not None and (
            forced or best_coeff.est_throughput > best.est_throughput
        )
        new_split = 0 if use_coeff else best.split
        event = RecalibrationEvent(
            old_split=current.split,
            new_split=new_split,
            host_ops_per_sec=self.host_ops_per_sec,
            device_ops_per_sec=self.device_ops_per_sec,
            host_decode_time=self.host_decode_time,
            dnn_device_time=self.dnn_device_time,
            predicted_throughput=best_coeff.est_throughput if use_coeff else best.est_throughput,
            old_factor=coeff.factor if coeff is not None else 0,
            new_factor=best_coeff.factor if use_coeff else 0,
        )
        same_mode = (coeff is not None) == use_coeff and (
            not use_coeff or coeff.factor == best_coeff.factor
        )
        if same_mode and (use_coeff or best.split == current.split):
            self.chosen_coeff = best_coeff if use_coeff else None
            self.events.append(event)
            return (self._placement_for(0) if use_coeff else best), False
        # predicted throughput of staying as-is, under the updated rates
        if coeff is not None:
            stay = self._predict_coeff(coeff)
        else:
            stay = self._predict_split(current.split)
        moved_pred = best_coeff.est_throughput if use_coeff else best.est_throughput
        # a forced policy mandates the coefficient path, so a pixel<->coeff
        # mode change under it bypasses hysteresis; factor changes within
        # the coeff path stay damped
        mode_change = (coeff is not None) != use_coeff
        if not (forced and mode_change) and moved_pred < (1.0 + self.hysteresis) * stay:
            self.chosen_coeff = coeff
            event = dataclasses.replace(
                event,
                new_split=current.split,
                new_factor=coeff.factor if coeff is not None else 0,
            )
            self.events.append(event)
            return self._placement_for(current.split), False
        self.chosen_coeff = best_coeff if use_coeff else None
        self.events.append(event)
        return (self._placement_for(0) if use_coeff else best), True

    def _placement_for(self, split: int) -> Placement:
        """The Placement object for a forced split under current rates."""
        return placement_mod.placement_for_split(
            self.chain,
            self.in_meta,
            split,
            host_decode_time=self.host_decode_time,
            dnn_device_time=self.dnn_device_time,
            host_ops_per_sec=self.host_ops_per_sec,
            device_ops_per_sec=self.device_ops_per_sec,
            device_dispatch_overhead_s=self.device_dispatch_overhead_s,
            device_fused=self.device_fused,
        )

    def _predict_split(self, split: int) -> float:
        return self._placement_for(split).est_throughput

    def _predict_coeff(self, option: SplitDecodeOption) -> float:
        """Predicted throughput of the *current* coefficient option under
        the updated rates (the stay-put side of the hysteresis compare)."""
        if self.coeff_geometry is None or self.host_entropy_time is None:
            return option.est_throughput
        fresh = placement_mod.enumerate_coeff_options(
            self.chain,
            self.coeff_geometry,
            host_entropy_time=self.host_entropy_time,
            dnn_device_time=self.dnn_device_time,
            device_ops_per_sec=self.device_ops_per_sec,
            device_dispatch_overhead_s=self.device_dispatch_overhead_s,
            factors=(option.factor,),
        )
        return fresh[0].est_throughput if fresh else option.est_throughput


@dataclasses.dataclass
class CascadeRecalibrationEvent:
    old_factor: int
    new_factor: int
    pass_rate: float  # EWMA pass-through fraction measured at old_factor
    cheap_seconds_per_item: float  # cheap-stage cost measured at old_factor
    full_seconds_per_item: float  # expensive-stage cost (refetch path)
    predicted_cost: float  # seconds/item predicted at new_factor
    threshold: float  # the stage's confidence threshold (accuracy floor)
    tenant: str = ""

    @property
    def changed(self) -> bool:
        return self.new_factor != self.old_factor


class CascadeRecalibrator:
    """Co-optimizes the cascade's cheap-stage decode factor against the
    pass-through rate measured online (tentpole of the §3.2 serving mode).

    The expected cost per cascade item is

        cost(f) = cheap_spi(f) + pass_rate(f) * full_spi

    — every item pays the cheap scaled-decode scan at factor ``f``, and
    the fraction that fails the confidence threshold additionally pays
    the full-resolution refetch.  A coarser factor shrinks ``cheap_spi``
    (fewer coefficient FLOPs, smaller staging) but *raises* the pass
    rate (lower-fidelity inputs score less confidently), so the optimum
    moves with the measured distribution, not just the planner's static
    per-factor costs.

    Per-factor pass rates and cheap-stage costs are EWMA-tracked from
    the facade's cascade exit counters + the telemetry occupancy windows
    (the same feed the split/worker recalibrators read).  Factors never
    served are priced by scaling the current factor's observations:
    cheap cost by ``(f_now / f_cand)**2`` (scaled IDCT output area) and
    pass rate linearly in the factor ratio, clamped to [0, 1] — a
    deliberately rough prior the next measured window immediately
    corrects.  Moves are hysteresis-damped like the split recalibrator.

    The confidence ``threshold`` is the query's accuracy contract, so it
    is honored as a floor rather than searched: the recalibrator only
    optimizes the (factor) axis of the paper's (factor, threshold)
    trade, reporting the threshold in every event.
    """

    def __init__(
        self,
        factor: int,
        threshold: float,
        candidates: Sequence[int] = (4, 2, 1),
        alpha: float = 0.5,
        hysteresis: float = 0.1,
        tenant: str = "",
    ):
        if factor not in candidates:
            raise ValueError(f"factor {factor} not in candidates {tuple(candidates)}")
        self.factor = factor
        self.threshold = threshold
        self.candidates = tuple(candidates)
        self.alpha = alpha
        self.hysteresis = hysteresis
        self.tenant = tenant
        self._pass_rate: dict[int, float] = {}  # EWMA per factor
        self._cheap_spi: dict[int, float] = {}  # EWMA per factor
        self._full_spi: float | None = None
        self.events: list[CascadeRecalibrationEvent] = []

    def _ewma(self, old: float | None, new: float) -> float:
        return new if old is None else (1.0 - self.alpha) * old + self.alpha * new

    def observe(
        self,
        factor: int,
        items: int,
        refetched: int,
        cheap_seconds_per_item: float,
        full_seconds_per_item: float | None = None,
    ) -> None:
        """Fold one measurement window in.

        ``items`` cascade items entered the cheap stage at ``factor``;
        ``refetched`` of them failed the threshold and paid the full-
        resolution refetch.  ``cheap_seconds_per_item`` is the measured
        cheap-stage occupancy; ``full_seconds_per_item`` the refetch
        path's (None when no item passed through this window).
        """
        if items <= 0:
            return
        rate = min(1.0, max(0.0, refetched / items))
        self._pass_rate[factor] = self._ewma(self._pass_rate.get(factor), rate)
        if cheap_seconds_per_item > 0:
            self._cheap_spi[factor] = self._ewma(
                self._cheap_spi.get(factor), cheap_seconds_per_item
            )
        if full_seconds_per_item is not None and full_seconds_per_item > 0:
            self._full_spi = self._ewma(self._full_spi, full_seconds_per_item)

    def _predict(self, factor: int) -> float | None:
        """Expected seconds/item at ``factor`` under current estimates."""
        now = self.factor
        cheap = self._cheap_spi.get(factor)
        if cheap is None:
            base = self._cheap_spi.get(now)
            if base is None:
                return None
            cheap = base * (now / factor) ** 2
        rate = self._pass_rate.get(factor)
        if rate is None:
            base = self._pass_rate.get(now)
            if base is None:
                return None
            rate = min(1.0, max(0.0, base * (factor / now)))
        full = self._full_spi if self._full_spi is not None else 0.0
        return cheap + rate * full

    def update(self) -> tuple[int, bool]:
        """Re-pick the cheap-stage factor; returns (factor, changed).

        The move only happens when the best candidate's predicted cost
        beats staying put by the hysteresis margin — a noisy window
        cannot thrash the facade into recompiling stage bindings.
        """
        old = self.factor
        stay = self._predict(old)
        if stay is None or stay <= 0:
            return old, False  # nothing measured yet: hold
        best, best_cost = old, stay
        for f in self.candidates:
            cost = self._predict(f)
            if cost is not None and cost < best_cost:
                best, best_cost = f, cost
        event = CascadeRecalibrationEvent(
            old_factor=old,
            new_factor=best,
            pass_rate=self._pass_rate.get(old, 0.0),
            cheap_seconds_per_item=self._cheap_spi.get(old, 0.0),
            full_seconds_per_item=self._full_spi or 0.0,
            predicted_cost=best_cost,
            threshold=self.threshold,
            tenant=self.tenant,
        )
        if best == old or best_cost >= stay / (1.0 + self.hysteresis):
            event = dataclasses.replace(event, new_factor=old, predicted_cost=stay)
            self.events.append(event)
            return old, False
        self.factor = best
        self.events.append(event)
        return best, True
