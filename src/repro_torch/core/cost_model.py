"""Preprocessing-aware cost modeling (paper §4).

Three throughput estimators for a configuration C = (cascade of DNNs,
input format, preprocessing plan):

* ``blazeit`` — Eq. 2: cascade execution only, preprocessing ignored.
* ``tahoma`` — Eq. 3: additive preprocessing + execution (no pipelining).
* ``smol``   — Eq. 4: min(T_preproc, T_exec_cascade) — pipelined.

plus the accuracy estimator (held-out validation set) and a calibration
harness that *measures* stage throughputs the way the paper does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence


def cascade_exec_throughput(
    exec_throughputs: Sequence[float],
    pass_fractions: Sequence[float] | None = None,
) -> float:
    """Effective execution throughput of a cascade (the inner term of
    Eqs. 2 and 4).

    ``pass_fractions[j]`` is the fraction of inputs that *reach* stage j
    (so ``pass_fractions[0] == 1``; the paper's alpha_j are per-stage
    pass-through rates, with reach fractions their running product).
    """
    k = len(exec_throughputs)
    if pass_fractions is None:
        pass_fractions = [1.0] * k
    assert len(pass_fractions) == k
    denom = sum(pf / t for pf, t in zip(pass_fractions, exec_throughputs))
    return 1.0 / denom if denom > 0 else float("inf")


def estimate_blazeit(
    preproc_throughput: float,
    exec_throughputs: Sequence[float],
    pass_fractions: Sequence[float] | None = None,
) -> float:
    """Eq. 2 — ignores preprocessing entirely."""
    del preproc_throughput
    return cascade_exec_throughput(exec_throughputs, pass_fractions)


def estimate_tahoma(
    preproc_throughput: float,
    exec_throughputs: Sequence[float],
    pass_fractions: Sequence[float] | None = None,
) -> float:
    """Eq. 3 — additive; ignores that stages pipeline."""
    t_exec = cascade_exec_throughput(exec_throughputs, pass_fractions)
    return 1.0 / (1.0 / preproc_throughput + 1.0 / t_exec)


def estimate_smol(
    preproc_throughput: float,
    exec_throughputs: Sequence[float],
    pass_fractions: Sequence[float] | None = None,
) -> float:
    """Eq. 4 — pipelined: the slower stage bounds end-to-end throughput."""
    t_exec = cascade_exec_throughput(exec_throughputs, pass_fractions)
    return min(preproc_throughput, t_exec)


def device_stage_seconds(
    total_flops: float,
    n_dispatch_groups: int,
    device_ops_per_sec: float,
    dispatch_overhead_s: float = 0.0,
) -> float:
    """Seconds/item of device-side preprocessing under the fusion model.

    The device compiler lowers each fusion group into one program stage, so
    a fused group costs ONE dispatch overhead — not a per-op sum.  "Beyond
    Inference" (AbouElhamayed et al., 2024) measures exactly this term
    dominating at serving rates; with ``dispatch_overhead_s`` calibrated,
    fusing a suffix shifts the optimal split device-ward because k extra
    device ops no longer cost k extra dispatches.
    """
    return n_dispatch_groups * dispatch_overhead_s + total_flops / device_ops_per_sec


@dataclasses.dataclass(frozen=True)
class CoeffGeometry:
    """Static stream geometry the split-decode cost model prices from.

    Derived once per (format, calibration sample) from the SJPG header —
    the analogue of ``decoded_meta`` for the coefficient domain."""

    height: int
    width: int
    channels: int
    n_br: int  # luma block rows
    n_bc: int  # luma block cols
    subsample: bool  # True = 4:2:0

    @classmethod
    def from_header(cls, hdr) -> "CoeffGeometry":
        return cls(hdr.height, hdr.width, hdr.channels, hdr.n_br, hdr.n_bc, bool(hdr.subsample))

    @property
    def chroma_grid(self) -> tuple[int, int]:
        # the codec owns the 4:2:0 grid formula; pricing must never drift
        # from the tensors jpeg.stage_coefficients actually stages
        from repro_torch.preprocessing import jpeg

        return jpeg.chroma_grid(self)

    @property
    def n_blocks(self) -> int:
        n = self.n_br * self.n_bc
        if self.channels == 3:
            cbr, cbc = self.chroma_grid
            n += 2 * cbr * cbc
        return n

    def scaled_hw(self, factor: int) -> tuple[int, int]:
        from repro_torch.preprocessing import jpeg

        return jpeg.scaled_size(self.height, factor), jpeg.scaled_size(self.width, factor)


def coeff_staging_bytes(geom: CoeffGeometry, layout: str) -> int:
    """Host->device staging bytes per item for one coefficient layout.

    ``"padded"`` stages every plane on the luma block grid (exact for
    4:4:4; 4:2:0 pays 4x on the chroma share for a trivially sliceable
    tensor); ``"packed"`` concatenates planes at native block density
    (compact for 4:2:0).  Both are int16 zigzag blocks of 64.
    """
    if layout == "padded":
        return geom.channels * geom.n_br * geom.n_bc * 64 * 2
    if layout == "packed":
        return geom.n_blocks * 64 * 2
    raise ValueError(f"layout must be 'padded' or 'packed', got {layout!r}")


def coeff_staging_layout(geom: CoeffGeometry) -> str:
    """THE staging-layout rule: the byte-cheaper layout, ties to padded
    (packed for 4:2:0, padded for 4:4:4).  The placement optimizer, the
    planner's host-stage timing probe and the facade all derive the
    layout from here so pricing, measurement and execution never stage
    different tensors."""
    return min(("padded", "packed"), key=lambda s: coeff_staging_bytes(geom, s))


def coeff_device_flops(geom: CoeffGeometry, factor: int = 1) -> float:
    """Weighted device-op count of the coefficient-domain decode stages at
    one scaled-IDCT factor: unzigzag + fused dequant+IDCT matmul +
    unblockify + chroma upsample (4:2:0) + color conversion.  Uses the
    same dtype-weighted arithmetic-op convention as ``PreprocOp.flops``
    so the placement optimizer can compare coefficient-domain and
    pixel-domain work on one scale.

    The IDCT matmul term is deliberately factor-INDEPENDENT: the kernel
    zero-pads ``kron(A, A)`` to the full (64, 64) block for every point
    (kernels/idct — same MXU lane cost regardless), so pricing the
    truncated basis at ``64 x point^2`` would predict phantom savings the
    device never delivers.  What a smaller factor genuinely buys is every
    *pixel-proportional* stage — unblockify, chroma upsample, color
    conversion (here) and the preprocessing chain re-costed on the scaled
    grid (``enumerate_coeff_options``) — shrinking by ``factor^2``.
    """
    point = 8 // factor
    w_f32, w_i16 = 4.0, 2.0
    # unzigzag gather: one move per staged coefficient (int16)
    flops = geom.n_blocks * 64.0 * w_i16
    # fused dequant+IDCT: one (64 -> 64, zero-padded) matmul per block
    # (2 flops/MAC) — executed at full width for every point, see above
    flops += geom.n_blocks * 2.0 * 64.0 * 64.0 * w_f32
    # unblockify: one move per *produced* pixel (point^2 per block)
    flops += geom.n_blocks * float(point * point) * w_f32
    hs, ws = geom.scaled_hw(factor)
    if geom.channels == 3:
        if geom.subsample:
            # nearest 2x2 chroma upsample: one move per upsampled pixel
            flops += 2.0 * hs * ws * w_f32
        # JFIF YCbCr->RGB: 3x3 matmul + round/clip per pixel
        flops += (18.0 + 2.0 * 3.0) * hs * ws * w_f32
    return flops


def cached_host_seconds(seconds: float, cache_hit_rate: float) -> float:
    """Cache-aware host-stage cost: the expected seconds/item of a host
    stage whose product (staged coefficient tensor, transcoded pixel
    rendition) is resident in the rendition cache for ``cache_hit_rate``
    of the traffic.  A hit skips the stage entirely, so the expectation is
    the miss fraction of the cold cost — which is what lets a plan
    servable from resident renditions beat a nominally-cheaper cold plan
    in the planner's ranking.
    """
    rate = min(max(float(cache_hit_rate), 0.0), 1.0)
    return seconds * (1.0 - rate)


ESTIMATORS: dict[str, Callable[..., float]] = {
    "blazeit": estimate_blazeit,
    "tahoma": estimate_tahoma,
    "smol": estimate_smol,
}


@dataclasses.dataclass
class StageThroughputs:
    """Measured stage throughputs for one configuration (items/sec)."""

    preproc: float
    exec_stages: tuple[float, ...]
    pass_fractions: tuple[float, ...] = (1.0,)

    def estimate(self, estimator: str = "smol") -> float:
        return ESTIMATORS[estimator](self.preproc, self.exec_stages, self.pass_fractions)


def measure_throughput(
    fn: Callable[[], None],
    items_per_call: int,
    warmup: int = 1,
    repeats: int = 3,
    min_seconds: float = 0.05,
) -> float:
    """Wall-clock throughput of ``fn`` in items/sec (median of repeats)."""
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(repeats):
        n, t0 = 0, time.perf_counter()
        while True:
            fn()
            n += items_per_call
            dt = time.perf_counter() - t0
            if dt >= min_seconds:
                break
        samples.append(n / dt)
    samples.sort()
    return samples[len(samples) // 2]


@dataclasses.dataclass
class PlanEstimate:
    """The cost model's verdict on one plan."""

    throughput: float
    accuracy: float
    stages: StageThroughputs

    def dominates(self, other: "PlanEstimate") -> bool:
        return (
            self.throughput >= other.throughput
            and self.accuracy >= other.accuracy
            and (self.throughput > other.throughput or self.accuracy > other.accuracy)
        )


def pareto_frontier(items: list, key=lambda e: (e.throughput, e.accuracy)) -> list:
    """Pareto-optimal subset under (throughput, accuracy), both maximized."""
    pts = sorted(items, key=lambda it: (-key(it)[0], -key(it)[1]))
    out, best_acc = [], float("-inf")
    for it in pts:
        _, acc = key(it)
        if acc > best_acc:
            out.append(it)
            best_acc = acc
    return out
