"""Hardware- and input-aware preprocessing operator placement (paper §6.3).

Preprocessing chains are sequential, so a placement is a *split point* k:
ops[:k] run on the host (CPU workers), ops[k:] run on the accelerator,
fused into the DNN's compiled graph.  The entropy-decode stage is pinned to
the host (the paper: entropy decoders "are not efficient on accelerators
... substantial branching"); everything downstream is dense math and may go
either way.

Pipelined end-to-end throughput for split k is

    T(k) = min( T_host(ops[:k]),  1 / (t_dev(ops[k:]) + t_dnn) )

— host and device run concurrently (§6.1), but device-side preprocessing
shares the accelerator with DNN execution, so those times add.  SMOL
evaluates every split (there are only ~5, as the paper notes) and takes the
argmax.  When DNN execution dominates, this pushes ops to the host; when
preprocessing dominates, it pushes them to the device — the paper's §6.3
policy, derived rather than hard-coded.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.cost_model import (
    CoeffGeometry,
    coeff_device_flops,
    coeff_staging_bytes,
    coeff_staging_layout,
    device_stage_seconds,
)
from repro_torch.preprocessing.ops import PreprocOp, TensorMeta, chain_flops, chain_out_meta

# Throughput ratio of the accelerator over one host worker for the same
# weighted arithmetic op count.  Used only when measured timings are not
# supplied; calibration (core/engine.py) overrides it with measurements.
DEFAULT_DEVICE_SPEEDUP = 20.0


@dataclasses.dataclass(frozen=True)
class Placement:
    split: int  # ops[:split] -> host, ops[split:] -> device
    host_ops: tuple[PreprocOp, ...]
    device_ops: tuple[PreprocOp, ...]
    est_throughput: float
    est_host_throughput: float
    est_device_throughput: float


def _stage_time(
    ops: Sequence[PreprocOp],
    in_meta: TensorMeta,
    ops_per_sec: float,
) -> tuple[float, TensorMeta]:
    """Time (seconds/item) to run ``ops`` at ``ops_per_sec`` weighted-op/s."""
    t, m = 0.0, in_meta
    for op in ops:
        t += op.flops(m) / ops_per_sec
        m = op.out_meta(m)
    return t, m


def _per_op_times(
    chain: Sequence[PreprocOp],
    in_meta: TensorMeta,
    host_ops_per_sec: float,
    device_ops_per_sec: float,
    measured_host_times: Sequence[float] | None = None,
    measured_device_times: Sequence[float] | None = None,
) -> tuple[list[float], list[float]]:
    """Per-op (host, device) seconds as the chain's metadata threads through."""
    host_times, device_times = [], []
    m = in_meta
    for i, op in enumerate(chain):
        if measured_host_times is not None:
            host_times.append(measured_host_times[i])
        else:
            host_times.append(op.flops(m) / host_ops_per_sec)
        if measured_device_times is not None:
            device_times.append(measured_device_times[i])
        else:
            device_times.append(op.flops(m) / device_ops_per_sec)
        m = op.out_meta(m)
    return host_times, device_times


def _suffix_groups_at(
    chain: Sequence[PreprocOp], in_meta: TensorMeta, split: int, fused: bool
) -> int:
    """Device dispatch-group count of the suffix ops[split:].

    With the device compiler (``fused=True``) a suffix lowers into fusion
    groups (core/dag.py) — one dispatch each; the legacy interpretive path
    dispatches per op.  Deferred import: dag is a sibling that imports the
    same op library."""
    suffix = list(chain[split:])
    if not suffix:
        return 0
    if not fused:
        return len(suffix)
    from repro_torch.core import dag as dag_mod

    m = in_meta
    for op in chain[:split]:
        m = op.out_meta(m)
    return len(dag_mod.device_fusion_groups(suffix, m))


def _split_candidate(
    chain: Sequence[PreprocOp],
    split: int,
    host_decode_time: float,
    dnn_device_time: float,
    host_times: Sequence[float],
    device_times: Sequence[float],
    device_groups: int = 0,
    device_dispatch_overhead_s: float = 0.0,
) -> Placement:
    t_host = host_decode_time + sum(host_times[:split])
    # per-op times are already seconds, so the rate argument is 1.0 and the
    # fusion model only adds the per-dispatch-group overhead term
    t_dev = (
        device_stage_seconds(
            sum(device_times[split:]), device_groups, 1.0, device_dispatch_overhead_s
        )
        + dnn_device_time
    )
    tput_host = 1.0 / t_host if t_host > 0 else float("inf")
    tput_dev = 1.0 / t_dev if t_dev > 0 else float("inf")
    return Placement(
        split=split,
        host_ops=tuple(chain[:split]),
        device_ops=tuple(chain[split:]),
        est_throughput=min(tput_host, tput_dev),
        est_host_throughput=tput_host,
        est_device_throughput=tput_dev,
    )


def placement_for_split(
    chain: Sequence[PreprocOp],
    in_meta: TensorMeta,
    split: int,
    host_decode_time: float,
    dnn_device_time: float,
    host_ops_per_sec: float = 2.0e9,
    device_ops_per_sec: float | None = None,
    device_dispatch_overhead_s: float = 0.0,
    device_fused: bool = True,
) -> Placement:
    """The Placement (with estimates) for one *forced* split point.

    Shares the cost formula with :func:`choose_split` so callers comparing
    a forced split against the optimum (e.g. recalibration hysteresis)
    never diverge from the optimizer's own arithmetic.
    """
    if device_ops_per_sec is None:
        device_ops_per_sec = host_ops_per_sec * DEFAULT_DEVICE_SPEEDUP
    host_times, device_times = _per_op_times(chain, in_meta, host_ops_per_sec, device_ops_per_sec)
    groups = (
        _suffix_groups_at(chain, in_meta, split, device_fused)
        if device_dispatch_overhead_s > 0.0
        else 0
    )
    return _split_candidate(
        chain, split, host_decode_time, dnn_device_time, host_times, device_times,
        device_groups=groups, device_dispatch_overhead_s=device_dispatch_overhead_s,
    )


def choose_split(
    chain: Sequence[PreprocOp],
    in_meta: TensorMeta,
    host_decode_time: float,
    dnn_device_time: float,
    host_ops_per_sec: float = 2.0e9,
    device_ops_per_sec: float | None = None,
    measured_host_times: Sequence[float] | None = None,
    measured_device_times: Sequence[float] | None = None,
    device_dispatch_overhead_s: float = 0.0,
    device_fused: bool = True,
) -> Placement:
    """Pick the throughput-maximizing split point.

    ``host_decode_time`` — seconds/item of the (host-pinned) decode stage.
    ``dnn_device_time`` — seconds/item of DNN execution on the accelerator.
    Per-op times may be *measured* (preferred; what the engine calibrates)
    or estimated from weighted op counts.

    ``device_dispatch_overhead_s`` charges each device dispatch *group* a
    fixed launch cost.  Under the device compiler (``device_fused=True``) a
    fusible suffix is one group — one dispatch — so pushing ops to the
    device gets cheaper than the legacy per-op-dispatch model and the
    optimal split can move device-ward.
    """
    if device_ops_per_sec is None:
        device_ops_per_sec = host_ops_per_sec * DEFAULT_DEVICE_SPEEDUP
    host_times, device_times = _per_op_times(
        chain, in_meta, host_ops_per_sec, device_ops_per_sec,
        measured_host_times, measured_device_times,
    )
    group_counts = (
        [_suffix_groups_at(chain, in_meta, k, device_fused) for k in range(len(chain) + 1)]
        if device_dispatch_overhead_s > 0.0
        else [0] * (len(chain) + 1)
    )
    best: Placement | None = None
    for split in range(len(chain) + 1):
        cand = _split_candidate(
            chain, split, host_decode_time, dnn_device_time, host_times, device_times,
            device_groups=group_counts[split],
            device_dispatch_overhead_s=device_dispatch_overhead_s,
        )
        if best is None or cand.est_throughput > best.est_throughput:
            best = cand
    assert best is not None
    return best


def placement_out_meta(placement: Placement, in_meta: TensorMeta) -> TensorMeta:
    m = chain_out_meta(list(placement.host_ops), in_meta)
    return chain_out_meta(list(placement.device_ops), m)


# ------------------------------------------------- split decode (§6.4 x §6.3)
SPLIT_DECODE_POLICIES = ("off", "auto", "full", "scaled")
COEFF_FACTORS = (1, 2, 4)  # resolution divisors the scaled IDCT supports


@dataclasses.dataclass(frozen=True)
class SplitDecodeOption:
    """One costed way of running the split-decode placement.

    The host stops at the entropy stage and stages quantized coefficient
    blocks; the device program runs dequant + (scaled) IDCT at
    ``point = 8 // factor``, chroma upsampling (4:2:0), color conversion,
    the preprocessing chain on the 1/factor-resolution pixel grid, and the
    DNN — all ONE dispatch.  ``coeff_flops`` / ``chain_flops`` /
    ``staging_bytes`` are the per-factor costs the planner and the
    recalibrator learn over (the per-factor coefficient-FLOP and
    staging-byte cost model).
    """

    factor: int  # 1 (full res), 2 (half), 4 (quarter)
    point: int  # scaled-IDCT size = 8 // factor
    layout: str  # coefficient staging layout: "padded" | "packed"
    staging_bytes: int  # host->device bytes per item under `layout`
    coeff_flops: float  # coefficient-domain decode flops at this factor
    chain_flops: float  # preproc-chain flops on the scaled pixel grid
    est_throughput: float
    est_host_throughput: float
    est_device_throughput: float


def scaled_pixel_meta(geom: CoeffGeometry, factor: int) -> TensorMeta:
    hs, ws = geom.scaled_hw(factor)
    return TensorMeta((hs, ws, geom.channels), "uint8", "HWC")


def coeff_factor_valid(
    chain: Sequence[PreprocOp], geom: CoeffGeometry, factor: int
) -> bool:
    """Whether decoding at 1/factor still feeds the chain losslessly.

    The scaled decode must (a) keep the chain's *output* meta identical to
    the native-resolution plan (the DNN input contract), and (b) never
    force a resize to upscale or a crop to exceed the scaled frame —
    mirroring libjpeg draft semantics, where the scaled decode never
    undershoots the requested target.  ``factor > 1`` additionally
    requires a resize somewhere in the chain: without one, decoded
    resolution IS the output resolution and reducing it would change the
    answer, not just the arithmetic.
    """
    if factor == 1:
        return True
    native = scaled_pixel_meta(geom, 1)
    scaled = scaled_pixel_meta(geom, factor)
    try:
        if chain_out_meta(list(chain), scaled) != chain_out_meta(list(chain), native):
            return False
    except AssertionError:
        return False
    m, has_resize = scaled, False
    for op in chain:
        spec = op.lowering_spec(m)
        if spec is not None and spec.kind == "resize":
            has_resize = True
            oh, ow = spec.out_hw
            h, w = m.spatial
            if oh > h or ow > w:
                return False  # scaled decode undershot the resample target
        elif spec is not None and spec.kind == "crop":
            t, l, ch, cw = spec.crop
            h, w = m.spatial
            if t < 0 or l < 0 or t + ch > h or l + cw > w:
                return False
        m = op.out_meta(m)
    return has_resize


def enumerate_coeff_options(
    chain: Sequence[PreprocOp],
    geom: CoeffGeometry,
    host_entropy_time: float,
    dnn_device_time: float,
    device_ops_per_sec: float,
    device_dispatch_overhead_s: float = 0.0,
    factors: Sequence[int] = COEFF_FACTORS,
) -> list[SplitDecodeOption]:
    """Cost every valid scaled-IDCT factor for one stream geometry.

    ``host_entropy_time`` is the measured seconds/item of the host-pinned
    entropy stage alone (vs. ``host_decode_time`` = the full pixel
    decode).  The whole coefficient program is ONE dispatch group, so the
    overhead term is charged once regardless of factor.  The staging
    layout is chosen by byte cost: packed wins for 4:2:0 (chroma at
    native quarter-density), and ties resolve to the padded layout 4:4:4
    streams already stage.
    """
    # the staging layout is factor-invariant: the staged tensor is always
    # the full coefficient set, only the device-side math scales
    layout = coeff_staging_layout(geom)
    staging = coeff_staging_bytes(geom, layout)
    options = []
    for factor in factors:
        if factor not in COEFF_FACTORS or not coeff_factor_valid(chain, geom, factor):
            continue
        c_flops = coeff_device_flops(geom, factor)
        p_flops = chain_flops(list(chain), scaled_pixel_meta(geom, factor))
        t_dev = (
            device_stage_seconds(
                c_flops + p_flops, 1, device_ops_per_sec, device_dispatch_overhead_s
            )
            + dnn_device_time
        )
        tput_host = 1.0 / host_entropy_time if host_entropy_time > 0 else float("inf")
        tput_dev = 1.0 / t_dev if t_dev > 0 else float("inf")
        options.append(
            SplitDecodeOption(
                factor=factor,
                point=8 // factor,
                layout=layout,
                staging_bytes=staging,
                coeff_flops=c_flops,
                chain_flops=p_flops,
                est_throughput=min(tput_host, tput_dev),
                est_host_throughput=tput_host,
                est_device_throughput=tput_dev,
            )
        )
    return options


def choose_coeff_option(
    chain: Sequence[PreprocOp],
    geom: CoeffGeometry,
    host_entropy_time: float,
    dnn_device_time: float,
    device_ops_per_sec: float,
    device_dispatch_overhead_s: float = 0.0,
    policy: str = "auto",
) -> SplitDecodeOption | None:
    """Best split-decode option under ``policy``, or None.

    ``"full"`` pins factor 1 (the legacy split-decode path), ``"scaled"``
    insists on a reduced-resolution factor (falling back to 1 when no
    scaled factor is valid), ``"auto"`` lets the cost model pick across
    all factors.  Ties break toward the larger factor (same predicted
    throughput, strictly less staged work downstream).
    """
    if policy == "off":
        return None
    if policy not in SPLIT_DECODE_POLICIES:
        raise ValueError(f"split_decode must be one of {SPLIT_DECODE_POLICIES}, got {policy!r}")
    factors = {"full": (1,), "scaled": (4, 2, 1), "auto": COEFF_FACTORS}[policy]
    options = enumerate_coeff_options(
        chain,
        geom,
        host_entropy_time,
        dnn_device_time,
        device_ops_per_sec,
        device_dispatch_overhead_s,
        factors=factors,
    )
    if not options:
        return None
    if policy == "scaled":
        scaled = [o for o in options if o.factor > 1]
        if scaled:
            return max(scaled, key=lambda o: (o.est_throughput, o.factor))
    return max(options, key=lambda o: (o.est_throughput, o.factor))
