"""Preprocessing-DAG optimizer (paper §6.2).

SMOL accepts the preprocessing steps as a computation DAG and optimizes it
in three phases, exactly as the paper describes:

1. **Exhaustive plan generation** under the legal-reordering rules:
   (R1) normalization and dtype conversion can be placed at any point,
   (R2) normalization, dtype conversion and channel reordering can fuse,
   (R3) resizing and cropping can be swapped (geometry-adjusted).
2. **Rule-based pruning**:
   (P1) resizing is cheaper with fewer pixels,
   (P2) resizing is cheaper with smaller data types,
   (P3) fusion always improves performance.
3. **Cost-based selection**: count weighted arithmetic ops per plan
   (ops.PreprocOp.flops) and pick the cheapest.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

from repro_torch.preprocessing import ops as P
from repro_torch.preprocessing.ops import PreprocOp, TensorMeta


@dataclasses.dataclass(frozen=True, repr=False)
class CenterCropFraction(PreprocOp):
    """Center-crop a square of ``round(frac * min(h, w))`` pixels.

    Appears only as the geometry-adjusted product of swapping
    ResizeShortSide(s) + CenterCrop(c)  ->  CenterCropFraction(c/s) + Resize(c, c).
    """

    frac: float
    name = "center_crop_frac"

    def _size(self, h: int, w: int) -> int:
        return max(1, round(self.frac * min(h, w)))

    def out_meta(self, m: TensorMeta) -> TensorMeta:
        assert m.layout == "HWC"
        s = self._size(*m.spatial)
        return TensorMeta((s, s, m.channels), m.dtype, "HWC")

    def apply_host(self, x):
        s = self._size(x.shape[0], x.shape[1])
        t, l = (x.shape[0] - s) // 2, (x.shape[1] - s) // 2
        return x[t : t + s, l : l + s]

    def apply_device(self, x):
        return self.apply_host(x)  # pure slicing works for jnp too

    def flops(self, m: TensorMeta) -> float:
        return 0.0

    def spec(self):
        return ("CenterCropFraction", round(self.frac, 6))

    def lowering_spec(self, m: TensorMeta) -> P.LoweringSpec:
        h, w = m.spatial
        s = self._size(h, w)
        return P.LoweringSpec("crop", crop=((h - s) // 2, (w - s) // 2, s, s))


@dataclasses.dataclass
class DagPlan:
    ops: list[PreprocOp]
    cost: float
    in_meta: TensorMeta

    @property
    def out_meta(self) -> TensorMeta:
        return P.chain_out_meta(self.ops, self.in_meta)

    def apply_host(self, x):
        return P.apply_chain_host(self.ops, x)

    def apply_device(self, x):
        return P.apply_chain_device(self.ops, x)

    def __repr__(self) -> str:
        return f"DagPlan(cost={self.cost:.3g}, ops={self.ops})"


def _is_spatial(op: PreprocOp) -> bool:
    return isinstance(op, (P.ResizeShortSide, P.Resize, P.CenterCrop, CenterCropFraction))


def _spatial_variants(spatial: list[PreprocOp]) -> list[list[PreprocOp]]:
    """Rule R3: swap resize<->crop where geometry allows."""
    variants = [list(spatial)]
    for i in range(len(spatial) - 1):
        a, b = spatial[i], spatial[i + 1]
        if isinstance(a, P.ResizeShortSide) and isinstance(b, P.CenterCrop):
            swapped = list(spatial)
            swapped[i] = CenterCropFraction(b.size / a.target)
            swapped[i + 1] = P.Resize(b.size, b.size)
            variants.append(swapped)
    return variants


def enumerate_plans(
    chain: list[PreprocOp],
    in_meta: TensorMeta,
    allow_approx: bool = True,
) -> list[list[PreprocOp]]:
    """Exhaustively generate legal plans (phase 1).

    ``allow_approx=False`` restricts to bit-identical transforms (fusion of
    elementwise runs only); ``True`` additionally enables R1/R3, which
    change numerics within resampling tolerance — the trade the paper makes
    explicitly when it reorders INT8 vs FLOAT32 resizes.
    """
    spatial = [op for op in chain if _is_spatial(op)]
    movable = [op for op in chain if isinstance(op, (P.ToFloat, P.Normalize))]
    trailing = [op for op in chain if isinstance(op, P.ChannelsFirst)]
    other = [
        op
        for op in chain
        if not _is_spatial(op) and op not in movable and op not in trailing
    ]
    if other:
        # Unknown ops: keep the chain as-is, only fuse.
        return [chain]

    if not allow_approx:
        return [chain]

    plans: list[list[PreprocOp]] = []
    spatial_vs = _spatial_variants(spatial) if allow_approx else [spatial]
    for sp in spatial_vs:
        n_slots = len(sp) + 1
        # R1: ToFloat at any slot; Normalize at any slot >= ToFloat's.
        for positions in itertools.product(range(n_slots), repeat=len(movable)):
            ok = all(positions[i] <= positions[i + 1] for i in range(len(positions) - 1))
            if not ok:
                continue
            plan: list[PreprocOp] = []
            for slot in range(n_slots):
                for op, pos in zip(movable, positions):
                    if pos == slot:
                        plan.append(op)
                if slot < len(sp):
                    plan.append(sp[slot])
            plan += trailing
            plans.append(plan)
    # Dedup by spec.
    seen, out = set(), []
    for plan in plans:
        key = tuple(op.spec() for op in plan)
        if key not in seen:
            seen.add(key)
            out.append(plan)
    return out


def fuse_elementwise(chain: list[PreprocOp]) -> list[PreprocOp]:
    """Rule R2 / P3: greedily fuse maximal runs of elementwise ops."""
    out: list[PreprocOp] = []
    run: list[PreprocOp] = []

    def flush():
        nonlocal run
        if len(run) >= 2:
            out.append(P.FusedElementwise(tuple(run)))
        else:
            out.extend(run)
        run = []

    for op in chain:
        if op.elementwise and not isinstance(op, P.FusedElementwise):
            run.append(op)
        else:
            flush()
            out.append(op)
    flush()
    return out


def device_fusion_groups(
    ops: Sequence[PreprocOp], in_meta: TensorMeta
) -> list[list[PreprocOp]]:
    """Partition a device-op suffix into maximal device-fusible groups.

    The device compiler (core/device_compiler.py) lowers one group into one
    fused program stage — a single device dispatch.  A group is a maximal
    run of ops whose :meth:`~repro_torch.preprocessing.ops.PreprocOp.lowering_spec`
    is non-None, containing at most one resize (a second resample needs its
    own interpolation pass and starts a new group).  Opaque ops are
    singleton groups: they execute via the per-op ``apply_device`` path.

    The group count is what the placement cost model charges per-dispatch
    overhead on: a fused group is ONE dispatch, not a sum of op dispatches.
    """
    groups: list[list[PreprocOp]] = []
    run: list[PreprocOp] = []
    run_has_resize = False
    m = in_meta
    for op in ops:
        spec = op.lowering_spec(m)
        if spec is None:
            if run:
                groups.append(run)
                run, run_has_resize = [], False
            groups.append([op])
        else:
            if spec.kind == "resize" and run_has_resize:
                groups.append(run)
                run, run_has_resize = [], False
            run.append(op)
            run_has_resize = run_has_resize or spec.kind == "resize"
        m = op.out_meta(m)
    if run:
        groups.append(run)
    return groups


def _violates_pruning(plan: list[PreprocOp], in_meta: TensorMeta) -> bool:
    """Phase 2 rule-based pruning (P1/P2).

    A plan is pruned if some other trivially-better ordering exists:
    - a Normalize/ToFloat placed *before* a resize makes that resize run on
      float32 over >= as many pixels (P2), and
    - a resize placed before a crop runs on more pixels than needed (P1)
      unless the crop needs the resized geometry (ResizeShortSide+CenterCrop
      is kept: it is the reference plan's semantics).
    """
    m = in_meta
    seen_float = False
    for op in plan:
        if isinstance(op, (P.ToFloat, P.Normalize)):
            seen_float = True
        if isinstance(op, (P.Resize, P.ResizeShortSide)) and seen_float:
            return True  # P2: resizing in float32 is never the cheapest plan here
        m = op.out_meta(m)
    return False


def optimize(
    chain: list[PreprocOp],
    in_meta: TensorMeta,
    allow_approx: bool = True,
    return_all: bool = False,
):
    """Full §6.2 pipeline: enumerate -> prune -> fuse -> cost-select."""
    candidates = enumerate_plans(chain, in_meta, allow_approx=allow_approx)
    kept = [p for p in candidates if not _violates_pruning(p, in_meta)] or candidates
    fused = [fuse_elementwise(p) for p in kept]  # P3: fusion always improves
    scored = [DagPlan(p, P.chain_flops(p, in_meta), in_meta) for p in fused]
    scored.sort(key=lambda pl: pl.cost)
    if return_all:
        return scored
    return scored[0]
