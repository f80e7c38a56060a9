"""Preprocessing operator library.

Each operator carries BOTH a host (numpy) and a device (torch)
implementation of the *same* algorithm, plus a cost function counting
arithmetic operations weighted by dtype width — the paper's §6.2 cost
heuristic.  The DAG optimizer (core/dag.py) reorders/fuses/prunes chains of
these ops; the placement optimizer (core/placement.py) decides, per op,
whether the host or device implementation runs (§6.3).

Shapes are (H, W, C) uint8 at the pipeline head ("HWC" layout); the DNN
consumes (C, H, W) float ("CHW").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

_DTYPE_WEIGHT = {"uint8": 1.0, "int16": 2.0, "float16": 2.0, "bfloat16": 2.0, "float32": 4.0}


@dataclasses.dataclass(frozen=True)
class LoweringSpec:
    """How one op lowers into the device preprocessing compiler's fused
    program (core/device_compiler.py).

    ``kind``:
      * ``"resize"`` — bilinear resample to ``out_hw`` (static, derived from
        the incoming TensorMeta);
      * ``"crop"`` — static slice ``crop = (top, left, height, width)``;
      * ``"affine"`` — folds into the per-channel ``x * scale + bias`` FMA
        (ToFloat/Normalize and their fusion products);
      * ``"layout"`` — HWC -> CHW, absorbed structurally (the fused program
        computes in planar CHW throughout).

    Ops that return ``None`` from :meth:`PreprocOp.lowering_spec` are opaque
    to the compiler: they break fusion groups and execute via the per-op
    ``apply_device`` reference chain (still inside one jitted program).
    """

    kind: str
    out_hw: tuple[int, int] | None = None  # resize target
    crop: tuple[int, int, int, int] | None = None  # top, left, height, width
    to_chw: bool = False  # affine product that also permutes layout


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    shape: tuple[int, ...]  # spatial-first: (H, W, C) or (C, H, W)
    dtype: str
    layout: str  # "HWC" | "CHW"

    @property
    def spatial(self) -> tuple[int, int]:
        return (self.shape[0], self.shape[1]) if self.layout == "HWC" else (self.shape[1], self.shape[2])

    @property
    def channels(self) -> int:
        return self.shape[2] if self.layout == "HWC" else self.shape[0]

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape))


def bilinear_coords(in_dim: int, out_dim: int, xp=np):
    """Half-pixel-center bilinear sample coordinates for one axis:
    ``(i0, i1, w1)`` — int32 neighbor indices and the float32 weight of
    ``i1`` (so a sample is ``v[i0] * (1 - w1) + v[i1] * w1``).

    This is THE source of the resampling arithmetic.  The host/device
    resize below, the kernel interpolation matrices
    (``kernels/fused_preproc/ops.bilinear_matrix``) and the device
    compiler's gather lowering all build from it; keeping one copy is what
    keeps the fused program bit-compatible with the reference chain.
    """
    s = (xp.arange(out_dim, dtype=xp.float32) + 0.5) * (in_dim / out_dim) - 0.5
    s = xp.clip(s, 0.0, in_dim - 1.0)
    i0 = xp.floor(s).astype(xp.int32)
    i1 = xp.minimum(i0 + 1, in_dim - 1)
    return i0, i1, s - i0


def _bilinear_resize(x, out_h: int, out_w: int, xp):
    """Half-pixel-center bilinear resize; identical math for numpy and torch.

    Operates on (H, W, C) float arrays (``xp=np``) or tensors
    (``xp=torch``); the sample coordinates always come from the numpy
    ``bilinear_coords``, so both sides gather with bit-identical weights.
    """
    h, w = x.shape[0], x.shape[1]
    y0, y1, wy = bilinear_coords(h, out_h, np)
    x0, x1, wx = bilinear_coords(w, out_w, np)
    if xp is torch:
        y0, y1, x0, x1 = (torch.from_numpy(v).to(x.device, torch.long) for v in (y0, y1, x0, x1))
        # the float32 weights of the reference's jnp path (numpy promotes
        # the exact float32 - int32 difference to float64)
        wy, wx = (torch.from_numpy(v.astype(np.float32)).to(x.device) for v in (wy, wx))
    wy = wy[:, None, None]
    wx = wx[None, :, None]
    a = x[y0][:, x0]
    b = x[y0][:, x1]
    c = x[y1][:, x0]
    d = x[y1][:, x1]
    top = a + (b - a) * wx
    bot = c + (d - c) * wx
    return top + (bot - top) * wy


def _resize_host(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    y = _bilinear_resize(x.astype(np.float32), out_h, out_w, np)
    if str(x.dtype) == "uint8":
        return np.clip(np.round(y), 0, 255).astype(np.uint8)
    return y.astype(x.dtype)


def _resize_device(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    y = _bilinear_resize(x.to(torch.float32), out_h, out_w, torch)
    if x.dtype == torch.uint8:
        # torch.round is half-to-even, like np.round: the re-quantized grid
        # matches the host chain's
        return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    return y.to(x.dtype)


class PreprocOp:
    """Base preprocessing operator."""

    name: str = "op"
    elementwise: bool = False  # fusable with adjacent elementwise ops

    def out_meta(self, m: TensorMeta) -> TensorMeta:
        raise NotImplementedError

    def apply_host(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_device(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def flops(self, m: TensorMeta) -> float:
        """Weighted arithmetic-op count (paper §6.2 cost heuristic)."""
        raise NotImplementedError

    def spec(self) -> tuple[Any, ...]:
        """Hashable identity for plan caching."""
        return (type(self).__name__,)

    def lowering_spec(self, m: TensorMeta) -> "LoweringSpec | None":
        """Fusion-eligibility protocol for the device compiler.

        Returns a :class:`LoweringSpec` describing how this op folds into a
        single fused device program, or ``None`` when the op is opaque
        (not fusible — the compiler falls back to ``apply_device``).
        """
        return None

    def __repr__(self) -> str:
        return f"{type(self).__name__}{self.spec()[1:]}"


@dataclasses.dataclass(frozen=True, repr=False)
class ResizeShortSide(PreprocOp):
    """Aspect-preserving resize so the short edge equals ``target``."""

    target: int
    name = "resize_short"

    def _out_hw(self, h: int, w: int) -> tuple[int, int]:
        s = self.target / min(h, w)
        return max(self.target, round(h * s)), max(self.target, round(w * s))

    def out_meta(self, m: TensorMeta) -> TensorMeta:
        assert m.layout == "HWC", "resize before layout change"
        oh, ow = self._out_hw(*m.spatial)
        return TensorMeta((oh, ow, m.channels), m.dtype, "HWC")

    def apply_host(self, x):
        return _resize_host(x, *self._out_hw(x.shape[0], x.shape[1]))

    def apply_device(self, x):
        return _resize_device(x, *self._out_hw(x.shape[0], x.shape[1]))

    def flops(self, m: TensorMeta) -> float:
        oh, ow = self._out_hw(*m.spatial)
        return 8.0 * oh * ow * m.channels * _DTYPE_WEIGHT.get(m.dtype, 4.0)

    def spec(self):
        return ("ResizeShortSide", self.target)

    def lowering_spec(self, m: TensorMeta) -> LoweringSpec:
        return LoweringSpec("resize", out_hw=self._out_hw(*m.spatial))


@dataclasses.dataclass(frozen=True, repr=False)
class Resize(PreprocOp):
    """Resize to an exact (h, w)."""

    height: int
    width: int
    name = "resize"

    def out_meta(self, m: TensorMeta) -> TensorMeta:
        assert m.layout == "HWC"
        return TensorMeta((self.height, self.width, m.channels), m.dtype, "HWC")

    def apply_host(self, x):
        return _resize_host(x, self.height, self.width)

    def apply_device(self, x):
        return _resize_device(x, self.height, self.width)

    def flops(self, m: TensorMeta) -> float:
        return 8.0 * self.height * self.width * m.channels * _DTYPE_WEIGHT.get(m.dtype, 4.0)

    def spec(self):
        return ("Resize", self.height, self.width)

    def lowering_spec(self, m: TensorMeta) -> LoweringSpec:
        return LoweringSpec("resize", out_hw=(self.height, self.width))


@dataclasses.dataclass(frozen=True, repr=False)
class CenterCrop(PreprocOp):
    size: int
    name = "center_crop"

    def out_meta(self, m: TensorMeta) -> TensorMeta:
        assert m.layout == "HWC"
        return TensorMeta((self.size, self.size, m.channels), m.dtype, "HWC")

    def _offsets(self, h: int, w: int) -> tuple[int, int]:
        return (h - self.size) // 2, (w - self.size) // 2

    def apply_host(self, x):
        t, l = self._offsets(x.shape[0], x.shape[1])
        return x[t : t + self.size, l : l + self.size]

    def apply_device(self, x):
        t, l = self._offsets(x.shape[0], x.shape[1])
        return x[t : t + self.size, l : l + self.size]

    def flops(self, m: TensorMeta) -> float:
        return 0.0  # pure slicing

    def spec(self):
        return ("CenterCrop", self.size)

    def lowering_spec(self, m: TensorMeta) -> LoweringSpec:
        t, l = self._offsets(*m.spatial)
        return LoweringSpec("crop", crop=(t, l, self.size, self.size))


@dataclasses.dataclass(frozen=True, repr=False)
class ToFloat(PreprocOp):
    """uint8 -> float32 in [0, 1]."""

    scale: float = 1.0 / 255.0
    name = "to_float"
    elementwise = True

    def out_meta(self, m: TensorMeta) -> TensorMeta:
        return TensorMeta(m.shape, "float32", m.layout)

    def apply_host(self, x):
        return x.astype(np.float32) * np.float32(self.scale)

    def apply_device(self, x):
        return x.to(torch.float32) * float(np.float32(self.scale))

    def flops(self, m: TensorMeta) -> float:
        return 2.0 * m.numel * _DTYPE_WEIGHT["float32"]

    def spec(self):
        return ("ToFloat", self.scale)

    def lowering_spec(self, m: TensorMeta) -> LoweringSpec:
        return LoweringSpec("affine")


@dataclasses.dataclass(frozen=True, repr=False)
class Normalize(PreprocOp):
    """(x - mean) / std per channel (expects float input)."""

    mean: tuple[float, ...] = (0.485, 0.456, 0.406)
    std: tuple[float, ...] = (0.229, 0.224, 0.225)
    name = "normalize"
    elementwise = True

    def _mean_std(self, layout: str, channels: int):
        mean = np.asarray(self.mean[:channels], dtype=np.float32)
        std = np.asarray(self.std[:channels], dtype=np.float32)
        if layout == "CHW":
            return mean[:, None, None], std[:, None, None]
        return mean, std

    def out_meta(self, m: TensorMeta) -> TensorMeta:
        return m

    @staticmethod
    def _layout_of(x) -> str:
        return "CHW" if x.shape[0] in (1, 3) and x.shape[-1] not in (1, 3) else "HWC"

    def apply_host(self, x):
        layout = self._layout_of(x)
        c = x.shape[0] if layout == "CHW" else x.shape[-1]
        mean, std = self._mean_std(layout, c)
        return (x - mean) / std

    def apply_device(self, x):
        layout = self._layout_of(x)
        c = x.shape[0] if layout == "CHW" else x.shape[-1]
        mean, std = (torch.from_numpy(v).to(x.device) for v in self._mean_std(layout, c))
        return (x - mean) / std

    def flops(self, m: TensorMeta) -> float:
        return 2.0 * m.numel * _DTYPE_WEIGHT["float32"]

    def spec(self):
        return ("Normalize", self.mean, self.std)

    def lowering_spec(self, m: TensorMeta) -> LoweringSpec:
        return LoweringSpec("affine")


@dataclasses.dataclass(frozen=True, repr=False)
class ChannelsFirst(PreprocOp):
    """HWC -> CHW."""

    name = "channels_first"
    elementwise = True  # pure permutation; fusable into the elementwise kernel

    def out_meta(self, m: TensorMeta) -> TensorMeta:
        assert m.layout == "HWC"
        h, w, c = m.shape
        return TensorMeta((c, h, w), m.dtype, "CHW")

    def apply_host(self, x):
        return np.ascontiguousarray(np.transpose(x, (2, 0, 1)))

    def apply_device(self, x):
        return x.permute(2, 0, 1)

    def flops(self, m: TensorMeta) -> float:
        return 0.5 * m.numel * _DTYPE_WEIGHT.get(m.dtype, 4.0)  # pure data movement

    def spec(self):
        return ("ChannelsFirst",)

    def lowering_spec(self, m: TensorMeta) -> LoweringSpec:
        return LoweringSpec("layout", to_chw=True)


@dataclasses.dataclass(frozen=True, repr=False)
class FusedElementwise(PreprocOp):
    """Fusion product of a run of elementwise ops (ToFloat/Normalize/
    ChannelsFirst).  One pass over the data: the §6.2 'fusion always
    improves performance' rule, realised either as a single numpy
    expression (host) or one torch expression (device)."""

    ops: tuple[PreprocOp, ...]
    name = "fused_elementwise"
    elementwise = True

    def out_meta(self, m: TensorMeta) -> TensorMeta:
        for op in self.ops:
            m = op.out_meta(m)
        return m

    def _folded(self, channels: int) -> tuple[np.ndarray, np.ndarray, bool]:
        """Fold the op run into (scale, bias, transpose?) applied as
        x*scale + bias — a single FMA per element."""
        return fold_affine(self.ops, channels)

    def apply_host(self, x):
        channels = x.shape[-1]
        scale, bias, transpose = self._folded(channels)
        y = x.astype(np.float32) * scale + bias
        if transpose:
            y = np.ascontiguousarray(np.transpose(y, (2, 0, 1)))
        return y

    def apply_device(self, x):
        channels = x.shape[-1]
        scale, bias, transpose = self._folded(channels)
        scale, bias = (torch.from_numpy(v).to(x.device) for v in (scale, bias))
        y = x.to(torch.float32) * scale + bias
        if transpose:
            y = y.permute(2, 0, 1)
        return y

    def flops(self, m: TensorMeta) -> float:
        # single fused pass: one multiply-add per element (+ optional move)
        return 2.0 * m.numel * _DTYPE_WEIGHT["float32"]

    def spec(self):
        return ("FusedElementwise",) + tuple(op.spec() for op in self.ops)

    def lowering_spec(self, m: TensorMeta) -> LoweringSpec:
        return LoweringSpec(
            "affine", to_chw=any(isinstance(op, ChannelsFirst) for op in self.ops)
        )


def fold_affine(ops: Sequence[PreprocOp], channels: int) -> tuple[np.ndarray, np.ndarray, bool]:
    """Fold a run of elementwise ops into ``(scale, bias, transpose?)``
    applied as ``x * scale + bias`` — one FMA per element.  Accepts
    ToFloat/Normalize/ChannelsFirst and nested FusedElementwise products."""
    scale = np.ones(channels, dtype=np.float32)
    bias = np.zeros(channels, dtype=np.float32)
    transpose = False
    for op in ops:
        if isinstance(op, FusedElementwise):
            s, b, t = fold_affine(op.ops, channels)
            scale *= s
            bias = bias * s + b
            transpose = transpose or t
        elif isinstance(op, ToFloat):
            scale *= np.float32(op.scale)
            bias *= np.float32(op.scale)
        elif isinstance(op, Normalize):
            std = np.asarray(op.std[:channels], np.float32)
            mean = np.asarray(op.mean[:channels], np.float32)
            scale /= std
            bias = (bias - mean) / std
        elif isinstance(op, ChannelsFirst):
            transpose = True
        else:
            raise TypeError(f"not elementwise-fusable: {op}")
    return scale, bias, transpose


def apply_chain_host(ops: list[PreprocOp], x: np.ndarray) -> np.ndarray:
    for op in ops:
        x = op.apply_host(x)
    return x


def apply_chain_device(ops: list[PreprocOp], x: torch.Tensor) -> torch.Tensor:
    for op in ops:
        x = op.apply_device(x)
    return x


def chain_out_meta(ops: list[PreprocOp], m: TensorMeta) -> TensorMeta:
    for op in ops:
        m = op.out_meta(m)
    return m


def chain_flops(ops: list[PreprocOp], m: TensorMeta) -> float:
    total = 0.0
    for op in ops:
        total += op.flops(m)
        m = op.out_meta(m)
    return total


STANDARD_RESNET_CHAIN: list[PreprocOp] = [
    ResizeShortSide(256),
    CenterCrop(224),
    ToFloat(),
    Normalize(),
    ChannelsFirst(),
]
