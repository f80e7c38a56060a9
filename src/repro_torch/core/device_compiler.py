"""Device preprocessing compiler: Placement suffix -> ONE device program.

The placement optimizer (core/placement.py) splits a preprocessing chain at
k: ops[:k] run on host workers, ops[k:] on the card.  This module lowers
the device suffix (paper §6.2's fusion, pushed device-side) exactly as
``repro.core.device_compiler`` does:

* the suffix is partitioned into fusion groups (core/dag.py
  ``device_fusion_groups``) via each op's ``lowering_spec()`` protocol;
* a single-group suffix matching ``[crop?] resize? [crop?] affine* layout?``
  lowers to ONE fused resample+affine stage — on CUDA the
  ``kernels/fused_preproc`` gather kernel, on the CPU its plain version,
  both bit-compatible with the host chain's arithmetic;
* crops fold into the bilinear tap tables (a crop before the resize is an
  index offset, a crop after it a slice of the tables — zero cost), and the
  ChannelsFirst layout change is absorbed structurally because the fused
  stage computes in planar CHW throughout;
* non-fusible suffixes fall back to the per-op reference chain;
* the DNN runs in the same program, so preproc + DNN is one dispatch per
  batch: one host-to-device copy of the staged batch, then the stage and
  the model under ``torch.inference_mode()`` on the device's current
  stream.

:class:`ProgramSet` holds one program per batch bucket (the reference's one
AOT-compiled executable per bucket).  On a CUDA device ``warm()`` captures
each bucket's whole program — stage kernels and DNN — as one
``torch.cuda.CUDAGraph``; a dispatch of a captured program is then one copy
into the graph's static input, one replay and one copy of its output.

:func:`compile_coeff_program` extends the lowering upstream of pixels: the
host stops after the entropy stage (``jpeg.decode_to_coefficients``) and
the program runs dequantize+IDCT on the ``kernels/idct`` kernel (K1, reading
the staged int16 zigzag rows in place), unblockify + chroma upsample + JFIF
color conversion on the ``kernels/blocks_to_rgb`` kernel (K5), then the
fused preprocessing stage and the DNN — the paper's §6.4 split-decode
placement.

Every constant operand — the zigzag-ordered IDCT matrices, the colour
matrix, the bilinear tap tables, the folded scale/bias — is a device
tensor built once when the program is built, never per call.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, MutableMapping, Sequence

import numpy as np
import torch

from repro_torch.core import dag as dag_mod
from repro_torch.device import LogicalDevice, resolve_device
from repro_torch.distributed.sharding import BatchSharding
from repro_torch.kernels import _build
from repro_torch.kernels.blocks_to_rgb import ops as b2r_ops
from repro_torch.kernels.fused_preproc import ops as fp_ops
from repro_torch.kernels.fused_preproc import plain as fp_plain
from repro_torch.kernels.idct import ops as idct_ops
from repro_torch.preprocessing import ops as P
from repro_torch.preprocessing.ops import PreprocOp, TensorMeta

FUSED_IMPLS = ("auto", "kernel", "plain")


def resolve_impl(impl: str, device: torch.device) -> str:
    """The fused-stage implementation: ``"kernel"`` (the CUDA kernel; its
    wrapper runs the plain version on CPU tensors) or ``"plain"``.
    ``"auto"`` is the kernel on a CUDA device and the plain version on the
    CPU."""
    if impl not in FUSED_IMPLS:
        raise ValueError(f"fused impl must be one of {FUSED_IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    return "kernel" if device.type == "cuda" else "plain"


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------- dispatch calibration
_MEASURED_DISPATCH_S: dict[tuple[str, str], float] = {}


def _dispatch_memo_key(device: torch.device) -> tuple[str, str]:
    """Memo identity for dispatch-overhead measurements: (type, card name)."""
    if device.type == "cuda":
        return ("cuda", torch.cuda.get_device_name(device))
    return (device.type, "")


def measure_dispatch_overhead(
    iters: int = 24, force: bool = False, device: str | torch.device | None = None
) -> float:
    """Measured per-dispatch launch overhead: one *empty* device dispatch.

    Runs a trivial program once outside the clock and takes the best of
    ``iters`` dispatch -> ``torch.cuda.synchronize`` round trips — the floor
    any device dispatch pays before doing work.  The result feeds the
    placement cost model's ``device_dispatch_overhead_s``.  Cached per
    (device type, card name).
    """
    dev = resolve_device(device)
    key = _dispatch_memo_key(dev)
    if key in _MEASURED_DISPATCH_S and not force:
        return _MEASURED_DISPATCH_S[key]
    x = torch.zeros(8, dtype=torch.float32, device=dev)
    x + 1.0
    synchronize(dev)  # first launch + allocator warm outside the clock
    best = float("inf")
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        x + 1.0
        synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    _MEASURED_DISPATCH_S[key] = best
    return best


# ------------------------------------------------------------- program cache
@dataclasses.dataclass(frozen=True)
class ProgramCacheStats:
    max_entries: int
    entries: int
    hits: int  # program reuses (cache lookups that found a program)
    misses: int  # compiles (insertions of a freshly-built program)
    evictions: int  # LRU removals forced by max_entries
    pinned: int = 0  # entries held non-evictable


class ProgramCache(MutableMapping):
    """Bounded LRU cache for compiled device programs.

    Drop-in for the plain dict ``compile_device_program`` /
    ``compile_coeff_program`` accept as ``cache``: lookups refresh recency,
    insertions evict the least-recently-used program once ``max_entries``
    is exceeded.  Pinned entries (refcounted) are never evicted; when every
    other entry is pinned the cache grows past its bound rather than evict
    one.
    """

    def __init__(self, max_entries: int = 16):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._data: dict = {}  # insertion/recency ordered (py3.7+ dicts)
        self._pins: dict = {}  # key -> pin refcount
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def __getitem__(self, key):
        prog = self._data.pop(key)  # KeyError propagates
        self._data[key] = prog  # re-insert at the hot end
        self._hits += 1
        return prog

    def __setitem__(self, key, program) -> None:
        if key in self._data:
            self._data.pop(key)
        else:
            self._misses += 1
        self._data[key] = program
        while len(self._data) > self.max_entries:
            victim = next(
                (k for k in self._data if k != key and k not in self._pins), None
            )
            if victim is None:
                break  # everything else resident is pinned: grow past the bound
            self._data.pop(victim)
            self._evictions += 1

    def pin(self, key) -> None:
        """Hold ``key`` non-evictable (refcounted; raises when absent)."""
        if key not in self._data:
            raise KeyError(key)
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key) -> None:
        """Drop one pin on ``key`` (no-op when not pinned)."""
        n = self._pins.get(key, 0)
        if n <= 1:
            self._pins.pop(key, None)
        else:
            self._pins[key] = n - 1

    def pinned(self, key) -> bool:
        """True while some bound program set holds ``key``."""
        return key in self._pins

    def __delitem__(self, key) -> None:
        del self._data[key]
        self._pins.pop(key, None)

    def __contains__(self, key) -> bool:  # no stats: peek, not use
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def stats(self) -> ProgramCacheStats:
        return ProgramCacheStats(
            max_entries=self.max_entries,
            entries=len(self._data),
            hits=self._hits,
            misses=self._misses,
            evictions=self._evictions,
            pinned=len(self._pins),
        )


def device_cache_key(device: Any) -> tuple:
    """Hashable cache identity of a program's target: the runtime's
    device, one logical device of the mesh, or a sharded replica group.
    Two logical devices of one card key apart: each holds its own program,
    per-batch tables and CUDA graphs, on its own stream."""
    if isinstance(device, BatchSharding):
        return ("sharded", tuple(d.label for d in device.devices))
    if isinstance(device, LogicalDevice):
        return ("logical", device.label)
    return ("device", str(device))


def _resolve_target(device: Any) -> tuple[torch.device, Any]:
    """(physical device, mesh target or None) of a program's ``device``
    argument: a device name, a :class:`LogicalDevice` or a
    :class:`BatchSharding` (whose first member's device it reports)."""
    if isinstance(device, BatchSharding):
        return device.devices[0].device, device
    if isinstance(device, LogicalDevice):
        return device.device, device
    return resolve_device(device), None


def _place(batch: Any, device: torch.device) -> torch.Tensor:
    """Commit a staged host batch to the program's device.

    From pinned staging memory the copy is asynchronous; the engine keeps
    the staging buffer leased until the batch retires, so the copy never
    reads a recycled buffer."""
    if not torch.is_tensor(batch):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    return batch.to(device, non_blocking=True)


# ------------------------------------------------------------------- lowering
@dataclasses.dataclass(frozen=True)
class Lowering:
    """Fused-stage plan for one device suffix: static geometry + folded affine."""

    in_meta: TensorMeta
    out_meta: TensorMeta
    pre_crop: tuple[int, int, int, int] | None  # (top, left, h, w) before resize
    resize: tuple[int, int] | None  # (oh, ow) resample target
    post_crop: tuple[int, int, int, int] | None  # (top, left, h, w) after resize
    round_uint8: bool  # resample re-quantizes to the integer pixel grid
    scale: tuple[float, ...]  # per-channel folded multiplier
    bias: tuple[float, ...]  # per-channel folded offset
    stages: tuple[str, ...]  # human-readable lowering description


def _compose_crop(first, second):
    """second applied after first: offsets accumulate, extent is second's."""
    if first is None:
        return second
    ft, fl, _, _ = first
    st, sl, sh, sw = second
    return (ft + st, fl + sl, sh, sw)


def lower_device_ops(device_ops: Sequence[PreprocOp], in_meta: TensorMeta) -> Lowering | None:
    """Pattern-match a device suffix into one fused stage, or None.

    Accepts any single fusion group (``dag.device_fusion_groups``): at most
    one resize, crops on either side of it (composed when repeated), any
    number of affine/layout ops anywhere — bilinear resampling is affine-
    invariant (weights sum to 1), so folded scale/bias commute past it.
    """
    if not device_ops:
        return None
    groups = dag_mod.device_fusion_groups(device_ops, in_meta)
    if len(groups) != 1:
        return None  # opaque op or second resample: reference chain fallback
    m = in_meta
    pre_crop = resize = post_crop = None
    round_uint8 = False
    affine_ops: list[PreprocOp] = []
    stages: list[str] = []
    for op in device_ops:
        spec = op.lowering_spec(m)
        assert spec is not None  # single group => every op lowered
        if spec.kind == "resize":
            resize = spec.out_hw
            round_uint8 = m.dtype == "uint8"
            stages.append(f"resize{m.spatial}->{spec.out_hw}" + ("+requant" if round_uint8 else ""))
        elif spec.kind == "crop":
            if resize is None:
                pre_crop = _compose_crop(pre_crop, spec.crop)
                stages.append(f"crop{spec.crop}")
            else:
                post_crop = _compose_crop(post_crop, spec.crop)
                stages.append(f"crop{spec.crop}<-folded-into-resize")
        elif spec.kind == "affine":
            affine_ops.append(op)
            stages.append(op.name)
        elif spec.kind == "layout":
            stages.append("chw")
        m = op.out_meta(m)
    scale, bias, _ = P.fold_affine(affine_ops, in_meta.channels)
    return Lowering(
        in_meta=in_meta,
        out_meta=m,
        pre_crop=pre_crop,
        resize=resize,
        post_crop=post_crop,
        round_uint8=round_uint8,
        scale=tuple(float(s) for s in scale),
        bias=tuple(float(b) for b in bias),
        stages=tuple(stages),
    )


# ------------------------------------------------------------ stage builders
def lowering_taps(low: Lowering) -> tuple[np.ndarray, ...] | None:
    """``(y0, y1, wy, x0, x1, wx)`` bilinear tap tables of a lowered resize,
    in the input's coordinates: the pre-resize crop is an index offset, the
    post-resize crop a slice.  None when the lowering has no resize."""
    if low.resize is None:
        return None
    h, w = low.in_meta.spatial
    t0, l0, ch, cw = low.pre_crop if low.pre_crop is not None else (0, 0, h, w)
    oh, ow = low.resize
    t, l, rows, cols = low.post_crop if low.post_crop is not None else (0, 0, oh, ow)
    return (
        *fp_ops.bilinear_taps(ch, oh, t, rows, offset=t0),
        *fp_ops.bilinear_taps(cw, ow, l, cols, offset=l0),
    )


def build_fused_stage(
    low: Lowering,
    impl: str,
    device: torch.device,
    input_planar: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The lowered preprocessing stage: (N, *in_meta.shape) -> out_meta batch.

    ``impl="kernel"`` resamples through ``kernels/fused_preproc``'s wrapper
    (the CUDA kernel on a CUDA tensor), ``"plain"`` through its plain
    version — the same expression tree as the reference's
    ``_resize_affine_jnp``.  Geometry is static, so the tap tables and the
    folded affine are device tensors built here, once.
    """
    channels = low.in_meta.channels
    scale = torch.tensor(low.scale, dtype=torch.float32, device=device)
    bias = torch.tensor(low.bias, dtype=torch.float32, device=device)
    taps_np = lowering_taps(low)
    taps = None if taps_np is None else [torch.from_numpy(v).to(device) for v in taps_np]
    resample = fp_ops.resize_affine_planar if impl == "kernel" else fp_plain.resize_affine_planar
    per_plane: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def stage(batch: torch.Tensor) -> torch.Tensor:
        x = batch.to(torch.float32)
        if not input_planar and low.in_meta.layout == "HWC":
            x = x.permute(0, 3, 1, 2)  # planar CHW compute layout
        n = x.shape[0]
        if taps is not None:
            if n not in per_plane:
                per_plane[n] = (scale.repeat(n), bias.repeat(n))
            s, b = per_plane[n]
            planes = x.reshape(n * channels, x.shape[2], x.shape[3]).contiguous()
            y = resample(planes, *taps, s, b, low.round_uint8)
            y = y.reshape(n, channels, taps[0].shape[0], taps[3].shape[0])
        else:
            if low.pre_crop is not None:
                t, l, ch, cw = low.pre_crop
                x = x[:, :, t : t + ch, l : l + cw]
            y = x * scale[None, :, None, None] + bias[None, :, None, None]
        if low.out_meta.layout == "HWC":
            y = y.permute(0, 2, 3, 1)
        if low.out_meta.dtype == "uint8":
            y = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
        elif low.out_meta.dtype != "float32":
            y = y.to(getattr(torch, low.out_meta.dtype))
        return y

    return stage


def _build_chain_stage(device_ops: Sequence[PreprocOp]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Reference fallback: the per-op apply_device fold over each item."""
    ops = list(device_ops)

    def stage(batch):
        return torch.stack([P.apply_chain_device(ops, im) for im in batch])

    return stage


# ------------------------------------------------------------------ programs
@dataclasses.dataclass
class DevicePreprocProgram:
    """One device program: preproc suffix + DNN, one dispatch per batch.

    Calling the program copies the staged batch to ``device`` and enqueues
    the whole stage + model on the device's current stream; it returns the
    output tensor without waiting.  A program bound to a mesh ``target``
    runs on that logical device's stream instead
    (:meth:`LogicalDevice.run`: the caller's stream waits for it), and a
    sharded group's program runs its ``members``, one per device of the
    group, each over its part of the batch, and joins their rows.
    ``dispatch_count`` tracks dispatches so tests (and the engine) can
    assert the one-dispatch-per-batch contract.
    ``build_seconds`` is the host-side cost of building the program (its
    constant tables included); ``first_dispatch_seconds`` is the wall time
    of dispatch #1 up to a device synchronize — the cold start that pays
    the kernels' build and the first launches.  Once :meth:`ProgramSet.warm`
    has captured the program as a CUDA graph (``graph``), every dispatch
    replays it.
    """

    fn: Callable[[torch.Tensor], Any]  # (device batch,) -> model outputs
    backend: str  # "fused" | "reference"
    impl: str  # "kernel" | "plain" | "chain" | "model-only"
    fused: bool  # True when the lowered resample+affine stage engaged
    stages: tuple[str, ...]
    key: tuple
    in_meta: TensorMeta
    out_meta: TensorMeta  # preprocessing output (the DNN's input)
    device: torch.device
    dispatch_count: int = 0
    build_seconds: float = 0.0
    first_dispatch_seconds: float | None = None
    batch_size: int = 0
    # invoked as listener(program, seconds) once the program's cold start is
    # paid: its first eager dispatch, or on CUDA its warm-up run plus graph
    # capture — the facade counts post-warmup compiles and emits "compile"
    # telemetry spans through it
    compile_listener: Callable[["DevicePreprocProgram", float], None] | None = None
    # True while ProgramSet.warm() is executing this program: the listener
    # can tell a startup warmup compile from a cold request-path compile
    _warming: bool = False
    # split-decode programs only: the scaled-IDCT resolution divisor and the
    # coefficient staging layout this program was compiled for
    coeff_factor: int | None = None
    coeff_layout: str | None = None
    # the program captured as one CUDA graph (ProgramSet.warm on CUDA)
    graph: "CapturedGraph | None" = None
    # the mesh target it is bound to (None: the runtime's device, on the
    # caller's current stream): a LogicalDevice or a BatchSharding
    target: Any = None
    # a sharded group's programs, one per device of the group, in order
    members: tuple["DevicePreprocProgram", ...] = ()

    @property
    def dispatches_per_batch(self) -> int:
        return 1  # the whole suffix + DNN is one dispatch (or one replay)

    def __call__(self, batch):
        self.dispatch_count += 1
        if self.members:
            return self._dispatch_members(batch)
        if self.target is not None:
            return self.target.run(self._dispatch, batch)
        return self._dispatch(batch)

    def _dispatch_members(self, batch):
        """Each member over its rows on its own stream, the rows joined in
        order on the caller's stream."""
        t0 = time.perf_counter()
        outs = [m(part) for m, part in zip(self.members, self.target.split(batch))]
        with torch.inference_mode():
            out = torch.cat([o.to(self.device) for o in outs])
        if self.dispatch_count == 1:
            synchronize(self.device)
            self.first_dispatch_seconds = time.perf_counter() - t0
            if self.compile_listener is not None:
                self.compile_listener(self, self.first_dispatch_seconds)
        return out

    def _dispatch(self, batch):
        if self.graph is not None:
            return self.graph.replay(batch)
        with torch.inference_mode():
            if self.dispatch_count == 1:
                t0 = time.perf_counter()
                out = self.fn(_place(batch, self.device))
                synchronize(self.device)
                self.first_dispatch_seconds = time.perf_counter() - t0
                if self.compile_listener is not None:
                    self.compile_listener(self, self.first_dispatch_seconds)
                return out
            return self.fn(_place(batch, self.device))


class _GraphPool:
    """The memory pool a ProgramSet's graphs share, and the order of their
    replays.  Graphs captured into one pool reuse each other's freed
    intermediates, so two of them must never run at once: every replay
    waits, on its own stream, for the set's previous replay to finish, and
    the host side of a replay (copy, launch, output copy) holds a lock."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.last_done: torch.cuda.Event | None = None


class CapturedGraph:
    """One bucket's program captured as a CUDA graph.

    ``static_in`` is the graph's input (bucket rows of the program's staged
    geometry) and ``static_out`` its output, both addresses the graph
    reads and writes on every replay.  :meth:`replay` copies a staged
    batch into ``static_in``, replays the graph and copies ``static_out``
    into a fresh tensor, all on the calling thread's current stream: the
    engine keeps several batches in flight, and the next replay overwrites
    ``static_out``.  ``kernel_launches`` maps each kernel wrapper that ran
    during capture to the number of its launches the graph holds — what one
    replay launches, since a replay bypasses the wrappers' counters."""

    def __init__(self, graph, static_in, static_out, pool: _GraphPool,
                 capture_seconds: float, kernel_launches: dict[str, int]):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.pool = pool
        self.capture_seconds = capture_seconds
        self.kernel_launches = dict(kernel_launches)
        self.replays = 0

    def replay(self, batch) -> torch.Tensor:
        src = batch if torch.is_tensor(batch) else torch.from_numpy(np.ascontiguousarray(batch))
        if tuple(src.shape) != tuple(self.static_in.shape):
            raise ValueError(
                f"graph captured for {tuple(self.static_in.shape)}, got {tuple(src.shape)}"
            )
        pool = self.pool
        with pool.lock, torch.inference_mode():
            stream = torch.cuda.current_stream(self.static_in.device)
            if pool.last_done is not None:
                stream.wait_event(pool.last_done)
            self.static_in.copy_(src, non_blocking=True)
            self.graph.replay()
            out = self.static_out.clone()
            done = torch.cuda.Event()
            done.record(stream)
            pool.last_done = done
            self.replays += 1
        return out


def _kernel_counters() -> dict[str, Any]:
    """The kernel wrappers a device program launches, by name."""
    return {"idct": idct_ops.idct_rows, "blocks_to_rgb": b2r_ops.blocks_to_rgb,
            "fused_preproc": fp_ops.resize_affine_planar}


def capture_program(prog: DevicePreprocProgram, bucket: int, pool: _GraphPool) -> CapturedGraph:
    """Capture ``prog`` at ``bucket`` rows as one CUDA graph.

    On a side stream: one eager dispatch on zeros first — it picks cuDNN's
    algorithms, fills the fused stage's per-batch tables, loads the kernel
    library and raises the kernels' shared-memory limits, none of which may
    happen inside a capture — then the capture itself, into the set's
    shared pool.  The capture is thread-local, so other threads' work
    (dispatchers reading results back) neither joins nor invalidates it,
    and so is the count of the kernels it holds: another replica's eager
    dispatch meanwhile is not counted.
    """
    dev = prog.device
    dtype = getattr(torch, prog.in_meta.dtype)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    listener, prog.compile_listener = prog.compile_listener, None
    try:
        with torch.cuda.stream(side):
            static_in = torch.zeros((bucket, *prog.in_meta.shape), dtype=dtype, device=dev)
            t0 = time.perf_counter()
            if prog.dispatch_count == 0:
                prog(static_in)  # dispatch #1, synchronized
            else:
                with torch.inference_mode():
                    prog.fn(static_in)
                synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            t1 = time.perf_counter()
            with torch.inference_mode(), _build.thread_launches() as counted:
                graph.capture_begin(pool=pool.handle, capture_error_mode="thread_local")
                try:
                    static_out = prog.fn(static_in)
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:  # noqa: BLE001 — the fn's error is the one to raise
                        pass
                    raise
                graph.capture_end()
            side.synchronize()
            t2 = time.perf_counter()
    finally:
        prog.compile_listener = listener
    launches = {name: counted.get(fn, 0) for name, fn in _kernel_counters().items()}
    captured = CapturedGraph(graph, static_in, static_out, pool, t2 - t1,
                             {k: v for k, v in launches.items() if v})
    capture_program.captures += 1
    if listener is not None:
        listener(prog, t2 - t0)
    return captured


capture_program.captures = 0  # graphs captured in this process


def batch_buckets(batch_size: int) -> tuple[int, ...]:
    """Bucketed dispatch sizes for one configured max batch, ascending:
    every power of two strictly below ``batch_size`` plus the exact size."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    buckets = {int(batch_size)}
    b = 1
    while b < batch_size:
        buckets.add(b)
        b <<= 1
    return tuple(sorted(buckets))


@dataclasses.dataclass
class ProgramSet:
    """Bucket program set for one (plan geometry, device) pair.

    One :class:`DevicePreprocProgram` per bucketed batch size: batch
    formation closes a ragged batch to :meth:`bucket_for`'s smallest
    covering bucket, dispatches the staged buffer's ``[:bucket]`` prefix,
    and reads back only the real rows — padded lanes never reach a retired
    result.  ``warm()`` (``RuntimeConfig.warmup="full"``) moves every
    bucket's cold start into startup: on the CPU it runs each program once
    on zeros; on CUDA it captures each program as one CUDA graph
    (:func:`capture_program`), the counterpart of the reference's one
    AOT-compiled executable per bucket, and every later dispatch of that
    bucket replays the graph.

    ``require_ready=True`` makes :meth:`program_for` serve only *warm*
    buckets until :meth:`warm` has covered the whole set — the background-
    warmer contract: a dispatcher never pays a request-path cold start
    while warmup is still running; a ragged batch falls forward to the
    smallest ready covering bucket (the warmer runs largest-first, so the
    full-size program is ready before serving starts and always covers).
    A bucket whose capture failed stays unready; its error is kept in
    ``failures``.  Graphs share one memory pool per logical device: a
    sharded set's members capture into their own devices' pools, so their
    replays can overlap.
    """

    programs: dict[int, DevicePreprocProgram]  # bucket -> program, ascending
    geometry: tuple = ()  # the plan's staging-geometry bin (shape, dtype)
    device: Any = None
    # serve only warmed buckets until warm() completes (background warmer)
    require_ready: bool = False

    def __post_init__(self):
        if not self.programs:
            raise ValueError("ProgramSet needs at least one program")
        self.programs = dict(sorted(self.programs.items()))
        self._warm_done = not self.require_ready
        self._pools: dict[Any, _GraphPool] = {}  # by target label, made at its first capture
        self.failures: list[tuple[int, BaseException]] = []

    @property
    def buckets(self) -> tuple[int, ...]:
        return tuple(self.programs)

    @property
    def max_batch(self) -> int:
        return next(reversed(self.programs))

    def bucket_for(self, n: int) -> int | None:
        """Smallest bucket covering ``n`` rows (None when n exceeds the set)."""
        for b in self.programs:
            if b >= n:
                return b
        return None

    @staticmethod
    def _is_warm(prog: DevicePreprocProgram) -> bool:
        """Dispatched at least once and, on CUDA, captured as a graph (a
        sharded program: every member)."""
        members = getattr(prog, "members", ())
        if members:
            return all(ProgramSet._is_warm(m) for m in members)
        if not prog.dispatch_count:
            return False
        dev = getattr(prog, "device", None)
        return dev is None or dev.type != "cuda" or prog.graph is not None

    @classmethod
    def _is_ready(cls, prog: DevicePreprocProgram) -> bool:
        """Warm and not mid-warm — no cold-start risk."""
        return cls._is_warm(prog) and not prog._warming

    @property
    def fully_warm(self) -> bool:
        """True once every bucket is safe to dispatch without a cold start."""
        return self._warm_done or all(self._is_ready(p) for p in self.programs.values())

    def program_for(self, n: int) -> tuple[DevicePreprocProgram, int] | None:
        """(program, bucket) dispatching ``n`` staged rows, or None.

        Under ``require_ready`` (background warmup still running) only
        warm buckets are served: the smallest *ready* bucket covering
        ``n``.  None means no ready bucket covers — the caller falls back
        to its full-size program.
        """
        if self._warm_done:
            b = self.bucket_for(n)
            if b is None:
                return None
            return self.programs[b], b
        for b, prog in self.programs.items():
            if b >= n and self._is_ready(prog):
                return prog, b
        return None

    def keys(self) -> tuple:
        """Program-cache keys of every entry (for pin/unpin bookkeeping)."""
        return tuple(p.key for p in self.programs.values())

    def graphs(self) -> dict[int, CapturedGraph]:
        """bucket -> captured graph, for the buckets captured so far (of a
        sharded bucket, its first member's)."""
        firsts = {b: (getattr(p, "members", ()) or (p,))[0] for b, p in self.programs.items()}
        return {b: p.graph for b, p in firsts.items() if p.graph is not None}

    def warm(self, buckets: tuple[int, ...] | None = None) -> int:
        """Warm each not-yet-warm entry, largest bucket first.

        On the CPU each program runs once on zeros; on CUDA each is
        captured as one CUDA graph into the set's shared memory pool.
        ``buckets`` restricts the pass (the facade warms the full-size
        bucket inline at startup and hands the rest to the background
        warmer).  A bucket that fails is recorded in ``failures`` and the
        pass goes on with the next; the first failure is raised at the
        end.  Returns the number of programs warmed.
        """
        warmed = 0
        chosen = self.programs if buckets is None else [b for b in buckets if b in self.programs]
        errors: list[BaseException] = []
        for bucket in sorted(chosen, reverse=True):
            prog = self.programs[bucket]
            if self._is_warm(prog):
                continue
            dispatched = prog.dispatch_count
            prog._warming = True
            try:
                if prog.device.type == "cuda":
                    self._capture(prog, bucket)
                else:
                    zeros = np.zeros((bucket, *prog.in_meta.shape), np.dtype(prog.in_meta.dtype))
                    prog(zeros)
            except Exception as e:  # noqa: BLE001 — recorded, raised below
                prog.dispatch_count = dispatched  # a failed warm leaves it cold
                self.failures.append((bucket, e))
                errors.append(e)
                continue
            finally:
                prog._warming = False
            warmed += 1
        if all(self._is_warm(p) for p in self.programs.values()):
            self._warm_done = True
        if errors:
            raise errors[0]
        return warmed

    def _capture(self, prog: DevicePreprocProgram, bucket: int) -> None:
        """``prog`` at ``bucket`` rows as a CUDA graph in its target's pool;
        a sharded program's members, each at its share of the rows."""
        if not prog.members:
            prog.graph = capture_program(prog, bucket, self._pool_for(prog))
            return
        t0 = time.perf_counter()
        rows = bucket // len(prog.members)
        for member in prog.members:
            if member.graph is None:
                member.graph = capture_program(member, rows, self._pool_for(member))
        # the members' warm-up runs are the group's: its next dispatch is
        # not a cold start
        prog.dispatch_count += 1
        if prog.compile_listener is not None:
            prog.compile_listener(prog, time.perf_counter() - t0)

    def _pool_for(self, prog: DevicePreprocProgram) -> _GraphPool:
        key = getattr(prog.target, "label", None)
        if key not in self._pools:
            self._pools[key] = _GraphPool()
        return self._pools[key]

    def release(self, keep: Callable[[DevicePreprocProgram], bool] = lambda p: False) -> None:
        """Drop the captured graphs of every program ``keep`` rejects, so
        their memory pool can be freed (a rebuilt plan captures anew)."""
        for prog in self.programs.values():
            if not keep(prog):
                for p in getattr(prog, "members", ()) or (prog,):
                    p.graph = None


def program_cache_key(
    device_ops: Sequence[PreprocOp],
    in_meta: TensorMeta,
    batch_size: int,
    backend: str,
    impl: str,
    model_key: str = "",
    device: torch.device | None = None,
) -> tuple:
    """Compile-cache identity: op specs + input meta + batch + backend +
    the stage implementation + the device."""
    return (
        tuple(op.spec() for op in device_ops),
        in_meta.shape,
        in_meta.dtype,
        in_meta.layout,
        batch_size,
        backend,
        impl,
        model_key,
        None if device is None else device_cache_key(device),
    )


def compile_device_program(
    device_ops: Sequence[PreprocOp],
    in_meta: TensorMeta,
    model_fn: Callable,
    batch_size: int,
    backend: str = "fused",
    impl: str = "auto",
    model_key: str = "",
    cache: MutableMapping[tuple, "DevicePreprocProgram"] | None = None,
    device: str | torch.device | None = "cuda",
) -> DevicePreprocProgram:
    """Lower ``device_ops`` + ``model_fn`` into one device program.

    ``backend='fused'`` engages the lowering (kernel or plain per ``impl``);
    ``'reference'`` keeps the per-op apply_device chain.  Either way the
    result is one dispatch per batch.  ``cache`` (keyed by
    :func:`program_cache_key`) makes recompiles after placement moves free.
    ``model_fn`` takes and returns tensors on ``device``.  ``device`` may
    also be a mesh target: a :class:`LogicalDevice` or a
    :class:`BatchSharding` (a sharded replica group).
    """
    if backend not in ("fused", "reference"):
        raise ValueError(f"device_backend must be 'fused' or 'reference', got {backend!r}")
    dev, target = _resolve_target(device)
    impl = resolve_impl(impl, dev) if backend == "fused" else "chain"
    key = program_cache_key(device_ops, in_meta, batch_size, backend, impl, model_key,
                            target or dev)
    if cache is not None and key in cache:
        return cache[key]
    if isinstance(target, BatchSharding):
        program = _sharded_program(target, key, batch_size, lambda d, rows: compile_device_program(
            device_ops, in_meta, model_fn, rows, backend, impl, model_key, device=d))
        if cache is not None:
            cache[key] = program
        return program

    t_build = time.perf_counter()
    low = lower_device_ops(device_ops, in_meta) if backend == "fused" else None
    if low is not None:
        stage = build_fused_stage(low, impl, dev)
        fused, stages, out_meta = True, low.stages, low.out_meta
    elif device_ops:
        stage = _build_chain_stage(device_ops)
        impl, fused = "chain", False
        stages = tuple(op.name for op in device_ops)
        out_meta = P.chain_out_meta(list(device_ops), in_meta)
    else:
        stage, impl, fused, stages, out_meta = None, "model-only", False, (), in_meta

    def raw(batch):
        return model_fn(stage(batch) if stage is not None else batch)

    program = DevicePreprocProgram(
        fn=raw,
        backend=backend,
        impl=impl,
        fused=fused,
        stages=stages,
        key=key,
        in_meta=in_meta,
        out_meta=out_meta,
        device=dev,
        batch_size=batch_size,
        build_seconds=time.perf_counter() - t_build,
        target=target,
    )
    if cache is not None:
        cache[key] = program
    return program


def _sharded_program(sharding: BatchSharding, key: tuple, batch_size: int,
                     build: Callable[[LogicalDevice, int], DevicePreprocProgram]
                     ) -> DevicePreprocProgram:
    """A sharded replica group's program: ``build(device, rows)`` for each
    device of the group at ``batch_size / g`` rows (outside the cache: the
    group's program holds its members).  Calling the program is its one
    path (each member on its own stream); its ``fn`` raises."""
    g = len(sharding.devices)
    if batch_size % g:
        raise ValueError(f"a batch of {batch_size} does not split over the {g} devices "
                         "of a sharded group")
    t_build = time.perf_counter()
    members = tuple(build(d, batch_size // g) for d in sharding.devices)

    def fn(batch):
        raise RuntimeError("a sharded group's program runs through its members: call the "
                           "program, not its fn")

    return dataclasses.replace(members[0], fn=fn, key=key, batch_size=batch_size, target=sharding,
                               members=members, build_seconds=time.perf_counter() - t_build)


# ------------------------------------------------- split-decode (DCT) program
_YCBCR_TO_RGB = np.array(
    # rows: R, G, B; cols: Y, Cb-128, Cr-128 (JFIF, matches dct.ycbcr_to_rgb)
    [[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]],
    dtype=np.float32,
)


def compile_coeff_program(
    header: Any,  # jpeg.JpegHeader from a calibration sample
    device_ops: Sequence[PreprocOp],
    model_fn: Callable,
    batch_size: int,
    factor: int = 1,  # scaled-IDCT resolution divisor: 1 full, 2 half, 4 quarter
    layout: str = "padded",  # coefficient staging layout ("padded" | "packed")
    impl: str = "auto",
    model_key: str = "",
    cache: MutableMapping[tuple, "DevicePreprocProgram"] | None = None,
    device: str | torch.device | None = "cuda",
) -> DevicePreprocProgram:
    """Split-decode program: quantized DCT coefficients in, predictions out.

    The host stops after the entropy stage (``jpeg.decode_to_coefficients``)
    and stages one int16 zigzag-coefficient tensor per item
    (``jpeg.stage_coefficients``, padded or packed); this program runs the
    dense remainder on the device in ONE dispatch: unzigzag + fused
    dequantize + (scaled) IDCT (K1, ``kernels/idct`` at ``point = 8 //
    factor``, one launch per quant table over a view of the staged batch)
    -> unblockify + 2x2 nearest chroma upsample (4:2:0) + JFIF color
    conversion (K5, ``kernels/blocks_to_rgb``, one launch) -> the fused
    resize/normalize stage (K2) -> DNN.  ``impl`` picks only the fused
    stage; K1 and K5 run their plain versions on CPU tensors.  ``factor > 1``
    decodes straight to reduced resolution.
    """
    from repro_torch.preprocessing import jpeg as jpeg_mod

    if header.channels != 3:
        raise ValueError("split-decode program supports 3-channel streams")
    if factor not in (1, 2, 4):
        raise ValueError(f"scaled-IDCT factor must be 1, 2 or 4, got {factor}")
    if layout not in ("padded", "packed"):
        raise ValueError(f"layout must be 'padded' or 'packed', got {layout!r}")
    dev, target = _resolve_target(device)
    impl = resolve_impl(impl, dev)
    n_br, n_bc = header.n_br, header.n_bc
    cbr, cbc = jpeg_mod.chroma_grid(header)
    subsample = bool(header.subsample)
    point = 8 // factor
    hs = jpeg_mod.scaled_size(header.height, factor)
    ws = jpeg_mod.scaled_size(header.width, factor)
    qtables = jpeg_mod._qtables(header.quality, header.channels)
    pixel_meta = TensorMeta((hs, ws, 3), "uint8", "HWC")
    in_shape = jpeg_mod.staged_coeff_shape(header, layout)
    key = (
        ("CoeffDecode", header.quality, n_br, n_bc, header.height, header.width,
         subsample, factor, layout),
        program_cache_key(device_ops, pixel_meta, batch_size, "fused", impl, model_key,
                          target or dev),
    )
    if cache is not None and key in cache:
        return cache[key]
    if isinstance(target, BatchSharding):
        program = _sharded_program(target, key, batch_size, lambda d, rows: compile_coeff_program(
            header, device_ops, model_fn, rows, factor, layout, impl, model_key, device=d))
        if cache is not None:
            cache[key] = program
        return program

    t_build = time.perf_counter()
    # constant operands, on the device once per program
    m_luma, m_chroma = (
        torch.from_numpy(idct_ops.zigzag_matrix(q, point)).to(dev) for q in qtables[:2]
    )
    rgb_mat = torch.from_numpy(_YCBCR_TO_RGB).to(dev)
    grid = b2r_ops.BlockGrid(n_br, n_bc, cbr, cbc, point, hs, ws, subsample)
    low = lower_device_ops(device_ops, pixel_meta)
    if low is not None:
        preproc = build_fused_stage(low, impl, dev, input_planar=True)
        fused, out_meta = True, low.out_meta
        pre_stages = low.stages
    else:
        chain = _build_chain_stage(device_ops)
        # the chain fallback must see the same uint8 pixel grid the pixel
        # path stages (ops.Resize only re-quantizes uint8 inputs): cast the
        # already clip/rounded RGB down before applying the per-op chain
        preproc = lambda x: chain(x.permute(0, 2, 3, 1).to(torch.uint8))  # noqa: E731
        fused = False
        out_meta = P.chain_out_meta(list(device_ops), pixel_meta)
        pre_stages = tuple(op.name for op in device_ops)

    n_luma = n_br * n_bc

    def raw(zz):  # one staged int16 zigzag-coefficient tensor per item
        if layout == "packed":  # (N, n_luma + 2 * cbr * cbc, 64)
            luma_zz, chroma_zz = zz[:, :n_luma], zz[:, n_luma:]
        else:  # (N, 3, n_br, n_bc, 64); 4:2:0 chroma occupies the top-left
            luma_zz, chroma_zz = zz[:, 0], zz[:, 1:, :cbr, :cbc]
        # K1 once per quant table, reading the staged rows in place
        luma = idct_ops.idct_zigzag_rows(luma_zz, m_luma)
        chroma = idct_ops.idct_zigzag_rows(chroma_zz, m_chroma)
        # K5: the decoded uint8 pixel grid, planar f32
        rgb = b2r_ops.blocks_to_rgb(luma, chroma, rgb_mat, grid)
        return model_fn(preproc(rgb))

    idct_stage = "dequant_idct" if point == 8 else f"dequant_idct/{point}pt"
    decode_stages = ("unzigzag", idct_stage, "unblockify")
    if subsample:
        decode_stages += ("chroma_upsample[2x2]",)
    program = DevicePreprocProgram(
        fn=raw,
        backend="fused",
        impl=impl,
        fused=fused,
        stages=decode_stages + ("ycbcr->rgb",) + pre_stages,
        key=key,
        in_meta=TensorMeta(in_shape, "int16", "CHW"),
        out_meta=out_meta,
        device=dev,
        coeff_factor=factor,
        coeff_layout=layout,
        batch_size=batch_size,
        build_seconds=time.perf_counter() - t_build,
        target=target,
    )
    if cache is not None:
        cache[key] = program
    return program
