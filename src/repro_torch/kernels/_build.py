"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use — never at import — and is cached on disk under
``build/repro_torch_kernels/`` keyed by a hash of the sources and flags, so
a second process reuses the library.  Each ``.cu`` file compiles in its
own ``nvcc`` process, all started together.

There is no fallback: a missing ``nvcc`` or a failed build raises.

A trace (:func:`trace`, opened by ``launch/hlo_analysis.py``) runs the
wrappers' card branch on meta tensors and launches nothing: while one is
open on the calling thread, :func:`load_library` hands out a
:class:`RecordingLibrary`, :func:`on_card` takes the meta device for the
card, :func:`current_stream` answers 0 and :func:`sm_count` the H100's
132, and each wrapper hands its launch's work (``kernels/cost.py``) to the
trace with :func:`trace_launch` in place of counting a launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# what a source needs beyond NVCC_FLAGS: K6's backward is assembled at
# ptxas -O1, where the default level's scheduling of its unrolled walks
# spills registers (PERF.md, PR 27)
UNIT_FLAGS = {"selective_scan_bwd.cu": ("-Xptxas", "-O1")}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build did: seconds, library path, ptxas report (registers,
# shared memory, spills per kernel) — chip_smoke.py prints it
build_info: dict = {}


def build_dir() -> Path:
    """``REPRO_TORCH_BUILD_DIR`` or ``<checkout>/build/repro_torch_kernels``."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of repro_torch "
        "are built from source at first use on the card"
    )


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(UNIT_FLAGS.items())).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Start every command at once, wait for all; raise on the first failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{log}")
    return logs


def _build(out: Path) -> None:
    nvcc = find_nvcc()
    units = [p for p in _sources() if p.suffix == ".cu"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (p.stem + ".o") for p in units]
        logs = _run_all(
            [[nvcc, *NVCC_FLAGS, *UNIT_FLAGS.get(src.name, ()), "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
             for src, obj in zip(units, objs)]
        )
        lib_tmp = Path(tmp) / out.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(lib_tmp)]])
        os.replace(lib_tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_info.update(
        seconds=time.perf_counter() - t0, built=True, ptxas="\n".join(logs).strip()
    )


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use (thread-safe); under
    a trace, the trace's :class:`RecordingLibrary`."""
    global _lib
    if tracing():
        return _trace.stack[-1][1]
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = out_dir / f"librepro_torch_kernels_{source_hash()}.so"
        build_info.update(path=str(lib_path), built=False, seconds=0.0)
        if not lib_path.exists():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        _declare(lib)
        _lib = lib
        return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _declare(lib: ctypes.CDLL) -> None:
    """C signatures: every pointer and the stream as ``c_void_p`` (a bare
    Python int would be passed as a 32-bit int and cut the pointer)."""
    lib.repro_idct_rows.argtypes = [
        _P, _I,  # x, x is int16 (zigzag) rather than f32 (natural)
        _I, _I, _I, _I, _I, _I, _I, _I,  # the view's four row sizes, strides
        _I, _P, _P, _I, _P,  # leading coefficients read, m, out, point^2, stream
    ]
    lib.repro_idct_rows.restype = _I
    lib.repro_blocks_to_rgb.argtypes = [
        _P, _P, _P, _P,  # luma, chroma, colour matrix, out
        _I, _I, _I, _I, _I,  # images, luma block grid, chroma block grid
        _I, _I, _I, _I, _P,  # point, hs, ws, 4:2:0, stream
    ]
    lib.repro_blocks_to_rgb.restype = _I
    lib.repro_resize_affine_planar_f32.argtypes = [
        _P, _I, _I, _I,  # x, planes, h, w
        _P, _P, _P, _I,  # y0, y1, wy, oh
        _P, _P, _P, _I,  # x0, x1, wx, ow
        _P, _P, _I,  # scale, bias, round_uint8
        _P, _I, _I, _I, _P,  # out, band rows, tile columns, stage floats, stream
    ]
    lib.repro_resize_affine_planar_f32.restype = _I
    lib.repro_flash_attention.argtypes = [
        _I, _P, _P, _P, _P, _P,  # dtype, q, k, v, out, lse (null: none)
        _I, _I, _I, _I, _I, _I, _I,  # B, Sq, Sk, H, KVH, D (q/k width), DV (v width)
        _L, _L, _L, _L, _L, _L,  # q / k strides (batch, seq, head)
        _L, _L, _L, _L, _L, _L,  # v / out strides
        _F, _I, _I, _I,  # scale, causal, window (-1 = none), heads per tile group
        _P, _P,  # work-tile counters, stream
    ]
    lib.repro_flash_attention.restype = _I
    lib.repro_flash_attention_bwd.argtypes = [
        _I, _P, _P, _P, _P, _P, _P,  # dtype, q, k, v, out, dout, lse
        _P, _P, _P,  # scratch: Delta / lse rows, per-head dk and dv sums (bf16 GQA; else null)
        _P, _P, _P,  # dq, dk, dv
        _I, _I, _I, _I, _I, _I, _I,  # B, Sq, Sk, H, KVH, D (q/k width), DV (v width)
        *[_L] * 24,  # (batch, seq, head) strides of q, k, v, out, dout, dq, dk, dv
        _F, _I, _I, _P,  # scale, causal, window (-1 = none), stream
    ]
    lib.repro_flash_attention_bwd.restype = _I
    lib.repro_decode_attention.argtypes = [
        _I, _I,  # q dtype, cache dtype
        _P, _L, _L,  # q, its (batch, head) strides
        _P, _L, _L, _L,  # k cache, its (batch, seq, head) strides
        _P, _L, _L, _L,  # v cache, its strides
        _P, _P, _P, _P, _P,  # lengths, out, lse (null: none), partials, arrival counters
        _I, _I, _I, _I, _I, _I, _I,  # B, S, KVH, group, D, chunk, splits
        _F, _I, _P,  # scale, window (-1 = none), stream
    ]
    lib.repro_decode_attention.restype = _I
    lib.repro_selective_scan.argtypes = [
        _I, _P, _P, _P, _L, _L,  # bf16 (else f32), xc, proj, z (null: no gate), z's (batch, seq) strides
        _P, _P, _P, _P, _P, _P,  # a_log, dt_bias, d_skip, h0 (null: zeros), out, h_last
        _P,  # h_chunks, the state entering each chunk (null: not kept)
        _I, _I, _I, _I, _P,  # B, S, D, N, stream
    ]
    lib.repro_selective_scan.restype = _I
    lib.repro_selective_scan_chunk.argtypes = []  # -> steps per h_chunks state
    lib.repro_selective_scan_chunk.restype = _I
    lib.repro_selective_scan_bwd_scratch.argtypes = [_I, _I, _I, _I]  # B, S, D, N
    lib.repro_selective_scan_bwd_scratch.restype = _L
    # bf16, N, D, out (6 ints: blocks an SM, warps and shared-memory bytes a
    # block, blocks a cluster, clusters resident at once, channels a block)
    lib.repro_selective_scan_bwd_info.argtypes = [_I, _I, _I, _P]
    lib.repro_selective_scan_bwd_info.restype = _I
    lib.repro_selective_scan_bwd.argtypes = [
        _I, _P, _P, _P, _L, _L,  # bf16 (else f32), xc, proj, z (null: no gate), z's (batch, seq) strides
        _P, _P, _P, _P, _P, _P,  # dout, a_log, dt_bias, d_skip, h_chunks, dh_last (null: zeros)
        _P, _P, _P, _P,  # scratch, dxc, dproj, dz (null without z)
        _P, _P, _P, _P,  # da_log, ddt_bias, dd_skip, dh0 (null: not wanted)
        _I, _I, _I, _I, _P,  # B, S, D, N, stream
    ]
    lib.repro_selective_scan_bwd.restype = _I
    lib.repro_empty_kernel.argtypes = [_I, _I, _P]  # blocks, threads, stream
    lib.repro_empty_kernel.restype = _I
    lib.repro_cuda_error_string.argtypes = [_I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


_counters: dict = {}


def stream_counters(kernel: str, device, stream: int, n: int):
    """At least ``n`` zeroed int32 counters of one kernel in device memory,
    kept per (device, stream): the kernel sets them back to 0 before it
    ends, and launches on one stream run in order, so they are zero at
    every launch.  Two streams get two sets, so their launches may
    overlap."""
    import torch

    if tracing():
        return torch.empty(n, dtype=torch.int32, device=device)
    key = (kernel, device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return buf


def check(lib: ctypes.CDLL, status: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        text = lib.repro_cuda_error_string(status).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status} ({text})")


_tally = threading.local()


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: adds one to its ``launches`` and
    to every tally the calling thread has open (:func:`thread_launches`)."""
    wrapper.launches += 1
    for counts in getattr(_tally, "open", ()):
        counts[wrapper] = counts.get(wrapper, 0) + 1


@contextlib.contextmanager
def thread_launches():
    """A dict, wrapper -> launches, counting only the launches the calling
    thread makes inside the block: a graph capture's count, with other
    threads dispatching eagerly meanwhile."""
    counts: dict = {}
    stack = _tally.__dict__.setdefault("open", [])
    stack.append(counts)
    try:
        yield counts
    finally:
        stack.remove(counts)


# ------------------------------------------------------------------ traces
_trace = threading.local()
TRACE_SM_COUNT = 132  # the H100 SXM's SMs, which a trace takes the card to have


def tracing() -> bool:
    """A trace is open on the calling thread."""
    return bool(getattr(_trace, "stack", None))


@contextlib.contextmanager
def trace(sink):
    """For the block, on the calling thread, the wrappers take meta tensors
    for the card's and launch nothing: each launch's work goes to
    ``sink.kernel_launch(name, cost)``, and the library is a
    :class:`RecordingLibrary` (yielded)."""
    lib = RecordingLibrary()
    stack = _trace.__dict__.setdefault("stack", [])
    stack.append((sink, lib))
    try:
        yield lib
    finally:
        stack.pop()


def on_card(device) -> bool:
    """``device`` takes the wrappers' card branch: a CUDA device, or inside
    a trace the meta device (there a CUDA tensor raises: a trace launches
    nothing, so it must not see real data)."""
    if not tracing():
        return device.type == "cuda"
    if device.type == "cuda":
        raise RuntimeError("a CUDA tensor reached a kernel's wrapper inside a trace, which launches nothing")
    return device.type == "meta"


def current_stream(device) -> int:
    """The calling thread's current CUDA stream on ``device`` (0 in a
    trace)."""
    if tracing():
        return 0
    import torch

    return torch.cuda.current_stream(device).cuda_stream


_sms: dict = {}


def sm_count(device) -> int:
    """``device``'s SMs (:data:`TRACE_SM_COUNT` in a trace)."""
    if tracing():
        return TRACE_SM_COUNT
    if device.index not in _sms:
        import torch

        _sms[device.index] = torch.cuda.get_device_properties(device.index).multi_processor_count
    return _sms[device.index]


def trace_launch(name: str, cost) -> None:
    """One launch of ``name``'s kernel in the open trace, with ``cost``
    (a ``kernels.cost.KernelCost``)."""
    _trace.stack[-1][0].kernel_launch(name, cost)


def repeat(n: int):
    """``range(n)`` for a loop whose iterations do the same work on equal
    shapes (microbatches).  In a trace only the first two run, and the
    second counts for the other n - 1 (``sink.repeated``), as the
    reference's analysis multiplies a while body by its trip count."""
    if not tracing() or n <= 2:
        yield from range(n)
        return
    yield 0
    with _trace.stack[-1][0].repeated(n - 2):
        yield 1


def counted(factor: float):
    """A context: in an open trace the block's counts (not its memory)
    count ``factor`` (an integer) times — work a
    :class:`~repro_torch.launch.mesh.RoleMesh` device does for each of the
    whole mesh's devices it stands for; with no trace open, or a factor of
    1, nothing."""
    if not tracing() or factor == 1:
        return contextlib.nullcontext()
    return _trace.stack[-1][0].repeated(factor - 1)


def trace_collective(kind: str, nbytes: int, devices):
    """A context: the block is one collective of ``kind`` with ``nbytes``
    of result at each of ``devices`` (logical devices), for the open
    trace (``sink.collective``)."""
    return _trace.stack[-1][0].collective(kind, nbytes, devices)


def _state_stride() -> int:
    """``kStateStride`` of ``csrc/selective_scan.cuh``, which the library
    reports as ``repro_selective_scan_chunk``."""
    m = re.search(r"constexpr int kStateStride = (\d+);", (CSRC / "selective_scan.cuh").read_text())
    return int(m.group(1))


# a meta tensor's pointer is its byte offset into a storage that starts at
# 0, below this (16 TiB, more than any cache or model the port holds); a
# real allocation's address on x86-64 Linux lies above it
META_POINTER_LIMIT = 1 << 44


class _Entry:
    def __init__(self, lib: RecordingLibrary, name: str):
        self.lib, self.name = lib, name
        self.argtypes, self.restype = [], None

    def __call__(self, *args):
        for arg, kind in zip(args, self.argtypes):
            if kind is _P and arg is not None and not 0 <= arg < META_POINTER_LIMIT:
                raise ValueError(f"the recording library takes no real pointer: {self.name} got {arg:#x}")
        self.lib.calls.append((self.name, args))
        if self.name == "repro_selective_scan_chunk":
            return _state_stride()
        return 0


class RecordingLibrary:
    """The kernels' library as a trace sees it: each entry point checks its
    arguments against the C signature, records the call and launches
    nothing.  It returns 0: ``cudaSuccess`` from a launch, and a scratch
    of no floats from ``repro_selective_scan_bwd_scratch`` (a trace leaves
    K6 backward's scratch out); ``repro_selective_scan_chunk`` returns
    ``kStateStride`` as the source states it.  A pointer that is not a
    meta tensor's offset (:data:`META_POINTER_LIMIT`) raises, so this
    library never stands in for the card on real data."""

    def __init__(self):
        self.calls: list = []
        self._entries: dict = {}
        _declare(self)

    def __getattr__(self, name: str):
        if not name.startswith("repro_"):
            raise AttributeError(name)
        entries = self.__dict__["_entries"]
        if name not in entries:
            entries[name] = _Entry(self, name)
        return entries[name]
