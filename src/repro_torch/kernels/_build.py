"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use — never at import — and is cached on disk under
``build/repro_torch_kernels/`` keyed by a hash of the sources and flags, so
a second process reuses the library.  Each ``.cu`` file compiles in its
own ``nvcc`` process, all started together.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
            [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
             for src, obj in zip(units, objs)]
        )
        lib_tmp = Path(tmp) / out.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(lib_tmp)]])
        os.replace(lib_tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_info.update(
        seconds=time.perf_counter() - t0, built=True, ptxas="\n".join(logs).strip()
    )


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use (thread-safe)."""
    global _lib
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
        _P, _P, _P, _P,  # lengths, out, partials, arrival counters
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
