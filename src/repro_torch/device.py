"""Explicit device selection for the port, and the serving mesh's logical
devices."""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable

import torch

# splits each physical device into this many logical ones (the counterpart
# of XLA's --xla_force_host_platform_device_count); read at each call
FORCE_DEVICE_COUNT_ENV = "REPRO_TORCH_FORCE_DEVICE_COUNT"


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``None`` and ``"cuda"`` mean the card; the CPU is used only when asked
    for by name.  Asking for CUDA on a machine without it raises — there is
    no quiet fallback to the CPU.  The meta device holds shapes alone (a
    trace's: ``launch/hlo_analysis.py``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev


class LogicalDevice:
    """One dispatch target of the serving mesh: a physical device, or one
    of the ``n`` parts :func:`mesh_devices` splits it into.

    ``id`` is global (physical index x n + part).  On a card each logical
    device owns one CUDA stream, and ``label`` names the card and the part
    (``cuda:0/1``); on the CPU there is no stream and the label is
    ``cpu:<id>``, as the reference labels its forced CPU devices."""

    __slots__ = ("device", "id", "stream", "label")

    def __init__(self, device: torch.device, id: int, stream: Any, label: str):
        self.device = device  # the physical device, with its index
        self.id = id
        self.stream = stream  # torch.cuda.Stream on a card, None on the CPU
        self.label = label

    def __repr__(self) -> str:
        return f"LogicalDevice({self.label})"

    @contextlib.contextmanager
    def scope(self):
        """Run the body on this device: on a card its stream is the
        thread's current stream; on the CPU nothing changes.  For the
        block, :func:`current_logical` is this device (a trace counts its
        ops per device by it)."""
        stack = _scopes.__dict__.setdefault("stack", [])
        stack.append(self)
        try:
            with torch.cuda.stream(self.stream):  # a no-op for None
                yield
        finally:
            stack.pop()

    def run(self, fn: Callable[[Any], Any], batch: Any) -> Any:
        """``fn(batch)`` on this device's stream.

        A caller already on the stream (a replica's dispatcher) gets the
        result as is.  Any other caller's current stream is made to wait
        for an event recorded after ``fn``'s work, so whatever it enqueues
        next (the readback) orders after it; a device ``batch`` is waited
        for the other way.  The caching allocator is told of both uses."""
        if self.stream is None:
            with self.scope():
                return fn(batch)
        caller = torch.cuda.current_stream(self.device)
        if caller == self.stream:
            with self.scope():
                return fn(batch)
        on_card = torch.is_tensor(batch) and batch.is_cuda
        if on_card:
            self.stream.wait_stream(caller)
            batch.record_stream(self.stream)
        with self.scope():
            out = fn(batch)
        caller.wait_stream(self.stream)
        if torch.is_tensor(out) and out.is_cuda:
            out.record_stream(caller)
        return out


_scopes = threading.local()


def current_logical() -> LogicalDevice | None:
    """The logical device whose :meth:`LogicalDevice.scope` the calling
    thread is in (the innermost), or None."""
    stack = getattr(_scopes, "stack", None)
    return stack[-1] if stack else None


_logical: dict[tuple[str, int, int, int], LogicalDevice] = {}
_logical_lock = threading.Lock()


def forced_device_count() -> int:
    """``REPRO_TORCH_FORCE_DEVICE_COUNT`` (1 when unset)."""
    raw = os.environ.get(FORCE_DEVICE_COUNT_ENV, "").strip()
    if not raw:
        return 1
    try:
        n = int(raw)
    except ValueError:
        n = 0
    if n < 1:
        raise ValueError(f"{FORCE_DEVICE_COUNT_ENV} must be an integer >= 1, got {raw!r}")
    return n


def mesh_devices(device: str | torch.device | None = "cuda") -> list[LogicalDevice]:
    """The serving mesh's devices, the counterpart of ``jax.devices()``.

    One logical device per physical device of ``device``'s type (each
    visible card, or the one CPU), each split into
    ``REPRO_TORCH_FORCE_DEVICE_COUNT`` parts.  A part keeps its stream for
    the life of the process.  Asking for CUDA without a card raises, as
    :func:`resolve_device` does."""
    dev = resolve_device(device)
    n = forced_device_count()
    cards = range(torch.cuda.device_count()) if dev.type == "cuda" else (0,)
    out = []
    with _logical_lock:
        for i in cards:
            for j in range(n):
                key = (dev.type, i, n, j)
                ld = _logical.get(key)
                if ld is None:
                    ld = _logical[key] = _new_logical(dev.type, i, n, j)
                out.append(ld)
    return out


_streams: dict[tuple[int, int], Any] = {}


def _new_logical(kind: str, index: int, n: int, part: int) -> LogicalDevice:
    if kind == "cpu":
        return LogicalDevice(torch.device("cpu"), part, None, f"cpu:{part}")
    phys = torch.device("cuda", index)
    stream = _streams.get((index, part))
    if stream is None:
        stream = _streams[(index, part)] = torch.cuda.Stream(phys)
    return LogicalDevice(phys, index * n + part, stream, f"cuda:{index}/{part}")


def dispatch_scope(fn: Any):
    """The scope a dispatcher runs ``fn`` and reads its output back in: the
    scope of the program's target (a sharded group's first member), so
    the readback is enqueued behind the program's work on its stream.  A
    plain callable gets no scope."""
    target = getattr(fn, "target", None)
    scope = getattr(target, "scope", None)
    return scope() if scope is not None else contextlib.nullcontext()
