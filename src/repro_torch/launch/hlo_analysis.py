"""Static analysis of a traced program for the roofline: the port's
``repro.launch.hlo_analysis``.

The reference parses XLA's compiled HLO text; PyTorch produces none.  The
port traces instead: :func:`analyze` runs the program the card runs — the
wrappers' card branch (``kernels._build.trace``) — on meta tensors, so
nothing is allocated and nothing is launched, with every aten op passing
through an :class:`Analysis` (a ``TorchDispatchMode``).  It counts:

* **dot FLOPs by dtype** — the aten matmul family (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, the convolutions): 2 x the result x the contracted
  size, by the product's dtype;
* **the kernels' work** — each launch of K3, K3's backward, K4, K6 and
  K6's backward hands its cost function's FLOPs by dtype, SFU exps and
  bytes (``kernels/cost.py``), counted by kernel with its launches;
* **traffic bytes** — operand plus result bytes of each op that
  materialises a tensor, plus the kernels' bytes.  Eager PyTorch does not
  fuse, so each op's round trip is real.  Views, reshapes that are views,
  ``expand``, ``detach``, allocations and other metadata ops count
  nothing (the reference's ``_NO_TRAFFIC``); an expanded operand counts
  its distinct elements.  An in-place op counts what it writes: ``copy_``
  its source read and its rows written, ``fill_`` its rows; a row write
  into a buffer (``index_put_``, ``index_copy_``, the ``scatter`` family:
  the KV cache's ``_scatter_rows_``) counts the rows and their indices,
  not the buffer, as the reference counts dynamic-update-slice; a gather
  (``index``, ``index_select``, ``gather``, ``embedding``) reads and
  writes its result's bytes, with its indices;
* **the peak of live bytes** — each storage created in the trace counted
  from its creation until it is freed (the counterpart of
  ``memory_analysis()``), over the arguments;
* **collective bytes by type** — each collective of
  ``distributed/collectives.py`` reports a device's result bytes (the
  training mesh's gradient reductions and all-gathers, and the
  tensor-parallel layers' broadcasts, ring sums, leaf all-gathers and
  their reduce-scatters).

Counts are PER DEVICE.  An op inside a logical device's scope
(``device.LogicalDevice.scope``: the training mesh runs every op of its
step in one) counts for that device; a backward op outside any scope the
backward itself opened counts for the device that made its first input
(it runs where its forward ran; K3's backward launches in its forward's
scope); the summary takes each count's largest device and adds what
ran outside any scope.

``count_entry_modules`` is not ported: the port's one dispatch per batch
is held by its launch counts (``tests/test_torch_split_decode.py``).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.device import LogicalDevice, current_logical
from repro_torch.distributed.sharding import current_mesh, get_rules, use_rules
from repro_torch.kernels import _build
from repro_torch.kernels.cost import NVLINK_BYTES_S, PEAK_BYTES_S, PEAK_FLOPS, KernelCost, dtype_name

aten = torch.ops.aten

_DOTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution, aten._convolution,
         aten.convolution_backward}
# ops that move no bytes: allocation and metadata (views are found by their schema)
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
               aten._unsafe_view, aten.lift_fresh, aten.resize_, aten.set_, aten.detach,
               aten.sym_size, aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
               aten.is_same_size, aten._local_scalar_dense, aten.alias}
_ROW_WRITES = {aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.scatter_, aten.scatter_add_,
               aten.scatter_reduce_}
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
_WRITE_ONLY = {aten.fill_, aten.zero_}


def _bytes(t: torch.Tensor) -> int:
    """Distinct elements' bytes: a stride-0 (expanded) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    """The tensors in an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


@dataclasses.dataclass
class _Counts:
    """What one device (or the ops outside any device's scope) did."""

    dot_flops: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(float))
    traffic_bytes: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)  # name -> KernelCost
    launches: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(int))
    collective_bytes: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(float))
    live: int = 0
    peak: int = 0


class Analysis(TorchDispatchMode):
    """Counts every aten op on the trace device (meta) it sees, per logical
    device; :meth:`summary` sums them.  Use through :func:`analyze`."""

    def __init__(self):
        super().__init__()
        self.counts: dict = collections.defaultdict(_Counts)
        self._storages: dict = {}  # id -> (weakref to the storage, owner, bytes)
        self.known: set = set()  # storage ids of the arguments and other pre-trace tensors
        self._quiet = 0  # inside a collective: its steps count no traffic
        self._backward_scope = ()  # the scope the running backward began in (): none running

    # ------------------------------------------------------------ memory
    def _own(self, t: torch.Tensor, owner) -> None:
        """``t``'s storage counts as live for ``owner`` until it is freed
        (once; an argument's never)."""
        st = t.untyped_storage()
        key = id(st)
        entry = self._storages.get(key)
        if entry is not None and entry[0]() is st:
            return
        if key in self.known:
            return
        n = st.nbytes()
        c = self.counts[owner]
        c.live += n
        c.peak = max(c.peak, c.live)

        def freed(_ref, key=key, n=n, owner=owner):
            self.counts[owner].live -= n
            self._storages.pop(key, None)

        self._storages[key] = (weakref.ref(st, freed), owner, n)

    def new_storage_bytes(self, tensors) -> int:
        """Bytes of the distinct storages of ``tensors`` made in the trace,
        on the device that made the most."""
        by_owner: dict = collections.defaultdict(int)
        for key in {id(t.untyped_storage()) for t in tensors}:
            if key in self._storages:
                _, owner, n = self._storages[key]
                by_owner[owner] += n
        return max(by_owner.values(), default=0)

    # ------------------------------------------------------------ ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if not any(t.device.type == "meta" for t in ins + _tensors(out)):
            return out  # host work (a Python scalar made on the CPU)
        owner = self._owner(ins)
        c = self.counts[owner]
        packet = func.overloadpacket
        if packet in _DOTS:
            result = next(t for t in _tensors(out))
            c.dot_flops[dtype_name(result.dtype)] += float(flop_registry[packet](*args, **kwargs, out_val=out))
        if not self._quiet:
            c.traffic_bytes += self._traffic(func, packet, args, ins, out)
        for t in _tensors(out):
            if t.device.type == "meta":
                self._own(t, owner)
        return out

    def _owner(self, ins: list):
        """The device an op runs on: the one whose scope is open (None:
        none), but in a backward, in the scope the backward began in, that
        of its first input made in a device's scope: a backward op runs
        where its forward ran, as the autograd engine runs it on the
        forward's stream."""
        dev = current_logical()
        if torch._C._current_autograd_node() is None:
            self._backward_scope = ()
        else:
            if self._backward_scope == ():
                self._backward_scope = dev
            if dev is self._backward_scope:
                for t in ins:
                    entry = self._storages.get(id(t.untyped_storage()))
                    if entry is not None and entry[1] is not None:
                        return entry[1]
        return None if dev is None else dev.label

    @staticmethod
    def _traffic(func, packet, args, ins, out) -> int:
        if packet in _NO_TRAFFIC or func.is_view:
            return 0
        if packet in _WRITE_ONLY:
            return _bytes(args[0])
        if packet is aten.copy_:
            return _bytes(args[1]) + _bytes(args[0])
        if packet in _ROW_WRITES:
            rest = [t for t in ins if t is not args[0]]
            return sum(_bytes(t) for t in rest) + (_bytes(rest[-1]) if rest else 0)
        if packet in _GATHERS:
            idx = [t for t in ins if t is not args[0]]
            return 2 * sum(_bytes(t) for t in _tensors(out)) + sum(_bytes(t) for t in idx)
        written = _tensors(args[0]) if func._schema.name.endswith("_") else _tensors(out)
        return sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in written)

    # ------------------------------------------------------------ hooks
    @contextlib.contextmanager
    def repeated(self, extra: int):
        """The block's counts (not its memory) count ``1 + extra`` times."""
        before = copy.deepcopy(dict(self.counts))
        yield
        for owner, c in list(self.counts.items()):
            b = before.get(owner, _Counts())
            for k, v in c.dot_flops.items():
                c.dot_flops[k] = v + extra * (v - b.dot_flops.get(k, 0.0))
            for k, v in c.collective_bytes.items():
                c.collective_bytes[k] = v + extra * (v - b.collective_bytes.get(k, 0.0))
            for k, v in c.launches.items():
                c.launches[k] = v + extra * (v - b.launches.get(k, 0))
            for k, cost in c.kernels.items():
                if k in b.kernels:
                    cost = cost + (-1) * b.kernels[k]
                c.kernels[k] = c.kernels[k] + extra * cost
            c.traffic_bytes += extra * (c.traffic_bytes - b.traffic_bytes)

    def kernel_launch(self, name: str, cost: KernelCost) -> None:
        dev = current_logical()
        c = self.counts[None if dev is None else dev.label]
        c.kernels[name] = c.kernels[name] + cost if name in c.kernels else cost
        c.launches[name] += 1
        c.traffic_bytes += cost.bytes

    @contextlib.contextmanager
    def collective(self, kind: str, nbytes: int, devices):
        """The block is one collective: ``nbytes`` of result at each of
        ``devices``, as collective bytes and as traffic; its steps inside
        count no traffic."""
        for dev in devices:
            c = self.counts[dev.label]
            c.collective_bytes[kind] += nbytes
            c.traffic_bytes += nbytes
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def summary(self) -> HloSummary:
        """Each count's largest device, plus what ran outside any scope
        (collective bytes: each type's largest device, and the total's)."""
        outside = self.counts.get(None, _Counts())
        devices = [c for owner, c in self.counts.items() if owner is not None] or [_Counts()]

        def most(get):
            return max(devices, key=get)

        dots = dict(outside.dot_flops)
        for k, v in most(lambda c: sum(c.dot_flops.values())).dot_flops.items():
            dots[k] = dots.get(k, 0.0) + v
        busy = most(lambda c: sum(k.bytes for k in c.kernels.values()) + len(c.launches))
        kernels, launches = dict(outside.kernels), dict(outside.launches)
        for name, cost in busy.kernels.items():
            kernels[name] = kernels[name] + cost if name in kernels else cost
            launches[name] = launches.get(name, 0) + busy.launches[name]
        coll = dict(outside.collective_bytes)
        for k in {k for c in devices for k in c.collective_bytes}:
            coll[k] = coll.get(k, 0.0) + max(c.collective_bytes.get(k, 0.0) for c in devices)
        total_coll = (sum(outside.collective_bytes.values())
                      + max(sum(c.collective_bytes.values()) for c in devices))
        return HloSummary(
            dot_flops=sum(dots.values()),
            dot_flops_by_dtype=dots,
            kernels={name: dataclasses.asdict(cost) for name, cost in kernels.items()},
            launches=launches,
            traffic_bytes=outside.traffic_bytes + most(lambda c: c.traffic_bytes).traffic_bytes,
            collective_bytes=coll,
            total_collective_bytes=total_coll,
            temp_bytes=max([outside.peak] + [c.peak for c in devices]),
        )


@dataclasses.dataclass
class HloSummary:
    """Per-device counts of one traced program (the reference's names where
    they mean the same)."""

    dot_flops: float  # aten products, every dtype
    dot_flops_by_dtype: dict
    kernels: dict  # name -> {"flops": {dtype: FLOPs}, "exps", "bytes"} of all its launches
    launches: dict  # name -> launches
    traffic_bytes: float  # aten ops and the kernels' bytes
    collective_bytes: dict  # type -> bytes
    total_collective_bytes: float
    temp_bytes: int  # peak of the bytes made in the trace alive at once

    def roofline(self) -> dict:
        """Seconds at the H100's peaks: compute (each dtype's dot FLOPs at
        its peak, plus each kernel's busiest pipe), memory (the traffic at
        the HBM's rate), collective (the bytes over one NVLink
        direction), and the largest of the three."""
        kernel_s = sum(KernelCost(k["flops"], k["exps"], k["bytes"]).compute_seconds()
                       for k in self.kernels.values())
        compute = sum(v / PEAK_FLOPS[k] for k, v in self.dot_flops_by_dtype.items()) + kernel_s
        terms = {"compute": compute, "memory": self.traffic_bytes / PEAK_BYTES_S,
                 "collective": self.total_collective_bytes / NVLINK_BYTES_S}
        return {f"{k}_seconds": v for k, v in terms.items()} | {"dominant": max(terms, key=terms.get)}

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# the trace's own thread's stack: under a dispatch mode every op's output
# holds a Python object, and freeing a deep autograd graph (an sLSTM's token
# loop: thousands of steps) recurses through them past a main thread's 8 MiB
TRACE_STACK_BYTES = 1 << 30


def analyze(fn, *args, known=()) -> tuple:
    """Trace ``fn(*args)`` on the card's branch (meta tensors in ``args``;
    nothing allocated, nothing launched) -> (its output, the
    :class:`HloSummary`, the :class:`Analysis`).  Storages of ``args`` and
    of ``known`` (e.g. the parameters inside a module) are arguments: the
    peak counts only what the trace makes.  The trace runs on a thread of
    its own (:data:`TRACE_STACK_BYTES` of stack), under the calling
    thread's logical-axis rules and current mesh."""
    analysis = Analysis()
    analysis.known = {id(t.untyped_storage()) for t in _tensors((args, known))}
    rules, mesh, result = get_rules(), current_mesh(), {}

    def run():
        try:
            with use_rules(rules), mesh or contextlib.nullcontext(), _build.trace(analysis), analysis:
                result["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — raised again on the calling thread
            result["error"] = e

    previous = threading.stack_size(TRACE_STACK_BYTES)
    try:
        worker = threading.Thread(target=run, name="trace")
        worker.start()
    finally:
        threading.stack_size(previous)
    worker.join()
    if "error" in result:
        raise result["error"]
    return result["out"], analysis.summary(), analysis


def trace_devices(n: int) -> list:
    """``n`` logical devices on the meta device, without streams: a trace's
    mesh (no card, nothing allocated)."""
    return [LogicalDevice(torch.device("meta"), i, None, f"meta:{i}") for i in range(n)]
