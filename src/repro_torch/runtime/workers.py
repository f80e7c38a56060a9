"""Multi-threaded host-preprocessing worker pool (paper §6.1 producers).

Replaces ad-hoc producer threads with one reusable pool that owns the
threading story of the host stage:

* **work stealing** — items are sharded round-robin across per-worker
  deques; a worker that drains its own deque steals from the *tail* of a
  victim's, so one pathologically slow item (a huge frame, a cold codec
  path) no longer strands the rest of that worker's shard ("Understand
  Data Preprocessing for Effective End-to-End Training", Gong et al., 2023
  — multi-worker host preprocessing with balancing is what keeps the
  accelerator fed).
* **bounded backpressure** — outputs flow through a bounded queue; when
  the consumer (batcher/device) falls behind, producers block instead of
  growing an unbounded buffer of decoded frames.
* **per-worker codec state** — an optional ``worker_state_factory`` gives
  each thread its own scratch (codec tables, arenas); ``host_fn`` is then
  called as ``host_fn(item, state)``, so stages can keep mutable decode
  state without locking.
* **memory admission** — with a :class:`~repro_torch.runtime.memory.MemoryBudget`
  attached, each worker admits the item's staged bytes *before* decoding
  and the consumer releases them after staging, bounding in-flight decoded
  bytes end to end.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, Sequence

from repro_torch.runtime.memory import MemoryBudget

_WORKER_DONE = object()


class HostStream:
    """Consumer handle for one :meth:`WorkerPool.process` run.

    ``get`` yields ``(index, array)`` in completion order and returns
    ``None`` once every worker has finished and the queue is drained.
    ``host_busy_seconds`` / ``errors`` are valid after that.
    """

    def __init__(self, pool: "WorkerPool", num_workers: int):
        self._q: queue.Queue = queue.Queue(maxsize=pool.queue_depth)
        self._budget = pool.budget
        self._budget_for = pool.budget_for
        self._item_nbytes = pool.item_nbytes
        self._num_workers = num_workers
        self._done_workers = 0
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._cancelled = False
        # budget admissions/releases, per budget object (multi-tenant runs
        # charge each item's bytes to its tenant's child budget)
        self._admitted: dict[int, list] = {}  # id(budget) -> [budget, count]
        self._released: dict[int, int] = {}  # id(budget) -> count
        self._reconciled = False
        self.host_busy_seconds = 0.0
        self.errors: list[BaseException] = []

    def _budget_of(self, idx: int | None) -> "MemoryBudget | None":
        """The admission budget charged for item ``idx`` (tenant-scoped when
        the pool has a ``budget_for`` map, the shared budget otherwise)."""
        if self._budget_for is not None and idx is not None:
            b = self._budget_for(idx)
            if b is not None:
                return b
        return self._budget

    def get(self, timeout: float | None = None):
        while True:
            msg = self._q.get(timeout=timeout)  # queue.Empty propagates
            if msg is _WORKER_DONE:
                self._done_workers += 1
                if self._done_workers == self._num_workers:
                    return None
                continue
            return msg

    def release_item(self, idx: int | None = None) -> None:
        """Return one item's budget bytes once the consumer has staged it.

        Tenant-tagged runs pass the item index so the release lands on the
        same (tenant) budget the worker admitted against."""
        budget = self._budget_of(idx)
        if budget is not None and self._item_nbytes:
            with self._lock:
                self._released[id(budget)] = self._released.get(id(budget), 0) + 1
            budget.release(self._item_nbytes)

    def cancel(self) -> None:
        """Unstick producers after the consumer abandons the stream."""
        self._cancelled = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def wait(self, timeout: float | None = None) -> None:
        """Join the worker threads; never raises.  Once every worker has
        exited, admissions that never reached the consumer (worker errors,
        cancellation drops) are released back to their budgets — otherwise a
        failed run would permanently shrink the byte headroom."""
        for t in self._threads:
            t.join(timeout)
        if (
            self._item_nbytes
            and not self._reconciled
            and not any(t.is_alive() for t in self._threads)
        ):
            self._reconciled = True
            with self._lock:
                leaks = [
                    (budget, count - self._released.get(bid, 0))
                    for bid, (budget, count) in self._admitted.items()
                ]
            for budget, leaked in leaks:
                for _ in range(leaked):
                    budget.release(self._item_nbytes)

    def join(self) -> None:
        self.wait()
        if self.errors:
            raise self.errors[0]


class WorkerPool:
    """Work-stealing host-stage thread pool feeding a bounded queue.

    Args:
      host_fn: ``item -> np.ndarray`` — or ``(item, state) -> np.ndarray``
        when ``worker_state_factory`` is given.
      num_workers: thread count (clamped to >= 1; recalibration may retune
        the *engine's* count between runs — the pool itself is immutable).
      queue_depth: backpressure bound on undelivered host outputs, items.
      worker_state_factory: called once per worker thread; its return value
        is passed to every ``host_fn`` call on that thread.
      budget: optional admission controller; ``item_nbytes`` are admitted
        before each ``host_fn`` call.  The *consumer* owns the matching
        ``budget.release(item_nbytes)`` once the item leaves the queue.
      budget_for: optional item-index → budget map for multi-tenant runs —
        each item's bytes are admitted against (and released to) its
        tenant's budget; indices it maps to None fall back to ``budget``.
      telemetry: optional :class:`~repro_torch.runtime.telemetry.Telemetry` hub —
        each item's host-stage time feeds the shared ``decode`` latency
        histogram (the same observations ``host_busy_seconds`` sums).
    """

    def __init__(
        self,
        host_fn: Callable[..., Any],
        num_workers: int = 4,
        queue_depth: int = 64,
        worker_state_factory: Callable[[], Any] | None = None,
        budget: MemoryBudget | None = None,
        item_nbytes: int = 0,
        budget_for: Callable[[int], MemoryBudget | None] | None = None,
        telemetry: Any = None,
    ):
        self.host_fn = host_fn
        self.num_workers = max(1, int(num_workers))
        self.queue_depth = max(1, int(queue_depth))
        self.worker_state_factory = worker_state_factory
        self.budget = budget
        self.budget_for = budget_for
        self.item_nbytes = int(item_nbytes)
        self.telemetry = telemetry

    # ------------------------------------------------------------- streaming
    def process(self, items: Sequence[Any]) -> HostStream:
        """Start the workers over ``items``; returns the output stream."""
        n = len(items)
        nw = self.num_workers
        stream = HostStream(self, nw)
        # Round-robin sharding; deque append/pop are atomic in CPython, so
        # steals need no locks.
        shards = [collections.deque(range(w, n, nw)) for w in range(nw)]

        def next_index(wid: int):
            try:
                return shards[wid].popleft()  # own shard: FIFO
            except IndexError:
                pass
            for off in range(1, nw):  # steal from the victim's tail
                try:
                    return shards[(wid + off) % nw].pop()
                except IndexError:
                    continue
            return None

        def worker(wid: int):
            state = self.worker_state_factory() if self.worker_state_factory else None
            busy = 0.0
            try:
                while not stream._cancelled:
                    idx = next_index(wid)
                    if idx is None:
                        break
                    budget = stream._budget_of(idx)
                    if budget is not None and self.item_nbytes:
                        # bound in-flight decoded bytes: admit before decode
                        admitted = False
                        while not stream._cancelled:
                            if budget.admit(self.item_nbytes, timeout=0.1):
                                admitted = True
                                break
                        if not admitted:  # cancelled while waiting
                            return
                        with stream._lock:
                            entry = stream._admitted.setdefault(id(budget), [budget, 0])
                            entry[1] += 1
                    t_in = time.perf_counter()
                    arr = (
                        self.host_fn(items[idx], state)
                        if self.worker_state_factory
                        else self.host_fn(items[idx])
                    )
                    dt = time.perf_counter() - t_in
                    busy += dt
                    if self.telemetry is not None:
                        self.telemetry.record("decode", dt)
                    self._put(stream, (idx, arr))
            except BaseException as e:  # noqa: BLE001 — re-raised by join()
                with stream._lock:
                    stream.errors.append(e)
            finally:
                with stream._lock:
                    stream.host_busy_seconds += busy
                self._put(stream, _WORKER_DONE)

        stream._threads = [
            threading.Thread(target=worker, args=(w,), daemon=True) for w in range(nw)
        ]
        for t in stream._threads:
            t.start()
        return stream

    def _put(self, stream: HostStream, msg) -> None:
        # bounded put that stays responsive to cancellation.  On the live
        # path DONE markers always land (the consumer drains until None);
        # after cancel() the consumer is gone, so even DONE is dropped —
        # wait()/join() track threads, not markers, and would otherwise
        # leave workers retrying into a full queue forever.
        while not stream._cancelled:
            try:
                stream._q.put(msg, timeout=0.1)
                return
            except queue.Full:
                continue

    # ------------------------------------------------------------ batch mode
    def map(self, items: Sequence[Any]) -> tuple[list[Any], float]:
        """Run the pool to completion; returns (outputs in item order,
        summed host-stage busy seconds)."""
        out: list[Any] = [None] * len(items)
        stream = self.process(items)
        try:
            while True:
                msg = stream.get()
                if msg is None:
                    break
                idx, arr = msg
                out[idx] = arr
                stream.release_item()
        finally:
            stream.cancel()
            stream.wait()
        if stream.errors:
            raise stream.errors[0]
        return out, stream.host_busy_seconds
