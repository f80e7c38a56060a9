"""SMOL's optimized runtime engine (paper §6.1, Appendix A), on torch/CUDA.

The paper's engine: producer threads entropy-decode + preprocess into an
MPMC queue; consumer threads drive the accelerator over CUDA streams;
buffers are preallocated/pinned and reused.

Here the device program runs on the device's current CUDA stream and
overlap comes from *asynchronous launches* — ``program(batch)`` enqueues
the host-to-device copy, the kernels and the DNN and returns the output
tensor at once, while the host goes on preparing the next batch.  A CUDA
event recorded right after each dispatch tells when that batch finished.
So:

* the host stage (entropy decode + host-placed preprocessing ops) runs on
  a :class:`~repro_torch.runtime.workers.WorkerPool` — work-stealing producer
  threads feeding a bounded backpressure queue,
* the consumer assembles batches into **leased staging buffers** drawn
  from a :class:`~repro_torch.runtime.memory.BufferPool` — page-locked
  (pinned) host memory on a CUDA device, so the copy to the card is
  asynchronous — and releases each lease only when its batch retires, so
  an in-flight copy never reads a recycled buffer,
* an optional :class:`~repro_torch.runtime.memory.MemoryBudget` bounds total
  in-flight decoded bytes: producers admit before decoding, the consumer
  releases after staging,
* device dispatch is asynchronous; we only wait on a batch's event when
  ``ring_slots`` batches are in flight — by which time the previous batch
  has typically drained.

``mode='preproc_only' | 'exec_only' | 'pipelined'`` reproduces the paper's
measurement protocol (§8.2, Table 3).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class EngineStats:
    mode: str
    num_items: int
    wall_seconds: float
    batches: int
    # Stage occupancy, the feedback signal for online recalibration (§6.3):
    # host_busy_seconds sums wall time spent inside host_fn across all
    # producers; device_busy_seconds estimates the accelerator stream's busy
    # interval (the device program runs on one ordered CUDA stream, so
    # consecutive dispatch->completion intervals are merged, not
    # double-counted).
    host_busy_seconds: float = 0.0
    device_busy_seconds: float = 0.0
    # Memory-subsystem occupancy at the end of the run: a PoolStats /
    # BudgetStats snapshot (None when pooling / the budget is disabled).
    pool_stats: Any = None
    budget_stats: Any = None
    # Multi-tenant accounting (None on untenanted runs): items staged and
    # staging bytes charged per tenant — each leased buffer row and batch
    # slot is attributed to the tenant whose item filled it.
    tenant_items: dict | None = None
    tenant_bytes: dict | None = None

    @property
    def throughput(self) -> float:
        return self.num_items / self.wall_seconds if self.wall_seconds > 0 else float("inf")

    @property
    def host_seconds_per_item(self) -> float:
        return self.host_busy_seconds / self.num_items if self.num_items else 0.0

    @property
    def device_seconds_per_batch(self) -> float:
        return self.device_busy_seconds / self.batches if self.batches else 0.0

    @property
    def device_seconds_per_item(self) -> float:
        return self.device_busy_seconds / self.num_items if self.num_items else 0.0


class PipelinedEngine:
    """End-to-end pipelined executor for one compiled plan.

    Args:
      host_fn: item -> np.ndarray of fixed shape/dtype (host stage: decode +
        host-placed preprocessing).  With ``worker_state_factory`` set it is
        called as ``host_fn(item, state)`` with that worker's private state.
      device_fn: either a compiled
        :class:`repro_torch.core.device_compiler.DevicePreprocProgram`
        (one program covering device preprocessing + DNN, one dispatch per
        batch, on its own device), or a bare (batch) -> outputs callable
        run on ``device``.
      out_shape/out_dtype: per-item output of host_fn.
      batch_size: device batch.
      num_workers: producer threads (paper heuristic: ~#cores).  Mutable —
        online recalibration retunes it between runs.
      queue_depth: bounded MPMC queue size, in items (over-allocated so
        producers never contend on the consumer — §6.1).
      ring_slots: max async-dispatched batches in flight (staging leases
        outstanding).
      memory: MemoryConfig governing staging-buffer pooling and the
        in-flight decoded-bytes budget.  Defaults to pooling on, no budget.
      worker_state_factory: per-producer-thread codec/scratch state.
      tenant_budgets: optional tenant-name → MemoryBudget map for
        multi-tenant batch runs (see :meth:`run`'s ``tenants``): each
        item's decoded bytes are admitted against its tenant's budget, so
        admission charges the tenant that decoded them.
      telemetry: optional telemetry hub (``record``/``emit_span``) —
        the worker pool feeds the ``decode`` histogram per item, staging
        handoffs feed the ``stage`` histogram and each retired batch feeds
        the ``dispatch`` histogram (dispatch → retirement), so batch runs
        share the serving path's latency surfaces.
      double_buffer: dispatch batches from a dedicated dispatcher thread
        fed by a bounded staging queue, so batch N+1's host-to-device copy
        and launches overlap batch N's compute and the consumer never
        stalls on staging.  ``False`` keeps the synchronous-staging loop.
      device: where a bare ``device_fn`` runs (a compiled program carries
        its own); CUDA gets pinned staging buffers and event-based
        retirement.  Default: the CPU.
      program_set: optional :class:`~repro_torch.core.device_compiler.ProgramSet`
        of bucket programs — ragged tail batches dispatch through the
        smallest covering bucket's program (``buf[:bucket]``; on CUDA a
        captured graph once the set is warm) instead of the full buffer.

    Only a batch's real rows are read at retirement, so padding rows (stale
    staging contents) never reach an output.
    """

    def __init__(
        self,
        host_fn: Callable[..., np.ndarray],
        device_fn: Callable[[Any], Any],
        out_shape: tuple[int, ...],
        out_dtype: Any,
        batch_size: int,
        num_workers: int = 4,
        queue_depth: int | None = None,
        ring_slots: int = 3,
        memory: Any = None,
        worker_state_factory: Callable[[], Any] | None = None,
        tenant_budgets: Any = None,
        telemetry: Any = None,
        double_buffer: bool = True,
        device: str | torch.device | None = None,
        program_set: Any = None,
    ):
        # Deferred: repro_torch.core must stay importable without
        # repro_torch.runtime (runtime's facade imports this module at
        # package-init time).
        from repro_torch.core.device_compiler import DevicePreprocProgram
        from repro_torch.runtime import memory as memory_mod

        self.host_fn = host_fn
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.queue_depth = queue_depth or 4 * batch_size
        self.ring_slots = ring_slots
        self.out_shape = tuple(out_shape)
        self.out_dtype = out_dtype
        self.worker_state_factory = worker_state_factory
        self.telemetry = telemetry
        self.double_buffer = double_buffer
        self.program_set = program_set
        if isinstance(device_fn, DevicePreprocProgram):
            self.device = device_fn.device
        else:
            self.device = torch.device("cpu" if device is None else device)
        self.memory = memory or memory_mod.MemoryConfig()
        # Leased, reused staging buffers — the pinned-buffer pool of
        # Appendix A — behind the TransferPool's bounded slot count: at most
        # ring_slots + 1 staging buffers exist (filling + queued + in
        # flight), so the double-buffered consumer backpressures instead of
        # racing ahead of the device.  pooling=False keeps the
        # allocate-per-batch baseline.  Pinned on CUDA: non_blocking copies.
        self._transfer = self.memory.build_transfer_pool(
            ring_slots + 1, pinned=self.device.type == "cuda"
        )
        self._budget = self.memory.build_budget()
        self.tenant_budgets = dict(tenant_budgets) if tenant_budgets else None
        self._item_nbytes = int(np.prod(self.out_shape, dtype=np.int64)) * np.dtype(
            out_dtype
        ).itemsize
        self.device_program = (
            device_fn if isinstance(device_fn, DevicePreprocProgram) else None
        )
        self.device_fn = device_fn
        self._warmed = False

    # ------------------------------------------------------------- memory API
    def _acquire_staging(self, liveness_check: Callable[[], None] | None = None):
        """One batch staging buffer leased from the bounded transfer pool.

        Blocks while every slot is staged or in flight (backpressure);
        ``liveness_check`` runs between waits so a consumer blocked on a
        dead dispatcher raises its error instead of hanging.  Returns
        (array, lease)."""
        shape = (self.batch_size, *self.out_shape)
        while True:
            lease = self._transfer.lease(shape, self.out_dtype, timeout=0.1)
            if lease is not None:
                return lease.array, lease
            if liveness_check is not None:
                liveness_check()

    def _make_worker_pool(self, tenants: Sequence[str] | None = None):
        from repro_torch.runtime.workers import WorkerPool

        budget_for = None
        if tenants is not None and self.tenant_budgets:
            budgets, names = self.tenant_budgets, tenants
            budget_for = lambda idx: budgets.get(names[idx])  # noqa: E731
        return WorkerPool(
            self.host_fn,
            num_workers=self.num_workers,
            queue_depth=self.queue_depth,
            worker_state_factory=self.worker_state_factory,
            budget=self._budget,
            item_nbytes=self._item_nbytes,
            budget_for=budget_for,
            telemetry=self.telemetry,
        )

    def configure_tenants(self, tenant_cfgs: Sequence[Any]) -> None:
        """Carve per-tenant child budgets out of the engine's byte budget.

        ``tenant_cfgs`` are TenantConfig-like
        objects (name/weight/floor_bytes/budget_bytes).  No-op when the
        engine runs without a budget — tenant *accounting* in stats still
        works, only byte admission stays unscoped.
        """
        if self._budget is None:
            return
        self.tenant_budgets = {
            cfg.name: self._budget.child(
                cfg.name,
                weight=cfg.weight,
                floor_bytes=cfg.floor_bytes,
                max_bytes=cfg.budget_bytes,
            )
            for cfg in tenant_cfgs
        }

    def pool_stats(self):
        pool = self._transfer.buffers
        return pool.stats() if pool is not None else None

    def transfer_stats(self):
        return self._transfer.stats()

    def budget_stats(self):
        return self._budget.stats() if self._budget is not None else None

    # ---------------------------------------------------------------- modes
    def run_preproc_only(self, items: Sequence[Any]) -> EngineStats:
        """Producer-pool throughput with the device leg disabled."""
        t0 = time.perf_counter()
        stream = self._make_worker_pool().process(items)
        try:
            while stream.get() is not None:
                stream.release_item()
        finally:
            stream.cancel()
            stream.wait()  # joins threads + reconciles leaked admissions
        if stream.errors:
            raise stream.errors[0]
        return EngineStats(
            "preproc_only",
            len(items),
            time.perf_counter() - t0,
            0,
            host_busy_seconds=stream.host_busy_seconds,
            pool_stats=self.pool_stats(),
            budget_stats=self.budget_stats(),
        )

    def run_exec_only(self, num_items: int) -> EngineStats:
        """Device throughput on synthetic inputs (paper §4: 'measured using
        synthetic data')."""
        batch = np.zeros((self.batch_size, *self.out_shape), dtype=self.out_dtype)
        n_batches = max(1, num_items // self.batch_size)
        self.device_fn(batch)
        _wait(_record_done(self.device))  # warmup outside the clock
        t0 = time.perf_counter()
        done = []
        for _ in range(n_batches):
            self.device_fn(batch)
            done.append(_record_done(self.device))
            if len(done) > 2:
                _wait(done.pop(0))  # bounded in-flight work
        for ev in done:
            _wait(ev)
        dt = time.perf_counter() - t0
        return EngineStats(
            "exec_only", n_batches * self.batch_size, dt, n_batches, device_busy_seconds=dt
        )

    def run(
        self,
        items: Sequence[Any],
        return_outputs: bool = True,
        tenants: Sequence[str] | None = None,
    ) -> tuple[list[Any], EngineStats]:
        """Fully pipelined end-to-end execution.

        ``tenants`` (optional, one name per item) tags every item with the
        tenant that owns it: decoded-byte admission charges that tenant's
        budget (see ``tenant_budgets``) and the returned stats carry
        per-tenant staged-item/byte accounting.
        """
        n = len(items)
        if tenants is not None and len(tenants) != n:
            raise ValueError(
                f"tenants ({len(tenants)}) must align with items ({n})"
            )
        if not self._warmed:
            if self.device_program is not None and self.device_program.dispatch_count:
                self._warmed = True  # AOT-warmed program: already compiled + run
            else:
                # Warm up the program outside the measured window (once per
                # engine): the first dispatch builds the kernels and pays
                # the first launches.
                warm = np.zeros((self.batch_size, *self.out_shape), dtype=self.out_dtype)
                self.device_fn(warm)
                _wait(_record_done(self.device))
                self._warmed = True

        tenant_items: dict[str, int] | None = None
        tenant_bytes: dict[str, int] | None = None
        if tenants is not None:
            tenant_items = {}
            tenant_bytes = {}
        clock = _DeviceClock()
        t0 = time.perf_counter()
        stream = self._make_worker_pool(tenants).process(items)

        outputs: list[Any] = [None] * n if return_outputs else []
        consume = (
            self._consume_double_buffered if self.double_buffer else self._consume_sync
        )
        try:
            n_batches = consume(
                stream, outputs, return_outputs, tenants, tenant_items, tenant_bytes, clock
            )
        finally:
            stream.cancel()
            stream.wait()  # joins threads + reconciles leaked admissions
        dt = time.perf_counter() - t0
        if stream.errors:
            raise stream.errors[0]
        return outputs, EngineStats(
            "pipelined",
            n,
            dt,
            n_batches,
            host_busy_seconds=stream.host_busy_seconds,
            device_busy_seconds=clock.busy,
            pool_stats=self.pool_stats(),
            budget_stats=self.budget_stats(),
            tenant_items=tenant_items,
            tenant_bytes=tenant_bytes,
        )

    # ------------------------------------------------------- consumer loops
    def _stage_row(self, stream, msg, buf, batch_idx, tenants, tenant_items, tenant_bytes):
        idx, arr = msg
        buf[len(batch_idx)] = arr
        stream.release_item(idx)  # staged: decoded bytes retire
        if tenants is not None:
            name = tenants[idx]
            tenant_items[name] = tenant_items.get(name, 0) + 1
            tenant_bytes[name] = tenant_bytes.get(name, 0) + self._item_nbytes
        batch_idx.append(idx)

    def _dispatch_fn(self, count: int):
        """The program dispatching ``count`` staged rows: the smallest
        covering bucket's program when a ProgramSet is bound (a ragged tail
        runs it on ``buf[:bucket]``), else the full-batch fn.  Returns
        (fn, rows-or-None)."""
        if self.program_set is not None and count < self.batch_size:
            hit = self.program_set.program_for(count)
            if hit is not None:
                return hit
        return self.device_fn, None

    def _dispatch(self, buf, count: int):
        """Enqueue one staged batch of ``count`` real rows; returns (device
        output, done event)."""
        fn, rows = self._dispatch_fn(count)
        dev_out = fn(buf if rows is None else buf[:rows])
        return dev_out, _record_done(self.device)

    def _consume_sync(
        self, stream, outputs, return_outputs, tenants, tenant_items, tenant_bytes, clock
    ) -> int:
        """Synchronous-staging consumer: each batch's dispatch (and its
        synchronous H2D leg) runs inline on this thread."""
        # in-flight entries: (row->item indices, device output, done event,
        # dispatch time, staging lease to release at retirement)
        in_flight: list[tuple[list[int], Any, Any, float, Any]] = []
        batch_idx: list[int] = []
        buf, lease = self._acquire_staging()
        n_batches = 0

        def flush(count: int):
            nonlocal buf, lease, batch_idx, n_batches
            if count == 0:
                return
            dispatch_t = time.perf_counter()
            dev_out, done = self._dispatch(buf, count)  # async dispatch
            in_flight.append((list(batch_idx[:count]), dev_out, done, dispatch_t, lease))
            n_batches += 1
            if len(in_flight) >= self.ring_slots:
                self._retire(in_flight.pop(0), outputs, return_outputs, clock)
            buf, lease = self._acquire_staging()
            batch_idx = []

        def retire_ready():
            # Eager retirement: record completion close to when the device
            # actually finished, instead of when the ring forces a block.
            # Without this, deferred retires attribute consumer/host wait
            # time to the device and inflate device_busy_seconds — the
            # recalibration signal — in host-bound regimes.
            while in_flight and _is_done(in_flight[0][2]):
                self._retire(in_flight.pop(0), outputs, return_outputs, clock)

        try:
            while True:
                retire_ready()
                try:
                    # short timeout so completions are noticed (and timed)
                    # even when the host stage starves the queue
                    msg = stream.get(timeout=0.002 if in_flight else None)
                except queue.Empty:
                    continue
                if msg is None:
                    break
                self._stage_row(
                    stream, msg, buf, batch_idx, tenants, tenant_items, tenant_bytes
                )
                if len(batch_idx) == self.batch_size:
                    flush(self.batch_size)
            if batch_idx:  # ragged tail: bucketed dispatch, padding never read back
                flush(len(batch_idx))
            while in_flight:
                self._retire(in_flight.pop(0), outputs, return_outputs, clock)
        finally:
            if lease is not None:
                lease.release()  # the partially-filled buffer never dispatched
        return n_batches

    def _consume_double_buffered(
        self, stream, outputs, return_outputs, tenants, tenant_items, tenant_bytes, clock
    ) -> int:
        """Double-buffered consumer: a dispatcher thread drains a bounded
        staging queue, so batch N+1's host-to-device copy + dispatch
        overlap batch N's compute while this thread only fills staging
        buffers.  Waiting on a batch's event happens at retirement only
        (dispatcher side) — the consumer never waits on the device."""
        stage_q: queue.Queue = queue.Queue(maxsize=2)
        disp_errors: list[BaseException] = []
        stopped = threading.Event()

        def dispatcher():
            in_flight: list[tuple[list[int], Any, Any, float, Any]] = []
            current = None  # lease taken off the queue, not yet in in_flight
            try:
                while True:
                    try:
                        msg = stage_q.get(timeout=0.002 if in_flight else None)
                    except queue.Empty:
                        while in_flight and _is_done(in_flight[0][2]):
                            self._retire(in_flight.pop(0), outputs, return_outputs, clock)
                        continue
                    if msg is None:
                        break
                    idxs, dbuf, dlease, t_staged = msg
                    current = dlease
                    dispatch_t = time.perf_counter()
                    dev_out, done = self._dispatch(dbuf, len(idxs))
                    t_called = time.perf_counter()
                    if self.telemetry is not None:
                        # queue wait + the dispatch call's enqueue (copy and
                        # launches) — staging cost the consumer no longer pays
                        self.telemetry.record("stage", t_called - t_staged)
                        if self.telemetry.config.spans:
                            self.telemetry.emit_span(
                                "batch", "stage", None,
                                self.telemetry.next_batch_id(),
                                t_staged, t_called, replica=0, size=len(idxs),
                            )
                    in_flight.append((idxs, dev_out, done, dispatch_t, dlease))
                    current = None  # ownership moved into the ring
                    if len(in_flight) >= self.ring_slots:
                        self._retire(in_flight.pop(0), outputs, return_outputs, clock)
                    while in_flight and _is_done(in_flight[0][2]):
                        self._retire(in_flight.pop(0), outputs, return_outputs, clock)
                while in_flight:
                    self._retire(in_flight.pop(0), outputs, return_outputs, clock)
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                disp_errors.append(e)
                if current is not None:
                    current.release()
                for *_rest, dlease in in_flight:
                    if dlease is not None:
                        dlease.release()
            finally:
                stopped.set()

        thread = threading.Thread(target=dispatcher, name="engine-dispatcher", daemon=True)
        thread.start()

        def check_dispatcher():
            if disp_errors:
                raise disp_errors[0]

        def enqueue(msg):
            while True:
                check_dispatcher()
                try:
                    stage_q.put(msg, timeout=0.05)
                    return
                except queue.Full:
                    continue

        n_batches = 0
        batch_idx: list[int] = []
        buf, lease = self._acquire_staging(check_dispatcher)
        try:
            while True:
                try:
                    msg = stream.get(timeout=0.1)
                except queue.Empty:
                    check_dispatcher()
                    continue
                if msg is None:
                    break
                self._stage_row(
                    stream, msg, buf, batch_idx, tenants, tenant_items, tenant_bytes
                )
                if len(batch_idx) == self.batch_size:
                    enqueue((batch_idx, buf, lease, time.perf_counter()))
                    n_batches += 1
                    batch_idx = []
                    buf, lease = self._acquire_staging(check_dispatcher)
            if batch_idx:  # ragged tail: padding rows are stale, never read back
                enqueue((batch_idx, buf, lease, time.perf_counter()))
                n_batches += 1
                batch_idx, buf, lease = [], None, None
        finally:
            if lease is not None:
                lease.release()  # the partially-filled buffer never dispatched
            while True:  # hand the dispatcher its shutdown sentinel
                try:
                    stage_q.put(None, timeout=0.05)
                    break
                except queue.Full:
                    if stopped.is_set():
                        break
            thread.join()
            while True:  # error path: staged-but-never-dispatched leases
                try:
                    left = stage_q.get_nowait()
                except queue.Empty:
                    break
                if left is not None and left[2] is not None:
                    left[2].release()
        if disp_errors:
            raise disp_errors[0]
        return n_batches

    # -------------------------------------------------------------- helpers
    def _retire(self, entry, outputs, return_outputs: bool, clock: "_DeviceClock | None" = None):
        idxs, dev_out, done, dispatch_t, lease = entry
        try:
            _wait(done)
            if return_outputs:
                host_out = _to_host(dev_out)
                for row, idx in enumerate(idxs):
                    outputs[idx] = host_out[row]
        finally:
            if lease is not None:
                lease.release()  # staging buffer back to the pool
        now = time.perf_counter()
        if clock is not None:
            clock.retire(dispatch_t)
        if self.telemetry is not None:
            # dispatch -> retirement; an upper bound on device time (eager
            # event polling keeps it tight), matching _DeviceClock
            self.telemetry.record("dispatch", now - dispatch_t)
            if self.telemetry.config.spans:
                self.telemetry.emit_span(
                    "batch", "dispatch", None, self.telemetry.next_batch_id(),
                    dispatch_t, now, replica=0, size=len(idxs),
                )


def _record_done(device: torch.device):
    """A CUDA event recorded on the device's current stream right after a
    dispatch (None on the CPU, where a dispatch returns finished)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _is_done(ev) -> bool:
    """True when the batch behind ``ev`` has finished on the device."""
    return ev is None or ev.query()


def _wait(ev) -> None:
    if ev is not None:
        ev.synchronize()


def _to_host(x) -> np.ndarray:
    """Model outputs as a host array (a device tensor is copied back)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _DeviceClock:
    """Busy-interval accumulator for the (serial) accelerator stream.

    Dispatch happens asynchronously; by the time we block on a batch, later
    batches may already be queued.  Merging [dispatch, retire] intervals via
    a watermark avoids counting the overlap twice.  Retire times are an
    upper bound on completion; the engine retires eagerly (event polling)
    to keep the bound tight.
    """

    def __init__(self):
        self.busy = 0.0
        self._watermark = 0.0

    def retire(self, dispatch_t: float) -> None:
        now = time.perf_counter()
        start = max(dispatch_t, self._watermark)
        if now > start:
            self.busy += now - start
        self._watermark = now


def measure_plan(
    host_fn,
    device_fn,
    items,
    out_shape,
    out_dtype,
    batch_size: int,
    num_workers: int = 4,
    device: str | torch.device | None = None,
) -> dict[str, float]:
    """Paper §8.2 protocol: measure preproc-only, exec-only, and pipelined
    throughput for one plan.  Returns items/sec per mode."""
    eng = PipelinedEngine(
        host_fn, device_fn, out_shape, out_dtype, batch_size, num_workers=num_workers,
        device=device,
    )
    pre = eng.run_preproc_only(items)
    ex = eng.run_exec_only(len(items))
    _, piped = eng.run(items, return_outputs=False)
    return {
        "preproc": pre.throughput,
        "exec": ex.throughput,
        "pipelined": piped.throughput,
    }
