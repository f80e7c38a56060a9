"""Request-level front end over compiled plans: dynamic batching + reorder,
**multi-tenant** (weighted-fair scheduling + per-tenant admission) and
**multi-replica** (one shared fair queue feeding N replica dispatchers).

The batch API (:meth:`repro_torch.core.engine.PipelinedEngine.run`) assumes the
whole corpus is present up front.  Serving gets items one at a time, from
*many* users, so the scheduler adds the pieces the paper's engine leaves to
the server:

* **dynamic batching** — a batcher thread collects host-stage outputs into
  a device batch, dispatching when the batch fills *or* the oldest queued
  request has waited ``max_wait_ms`` (latency/throughput knob).  The
  deadline is per batch and per tenant: ``TenantConfig.max_wait_ms``
  overrides the global default, and a batch closes at the *tightest*
  deadline of any tenant holding a slot in it — latency tenants dispatch
  early, throughput tenants keep batching;
* **replica dispatchers** — a binding may carry one compiled program *per
  replica* (``device_fn`` as a sequence, or ``num_replicas`` over one
  function); each replica runs its own batcher thread, and every batcher
  pulls from the *global* per-tenant ready deques under one lock, so
  tenant weights span replicas (a weight-4 tenant gets 4x service on the
  whole mesh, not per replica).  A replica failure — a dispatch raising
  :class:`~repro_torch.distributed.fault_tolerance.ReplicaFailure`, or
  :meth:`fail_replica` marking it dead between dispatches — drains the
  failed batch's items *back to the front* of their tenants' ready deques
  and re-dispatches them on surviving replicas (zero requests lost);
  ``plan_elastic_restart`` sizes the remaining mesh, and when the last
  replica dies the scheduler degrades to completing requests with the
  failure error instead of hanging;
* **a reorder buffer** — device batches complete in dispatch order but
  requests may finish host preprocessing out of order; :meth:`drain`
  releases completed requests in submission (uid) order, except that
  completions belonging to *latency tenants* (``max_wait_ms`` set) leave
  ahead of throughput tenants' (drain priority: a latency tenant's
  finished request never queues behind a throughput tenant's backlog);
* **weighted fair queuing** — every request belongs to a tenant
  (:class:`TenantConfig`; ``submit(item, tenant=...)``).  Both contention
  points — host-worker pickup and batch-slot formation — serve tenants by
  start-time fair queuing: each tenant carries a virtual time advanced by
  ``1/weight`` per item served, and the scheduler always serves the
  backlogged tenant with the smallest virtual time.  A tenant with weight
  4 gets 4× the service of a weight-1 tenant under saturation, and a
  newly-active tenant's virtual time is clamped to the scheduler's clock,
  so a 100:1 burst from one tenant delays another's first item by at most
  a few weighted slots (bounded starvation);
* **per-tenant admission** — ``max_pending`` caps in-flight requests *per
  tenant* (excess submits block for backpressure or raise
  :class:`SchedulerSaturated` for load shedding — one tenant saturating
  its own quota never trips another's admission), and per-tenant
  :class:`~repro_torch.runtime.memory.MemoryBudget` children bound in-flight
  *bytes*, charging the tenant that decoded them;
* **per-tenant plan bindings** — tenants may pin different models/plans
  (:meth:`bind_tenant`); batches only mix tenants that share a binding,
  and the weighted-fair pick decides which binding's batch forms next.

Host preprocessing runs on a worker pool exactly like the engine's
producers.  The stage functions can be swapped via :meth:`rebind` (the
default binding) or :meth:`bind_tenant` — the hooks online recalibration
uses to apply a new placement split.  Both *drain in-flight requests
first* (they block briefly; recalibration events are rare) so no item
preprocessed by an old host stage meets a new device stage or
staging-buffer signature.

A request whose host or device stage raises completes with its ``error``
field set rather than killing the worker/batcher thread — serving keeps
going, and the caller sees the failure on drain.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import dispatch_scope
from repro_torch.distributed.fault_tolerance import (
    ElasticPlan,
    ReplicaFailure,
    plan_elastic_restart,
)
from repro_torch.runtime.memory import MemoryBudget
from repro_torch.runtime.rendition_cache import set_current_tenant
from repro_torch.runtime.telemetry import ReqTimes, Telemetry

DEFAULT_TENANT = "default"


class SchedulerSaturated(RuntimeError):
    """submit() rejected: the tenant is at its max_pending / byte quota."""


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's serving contract.

    ``weight`` sets the fair-queuing service share (items served in
    proportion to weight under saturation).  ``max_pending`` and
    ``budget_bytes`` are per-tenant admission quotas (falling back to the
    scheduler-wide defaults when unset); ``floor_bytes`` is the byte floor
    guaranteed under a hierarchical parent budget.  ``max_wait_ms``
    overrides the scheduler-wide dynamic-batching deadline for batches
    this tenant participates in — a latency tenant's batch closes early
    while throughput tenants keep the global (or their own longer) wait.
    ``model`` optionally pins the tenant to one model id — the runtime
    facade resolves it to a dedicated compiled plan and binds it via
    :meth:`RequestScheduler.bind_tenant`.
    """

    name: str
    weight: float = 1.0
    max_pending: int | None = None
    budget_bytes: int | None = None
    floor_bytes: int = 0
    max_wait_ms: float | None = None  # per-tenant batch deadline override
    model: str | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be positive, got {self.weight}"
            )
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(f"tenant {self.name!r}: max_pending must be >= 1")
        if self.budget_bytes is not None and self.budget_bytes <= 0:
            raise ValueError(f"tenant {self.name!r}: budget_bytes must be positive")
        if self.floor_bytes < 0:
            raise ValueError(f"tenant {self.name!r}: floor_bytes must be >= 0")
        if self.max_wait_ms is not None and self.max_wait_ms < 0:
            raise ValueError(f"tenant {self.name!r}: max_wait_ms must be >= 0")


@dataclasses.dataclass
class TenantStats:
    """Per-tenant serving counters (the fairness observability surface)."""

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0
    batch_items: int = 0
    host_items: int = 0
    host_busy_seconds: float = 0.0
    device_busy_seconds: float = 0.0  # batch device time, attributed per item
    admission_blocked_seconds: float = 0.0
    refetched: int = 0  # items internally resubmitted (cascade pass-through)


@dataclasses.dataclass
class CompletedRequest:
    uid: int
    output: Any  # None when error is set
    submitted_at: float
    completed_at: float
    error: BaseException | None = None
    tenant: str = DEFAULT_TENANT

    @property
    def latency(self) -> float:
        return self.completed_at - self.submitted_at


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0  # admission-control rejections (never entered the pipe)
    batches: int = 0
    batch_items: int = 0
    host_items: int = 0  # items through the host stage (>= completed)
    host_busy_seconds: float = 0.0
    device_busy_seconds: float = 0.0
    admission_blocked_seconds: float = 0.0  # time submit() spent backpressured
    replica_failures: int = 0  # replicas lost from the serving mesh
    redispatched_items: int = 0  # items drained off failed replicas + re-served
    refetched_items: int = 0  # cascade pass-throughs resubmitted internally

    @property
    def mean_batch_size(self) -> float:
        return self.batch_items / self.batches if self.batches else 0.0


@dataclasses.dataclass(frozen=True)
class ReplicaSnapshot:
    """One replica dispatcher's counters (the mesh observability surface)."""

    index: int
    device: str  # facade-supplied label ("cpu:0", "sharded[0-3]", ...)
    alive: bool
    batches: int
    items: int
    dispatch_errors: int
    redispatched_items: int  # items drained back off this replica on failure


class _ReplicaState:
    __slots__ = ("index", "device", "alive", "batches", "items",
                 "dispatch_errors", "redispatched_items")

    def __init__(self, index: int, device: str):
        self.index = index
        self.device = device
        self.alive = True
        self.batches = 0
        self.items = 0
        self.dispatch_errors = 0
        self.redispatched_items = 0

    def snapshot(self) -> ReplicaSnapshot:
        return ReplicaSnapshot(
            index=self.index,
            device=self.device,
            alive=self.alive,
            batches=self.batches,
            items=self.items,
            dispatch_errors=self.dispatch_errors,
            redispatched_items=self.redispatched_items,
        )


def _to_host(out: Any) -> np.ndarray:
    """A dispatch's rows as a host array.  A device tensor is copied back
    on the calling thread's current stream — the stream the program's work
    was enqueued on — so the copy waits for that work and nothing else."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def _as_device_fns(device_fn) -> tuple:
    """Normalize a binding's device side: one callable, or one per replica."""
    if isinstance(device_fn, (list, tuple)):
        fns = tuple(device_fn)
        if not fns:
            raise ValueError("device_fn sequence must be non-empty")
        return fns
    return (device_fn,)


class _Binding:
    """One compiled plan's stage functions + staging signature.  Tenants
    sharing a binding (by identity) may share device batches.  The device
    side is one compiled program per replica (a single program is
    replicated across all dispatchers)."""

    __slots__ = (
        "host_fn",
        "device_fns",
        "program_sets",
        "out_shape",
        "out_dtype",
        "item_nbytes",
    )

    def __init__(self, host_fn, device_fn, out_shape, out_dtype, program_sets=None):
        self.host_fn = host_fn
        self.device_fns = _as_device_fns(device_fn)
        self.program_sets = tuple(program_sets) if program_sets else ()
        self.retarget(out_shape, out_dtype)

    @property
    def device_fn(self):  # the single-replica view (engine/batch path)
        return self.device_fns[0]

    def device_fn_for(self, replica: int):
        return self.device_fns[replica % len(self.device_fns)]

    def dispatch_fn_for(self, replica: int, n: int):
        """Program for an ``n``-item batch on ``replica``.

        With a :class:`ProgramSet` bound, a ragged batch dispatches
        through the smallest pre-compiled bucket covering ``n`` (the batch
        buffer is sliced to the bucket, padding lanes never reach outputs).
        While a background warmup is still running (``require_ready``
        program sets), only *warmed* buckets are served — the set answers
        with the smallest ready covering bucket, so a dispatcher never
        pays a request-path compile mid-warm.  Returns ``(fn, bucket)``;
        ``bucket=None`` means dispatch the full buffer through the plain
        per-replica program.
        """
        if self.program_sets and n:
            ps = self.program_sets[replica % len(self.program_sets)]
            hit = ps.program_for(n)
            if hit is not None:
                return hit
        return self.device_fns[replica % len(self.device_fns)], None

    def retarget(self, out_shape, out_dtype) -> None:
        self.out_shape = tuple(out_shape)
        self.out_dtype = out_dtype
        self.item_nbytes = int(np.prod(self.out_shape, dtype=np.int64)) * np.dtype(
            out_dtype
        ).itemsize


class RequestRoute:
    """Per-request routing directive for cascade / aggregation serving.

    A routed request rides the normal pipe (WFQ pickup, batching, budget
    admission all bill the submitting tenant) but may deviate at three
    points:

    * ``binding`` — serve this request from a specific compiled plan
      (e.g. a cascade stage's cheap scaled-decode target) instead of the
      tenant's bound plan.  Batches only mix requests on the *same*
      effective binding.
    * ``on_result(uid, output) -> None | (next_item, next_route)`` —
      inspect the device output at dispatch retirement.  Returning a
      ``(item, route)`` pair *refetches*: the request re-enters the same
      tenant's ingress under the SAME uid (so drain order and fairness
      accounting are preserved — the second pass bills the same tenant's
      virtual time) with the new payload/route.  Returning ``None``
      completes normally.
    * ``sink(uid, output, error)`` — consume the completion instead of
      parking it in the drain reorder buffer (aggregation scans retire
      thousands of internal requests no caller will ever drain).  The
      uid is marked drained-ahead so the global drain prefix skips it.

    ``submitted_at`` / ``admitted_nbytes`` are stamped at first submit
    and carried across refetches: end-to-end latency spans every stage,
    and admission retires exactly the bytes it charged.
    """

    __slots__ = ("binding", "on_result", "sink", "stage",
                 "submitted_at", "admitted_nbytes")

    def __init__(
        self,
        binding: _Binding | None = None,
        on_result: Callable[[int, Any], Any] | None = None,
        sink: Callable[[int, Any, BaseException | None], None] | None = None,
        stage: int = 0,
    ):
        self.binding = binding
        self.on_result = on_result
        self.sink = sink
        self.stage = stage
        self.submitted_at: float | None = None
        self.admitted_nbytes: int | None = None


class _TenantState:
    __slots__ = (
        "config",
        "binding",
        "budget",
        "inflight",
        "ingress",
        "ready",
        "vt_ingress",
        "vt_ready",
        "stats",
        "drain_queue",
    )

    def __init__(self, config: TenantConfig, binding: _Binding, budget):
        self.config = config
        self.binding = binding
        self.budget = budget  # tenant-scoped MemoryBudget (or None -> shared)
        self.inflight = 0
        self.ingress: collections.deque = collections.deque()
        self.ready: collections.deque = collections.deque()
        self.vt_ingress = 0.0
        self.vt_ready = 0.0
        self.stats = TenantStats()
        # latency tenants only (max_wait_ms set): uids in submission order,
        # the drain-priority release queue
        self.drain_queue: collections.deque = collections.deque()


class RequestScheduler:
    """Dynamic-batching, weighted-fair executor over compiled plan bindings."""

    _STOP = object()
    _KICK = object()  # wake a blocked replica batcher to re-check the deques

    def __init__(
        self,
        host_fn: Callable[[Any], np.ndarray],
        device_fn: Callable[[Any], Any] | Sequence[Callable[[Any], Any]],
        out_shape: tuple[int, ...],
        out_dtype: Any,
        max_batch: int,
        num_workers: int = 2,
        max_wait_ms: float = 2.0,
        max_pending: int | None = None,
        admission: str = "block",
        admission_timeout_s: float = 30.0,
        budget: MemoryBudget | None = None,
        tenants: Sequence[TenantConfig] | None = None,
        num_replicas: int | None = None,
        replica_labels: Sequence[str] | None = None,
        telemetry: Telemetry | None = None,
        program_sets: Sequence[Any] | None = None,
    ):
        if admission not in ("block", "reject"):
            raise ValueError(f"admission must be 'block' or 'reject', got {admission!r}")
        self.max_batch = max_batch
        self.num_workers = num_workers
        self.max_wait_s = max_wait_ms / 1e3
        # per-tenant pending cap: a tenant without its own max_pending gets
        # this default, and saturation is judged (and raised) per tenant
        self.max_pending = max_pending
        self.admission = admission
        self.admission_timeout_s = admission_timeout_s
        self.budget = budget  # shared/parent byte budget
        self.stats = SchedulerStats()
        # one shared tracing/metrics hub: every stage timestamp below comes
        # from telemetry's clock, and the occupancy windows the
        # recalibrators read (measurement()) are fed by the same
        # observations the latency histograms see
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._worker_ids = itertools.count()  # decode-span worker labels

        self._default_binding = _Binding(
            host_fn, device_fn, out_shape, out_dtype, program_sets=program_sets
        )
        # replica mesh: one dispatcher per replica, all pulling from the
        # shared fair queue.  ``device_fn`` as a sequence gives each replica
        # its own compiled program; a single callable is replicated.
        n = num_replicas if num_replicas is not None else len(
            self._default_binding.device_fns
        )
        if n < 1:
            raise ValueError(f"num_replicas must be >= 1, got {n}")
        if replica_labels is not None:
            labels = [str(x) for x in replica_labels]
            if len(labels) != n:
                raise ValueError(
                    f"{len(labels)} replica_labels for {n} replicas"
                )
        else:
            labels = [f"replica{i}" for i in range(n)]
        self._replicas = [_ReplicaState(i, labels[i]) for i in range(n)]
        self._fail_exc: BaseException | None = None  # set when the mesh is gone
        self._elastic: ElasticPlan | None = None
        self._tenants: dict[str, _TenantState] = {}
        for cfg in tenants or ():
            self._register_tenant(cfg)
        if DEFAULT_TENANT not in self._tenants:
            # the untenanted path: weight-1 tenant admitting against the
            # shared budget directly (no child carve-out)
            self._tenants[DEFAULT_TENANT] = _TenantState(
                TenantConfig(DEFAULT_TENANT), self._default_binding, None
            )

        # ingress: per-tenant deques + one condition (host workers pick by
        # weighted fairness); stops counts pending worker-retire sentinels
        self._ingress_cond = threading.Condition()
        self._ingress_stops = 0
        self._vclock_ingress = 0.0
        # ready: host outputs flow through one queue to the replica
        # batchers, which stash them into per-tenant deques; the deques and
        # the ready virtual clock are shared across batchers (tenant
        # weights span replicas) and guarded by _ready_lock
        self._ready: queue.Queue = queue.Queue()
        self._ready_lock = threading.Lock()
        self._vclock_ready = 0.0
        self._drained_ahead: set[int] = set()  # uids released by drain priority
        self._done: dict[int, CompletedRequest] = {}
        self._done_lock = threading.Lock()
        self._done_event = threading.Event()
        self._rebind_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._next_uid = 0
        self._next_drain = 0
        self._inflight = 0
        # Condition (not a bare lock): admission blocks on it until
        # completions notify pending-count headroom.
        self._inflight_lock = threading.Condition()
        self._idle = threading.Event()
        self._idle.set()
        self._threads: list[threading.Thread] = []
        self._running = False

    # --------------------------------------------------------------- tenants
    def _register_tenant(self, cfg: TenantConfig) -> _TenantState:
        if cfg.name in self._tenants:
            raise ValueError(f"duplicate tenant {cfg.name!r}")
        if self.budget is not None:
            # carve a per-tenant child out of the shared budget: admissions
            # charge tenant AND total, floors are guaranteed, caps default
            # to the weight-proportional share
            tbudget = self.budget.child(
                cfg.name,
                weight=cfg.weight,
                floor_bytes=cfg.floor_bytes,
                max_bytes=cfg.budget_bytes,
            )
        elif cfg.budget_bytes:
            tbudget = MemoryBudget(cfg.budget_bytes, cfg.name)
        else:
            tbudget = None
        state = _TenantState(cfg, self._default_binding, tbudget)
        self._tenants[cfg.name] = state
        return state

    @property
    def tenants(self) -> Mapping[str, TenantStats]:
        """Live per-tenant counters, keyed by tenant name."""
        return {name: s.stats for name, s in self._tenants.items()}

    # the default binding owns the staging signature; expose it rather than
    # duplicating state that rebind() would have to keep in sync
    @property
    def out_shape(self) -> tuple[int, ...]:
        return self._default_binding.out_shape

    @property
    def out_dtype(self):
        return self._default_binding.out_dtype

    def tenant_budget(self, tenant: str = DEFAULT_TENANT) -> MemoryBudget | None:
        state = self._state(tenant)
        return state.budget if state.budget is not None else self.budget

    def _state(self, tenant: str) -> _TenantState:
        try:
            return self._tenants[tenant]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r}; configured: {sorted(self._tenants)}"
            ) from None

    # -------------------------------------------------------------- replicas
    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    @property
    def alive_replicas(self) -> int:
        return sum(1 for r in self._replicas if r.alive)

    @property
    def elastic_plan(self) -> ElasticPlan | None:
        """Mesh sizing after the most recent replica loss (None = intact)."""
        return self._elastic

    def replica_snapshots(self) -> list[ReplicaSnapshot]:
        """Frozen per-replica counters, index order."""
        with self._stats_lock:
            return [r.snapshot() for r in self._replicas]

    def fail_replica(self, index: int) -> None:
        """Fault hook: mark replica ``index`` dead *between* dispatches.

        Its batcher exits at the next loop; a batch it had already formed
        drains back to the shared queue and re-dispatches on survivors.
        (A failure *during* dispatch is modelled by the device_fn raising
        :class:`ReplicaFailure` — e.g. via ``FaultInjector``.)
        """
        replica = self._replicas[index]
        self._note_replica_dead(replica)
        if self.alive_replicas == 0 and self._fail_exc is None:
            self._fail_exc = ReplicaFailure(index, "replica marked failed")
        # wake every batcher: the dead one to exit, survivors to take over
        for _ in self._replicas:
            self._ready.put(self._KICK)

    def _note_replica_dead(self, replica: _ReplicaState) -> None:
        with self._stats_lock:
            if replica.alive:
                replica.alive = False
                self.stats.replica_failures += 1
        survivors = self.alive_replicas
        if survivors:
            self._elastic = plan_elastic_restart(
                alive_chips=survivors,
                model_parallel=1,
                target_global_batch=self.max_batch * len(self._replicas),
                per_replica_batch=self.max_batch,
            )

    # --------------------------------------------------------------- control
    def start(self) -> None:
        if self._running:
            return
        # drop sentinels left over from a previous stop()/failure epoch so
        # fresh batchers don't exit immediately (a clean stop leaves no
        # real messages behind — flush() ran first)
        while True:
            try:
                msg = self._ready.get_nowait()
            except queue.Empty:
                break
            if msg is not self._STOP and msg is not self._KICK:
                self._ready.put(msg)
                break
        self._running = True
        self._threads = [
            threading.Thread(target=self._host_worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        self._threads.extend(
            threading.Thread(target=self._replica_batcher, args=(r,), daemon=True)
            for r in self._replicas
        )
        for t in self._threads:
            t.start()

    def stop(self, timeout: float = 60.0) -> None:
        """Drain in-flight requests (best effort, bounded), then shut down.

        Draining first preserves the complete-or-error contract; a request
        stuck past ``timeout`` is abandoned.
        """
        if not self._running:
            return
        try:
            self.flush(timeout=timeout)
        except TimeoutError:
            pass  # abandon whatever is stuck; shutdown must proceed
        self._running = False
        with self._inflight_lock:
            self._inflight_lock.notify_all()  # wake submitters blocked on admission
        with self._ingress_cond:
            self._ingress_stops += self.num_workers
            self._ingress_cond.notify_all()
        # one stop per batcher thread; batchers that already exited (dead
        # replicas) leave theirs behind, cleaned up by the next start()
        for _ in self._replicas:
            self._ready.put(self._STOP)
        for t in self._threads:
            t.join()
        self._threads = []

    def rebind(
        self,
        host_fn: Callable,
        device_fn: Callable | Sequence[Callable],
        out_shape: tuple[int, ...] | None = None,
        out_dtype: Any = None,
        timeout: float = 60.0,
        program_sets: Sequence[Any] | None = None,
    ) -> None:
        """Swap the *default* binding's stage functions (and signature).

        Drains in-flight requests first so no item preprocessed by the old
        host_fn reaches the new device_fn, and so the batcher can safely
        reallocate its staging buffer when the new placement changes the
        host-stage output shape/dtype.  Tenants pinned to their own binding
        via :meth:`bind_tenant` are unaffected.  ``device_fn`` may again be
        a per-replica sequence (or one program, replicated).
        """
        self.flush(timeout=timeout)
        with self._rebind_lock:
            b = self._default_binding
            b.host_fn = host_fn
            b.device_fns = _as_device_fns(device_fn)
            b.program_sets = tuple(program_sets) if program_sets else ()
            # safe to retarget the budget reservation size: flush() left
            # zero requests admitted under the old footprint
            b.retarget(
                out_shape if out_shape is not None else b.out_shape,
                out_dtype if out_dtype is not None else b.out_dtype,
            )

    def bind_tenant(
        self,
        tenant: str,
        host_fn: Callable,
        device_fn: Callable | Sequence[Callable],
        out_shape: tuple[int, ...],
        out_dtype: Any,
        timeout: float = 60.0,
        program_sets: Sequence[Any] | None = None,
    ) -> None:
        """Pin ``tenant`` to its own compiled plan (model/placement).

        The tenant gets a dedicated binding; its batches only mix with
        tenants bound to the *same* binding object (i.e. nobody, until the
        facade binds two tenants to one shared plan).  Flushes first, like
        :meth:`rebind`.
        """
        state = self._state(tenant)
        if self._running:
            self.flush(timeout=timeout)
        with self._rebind_lock:
            state.binding = _Binding(
                host_fn, device_fn, out_shape, out_dtype, program_sets=program_sets
            )

    def resize_workers(self, num_workers: int) -> None:
        """Retune the host-worker count online (the recalibration knob).

        Growing spawns threads immediately; shrinking posts retire
        sentinels — surplus workers exit before picking up their next item
        (queued work is simply picked up by the survivors).  No-op when the
        count is unchanged or the scheduler is stopped.
        """
        num_workers = max(1, int(num_workers))
        if not self._running or num_workers == self.num_workers:
            self.num_workers = num_workers
            return
        delta = num_workers - self.num_workers
        if delta > 0:
            fresh = [
                threading.Thread(target=self._host_worker, daemon=True) for _ in range(delta)
            ]
            self._threads.extend(fresh)
            for t in fresh:
                t.start()
        else:
            with self._ingress_cond:
                self._ingress_stops += -delta
                self._ingress_cond.notify_all()
            # retiring workers exit asynchronously; drop already-dead
            # threads so the list doesn't grow across repeated resizes
            self._threads = [t for t in self._threads if t.is_alive()]
        self.num_workers = num_workers

    # ---------------------------------------------------------------- submit
    def _admit(self, state: _TenantState, nbytes: int | None = None) -> None:
        """Admission control: bound the tenant's pending requests and
        in-flight bytes.  Saturation is per tenant — one tenant exhausting
        its quota never raises for another.  ``nbytes`` overrides the
        tenant binding's per-item footprint (routed requests stage through
        a different binding's signature)."""
        t0 = time.perf_counter()
        blocked = 0.0
        cfg = state.config
        cap = cfg.max_pending if cfg.max_pending is not None else self.max_pending
        with self._inflight_lock:
            if cap is not None and state.inflight >= cap:
                if self.admission == "reject":
                    self._count_rejected(state)
                    raise SchedulerSaturated(
                        f"tenant {cfg.name!r}: {state.inflight} requests pending "
                        f">= max_pending={cap}"
                    )
                ok = self._inflight_lock.wait_for(
                    lambda: state.inflight < cap or not self._running,
                    self.admission_timeout_s,
                )
                blocked = time.perf_counter() - t0
                if not self._running:
                    raise RuntimeError("scheduler stopped while submit() was blocked")
                if not ok:
                    self._count_rejected(state)
                    raise TimeoutError(
                        f"tenant {cfg.name!r}: submit() blocked > "
                        f"{self.admission_timeout_s}s at max_pending={cap}"
                    )
            state.inflight += 1
            self._inflight += 1
            self._idle.clear()
        budget = state.budget if state.budget is not None else self.budget
        if nbytes is None:
            nbytes = state.binding.item_nbytes
        if budget is not None and nbytes:
            if self.admission == "reject":
                admitted = budget.try_admit(nbytes)
            else:
                # poll in short slices so a stop() during the wait is
                # noticed instead of blocking the full admission timeout
                t1 = time.perf_counter()
                deadline = t1 + self.admission_timeout_s
                admitted = False
                while self._running:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    if budget.admit(nbytes, timeout=min(0.05, remaining)):
                        admitted = True
                        break
                blocked += time.perf_counter() - t1
            if admitted and not self._running:
                # stopped while we were blocked: this request would never run
                budget.release(nbytes)
                admitted = False
            if not admitted:
                with self._inflight_lock:
                    state.inflight -= 1
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._idle.set()
                    self._inflight_lock.notify_all()
                if not self._running:
                    raise RuntimeError("scheduler stopped while submit() was blocked")
                self._count_rejected(state)
                raise SchedulerSaturated(
                    f"tenant {cfg.name!r}: memory budget exhausted "
                    f"({budget.in_flight_bytes}B in flight, request needs {nbytes}B)"
                )
        if blocked:
            with self._stats_lock:
                self.stats.admission_blocked_seconds += blocked
                state.stats.admission_blocked_seconds += blocked

    def _count_rejected(self, state: _TenantState) -> None:
        with self._stats_lock:
            self.stats.rejected += 1
            state.stats.rejected += 1

    def make_binding(
        self,
        host_fn: Callable,
        device_fn: Callable | Sequence[Callable],
        out_shape: tuple[int, ...],
        out_dtype: Any,
        program_sets: Sequence[Any] | None = None,
    ) -> _Binding:
        """Build a standalone binding for routed requests (cascade stages,
        aggregation scans) without binding any tenant to it."""
        return _Binding(
            host_fn, device_fn, out_shape, out_dtype, program_sets=program_sets
        )

    def submit(
        self,
        item: Any,
        tenant: str = DEFAULT_TENANT,
        route: RequestRoute | None = None,
    ) -> int:
        if not self._running:
            raise RuntimeError("scheduler is not running; call start() first")
        if self._fail_exc is not None:
            raise RuntimeError(
                "scheduler mesh has no live replicas"
            ) from self._fail_exc
        state = self._state(tenant)
        if route is not None:
            # stamp the admission footprint once: refetches re-use it, and
            # retirement releases exactly what was charged even when a
            # later stage's binding has a different signature
            if route.admitted_nbytes is None:
                binding = route.binding if route.binding is not None else state.binding
                route.admitted_nbytes = binding.item_nbytes
            self._admit(state, nbytes=route.admitted_nbytes)
        else:
            self._admit(state)
        with self._submit_lock:
            uid = self._next_uid
            self._next_uid += 1
            if state.config.max_wait_ms is not None and (
                route is None or route.sink is None
            ):
                # latency tenant: record the uid for drain priority (its
                # completion may leave the reorder buffer ahead of
                # throughput tenants' backlog).  Sink-routed requests never
                # enter the reorder buffer, so they stay out of the queue.
                state.drain_queue.append(uid)
        with self._stats_lock:
            self.stats.submitted += 1
            state.stats.submitted += 1
        now = time.perf_counter()
        if route is not None and route.submitted_at is None:
            route.submitted_at = now
        with self._ingress_cond:
            if not state.ingress:
                # (re)activation: clamp virtual time to the scheduler clock
                # so an idle tenant can't hoard credit (bounded starvation)
                state.vt_ingress = max(state.vt_ingress, self._vclock_ingress)
            state.ingress.append((uid, item, ReqTimes(now), route))
            self._ingress_cond.notify()
        return uid

    def drain(self, timeout: float | None = None) -> list[CompletedRequest]:
        """Completed requests in submission order, with drain priority.

        Ordering contract: *latency tenants* (``max_wait_ms`` set) release
        in per-tenant submission order as soon as their requests complete —
        never queued behind a throughput tenant's unfinished backlog.
        Everything else releases as the contiguous global uid prefix (uids
        already released early are skipped when the prefix reaches them).

        With ``timeout=None`` returns whatever has finished; with a timeout,
        waits up to that long for at least one newly drainable request.
        """
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            out = []
            with self._done_lock:
                # pass 1 — drain priority: latency tenants' completions go
                # first, in their own submission order
                for s in self._tenants.values():
                    dq = s.drain_queue
                    while dq and dq[0] in self._done:
                        uid = dq.popleft()
                        out.append(self._done.pop(uid))
                        self._drained_ahead.add(uid)
                # pass 2 — the global contiguous prefix
                while True:
                    if self._next_drain in self._drained_ahead:
                        self._drained_ahead.discard(self._next_drain)
                        self._next_drain += 1
                        continue
                    if self._next_drain not in self._done:
                        break
                    req = self._done.pop(self._next_drain)
                    self._next_drain += 1
                    # a latency uid released via the prefix: keep its
                    # tenant's priority queue in sync
                    s = self._tenants.get(req.tenant)
                    if s is not None and s.drain_queue and s.drain_queue[0] == req.uid:
                        s.drain_queue.popleft()
                    out.append(req)
                self._done_event.clear()
            if out:
                # the drain span: device completion -> reorder-buffer release
                t_rel = time.perf_counter()
                for req in out:
                    if req.error is None:
                        self.telemetry.observe_drain(
                            req.tenant, req.uid, req.completed_at, t_rel
                        )
            if out or deadline is None:
                return out
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return []
            self._done_event.wait(remaining)

    def flush(self, timeout: float = 60.0) -> None:
        """Block until every submitted request has completed."""
        if not self._idle.wait(timeout):
            raise TimeoutError(f"scheduler did not drain within {timeout}s")

    # --------------------------------------------------------------- threads
    def _next_ingress(self):
        """Weighted-fair pickup: serve the backlogged tenant with the
        smallest ingress virtual time.  Returns None on a retire sentinel."""
        with self._ingress_cond:
            while True:
                if self._ingress_stops > 0:
                    self._ingress_stops -= 1
                    return None
                active = [s for s in self._tenants.values() if s.ingress]
                if active:
                    break
                self._ingress_cond.wait()
            state = min(active, key=lambda s: s.vt_ingress)
            state.vt_ingress += 1.0 / state.config.weight
            self._vclock_ingress = state.vt_ingress
            uid, item, tm, route = state.ingress.popleft()
            tm.pick = time.perf_counter()  # queue span ends: WFQ pickup
            return state, uid, item, tm, route

    def _host_worker(self) -> None:
        wid = next(self._worker_ids)  # labels this thread's decode spans
        while True:
            msg = self._next_ingress()
            if msg is None:
                return
            state, uid, item, tm, route = msg
            with self._rebind_lock:  # pin the current stage fn, call outside
                if route is not None and route.binding is not None:
                    host_fn = route.binding.host_fn
                else:
                    host_fn = state.binding.host_fn
            # tag this worker thread so the rendition cache (consulted
            # inside cache-aware host_fns) attributes hits/misses to the
            # tenant whose request is being staged
            set_current_tenant(state.config.name)
            t_in = time.perf_counter()
            try:
                arr = host_fn(item)
            except BaseException as e:  # noqa: BLE001 — delivered via drain()
                self._complete_error(state, uid, tm, e, route)
                continue
            dt = time.perf_counter() - t_in
            tm.decoded = time.perf_counter()
            tm.worker = wid
            self.telemetry.observe_host(state.config.name, dt)
            with self._stats_lock:
                self.stats.host_busy_seconds += dt
                self.stats.host_items += 1
                state.stats.host_busy_seconds += dt
                state.stats.host_items += 1
            self._ready.put((state, uid, arr, tm, route))

    # Batcher internals.  The per-tenant `ready` deques and the `vt_ready`
    # clocks are shared by every replica batcher (so tenant weights span
    # the mesh) — all access goes through _ready_lock.  _stash acquires it
    # itself; _pick_ready must be called with it held.
    def _stash(self, msg) -> None:
        state, uid, arr, tm, route = msg
        with self._ready_lock:
            if not state.ready:
                state.vt_ready = max(state.vt_ready, self._vclock_ready)
            state.ready.append((uid, arr, tm, route))

    @staticmethod
    def _entry_binding(state: _TenantState, entry: tuple) -> _Binding:
        """Effective binding of one ready-deque entry: its route override
        (cascade stage / aggregation scan target) or the tenant's plan."""
        route = entry[3]
        if route is not None and route.binding is not None:
            return route.binding
        return state.binding

    def _pick_ready(self, candidates: list[_TenantState]) -> _TenantState:
        state = min(candidates, key=lambda s: s.vt_ready)
        state.vt_ready += 1.0 / state.config.weight
        self._vclock_ready = state.vt_ready
        return state

    def _replica_batcher(self, replica: _ReplicaState) -> None:
        bufs: dict[int, np.ndarray] = {}  # id(binding) -> staging buffer
        while True:
            if not replica.alive:
                if self.alive_replicas:
                    return  # survivors keep serving the shared queue
                # last replica down: degrade to completing requests with
                # the failure instead of hanging submitters/flush()
                if self._fail_exc is None:
                    self._fail_exc = ReplicaFailure(
                        replica.index, "replica marked failed"
                    )
                self._error_pump()
                return
            # drain queued host outputs first, so the fairness pick sees
            # every backlogged tenant rather than arrival order
            if not self._drain_ready_nowait():
                self._drain_pending(bufs, replica)
                return
            with self._ready_lock:
                backlog = any(s.ready for s in self._tenants.values())
            if backlog:
                if not self._form_batch(bufs, replica, wait=True):
                    return
                continue
            msg = self._ready.get()
            if msg is self._STOP:
                self._drain_pending(bufs, replica)
                return
            if msg is self._KICK:
                continue
            self._stash(msg)

    def _drain_ready_nowait(self) -> bool:
        """Move queued host outputs into tenant deques; False on STOP."""
        while True:
            try:
                msg = self._ready.get_nowait()
            except queue.Empty:
                return True
            if msg is self._STOP:
                return False
            if msg is self._KICK:
                continue
            self._stash(msg)

    def _tenant_wait_s(self, state: _TenantState) -> float:
        """One tenant's dynamic-batching deadline: its ``max_wait_ms``
        override, or the scheduler-wide default."""
        cfg = state.config
        return cfg.max_wait_ms / 1e3 if cfg.max_wait_ms is not None else self.max_wait_s

    def _form_batch(self, bufs: dict, replica: _ReplicaState, wait: bool) -> bool:
        """Form and dispatch ONE batch by weighted-fair pick.  Returns False
        when a stop sentinel was consumed (caller must exit)."""
        with self._ready_lock:
            active = [s for s in self._tenants.values() if s.ready]
            if not active:
                return True
            first = self._pick_ready(active)
            binding = self._entry_binding(first, first.ready[0])
            head = first.ready.popleft()
        with self._rebind_lock:  # signature may change across rebinds
            shape, dtype = (self.max_batch, *binding.out_shape), binding.out_dtype
        buf = bufs.get(id(binding))
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = np.zeros(shape, dtype=dtype)
            bufs[id(binding)] = buf
        metas: list[tuple[int, ReqTimes, _TenantState, Any]] = []
        self._stage(buf, metas, first, head)
        # the batch deadline is the tightest max_wait of any tenant with a
        # slot in it: a latency tenant's presence closes the batch early,
        # and joining members can only pull the deadline in, never push it
        t_open = time.perf_counter()
        deadline = t_open + self._tenant_wait_s(first)
        while len(metas) < self.max_batch:
            if not replica.alive:
                break  # dispatch path drains the partial batch back
            # only tenants whose head-of-line request targets this batch's
            # compiled plan may join it (routed requests carry their own)
            with self._ready_lock:
                cands = [
                    s for s in self._tenants.values()
                    if s.ready and self._entry_binding(s, s.ready[0]) is binding
                ]
                if cands:
                    state = self._pick_ready(cands)
                    item = state.ready.popleft()
                else:
                    state = None
            if state is not None:
                self._stage(buf, metas, state, item)
                deadline = min(deadline, t_open + self._tenant_wait_s(state))
                continue
            if not wait:
                break
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                msg = self._ready.get(timeout=remaining)
            except queue.Empty:
                break
            if msg is self._STOP:
                self._dispatch(binding, buf, metas, replica, t_open)
                self._drain_pending(bufs, replica)
                return False
            if msg is self._KICK:
                continue
            self._stash(msg)
        if len(self._replicas) > 1:
            # about to block on the device: if backlog remains, kick a
            # sibling batcher so batches overlap across replicas
            with self._ready_lock:
                leftover = any(s.ready for s in self._tenants.values())
            if leftover:
                self._ready.put(self._KICK)
        self._dispatch(binding, buf, metas, replica, t_open)
        return True

    def _drain_pending(self, bufs: dict, replica: _ReplicaState) -> None:
        """Dispatch whatever is still staged in tenant deques (stop path).
        A dead replica leaves the deques alone — survivors (or the error
        pump) own them."""
        def backlog() -> bool:
            with self._ready_lock:
                return any(s.ready for s in self._tenants.values())

        while replica.alive and backlog():
            self._form_batch(bufs, replica, wait=False)

    def _stage(self, buf: np.ndarray, metas: list, state: _TenantState, msg: tuple) -> bool:
        """Copy one host output into the staging buffer; errors (e.g. an
        item preprocessed under a pre-rebind signature) fail that request
        instead of killing the batcher."""
        uid, arr, tm, route = msg
        try:
            buf[len(metas)] = arr
        except (ValueError, TypeError) as e:
            self._complete_error(state, uid, tm, e, route)
            return False
        tm.staged = time.perf_counter()  # stage span ends: copied into batch
        # keep arr: a replica failure drains the item back to the queue
        metas.append((uid, tm, state, arr, route))
        return True

    def _requeue(self, metas: list) -> None:
        """Drain a failed replica's staged items back to the *front* of
        their tenants' ready deques (uid order preserved) for re-dispatch
        on survivors."""
        with self._ready_lock:
            for uid, tm, state, arr, route in reversed(metas):
                if not state.ready:
                    state.vt_ready = max(state.vt_ready, self._vclock_ready)
                state.ready.appendleft((uid, arr, tm, route))

    def _on_replica_failure(
        self, replica: _ReplicaState, metas: list, exc: ReplicaFailure
    ) -> None:
        """A dispatch hit a dead replica: take it out of the mesh and either
        re-dispatch its batch on survivors or (mesh gone) fail the batch."""
        self._note_replica_dead(replica)
        with self._stats_lock:
            replica.dispatch_errors += 1
        if self.alive_replicas:
            if metas:
                self._requeue(metas)
                with self._stats_lock:
                    replica.redispatched_items += len(metas)
                    self.stats.redispatched_items += len(metas)
            # wake survivors to pick up the drained items; the caller's
            # batcher loop sees the dead replica and exits
            for _ in range(self.alive_replicas):
                self._ready.put(self._KICK)
            return
        # no survivors: complete the batch with the failure and flip the
        # scheduler into error-pump mode (loop top picks it up)
        self._fail_exc = exc
        for uid, tm, state, _arr, route in metas:
            self._complete_error(state, uid, tm, exc, route)

    def _error_pump(self) -> None:
        """All replicas are dead: complete everything still flowing through
        the pipe with the mesh failure, until stop().  Keeps flush()/drain()
        honest instead of hanging."""
        exc = self._fail_exc
        while True:
            with self._ready_lock:
                stranded = []
                for s in self._tenants.values():
                    while s.ready:
                        stranded.append((s, s.ready.popleft()))
            for state, (uid, arr, tm, route) in stranded:
                self._complete_error(state, uid, tm, exc, route)
            msg = self._ready.get()
            if msg is self._STOP:
                return
            if msg is self._KICK:
                continue
            state, uid, arr, tm, route = msg
            self._complete_error(state, uid, tm, exc, route)

    def _dispatch(
        self,
        binding: _Binding,
        buf: np.ndarray,
        metas: list,
        replica: _ReplicaState,
        t_open: float | None = None,
    ) -> None:
        if not metas:
            return
        if self._fail_exc is not None:
            for uid, tm, state, _arr, route in metas:
                self._complete_error(state, uid, tm, self._fail_exc, route)
            return
        if not replica.alive:
            # marked dead between forming and dispatching (fail_replica):
            # drain the batch back instead of running it on a dead replica
            self._on_replica_failure(
                replica, metas, ReplicaFailure(replica.index, "replica marked failed")
            )
            return
        t_in = time.perf_counter()
        with self._rebind_lock:
            device_fn, bucket = binding.dispatch_fn_for(replica.index, len(metas))
        try:
            # ragged batch + program set: slice to the smallest warm
            # bucket covering the batch; unbucketed dispatch runs the full
            # max_batch buffer.  Either way padding lanes stop here — the
            # completion loop below reads only rows < len(metas).  A mesh
            # program's readback runs in its target's scope: on its stream,
            # behind its work, and apart from the other replicas'.
            with dispatch_scope(device_fn):
                out = _to_host(device_fn(buf if bucket is None else buf[:bucket]))
        except ReplicaFailure as e:
            self._on_replica_failure(replica, metas, e)
            return
        except BaseException as e:  # noqa: BLE001 — delivered via drain()
            for uid, tm, state, _arr, route in metas:
                self._complete_error(state, uid, tm, e, route)
            return
        dt = time.perf_counter() - t_in
        now = time.perf_counter()
        per_tenant = collections.Counter(state.config.name for _, _, state, _, _ in metas)
        states = {state.config.name: state for _, _, state, _, _ in metas}
        tel = self.telemetry
        tel.observe_device_batch(dt, per_tenant)
        # Route the batch's rows.  An on_result directive returning
        # (next_item, next_route) *refetches*: the request re-enters the
        # same tenant's ingress under the SAME uid (second pass bills the
        # same tenant's virtual time; the drain prefix waits, preserving
        # uid order).  Everything else finishes — into the reorder buffer,
        # or a route's sink.
        refetch: list = []  # (state, uid, tm, route, (next_item, next_route))
        finish: list = []  # (row, uid, tm, state, route)
        errors: list = []  # (uid, tm, state, route, exc)
        for row, (uid, tm, state, _arr, route) in enumerate(metas):
            tm.done = now
            if route is not None and route.on_result is not None:
                try:
                    nxt = route.on_result(uid, out[row])
                except BaseException as e:  # noqa: BLE001 — delivered via drain()
                    errors.append((uid, tm, state, route, e))
                    continue
                if nxt is not None:
                    refetch.append((state, uid, tm, route, nxt))
                    continue
            finish.append((row, uid, tm, state, route))
        # only finishing requests land in the latency histograms: a
        # refetched item's end-to-end span covers every stage, recorded
        # when its final pass retires
        for _row, uid, tm, state, _route in finish:
            tel.complete_request(state.config.name, uid, tm, replica=replica.index)
        if tel.config.spans:
            # batch span: open -> device done, linking member request spans;
            # dispatch #1 of an uncaptured program is the cold start (it
            # builds the kernels and pays the first launches)
            tel.emit_span(
                "batch",
                "batch",
                None,
                tel.next_batch_id(),
                t_open if t_open is not None else t_in,
                now,
                replica=replica.index,
                size=len(metas),
                bucket=bucket,
                uids=[m[0] for m in metas],
                cold=getattr(device_fn, "dispatch_count", 0) == 1,
                compile_s=getattr(device_fn, "first_dispatch_seconds", None),
            )
            for state, uid, tm, route, _nxt in refetch:
                # the cheap-stage pass this item just finished before its
                # full-resolution resubmission
                tel.emit_span(
                    "refetch",
                    f"stage{route.stage}",
                    state.config.name,
                    uid,
                    tm.submit,
                    now,
                    stage=route.stage,
                )
        with self._stats_lock:
            self.stats.device_busy_seconds += dt
            self.stats.batches += 1
            self.stats.batch_items += len(metas)
            self.stats.completed += len(finish)
            self.stats.refetched_items += len(refetch)
            replica.batches += 1
            replica.items += len(metas)
            for name, n in per_tenant.items():
                ts = states[name].stats
                # attribute the batch's device occupancy to tenants in
                # proportion to the slots they filled
                ts.device_busy_seconds += dt * n / len(metas)
                ts.batch_items += n
            for _row, _uid, _tm, state, _route in finish:
                state.stats.completed += 1
            for state, _uid, _tm, _route, _nxt in refetch:
                state.stats.refetched += 1
        sink_calls: list = []
        retire_group: collections.Counter = collections.Counter()
        with self._done_lock:
            woke = False
            for row, uid, tm, state, route in finish:
                if route is not None and route.sink is not None:
                    # consumed out-of-band: mark drained-ahead so the
                    # global uid prefix skips it
                    self._drained_ahead.add(uid)
                    sink_calls.append((route, uid, out[row]))
                    continue
                t_submit = (
                    route.submitted_at
                    if route is not None and route.submitted_at is not None
                    else tm.submit
                )
                self._done[uid] = CompletedRequest(
                    uid, out[row], t_submit, now, tenant=state.config.name
                )
                woke = True
            if woke or sink_calls:
                self._done_event.set()
        for route, uid, val in sink_calls:
            route.sink(uid, val, None)
        for _row, _uid, _tm, state, route in finish:
            if route is not None:
                self._retire_admissions(state, 1, nbytes=route.admitted_nbytes)
            else:
                retire_group[state.config.name] += 1
        for name, n in retire_group.items():
            self._retire_admissions(states[name], n)
        for uid, tm, state, route, exc in errors:
            self._complete_error(state, uid, tm, exc, route)
        if refetch:
            t_re = time.perf_counter()
            with self._ingress_cond:
                for state, uid, _tm, route, (next_item, next_route) in refetch:
                    if next_route is None:
                        next_route = RequestRoute()
                    # carry the original admission footprint and submit
                    # time across the refetch
                    next_route.submitted_at = route.submitted_at
                    next_route.admitted_nbytes = route.admitted_nbytes
                    if not state.ingress:
                        state.vt_ingress = max(state.vt_ingress, self._vclock_ingress)
                    state.ingress.append((uid, next_item, ReqTimes(t_re), next_route))
                self._ingress_cond.notify_all()

    def _complete_error(
        self,
        state: _TenantState,
        uid: int,
        tm: ReqTimes,
        exc: BaseException,
        route: RequestRoute | None = None,
    ) -> None:
        # failed requests stay out of the latency histograms: an error
        # short-circuits the pipeline, so its timeline isn't a latency
        now = time.perf_counter()
        with self._stats_lock:
            self.stats.failed += 1
            state.stats.failed += 1
        if route is not None and route.sink is not None:
            with self._done_lock:
                self._drained_ahead.add(uid)
                self._done_event.set()
            route.sink(uid, None, exc)
        else:
            t_submit = (
                route.submitted_at
                if route is not None and route.submitted_at is not None
                else tm.submit
            )
            with self._done_lock:
                self._done[uid] = CompletedRequest(
                    uid, None, t_submit, now, error=exc, tenant=state.config.name
                )
                self._done_event.set()
        self._retire_admissions(
            state, 1, nbytes=route.admitted_nbytes if route is not None else None
        )

    def _retire_admissions(
        self, state: _TenantState, count: int, nbytes: int | None = None
    ) -> None:
        """Return ``count`` completed requests' admission: the tenant's
        pending slots and budget bytes (waking any blocked submitters).
        ``nbytes`` overrides the per-item footprint for routed requests."""
        budget = state.budget if state.budget is not None else self.budget
        if nbytes is None:
            nbytes = state.binding.item_nbytes
        if budget is not None and nbytes:
            for _ in range(count):
                budget.release(nbytes)
        with self._inflight_lock:
            state.inflight -= count
            self._inflight -= count
            if self._inflight == 0:
                self._idle.set()
            self._inflight_lock.notify_all()

    def measurement(self, tenant: str | None = None):
        """Stage occupancy per item *since the previous call* (windowed, for
        the recalibrator) — scheduler-wide, or for one tenant.

        Host time is normalized by items that went through the host stage
        and device time by items that went through a device batch — dividing
        both by completions would inflate the host figure whenever requests
        are still in flight.  Lifetime averages would bury a recent
        throughput shift under old history, so each call consumes the window
        since the last one.  The windows come from the telemetry occupancy
        accumulators — the recalibrators read the same measured stage times
        the latency histograms are built from.
        """
        from repro_torch.runtime.recalibration import StageMeasurement

        if tenant is not None:
            self._state(tenant)  # keep the unknown-tenant KeyError contract
        host_busy, host_items, dev_busy, dev_items = self.telemetry.measurement_window(
            ("scheduler", id(self)), tenant
        )
        return StageMeasurement(
            host_seconds_per_item=host_busy / max(1, host_items),
            device_seconds_per_item=dev_busy / max(1, dev_items),
        )
