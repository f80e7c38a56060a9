"""Fault tolerance: preemption handling, straggler mitigation, retries,
elastic restart.

Every mechanism is per-host local state, so no coordinator is assumed.
The serving scheduler uses :class:`ReplicaFailure` and
:func:`plan_elastic_restart`; the rest is copied from the reference with
its imports rewritten.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Callable

log = logging.getLogger("repro_torch.ft")


class PreemptionHandler:
    """Converts SIGTERM/SIGINT (cloud preemption notices) into a flag the
    train loop polls; the loop then checkpoints and exits cleanly.

    Usage:
        ph = PreemptionHandler(install=True)
        for step in ...:
            ...
            if ph.should_stop:
                checkpoint.save(...); break
    """

    def __init__(self, install: bool = False, signals=(signal.SIGTERM,)):
        self._stop = False
        self._signals = signals
        if install:
            self.install()

    def install(self):
        for sig in self._signals:
            signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; requesting clean stop", signum)
        self._stop = True

    def request_stop(self):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop


class ReplicaFailure(RuntimeError):
    """A serving replica died (device lost, injected fault, OOM).

    Raised by (or on behalf of) a replica's device dispatch.  The request
    scheduler treats it differently from an ordinary per-request error:
    instead of failing the batch, the in-flight items drain back to the
    shared fair queue and re-dispatch onto surviving replicas, and the
    failed replica leaves the mesh (``plan_elastic_restart`` sizes what
    remains).
    """

    def __init__(self, replica: int, reason: str = "replica failed"):
        super().__init__(f"replica {replica}: {reason}")
        self.replica = replica
        self.reason = reason


class FaultInjector:
    """Test/chaos hook: arms failures that replicas observe at dispatch.

    ``arm(replica)`` makes the next dispatch attempt on that replica raise
    :class:`ReplicaFailure` (the scheduler also exposes ``fail_replica``,
    which marks a replica dead *between* dispatches).  Thread-safe; the
    serving fault-injection tests and chaos drills drive this.
    """

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._armed: set[int] = set()

    def arm(self, replica: int) -> None:
        with self._lock:
            self._armed.add(replica)

    def check(self, replica: int) -> None:
        """Raise ReplicaFailure if a fault is armed for ``replica``."""
        with self._lock:
            armed = replica in self._armed
            self._armed.discard(replica)
        if armed:
            raise ReplicaFailure(replica, "injected fault")


@dataclasses.dataclass
class StragglerStats:
    step: int
    duration: float
    median: float
    is_straggler: bool


class StragglerMonitor:
    """Per-step deadline monitoring.

    At pod scale stragglers show up as step-time outliers (a slow host
    drags every synchronous collective).  The monitor keeps a rolling
    median and flags steps exceeding ``threshold`` x median.  The caller's
    policy hooks then kick in — our train loop's policy: (1) log + count;
    (2) after ``escalate_after`` consecutive stragglers, advise the caller
    to checkpoint and trigger elastic restart without the slow host.
    """

    def __init__(self, threshold: float = 2.0, window: int = 50, escalate_after: int = 5):
        self.threshold = threshold
        self.window = window
        self.escalate_after = escalate_after
        self._durations: list[float] = []
        self._consecutive = 0
        self.flagged: list[StragglerStats] = []

    def observe(self, step: int, duration: float) -> StragglerStats:
        hist = self._durations[-self.window :]
        median = sorted(hist)[len(hist) // 2] if hist else duration
        is_straggler = len(hist) >= 5 and duration > self.threshold * median
        self._durations.append(duration)
        stat = StragglerStats(step, duration, median, is_straggler)
        if is_straggler:
            self._consecutive += 1
            self.flagged.append(stat)
            log.warning("step %d straggled: %.3fs vs median %.3fs", step, duration, median)
        else:
            self._consecutive = 0
        return stat

    @property
    def should_escalate(self) -> bool:
        return self._consecutive >= self.escalate_after


def with_retries(
    fn: Callable,
    max_attempts: int = 3,
    backoff: float = 0.5,
    retriable: tuple[type[BaseException], ...] = (RuntimeError, OSError),
):
    """Retry transient failures (flaky interconnect, storage hiccups) with
    exponential backoff.  Non-retriable exceptions propagate immediately."""

    def wrapped(*args, **kwargs):
        delay = backoff
        for attempt in range(1, max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except retriable as e:
                if attempt == max_attempts:
                    raise
                log.warning("attempt %d/%d failed (%s); retrying in %.1fs",
                            attempt, max_attempts, e, delay)
                time.sleep(delay)
                delay *= 2

    return wrapped


@dataclasses.dataclass
class ElasticPlan:
    """Recovery plan after losing hosts: the largest mesh we can rebuild
    and how the global batch maps onto it."""

    data_parallel: int
    model_parallel: int
    pods: int
    global_batch: int
    grad_accum: int  # microbatching keeps the global batch constant


def plan_elastic_restart(
    alive_chips: int,
    model_parallel: int,
    target_global_batch: int,
    per_replica_batch: int,
    chips_per_pod: int = 256,
) -> ElasticPlan:
    """Choose the largest viable (pod, data, model) mesh from surviving
    chips, keeping the optimizer-visible global batch fixed by raising
    gradient accumulation (so the training trajectory is preserved)."""
    if alive_chips < model_parallel:
        raise ValueError(f"{alive_chips} chips cannot host model_parallel={model_parallel}")
    replicas = alive_chips // model_parallel
    # Prefer whole pods for the leading axis.
    pods = max(1, (replicas * model_parallel) // chips_per_pod)
    data = replicas // pods if pods > 1 else replicas
    capacity = pods * data * per_replica_batch
    accum = max(1, -(-target_global_batch // capacity))
    return ElasticPlan(
        data_parallel=data,
        model_parallel=model_parallel,
        pods=pods,
        global_batch=target_global_batch,
        grad_accum=accum,
    )
