"""Vision request serving, routed through the SMOL query runtime.

Before this module, vision serving meant hand-wiring decode → preprocess →
model per deployment.  Now every vision request goes through
:class:`repro_torch.runtime.SmolRuntime`: the planner picks the (model, format)
plan, the placement optimizer splits preprocessing across host/device, the
device preprocessing compiler lowers the device half + DNN into one fused
program (``RuntimeConfig.device.backend``), the request scheduler
dynamically batches — across every replica of the device mesh
(``RuntimeConfig.mesh``) — and the recalibration loop keeps the split
(and the host worker count) matched to observed stage occupancy while the
server runs.

Resource governance comes from the runtime's memory subsystem
(``RuntimeConfig.memory``): with ``max_pending`` / ``budget_bytes`` set,
an overloaded server backpressures or sheds load at :meth:`submit` —
``admission='reject'`` surfaces as :class:`repro_torch.runtime.SchedulerSaturated`
to the caller, which is the signal to return HTTP 429 upstream.

The serving layer is **multi-tenant**: declare
:class:`~repro_torch.runtime.TenantConfig`\\ s on ``RuntimeConfig.tenants`` and
pass ``tenant=`` to :meth:`submit`.  Tenants get weighted-fair service
(a weight-4 tenant receives 4× a weight-1 tenant's throughput under
saturation), per-tenant admission quotas (saturation raises for the
bursting tenant only), per-tenant byte budgets carved from the global
one, and — when a tenant pins its own ``model`` — a dedicated compiled
plan with its own recalibrated host/device split.
:meth:`VisionServingEngine.stats` exposes pool/budget/queue occupancy,
per-tenant counters, and program-cache hit/eviction rates for dashboards.

Cold starts are controlled by ``RuntimeConfig.warmup``: ``"full"`` warms
the whole bucketed program set (every power-of-two batch size; on a CUDA
device each bucket is captured as one CUDA graph) inside
:meth:`VisionServingEngine.start`, so the first real request is served by
an already-warm program —
:attr:`programs_compiled_post_warmup` staying at 0 is the steady-state
invariant dashboards should alert on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.planner import ModelSpec
from repro_torch.preprocessing.formats import ImageFormat, StoredImage
from repro_torch.runtime import DEFAULT_TENANT, CompletedRequest, RuntimeConfig, SmolRuntime
from repro_torch.runtime.query import AggregationQueryResult, Query, QueryResult


@dataclasses.dataclass
class VisionResponse:
    uid: int
    prediction: int  # -1 when the request failed
    scores: np.ndarray
    latency: float
    error: BaseException | None = None
    tenant: str = DEFAULT_TENANT


class VisionServingEngine:
    """Request-level vision inference server on top of SmolRuntime.

    ``recalibrate_every`` requests, the engine feeds the scheduler's
    measured stage occupancy back into the runtime, which may move the
    host/device split and atomically rebind the stage functions.
    """

    def __init__(
        self,
        models: Sequence[ModelSpec],
        formats: Sequence[ImageFormat],
        model_fns: Mapping[str, Callable],
        calibration: Sequence[StoredImage],
        config: RuntimeConfig | None = None,
        recalibrate_every: int = 0,
        decode_time: Callable[[ImageFormat], float] | None = None,
        device: str | torch.device | None = "cuda",
    ):
        self.runtime = SmolRuntime(
            models, formats, model_fns, calibration, config=config, decode_time=decode_time,
            device=device,
        )
        self.recalibrate_every = recalibrate_every
        self._since_recal = 0
        self._started = False

    # --------------------------------------------------------------- control
    def start(self) -> None:
        self.runtime.start_serving()
        self._started = True

    def stop(self) -> None:
        self.runtime.stop_serving()
        self._started = False

    def __enter__(self) -> "VisionServingEngine":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- serving
    def submit(
        self,
        image: StoredImage | np.ndarray | Query,
        tenant: str = DEFAULT_TENANT,
    ) -> int | AggregationQueryResult:
        """Submit one request — a bare image (legacy, deprecated) or a
        typed query (:class:`~repro_torch.runtime.ClassificationQuery` /
        ``CascadeQuery`` / ``AggregationQuery``).  Aggregation queries run
        synchronously and return their result directly; everything else
        returns the uid and resolves through :meth:`drain`."""
        if not self._started:
            raise RuntimeError("start() the engine before submitting requests")
        out = self.runtime.submit(image, tenant=tenant)
        self._since_recal += 1
        if self.recalibrate_every and self._since_recal >= self.recalibrate_every:
            self._since_recal = 0
            # model-pinned tenants recalibrate their own split from their
            # own measurement window; everyone else moves the shared one
            self.runtime.serving_recalibrate(tenant if tenant != DEFAULT_TENANT else None)
        return out

    def drain(self, timeout: float | None = None) -> list[VisionResponse | QueryResult]:
        """Completed requests: typed queries come back as their
        :class:`~repro_torch.runtime.QueryResult` subclass, legacy bare-image
        submissions as :class:`VisionResponse`."""
        out: list[VisionResponse | QueryResult] = []
        for r in self.runtime.drain(timeout=timeout):
            out.append(r if isinstance(r, QueryResult) else self._to_response(r))
        return out

    def serve_batch(
        self,
        images: Sequence[StoredImage | np.ndarray],
        tenant: str = DEFAULT_TENANT,
    ) -> list[VisionResponse]:
        """Convenience: submit all, wait, return responses in request order."""
        for img in images:
            self.submit(img, tenant=tenant)
        self.runtime.flush()
        return self.drain()

    @property
    def plan_key(self) -> str:
        return self.runtime.plan().key

    @property
    def split(self) -> int:
        return self.runtime.compile().placement.split

    @property
    def num_workers(self) -> int:
        """Live host worker count (moves under worker recalibration)."""
        return self.runtime.num_workers

    @property
    def device_backend(self) -> str:
        """'fused' (device preprocessing compiler) or 'reference'."""
        return self.runtime.config.device.backend

    @property
    def device_program(self):
        """The compiled device program serving this engine (preproc + DNN,
        one dispatch per batch); None before the plan is compiled."""
        compiled = self.runtime.compile()
        return compiled.device_program

    @property
    def split_decode(self):
        """The split-decode placement actually serving
        (:class:`~repro_torch.runtime.SplitDecodeSection`): policy, chosen
        scaled-IDCT factor (0 = pixel-path fallback) and staging layout;
        None when the policy is off."""
        self.runtime.compile()
        return self.runtime.stats().split_decode

    @property
    def split_decode_factor(self) -> int:
        """Chosen scaled-IDCT resolution divisor (0 = pixel path/off)."""
        info = self.split_decode
        return info.factor if info is not None else 0

    @property
    def warmup(self) -> str:
        """The configured warmup mode: ``off`` | ``lazy`` | ``full``."""
        return self.runtime.config.warmup

    @property
    def programs_compiled_post_warmup(self) -> int:
        """Device programs that paid their cold start on the request path after
        :meth:`start` finished — 0 under ``warmup='full'`` in steady state
        (the cold-start alarm counter; also exported by ``metrics_text``)."""
        return self.runtime.programs_compiled_post_warmup

    @property
    def replicas(self):
        """Per-replica dispatch counters
        (:class:`~repro_torch.runtime.ReplicaSnapshot` tuple; empty before
        serving starts)."""
        mesh = self.runtime.stats().mesh
        return mesh.replicas if mesh is not None else ()

    def fail_replica(self, index: int) -> None:
        """Chaos/ops hook of the replica mesh (not ported: raises
        :class:`NotImplementedError`)."""
        self.runtime.fail_replica(index)

    def stats(self):
        """Versioned runtime snapshot
        (:class:`~repro_torch.runtime.RuntimeStats`): memory/threading occupancy,
        per-tenant counters, the replica mesh, program-cache rates, and the
        ``latency`` section (per-stage/per-tenant p50/p95/p99)."""
        return self.runtime.stats()

    # ----------------------------------------------------------- telemetry
    @property
    def latency(self):
        """Per-stage / per-tenant latency digests
        (:class:`~repro_torch.runtime.LatencySection`) — the streaming-histogram
        p50/p95/p99 surface, without building the full stats snapshot."""
        return self.runtime.stats().latency

    def dump_trace(self, path: str) -> int:
        """Write the captured request/batch span timeline as Chrome
        trace-event JSON (open in Perfetto).  Needs
        ``RuntimeConfig.telemetry.spans=True``; returns spans written."""
        return self.runtime.dump_trace(path)

    def metrics_text(self) -> str:
        """Prometheus text exposition (latency histograms + request and
        program-cache counters) — serve this from ``/metrics``."""
        return self.runtime.metrics_text()

    @staticmethod
    def _to_response(r: CompletedRequest) -> VisionResponse:
        # Raising here would discard the other requests runtime.drain()
        # already released from the reorder buffer, so failures travel as
        # data: callers check response.error.
        if r.error is not None:
            return VisionResponse(
                r.uid, -1, np.empty(0), r.latency, error=r.error, tenant=r.tenant
            )
        scores = np.asarray(r.output)
        pred = int(np.argmax(scores)) if scores.ndim else int(scores)
        return VisionResponse(r.uid, pred, scores, r.latency, tenant=r.tenant)
