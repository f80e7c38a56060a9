"""Typed query objects for the SMOL runtime (paper §3.2 query classes).

The runtime serves three query classes behind a single ``submit(query)``
entry point:

- :class:`ClassificationQuery` — one image through the tenant's plan
  target (the pre-PR-9 ``submit(image)`` behaviour, now typed).
- :class:`CascadeQuery` — Tahoma-style cascade: stage 1 scores the image
  from the *cheap* rendition (scaled split decode); if the max-softmax
  confidence clears the stage threshold the item exits, otherwise the
  scheduler internally refetches the full-resolution rendition for the
  expensive stage.
- :class:`AggregationQuery` — BlazeIt-style aggregate: the specialized
  s(x) full scan rides the cheapest rendition over the whole corpus and
  ``control_variate_aggregate`` drives sampled target-model refetches
  until the CI half-width drops below ``eps``.

Results come back as :class:`QueryResult` subclasses carrying the fields
each query class actually produces (prediction + exit stage for
cascades; estimate + CI + invocation counts for aggregation).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Query:
    """Base class for typed runtime queries."""


@dataclasses.dataclass(frozen=True)
class ClassificationQuery(Query):
    """Classify one stored image through the tenant's plan target."""

    image: Any


@dataclasses.dataclass(frozen=True)
class CascadeStageSpec:
    """One cascade stage: exit when max-softmax confidence >= threshold.

    ``model`` optionally names a model from the runtime's model set for
    this stage; ``None`` uses the tenant's plan model.  The final stage's
    threshold is ignored — every surviving item exits there.
    """

    threshold: float = 1.0
    model: str | None = None

    def __post_init__(self) -> None:
        if not 0.0 <= self.threshold <= 1.0:
            raise ValueError(f"threshold must be in [0, 1], got {self.threshold}")


@dataclasses.dataclass(frozen=True)
class CascadeQuery(Query):
    """Cascaded classification with progressive rendition refetch."""

    image: Any
    stages: tuple[CascadeStageSpec, ...] = ()

    def __post_init__(self) -> None:
        stages = tuple(self.stages)
        if len(stages) != 2:
            raise ValueError(
                f"CascadeQuery currently supports exactly 2 stages, got {len(stages)}"
            )
        object.__setattr__(self, "stages", stages)


@dataclasses.dataclass(frozen=True)
class AggregationQuery(Query):
    """Estimate mean(value_fn(model(x))) over a corpus to +/- eps.

    The specialized full scan runs every corpus item through the cheap
    stage-1 rendition; the target model refetches a random sample at full
    resolution until the control-variate CI half-width is <= ``eps`` with
    confidence ``1 - delta``.  ``value_fn`` maps a per-item score row to
    the scalar being aggregated (default: argmax class index).
    """

    corpus: Sequence[Any]
    eps: float
    delta: float = 0.05
    value_fn: Callable[[np.ndarray], float] | None = None
    batch: int = 64
    min_samples: int = 100
    max_samples: int | None = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.eps <= 0:
            raise ValueError(f"eps must be > 0, got {self.eps}")
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Base class for typed query results."""

    uid: int
    tenant: str
    latency: float
    error: BaseException | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclasses.dataclass(frozen=True)
class ClassificationResult(QueryResult):
    prediction: int | None = None
    scores: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class CascadeQueryResult(QueryResult):
    prediction: int | None = None
    scores: np.ndarray | None = None
    exit_stage: int = 0
    refetched: bool = False


@dataclasses.dataclass(frozen=True)
class AggregationQueryResult(QueryResult):
    estimate: float = 0.0
    ci_halfwidth: float = 0.0
    num_target_invocations: int = 0
    num_specialized_invocations: int = 0
    variance_reduction: float = 0.0
