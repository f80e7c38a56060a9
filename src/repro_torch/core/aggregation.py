"""BlazeIt-style aggregation queries with control variates (paper §3.2).

Query: estimate the mean number of target objects per frame of a video, to
within +/- eps with confidence 1-delta.  A cheap specialized NN s(x) is
evaluated on EVERY frame (this is where preprocessing throughput bites —
the paper's point); the expensive target model t(x) on a random sample.
The control-variate estimator

    mu_hat = mean_all(s) + mean_sample(t(x_i) - s(x_i))

has variance Var(t - s)/m: the better the specialized NN, the fewer target
invocations.  SMOL improves end-to-end time on BOTH axes: low-resolution
renditions cut the per-frame preprocessing cost of the s(x) scan, and
*more accurate* (more expensive) specialized NNs cut sampling variance —
exactly the Figure 9 story.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

Z_FOR_DELTA = {0.05: 1.96, 0.01: 2.576, 0.1: 1.645}


def z_for_delta(delta: float) -> float:
    """Two-sided critical value z with P(|Z| > z) = delta for Z ~ N(0, 1).

    Table lookup for the common deltas, otherwise an inverse-normal
    rational approximation (Acklam), accurate to ~1e-9 — previously any
    unlisted delta silently fell back to the 0.05 value.
    """
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    if delta in Z_FOR_DELTA:
        return Z_FOR_DELTA[delta]
    # z = Phi^-1(1 - delta/2) via Acklam's rational approximation.
    p = 1.0 - delta / 2.0
    a = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
    b = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00)
    p_low = 0.02425
    if p < p_low:
        q = np.sqrt(-2.0 * np.log(p))
        x = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0
        )
    elif p <= 1.0 - p_low:
        q = p - 0.5
        r = q * q
        x = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
            ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0
        )
    else:
        q = np.sqrt(-2.0 * np.log(1.0 - p))
        x = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0
        )
    return float(x)


@dataclasses.dataclass
class AggregationResult:
    estimate: float
    ci_halfwidth: float
    num_target_invocations: int
    num_specialized_invocations: int
    sample_indices: np.ndarray
    variance_reduction: float  # Var(t) / Var(t - s) on the sample


def control_variate_aggregate(
    specialized_all: np.ndarray,
    target_fn: Callable[[np.ndarray], np.ndarray],
    eps: float,
    delta: float = 0.05,
    batch: int = 64,
    min_samples: int = 100,
    max_samples: int | None = None,
    seed: int = 0,
) -> AggregationResult:
    """Sequential control-variate estimation.

    ``specialized_all`` — s(x) already computed for every frame (the cheap
    full scan).  ``target_fn(indices)`` — evaluates the target model on the
    given frame indices, returning per-frame counts.  Samples in batches
    until the CLT half-width drops below ``eps``.
    """
    n = len(specialized_all)
    max_samples = max_samples or n
    z = z_for_delta(delta)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)

    mean_s = float(specialized_all.mean())
    taken: list[int] = []
    diffs: list[float] = []
    t_vals: list[float] = []
    m = 0
    while True:
        want = max(min_samples - m, batch) if m < min_samples else batch
        if m + want > max_samples:
            want = max_samples - m
        if want <= 0:
            break
        idx = perm[m : m + want]
        t = np.asarray(target_fn(idx), dtype=np.float64)
        s = specialized_all[idx].astype(np.float64)
        diffs.extend((t - s).tolist())
        t_vals.extend(t.tolist())
        taken.extend(idx.tolist())
        m += want
        if m >= min_samples:
            d = np.asarray(diffs)
            hw = z * d.std(ddof=1) / np.sqrt(m)
            if hw <= eps or m >= max_samples:
                break
    d = np.asarray(diffs)
    t_arr = np.asarray(t_vals)
    est = mean_s + float(d.mean())
    hw = z * float(d.std(ddof=1)) / np.sqrt(m)
    var_t = float(t_arr.var(ddof=1)) if m > 1 else 0.0
    var_d = float(d.var(ddof=1)) if m > 1 else 1.0
    return AggregationResult(
        estimate=est,
        ci_halfwidth=hw,
        num_target_invocations=m,
        num_specialized_invocations=n,
        sample_indices=np.asarray(taken),
        variance_reduction=var_t / max(var_d, 1e-12),
    )


def plain_sampling_aggregate(
    target_fn: Callable[[np.ndarray], np.ndarray],
    n: int,
    eps: float,
    delta: float = 0.05,
    batch: int = 64,
    min_samples: int = 100,
    max_samples: int | None = None,
    seed: int = 0,
) -> AggregationResult:
    """Baseline: plain random sampling, no control variate."""
    zeros = np.zeros(n)
    res = control_variate_aggregate(
        zeros, target_fn, eps, delta, batch, min_samples, max_samples, seed
    )
    return dataclasses.replace(res, num_specialized_invocations=0)
