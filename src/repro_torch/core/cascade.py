"""Model cascades (Tahoma-style; paper §3.2 classification example).

A cascade is a sequence of (model, threshold) stages.  Each stage scores a
batch; items whose confidence clears the stage threshold exit with that
stage's prediction, the rest *pass through* to the next (more accurate,
more expensive) stage.  Pass-through rates feed the cost models' alpha_j.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class CascadeStage:
    name: str
    apply_fn: Callable[[np.ndarray], np.ndarray]  # batch -> logits (N, C)
    confidence_threshold: float  # exit if max softmax prob >= threshold
    exec_throughput: float | None = None  # measured items/sec (calibration)


@dataclasses.dataclass
class CascadeResult:
    predictions: np.ndarray  # (N,) int labels
    exit_stage: np.ndarray  # (N,) stage index each item exited at
    pass_fractions: tuple[float, ...]  # fraction of items reaching each stage

    @property
    def exit_counts(self) -> tuple[int, ...]:
        """Number of items that exited at each stage."""
        n_stages = len(self.pass_fractions)
        return tuple(int((self.exit_stage == s).sum()) for s in range(n_stages))


def _softmax_conf(logits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    z = logits - logits.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=-1, keepdims=True)
    return p.argmax(axis=-1), p.max(axis=-1)


class Cascade:
    """Executable cascade with pass-rate tracking."""

    def __init__(self, stages: Sequence[CascadeStage]):
        if not stages:
            raise ValueError("cascade needs >= 1 stage")
        self.stages = list(stages)

    def __call__(self, batch: np.ndarray) -> CascadeResult:
        n = batch.shape[0]
        preds = np.zeros(n, dtype=np.int64)
        exit_stage = np.full(n, len(self.stages) - 1, dtype=np.int64)
        alive = np.arange(n)
        pass_fractions = []
        x = batch
        for s, stage in enumerate(self.stages):
            pass_fractions.append(len(alive) / n)
            if len(alive) == 0:
                # Everything exited earlier: the remaining stages see zero
                # items, so skip their apply_fn entirely.
                pass_fractions.extend(0.0 for _ in self.stages[s + 1 :])
                break
            logits = np.asarray(stage.apply_fn(x))
            last = s == len(self.stages) - 1
            if last:
                # The final stage keeps every remaining item: argmax alone
                # decides the label, no need to normalize a softmax.
                labels = logits.argmax(axis=-1)
                exits = np.ones(len(alive), dtype=bool)
            else:
                labels, conf = _softmax_conf(logits)
                exits = conf >= stage.confidence_threshold
            preds[alive[exits]] = labels[exits]
            exit_stage[alive[exits]] = s
            alive = alive[~exits]
            x = x[~exits]
        return CascadeResult(preds, exit_stage, tuple(pass_fractions))

    def measured_pass_fractions(self, calibration_batch: np.ndarray) -> tuple[float, ...]:
        """Estimate alpha reach-fractions on a validation set (paper §4)."""
        return self(calibration_batch).pass_fractions


def make_jit_stage(
    name: str,
    params,
    forward: Callable,
    confidence_threshold: float,
    device: str | torch.device | None = "cuda",
) -> CascadeStage:
    """Wrap a (params, forward) pair as a cascade stage on ``device``: each
    batch is copied there, scored under ``torch.inference_mode()`` and its
    logits read back to the host."""
    dev = resolve_device(device)

    def apply_fn(batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = forward(params, torch.as_tensor(np.asarray(batch), device=dev))
        return out.detach().cpu().numpy()

    return CascadeStage(name=name, apply_fn=apply_fn, confidence_threshold=confidence_threshold)
