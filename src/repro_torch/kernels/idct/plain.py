"""Plain PyTorch version of the IDCT kernel: one fp32 matrix product."""

from __future__ import annotations

import torch


def idct_rows(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, 64) f32 coefficient rows @ (64, P) fused dequant+IDCT matrix.

    The same function as ``csrc/idct.cu``; the CPU path and the card check
    in ``chip_smoke.py`` use it."""
    return x @ m
