"""Plain PyTorch versions of the IDCT kernel: one fp32 matrix product."""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.preprocessing.dct import UNZIGZAG


def idct_rows(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, 64) f32 coefficient rows @ (64, P) fused dequant+IDCT matrix.

    The same function as ``csrc/idct.cu``; the CPU path and the card check
    in ``chip_smoke.py`` use it."""
    return x @ m


@functools.lru_cache(maxsize=16)
def _unzigzag(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(UNZIGZAG, np.int64)).to(device)


def idct_zigzag_rows(x: torch.Tensor, m_zz: torch.Tensor) -> torch.Tensor:
    """(..., 64) int16 zigzag rows -> (rows, P) f32 through ``m_zz``, the
    fused matrix with its rows in zigzag order.

    Unzigzag, cast, then the natural-order product, as the split-decode
    program computed it before the kernel read the staged rows in place:
    ``m_zz``'s rows put back in natural order are the natural matrix bit
    for bit, so this is that arithmetic unchanged."""
    unzigzag = _unzigzag(x.device)
    rows = x.reshape(-1, 64).index_select(-1, unzigzag).to(torch.float32)
    return rows @ m_zz.index_select(0, unzigzag)
