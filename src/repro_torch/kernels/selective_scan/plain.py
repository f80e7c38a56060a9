"""Plain PyTorch version of the selective scan (K6): the reference's own
formulation (``repro.models.ssm``, ``mamba_apply`` and
``_ssm_scan_chunked``).

``da = exp(dt a)`` and ``db = dt B x`` are materialised as (B, S, D, N)
f32 tensors, the time axis is padded to whole chunks with ``da = 1``,
``db = 0`` (so the last state is the one after the last real token), each
chunk is scanned in parallel — Hillis–Steele doubling, where the
reference takes ``lax.associative_scan`` — with the carry folded in
through the prefix products, and ``y = Σ_n h C + d_skip x``.
"""

from __future__ import annotations

import torch


def _scan_chunk(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` over axis 1 of
    (B, L, D, N): the prefix products and the prefix states from h = 0."""
    offset = 1
    while offset < a.shape[1]:
        a_prev, b_prev = a[:, :-offset], b[:, :-offset]
        a_cur, b_cur = a[:, offset:], b[:, offset:]
        a = torch.cat([a[:, :offset], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :offset], a_cur * b_prev + b_cur], dim=1)
        offset *= 2
    return a, b


def selective_scan(
    xc: torch.Tensor,  # (B, S, D) model dtype, read as f32
    dt: torch.Tensor,  # (B, S) f32: one step size per token
    bmat: torch.Tensor,  # (B, S, N) f32
    cmat: torch.Tensor,  # (B, S, N) f32
    a: torch.Tensor,  # (D, N) f32: -exp(a_log)
    d_skip: torch.Tensor,  # (D,) f32
    h0: torch.Tensor | None = None,  # (B, D, N) f32; None: zeros
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, S, D) f32, h_last (B, D, N) f32)."""
    bsz, s, d = xc.shape
    n = a.shape[1]
    x = xc.float()
    da = torch.exp(dt[:, :, None, None] * a)  # (B, S, D, N)
    db = (dt[:, :, None] * bmat)[:, :, None, :] * x[..., None]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        da = torch.cat([da, da.new_ones(bsz, pad, d, n)], dim=1)
        db = torch.cat([db, db.new_zeros(bsz, pad, d, n)], dim=1)
    h = x.new_zeros(bsz, d, n) if h0 is None else h0.float()
    hs = []
    for c0 in range(0, s + pad, chunk):
        aa, bb = _scan_chunk(da[:, c0:c0 + chunk], db[:, c0:c0 + chunk])
        hc = aa * h[:, None] + bb
        h = hc[:, -1]
        hs.append(hc)
    hs = torch.cat(hs, dim=1)[:, :s]
    y = torch.einsum("bsdn,bsn->bsd", hs, cmat) + d_skip * x
    return y, h
