"""Plain PyTorch version of the selective scan (K6): the reference's own
formulation (``repro.models.ssm``, ``mamba_apply``/``mamba_step`` and
``_ssm_scan_chunked``), from the x_proj output to the gated rows.

``proj`` is split into B, C and dt_raw and cast to f32, ``dt =
softplus(dt_raw + mean(dt_bias))`` and ``a = -exp(a_log)``; ``da = exp(dt
a)`` and ``db = dt B x`` are materialised as (B, S, D, N) f32 tensors, the
time axis is padded to whole chunks with ``da = 1``, ``db = 0`` (so the
last state is the one after the last real token), each chunk is scanned in
parallel — Hillis–Steele doubling, where the reference takes
``lax.associative_scan`` — with the carry folded in through the prefix
products, ``y = Σ_n h C + d_skip x``, and with ``z`` the output is
``y.to(z.dtype) * silu(z)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    proj: torch.Tensor,  # (B, S, 2N + 1) model dtype: B, C, dt_raw
    a_log: torch.Tensor,  # (D, N) f32
    dt_bias: torch.Tensor,  # (D,) f32
    d_skip: torch.Tensor,  # (D,) f32
    h0: torch.Tensor | None = None,  # (B, D, N) f32; None: zeros
    z: torch.Tensor | None = None,  # (B, S, D) model dtype: the gate; None: y in f32
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, S, D): y in f32, or y silu(z) in z's dtype; h_last
    (B, D, N) f32)."""
    bsz, s, d = xc.shape
    n = a_log.shape[1]
    x = xc.float()
    bmat, cmat, dt_raw = proj.float().split([n, n, 1], dim=-1)
    dt = F.softplus(dt_raw + dt_bias.mean())  # (B, S, 1): one step size per token
    da = torch.exp(dt[..., None] * -torch.exp(a_log))  # (B, S, D, N)
    db = dt[..., None] * bmat[:, :, None, :] * x[..., None]
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
    return (y if z is None else y.to(z.dtype) * F.silu(z)), h
