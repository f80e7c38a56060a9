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

:func:`selective_scan_bwd` is the same function's gradient written out
(K6's backward): the states materialised again, then the reverse
recurrence ``g_t = dy_t C_t + exp(dt_{t+1} a) g_{t+1}`` as the same chunked
tree scan on the flipped time axis, the gate's backward in the model
dtype where autograd rounds it.
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
    x = xc.float()
    n = a_log.shape[1]
    bmat, cmat, dt_raw = proj.float().split([n, n, 1], dim=-1)
    dt = F.softplus(dt_raw + dt_bias.mean())  # (B, S, 1): one step size per token
    da = torch.exp(dt[..., None] * -torch.exp(a_log))  # (B, S, D, N)
    db = dt[..., None] * bmat[:, :, None, :] * x[..., None]
    h = x.new_zeros(xc.shape[0], xc.shape[2], n) if h0 is None else h0.float()
    hs, h = _chunked_scan(da, db, h, chunk)
    y = torch.einsum("bsdn,bsn->bsd", hs, cmat) + d_skip * x
    return (y if z is None else y.to(z.dtype) * F.silu(z)), h


def _chunked_scan(da: torch.Tensor, db: torch.Tensor, h: torch.Tensor, chunk: int):
    """``h_t = da_t h_{t-1} + db_t`` over axis 1 of (B, S, D, N) from ``h``,
    ``chunk`` steps a tree, the time axis padded to whole chunks with
    ``da = 1``, ``db = 0`` -> (every state (B, S, D, N), the last)."""
    bsz, s, d, n = da.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        da = torch.cat([da, da.new_ones(bsz, pad, d, n)], dim=1)
        db = torch.cat([db, db.new_zeros(bsz, pad, d, n)], dim=1)
    hs = []
    for c0 in range(0, s + pad, chunk):
        aa, bb = _scan_chunk(da[:, c0:c0 + chunk], db[:, c0:c0 + chunk])
        hc = aa * h[:, None] + bb
        h = hc[:, -1]
        hs.append(hc)
    return torch.cat(hs, dim=1)[:, :s], h


def selective_scan_bwd(
    xc: torch.Tensor,  # (B, S, D) model dtype
    proj: torch.Tensor,  # (B, S, 2N + 1) model dtype: B, C, dt_raw
    a_log: torch.Tensor,  # (D, N) f32
    dt_bias: torch.Tensor,  # (D,) f32
    d_skip: torch.Tensor,  # (D,) f32
    h0: torch.Tensor | None,  # (B, D, N) f32; None: zeros
    z: torch.Tensor | None,  # (B, S, D) model dtype: the gate; None: no gate
    dout: torch.Tensor,  # (B, S, D): the gradient of out (z's dtype, or f32 without z)
    dh_last: torch.Tensor | None = None,  # (B, D, N) f32: the gradient of h_last; None: zeros
    chunk: int = 256,
) -> tuple:
    """The gradient of :func:`selective_scan` -> (dxc, dproj, da_log,
    ddt_bias, dd_skip, dh0 or None, dz or None): dxc, dproj and dz in the
    model dtype, the rest f32.  The gate's backward rounds where autograd
    of ``y.to(z.dtype) * F.silu(z)`` rounds; the rest runs in f32 and
    rounds once."""
    bsz, s, d = xc.shape
    n = a_log.shape[1]
    x = xc.float()
    bmat, cmat, dt_raw = proj.float().split([n, n, 1], dim=-1)
    u = dt_raw + dt_bias.mean()
    dt = F.softplus(u)  # (B, S, 1)
    a = -torch.exp(a_log)  # (D, N)
    da = torch.exp(dt[..., None] * a)  # (B, S, D, N): alpha_t
    db = dt[..., None] * bmat[:, :, None, :] * x[..., None]
    h_init = x.new_zeros(bsz, d, n) if h0 is None else h0.float()
    hs, _ = _chunked_scan(da, db, h_init, chunk)
    h_prev = torch.cat([h_init[:, None], hs[:, :-1]], dim=1)  # h_{t-1}
    dz = None
    if z is None:
        dy = dout.float()
    else:  # autograd of y.to(T) * silu(z), in T: dy = f32(T(dout s)), dz = silu_backward(T(dout T(y)), z)
        y = torch.einsum("bsdn,bsn->bsd", hs, cmat) + d_skip * x
        dy = (dout * F.silu(z)).float()
        dz = torch.ops.aten.silu_backward(dout * y.to(z.dtype), z)
    # g_t = dy_t C_t + alpha_{t+1} g_{t+1}: the forward's scan on the flipped
    # time axis, alpha shifted by one step (1 ahead of the last step, where
    # dh_last enters)
    a_rev = torch.cat([da.new_ones(bsz, 1, d, n), da.flip(1)[:, :-1]], dim=1)
    g_init = x.new_zeros(bsz, d, n) if dh_last is None else dh_last.float()
    g, _ = _chunked_scan(a_rev, (dy[..., None] * cmat[:, :, None, :]).flip(1), g_init, chunk)
    g = g.flip(1)
    gx = torch.einsum("bsdn,bsd->bsn", g, x)  # sum_d g x
    gha = g * h_prev * da  # g_t h_{t-1} alpha_t
    ddt = torch.einsum("bsdn,dn->bs", gha, a) + (gx * bmat).sum(-1)
    du = torch.ops.aten.softplus_backward(ddt[..., None], u, 1.0, 20.0)  # (B, S, 1)
    dproj = torch.cat([dt * gx, torch.einsum("bsdn,bsd->bsn", hs, dy), du], dim=-1)
    dx = torch.einsum("bsdn,bsn->bsd", g, dt * bmat) + d_skip * dy
    da_log = a * torch.einsum("bsdn,bs->dn", gha, dt[..., 0])
    ddt_bias = (du.sum() / d).expand(d).clone()
    dd_skip = torch.einsum("bsd,bsd->d", dy, x)
    dh0 = None if h0 is None else da[:, 0] * g[:, 0]
    return dx.to(xc.dtype), dproj.to(proj.dtype), da_log, ddt_bias, dd_skip, dh0, dz
