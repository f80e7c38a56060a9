"""State-space and recurrent blocks of the port: ``repro.models.ssm`` —
Mamba-style selective SSM (hymba), mLSTM and sLSTM (xlstm).

Functions over the parameter modules of ``models/transformer.py``
(:class:`~repro_torch.models.transformer.Mamba`, ``MLSTM``, ``SLSTM``:
the reference's ``mamba_init``, ``mlstm_init``, ``slstm_init``), with the
reference's arithmetic and quirks:

* Mamba: ``dt`` is one value per token, shared by every channel
  (``softplus(dt_raw + dt_bias.mean())``); the depthwise conv is a
  cross-correlation in f32 over ``conv - 1`` rows of left padding (or
  ``conv_init``), and ``conv_state`` keeps the last ``conv - 1``
  pre-conv inputs.  Everything from the x_proj output to the gated rows
  (the split, softplus(dt_raw + mean(dt_bias)), -exp(a_log), the scan,
  d_skip x and the silu(z) gate) is K6 (``kernels/selective_scan``): over
  the whole prompt in :func:`mamba_apply`, at S = 1 in
  :func:`mamba_step`.  On CPU tensors K6 runs its plain version, the
  reference's chunked formulation.  Under grad (training) K6 runs as an
  autograd Function whose backward is K6's backward kernel.
* mLSTM: the chunked gated-linear-attention form (chunk 128), ``log(max(f,
  1e-6))``, ``exp(min(rel, 0))``, ``max(|n|, 1)`` as the normaliser, k
  scaled by ``hd ** -0.5`` and the forget gate biased by +4; padded steps
  carry ``f = 1, i = 0``.  The chunk loop is a Python loop of matmuls.
* sLSTM: stabilised exponential gating with ``m``, a true recurrence: a
  Python loop over time.  ``x @ w_in`` of every step is one product ahead
  of the loop (the reference takes it a step at a time; the rows are the
  same).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.models import layers as L

SLSTM_STATE = ("slstm_h", "slstm_c", "slstm_n", "slstm_m")  # the cache leaves of (h, c, n, m)


# ------------------------------------------------------------ selective SSM
def _causal_conv(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise cross-correlation in f32: window (B, S + conv - 1, D), w
    (conv, D) -> (B, S, D), ``out[t] = Σ_k w[k] window[t + k]``."""
    conv, s = w.shape[0], window.shape[1] - w.shape[0] + 1
    out = window[:, :s] * w[0]
    for k in range(1, conv):
        out = out + window[:, k:k + s] * w[k]
    return out


def mamba_apply(p, x: torch.Tensor, state: int, chunk: int = 256, init_state=None, conv_init=None):
    """Full-sequence selective SSM.  x: (B, S, D_model) -> (y, (ssm_state
    (B, D_in, N) f32, conv_state (B, conv - 1, D_in))), so prefill can
    seed decoding.  ``chunk``: the plain scan's chunk (CPU tensors)."""
    bsz, s, _ = x.shape
    dt_ = x.dtype
    xi, z = (x @ p.in_proj.to(dt_)).chunk(2, dim=-1)  # (B, S, D_in)
    d_in, conv = xi.shape[-1], p.conv_w.shape[0]
    pad = x.new_zeros(bsz, conv - 1, d_in) if conv_init is None else conv_init.to(dt_)
    xi_pad = torch.cat([pad, xi], dim=1)
    xc = F.silu(_causal_conv(xi_pad.float(), p.conv_w[:, 0, :].float()).to(dt_))
    conv_state = xi_pad[:, xi_pad.shape[1] - (conv - 1):]
    proj = xc @ p.x_proj.to(dt_)  # (B, S, 2N + 1): B, C, dt_raw
    h0 = None if init_state is None else init_state.float().contiguous()
    y, h_last = scan_ops.selective_scan(xc, proj, p.a_log, p.dt_bias, p.d_skip, h0, z, chunk)
    return y @ p.out_proj.to(dt_), (h_last, conv_state)


def mamba_step(p, x: torch.Tensor, ssm_state: torch.Tensor, conv_state: torch.Tensor, state: int):
    """Single decode step.  x: (B, D_model); the states from prefill or the
    previous step -> (y, (ssm_state, conv_state)): K6 at S = 1."""
    dt_ = x.dtype
    xi, z = (x @ p.in_proj.to(dt_)).chunk(2, dim=-1)
    window = torch.cat([conv_state.to(dt_), xi[:, None]], dim=1)  # (B, conv, D_in)
    xc = F.silu(_causal_conv(window.float(), p.conv_w[:, 0, :].float()).to(dt_))  # (B, 1, D_in)
    proj = xc @ p.x_proj.to(dt_)
    y, h = scan_ops.selective_scan(xc, proj, p.a_log, p.dt_bias, p.d_skip, ssm_state.contiguous(), z[:, None])
    return y[:, 0] @ p.out_proj.to(dt_), (h, window[:, 1:])


# ------------------------------------------------------------------- mLSTM
def mlstm_apply(p, x: torch.Tensor, num_heads: int, chunk: int = 128, init_c=None, init_n=None):
    """Chunked gated-linear-attention form of the mLSTM.

    x: (B, S, D_model) -> (y, (C (B, H, dk, dv), n (B, H, dk)))."""
    bsz, s, _ = x.shape
    dt_ = x.dtype
    xin = x @ p.up_proj.to(dt_)  # (B, S, D_in)
    d_in = xin.shape[-1]
    hd = d_in // num_heads
    q = (xin @ p.wq.to(dt_)).reshape(bsz, s, num_heads, hd)
    k = (xin @ p.wk.to(dt_)).reshape(bsz, s, num_heads, hd) * hd**-0.5
    v = (xin @ p.wv.to(dt_)).reshape(bsz, s, num_heads, hd)
    gates = xin @ p.w_gates.to(dt_)  # (B, S, 2H)
    ig = torch.sigmoid(gates[..., :num_heads].float())
    fg = torch.sigmoid(gates[..., num_heads:].float() + 4.0)  # forget ~1

    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, 0, 0, pad))
        fg = F.pad(fg, (0, 0, 0, pad), value=1.0)
    q, k, v = q.float(), k.float(), v.float()
    c = x.new_zeros(bsz, num_heads, hd, hd, dtype=torch.float32) if init_c is None else init_c
    n = x.new_zeros(bsz, num_heads, hd, dtype=torch.float32) if init_n is None else init_n
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()

    hs = []
    for c0 in range(0, s + pad, chunk):
        qq, kk, vv = q[:, c0:c0 + chunk], k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]  # (B, L, H, hd)
        ii, ff = ig[:, c0:c0 + chunk], fg[:, c0:c0 + chunk]  # (B, L, H)
        g = torch.cumsum(torch.log(torch.clamp(ff, min=1e-6)), dim=1)  # within-chunk log decay
        g_tot = g[:, -1]  # (B, H)
        # inter-chunk: h_t += exp(g_t) q_t @ C_in
        qd = qq * torch.exp(g)[..., None]
        h_inter = torch.einsum("blhd,bhde->blhe", qd, c)
        n_inter = torch.einsum("blhd,bhd->blh", qd, n)
        # intra-chunk: A[t, tau] = exp(g_t - g_tau) i_tau (q_t . k_tau)
        att = torch.einsum("blhd,bmhd->bhlm", qq, kk)
        rel = g[:, :, None, :] - g[:, None, :, :]  # (B, L, M, H)
        decay = torch.exp(torch.clamp(rel, max=0.0)).permute(0, 3, 1, 2)  # (B, H, L, M)
        i_tau = ii.transpose(1, 2)[:, :, None, :]  # (B, H, 1, M)
        a = torch.where(causal, att * decay * i_tau, 0.0)
        h_intra = torch.einsum("bhlm,bmhd->blhd", a, vv)
        n_intra = a.sum(dim=-1).transpose(1, 2)  # (B, L, H)
        # carry: C_out = exp(g_tot) C_in + Σ_tau exp(g_tot - g_tau) i_tau k v^T
        w_tau = torch.exp(g_tot[:, None] - g) * ii  # (B, L, H)
        decay_tot = torch.exp(g_tot)
        c = decay_tot[..., None, None] * c + torch.einsum("blhd,blhe->bhde", kk * w_tau[..., None], vv)
        n = decay_tot[..., None] * n + torch.einsum("blh,blhd->bhd", w_tau, kk)
        norm = torch.clamp(torch.abs(n_inter + n_intra), min=1.0)
        hs.append((h_inter + h_intra) / norm[..., None])

    hs = torch.cat(hs, dim=1).reshape(bsz, s + pad, d_in)[:, :s]
    hs = L.rmsnorm(hs.to(dt_), p.out_norm.scale)
    o = torch.sigmoid(x @ p.o_gate.to(dt_))
    return (hs * o) @ p.down_proj.to(dt_), (c, n)


def mlstm_step(p, x: torch.Tensor, c_state: torch.Tensor, n_state: torch.Tensor, num_heads: int):
    """Single decode step.  x: (B, D_model) -> (y, (C, n))."""
    bsz = x.shape[0]
    dt_ = x.dtype
    xin = x @ p.up_proj.to(dt_)
    d_in = xin.shape[-1]
    hd = d_in // num_heads
    q = (xin @ p.wq.to(dt_)).reshape(bsz, num_heads, hd).float()
    k = (xin @ p.wk.to(dt_)).reshape(bsz, num_heads, hd).float() * hd**-0.5
    v = (xin @ p.wv.to(dt_)).reshape(bsz, num_heads, hd).float()
    gates = (xin @ p.w_gates.to(dt_)).float()
    ig = torch.sigmoid(gates[..., :num_heads])
    fg = torch.sigmoid(gates[..., num_heads:] + 4.0)
    c_new = fg[..., None, None] * c_state + ig[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n_new = fg[..., None] * n_state + ig[..., None] * k
    h = torch.einsum("bhd,bhde->bhe", q, c_new)
    norm = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)), min=1.0)
    h = (h / norm[..., None]).reshape(bsz, d_in)
    h = L.rmsnorm(h.to(dt_), p.out_norm.scale)
    o = torch.sigmoid(x @ p.o_gate.to(dt_))
    return (h * o) @ p.down_proj.to(dt_), (c_new, n_new)


# ------------------------------------------------------------------- sLSTM
def _slstm_cell(p, x_in: torch.Tensor, state, dt_):
    """One step from ``x_in`` = ``(x_t @ w_in)`` in f32 (B, 4D)."""
    h_prev, c_prev, n_prev, m_prev = state
    pre = x_in + (h_prev.to(dt_) @ p.w_rec.to(dt_)).float()
    i_t, f_t, z_t, o_t = pre.chunk(4, dim=-1)
    # exponential gating with stabilizer (xLSTM eqs. 15-19)
    m_t = torch.maximum(f_t + m_prev, i_t)
    i_e = torch.exp(i_t - m_t)
    f_e = torch.exp(f_t + m_prev - m_t)
    c_t = f_e * c_prev + i_e * torch.tanh(z_t)
    n_t = f_e * n_prev + i_e
    h_t = torch.sigmoid(o_t) * c_t / torch.clamp(n_t, min=1.0)
    return h_t, c_t, n_t, m_t


def slstm_apply(p, x: torch.Tensor, num_heads: int, init_state=None):
    """Sequential sLSTM over time (a true recurrence).  x: (B, S, D) ->
    (y, (h, c, n, m) each (B, D) f32)."""
    bsz, s, d = x.shape
    dt_ = x.dtype
    if init_state is None:
        zeros = x.new_zeros(bsz, d, dtype=torch.float32)
        init_state = (zeros, zeros, zeros, zeros)
    x_in = (x @ p.w_in.to(dt_)).float()  # (B, S, 4D): every step's input product
    state, hs = init_state, []
    for t in range(s):
        state = _slstm_cell(p, x_in[:, t], state, dt_)
        hs.append(state[0])
    hs = L.rmsnorm(torch.stack(hs, dim=1).to(dt_), p.out_norm.scale)
    return hs @ p.down_proj.to(dt_), state


def slstm_step(p, x: torch.Tensor, state):
    """Single decode step.  x: (B, D) -> (y, (h, c, n, m))."""
    dt_ = x.dtype
    new = _slstm_cell(p, (x @ p.w_in.to(dt_)).float(), state, dt_)
    h = L.rmsnorm(new[0].to(dt_), p.out_norm.scale)
    return h @ p.down_proj.to(dt_), new
