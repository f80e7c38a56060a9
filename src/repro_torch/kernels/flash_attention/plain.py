"""Plain PyTorch version of the flash-attention kernel (K3).

The same function as ``csrc/flash_attention.cu``, written as
``repro.models.layers.attention_scores_blockwise`` writes it: a dense
softmax when the keys fit one block, else an online softmax over KV blocks
with the padded tail masked.  Scores, softmax and the value sum are f32;
the result is cast to q's dtype.  The CPU path and the card check in
``chip_smoke.py`` use it.

The value width may differ from the query/key width (MLA's 192/128), as
the reference's ``dv = v.shape[-1]``, and the key length from the query
length (cross attention: whisper's decoder over 1500 encoder frames); the
branch is chosen by the key length, as the reference's ``sk <= block``.
Both positions count from 0: causal keeps ``kpos <= qpos``, the window
``kpos > qpos - window``.

Fully masked rows: here (as in the reference) a row whose every key is
masked gets the mean of V, the CUDA kernel gives 0 (``l == 0`` guard, as
the Pallas kernel's finalize).  No such row is ever read: a causal row
always sees key 0, a windowed row of a square call (``kpos > qpos -
window``) its own key, a non-causal unwindowed row every key, and padded
query rows are cropped.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite: exp(NEG_INF - NEG_INF) must be 1, not NaN


def _mask(s: int, kpos: torch.Tensor, causal: bool, window: int | None) -> torch.Tensor:
    qpos = torch.arange(s, device=kpos.device)[:, None]
    mask = torch.ones((s, kpos.shape[0]), dtype=torch.bool, device=kpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos
    if window is not None:
        mask &= kpos[None, :] > qpos - window
    return mask


def flash_attention_bshd(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KVH, D)
    v: torch.Tensor,  # (B, Sk, KVH, DV)
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    block: int = 1024,
) -> torch.Tensor:
    """(B, Sq, H, DV) attention in the model's layout; GQA in grouped form
    (query heads ``h`` read KV head ``h // group``, no repeat)."""
    b, s, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    group = h // kvh
    scale = scale if scale is not None else d**-0.5
    qg = q.reshape(b, s, kvh, group, d).float()
    if sk <= block:
        sc = torch.einsum("bqkgd,bmkd->bkgqm", qg, k.float()) * scale
        mask = _mask(s, torch.arange(sk, device=q.device), causal, window)
        sc = sc.masked_fill(~mask, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        out = torch.einsum("bkgqm,bmkd->bqkgd", p, v.float())
        return out.reshape(b, s, h, dv).to(q.dtype)

    nb = -(-sk // block)
    pad = nb * block - sk
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    m = torch.full((b, kvh, group, s), NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, group, s), device=q.device)
    acc = torch.zeros((b, kvh, group, s, dv), device=q.device)
    for bi in range(nb):
        kb = kf[:, bi * block:(bi + 1) * block]
        vb = vf[:, bi * block:(bi + 1) * block]
        sc = torch.einsum("bqkgd,bmkd->bkgqm", qg, kb) * scale
        kpos = bi * block + torch.arange(block, device=q.device)
        mask = _mask(s, kpos, causal, window) & (kpos < sk)[None, :]
        sc = sc.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1)
        acc = corr[..., None] * acc + torch.einsum("bkgqm,bmkd->bkgqd", p, vb)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4)  # (B, S, K, G, DV)
    return out.reshape(b, s, h, dv).to(q.dtype)
