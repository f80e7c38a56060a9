"""Plain PyTorch version of the flash-decoding kernel (K4).

The same function as ``csrc/decode_attention.cu``, written as
``repro.models.layers.decode_attention_jnp`` writes it: the G query heads
of each KV head contract against the cache in its (B, S, KVH, D) layout,
keys at ``pos >= length`` (and, with a window, ``pos < length - window``)
are masked, softmax and value sum in f32, result in q's dtype.  Lengths
below 0 or above S mask as they would in a longer cache (a slice of a
sequence-split cache, called with ``lengths - off``).  With
``return_lse`` also each head's f32 log-sum-exp of the masked scores,
-1e30 where no key is valid.  The CPU path and the card check in
``chip_smoke.py`` use it.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention(
    q: torch.Tensor,  # (B, H, D) — one token per sequence
    k_cache: torch.Tensor,  # (B, S, KVH, D)
    v_cache: torch.Tensor,  # (B, S, KVH, D)
    lengths: torch.Tensor,  # (B,) int — valid keys per sequence
    window: int | None = None,
    scale: float | None = None,
    return_lse: bool = False,
):
    b, h, d = q.shape
    kvh = k_cache.shape[2]
    group = h // kvh
    scale = scale if scale is not None else d**-0.5
    qg = q.reshape(b, kvh, group, d).float()
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)[None, None, None, :]
    lens = lengths.to(device=q.device, dtype=torch.int64)[:, None, None, None]
    mask = pos < lens
    if window is not None:
        mask &= pos >= lens - window
    sc = sc.masked_fill(~mask, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out.reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(mask.any(-1), torch.logsumexp(sc, dim=-1), NEG_INF)
    return out, lse.reshape(b, h)
