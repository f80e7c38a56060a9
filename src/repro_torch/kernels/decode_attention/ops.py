"""Flash-decoding (K4): the wrapper around ``csrc/decode_attention.cu``.

:func:`decode_attention_cache` reads the KV cache in the model's layout
(B, S, KVH, D) through its strides — a per-layer slice of the stacked
(L, B, S, KVH, D) cache is passed as it is, so no step copies or transposes
the cache (the reference wrapper reshapes to (B·KVH, S, D)).  It is the
port's ``decode_attention_jnp``: ``models/decode.py`` calls it on every
layer of every step.  The reference wrapper's
(B, KVH, S, D) layout is the same call on ``transpose(1, 2)`` views.

The kernel splits S into chunks of :data:`CHUNK` keys, one block per
(sequence·KV head, chunk), and a second pass combines the chunks' partial
softmax sums; the wrapper allocates the f32 scratch for them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import plain

HEAD_DIMS = (64, 128, 256)  # the kernel's template instances
MAX_GROUP = 8  # query heads per KV head the kernel holds in registers
CHUNK = 128  # keys per block (csrc/decode_attention.cu kChunk)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_cache(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, S, KVH, D)
    v_cache: torch.Tensor,  # (B, S, KVH, D)
    lengths: torch.Tensor,  # (B,) int — valid keys per sequence
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """One query token per sequence against its cache -> (B, H, D) in q's
    dtype.  Keys ``pos < lengths`` attend; with ``window`` only
    ``pos >= lengths - window``.  q and the cache may differ in dtype
    (float32 or bfloat16 each).

    On a CUDA tensor this launches ``csrc/decode_attention.cu`` on the
    current stream (and raises if it cannot); on a CPU tensor it runs the
    plain version."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"q must be (B, H, D) and the cache (B, S, KVH, D), got "
                         f"{tuple(q.shape)} {tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    b, h, d = q.shape
    _, s, kvh, dc = k_cache.shape
    if k_cache.shape[0] != b or dc != d or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache {tuple(k_cache.shape)}")
    if lengths.shape != (b,) or lengths.dtype.is_floating_point:
        raise ValueError(f"lengths must be (B,) integers, got {tuple(lengths.shape)} {lengths.dtype}")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode attention takes float32 or bfloat16, got {q.dtype} / "
                        f"{k_cache.dtype} / {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device == lengths.device):
        raise ValueError("q, cache and lengths must be on one device")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    scale = float(d) ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return plain.decode_attention(q, k_cache, v_cache, lengths, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, got {q.device}")
    group = h // kvh
    if d not in HEAD_DIMS or group > MAX_GROUP:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} query heads per KV head, got {d} / {group}")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("q and the cache need a contiguous head_dim")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or s == 0:
        return out.zero_()
    lens = lengths.to(torch.int32).contiguous()
    n_split = -(-s // CHUNK)
    part_ml = torch.empty((2, b * kvh, n_split, group), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b * kvh, n_split, group, d), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.repro_decode_attention(
        _DTYPES[q.dtype], _DTYPES[k_cache.dtype],
        q.data_ptr(), q.stride(0), q.stride(1),
        k_cache.data_ptr(), k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.data_ptr(), v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        lens.data_ptr(), out.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
        part_acc.data_ptr(), b, s, kvh, group, d, n_split,
        scale, -1 if window is None else int(window), stream,
    )
    _build.check(lib, status, "decode_attention")
    decode_attention_cache.launches += 1
    return out


decode_attention_cache.launches = 0  # kernel launches (CPU calls do not count)

