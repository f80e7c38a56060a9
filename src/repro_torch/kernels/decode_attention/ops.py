"""Flash-decoding (K4): the wrapper around ``csrc/decode_attention.cu``.

:func:`decode_attention_cache` reads the KV cache in the model's layout
(B, S, KVH, D) through its strides — a per-layer slice of the stacked
(L, B, S, KVH, D) cache is passed as it is, so no step copies or transposes
the cache (the reference wrapper reshapes to (B·KVH, S, D)).  It is the
port's ``decode_attention_jnp``: ``models/decode.py`` calls it on every
layer of every step.  The reference wrapper's
(B, KVH, S, D) layout is the same call on ``transpose(1, 2)`` views.

One launch per call: the kernel splits each sequence's valid keys into
chunks (:func:`split_plan`), one block per (chunk, sequence·KV head), and
the last block of each sequence·KV head merges the chunks' partial softmax
sums.  The wrapper allocates the f32 scratch for the partials; the
per-(sequence·KV head) arrival counters are kept per device and stream,
and the kernel leaves them at zero.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, require_no_grad
from repro_torch.kernels.decode_attention import plain

HEAD_DIMS = (64, 128, 256)  # the kernel's template instances
MAX_GROUP = 8  # query heads per KV head the kernel holds in registers
ROADMAP_BACKWARD = "decode only: no training path reaches K4, and no backward is queued"
STAGE_BYTES = 64 * 1024  # K + V rows of one chunk in shared memory (csrc kStageBytes)
MIN_CHUNK = 8  # keys per block, at least (unless fewer are valid)
_ALIGN = 16  # bytes: the kernel's TMA bulk copies
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_plan(bkvh: int, s: int, window: int | None, d: int, cache_bytes: int,
               n_sm: int) -> tuple[int, int]:
    """``(chunk, n_split)``: keys per block and blocks per sequence·KV head.

    Chosen from shapes alone — never from lengths, which live on the card.
    A sequence has at most ``span = min(S, window)`` valid keys, and its
    chunks start at ``max(0, length - window)``, so ``n_split`` chunks of
    ``chunk`` keys cover them.  The chunk is as large as keeps
    ``bkvh * n_split >= n_sm`` (the grid fills the card), at least
    :data:`MIN_CHUNK`, and at most what :data:`STAGE_BYTES` holds."""
    span = s if window is None else min(s, window)
    want = -(-n_sm // bkvh)
    most = STAGE_BYTES // (2 * d * cache_bytes)
    chunk = min(most, max(min(MIN_CHUNK, span), span // want))
    return chunk, -(-span // chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_alignment(*caches: torch.Tensor) -> None:
    """The kernel copies each cache row with one TMA bulk copy: the base
    pointer and every stepped (batch, seq, head) stride must be 16-byte
    aligned."""
    for x in caches:
        strides = [x.stride(i) * x.element_size() for i in range(3) if x.shape[i] > 1]
        if x.data_ptr() % _ALIGN or any(st % _ALIGN for st in strides):
            raise ValueError(
                f"decode attention's bulk copies need a 16-byte aligned cache: "
                f"pointer offset {x.data_ptr() % _ALIGN} B, (batch, seq, head) strides "
                f"{[x.stride(i) for i in range(3)]} elements of {x.element_size()} B"
            )


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
    ``pos >= lengths - window``; with no such key the result is the mean of
    the cache's S value rows (the reference's uniform softmax over masked
    scores).  q and the cache may differ in dtype (float32 or bfloat16
    each).

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
    require_no_grad("decode_attention (K4)", ROADMAP_BACKWARD, q, k_cache, v_cache)
    if q.device.type == "cpu":
        return plain.decode_attention(q, k_cache, v_cache, lengths, window=window, scale=scale)
    group = h // kvh
    if d not in HEAD_DIMS or group > MAX_GROUP:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} query heads per KV head, got {d} / {group}")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("q and the cache need a contiguous head_dim")
    if b * kvh > 65535:
        raise ValueError(f"at most 65535 sequence x KV head pairs per launch, got {b * kvh}")
    _check_alignment(k_cache, v_cache)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, got {q.device}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or s == 0:
        return out.zero_()
    lens = lengths.to(torch.int32).contiguous()
    chunk, n_split = split_plan(b * kvh, s, window, d, k_cache.element_size(), _sm_count(q.device.index))
    part = torch.empty(b * kvh * n_split * group * (2 + d), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.repro_decode_attention(
        _DTYPES[q.dtype], _DTYPES[k_cache.dtype],
        q.data_ptr(), q.stride(0), q.stride(1),
        k_cache.data_ptr(), k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.data_ptr(), v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        lens.data_ptr(), out.data_ptr(), part.data_ptr(),
        _build.stream_counters("decode_attention", q.device, stream, b * kvh).data_ptr(),
        b, s, kvh, group, d, chunk, n_split, scale, -1 if window is None else int(window), stream,
    )
    _build.check(lib, status, "decode_attention")
    decode_attention_cache.launches += 1
    return out


decode_attention_cache.launches = 0  # kernel launches (CPU calls do not count)
