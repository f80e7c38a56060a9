"""Flash attention (K3): the wrapper around ``csrc/flash_attention.cu``.

:func:`flash_attention_bshd` takes the model's layout — q (B, Sq, H, D),
k (B, Sk, KVH, D), v (B, Sk, KVH, DV) — and is what
``models/layers.attention_scores_blockwise`` calls.  DV is D everywhere
but MLA, whose q/k are 192 wide (nope 128 + rope 64) and v 128.  Sk is Sq
everywhere but cross attention (whisper's decoder over its 1500 encoder
frames, non-causal).  The reference wrapper's (B, H, S, D) layout is the
same call on ``transpose(1, 2)`` views: the kernel takes any strides.

The reference wrapper pads S up to its block size and crops back
(``repro/kernels/flash_attention/ops.py``), because a Pallas grid needs
whole blocks.  The CUDA kernel instead masks the ragged tail itself
(query rows past Sq are not stored, keys past Sk are masked as the padded
keys are), so nothing is copied: the kernel reads q, k and v in place
through their strides and writes one new (B, Sq, H, DV) tensor.

The kernel is fixed by dtype: float32 runs the SIMT kernel (full fp32,
any strides), bfloat16 the tensor-core kernel, whose TMA loads need
16-byte aligned base pointers and (batch, seq, head) strides; a bf16
tensor that breaks that raises here, before any launch.  Nothing switches
kernels at run time.  The kernels are templates on (D, DV):
:data:`HEAD_DIMS` lists their instances.

The bf16 kernel is persistent (one block per SM) and takes its work tiles
(128 query rows of one batch and head) in one order: (batch, head) pairs
in groups of :func:`tile_group`, so that a head's query tiles run close
together in time and re-read its K/V from L2 rather than device memory (a
group's K/V fit :data:`KV_L2_BYTES`), heaviest causal tile first within a
group.  Blocks take the next tile from a counter in device memory, kept
per device and stream like K4's arrival counters: the kernel leaves it at
zero.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import plain

# the kernels' template instances, (q/k width, v width)
HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))
# the C entry point's dtype code: 0 the SIMT fp32 kernel, 1 the bf16 tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TMA_ALIGN = 16  # bytes: TMA base pointers and strides
# K/V bytes one group of the bf16 kernel's tile order may hold, a sixth of
# the H100's 50 MB L2: the q and out streams pass through it too
KV_L2_BYTES = 8 * 2**20


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q/k/v must be (B, S, heads, D), got {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.shape[1] == 0 and q.shape[1] > 0:
        raise ValueError("attention over no keys")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on {q.device}/{k.device}/{v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _strides(x: torch.Tensor) -> tuple[int, int, int]:
    """(batch, seq, head) strides in elements; a dimension of size 1 is
    never stepped, so it gets its contiguous stride whatever torch reports."""
    return tuple(x.stride(i) if x.shape[i] > 1 else math.prod(x.shape[i + 1:]) for i in range(3))


def _check_tma(*xs: torch.Tensor) -> None:
    for x in xs:
        if x.data_ptr() % _TMA_ALIGN or any(st * x.element_size() % _TMA_ALIGN for st in _strides(x)):
            raise ValueError(
                f"the bf16 kernel's TMA loads need 16-byte aligned pointers and (batch, seq, head) "
                f"strides: pointer offset {x.data_ptr() % _TMA_ALIGN} B, strides {_strides(x)} elements"
            )


def tile_group(b: int, h: int, kvh: int, sk: int, d: int, dv: int) -> int:
    """(batch, head) pairs per group of the bf16 kernel's tile order: whole
    KV heads (``h // kvh`` query heads each) whose bf16 K and V, Sk keys of
    D + DV, fit :data:`KV_L2_BYTES` — at least one KV head, at most all
    ``b * h`` pairs (one group: every head's heaviest tile first)."""
    kv_heads = max(1, KV_L2_BYTES // (sk * (d + dv) * 2))
    return min(b * h, kv_heads * (h // kvh))


def flash_attention_bshd(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KVH, D)
    v: torch.Tensor,  # (B, Sk, KVH, DV)
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal (``kpos <= qpos``) / sliding-window (``kpos > qpos - window``)
    GQA attention, both positions counted from 0, -> (B, Sq, H, DV) in q's
    dtype, f32 softmax and accumulation; ``scale`` defaults to D^-0.5.

    On a CUDA tensor this launches ``csrc/flash_attention.cu`` on the
    current stream (and raises if it cannot); on a CPU tensor it runs the
    plain version."""
    _check(q, k, v, window)
    b, s, h, d = q.shape
    sk, dv = k.shape[1], v.shape[3]
    scale = float(d) ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return plain.flash_attention_bshd(q, k, v, causal=causal, window=window, scale=scale)
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take (q/k, v) head widths in {HEAD_DIMS}, got {(d, dv)}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q/k/v need a contiguous head_dim")
    if q.dtype == torch.bfloat16:
        _check_tma(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.repro_flash_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, sk, h, k.shape[2], d, dv,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        scale, int(causal), -1 if window is None else int(window),
        tile_group(b, h, k.shape[2], sk, d, dv),
        _build.stream_counters("flash_attention", q.device, stream, 2).data_ptr(), stream,
    )
    _build.check(lib, status, "flash_attention")
    flash_attention_bshd.launches += 1
    flash_attention_bshd.launches_by_dims[(d, dv)] += 1
    flash_attention_bshd.launches_cross += sk != s
    return out


flash_attention_bshd.launches = 0  # kernel launches (CPU calls do not count)
# the same launches by instance, (q/k width, v width)
flash_attention_bshd.launches_by_dims = dict.fromkeys(HEAD_DIMS, 0)
# the launches with a key length other than the query length (cross attention)
flash_attention_bshd.launches_cross = 0

