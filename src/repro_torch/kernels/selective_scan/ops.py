"""Selective scan (K6): the wrapper around ``csrc/selective_scan.cu``.

Mamba's scan with its prologue and gate (``models/ssm.py``): from the
x_proj output ``proj = [B | C | dt_raw]``, ``dt = softplus(dt_raw +
mean(dt_bias))`` and ``a = -exp(a_log)``; for each (sequence, channel d,
state n), ``h_t = exp(dt_t a[d,n]) h_{t-1} + dt_t B[t,n] x[t,d]`` and
``y[t,d] = Σ_n h_t C[t,n] + d_skip[d] x[t,d]``; with ``z`` the output is
``y silu(z)`` in the model dtype.  ``mamba_apply`` calls it once over the
whole prompt and ``mamba_step`` with S = 1, so a decode step launches one
per hybrid layer and nothing else for the scan.  It stands for the
reference's plain-JAX scan (``repro.models.ssm._ssm_scan_chunked`` and the
elementwise around it), not for a TPU kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, require_no_grad
from repro_torch.kernels.selective_scan import plain

NSTATES = (8, 16)  # the kernel's template instances: hymba-1.5b's 16, its smoke config's 8
# where a gradient through the kernel is queued
ROADMAP_BACKWARD = "ROADMAP port queue item 25.7a (K6's backward, hymba training on the card)"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(t: torch.Tensor, dims: tuple[int, ...]) -> bool:
    """``t`` starts on 16 bytes and steps whole 16 bytes along ``dims``
    (where they hold more than one row): the kernel's 16-byte copies."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(t.shape[i] == 1 or t.stride(i) * es % 16 == 0 for i in dims)


def selective_scan(
    xc: torch.Tensor,  # (B, S, D) f32 or bf16, read as f32
    proj: torch.Tensor,  # (B, S, 2N + 1) xc's dtype: B, C, dt_raw (the x_proj output)
    a_log: torch.Tensor,  # (D, N) f32
    dt_bias: torch.Tensor,  # (D,) f32
    d_skip: torch.Tensor,  # (D,) f32
    h0: torch.Tensor | None = None,  # (B, D, N) f32; None: zeros
    z: torch.Tensor | None = None,  # (B, S, D) xc's dtype, unit stride along D: the gate
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, S, D), h_last (B, D, N) f32): ``out`` is y in f32, or
    with ``z`` ``y silu(z)`` in xc's dtype (bf16: rounded as
    ``y.to(bf16) * F.silu(z)`` rounds).

    On CUDA tensors this launches ``csrc/selective_scan.cu`` on the current
    stream (and raises if it cannot); on CPU tensors it runs the plain
    version, whose tree scan takes ``chunk`` steps at a time (the kernel
    walks the steps in order and takes no chunk)."""
    if xc.dim() != 3:
        raise ValueError(f"xc must be (B, S, D), got {tuple(xc.shape)}")
    bsz, s, d = xc.shape
    if s < 1 or bsz < 1:
        raise ValueError(f"an empty scan: xc {tuple(xc.shape)}")
    if xc.dtype not in _DTYPES:
        raise TypeError(f"xc must be float32 or bfloat16, got {xc.dtype}")
    if a_log.dim() != 2 or a_log.shape[0] != d:
        raise ValueError(f"a_log must be (D={d}, N), got {tuple(a_log.shape)}")
    n = a_log.shape[1]
    f32 = torch.float32
    operands = {"proj": (proj, (bsz, s, 2 * n + 1), xc.dtype), "a_log": (a_log, (d, n), f32),
                "dt_bias": (dt_bias, (d,), f32), "d_skip": (d_skip, (d,), f32)}
    if h0 is not None:
        operands["h0"] = (h0, (bsz, d, n), f32)
    if z is not None:
        operands["z"] = (z, (bsz, s, d), xc.dtype)
    for name, (t, shape, dtype) in operands.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != xc.device:
            raise ValueError(f"{name} on {t.device} but xc on {xc.device}")
    require_no_grad("selective_scan (K6)", ROADMAP_BACKWARD, xc, proj, a_log, dt_bias, d_skip, h0, z)
    if xc.device.type == "cpu":
        return plain.selective_scan(xc, proj, a_log, dt_bias, d_skip, h0, z, chunk)
    if xc.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu tensors, got {xc.device}")
    if n not in NSTATES:
        raise ValueError(f"the kernel takes N in {NSTATES} states, got {n}")
    if bsz > 65535:
        raise ValueError(f"at most 65535 sequences per launch, got {bsz}")
    dense = [xc, *(t for name, (t, _, _) in operands.items() if name != "z")]
    if not all(t.is_contiguous() for t in dense) or (z is not None and z.stride(2) != 1):
        raise ValueError("selective_scan needs contiguous operands (z: unit stride along D)")
    vectors = [xc, a_log, dt_bias] + ([] if h0 is None else [h0])
    if d * xc.element_size() % 16 or not all(_aligned(t, ()) for t in vectors) or (
            z is not None and not _aligned(z, (0, 1))):
        raise ValueError("selective_scan reads rows of x and z, a_log, dt_bias and h0 16 bytes at a time: "
                         "D * itemsize must be a multiple of 16 and each must start 16-byte aligned")
    out = torch.empty((bsz, s, d), dtype=f32 if z is None else xc.dtype, device=xc.device)
    h_last = torch.empty((bsz, d, n), dtype=f32, device=xc.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    status = lib.repro_selective_scan(
        _DTYPES[xc.dtype], xc.data_ptr(), proj.data_ptr(), None if z is None else z.data_ptr(),
        0 if z is None else z.stride(0), 0 if z is None else z.stride(1), a_log.data_ptr(),
        dt_bias.data_ptr(), d_skip.data_ptr(), None if h0 is None else h0.data_ptr(), out.data_ptr(),
        h_last.data_ptr(), bsz, s, d, n, stream)
    _build.check(lib, status, "selective_scan")
    selective_scan.launches += 1
    selective_scan.launches_step += s == 1
    return out, h_last


selective_scan.launches = 0  # kernel launches (CPU calls do not count)
selective_scan.launches_step = 0  # the same at S = 1 (decode steps)
