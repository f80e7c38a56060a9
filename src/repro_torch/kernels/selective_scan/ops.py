"""Selective scan (K6): the wrapper around ``csrc/selective_scan.cu``.

Mamba's recurrence (``models/ssm.py``): for each (sequence, channel d,
state n), ``h_t = exp(dt_t a[d,n]) h_{t-1} + dt_t B[t,n] x[t,d]`` and
``y[t,d] = Σ_n h_t C[t,n] + d_skip[d] x[t,d]``.  ``mamba_apply`` calls it
once over the whole prompt and ``mamba_step`` with S = 1, so a decode
step launches one per hybrid layer.  It stands for the reference's
plain-JAX scan (``repro.models.ssm._ssm_scan_chunked`` and the
elementwise around it), not for a TPU kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan import plain

NSTATES = (8, 16)  # the kernel's template instances: hymba-1.5b's 16, its smoke config's 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def selective_scan(
    xc: torch.Tensor,  # (B, S, D) f32 or bf16, read as f32
    dt: torch.Tensor,  # (B, S) f32
    bmat: torch.Tensor,  # (B, S, N) f32
    cmat: torch.Tensor,  # (B, S, N) f32
    a: torch.Tensor,  # (D, N) f32: -exp(a_log)
    d_skip: torch.Tensor,  # (D,) f32
    h0: torch.Tensor | None = None,  # (B, D, N) f32; None: zeros
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, S, D) f32, h_last (B, D, N) f32).

    On CUDA tensors this launches ``csrc/selective_scan.cu`` on the current
    stream (and raises if it cannot); on CPU tensors it runs the plain
    version, whose tree scan takes ``chunk`` steps at a time (the kernel
    walks the steps in order and takes no chunk)."""
    if xc.dim() != 3:
        raise ValueError(f"xc must be (B, S, D), got {tuple(xc.shape)}")
    bsz, s, d = xc.shape
    if a.dim() != 2 or a.shape[0] != d:
        raise ValueError(f"a must be (D={d}, N), got {tuple(a.shape)}")
    n = a.shape[1]
    if s < 1 or bsz < 1:
        raise ValueError(f"an empty scan: xc {tuple(xc.shape)}")
    if xc.dtype not in _DTYPES:
        raise TypeError(f"xc must be float32 or bfloat16, got {xc.dtype}")
    shapes = {"dt": (dt, (bsz, s)), "bmat": (bmat, (bsz, s, n)), "cmat": (cmat, (bsz, s, n)),
              "a": (a, (d, n)), "d_skip": (d_skip, (d,))}
    if h0 is not None:
        shapes["h0"] = (h0, (bsz, d, n))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != xc.device:
            raise ValueError(f"{name} on {t.device} but xc on {xc.device}")
    if xc.device.type == "cpu":
        return plain.selective_scan(xc, dt, bmat, cmat, a, d_skip, h0, chunk)
    if xc.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu tensors, got {xc.device}")
    if n not in NSTATES:
        raise ValueError(f"the kernel takes N in {NSTATES} states, got {n}")
    if bsz > 65535:
        raise ValueError(f"at most 65535 sequences per launch, got {bsz}")
    operands = [xc, *(t for t, _ in shapes.values())]
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("selective_scan needs contiguous operands")
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=xc.device)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=xc.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    status = lib.repro_selective_scan(
        _DTYPES[xc.dtype], xc.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), d_skip.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), bsz, s, d, n, stream)
    _build.check(lib, status, "selective_scan")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0  # kernel launches (CPU calls do not count)
