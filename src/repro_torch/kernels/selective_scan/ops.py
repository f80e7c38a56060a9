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

Gradients.  When grad mode is on and an input requires grad,
:func:`selective_scan` runs as :class:`SelectiveScan`, a
``torch.autograd.Function``: its forward is K6 writing ``h_chunks`` too,
the state entering each chunk of the kernels' steps (:func:`state_chunk`),
saved with the inputs; its
backward is :func:`selective_scan_bwd`, K6's backward
(``csrc/selective_scan_bwd.cu``), which walks each chunk again from its
state.  On CPU tensors each half runs its plain version, so the CPU tests
drive the same wiring.  Otherwise (serving) the forward keeps no states.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan import plain

NSTATES = (8, 16)  # the kernel's template instances: hymba-1.5b's 16, its smoke config's 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(t: torch.Tensor, dims: tuple[int, ...]) -> bool:
    """``t`` starts on 16 bytes and steps whole 16 bytes along ``dims``
    (where they hold more than one row): the kernel's 16-byte copies."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(t.shape[i] == 1 or t.stride(i) * es % 16 == 0 for i in dims)


def _check(xc, proj, a_log, dt_bias, d_skip, h0, z) -> None:
    """Shapes, dtypes and devices."""
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


def _check_device(xc: torch.Tensor, n: int, what: str) -> None:
    """What the kernels take beyond :func:`_check`: cuda tensors, N in
    :data:`NSTATES`, at most 65535 sequences."""
    if xc.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {xc.device}")
    if n not in NSTATES:
        raise ValueError(f"the kernel takes N in {NSTATES} states, got {n}")
    if xc.shape[0] > 65535:
        raise ValueError(f"at most 65535 sequences per launch, got {xc.shape[0]}")


def _check_rows(what: str, dense: list, vectors: list, z: torch.Tensor | None, d: int, itemsize: int) -> None:
    """The kernels' 16-byte copies and loads: ``dense`` contiguous,
    ``vectors`` 16-byte aligned, z unit stride along D with 16-byte rows,
    D * itemsize a multiple of 16."""
    if not all(t.is_contiguous() for t in dense) or (z is not None and z.stride(2) != 1):
        raise ValueError(f"{what} needs contiguous operands (z: unit stride along D)")
    if d * itemsize % 16 or not all(_aligned(t, ()) for t in vectors) or (
            z is not None and not _aligned(z, (0, 1))):
        raise ValueError(f"{what} reads rows of x and z, a_log, dt_bias and the states 16 bytes at a time: "
                         "D * itemsize must be a multiple of 16 and each must start 16-byte aligned")


def state_chunk() -> int:
    """Steps per state of ``h_chunks``: ``kChunk`` of
    ``csrc/selective_scan.cuh``, which both kernels stride by, as the
    library reports it (loads the library: card only)."""
    return _build.load_library().repro_selective_scan_chunk()


def _check_extra(extra: dict, device) -> None:
    """Each ``name: (tensor, shape, dtype)`` of the backward's operands."""
    for name, (t, shape, dtype) in extra.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
            raise ValueError(f"{name} must be {shape} {dtype} on {device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def _forward(xc, proj, a_log, dt_bias, d_skip, h0, z, chunk: int, with_chunks: bool):
    """-> (out, h_last, h_chunks or None): the plain version on CPU tensors
    (no h_chunks), else K6, with ``with_chunks`` also writing h_chunks
    (B, ceil(S / state_chunk()), D, N) f32, the state entering each chunk."""
    _check(xc, proj, a_log, dt_bias, d_skip, h0, z)
    if xc.device.type == "cpu":
        return (*plain.selective_scan(xc, proj, a_log, dt_bias, d_skip, h0, z, chunk), None)
    bsz, s, d = xc.shape
    n = a_log.shape[1]
    _check_device(xc, n, "selective_scan")
    h0s = [] if h0 is None else [h0]
    _check_rows("selective_scan", [xc, proj, a_log, dt_bias, d_skip, *h0s], [xc, a_log, dt_bias, *h0s], z, d,
                xc.element_size())
    f32 = torch.float32
    out = torch.empty((bsz, s, d), dtype=f32 if z is None else xc.dtype, device=xc.device)
    h_last = torch.empty((bsz, d, n), dtype=f32, device=xc.device)
    lib = _build.load_library()
    h_chunks = None
    if with_chunks:
        h_chunks = torch.empty((bsz, -(-s // state_chunk()), d, n), dtype=f32, device=xc.device)
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    status = lib.repro_selective_scan(
        _DTYPES[xc.dtype], xc.data_ptr(), proj.data_ptr(), None if z is None else z.data_ptr(),
        0 if z is None else z.stride(0), 0 if z is None else z.stride(1), a_log.data_ptr(),
        dt_bias.data_ptr(), d_skip.data_ptr(), None if h0 is None else h0.data_ptr(), out.data_ptr(),
        h_last.data_ptr(), None if h_chunks is None else h_chunks.data_ptr(), bsz, s, d, n, stream)
    _build.check(lib, status, "selective_scan")
    selective_scan.launches += 1
    selective_scan.launches_step += s == 1
    return out, h_last, h_chunks


class SelectiveScan(torch.autograd.Function):
    """K6 with a gradient: forward keeping ``h_chunks``, backward K6's
    backward (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, xc, proj, a_log, dt_bias, d_skip, h0, z, chunk: int):
        out, h_last, h_chunks = _forward(xc, proj, a_log, dt_bias, d_skip, h0, z, chunk, with_chunks=True)
        ctx.save_for_backward(xc, proj, a_log, dt_bias, d_skip, h0, z, h_chunks)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused h_last gives None, not a zero tensor
        return out, h_last

    @staticmethod
    def backward(ctx, dout, dh_last):
        xc, proj, a_log, dt_bias, d_skip, h0, z, h_chunks = ctx.saved_tensors
        if dout is None:
            if dh_last is None:
                return (None,) * 8
            dout = torch.zeros(xc.shape, dtype=torch.float32 if z is None else z.dtype, device=xc.device)
        grads = selective_scan_bwd(xc, proj, a_log, dt_bias, d_skip, h0, z, dout, dh_last, h_chunks,
                                   ctx.chunk)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


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
    walks the steps in order and takes no chunk).  Under grad mode with an
    input that requires grad it runs as :class:`SelectiveScan` (backward
    K6's backward)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (xc, proj, a_log, dt_bias, d_skip, h0, z)):
        return SelectiveScan.apply(xc, proj, a_log, dt_bias, d_skip, h0, z, chunk)
    return _forward(xc, proj, a_log, dt_bias, d_skip, h0, z, chunk, with_chunks=False)[:2]


selective_scan.launches = 0  # kernel launches (CPU calls do not count)
selective_scan.launches_step = 0  # the same at S = 1 (decode steps)


def selective_scan_bwd(
    xc: torch.Tensor,  # (B, S, D) f32 or bf16
    proj: torch.Tensor,  # (B, S, 2N + 1) xc's dtype
    a_log: torch.Tensor,  # (D, N) f32
    dt_bias: torch.Tensor,  # (D,) f32
    d_skip: torch.Tensor,  # (D,) f32
    h0: torch.Tensor | None,  # (B, D, N) f32; None: zeros (no dh0)
    z: torch.Tensor | None,  # (B, S, D) xc's dtype: the gate; None: no gate (no dz)
    dout: torch.Tensor,  # (B, S, D): the gradient of out (xc's dtype with z, f32 without)
    dh_last: torch.Tensor | None = None,  # (B, D, N) f32: the gradient of h_last; None: zeros
    h_chunks: torch.Tensor | None = None,  # (B, ceil(S / state_chunk()), D, N) f32: the forward's (cuda only)
    chunk: int = 256,
) -> tuple:
    """K6's backward -> (dxc, dproj, da_log, ddt_bias, dd_skip, dh0 or
    None, dz or None): dxc, dproj and dz in xc's dtype (dz contiguous, in
    z's shape), the rest f32.  The gate's backward rounds where autograd
    of ``y.to(T) * F.silu(z)`` does; sums run in f32 and in a fixed order
    (no atomics: the same result from run to run).

    On CUDA tensors this launches ``csrc/selective_scan_bwd.cu`` (the
    walks per chunk, then the sums over channel blocks into d proj, then
    the parameter sums) on the current stream from ``h_chunks``, the
    forward's saved states; on CPU tensors it runs the plain backward
    (which recomputes the states, with ``chunk`` steps a tree)."""
    _check(xc, proj, a_log, dt_bias, d_skip, h0, z)
    bsz, s, d = xc.shape
    n = a_log.shape[1]
    f32 = torch.float32
    extra = {"dout": (dout, (bsz, s, d), f32 if z is None else xc.dtype)}
    if dh_last is not None:
        extra["dh_last"] = (dh_last, (bsz, d, n), f32)
    _check_extra(extra, xc.device)
    if xc.device.type == "cpu":
        return plain.selective_scan_bwd(xc, proj, a_log, dt_bias, d_skip, h0, z, dout, dh_last, chunk)
    _check_device(xc, n, "selective_scan_bwd")
    if h_chunks is None:
        raise ValueError("selective_scan_bwd on the card walks from the forward's h_chunks: pass them")
    _check_extra({"h_chunks": (h_chunks, (bsz, -(-s // state_chunk()), d, n), f32)}, xc.device)
    # autograd may hand either cotangent over expanded (a sum's gradient: stride 0)
    dout = dout.contiguous()
    dh_last = None if dh_last is None else dh_last.contiguous()
    states = [h_chunks] + ([] if dh_last is None else [dh_last])
    _check_rows("selective_scan_bwd", [xc, proj, a_log, dt_bias, d_skip, dout, *states],
                [xc, a_log, dt_bias, dout, *states], z, d, xc.element_size())
    lib = _build.load_library()
    scratch = torch.empty(lib.repro_selective_scan_bwd_scratch(bsz, s, d, n), dtype=f32, device=xc.device)
    dxc = torch.empty_like(xc)
    dproj = torch.empty_like(proj)
    dz = None if z is None else torch.empty((bsz, s, d), dtype=xc.dtype, device=xc.device)
    da_log, ddt_bias, dd_skip = torch.empty_like(a_log), torch.empty_like(dt_bias), torch.empty_like(d_skip)
    dh0 = None if h0 is None else torch.empty((bsz, d, n), dtype=f32, device=xc.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    status = lib.repro_selective_scan_bwd(
        _DTYPES[xc.dtype], xc.data_ptr(), proj.data_ptr(), ptr(z), 0 if z is None else z.stride(0),
        0 if z is None else z.stride(1), dout.data_ptr(), a_log.data_ptr(), dt_bias.data_ptr(),
        d_skip.data_ptr(), h_chunks.data_ptr(), ptr(dh_last), scratch.data_ptr(), dxc.data_ptr(),
        dproj.data_ptr(), ptr(dz), da_log.data_ptr(), ddt_bias.data_ptr(), dd_skip.data_ptr(), ptr(dh0),
        bsz, s, d, n, stream)
    _build.check(lib, status, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return dxc, dproj, da_log, ddt_bias, dd_skip, dh0, dz


# calls that launched the backward (its three kernels each; CPU calls do not count)
selective_scan_bwd.launches = 0
