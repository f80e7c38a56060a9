"""K6's backward (``kernels/selective_scan``) on the CPU: the plain
``selective_scan_bwd`` against ``jax.vjp`` of the reference's scan region,
the autograd Function's wiring, ``mamba_apply``'s gradients against
``jax.vjp`` of the reference's ``mamba_apply``, and, in bf16, the plain
backward against torch autograd through the plain forward.

Inputs are numpy-seeded and handed to both sides.  Tolerances, each with
its reason:

* f32 (the plain backward, the Function and ``mamba_apply``): 1e-5 of the
  reference's largest |value| per gradient — the same arithmetic, summed
  in another order (the tree scans, the reverse scan on the flipped time
  axis against the reference's transposed ``associative_scan``);
* bf16: each gradient within one bf16 step (2^-7) of the largest |value|
  of autograd's: the plain backward rounds where autograd does (the gate
  in bf16, the rest in f32 rounded once), but sums in another order.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as RS  # noqa: E402
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.selective_scan import plain as scan_plain  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

RTOL = 1e-5
BF16_RTOL = 2**-7
NAMES = ("dxc", "dproj", "da_log", "ddt_bias", "dd_skip", "dh0", "dz")
D_MODEL, CONV = 24, 4


def _close(name, got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if scale == 0.0:  # d a_log at S = 1 from a zero state: h_{t-1} = 0 everywhere
        assert err == 0.0, (name, err)
        return
    assert 1e-6 < scale < 1e6, (name, scale)
    assert err <= rtol * scale, (name, err / scale)


def _inputs(b, s, d, n, seed):
    """K6's operands (as ``mamba_apply`` hands them over) and the
    cotangents of its two outputs, all random."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (scale * rng.normal(size=shape)).astype(np.float32)
    return dict(xc=f(b, s, d), proj=f(b, s, 2 * n + 1), a_log=f(d, n, scale=0.5), dt_bias=f(d),
                d_skip=f(d), h0=f(b, d, n), z=f(b, s, d), dout=f(b, s, d), dh_last=f(b, d, n))


def _reference_region(xc, proj, a_log, dt_bias, d_skip, h0, z, chunk, gated):
    """The reference's scan region from the x_proj output to the gated rows:
    ``mamba_step``'s elementwise at S = 1 (``repro.models.ssm`` :129-136),
    else ``mamba_apply``'s (:93-112) through ``_ssm_scan_chunked``
    -> (out, h_last)."""
    b, s, d = xc.shape
    n = a_log.shape[1]
    bmat, cmat, dt_raw = jnp.split(proj, [n, 2 * n], axis=-1)
    dt = jax.nn.softplus(dt_raw + dt_bias.mean())  # (B, S, 1)
    a = -jnp.exp(a_log)
    skip = d_skip * xc
    if s == 1:
        db = dt[:, 0, :, None] * bmat[:, 0, None, :] * xc[:, 0, :, None]
        h_last = jnp.exp(dt[:, 0, :, None] * a) * h0 + db
        y = (jnp.einsum("bdn,bn->bd", h_last, cmat[:, 0]) + skip[:, 0])[:, None]
    else:
        da = jnp.exp(dt[..., None] * a)
        db = dt[..., None] * bmat[:, :, None, :] * xc[..., None]
        pad = (-s) % chunk
        if pad:
            da = jnp.pad(da, ((0, 0), (0, pad), (0, 0), (0, 0)), constant_values=1.0)
            db = jnp.pad(db, ((0, 0), (0, pad), (0, 0), (0, 0)))
        hs, h_last = RS._ssm_scan_chunked(da, db, h0, chunk)
        y = jnp.einsum("bsdn,bsn->bsd", hs[:, :s], cmat) + skip
    return (y * jax.nn.silu(z) if gated else y), h_last


def _reference_grads(inp, chunk, with_h0, gated):
    """jax.vjp of the region over (xc, proj, a_log, dt_bias, d_skip, h0, z)
    with the cotangents (dout, dh_last); h0 is zeros without ``with_h0``."""
    args = [jnp.asarray(inp[k]) for k in ("xc", "proj", "a_log", "dt_bias", "d_skip", "h0", "z")]
    if not with_h0:
        args[5] = jnp.zeros_like(args[5])
    _, vjp = jax.vjp(lambda *a: _reference_region(*a, chunk, gated), *args)
    return vjp((jnp.asarray(inp["dout"]), jnp.asarray(inp["dh_last"])))


def _port_args(inp, with_h0, gated, dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    for k in ("xc", "proj", "z"):
        t[k] = t[k].to(dtype)
    return (t["xc"], t["proj"], t["a_log"], t["dt_bias"], t["d_skip"], t["h0"] if with_h0 else None,
            t["z"] if gated else None)


_CASES = [pytest.param(s, chunk, h0, n, gated, id=f"{s}-{chunk}-{h0}-n{n}-{'gated' if gated else 'y'}")
          for s, chunk in [(1, 256), (37, 16), (130, 64), (130, 256)] for h0 in (False, True) for n in (8, 16)
          for gated in (False, True)]


@pytest.mark.parametrize("s,chunk,with_h0,n,gated", _CASES)
def test_plain_backward_matches_reference_vjp(s, chunk, with_h0, n, gated):
    """S = 1 (a decode step), 37 and 130 (ragged against the chunk), chunks
    16/64/256, with and without h0, 8 and 16 states, gated and
    ``z=None``; a cotangent on h_last too."""
    inp = _inputs(2, s, 12, n, seed=s + n + 7 * chunk)
    want = _reference_grads(inp, chunk, with_h0, gated)
    args = _port_args(inp, with_h0, gated)
    dout = torch.from_numpy(inp["dout"])
    got = scan_plain.selective_scan_bwd(*args, dout, torch.from_numpy(inp["dh_last"]), chunk)
    assert (got[5] is None) == (not with_h0) and (got[6] is None) == (not gated)
    for name, g, w, arg in zip(NAMES, got, want, args):
        if arg is not None:
            assert g.dtype == arg.dtype
            _close(name, g, w)


def test_function_on_the_cpu_runs_the_plain_backward():
    """Under grad the wrapper runs as ``SelectiveScan``: its gradients are
    the plain backward's, an input that does not require grad gets None
    from its backward; under no_grad there is no graph; CPU calls launch
    nothing."""
    inp = _inputs(2, 37, 12, 8, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in _port_args(inp, True, True)]
    before = (scan_ops.selective_scan.launches, scan_ops.selective_scan_bwd.launches)
    out, h_last = scan_ops.selective_scan(*leaves, chunk=16)
    assert type(out.grad_fn).__name__ == "SelectiveScanBackward" and h_last.grad_fn is out.grad_fn
    cot = (torch.from_numpy(inp["dout"]), torch.from_numpy(inp["dh_last"]))
    grads = torch.autograd.grad((out, h_last), leaves, cot)
    with torch.no_grad():
        want = scan_plain.selective_scan_bwd(*leaves, *cot, chunk=16)
    for name, g, w in zip(NAMES, grads, want):
        assert torch.equal(g, w), name
    # only h_last used: dout is zeros
    g_h = torch.autograd.grad(scan_ops.selective_scan(*leaves, chunk=16)[1], leaves[0], cot[1])[0]
    with torch.no_grad():
        want_h = scan_plain.selective_scan_bwd(*leaves, torch.zeros_like(cot[0]), cot[1], chunk=16)[0]
    assert torch.equal(g_h, want_h)
    # only xc requires grad: the backward returns None for every other input
    xc = leaves[0].detach().requires_grad_(True)
    out, _ = scan_ops.selective_scan(xc, *(t.detach() for t in leaves[1:]), chunk=16)
    back = out.grad_fn.apply(cot[0], None)
    assert back[0] is not None and all(g is None for g in back[1:])
    with torch.no_grad():
        out, h_last = scan_ops.selective_scan(*leaves, chunk=16)
    assert out.grad_fn is None and h_last.grad_fn is None
    assert (scan_ops.selective_scan.launches, scan_ops.selective_scan_bwd.launches) == before


def _mamba(seed=0):
    """The reference's Mamba with dt_bias, a_log and d_skip random too, and
    the port's on the same leaves, each requiring grad."""
    params = jax.tree.map(np.asarray, RS.mamba_init(jax.random.PRNGKey(seed), D_MODEL, 2 * D_MODEL, 8, CONV))
    rng = np.random.default_rng(seed + 100)
    params["dt_bias"] = rng.normal(size=params["dt_bias"].shape).astype(np.float32)
    params["a_log"] = (params["a_log"] + 0.1 * rng.normal(size=params["a_log"].shape)).astype(np.float32)
    params["d_skip"] = rng.normal(size=params["d_skip"].shape).astype(np.float32)
    port = T.Mamba(D_MODEL, 2 * D_MODEL, 8, CONV, torch.float32, "cpu")
    with torch.no_grad():
        for name, w in port.named_parameters():
            w.copy_(torch.from_numpy(np.array(params[name], np.float32)))
            w.requires_grad_(True)
    return params, port


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "init_state"])
def test_mamba_apply_gradients_match_reference(with_state):
    """Every Mamba leaf's gradient and x's, through the whole layer (in_proj,
    the conv, x_proj, K6, out_proj), S = 37 over chunks of 16, cotangents
    on y, h_last and conv_state; with ``init_state``/``conv_init`` their
    gradients too."""
    params, port = _mamba()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37, D_MODEL)).astype(np.float32)
    init = {}
    if with_state:
        init = dict(init_state=rng.normal(size=(2, 2 * D_MODEL, 8)).astype(np.float32),
                    conv_init=rng.normal(size=(2, CONV - 1, 2 * D_MODEL)).astype(np.float32))
    cot = (rng.normal(size=(2, 37, D_MODEL)).astype(np.float32),
           rng.normal(size=(2, 2 * D_MODEL, 8)).astype(np.float32),
           rng.normal(size=(2, CONV - 1, 2 * D_MODEL)).astype(np.float32))
    names = list(params)

    def ref(p, xx, kw):
        y, (h, conv) = RS.mamba_apply(p, xx, 8, chunk=16, **kw)
        return y, h, conv

    _, vjp = jax.vjp(ref, jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                     {k: jnp.asarray(v) for k, v in init.items()})
    g_params, g_x, g_init = vjp(tuple(jnp.asarray(c) for c in cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    kw = {k: torch.from_numpy(v).requires_grad_(True) for k, v in init.items()}
    y, (h, conv) = ssm.mamba_apply(port, xt, 8, chunk=16, **kw)
    leaves = [dict(port.named_parameters())[k] for k in names]
    grads = torch.autograd.grad((y, h, conv), [*leaves, xt, *kw.values()],
                                tuple(torch.from_numpy(c) for c in cot))
    for name, g in zip(names, grads):
        _close(name, g, g_params[name])
    _close("x", grads[len(names)], g_x)
    for (name, g) in zip(kw, grads[len(names) + 1:]):
        _close(name, g, g_init[name])


@pytest.mark.parametrize("with_h0,gated", [(False, True), (True, True), (False, False), (True, False)])
def test_plain_backward_bf16_matches_autograd(with_h0, gated):
    """In bf16 (xc, proj, z and the gated out), the plain backward against
    torch autograd through the plain forward: the gate's roundings where
    autograd's are, each gradient within one bf16 step of its largest
    |value|."""
    inp = _inputs(2, 37, 16, 8, seed=11)
    leaves = [t if t is None else t.clone().requires_grad_(True)
              for t in _port_args(inp, with_h0, gated, torch.bfloat16)]
    out, h_last = scan_plain.selective_scan(*leaves, 16)
    dout = torch.from_numpy(inp["dout"]).to(out.dtype)
    dh_last = torch.from_numpy(inp["dh_last"])
    used = [t for t in leaves if t is not None]
    want = iter(torch.autograd.grad((out, h_last), used, (dout, dh_last)))
    with torch.no_grad():
        got = scan_plain.selective_scan_bwd(*leaves, dout, dh_last, 16)
    for name, g, leaf in zip(NAMES, got, leaves):
        if leaf is None:
            assert g is None
            continue
        w = next(want)
        assert g.dtype == w.dtype == leaf.dtype
        _close(name, g.float(), w.float(), BF16_RTOL)


def test_backward_takes_expanded_cotangents_to_the_kernel(monkeypatch):
    """A loss such as ``h_last.sum()`` hands the backward an expanded (stride
    0) dh_last, and ``out.sum()`` an expanded dout: on the card's branch
    both are copied before the kernel's contiguity checks, so the call
    reaches the library (meta tensors stand in for the card's; the device
    check and the library are stubbed)."""
    class Reached(Exception):
        pass

    def library():
        raise Reached

    monkeypatch.setattr(scan_ops, "_check_device", lambda *a: None)
    monkeypatch.setattr(scan_ops, "state_chunk", lambda: 8)
    monkeypatch.setattr(scan_ops._build, "load_library", library)
    b, s, d, n, bf16, f32 = 2, 37, 16, 8, torch.bfloat16, torch.float32
    meta = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    args = (meta(b, s, d, dtype=bf16), meta(b, s, 2 * n + 1, dtype=bf16), meta(d, n), meta(d), meta(d), meta(b, d, n),
            meta(b, s, d, dtype=bf16))
    dout = meta(1, 1, 1, dtype=bf16).expand(b, s, d)
    dh_last = meta(1, 1, 1).expand(b, d, n)
    assert 0 in dout.stride() and 0 in dh_last.stride()
    with pytest.raises(Reached):
        scan_ops.selective_scan_bwd(*args, dout, dh_last, meta(b, -(-s // 8), d, n))


def _meta_card(monkeypatch, lib):
    """The card's branch of the wrapper on meta tensors: the device check
    passes, the library is ``lib``, a state every 8 steps (the kernels'
    ``kStateStride``), stream 0; launches counted on the card are put back
    after the test."""
    monkeypatch.setattr(scan_ops, "_check_device", lambda *a: None)
    monkeypatch.setattr(scan_ops, "state_chunk", lambda: 8)
    monkeypatch.setattr(scan_ops._build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(scan_ops.selective_scan, "launches", scan_ops.selective_scan.launches)
    monkeypatch.setattr(scan_ops.selective_scan, "launches_step", scan_ops.selective_scan.launches_step)
    monkeypatch.setattr(scan_ops.selective_scan_bwd, "launches", scan_ops.selective_scan_bwd.launches)


def _meta_args(b, s, d, n, dtype=torch.bfloat16):
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    return (meta(b, s, d, dtype=dtype), meta(b, s, 2 * n + 1, dtype=dtype), meta(d, n), meta(d), meta(d),
            meta(b, d, n), meta(b, s, d, dtype=dtype))


@pytest.mark.parametrize("s", [16, 17, 37, 130])
def test_forward_keeps_a_state_every_state_chunk_steps(monkeypatch, s):
    """Under grad the forward keeps h_chunks, the state entering each
    ``state_chunk()`` steps (8: S = 17 keeps 3, a last state for one step),
    and hands them to the kernel; serving keeps none."""
    calls = []

    def scan(*a):
        calls.append(a)
        return 0

    _meta_card(monkeypatch, types.SimpleNamespace(repro_selective_scan=scan))
    b, d, n = 2, 16, 8
    args = _meta_args(b, s, d, n)
    out, h_last, h_chunks = scan_ops._forward(*args, 256, with_chunks=True)
    assert tuple(h_chunks.shape) == (b, -(-s // 8), d, n) and h_chunks.dtype == torch.float32
    assert calls[-1][12] is not None  # the h_chunks pointer (0 on meta tensors; None means none)
    assert tuple(out.shape) == (b, s, d) and tuple(h_last.shape) == (b, d, n)
    assert scan_ops._forward(*args, 256, with_chunks=False)[2] is None and calls[-1][12] is None


def test_backward_takes_states_only_at_the_kernels_stride(monkeypatch):
    """h_chunks at another stride than ``state_chunk()`` (32 steps, as the
    kernels once kept them) is refused before the library is reached."""
    def library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(scan_ops, "_check_device", lambda *a: None)
    monkeypatch.setattr(scan_ops, "state_chunk", lambda: 8)
    monkeypatch.setattr(scan_ops._build, "load_library", library)
    b, s, d, n = 2, 37, 16, 8
    args = _meta_args(b, s, d, n)
    dout = torch.empty((b, s, d), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="h_chunks"):
        scan_ops.selective_scan_bwd(*args, dout, None, torch.empty((b, -(-s // 32), d, n), device="meta"))


def test_backward_takes_the_scratch_the_library_names(monkeypatch):
    """The backward's f32 scratch (the partial rows of the cluster sums, the
    parameter partials) is as large as the library says at the call's
    sizes, and the kernel gets the h_chunks it was given."""
    sizes, calls, made = [], [], []

    def scratch(*a):
        sizes.append(a)
        return 1234

    def bwd(*a):
        calls.append(a)
        return 0

    _meta_card(monkeypatch, types.SimpleNamespace(repro_selective_scan_bwd_scratch=scratch,
                                                  repro_selective_scan_bwd=bwd))
    empty = torch.empty

    def recorded(*shape, **kw):
        made.append((shape, kw.get("dtype")))
        return empty(*shape, **kw)

    b, s, d, n = 3, 37, 16, 16
    args = _meta_args(b, s, d, n)
    dout = torch.empty((b, s, d), dtype=torch.bfloat16, device="meta")
    h_chunks = torch.empty((b, -(-s // 8), d, n), device="meta")
    monkeypatch.setattr(torch, "empty", recorded)
    grads = scan_ops.selective_scan_bwd(*args, dout, None, h_chunks)
    monkeypatch.setattr(torch, "empty", empty)
    assert sizes == [(b, s, d, n)] and len(calls) == 1
    assert ((1234,), torch.float32) in made
    assert [tuple(g.shape) for g in grads] == [(b, s, d), (b, s, 2 * n + 1), (d, n), (d,), (d,), (b, d, n),
                                               (b, s, d)]
