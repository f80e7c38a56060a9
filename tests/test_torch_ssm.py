"""The port's state-space and recurrent blocks (``models/ssm.py``) and the
two stacks built on them — hymba-1.5b (attention + Mamba) and xlstm-125m
(mLSTM + sLSTM) — against the reference on the CPU, on the same weights
(the reference's ``*_init`` / ``init_lm`` carried across as numpy) and the
same seeded numpy inputs.  K6 (``kernels/selective_scan``) runs its plain
version here.

Tolerance: f32 throughout, ``RTOL`` 1e-5 of the reference's largest
|value| — the same arithmetic, summed in another order (the plain scan's
Hillis–Steele tree against ``lax.associative_scan``'s, torch's matmuls
against XLA's) over a few layers at most.  Serve ids are compared
exactly, per request uid.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import decode as RD  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.selective_scan import ops as scan_ops  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

RTOL = 1e-5
ARCHS = ["hymba-1.5b", "xlstm-125m"]
D_MODEL, N_STATE, CONV, HEADS = 24, 8, 4, 4


def _close(got, want, rtol=RTOL, vocab=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert 1e-3 < scale < 1e6, scale
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _load(module, tree: dict):
    """``module``'s parameters from the reference's (nested) dict of arrays."""
    with torch.no_grad():
        for name, w in module.named_parameters():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            w.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return module


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mamba(seed=0):
    """A reference Mamba whose dt_bias, a_log and d_skip are random too (so
    a per-channel dt, say, would show), and the port's on the same leaves."""
    params = _np(RS.mamba_init(jax.random.PRNGKey(seed), D_MODEL, 2 * D_MODEL, N_STATE, CONV))
    rng = np.random.default_rng(seed + 100)
    params["dt_bias"] = rng.normal(size=params["dt_bias"].shape).astype(np.float32)
    params["a_log"] = (params["a_log"] + 0.1 * rng.normal(size=params["a_log"].shape)).astype(np.float32)
    params["d_skip"] = rng.normal(size=params["d_skip"].shape).astype(np.float32)
    port = _load(T.Mamba(D_MODEL, 2 * D_MODEL, N_STATE, CONV, torch.float32, "cpu"), params)
    return jax.tree.map(jnp.asarray, params), port


# ------------------------------------------------------------------ Mamba
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "init_state"])
def test_mamba_apply_matches_reference(with_state):
    """S = 37 over chunks of 16: a ragged last chunk, padded with da = 1,
    db = 0, so h_last is the state at the last real token."""
    jp, port = _mamba()
    x = _x(2, 37, D_MODEL, seed=1)
    init = dict(init_state=_x(2, 2 * D_MODEL, N_STATE, seed=2), conv_init=_x(2, CONV - 1, 2 * D_MODEL, seed=3))
    kw = init if with_state else {}
    y_ref, (h_ref, conv_ref) = RS.mamba_apply(jp, jnp.asarray(x), N_STATE, chunk=16,
                                              **{k: jnp.asarray(v) for k, v in kw.items()})
    y, (h, conv) = ssm.mamba_apply(port, torch.from_numpy(x), N_STATE, chunk=16,
                                   **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(y, y_ref)
    _close(h, h_ref)
    _close(conv, conv_ref)  # the last pre-conv inputs (rows of x @ in_proj)


def test_mamba_step_chained_after_apply():
    jp, port = _mamba(seed=4)
    x = _x(3, 11, D_MODEL, seed=5)
    _, (h_ref, conv_ref) = RS.mamba_apply(jp, jnp.asarray(x[:, :8]), N_STATE, chunk=16)
    _, (h, conv) = ssm.mamba_apply(port, torch.from_numpy(x[:, :8]), N_STATE, chunk=16)
    for t in range(8, 11):
        y_ref, (h_ref, conv_ref) = RS.mamba_step(jp, jnp.asarray(x[:, t]), h_ref, conv_ref, N_STATE)
        y, (h, conv) = ssm.mamba_step(port, torch.from_numpy(x[:, t]), h, conv, N_STATE)
        _close(y, y_ref)
        _close(h, h_ref)
        _close(conv, conv_ref)


# ------------------------------------------------------------------ K6
def _scan_inputs(b, s, d, n, seed):
    """K6's operands as ``mamba_apply`` hands them over: the x_proj output
    ``proj`` (B, C, dt_raw), the conv output ``xc``, the gate ``z``, and
    Mamba's f32 leaves, all random (so a per-channel dt would show)."""
    rng = np.random.default_rng(seed)
    return dict(
        xc=rng.normal(size=(b, s, d)).astype(np.float32),
        proj=rng.normal(size=(b, s, 2 * n + 1)).astype(np.float32),
        z=rng.normal(size=(b, s, d)).astype(np.float32),
        a_log=(rng.normal(size=(d, n)) * 0.5).astype(np.float32),
        dt_bias=rng.normal(size=(d,)).astype(np.float32),
        d_skip=rng.normal(size=(d,)).astype(np.float32),
        h0=rng.normal(size=(b, d, n)).astype(np.float32),
    )


def _reference_scan(inp, chunk, with_h0, gated):
    """The reference's elementwise and scan on these operands: ``mamba_step``
    (``repro.models.ssm`` :129-136) at S = 1, else ``mamba_apply``
    (:93-112) through ``_ssm_scan_chunked``; with ``gated`` the output is
    ``y silu(z)``, as both compute it before ``out_proj``."""
    xc, proj, z = (jnp.asarray(inp[k]) for k in ("xc", "proj", "z"))
    b, s, d = xc.shape
    n = inp["a_log"].shape[1]
    bmat, cmat, dt_raw = jnp.split(proj.astype(jnp.float32), [n, 2 * n], axis=-1)
    dt = jax.nn.softplus(dt_raw + jnp.asarray(inp["dt_bias"]).mean())  # (B, S, 1)
    a = -jnp.exp(jnp.asarray(inp["a_log"]))
    h0 = jnp.asarray(inp["h0"]) if with_h0 else jnp.zeros((b, d, n), jnp.float32)
    skip = jnp.asarray(inp["d_skip"]) * xc
    if s == 1:
        da = jnp.exp(dt[:, 0, :, None] * a)  # (B, D_in, N)
        db = dt[:, 0, :, None] * bmat[:, 0, None, :] * xc[:, 0, :, None]
        h_last = da * h0 + db
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


_SCAN_CASES = [pytest.param(s, chunk, h0, N_STATE, False, id=f"{s}-{chunk}-{h0}")
               for s, chunk, h0 in [(37, 16, False), (37, 16, True), (1, 256, True), (64, 256, False)]]
_SCAN_CASES += [pytest.param(s, chunk, h0, n, gated, id=f"{s}-{chunk}-{h0}-n{n}-{'gated' if gated else 'y'}")
                for s, chunk in [(1, 256), (37, 16), (130, 64)] for h0 in (False, True) for n in (8, 16)
                for gated in (False, True) if (s, chunk, h0, n, gated) not in [(1, 256, True, N_STATE, False)]]


@pytest.mark.parametrize("s,chunk,with_h0,n,gated", _SCAN_CASES)
def test_selective_scan_matches_reference_scan(s, chunk, with_h0, n, gated):
    """K6's wrapper on CPU tensors (the plain version) against the
    reference from the x_proj output to the gated rows: S = 1 (a decode
    step), 37 and 130 (ragged against the chunk), with and without h0, 8
    and 16 states, gated and ``z=None``."""
    inp = _scan_inputs(2, s, 12, n, seed=s + n)
    y_ref, h_ref = _reference_scan(inp, chunk, with_h0, gated)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    before = (scan_ops.selective_scan.launches, scan_ops.selective_scan.launches_step)
    y, h = scan_ops.selective_scan(t["xc"], t["proj"], t["a_log"], t["dt_bias"], t["d_skip"],
                                   t["h0"] if with_h0 else None, t["z"] if gated else None, chunk)
    # CPU calls run the plain version, uncounted
    assert (scan_ops.selective_scan.launches, scan_ops.selective_scan.launches_step) == before
    assert y.dtype == h.dtype == torch.float32
    _close(y, y_ref)
    _close(h, h_ref)


def _bad(name):
    t = {k: torch.from_numpy(v) for k, v in _scan_inputs(2, 5, 12, N_STATE, seed=0).items()}
    if name == "xc_fp16":
        t["xc"] = t["xc"].half()
    elif name == "dt_fp64":  # dt_bias, which dt takes its mean from
        t["dt_bias"] = t["dt_bias"].double()
    elif name == "bmat_shape":  # proj, which holds B, over too few steps
        t["proj"] = t["proj"][:, :4]
    elif name == "proj_width":  # 2N columns: no dt_raw
        t["proj"] = t["proj"][..., :-1]
    elif name == "a_width":
        t["a_log"] = t["a_log"][:7]
    elif name == "h0_shape":
        t["h0"] = t["h0"][:1]
    elif name == "z_shape":
        t["z"] = t["z"][..., :6]
    elif name == "z_dtype":
        t["z"] = t["z"].to(torch.bfloat16)
    elif name == "xc_2d":
        t["xc"] = t["xc"][0]
    elif name == "meta_device":
        t = {k: v.to("meta") for k, v in t.items()}
    return t


@pytest.mark.parametrize("name,error", [("xc_fp16", TypeError), ("dt_fp64", TypeError),
                                        ("bmat_shape", ValueError), ("a_width", ValueError),
                                        ("h0_shape", ValueError), ("xc_2d", ValueError),
                                        ("meta_device", ValueError), ("proj_width", ValueError),
                                        ("z_shape", ValueError), ("z_dtype", TypeError)])
def test_selective_scan_wrapper_raises(name, error):
    t = _bad(name)
    with pytest.raises(error):
        scan_ops.selective_scan(t["xc"], t["proj"], t["a_log"], t["dt_bias"], t["d_skip"], t["h0"], t["z"])


# ------------------------------------------------------------------ xLSTM cells
def test_mlstm_apply_and_step_match_reference():
    """S = 37 over the reference's chunk of 128 (padded with f = 1, i = 0),
    then three steps from the state it leaves."""
    params = _np(RS.mlstm_init(jax.random.PRNGKey(6), D_MODEL, HEADS))
    jp, port = jax.tree.map(jnp.asarray, params), _load(T.MLSTM(D_MODEL, HEADS, torch.float32, "cpu"), params)
    x = _x(2, 40, D_MODEL, seed=7)
    y_ref, (c_ref, n_ref) = RS.mlstm_apply(jp, jnp.asarray(x[:, :37]), HEADS)
    y, (c, n) = ssm.mlstm_apply(port, torch.from_numpy(x[:, :37]), HEADS)
    _close(y, y_ref)
    _close(c, c_ref)
    _close(n, n_ref)
    for t in range(37, 40):
        y_ref, (c_ref, n_ref) = RS.mlstm_step(jp, jnp.asarray(x[:, t]), c_ref, n_ref, HEADS)
        y, (c, n) = ssm.mlstm_step(port, torch.from_numpy(x[:, t]), c, n, HEADS)
        _close(y, y_ref)
        _close(c, c_ref)


def test_slstm_apply_and_step_match_reference():
    params = _np(RS.slstm_init(jax.random.PRNGKey(8), D_MODEL, HEADS))
    jp, port = jax.tree.map(jnp.asarray, params), _load(T.SLSTM(D_MODEL, torch.float32, "cpu"), params)
    x = _x(2, 24, D_MODEL, seed=9) * 3.0  # gates well away from 0: m, the stabiliser, moves
    y_ref, state_ref = RS.slstm_apply(jp, jnp.asarray(x[:, :21]), HEADS)
    y, state = ssm.slstm_apply(port, torch.from_numpy(x[:, :21]), HEADS)
    _close(y, y_ref)
    for got, want in zip(state, state_ref):
        _close(got, want)
    for t in range(21, 24):
        y_ref, state_ref = RS.slstm_step(jp, jnp.asarray(x[:, t]), state_ref)
        y, state = ssm.slstm_step(port, torch.from_numpy(x[:, t]), state)
        _close(y, y_ref)
        for got, want in zip(state, state_ref):
            _close(got, want)


# ------------------------------------------------------------------ the stacks
def _models(arch, seed=0):
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    params = _np(RT.init_lm(ref_cfg, jax.random.PRNGKey(seed)))
    return ref_cfg, cfg, params, T.from_jax_params(params, cfg)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_parameters_are_the_references(arch):
    ref_cfg, cfg, params, model = _models(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dataclasses.asdict(configs.get_config(arch)) == dataclasses.asdict(ref_configs.get_config(arch))
    # every reference leaf has its parameter (each xlstm layer holds an mLSTM and an sLSTM)
    assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in jax.tree.leaves(params))
    layout = T.to_jax_layout(T.TransformerLM(cfg, "meta"))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, layout)) == jax.tree.structure(
        jax.tree.map(lambda t: 0, params))
    def shapes(tree):
        return {jax.tree_util.keystr(path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert shapes(layout) == shapes(params)  # checkpoints carry across in both directions
    flags = RT.layer_flags(ref_cfg)
    if "is_slstm" in flags:
        assert [blk.is_slstm for blk in model.layers] == flags["is_slstm"].tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_draws_the_reference_scales(arch):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), d_model=64)
    model = T.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    blk = model.layers[0]
    if arch == "hymba-1.5b":
        m = blk.mamba
        assert abs(m.conv_w.std().item() - 0.2) < 0.03
        assert torch.equal(m.a_log, torch.log(torch.arange(1, cfg.ssm_state + 1.0)).expand_as(m.a_log))
        assert (m.dt_bias == 0).all() and (m.d_skip == 1).all()
        assert abs(m.in_proj.std().item() - 64**-0.5) < 0.1 * 64**-0.5
    else:
        assert abs(blk.slstm.w_rec.std().item() - 0.1 * 64**-0.5) < 0.01 * 64**-0.5
        assert abs(blk.mlstm.wq.std().item() - 128**-0.5) < 0.1 * 128**-0.5
        assert (blk.mlstm.out_norm.scale == 1).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref_cfg, cfg, params, model = _models(arch)
    toks = _tokens(cfg, 2, 20, seed=1)  # past hymba's smoke window of 8
    want = RT.forward(jax.tree.map(jnp.asarray, params), ref_cfg, jnp.asarray(toks))
    got = T.forward(model, cfg, torch.from_numpy(toks))
    assert got.shape == want.shape == (2, 20, cfg.padded_vocab_size)
    _close(got, want, vocab=cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 12 tokens, then 6 decode steps: the logits and every cache
    leaf (the recurrent states written in place) at each."""
    ref_cfg, cfg, params, model = _models(arch)
    jparams = jax.tree.map(jnp.asarray, params)
    toks = _tokens(cfg, 2, 18, seed=2)
    lg_ref, cache_ref, lens_ref = RD.prefill(jparams, ref_cfg, jnp.asarray(toks[:, :12]), max_len=24,
                                             cache_dtype=jnp.float32)
    lg, cache, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :12]), max_len=24, cache_dtype=torch.float32)
    assert set(cache) == set(cache_ref) and lens.tolist() == [12, 12]
    _close(lg, lg_ref, vocab=cfg.vocab_size)
    for t in range(12, 18):
        lg_ref, cache_ref, lens_ref = RD.decode_step(jparams, ref_cfg, jnp.asarray(toks[:, t]), cache_ref, lens_ref)
        lg, cache2, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:, t]), cache, lens)
        assert cache2 is cache  # updated in place
        _close(lg, lg_ref, vocab=cfg.vocab_size)
        assert lens.tolist() == np.asarray(lens_ref).tolist()
    for name, leaf in cache.items():
        want = np.asarray(cache_ref[name], np.float32)
        assert leaf.shape == want.shape, name
        np.testing.assert_allclose(leaf.numpy(), want, atol=RTOL * max(np.abs(want).max(), 1.0), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_carries_what_forward_computes(arch):
    """Prefill 20 tokens and one decode step give forward's logits over the
    21: the recurrent state carries the whole prefix."""
    _, cfg, _, model = _models(arch, seed=1)
    toks = torch.from_numpy(_tokens(cfg, 2, 21, seed=3))
    _, cache, lens = D.prefill(model, cfg, toks[:, :20], max_len=24, cache_dtype=torch.float32)
    step, _, _ = D.decode_step(model, cfg, toks[:, 20], cache, lens)
    _close(step, T.forward(model, cfg, toks)[:, -1], vocab=cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_per_uid(arch):
    """5 requests over 2 slots: refilled slots.  The reference's slot
    prefill steps the whole batch, so every other slot's recurrent state
    moves on its prompt tokens, and a refilled slot keeps the previous
    request's state (only its length is reset): the port's serve loop does
    the same, step for step, and gives the same ids."""
    ref_cfg, cfg, params, model = _models(arch)
    slots, max_len, max_new = 2, 32, 6
    texts = [f"query {i}: {'xyz' * i}" for i in range(5)]
    ref_reqs = [ref_engine.Request(uid=i, text=t, max_new_tokens=max_new) for i, t in enumerate(texts)]
    ref_done, _ = ref_engine.ServingEngine(jax.tree.map(jnp.asarray, params), ref_cfg, batch_slots=slots,
                                           max_len=max_len).serve(ref_reqs)
    eng = engine.ServingEngine(model, cfg, batch_slots=slots, max_len=max_len, device="cpu")
    done, stats = eng.serve([engine.Request(uid=i, text=t, max_new_tokens=max_new) for i, t in enumerate(texts)])
    assert stats.completed == 5
    assert {r.uid: r.output_ids for r in done} == {r.uid: r.output_ids for r in ref_done}


@pytest.mark.parametrize("arch,want", [("hymba-1.5b", (3, 16)), ("xlstm-125m", (3, None)),
                                       ("whisper-large-v3", (3, 16))])
def test_slots_and_length(arch, want):
    """Slots from axis 1, the length from a self-attention "seq" axis
    (not mlstm_c's heads, not the cross K/V's S_enc), None without one."""
    cfg = configs.get_smoke_config(arch)
    cache = D.init_cache(cfg, 3, 16, dtype=torch.float32, device="cpu")
    cross_first = {k: cache[k] for k in sorted(cache, key=lambda k: not k.startswith("cross_"))}
    assert engine.slots_and_length(cache) == engine.slots_and_length(cross_first) == want
    assert set(cache) <= set(D.CACHE_DIM_SEMANTICS)
    assert all(cache[k].dtype == torch.float32 for k in cache if k in D.RECURRENT)
