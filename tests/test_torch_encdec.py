"""The port's encoder-decoder (whisper-large-v3's smoke configuration)
against the reference on the same weights (``from_jax_params``) and the
same seeded numpy frame embeddings, on the CPU (where K3/K4 run their
plain versions): ``encode``, ``forward``, ``prefill`` (the cross K/V it
stores included) and ``decode_step`` (each decoder layer, then its cross
layer over the cross cache), ``ServingEngine.serve``'s ids per uid, and
the conv frontend stub.

The two packages draw frame embeddings from different random streams
(``jax.random`` against a ``torch.Generator``), so the parity tests hand
both the same numpy embeddings.  Tolerances as ``test_torch_lm.py``: f32
logits within 1e-4 of the reference's largest |logit|, bf16 5e-2.
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
from repro.models import frontends as RF  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import frontends as F  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

RTOL = 1e-4
RTOL_BF16 = 5e-2
ARCH = "whisper-large-v3"


def _models(seed=0, **overrides):
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), **overrides)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **overrides)
    params = jax.tree.map(np.asarray, RT.init_lm(ref_cfg, jax.random.PRNGKey(seed)))
    return ref_cfg, cfg, params, T.from_jax_params(params, cfg)


def _frames(cfg, b=2, seed=7):
    return np.random.default_rng(seed).normal(size=(b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


def _close(got, want, rtol=RTOL, vocab=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    scale = float(np.abs(want).max())
    assert 1e-3 < scale < 1e6, scale
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def test_config_and_parameters_are_the_references():
    ref_cfg, cfg, params, model = _models()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dataclasses.asdict(configs.get_config(ARCH)) == dataclasses.asdict(ref_configs.get_config(ARCH))
    assert len(model.encoder.layers) == cfg.encoder_layers and len(model.cross) == cfg.num_layers
    assert model.vis_proj is None
    # every reference leaf has its parameter, the encoder's and the cross layers' included
    assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in jax.tree.leaves(params))


def test_encode_matches_reference():
    ref_cfg, cfg, params, model = _models()
    frames = _frames(cfg)
    want = RT.encode(jax.tree.map(jnp.asarray, params), ref_cfg, jnp.asarray(frames))
    got = T.encode(model, cfg, torch.from_numpy(frames))
    assert got.shape == want.shape == (2, cfg.encoder_seq_len, cfg.d_model)
    _close(got, want)


def test_forward_matches_reference():
    ref_cfg, cfg, params, model = _models()
    frames = _frames(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = RT.forward(jax.tree.map(jnp.asarray, params), ref_cfg, jnp.asarray(toks),
                      encoder_frames=jnp.asarray(frames))
    got = T.forward(model, cfg, torch.from_numpy(toks), encoder_frames=torch.from_numpy(frames))
    assert got.shape == want.shape == (2, 12, cfg.padded_vocab_size)
    _close(got, want, vocab=cfg.vocab_size)
    with pytest.raises(ValueError, match="encoder_frames"):
        T.forward(model, cfg, torch.from_numpy(toks))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill 9 tokens over the frames, then 5 decode steps; the logits
    at each, and the written cache rows — self and cross K/V — against the
    reference's.  The cross K/V are stored in the model's dtype, the rest
    in the cache dtype (f32 here)."""
    ref_cfg, cfg, params, model = _models(dtype=dtype)
    jparams = jax.tree.map(jnp.asarray, params)
    frames = _frames(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 14)).astype(np.int32)
    n_pre, max_len = 9, 16
    rtol = RTOL if dtype == "float32" else RTOL_BF16
    lg_ref, cache_ref, lens_ref = RD.prefill(jparams, ref_cfg, jnp.asarray(toks[:, :n_pre]), max_len=max_len,
                                             cache_dtype=jnp.float32, encoder_frames=jnp.asarray(frames))
    lg, cache, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :n_pre]), max_len=max_len,
                                cache_dtype=torch.float32, encoder_frames=torch.from_numpy(frames))
    _close(lg.float(), lg_ref.astype(jnp.float32), rtol, cfg.vocab_size)
    assert lens.tolist() == np.asarray(lens_ref).tolist() == [n_pre, n_pre]
    assert set(cache) == set(cache_ref) == {"k", "v", "cross_k", "cross_v"}
    for name in cache:
        assert str(cache[name].dtype)[6:] == str(cache_ref[name].dtype), name
        assert cache[name].shape == cache_ref[name].shape, name
    assert cache["cross_k"].shape == (cfg.num_layers, 2, cfg.encoder_seq_len, cfg.num_kv_heads,
                                      cfg.resolved_head_dim)
    for name in ("cross_k", "cross_v", "k"):
        want = np.asarray(cache_ref[name].astype(jnp.float32))
        _close(cache[name].float(), want, rtol)
    for t in range(n_pre, toks.shape[1]):
        lg_ref, cache_ref, lens_ref = RD.decode_step(jparams, ref_cfg, jnp.asarray(toks[:, t]), cache_ref, lens_ref)
        lg, cache2, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:, t]), cache, lens)
        assert cache2 is cache  # updated in place
        _close(lg.float(), lg_ref.astype(jnp.float32), rtol, cfg.vocab_size)
        assert lens.tolist() == np.asarray(lens_ref).tolist()
    for name in ("k", "v", "cross_v"):  # the decode steps' rows; the cross cache unchanged
        _close(cache[name].float(), np.asarray(cache_ref[name].astype(jnp.float32)), rtol)


def test_init_cache_holds_the_cross_cache():
    cfg = configs.get_smoke_config(ARCH)
    cache = D.init_cache(cfg, 3, 20, dtype=torch.float32, device="cpu")
    ref = RD.init_cache(ref_configs.get_smoke_config(ARCH), 3, 20, dtype=jnp.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    assert not any(v.any() for v in cache.values())
    bf16 = D.init_cache(cfg, 3, 20, dtype=torch.float32, device="cpu", cross_dtype=torch.bfloat16)
    assert bf16["cross_k"].dtype == torch.bfloat16 and bf16["k"].dtype == torch.float32


def test_serve_matches_reference_per_uid():
    # the reference engine has no frames: whisper serves over a zero cross cache
    ref_cfg, cfg, params, model = _models()
    texts = [f"query {i}: {'xyz' * i}" for i in range(3)]
    ref_reqs = [ref_engine.Request(uid=i, text=t, max_new_tokens=4) for i, t in enumerate(texts)]
    ref_done, ref_stats = ref_engine.ServingEngine(jax.tree.map(jnp.asarray, params), ref_cfg, batch_slots=2,
                                                   max_len=48).serve(ref_reqs)
    eng = engine.ServingEngine(model, cfg, batch_slots=2, max_len=48, device="cpu")
    done, stats = eng.serve([engine.Request(uid=i, text=t, max_new_tokens=4) for i, t in enumerate(texts)])
    assert stats.completed == ref_stats.completed == 3
    got = {r.uid: r.output_ids for r in done}
    assert got == {r.uid: r.output_ids for r in ref_done}
    assert all(1 <= len(ids) <= 4 for ids in got.values())


def test_decode_graph_takes_slots_and_length_from_the_self_attention_cache():
    # a cache whose first leaf is cross_k: its length is S_enc (16), not
    # max_len; the graph's warm-up step must run past max_len
    cfg = configs.get_smoke_config(ARCH)
    cache = D.init_cache(cfg, 3, 40, dtype=torch.float32, device="cpu")
    cross_first = {name: cache[name] for name in ("cross_k", "cross_v", "k", "v")}
    assert next(iter(cross_first.values())).shape[2] == cfg.encoder_seq_len
    assert engine.slots_and_length(cross_first) == engine.slots_and_length(cache) == (3, 40)
    meta = {name: torch.empty(v.shape, device="meta") for name, v in cross_first.items()}
    assert engine.slots_and_length(meta) == (3, 40)
    model = T.init_lm(cfg, device="cpu")
    with pytest.raises(ValueError, match="on the card"):
        engine.DecodeGraph(model, cfg, cross_first)


@pytest.mark.parametrize("seconds", [30, 10.5, 1])
def test_conv_frontend_stub(seconds):
    n = F.audio_frames_for_seconds(seconds)
    assert n == RF.audio_frames_for_seconds(seconds)
    a = F.conv_stub_frames(torch.Generator().manual_seed(3), 2, n, 64, device="cpu")
    b = F.conv_stub_frames(torch.Generator().manual_seed(3), 2, n, 64, device="cpu")
    want = RF.conv_stub_frames(jax.random.PRNGKey(3), 2, n, 64)
    assert a.shape == tuple(want.shape) == (2, n, 64) and a.dtype == torch.bfloat16
    assert torch.equal(a, b)  # seeded
    f32 = F.conv_stub_frames(torch.Generator().manual_seed(3), 2, 1500, 64, dtype=torch.float32, device="cpu")
    assert abs(f32.mean().item()) < 0.02 and abs(f32.std().item() - 1) < 0.02  # N(0, 1), as the reference's
