"""The port's VLM backbone (internvl2-26b's smoke configuration) against
the reference on the same weights (``from_jax_params``) and the same
seeded numpy patch embeddings, on the CPU: ``forward`` and ``prefill``
with the patch embeddings projected by ``vis_proj`` and run ahead of the
text, ``decode_step`` after them, ``ServingEngine.serve``'s ids per uid
(text only, as the reference's engine serves), and the ViT frontend stub.

The two packages draw patch embeddings from different random streams, so
the parity tests hand both the same numpy embeddings.  Tolerances as
``test_torch_lm.py``: f32 logits within 1e-4 of the reference's largest
|logit|, bf16 5e-2.
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
ARCH = "internvl2-26b"


def _models(seed=0, **overrides):
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), **overrides)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **overrides)
    params = jax.tree.map(np.asarray, RT.init_lm(ref_cfg, jax.random.PRNGKey(seed)))
    return ref_cfg, cfg, params, T.from_jax_params(params, cfg)


def _patches(cfg, b=2, seed=8):
    return np.random.default_rng(seed).normal(size=(b, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)


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
    assert model.vis_proj.shape == (cfg.d_model, cfg.d_model) and model.encoder is None and model.cross is None
    np.testing.assert_array_equal(model.vis_proj.numpy(), params["vis_proj"])
    assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in jax.tree.leaves(params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    ref_cfg, cfg, params, model = _models(dtype=dtype)
    vis = _patches(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    want = RT.forward(jax.tree.map(jnp.asarray, params), ref_cfg, jnp.asarray(toks), vision_embeds=jnp.asarray(vis))
    got = T.forward(model, cfg, torch.from_numpy(toks), vision_embeds=torch.from_numpy(vis))
    assert got.shape == want.shape == (2, cfg.num_vision_tokens + 10, cfg.padded_vocab_size)
    _close(got.float(), want.astype(jnp.float32), RTOL if dtype == "float32" else RTOL_BF16, cfg.vocab_size)


def test_prefill_and_decode_match_reference():
    """Prefill the patches and 7 tokens, then 5 decode steps: the lengths
    count the vision tokens; logits and cache rows against the reference."""
    ref_cfg, cfg, params, model = _models()
    jparams = jax.tree.map(jnp.asarray, params)
    vis = _patches(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    n_pre, n_vis, max_len = 7, cfg.num_vision_tokens, 24
    lg_ref, cache_ref, lens_ref = RD.prefill(jparams, ref_cfg, jnp.asarray(toks[:, :n_pre]), max_len=max_len,
                                             cache_dtype=jnp.float32, vision_embeds=jnp.asarray(vis))
    lg, cache, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :n_pre]), max_len=max_len,
                                cache_dtype=torch.float32, vision_embeds=torch.from_numpy(vis))
    _close(lg, lg_ref, vocab=cfg.vocab_size)
    assert lens.tolist() == np.asarray(lens_ref).tolist() == [n_vis + n_pre] * 2
    _close(cache["k"], cache_ref["k"])
    for t in range(n_pre, toks.shape[1]):
        lg_ref, cache_ref, lens_ref = RD.decode_step(jparams, ref_cfg, jnp.asarray(toks[:, t]), cache_ref, lens_ref)
        lg, cache, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:, t]), cache, lens)
        _close(lg, lg_ref, vocab=cfg.vocab_size)
    _close(cache["v"], cache_ref["v"])
    with pytest.raises(ValueError, match="does not fit"):
        D.prefill(model, cfg, torch.from_numpy(toks), max_len=n_vis + 11, vision_embeds=torch.from_numpy(vis))


def test_vision_embeds_need_the_vision_frontend():
    cfg = configs.get_smoke_config("internlm2-1.8b")
    model = T.init_lm(cfg, device="cpu")
    with pytest.raises(ValueError, match="vision"):
        T.forward(model, cfg, torch.zeros((1, 3), dtype=torch.long),
                  vision_embeds=torch.zeros((1, 2, cfg.d_model)))


def test_serve_matches_reference_per_uid():
    ref_cfg, cfg, params, model = _models()
    texts = [f"query {i}: {'xyz' * i}" for i in range(3)]
    ref_reqs = [ref_engine.Request(uid=i, text=t, max_new_tokens=4) for i, t in enumerate(texts)]
    ref_done, ref_stats = ref_engine.ServingEngine(jax.tree.map(jnp.asarray, params), ref_cfg, batch_slots=2,
                                                   max_len=48).serve(ref_reqs)
    eng = engine.ServingEngine(model, cfg, batch_slots=2, max_len=48, device="cpu")
    done, stats = eng.serve([engine.Request(uid=i, text=t, max_new_tokens=4) for i, t in enumerate(texts)])
    assert stats.completed == ref_stats.completed == 3
    assert {r.uid: r.output_ids for r in done} == {r.uid: r.output_ids for r in ref_done}


@pytest.mark.parametrize("image_size", [448, 224, 14, 500])
def test_vit_frontend_stub(image_size):
    n = F.num_patches_for_resolution(image_size)
    assert n == RF.num_patches_for_resolution(image_size)
    a = F.vit_stub_embeddings(torch.Generator().manual_seed(5), 2, n, 32, device="cpu")
    b = F.vit_stub_embeddings(torch.Generator().manual_seed(5), 2, n, 32, device="cpu")
    want = RF.vit_stub_embeddings(jax.random.PRNGKey(5), 2, n, 32)
    assert a.shape == tuple(want.shape) == (2, n, 32) and a.dtype == torch.bfloat16
    assert torch.equal(a, b)  # seeded
