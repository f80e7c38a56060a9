"""The port's LM path (forward, prefill, decode_step) against the reference
on the same weights — ``repro.models.transformer.init_lm``'s pytree carried
across as numpy and loaded with ``from_jax_params`` — and the same seeded
tokens, on the CPU (where K3/K4 run their plain versions).

Logits compare in f32 relative to the largest |logit| of the reference:
``RTOL`` 1e-4 (f32 sums in another order over a few layers); bf16 runs
``RTOL_BF16`` 5e-2 (bf16 rounds at the same points, but XLA and torch
round their bf16 matmuls' f32 sums apart by one bf16 step now and then).
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
from repro.models import transformer as RT  # noqa: E402
from repro.models.config import ModelConfig as RefConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

RTOL = 1e-4
RTOL_BF16 = 5e-2

# tests/test_models.py's two dense configurations
DENSE_GQA_QKNORM = dict(name="t", family="dense", num_layers=3, d_model=64, num_heads=4,
                        num_kv_heads=2, d_ff=128, vocab_size=97, head_dim=16, qk_norm=True,
                        dtype="float32")
LOCAL_GLOBAL_TIED = dict(name="t", family="dense", num_layers=4, d_model=48, num_heads=4,
                         num_kv_heads=1, d_ff=96, vocab_size=61, head_dim=16, sliding_window=4,
                         local_global_ratio=2, tie_embeddings=True, dtype="float32")


def _configs(which: str):
    """(reference config, port config) of one case."""
    if which in configs.ARCH_MODULES:
        return ref_configs.get_smoke_config(which), configs.get_smoke_config(which)
    kw = {"dense_gqa_qknorm": DENSE_GQA_QKNORM, "local_global_tied": LOCAL_GLOBAL_TIED}[which]
    return RefConfig(**kw), ModelConfig(**kw)


def _models(ref_cfg, cfg, seed=0):
    params = jax.tree.map(np.asarray, RT.init_lm(ref_cfg, jax.random.PRNGKey(seed)))
    return params, T.from_jax_params(params, cfg)


def _close(got, want, rtol, vocab):
    got = np.asarray(got, np.float32)[..., :vocab]
    want = np.asarray(want, np.float32)[..., :vocab]
    scale = float(np.abs(want).max())
    assert 1e-3 < scale < 1e6, scale  # not comparing pad values
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


# qwen3-32b: qk-norm and an attention width H * hd of its own (equal to
# d_model at smoke size, 8192 against 5120 at full width); internlm2-20b:
# 6 query heads over 2, 3 layers
CASES = ["gemma3-1b", "internlm2-1.8b", "dense_gqa_qknorm", "local_global_tied", "qwen3-32b",
         "internlm2-20b"]


def test_configs_are_the_reference_configs():
    for arch in configs.ARCH_MODULES:
        for get, ref_get in ((configs.get_config, ref_configs.get_config),
                             (configs.get_smoke_config, ref_configs.get_smoke_config)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(ref_get(arch))
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES  # all ten, in the reference's order


@pytest.mark.parametrize("which", CASES)
def test_forward_matches_reference(which):
    ref_cfg, cfg = _configs(which)
    params, model = _models(ref_cfg, cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = np.asarray(RT.forward(jax.tree.map(jnp.asarray, params), ref_cfg, jnp.asarray(toks)))
    got = T.forward(model, cfg, torch.from_numpy(toks))
    assert got.shape == want.shape == (2, 12, cfg.padded_vocab_size)
    _close(got, want, RTOL, cfg.vocab_size)
    if cfg.padded_vocab_size != cfg.vocab_size:
        assert (got[..., cfg.vocab_size:] == -1e30).all()  # the vocab-pad mask


@pytest.mark.parametrize("which", CASES)
def test_prefill_and_decode_match_reference(which):
    """Prefill 9 tokens, then 5 decode steps; at each the logits and the
    written cache rows agree with the reference's."""
    ref_cfg, cfg = _configs(which)
    params, model = _models(ref_cfg, cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 14)).astype(np.int32)
    n_pre, max_len = 9, 16
    lg_ref, cache_ref, lens_ref = RD.prefill(jparams, ref_cfg, jnp.asarray(toks[:, :n_pre]),
                                             max_len=max_len, cache_dtype=jnp.float32)
    lg, cache, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :n_pre]), max_len=max_len,
                                cache_dtype=torch.float32)
    _close(lg, lg_ref, RTOL, cfg.vocab_size)
    assert lens.tolist() == np.asarray(lens_ref).tolist() == [n_pre, n_pre]
    k_ref = np.asarray(cache_ref["k"])
    assert cache["k"].shape == k_ref.shape
    np.testing.assert_allclose(cache["k"].numpy(), k_ref, atol=1e-4 * np.abs(k_ref).max())
    for t in range(n_pre, toks.shape[1]):
        lg_ref, cache_ref, lens_ref = RD.decode_step(jparams, ref_cfg, jnp.asarray(toks[:, t]),
                                                     cache_ref, lens_ref)
        lg, cache2, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:, t]), cache, lens)
        assert cache2 is cache  # updated in place
        _close(lg, lg_ref, RTOL, cfg.vocab_size)
        assert lens.tolist() == np.asarray(lens_ref).tolist()
    v_ref = np.asarray(cache_ref["v"])
    np.testing.assert_allclose(cache["v"].numpy(), v_ref, atol=1e-4 * np.abs(v_ref).max())


def test_kv_repeat_matches_reference():
    # a cache whose KV heads are repeated (the reference's tensor-parallel
    # cache policy): K3 sees the model's heads, K4 the repeated ones
    ref_cfg, cfg = _configs("internlm2-1.8b")
    params, model = _models(ref_cfg, cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 8)).astype(np.int32)
    lg_ref, cache_ref, lens_ref = RD.prefill(jparams, ref_cfg, jnp.asarray(toks[:, :6]), max_len=10,
                                             kv_repeat=2, cache_dtype=jnp.float32)
    lg, cache, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :6]), max_len=10, kv_repeat=2,
                                cache_dtype=torch.float32)
    assert cache["k"].shape[3] == 2 * cfg.num_kv_heads
    _close(lg, lg_ref, RTOL, cfg.vocab_size)
    for t in (6, 7):
        lg_ref, cache_ref, lens_ref = RD.decode_step(jparams, ref_cfg, jnp.asarray(toks[:, t]),
                                                     cache_ref, lens_ref, kv_repeat=2)
        lg, cache, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:, t]), cache, lens,
                                        kv_repeat=2)
        _close(lg, lg_ref, RTOL, cfg.vocab_size)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(cache_ref["v"]), atol=1e-5)


def test_forward_matches_prefill_and_decode_in_bf16():
    """Gemma3 smoke in bf16 (the full-width dtype): the reference's
    rounding points — sqrt(d_model) in bf16, f32 norms and rope, bf16
    projections — against the reference in bf16."""
    ref_cfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _configs("gemma3-1b"))
    params, model = _models(ref_cfg, cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = RT.forward(jparams, ref_cfg, jnp.asarray(toks))
    got = T.forward(model, cfg, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), RTOL_BF16, cfg.vocab_size)
    lg_ref, cache_ref, lens_ref = RD.prefill(jparams, ref_cfg, jnp.asarray(toks[:, :10]), max_len=16)
    lg, cache, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :10]), max_len=16)
    assert cache["k"].dtype == torch.bfloat16
    _close(lg.float(), np.asarray(lg_ref.astype(jnp.float32)), RTOL_BF16, cfg.vocab_size)
    lg_ref, _, _ = RD.decode_step(jparams, ref_cfg, jnp.asarray(toks[:, 10]), cache_ref, lens_ref)
    lg, _, _ = D.decode_step(model, cfg, torch.from_numpy(toks[:, 10]), cache, lens)
    _close(lg.float(), np.asarray(lg_ref.astype(jnp.float32)), RTOL_BF16, cfg.vocab_size)


def test_decode_past_the_cache_drops_the_write():
    # an idle serving slot's length keeps counting past max_len: the
    # reference's scatter drops the row, and so does the port
    ref_cfg, cfg = _configs("internlm2-1.8b")
    params, model = _models(ref_cfg, cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    cache_ref = RD.init_cache(ref_cfg, 2, 4, dtype=jnp.float32)
    cache = D.init_cache(cfg, 2, 4, dtype=torch.float32, device="cpu")
    lens = np.array([2, 6], np.int32)
    tok = np.array([5, 7], np.int32)
    lg_ref, cache_ref, _ = RD.decode_step(jparams, ref_cfg, jnp.asarray(tok), cache_ref, jnp.asarray(lens))
    lg, cache, _ = D.decode_step(model, cfg, torch.from_numpy(tok), cache, torch.from_numpy(lens))
    _close(lg, lg_ref, RTOL, cfg.vocab_size)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(cache_ref["k"]), atol=1e-5)
    assert not cache["k"][:, 1].any()  # nothing written for the slot past the cache


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke_config("gemma3-1b")
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_lm(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        D.init_cache(cfg, 1, 8)
    model = T.init_lm(cfg, device="cpu")
    assert model.embed.device.type == "cpu"


def test_init_lm_is_seeded_with_the_reference_scales():
    cfg = configs.get_smoke_config("internlm2-1.8b")
    a = T.init_lm(cfg, torch.Generator().manual_seed(4), device="cpu")
    b = T.init_lm(cfg, torch.Generator().manual_seed(4), device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    std = a.layers[0].attn.wq.std().item()
    assert abs(std - cfg.d_model**-0.5) < 0.2 * cfg.d_model**-0.5
    assert a.lm_head is not None and a.embed.dtype == torch.float32
    n = sum(p.numel() for p in a.parameters())
    # the reference's parameter count on the padded vocab
    ref_cfg = ref_configs.get_smoke_config("internlm2-1.8b")
    ref_n = sum(x.size for x in jax.tree.leaves(RT.init_lm(ref_cfg, jax.random.PRNGKey(0))))
    assert n == ref_n


# the stack the port raises for (a reference defect, ROADMAP §3): a
# dense-FFN prefix under GQA (no configuration has one); the SSM and hybrid
# stacks are tests/test_torch_ssm.py's
UNPORTED = ["gqa-dense-prefix"]


@pytest.mark.parametrize("which", UNPORTED)
def test_unported_stacks_raise(which):
    cfg = ModelConfig("t", "moe", 3, 48, 4, 4, 32, 61, head_dim=12, num_experts=8,
                      experts_per_token=2, first_dense_layers=1, dense_d_ff=64, dtype="float32")
    with pytest.raises(NotImplementedError, match="ROADMAP §3"):
        T.TransformerLM(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP §3"):
        D.init_cache(cfg, 1, 8, device="cpu")
