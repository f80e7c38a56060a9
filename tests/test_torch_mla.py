"""The port's MLA (DeepSeek-V2's multi-head latent attention) against the
reference on the same weights (``from_jax_params``) and the same seeded
inputs, on the CPU: ``mla_apply``, K3's plain version with a value width
other than the query/key width against ``attention_scores_blockwise``, and
the DeepSeek-V2 smoke stack — MLA + MoE with a dense-FFN prefix — through
forward, prefill (the compressed c_kv / k_rope cache and its prefix) and
the absorbed-form decode.

Tolerances: f32 within ``RTOL`` 1e-4 of the reference's largest |value|
(f32 sums in another order); attention outputs within 1e-5 absolute (unit
normal inputs, values of order 1).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models import decode as RD  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention import plain as fa_plain  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

RTOL = 1e-4
ATTN_ATOL = 1e-5
ARCH = "deepseek-v2-236b"


def _models(seed=0, **overrides):
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), **overrides)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **overrides)
    params = jax.tree.map(np.asarray, RT.init_lm(ref_cfg, jax.random.PRNGKey(seed)))
    return ref_cfg, cfg, params, T.from_jax_params(params, cfg)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert 1e-3 < scale < 1e6, scale
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "s,kvh,causal,window,block",
    [(12, 4, True, None, 1024), (12, 2, True, None, 1024), (20, 4, True, None, 8),
     (20, 2, True, 6, 8), (9, 4, False, None, 1024), (21, 1, False, 5, 8)],
)
def test_plain_flash_attention_takes_a_value_width(s, kvh, causal, window, block):
    # q/k 24 wide and v 16 (MLA's shape, smoke-sized): the dense branch and
    # the blockwise one (``block`` below S), GQA groups 1, 2 and 4
    b, h, d, dv = 2, 4, 24, 16
    q, k, v = _normal(1, b, s, h, d), _normal(2, b, s, kvh, d), _normal(3, b, s, kvh, dv)
    scale = d**-0.5
    want = np.asarray(RL.attention_scores_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                    causal=causal, window=window, block=block,
                                                    scale=scale))
    got = fa_plain.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                        causal=causal, window=window, scale=scale, block=block)
    assert got.shape == want.shape == (b, s, h, dv)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL, rtol=0)
    # the wrapper and the layer take it too (their CPU path is the plain version)
    got = L.attention_scores_blockwise(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                       causal=causal, window=window, scale=scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL, rtol=0)


def _bhsd(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("s", [1, 127, 129, 193, 1025])
def test_k3_mla_instance_at_the_tile_edges(s, kvh, window):
    # K3's wrapper at MLA's widths (q/k 192, v 128; on the CPU its plain
    # version) where the bf16 kernel's 128-row query tiles, 64-key tiles and
    # 3-stage ring wrap, GQA groups 1 and 2, causal with and without a
    # 64-key window, v a strided view of the (k_nope | v) product as the
    # model passes it: against the reference's oracle and, up to S 129, its
    # Pallas kernel in interpret mode (v zero-padded to 192, the output
    # cropped: the kernel takes one width).  f32, within ATTN_ATOL.
    b, h, d, dv = (2 if s < 1025 else 1), 4, 192, 128
    q, k = _normal(11, b, s, h, d), _normal(12, b, s, kvh, d)
    kv = _normal(13, b, s, kvh, 128 + dv)  # (k_nope | v)
    v = torch.from_numpy(kv)[..., 128:]
    assert not v.is_contiguous()
    got = fa.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k), v, window=window, scale=d**-0.5)
    assert got.shape == (b, s, h, dv)
    want = np.asarray(attention_ref(_bhsd(q), _bhsd(k), _bhsd(v.numpy()), window=window, scale=d**-0.5))
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 2, 1, 3), atol=ATTN_ATOL, rtol=0)
    if s <= 129:  # interpret mode is slow at long S
        vp = np.concatenate([v.numpy(), np.zeros((b, s, kvh, d - dv), np.float32)], axis=-1)
        pallas = np.asarray(ref_flash(_bhsd(q), _bhsd(k), _bhsd(vp), window=window, scale=d**-0.5,
                                      bq=64, bk=64))[..., :dv]
        np.testing.assert_allclose(got.numpy(), pallas.transpose(0, 2, 1, 3), atol=ATTN_ATOL, rtol=0)


def test_flash_attention_wrapper_knows_the_mla_instance(monkeypatch):
    # (192, 128) is a kernel instance: a meta tensor passes the width check
    # and meets the device check; a width pair with no instance raises first
    def no_launch():
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(fa._build, "load_library", no_launch)
    assert (192, 128) in fa.HEAD_DIMS and (128, 128) in fa.HEAD_DIMS
    q = torch.empty((1, 8, 2, 192), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention_bshd(q, q, torch.empty((1, 8, 2, 128), device="meta"))
    with pytest.raises(ValueError, match="head widths"):
        fa.flash_attention_bshd(q, q, torch.empty((1, 8, 2, 64), device="meta"))
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention_bshd(q, q, torch.empty((1, 7, 2, 128), device="meta"))
    # a key length other than the query length is cross attention, which the layer takes
    out = L.attention_scores_blockwise(torch.zeros(1, 4, 2, 8), torch.zeros(1, 5, 2, 8), torch.zeros(1, 5, 2, 8))
    assert out.shape == (1, 4, 2, 8)


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_apply_matches_reference(q_lora):
    overrides = {} if q_lora else {"q_lora_rank": 0}
    ref_cfg, cfg, params, model = _models(**overrides)
    p_ref = jax.tree.map(lambda x: jnp.asarray(x[0]), params["layers"]["attn"])
    assert hasattr(model.layers[0].attn, "wq_a") == q_lora
    x = _normal(5, 2, 11, cfg.d_model)
    pos = np.arange(11)
    want = RL.mla_apply(p_ref, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.mla_apply(model.layers[0].attn, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert got.shape == (2, 11, cfg.d_model)
    _close(got, want)
    # the compressed rows prefill caches
    c_ref, r_ref = RL.mla_compress(p_ref, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    c, r = L.mla_compress(model.layers[0].attn, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(c, c_ref)
    _close(r, r_ref)


def test_deepseek_forward_matches_reference():
    ref_cfg, cfg, params, model = _models()
    assert len(model.dense_prefix) == cfg.first_dense_layers == 1
    assert model.dense_prefix[0].mlp.w_gate.shape == (cfg.d_model, cfg.dense_d_ff)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = RT.forward(jax.tree.map(jnp.asarray, params), ref_cfg, jnp.asarray(toks))
    got = T.forward(model, cfg, torch.from_numpy(toks))
    assert got.shape == want.shape
    _close(got[..., :cfg.vocab_size], np.asarray(want)[..., :cfg.vocab_size])


def test_deepseek_prefill_and_absorbed_decode_match_reference():
    """Prefill 9 tokens (the compressed cache and its dense-prefix part),
    then 5 absorbed-form decode steps; logits and every cache leaf agree
    with the reference's."""
    ref_cfg, cfg, params, model = _models()
    jparams = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(2, 14)).astype(np.int32)
    lg_ref, cache_ref, lens_ref = RD.prefill(jparams, ref_cfg, jnp.asarray(toks[:, :9]), max_len=16,
                                             cache_dtype=jnp.float32)
    lg, cache, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :9]), max_len=16,
                                cache_dtype=torch.float32)
    assert set(cache) == set(cache_ref) == {"c_kv", "k_rope", "prefix_c_kv", "prefix_k_rope"}
    assert cache["c_kv"].shape == (cfg.num_layers - 1, 2, 16, cfg.kv_lora_rank)
    _close(lg[:, :cfg.vocab_size], np.asarray(lg_ref)[:, :cfg.vocab_size])
    for t in range(9, 14):
        lg_ref, cache_ref, lens_ref = RD.decode_step(jparams, ref_cfg, jnp.asarray(toks[:, t]),
                                                     cache_ref, lens_ref)
        lg, cache2, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:, t]), cache, lens)
        assert cache2 is cache  # updated in place
        _close(lg[:, :cfg.vocab_size], np.asarray(lg_ref)[:, :cfg.vocab_size])
        assert lens.tolist() == np.asarray(lens_ref).tolist()
    for name, ref in cache_ref.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(cache[name].numpy(), ref, atol=RTOL * np.abs(ref).max(), err_msg=name)


def test_absorbed_decode_past_the_cache_drops_the_write():
    # an idle serving slot's length counts past max_len: no row is written
    ref_cfg, cfg, params, model = _models()
    jparams = jax.tree.map(jnp.asarray, params)
    cache_ref = RD.init_cache(ref_cfg, 2, 4, dtype=jnp.float32)
    cache = D.init_cache(cfg, 2, 4, dtype=torch.float32, device="cpu")
    lens, tok = np.array([2, 6], np.int32), np.array([5, 7], np.int32)
    lg_ref, cache_ref, _ = RD.decode_step(jparams, ref_cfg, jnp.asarray(tok), cache_ref, jnp.asarray(lens))
    lg, cache, _ = D.decode_step(model, cfg, torch.from_numpy(tok), cache, torch.from_numpy(lens))
    _close(lg[:, :cfg.vocab_size], np.asarray(lg_ref)[:, :cfg.vocab_size])
    assert not cache["c_kv"][:, 1].any() and not cache["prefix_k_rope"][:, 1].any()
    np.testing.assert_allclose(cache["c_kv"].numpy(), np.asarray(cache_ref["c_kv"]), atol=1e-5)
