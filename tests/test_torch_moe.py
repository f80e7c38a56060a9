"""The port's MoE (``models/layers.moe_apply``) and the OLMoE stack against
the reference on the same weights — ``repro.models.transformer.init_lm``'s
pytree carried across with ``from_jax_params`` — and the same seeded
inputs, on the CPU.

Tolerances: f32 outputs within ``RTOL`` 1e-4 of the reference's largest
|value| (f32 sums in another order); bf16 within ``RTOL_BF16`` 5e-2 (the
two frameworks round their bf16 products' f32 sums apart by one bf16 step
now and then).  Routing decisions (which (token, slot) pairs drop) and
greedy serve ids compare exactly: the gates agree to ~1e-7 here, far
inside the gaps between them at these seeds.
"""

import dataclasses
import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve_cli  # noqa: E402
from repro.models import decode as RD  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

RTOL = 1e-4
RTOL_BF16 = 5e-2
ARCHS = ["olmoe-1b-7b", "deepseek-v2-236b"]  # no shared experts; 2 shared experts


def _models(arch, seed=0, **overrides):
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), **overrides)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **overrides)
    params = jax.tree.map(np.asarray, RT.init_lm(ref_cfg, jax.random.PRNGKey(seed)))
    return ref_cfg, cfg, params, T.from_jax_params(params, cfg)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert 1e-3 < scale < 1e6, scale
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _first_cap_per_expert(idx: np.ndarray, e: int, cap: int) -> np.ndarray:
    """Which assignments keep their slot: in (token, slot) order, the
    first ``cap`` of each expert."""
    seen = np.zeros(e, np.int64)
    keep = np.zeros(idx.size, bool)
    for n, ex in enumerate(idx.reshape(-1)):
        keep[n] = seen[ex] < cap
        seen[ex] += 1
    return keep


def test_configs_are_the_reference_configs():
    for arch in ARCHS:
        assert dataclasses.asdict(configs.get_config(arch)) == dataclasses.asdict(ref_configs.get_config(arch))
        assert (dataclasses.asdict(configs.get_smoke_config(arch))
                == dataclasses.asdict(ref_configs.get_smoke_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_carry_across_whole(arch):
    # every reference leaf has a port parameter, at the reference's count
    _, cfg, params, model = _models(arch)
    assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in jax.tree.leaves(params))
    blk = model.layers[0]
    assert blk.moe.router.dtype == torch.float32 and blk.mlp is None
    assert (blk.moe.shared is not None) == bool(cfg.num_shared_experts)
    np.testing.assert_array_equal(blk.moe.experts.w_down.numpy(), params["layers"]["moe"]["experts"]["w_down"][0])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_moe_apply_matches_reference(arch, capacity_factor):
    """At 4.0 nothing drops; at 0.5 some (token, slot) pairs do, the same
    pairs in both: the port's ``moe_route`` keeps the first ``cap`` of
    each expert in (token, slot) order over the reference's top-k."""
    ref_cfg, cfg, params, model = _models(arch, moe_capacity_factor=capacity_factor)
    p_ref = jax.tree.map(lambda x: jnp.asarray(x[0]), params["layers"]["moe"])
    x = np.random.default_rng(1).normal(size=(3, 7, cfg.d_model)).astype(np.float32)
    want = np.asarray(RL.moe_apply(p_ref, ref_cfg, jnp.asarray(x), ref_cfg.mlp_act))
    got = L.moe_apply(model.layers[0].moe, cfg, torch.from_numpy(x), cfg.mlp_act)
    assert got.shape == want.shape == x.shape
    _close(got, want, RTOL)

    e, k, t = cfg.num_experts, cfg.experts_per_token, 3 * 7
    cap = L.moe_capacity(cfg, t)
    assert cap == max(int(capacity_factor * t * k / e), min(t * k, 8))
    xt = x.reshape(t, -1)
    gates = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(params["layers"]["moe"]["router"][0]), axis=-1)
    _, idx = jax.lax.top_k(gates, k)
    want_keep = _first_cap_per_expert(np.asarray(idx), e, cap)
    _, keep, slot = L.moe_route(torch.from_numpy(xt), model.layers[0].moe.router, e, k, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (~want_keep).any() == (capacity_factor < 1.0)  # the small factor drops some
    assert (slot[~keep] == e * cap).all() and len(set(slot[keep].tolist())) == int(keep.sum())


def test_shared_experts_add_one_mlp():
    # the shared experts are one MLP of width n_shared * d_ff over every token
    ref_cfg, cfg, params, model = _models("deepseek-v2-236b")
    moe = model.layers[0].moe
    assert moe.shared.w_gate.shape == (cfg.d_model, cfg.num_shared_experts * cfg.d_ff)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 5, cfg.d_model)).astype(np.float32))
    routed_only = L.moe_apply(moe, cfg, x, cfg.mlp_act)
    shared, moe.shared = moe.shared, None
    try:
        routed = L.moe_apply(moe, cfg, x, cfg.mlp_act)
    finally:
        moe.shared = shared
    want_shared = RL.mlp_apply(jax.tree.map(lambda a: jnp.asarray(a[0]), params["layers"]["moe"]["shared"]),
                               jnp.asarray(x.numpy().reshape(10, -1)), cfg.mlp_act)
    _close((routed_only - routed).reshape(10, -1), want_shared, RTOL)


def test_moe_apply_in_bf16():
    ref_cfg, cfg, params, model = _models("olmoe-1b-7b", dtype="bfloat16")
    p_ref = jax.tree.map(lambda x: jnp.asarray(x[0]), params["layers"]["moe"])
    x = np.random.default_rng(3).normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    want = RL.moe_apply(p_ref, ref_cfg, jnp.asarray(x, jnp.bfloat16), ref_cfg.mlp_act)
    got = L.moe_apply(model.layers[0].moe, cfg, torch.from_numpy(x).bfloat16(), cfg.mlp_act)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), RTOL_BF16)


def test_olmoe_forward_prefill_and_decode_match_reference():
    """OLMoE smoke (qk-norm GQA, 8 experts top-2): forward, prefill of 9
    tokens and 5 decode steps (K4's plain version, MoE over the batch's
    tokens), logits and cache rows against the reference's."""
    ref_cfg, cfg, params, model = _models("olmoe-1b-7b")
    jparams = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 14)).astype(np.int32)
    want = RT.forward(jparams, ref_cfg, jnp.asarray(toks))
    _close(T.forward(model, cfg, torch.from_numpy(toks))[..., :cfg.vocab_size],
           np.asarray(want)[..., :cfg.vocab_size], RTOL)
    lg_ref, cache_ref, lens_ref = RD.prefill(jparams, ref_cfg, jnp.asarray(toks[:, :9]), max_len=16,
                                             cache_dtype=jnp.float32)
    lg, cache, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :9]), max_len=16,
                                cache_dtype=torch.float32)
    _close(lg[:, :cfg.vocab_size], np.asarray(lg_ref)[:, :cfg.vocab_size], RTOL)
    assert set(cache) == set(cache_ref) == {"k", "v"}
    for t in range(9, 14):
        lg_ref, cache_ref, lens_ref = RD.decode_step(jparams, ref_cfg, jnp.asarray(toks[:, t]),
                                                     cache_ref, lens_ref)
        lg, cache, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:, t]), cache, lens)
        _close(lg[:, :cfg.vocab_size], np.asarray(lg_ref)[:, :cfg.vocab_size], RTOL)
    for name in ("k", "v"):
        ref = np.asarray(cache_ref[name])
        np.testing.assert_allclose(cache[name].numpy(), ref, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_per_uid(arch):
    # prompts cut to max_len // 2 = 12 tokens; some requests run out of room
    ref_cfg, cfg, params, model = _models(arch)
    texts = [f"query {i}: {'xyz' * i}" for i in range(5)]
    ref_reqs = [ref_engine.Request(uid=i, text=t, max_new_tokens=14) for i, t in enumerate(texts)]
    ref_done, ref_stats = ref_engine.ServingEngine(jax.tree.map(jnp.asarray, params), ref_cfg, batch_slots=3,
                                                   max_len=24).serve(ref_reqs)
    eng = engine.ServingEngine(model, cfg, batch_slots=3, max_len=24, device="cpu")
    assert not eng.cuda_graph and eng.warm() is None  # the CPU is always eager
    done, stats = eng.serve([engine.Request(uid=i, text=t, max_new_tokens=14) for i, t in enumerate(texts)])
    assert stats.completed == ref_stats.completed == 5
    assert {r.uid: r.output_ids for r in done} == {r.uid: r.output_ids for r in ref_done}
    assert stats.tokens_generated == ref_stats.tokens_generated


def _reference_cli_ids(monkeypatch, argv):
    """Output ids by uid of ``repro.launch.serve`` run with ``argv``."""
    served = {}

    class Recording(ref_engine.ServingEngine):
        def serve(self, requests):
            done, stats = super().serve(requests)
            served.update({r.uid: r.output_ids for r in done})
            return done, stats

    monkeypatch.setattr(ref_serve_cli, "ServingEngine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with redirect_stdout(io.StringIO()):
        ref_serve_cli.main()
    return served


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_matches_reference_cli(monkeypatch, arch):
    """``launch/serve.py --smoke --device cpu`` gives the reference CLI's ids
    on the reference CLI's weights (its PRNGKey(0) init, carried across
    in place of the port's seeded torch init)."""
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--max-new", "4", "--slots", "2",
            "--max-len", "32"]
    want = _reference_cli_ids(monkeypatch, argv)
    ref_cfg = ref_configs.get_smoke_config(arch)
    params = jax.tree.map(np.asarray, RT.init_lm(ref_cfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(serve_cli.T, "init_lm", lambda cfg, gen, dev: T.from_jax_params(params, cfg))
    out = io.StringIO()
    with redirect_stdout(out):
        done, stats = serve_cli.main([*argv, "--device", "cpu"])
    assert "completed 3 requests" in out.getvalue()
    assert {r.uid: r.output_ids for r in done} == want
    assert len(want) == 3 and all(1 <= len(ids) <= 4 for ids in want.values())


def test_serve_cli_cuts_the_depth(capsys):
    done, stats = serve_cli.main(["--arch", "deepseek-v2-236b", "--smoke", "--device", "cpu", "--layers", "2",
                                  "--requests", "2", "--max-new", "2", "--slots", "2", "--max-len", "32"])
    assert stats.completed == 2
    assert "completed 2 requests" in capsys.readouterr().out
