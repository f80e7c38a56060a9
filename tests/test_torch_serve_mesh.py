"""Prefill and decode on a mesh in the port against the reference on the
CPU: ``zero.place_params`` puts each model device's slice of every
"model"-ruled leaf (the reference's ``param_pspecs``) on it,
``decode.make_mesh_prefill`` / ``make_mesh_decode_step`` split the rows
over the data shards and the heads over "model", and each device keeps its
slice of the KV cache (``choose_cache_policy``: heads over "model" after
``kv_repeat``, rows over the data axes; or, where the heads do not split,
the sequence over "model", and over the data axes too at a batch smaller
than they are: K4 on each device's keys, the partial softmaxes merged by
their log-sum-exp).

Meshes of logical CPU devices (``REPRO_TORCH_FORCE_DEVICE_COUNT``) of
shapes (1, 2), (2, 1) and (2, 2), and (1, 8) and (2, 8) for the smoke
gemma3-1b's sequence split; the smoke configurations of the five served
architectures with the reference's weights (``from_jax_params``).
Tolerances: logits against the reference's single-device ``prefill`` /
``decode_step`` (JAX, f32) within ``test_torch_lm.py``'s ``RTOL`` (1e-4 of
the largest |logit|: f32 sums in another order, the partial outputs' ring
sum); each device's cache slice against the port's own single-device
cache bitwise for the first layer (nothing summed before its K/V) and
within :data:`CACHE_RTOL` of the largest |entry| after it (a
tensor-parallel sum precedes the write); placement bitwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import sharding as Rsh  # noqa: E402
from repro.models import decode as RD  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.device import current_logical  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.kv_cache import CachePolicy, choose_cache_policy  # noqa: E402

from test_torch_lm import RTOL, _close, _models  # noqa: E402
from test_torch_tensor_parallel import _node, _spec_slice  # noqa: E402
from test_torch_train_mesh import _mesh  # noqa: E402

ARCHS = ["gemma3-1b", "internlm2-1.8b", "qwen3-32b", "internvl2-26b", "olmoe-1b-7b"]
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
B, N_PRE, STEPS = 4, 9, 4
CACHE_RTOL = 1e-5
SERVED = ("qwen3-32b", "internlm2-1.8b", "internlm2-20b", "internvl2-26b", "olmoe-1b-7b")

_REF: dict = {}


def _setup(arch, cfg_change=None):
    """(reference config, port config, the reference's params as numpy, the
    port's model on them, the tokens, the VLM's vision embeddings or None)."""
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    if cfg_change:
        ref_cfg, cfg = dataclasses.replace(ref_cfg, **cfg_change), dataclasses.replace(cfg, **cfg_change)
    params, model = _models(ref_cfg, cfg)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, size=(B, N_PRE + STEPS)).astype(np.int32)
    vis = None
    if cfg.frontend == "vit_stub":
        vis = rng.normal(size=(B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, params, model, toks, vis


def _max_len(cfg) -> int:
    return N_PRE + STEPS + 3 + (cfg.num_vision_tokens if cfg.frontend == "vit_stub" else 0)


def _reference(arch):
    """The reference's single-device logits: prefill, then STEPS decode
    steps of the given tokens (cached per arch)."""
    if arch not in _REF:
        ref_cfg, cfg, params, _, toks, vis = _setup(arch)
        jp = jax.tree.map(jnp.asarray, params)
        kw = {} if vis is None else {"vision_embeds": jnp.asarray(vis)}
        lg, cache, lens = RD.prefill(jp, ref_cfg, jnp.asarray(toks[:, :N_PRE]), max_len=_max_len(cfg),
                                     cache_dtype=jnp.float32, **kw)
        out = [np.asarray(lg)]
        for t in range(STEPS):
            lg, cache, lens = RD.decode_step(jp, ref_cfg, jnp.asarray(toks[:, N_PRE + t]), cache, lens)
            out.append(np.asarray(lg))
        _REF[arch] = out
    return _REF[arch]


def _serve(cfg, model, mesh, toks, vis, steps=STEPS, policy=None, max_len=None):
    """Place ``model`` on ``mesh``, prefill and decode ``steps`` tokens ->
    (logits per call, the placed cache, the policy, the placed params);
    ``policy`` default: ``choose_cache_policy``'s, ``max_len`` default:
    :func:`_max_len`."""
    max_len = max_len or _max_len(cfg)
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = policy or choose_cache_policy(cfg, mesh.shape["model"], toks.shape[0], mesh.shape["data"])
        pspecs = S.param_pspecs(model)
        placed = Z.place_params(model, mesh, pspecs)
        prefill = D.make_mesh_prefill(cfg, mesh, pspecs, policy)
        step = D.make_mesh_decode_step(cfg, mesh, pspecs, policy)
    kw = {} if vis is None else {"vision_embeds": torch.from_numpy(vis)}
    lg, cache, lens = prefill(placed, torch.from_numpy(toks[:, :N_PRE]), max_len=max_len,
                              cache_dtype=torch.float32, **kw)
    out = [lg]
    for t in range(steps):
        lg, cache2, lens = step(placed, torch.from_numpy(toks[:, N_PRE + t]), cache, lens)
        assert cache2 is cache
        out.append(lg)
    assert lens.tolist() == [N_PRE + steps + (0 if vis is None else cfg.num_vision_tokens)] * toks.shape[0]
    return out, cache, policy, placed


# ----------------------------------------------------------------- logits
def _spied(monkeypatch) -> dict:
    """The logical devices K3's and K4's plain versions run on, by kernel."""
    seen = {"k3": set(), "k4": set()}

    def spy(key, fn):
        def wrapped(*args, **kw):
            seen[key].add(current_logical().label)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(L, "attention_scores_blockwise", spy("k3", L.attention_scores_blockwise))
    monkeypatch.setattr(da_ops, "decode_attention_cache", spy("k4", da_ops.decode_attention_cache))
    return seen


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_logits_against_reference(arch, mesh, monkeypatch):
    """Prefill's last-token logits and STEPS decode steps' logits on the
    mesh against the reference's single-device run, every row in the
    shards' order on the mesh's first device; K3's and K4's plain versions
    ran on every model device of every group (spied by logical device)."""
    want = _reference(arch)
    _, cfg, _, model, toks, vis = _setup(arch)
    m = _mesh(MESHES[mesh], monkeypatch)
    seen = _spied(monkeypatch)
    got, _, _, _ = _serve(cfg, model, m, toks, vis)
    for g, w in zip(got, want):
        assert g.shape == (B, cfg.padded_vocab_size) and g.device == m.flat[0].device
        _close(g, w, RTOL, cfg.vocab_size)
    labels = {dev.label for dev in m.flat}
    assert seen == {"k3": labels, "k4": labels}, (arch, mesh, seen)


# ------------------------------------------------------------------ cache
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_slices_are_the_single_device_caches(arch, mesh, monkeypatch):
    """After prefill and the decode steps each device's slice of k and v
    is the same slice (its data shard's rows, its model index's cache heads
    after ``kv_repeat``) of the port's single-device cache built with the
    same policy: bitwise in the first layer, within CACHE_RTOL after it;
    ``gather_cache`` joins the slices back."""
    _, cfg, _, model, toks, vis = _setup(arch)
    m = _mesh(MESHES[mesh], monkeypatch)
    _, cache, policy, _ = _serve(cfg, model, m, toks, vis)
    kw = {} if vis is None else {"vision_embeds": torch.from_numpy(vis)}
    _, single, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :N_PRE]), max_len=_max_len(cfg),
                                kv_repeat=policy.kv_repeat, cache_dtype=torch.float32, **kw)
    for t in range(STEPS):
        _, single, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:, N_PRE + t]), single, lens,
                                        kv_repeat=policy.kv_repeat)
    with S.use_rules(S.SINGLE_POD_RULES):
        specs = D.cache_pspecs(single, policy, m)
    assert set(single) == {"k", "v"} and single["k"].shape[3] == cfg.num_kv_heads * policy.kv_repeat
    for q, mine in enumerate(cache):
        for key, whole in single.items():
            want = _spec_slice(whole.numpy(), specs[key], m, q)
            got = mine[key].numpy()
            assert got.shape == want.shape == (cfg.num_layers, B // m.shape["data"], _max_len(cfg),
                                               whole.shape[3] // m.shape["model"], whole.shape[4])
            assert np.array_equal(got[0], want[0]), (key, q)
            assert np.abs(got - want).max() <= CACHE_RTOL * np.abs(want).max(), (key, q)
    with S.use_rules(S.SINGLE_POD_RULES):
        back = D.gather_cache(cache, m, policy)
    assert {k: v.shape for k, v in back.items()} == {k: v.shape for k, v in single.items()}
    assert all(torch.equal(back[k][0], single[k][0]) for k in back)


# ------------------------------------------------ the sequence-split cache
# (arch, mesh shape, a forced cache policy or None for choose_cache_policy's, max_len or None for _max_len's)
SEQ_CASES = {
    "gemma3-1b-1x8": ("gemma3-1b", (1, 8), None, 64),
    "internlm2-1.8b-1x2": ("internlm2-1.8b", (1, 2), CachePolicy(1, False, True, ("model",)), None),
    "internlm2-1.8b-2x2": ("internlm2-1.8b", (2, 2), CachePolicy(1, False, True, ("model",)), None),
}
_SEQ_REF: dict = {}


def _reference_run(arch, rows: int, max_len: int):
    """The reference's single-device logits over the first ``rows`` rows of
    :func:`_setup`'s tokens: prefill of N_PRE tokens into a ``max_len``
    cache, then STEPS decode steps (cached)."""
    key = (arch, rows, max_len)
    if key not in _SEQ_REF:
        ref_cfg, _, params, _, toks, _ = _setup(arch)
        jp = jax.tree.map(jnp.asarray, params)
        lg, cache, lens = RD.prefill(jp, ref_cfg, jnp.asarray(toks[:rows, :N_PRE]), max_len=max_len,
                                     cache_dtype=jnp.float32)
        out = [np.asarray(lg)]
        for t in range(STEPS):
            lg, cache, lens = RD.decode_step(jp, ref_cfg, jnp.asarray(toks[:rows, N_PRE + t]), cache, lens)
            out.append(np.asarray(lg))
        _SEQ_REF[key] = out
    return _SEQ_REF[key]


def _single_run(cfg, model, toks, max_len, policy, rows=None):
    """The port's single-device cache after prefill and STEPS decode steps
    of the first ``rows`` rows (default: all)."""
    toks = toks[:rows]
    _, single, lens = D.prefill(model, cfg, torch.from_numpy(toks[:, :N_PRE]), max_len=max_len,
                                kv_repeat=policy.kv_repeat, cache_dtype=torch.float32)
    for t in range(STEPS):
        _, single, lens = D.decode_step(model, cfg, torch.from_numpy(toks[:, N_PRE + t]), single, lens,
                                        kv_repeat=policy.kv_repeat)
    return single


def _hold_slices(cache, single, policy, m, rows: int, width: int) -> None:
    """Each device's k and v slice is the same slice of the single-device
    cache (its rows, its keys): bitwise in the first layer, within
    CACHE_RTOL of the largest |entry| after it."""
    with S.use_rules(S.SINGLE_POD_RULES):
        specs = D.cache_pspecs(single, policy, m)
    for q, mine in enumerate(cache):
        for key, whole in single.items():
            want = _spec_slice(whole.numpy(), specs[key], m, q)
            got = mine[key].numpy()
            assert got.shape == want.shape == (whole.shape[0], rows, width, *whole.shape[3:]), (key, q)
            assert np.array_equal(got[0], want[0]), (key, q)
            assert np.abs(got - want).max() <= CACHE_RTOL * np.abs(want).max(), (key, q)


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_split_logits_against_reference(case, monkeypatch):
    """A cache split by sequence over "model" (choose_cache_policy's for
    the smoke gemma3-1b's 4 heads over 1 KV head on 8 model devices; forced
    for internlm2-1.8b on (1, 2) and (2, 2)): prefill's last-token logits
    and STEPS decode steps' within RTOL of the reference's single-device
    run.  K3 ran on each data shard's lead alone (the heads do not split:
    attention runs whole there) and K4 on every device; on (1, 8) a 64-key
    cache gives each device 8 keys, so devices 2-7 hold no valid key and
    their partials weigh 0 in the merge."""
    arch, shape, policy, max_len = SEQ_CASES[case]
    _, cfg, _, model, toks, vis = _setup(arch)
    max_len = max_len or _max_len(cfg)
    want = _reference_run(arch, B, max_len)
    m = _mesh(shape, monkeypatch)
    seen = _spied(monkeypatch)
    got, _, used, _ = _serve(cfg, model, m, toks, vis, policy=policy, max_len=max_len)
    assert used.seq_axes == ("model",) and not used.shard_heads and used.shard_batch
    for g, w in zip(got, want):
        assert g.shape == (B, cfg.padded_vocab_size) and g.device == m.flat[0].device
        _close(g, w, RTOL, cfg.vocab_size)
    leads = {m.flat[i * shape[1]].label for i in range(shape[0])}
    assert seen == {"k3": leads, "k4": {dev.label for dev in m.flat}}, (case, seen)


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_split_cache_slices_are_the_single_device_caches(case, monkeypatch):
    """After prefill and the decode steps each device's slice of k and v
    holds its data shard's rows and its model index's keys (64 / 8 on
    (1, 8)) of the port's single-device cache: bitwise in the first layer,
    within CACHE_RTOL after it; a device whose keys lie past the 13
    written holds zeros, and ``gather_cache`` joins the slices back."""
    arch, shape, policy, max_len = SEQ_CASES[case]
    _, cfg, _, model, toks, vis = _setup(arch)
    max_len = max_len or _max_len(cfg)
    m = _mesh(shape, monkeypatch)
    _, cache, policy, _ = _serve(cfg, model, m, toks, vis, policy=policy, max_len=max_len)
    single = _single_run(cfg, model, toks, max_len, policy)
    width = max_len // shape[1]
    _hold_slices(cache, single, policy, m, B // shape[0], width)
    for q in range(m.size):
        if m.coords(q)["model"] * width >= N_PRE + STEPS:
            assert all(not mine.any() for mine in cache[q].values()), q
    with S.use_rules(S.SINGLE_POD_RULES):
        back = D.gather_cache(cache, m, policy)
    assert {k: v.shape for k, v in back.items()} == {k: v.shape for k, v in single.items()}
    assert all(torch.equal(back[k][0], single[k][0]) for k in back)


def test_sequence_split_over_data_at_batch_one(monkeypatch):
    """The smoke gemma3-1b on (2, 8) at batch 1: choose_cache_policy splits
    the sequence over ("data", "model"), 4 keys a device of a 64-key cache.
    The mesh's prefill of one row raises (the rows do not split over the
    data axes, as in the reference); the port's single-device prefill cache
    placed with ``place_cache``, then STEPS decode steps: logits within
    RTOL of the reference's decode steps, the layers on the first data
    index's lead, K4 on all 16 devices (the merge in two levels), and each
    device's cache slice the single-device cache's."""
    arch, max_len = "gemma3-1b", 64
    _, cfg, _, model, toks, _ = _setup(arch)
    want = _reference_run(arch, 1, max_len)
    m = _mesh((2, 8), monkeypatch)
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, 8, 1, 2)
        pspecs = S.param_pspecs(model)
        placed = Z.place_params(model, m, pspecs)
        prefill = D.make_mesh_prefill(cfg, m, pspecs, policy)
        step = D.make_mesh_decode_step(cfg, m, pspecs, policy)
    assert policy == CachePolicy(1, False, False, ("data", "model"))
    with pytest.raises(ValueError, match="does not split over 2 data shards"):
        prefill(placed, torch.from_numpy(toks[:1, :N_PRE]), max_len=max_len, cache_dtype=torch.float32)
    lg, single, lens = D.prefill(model, cfg, torch.from_numpy(toks[:1, :N_PRE]), max_len=max_len,
                                 cache_dtype=torch.float32)
    _close(lg, want[0], RTOL, cfg.vocab_size)
    with S.use_rules(S.SINGLE_POD_RULES):
        cache = D.place_cache(single, m, policy)
    expect = _single_run(cfg, model, toks, max_len, policy, rows=1)
    seen = _spied(monkeypatch)
    for t in range(STEPS):
        lg, cache2, lens = step(placed, torch.from_numpy(toks[:1, N_PRE + t]), cache, lens)
        assert cache2 is cache and lg.device == m.flat[0].device
        _close(lg, want[t + 1], RTOL, cfg.vocab_size)
    assert lens.tolist() == [N_PRE + STEPS]
    assert seen == {"k3": set(), "k4": {dev.label for dev in m.flat}}
    _hold_slices(cache, expect, policy, m, 1, max_len // 16)


# ------------------------------------------------------------------ MoE
def _recorded_keep(record: list, route=L.moe_route):
    def recording(xt, router, e, k, cap):
        flat_w, keep, slot = route(xt, router, e, k, cap)
        record.append((xt.shape[0], cap, keep.clone()))
        return flat_w, keep, slot

    return recording


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_moe_decode_routes_the_whole_batch(mesh, monkeypatch):
    """OLMoE on a (2, 1) or (2, 2) mesh at capacity factor 0.5 and 64
    rows: a decode step's 64 tokens (32 a data shard, under the
    expert-parallel threshold) route as one batch, one capacity over all
    of them (8 slots an expert for 16 assignments each on average), so the
    same (token, slot) pairs drop as in the port's single-device step
    (held to the reference's ``moe_apply`` drops in ``test_torch_moe.py``),
    and the logits are the reference's single-device decode step's within
    RTOL.  Each model device of the first data shard routes the gathered
    rows to its own experts, which stay split (rows move, not experts)."""
    rows = 64
    ref_cfg, cfg, params, model, _, _ = _setup("olmoe-1b-7b", {"moe_capacity_factor": 0.5})
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(rows, 5)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    _, rcache, rlens = RD.prefill(jp, ref_cfg, jnp.asarray(toks[:, :4]), max_len=8, cache_dtype=jnp.float32)
    want, _, _ = RD.decode_step(jp, ref_cfg, jnp.asarray(toks[:, 4]), rcache, rlens)
    m = _mesh(MESHES[mesh], monkeypatch)
    tp = m.shape["model"]
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, tp, rows, 2)
        pspecs = S.param_pspecs(model)
        placed = Z.place_params(model, m, pspecs)
        prefill = D.make_mesh_prefill(cfg, m, pspecs, policy)
        step = D.make_mesh_decode_step(cfg, m, pspecs, policy)
    _, cache, lens = prefill(placed, torch.from_numpy(toks[:, :4]), max_len=8, cache_dtype=torch.float32)
    _, single, slens = D.prefill(model, cfg, torch.from_numpy(toks[:, :4]), max_len=8, cache_dtype=torch.float32)
    mesh_keep, single_keep, routed_on = [], [], []
    route = _recorded_keep(mesh_keep)
    monkeypatch.setattr(L, "moe_route", lambda *a: routed_on.append(current_logical().label) or route(*a))
    got, _, _ = step(placed, torch.from_numpy(toks[:, 4]), cache, lens)
    monkeypatch.setattr(L, "moe_route", _recorded_keep(single_keep))
    D.decode_step(model, cfg, torch.from_numpy(toks[:, 4]), single, slens)
    _close(got, np.asarray(want), RTOL, cfg.vocab_size)
    assert [(t, cap) for t, cap, _ in mesh_keep] == [(rows, 8)] * (cfg.num_layers * tp)
    assert [(t, cap) for t, cap, _ in single_keep] == [(rows, 8)] * cfg.num_layers
    assert routed_on == [dev.label for dev in m.flat[:tp]] * cfg.num_layers  # the first data shard's group
    for i, (_, _, mk) in enumerate(mesh_keep):
        assert torch.equal(mk, single_keep[i // tp][2])
    for name, w in placed[0].named_parameters():
        if ".moe.experts." in name:
            assert w.shape[0] == cfg.num_experts // tp, name
    assert all(int((~mk).sum()) > 0 for _, _, mk in mesh_keep)  # the capacity drops tokens


def test_moe_prefill_takes_the_expert_parallel_branch(monkeypatch):
    """OLMoE's prefill of 4 x 128 tokens on a (2, 2) mesh is 256 tokens a
    data shard: each shard routes its own tokens to its model devices'
    experts (the reference's expert-parallel branch); at capacity factor
    4.0 nothing drops, so the logits are the single-device reference's."""
    ref_cfg, cfg, params, model, _, _ = _setup("olmoe-1b-7b")
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, size=(4, 128)).astype(np.int32)
    want, _, _ = RD.prefill(jax.tree.map(jnp.asarray, params), ref_cfg, jnp.asarray(toks), max_len=130,
                            cache_dtype=jnp.float32)
    m = _mesh((2, 2), monkeypatch)
    calls = []
    ep = L._moe_apply_ep
    monkeypatch.setattr(L, "_moe_apply_ep", lambda *a, **kw: calls.append(a[2].shape) or ep(*a, **kw))
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, 2, 4, 2)
        pspecs = S.param_pspecs(model)
        prefill = D.make_mesh_prefill(cfg, m, pspecs, policy)
        placed = Z.place_params(model, m, pspecs)
    got, _, _ = prefill(placed, torch.from_numpy(toks), max_len=130, cache_dtype=torch.float32)
    _close(got, np.asarray(want), RTOL, cfg.vocab_size)
    assert calls == [(2, 128, cfg.d_model)] * (2 * cfg.num_layers)  # each shard's rows, each layer


# -------------------------------------------------------------- placement
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_params_and_cache_are_the_reference_specs_slices(arch, mesh, monkeypatch):
    """Each device's parameter is bitwise the numpy slice of the reference's
    serving spec (``param_pspecs`` under SINGLE_POD_RULES) for its mesh
    position, in the config's dtype; ``gather_params`` gives the model back
    bitwise.  A single-device cache placed with ``place_cache`` is the
    slices of the reference's cache specs (``cache_structs_and_specs``'
    rules), and ``gather_cache`` joins it back bitwise."""
    _, cfg, params, model, _, _ = _setup(arch)
    with Rsh.use_rules(Rsh.SINGLE_POD_RULES):
        ref_specs = Rsh.param_pspecs(params)
    m = _mesh(MESHES[mesh], monkeypatch)
    with S.use_rules(S.SINGLE_POD_RULES):
        placed = Z.place_params(model, m, S.param_pspecs(model))
    split = 0
    for q, copy in enumerate(placed):
        for name, w in copy.named_parameters():
            path, index = T._jax_path(name)
            spec = tuple(_node(ref_specs, path))
            want = _spec_slice(_node(params, path), spec, m, q)
            assert w.dtype == dict(model.named_parameters())[name].dtype
            assert np.array_equal(w.numpy(), want if index is None else want[index]), (q, name)
            split += "model" in spec and m.shape["model"] > 1
    assert split > 0 or m.shape["model"] == 1
    with S.use_rules(S.SINGLE_POD_RULES):
        back = Z.gather_params(placed, m, S.param_pspecs(model))
    for (name, w), (_, w0) in zip(back.named_parameters(), model.named_parameters()):
        assert torch.equal(w, w0), name
    rng = np.random.default_rng(3)
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, m.shape["model"], B, m.shape["data"])
        cache = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
                 for k, v in D.init_cache(cfg, B, 6, policy.kv_repeat, torch.float32, "cpu").items()}
        placed_cache = D.place_cache(cache, m, policy)
        specs = D.cache_pspecs(cache, policy, m)
        back = D.gather_cache(placed_cache, m, policy)
    for q, mine in enumerate(placed_cache):
        for key, whole in cache.items():
            assert np.array_equal(mine[key].numpy(), _spec_slice(whole.numpy(), specs[key], m, q)), (key, q)
    assert all(torch.equal(back[k], cache[k]) for k in cache)


# gemma3-1b's 4 heads over 1 KV head split no group at TP 16: its cache splits by sequence, over "model" at
# prefill_32k / decode_32k and over the data axes too at long_500k's batch of 1
PRODUCTION_CELLS = ([(arch, shape) for arch in SERVED for shape in ("prefill_32k", "decode_32k")]
                    + [("gemma3-1b", shape) for shape in ("prefill_32k", "decode_32k", "long_500k")])


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", PRODUCTION_CELLS)
def test_production_cells_place_the_reference_layout(arch, shape, multi_pod):
    """At full size on the 16x16 and 2x16x16 meshes (their RoleMesh, meta
    tensors) the busiest device's argument bytes equal the spec trees':
    the serving weights under ``param_pspecs`` (no FSDP: under the 4 GiB
    threshold at 2 bytes a parameter), for decode the cache under
    ``cache_structs_and_specs``, and the inputs over the data axes (whole
    where the batch does not split), all at the reference's 2 bytes, plus 2
    bytes for each element of the leaves the port keeps in f32
    (``dtype_surplus_bytes``).  A decode device's cache slice holds its
    rows, keys and heads: gemma3-1b's 8 rows x 2048 keys at decode_32k on
    16x16, 1 x 2048 at long_500k (1 x 1024 on 2x16x16)."""
    cfg = configs.get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, devices=H.trace_devices(512 if multi_pod else 256))
    rules = S.MULTI_POD_RULES if multi_pod else S.SINGLE_POD_RULES
    with S.use_rules(rules):
        spec = TS.build_cell(cfg, SHAPES[shape], mesh)
    assert spec.skip is None
    placed = spec.args[0]
    # the reference casts every leaf to bf16; the port keeps its norm scales and MoE routers in f32
    wide = {name: w for name, w in placed[0].named_parameters() if w.element_size() > 2}
    assert wide and all(w.dtype == torch.float32 and ("norm" in name or name.endswith("router"))
                        for name, w in wide.items())
    assert spec.dtype_surplus_bytes == 2 * sum(w.numel() for w in wide.values())
    assert spec.argument_bytes == spec.reference_argument_bytes + spec.dtype_surplus_bytes
    assert len(placed) == len(spec.device_args) == (18 if multi_pod else 9)  # the RoleMesh's devices
    if SHAPES[shape].kind == "decode":
        cache, cell, data = spec.args[2][0], SHAPES[shape], 32 if multi_pod else 16
        policy = choose_cache_policy(cfg, 16, cell.global_batch, data)
        heads = cfg.num_kv_heads * policy.kv_repeat
        keys = cell.seq_len // (16 * (data if "data" in policy.seq_axes else 1) if policy.seq_axes else 1)
        assert cache["k"].shape == (cfg.num_layers, cell.global_batch // data if policy.shard_batch else 1, keys,
                                    heads // 16 if policy.shard_heads else heads, cfg.resolved_head_dim)
        if arch == "gemma3-1b":
            assert cache["k"].shape[1:3] == {"decode_32k": (8 // (2 if multi_pod else 1), 2048),
                                             "long_500k": (1, 2048 // (2 if multi_pod else 1))}[shape]


@pytest.mark.parametrize("kind,batch", [("decode", 1), ("decode", 4), ("prefill", 4)])
def test_role_mesh_trace_equals_a_full_trace_of_a_sequence_split_cell(kind, batch, monkeypatch):
    """The smoke gemma3-1b (at head width 64, which the kernels take) on
    (2, 8) with a 64-key cache: its cache splits by sequence over "model"
    at batch 4 and over ("data", "model") at batch 1.  A trace on the
    mesh's RoleMesh (3 data indices of 2, 3 model indices of 8) counts
    what a trace of all 16 devices counts, per device: the gathers of
    partials, which hold a slice for each device of the whole axis, the
    sends of prefill's key slices, the launches (K4 on every device, K3 on
    the leads), FLOPs, traffic and bytes."""
    cfg = dataclasses.replace(configs.get_smoke_config("gemma3-1b"), head_dim=64)
    cell = InputShape("c", kind, 64, batch)
    mesh = make_mesh((2, 8), ("data", "model"), H.trace_devices(16))
    short = dryrun.run_cell(cfg, cell, mesh)
    monkeypatch.setattr(TS, "RoleMesh", lambda m: m)
    full = dryrun.run_cell(cfg, cell, mesh)
    assert short["hlo"] == full["hlo"] and short["memory"] == full["memory"]
    assert short["hlo"]["launches"] == {"flash_attention" if kind == "prefill" else "decode_attention": cfg.num_layers}
    assert short["hlo"]["collective_bytes"]["all-gather"] > 0


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-32b"])
def test_place_params_under_fsdp_round_trips(arch, monkeypatch):
    """Under ``zero_pspecs``' tree (FSDP: the parameters split over the data
    axes too) ``place_params`` stores each device's data part of its
    "model" slice (``zero.Layout``: a feature slice, or whole layers of a
    stack, empty where another data index owns the layer) and
    ``gather_params`` gives the model back bitwise; the mesh's steps do
    not serve such a tree (:func:`test_what_the_slice_leaves_out_raises`)."""
    _, cfg, _, model, _, _ = _setup(arch)
    m = _mesh((2, 2), monkeypatch)
    with S.use_rules(S.SINGLE_POD_RULES):
        pspecs = Z.zero_pspecs(model, S.param_pspecs(model), m)
        assert S.splits_over_data(pspecs, m)
        layout = Z.Layout(model, m, pspecs, param_specs=pspecs)
        placed = Z.place_params(model, m, pspecs)
        back = Z.gather_params(placed, m, pspecs)
    whole = dict(model.named_parameters())
    parts = 0
    for q, copy in enumerate(placed):
        for name, w in copy.named_parameters():
            sl = layout.data_slice(name, q, layout.model_shape(name))
            mine = Z.take(whole[name].detach(), layout.param_slice(name, q, whole[name].shape))
            if layout.fsdp_dim[name] is not None:
                parts += 1
                want = mine[:0] if sl is None else Z.take(mine, sl)
            else:
                want = mine
            assert torch.equal(w, want), (q, name)
    assert parts > 0
    for (name, w), (_, w0) in zip(back.named_parameters(), model.named_parameters()):
        assert torch.equal(w, w0), name


# ------------------------------------------------------------------ raises
def _not_served():
    """(arch, a policy, a FSDP flag, the mesh) for each case the slice
    leaves out: a KV cache split by neither heads nor rows, nor by sequence
    (no policy ``choose_cache_policy`` gives; here for the encoder-decoder,
    whose cross cache is served beside a cache split by heads or by
    sequence); MLA under FSDP (the FSDP reason is named first), MLA whose 4
    query heads do not split over 8 model devices, and MLA at batch 1 on
    (2, 2), its latent cache split by sequence over the data axes too."""
    heads = CachePolicy(1, True, True, ())
    mla = CachePolicy(1, False, True, ("model",))
    return {
        "sequence-over-data-with-heads": ("internlm2-1.8b", CachePolicy(1, True, False, ("data",)), False, (2, 2)),
        "mla": ("deepseek-v2-236b", mla, True, (2, 2)),
        "mla-heads-not-split": ("deepseek-v2-236b", mla, False, (1, 8)),
        "mla-sequence-over-data": ("deepseek-v2-236b", CachePolicy(1, False, False, ("data", "model")), False, (2, 2)),
        "neither-heads-nor-rows": ("whisper-large-v3", CachePolicy(1, False, True, ()), False, (2, 2)),
        "fsdp": ("qwen3-32b", heads, True, (2, 2)),
    }


# what each case's reason names
_REASONS = {"sequence-over-data-with-heads": "split by sequence over data", "mla": "FSDP",
            "mla-heads-not-split": "4 query heads over 8 model devices",
            "mla-sequence-over-data": "latent cache split by sequence over data/model",
            "neither-heads-nor-rows": "neither by heads nor by rows", "fsdp": "FSDP"}


@pytest.mark.parametrize("case", list(_not_served()))
def test_what_the_slice_leaves_out_raises(case, monkeypatch):
    """Each case the slice does not serve raises ``NotImplementedError``
    naming ROADMAP 26b from make_mesh_prefill and make_mesh_decode_step
    (under FSDP: ``zero_pspecs``' tree, the parameters split over the data
    axes too); ``mesh_serving_gap`` names it.  The encoder-decoder and MLA
    with ``choose_cache_policy``'s policy at a batch of the data size on
    (2, 2) are served (``test_torch_serve_mesh_encdec.py``,
    ``test_torch_serve_mesh_mla.py``); at batch 1 the policy is the one
    this case raises for."""
    arch, policy, fsdp, shape = _not_served()[case]
    cfg = configs.get_smoke_config(arch)
    m = _mesh(shape, monkeypatch)
    model = T.TransformerLM(cfg, "meta")
    with S.use_rules(S.SINGLE_POD_RULES):
        pspecs = S.param_pspecs(model)
        if fsdp:
            pspecs = Z.zero_pspecs(model, pspecs, m)
        for make in (D.make_mesh_prefill, D.make_mesh_decode_step):
            with pytest.raises(NotImplementedError, match="26b"):
                make(cfg, m, pspecs, policy)
        assert "26b" in D.mesh_serving_gap(cfg, policy, pspecs, m)
        assert _REASONS[case] in D.mesh_serving_gap(cfg, policy, pspecs, m)
        if case in ("neither-heads-nor-rows", "mla"):
            assert D.mesh_serving_gap(cfg, choose_cache_policy(cfg, 2, 4, 2), S.param_pspecs(model), m) is None
        if case == "mla-sequence-over-data":
            assert choose_cache_policy(cfg, 2, 1, 2) == policy
