"""The training mesh's tensor-parallel layout in the port against the
reference on the CPU: every leaf whose spec (the reference's
``param_pspecs``) has "model" on a dim stored on each model device as that
spec's slice, attention on each device's heads (K3's plain version on the
CPU), the MLP on its columns, the vocabulary on its rows, and the leaves
the compute cannot use as slices gathered before use.

Meshes of logical CPU devices (``REPRO_TORCH_FORCE_DEVICE_COUNT``) of
shapes (1, 2), (2, 2) and (1, 4); the inputs of
``tests/test_torch_train_mesh.py`` (seeded weights, AdamW moments at
count 3, the same batches).  Tolerances: the step against the reference's
single-device step within ``STEP_RTOL`` (1e-5: f32 sums in another order,
the partial outputs' and the shards'); the vocab-parallel per-token losses
within 1e-6 of the single-device ones; placement and gathering bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import sharding as Rsh  # noqa: E402
from repro.training import train_loop as ref_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.device import current_logical  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import train_loop as loop  # noqa: E402

from test_torch_train_mesh import _assert_step, _mesh, _tcfgs  # noqa: E402
from test_torch_training import STEP_AT, _batch, _np, _paths, _rel, _states  # noqa: E402

ARCHS = ["gemma3-1b", "internlm2-1.8b", "whisper-large-v3", "deepseek-v2-236b", "hymba-1.5b", "xlstm-125m"]
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
LOSS_RTOL = 1e-6
# rows a data shard needs for MoE's expert-parallel branch (256 tokens a shard)
MOE_SEQ = 128

_REF: dict = {}


def _reference(arch):
    """The reference's step from ``_states(arch)`` on one device, cached:
    (batch, its new params as numpy, its metrics as floats, the start
    params).  An MoE config takes MOE_SEQ tokens a row (capacity 4: no
    token drops, so the per-shard routing of the expert-parallel branch
    is the whole batch's)."""
    if arch not in _REF:
        ref_cfg, cfg, ref_state, _, params = _states(arch)
        batch = _batch(cfg, b=4, s=MOE_SEQ if cfg.is_moe else 12)
        ref_new, ref_m = jax.jit(ref_loop.make_train_step(ref_cfg, _tcfgs()[0]))(
            ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        _REF[arch] = (batch, jax.tree.map(np.asarray, ref_new["params"]),
                      {k: float(v) for k, v in ref_m.items()}, params)
    return _REF[arch]


def _place(state, mesh):
    with S.use_rules(S.SINGLE_POD_RULES), mesh:
        specs = Z.zero_pspecs(state["params"], S.param_pspecs(state["params"]), mesh)
        return Z.place_train_state(state, mesh, specs), specs


# ------------------------------------------------------------------- step
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_step_against_reference(arch, mesh, monkeypatch):
    """One step of the mesh's tensor-parallel layout against the reference's
    single-device step: loss, grad norm and each leaf's update.  Attention
    runs on every model device (its heads) where the heads split, and on
    the lead alone over the gathered leaves where they do not (hymba's 5
    heads over 2 or 4)."""
    batch, ref_params, ref_m, params = _reference(arch)
    _, cfg, _, state, _ = _states(arch)
    shape = MESHES[mesh]
    seen = set()
    real = L.attention_scores_blockwise

    def spy(*args, **kw):
        seen.add(current_logical().label)
        return real(*args, **kw)

    monkeypatch.setattr(L, "attention_scores_blockwise", spy)
    m = _mesh(shape, monkeypatch)
    with S.use_rules(S.SINGLE_POD_RULES), m:
        specs = Z.zero_pspecs(state["params"], S.param_pspecs(state["params"]), m)
        placed = Z.place_train_state(state, m, specs)
        step = loop.make_train_step(cfg, _tcfgs()[1], grad_pspecs=specs)
    new, metrics = step(placed, batch)
    with S.use_rules(S.SINGLE_POD_RULES):
        got = Z.gather_train_state(new, m, specs)
    _assert_step(got, metrics, ref_params, ref_m, params, (arch, mesh))
    assert int(_np(got["step"])) == STEP_AT + 1 and int(_np(got["opt"]["count"])) == 4
    if cfg.family != "ssm":
        leads = {dev.label for dev in m.flat[::shape[1]]}
        heads = L.heads_split(cfg, shape[1]) if cfg.attn_type == "gqa" else cfg.num_heads % shape[1] == 0
        assert seen == ({dev.label for dev in m.flat} if heads else leads), (arch, mesh, seen)


# -------------------------------------------------------------- placement
def _spec_slice(a: np.ndarray, spec, mesh, pos: int) -> np.ndarray:
    """The part of ``a`` that ``spec`` gives the device at ``pos``: each
    dim split over its axes' sizes (row-major over a tuple of axes)."""
    coords, idx = mesh.coords(pos), []
    for dim, axes in zip(a.shape, list(spec) + [None] * (a.ndim - len(spec))):
        if axes is None:
            idx.append(slice(None))
            continue
        i, n = 0, 1
        for ax in (axes if isinstance(axes, tuple) else (axes,)):
            i, n = i * mesh.shape[ax] + int(coords[ax]), n * mesh.shape[ax]
        width = dim // n
        idx.append(slice(i * width, (i + 1) * width))
    return a[tuple(idx)]


def _node(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v2-236b", "hymba-1.5b", "xlstm-125m", "whisper-large-v3"])
def test_placed_leaves_are_the_reference_specs_slices(arch, mesh, monkeypatch):
    """Each device's parameter is bitwise the numpy slice the reference's
    spec (``param_pspecs`` under SINGLE_POD_RULES) names for its mesh
    position, its m and v the slices of the ZeRO specs (the parameter's
    "model" entries and the data axes on one free dim; a layer group
    split by whole layers), and ``gather_train_state`` gives every leaf
    and moment back whole, bitwise."""
    _, _, ref_state, state, params = _states(arch)
    m_tree = jax.tree.map(np.asarray, ref_state["opt"]["m"])
    v_tree = jax.tree.map(np.asarray, ref_state["opt"]["v"])
    with Rsh.use_rules(Rsh.SINGLE_POD_RULES):
        ref_specs = Rsh.param_pspecs(params)
    m = _mesh(MESHES[mesh], monkeypatch)
    placed, specs = _place(state, m)
    split = 0
    for q in range(m.size):
        named = dict(placed["params"][q].named_parameters())
        for name, w in named.items():
            path, index = T._jax_path(name)
            spec = tuple(_node(ref_specs, path))
            want = _spec_slice(_node(params, path), spec, m, q)
            assert np.array_equal(_np(w), want if index is None else want[index]), (q, name)
            split += "model" in spec
            # the moments' spec: the parameter's, and the data axes on one free dim
            zspec = tuple(S.spec_at(specs, name))
            assert [None if a == "data" else a for a in zspec] == list(spec) + [None] * (len(zspec) - len(spec))
            for key, tree in (("m", m_tree), ("v", v_tree)):
                part = _spec_slice(_node(tree, path), zspec, m, q)
                if index is None:
                    assert np.array_equal(_np(placed["opt"][key][q][name]), part), (key, q, name)
                    continue
                layers = _spec_slice(np.arange(_node(tree, path).shape[0]), zspec[:1], m, q)
                assert (name in placed["opt"][key][q]) == (index in layers), (key, q, name)
                if index in layers:
                    got = placed["opt"][key][q][name]
                    assert np.array_equal(_np(got), part[index - int(layers[0])]), (key, q, name)
    assert split > 0
    with S.use_rules(S.SINGLE_POD_RULES):
        back = Z.gather_train_state(placed, m, specs)
    tree = T.to_jax_layout(back["params"])
    for (path, got), (_, want) in zip(_paths(tree), _paths(params)):
        assert np.array_equal(_np(got), np.asarray(want, np.float32)), path
    for key, ref_tree in (("m", m_tree), ("v", v_tree)):
        for (path, got), (_, want) in zip(_paths(T.stack_jax_layout(back["opt"][key].items())), _paths(ref_tree)):
            assert np.array_equal(_np(got), want), (key, path)


def test_a_model_dim_that_does_not_split_raises(monkeypatch):
    """gemma3-1b's smoke vocabulary (512 rows) over 3 model devices."""
    _, _, _, state, _ = _states("gemma3-1b")
    with pytest.raises(ValueError, match="does not split over 3 model devices"):
        _place(state, _mesh((1, 3), monkeypatch))


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-1b"])
def test_vocab_parallel_token_losses(arch, tp, monkeypatch):
    """``token_losses`` over the model group's vocab slices against the
    single-device one: internlm2's 211 words padded to 256 (the padding in
    the last slice, masked to -1e30) with an ``lm_head``, gemma's tied
    embedding.  The embedding's lookup is vocab-parallel too, and
    ``forward_train``'s logits, gathered whole on the lead, are the
    single-device ones."""
    _, cfg, _, state, _ = _states(arch)
    tokens = torch.from_numpy(_batch(cfg, b=2, s=12)["tokens"]).long()
    with torch.no_grad():
        want = loop.token_losses(state["params"], cfg, tokens[:, :-1], tokens[:, 1:])
        logits = T.forward_train(state["params"], cfg, tokens)
    m = _mesh((1, tp), monkeypatch)
    placed, specs = _place(state, m)
    layout = Z.Layout(placed["params"][0], m, specs, S.SINGLE_POD_RULES)
    shard = S.TensorShard(m.flat, placed["params"], layout.model_dim, tp)
    with torch.no_grad(), S.use_rules(S.SINGLE_POD_RULES), m, S.tensor_shard(shard):
        assert T.vocab_split(placed["params"][0], cfg) is shard
        got = loop.token_losses(placed["params"][0], cfg, tokens[:, :-1], tokens[:, 1:])
        got_logits = T.forward_train(placed["params"][0], cfg, tokens)
        parts = T.logits_parts(placed["params"][0], cfg, T.embed_tokens(placed["params"][0], cfg, tokens[:, :1]),
                               shard)
    assert _rel(_np(got), _np(want)) <= LOSS_RTOL
    v = cfg.vocab_size  # the padding's -1e30 would hide any error in a relative bound
    assert got_logits.shape == logits.shape and torch.equal(got_logits[..., v:], logits[..., v:])
    assert _rel(_np(got_logits[..., :v]), _np(logits[..., :v])) <= LOSS_RTOL
    width = cfg.padded_vocab_size // tp
    assert [(start, lg.shape[-1]) for _, lg, start in parts] == [(i * width, width) for i in range(tp)]
    last, real = _np(parts[-1][1]), cfg.vocab_size - (tp - 1) * width  # the last slice's real words
    assert (last[..., real:] == np.float32(-1e30)).all() and (last[..., :real] > -1e29).all()
    assert (real < width) == (cfg.vocab_size < cfg.padded_vocab_size)


# ------------------------------------------------------------- collectives
def test_all_gather_and_its_reduce_scatter(monkeypatch):
    """``all_gather`` joins the parts in order on each receiver; its
    backward gives each part the sum of the receivers' gradients of its
    slice, and a scatter with one receiver."""
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "3")
    from repro_torch import device as D

    devices = D.mesh_devices("cpu")
    rng = np.random.default_rng(3)
    parts = [torch.tensor(rng.normal(size=(4, 5)), dtype=torch.float32, requires_grad=True) for _ in devices]
    wholes = C.all_gather(parts, devices, 1)
    assert all(torch.equal(w, torch.cat([p.detach() for p in parts], 1)) for w in wholes)
    weights = [torch.tensor(rng.normal(size=(4, 15)), dtype=torch.float32) for _ in devices]
    grads = torch.autograd.grad(sum((w * g).sum() for w, g in zip(wholes, weights)), parts)
    total = sum(weights[1:], weights[0])
    for i, g in enumerate(grads):
        assert torch.allclose(g, total[:, 5 * i:5 * (i + 1)], rtol=0, atol=1e-6)
    lead = C.all_gather(parts, devices, 0, at=(0,))
    assert len(lead) == 1 and lead[0].shape == (12, 5)
    grads = torch.autograd.grad((lead[0] * 2).sum(), parts)
    assert all(torch.equal(g, torch.full((4, 5), 2.0)) for g in grads)


def test_tensor_shard_nests_and_is_reinstalled_for_recompute(monkeypatch):
    """``sharding.tensor_shard`` nests and unwinds, and a layer's recompute
    (``remat_kwargs``) reinstalls it with the forward's logical device."""
    m = _mesh((1, 2), monkeypatch)
    _, _, _, state, _ = _states("gemma3-1b")
    placed, specs = _place(state, m)
    layout = Z.Layout(placed["params"][0], m, specs, S.SINGLE_POD_RULES)
    shard = S.TensorShard(m.flat, placed["params"], layout.model_dim, 2)
    assert S.current_tensor_shard() is None
    with m.flat[0].scope(), S.tensor_shard(shard):
        with S.tensor_shard(None):
            assert S.current_tensor_shard() is None
        assert S.current_tensor_shard() is shard
        _, recompute = S.remat_kwargs()["context_fn"]()
    assert S.current_tensor_shard() is None and current_logical() is None
    with recompute:
        assert S.current_tensor_shard() is shard and current_logical() is m.flat[0]
    lead = placed["params"][0]
    assert shard.is_split(lead.embed) and not shard.is_split(lead.final_norm.scale)
    assert shard.members(lead.layers[0].attn) == [c.layers[0].attn for c in placed["params"]]
    cfg = configs.get_smoke_config("gemma3-1b")
    whole = shard.whole(lead.layers[0].attn)
    assert lead.layers[0].attn.wq.shape == (cfg.d_model, cfg.num_heads * cfg.resolved_head_dim // 2)
    assert whole.wq.shape == (cfg.d_model, cfg.num_heads * cfg.resolved_head_dim)
    assert whole.q_norm is lead.layers[0].attn.q_norm


def test_moe_router_is_stored_split_and_gathered(monkeypatch):
    """OLMoE's router (spec (None, "experts")) is stored as its column
    slice on each model device and joined back whole."""
    _, cfg, _, state, params = _states("olmoe-1b-7b")
    m = _mesh((1, 2), monkeypatch)
    placed, _ = _place(state, m)
    router = params["layers"]["moe"]["router"][0]
    for q, copy in enumerate(placed["params"]):
        e = cfg.num_experts // 2
        assert np.array_equal(_np(copy.layers[0].moe.router), router[:, q * e:(q + 1) * e])
