"""FSDP on the training mesh in the port against the reference on the CPU:
the parameters placed under ``zero_pspecs`` of their specs (what the
reference's ``maybe_fsdp_pspecs`` returns above its threshold, equal to
the moments' tree), each device storing its data part of every leaf —
a feature dimension's slice, or whole layers of a layer group, none of
the others — each layer gathering its leaves before use
(``sharding.gathered``: ``collectives.all_gather`` over the data column,
or ``collectives.send`` from the layer's owner), their gradients brought
back to the stored parts, and AdamW updating those parts in place.

Meshes of logical CPU devices (``REPRO_TORCH_FORCE_DEVICE_COUNT``) of
shapes (2, 1) and (2, 2); the inputs of ``tests/test_torch_train_mesh.py``
and ``tests/test_torch_tensor_parallel.py`` (seeded weights, AdamW
moments at count 3, the same batches).  Tolerances: the step against the
reference's single-device step within ``STEP_RTOL`` (1e-5: f32 sums in
another order, the shards' and the partial outputs'); placement,
gathering and the collectives bitwise.
"""

import dataclasses
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.distributed import sharding as Rsh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import specs as LS  # noqa: E402
from repro_torch.launch.mesh import RoleMesh, make_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import train_loop as loop  # noqa: E402

from test_torch_tensor_parallel import _node, _reference, _spec_slice  # noqa: E402
from test_torch_train_mesh import _assert_step, _mesh, _tcfgs  # noqa: E402
from test_torch_train_mesh import _reference as _reference_accum  # noqa: E402
from test_torch_training import STEP_AT, _batch, _np, _paths, _states  # noqa: E402

ARCHS = ["gemma3-1b", "qwen3-32b", "internlm2-20b", "deepseek-v2-236b", "whisper-large-v3", "hymba-1.5b"]
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}


def _fsdp_specs(state, mesh):
    """The FSDP tree: ``zero_pspecs`` of the parameters' specs."""
    return Z.zero_pspecs(state["params"], S.param_pspecs(state["params"]), mesh)


def _place(state, mesh):
    with S.use_rules(S.SINGLE_POD_RULES), mesh:
        specs = _fsdp_specs(state, mesh)
        return Z.place_train_state(state, mesh, specs, param_specs=specs), specs


def _fsdp_step(state, cfg, tcfg, batch, mesh):
    """Place ``state`` under FSDP, take one step, read it back -> (the
    placed state after it, its metrics, the gathered state, the specs)."""
    placed, specs = _place(state, mesh)
    with S.use_rules(S.SINGLE_POD_RULES), mesh:
        step = loop.make_train_step(cfg, tcfg, grad_pspecs=specs, param_pspecs=specs)
    new, metrics = step(placed, batch)
    with S.use_rules(S.SINGLE_POD_RULES):
        return new, metrics, Z.gather_train_state(new, mesh, specs, param_specs=specs), specs


# ------------------------------------------------------------------- step
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_step_against_reference(arch, mesh, monkeypatch):
    """One FSDP step against the reference's single-device step: loss,
    grad norm and each leaf's update.  gemma3-1b splits its layers over
    the data axes (whole layers) and the embedding and final norm on a
    feature dim, its one KV head gathered over data, then over "model";
    qwen3-32b's qk-norm scales are split by layer and replicated over
    "model"; internlm2-20b's 3 layers do not divide 2, so every stacked
    leaf splits on a feature dim; deepseek-v2-236b's dense prefix (1 layer)
    on a feature dim, its MoE layers (experts, router, MLA) by layer, the
    experts gathered before the expert-parallel branch; whisper-large-v3's
    encoder and cross blocks; hymba-1.5b's 5 heads and Mamba leaves
    gathered over data, then whole on the lead.  Every device ends with the
    same grad norm."""
    batch, ref_params, ref_m, params = _reference(arch)
    _, cfg, _, state, _ = _states(arch)
    m = _mesh(MESHES[mesh], monkeypatch)
    new, metrics, got, specs = _fsdp_step(state, cfg, _tcfgs()[1], batch, m)
    _assert_step(got, metrics, ref_params, ref_m, params, (arch, mesh))
    assert int(_np(got["step"])) == STEP_AT + 1 and int(_np(got["opt"]["count"])) == 4
    assert all(torch.equal(g, metrics["grad_norm"]) for g in metrics["grad_norms"])
    with S.use_rules(S.SINGLE_POD_RULES):
        layout = Z.Layout(new["params"][0], m, specs, param_specs=specs)
    assert all(layout.fsdp_dim[n] is not None for n in layout.names)


def test_fsdp_grad_accum(monkeypatch):
    """grad_accum=2 on (2, 2): each part's gradient summed over the shards
    and the microbatches."""
    batch, ref_params, ref_m, params = _reference_accum("gemma3-1b", accum=2)
    _, cfg, _, state, _ = _states("gemma3-1b")
    _, metrics, got, _ = _fsdp_step(state, cfg, _tcfgs(2)[1], batch, _mesh((2, 2), monkeypatch))
    _assert_step(got, metrics, ref_params, ref_m, params)


# -------------------------------------------------------------- placement
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["gemma3-1b", "internlm2-20b", "deepseek-v2-236b"])
def test_placed_leaves_are_the_fsdp_specs_slices(arch, mesh, monkeypatch):
    """Each device's parameter and its m and v are bitwise the numpy slice
    the FSDP spec names for its mesh position (a layer group split by
    whole layers: the owner holds the layer, every other device an empty
    tensor); the bytes a device holds are ``specs._spec_bytes`` of the
    FSDP tree (parameters, m and v) and the two scalars; and
    ``gather_train_state`` gives every leaf and moment back whole,
    bitwise."""
    _, _, ref_state, state, params = _states(arch)
    trees = {"p": params, "m": jax.tree.map(np.asarray, ref_state["opt"]["m"]),
             "v": jax.tree.map(np.asarray, ref_state["opt"]["v"])}
    with Rsh.use_rules(Rsh.SINGLE_POD_RULES):
        ref_specs = Rsh.param_pspecs(params)
    m = _mesh(MESHES[mesh], monkeypatch)
    placed, specs = _place(state, m)
    empty = 0
    for q in range(m.size):
        named = dict(placed["params"][q].named_parameters())
        for name, w in named.items():
            path, index = T._jax_path(name)
            spec = tuple(S.spec_at(specs, name))
            # the reference's spec, the data axes on one free dim
            assert [None if a == "data" else a for a in spec] == list(_node(ref_specs, path)) + [None] * (
                len(spec) - len(_node(ref_specs, path)))
            got = {"p": w, "m": placed["opt"]["m"][q].get(name), "v": placed["opt"]["v"][q].get(name)}
            for key, tree in trees.items():
                want = _spec_slice(np.asarray(_node(tree, path), np.float32), spec, m, q)
                if index is not None:
                    layers = _spec_slice(np.arange(_node(tree, path).shape[0]), spec[:1], m, q)
                    if index not in layers:  # a layer another data index owns
                        assert (got[key] is None) if key != "p" else got[key].numel() == 0, (key, q, name)
                        empty += key == "p"
                        continue
                    want = want[index - int(layers[0])]
                assert np.array_equal(_np(got[key]), want), (key, q, name)
        held = Z.Layout(placed["params"][q], m, specs, S.SINGLE_POD_RULES, specs)
        assert all(held.holds(n, q) == (named[n].numel() > 0) for n in named)
        shapes = Z._shapes(state["params"])
        with S.use_rules(S.SINGLE_POD_RULES):
            want_bytes = 3 * LS._spec_bytes(shapes, specs, m, 4) + 2 * 4
        ts = [*named.values(), *placed["opt"]["m"][q].values(), *placed["opt"]["v"][q].values(),
              placed["opt"]["count"][q], placed["step"][q]]
        assert sum(t.numel() * t.element_size() for t in ts) == want_bytes, q
    assert (empty > 0) == (arch != "internlm2-20b")  # internlm2's 3 layers split on a feature dim
    with S.use_rules(S.SINGLE_POD_RULES):
        back = Z.gather_train_state(placed, m, specs, param_specs=specs)
    for (path, got), (_, want) in zip(_paths(T.to_jax_layout(back["params"])), _paths(params)):
        assert np.array_equal(_np(got), np.asarray(want, np.float32)), path
    for key in ("m", "v"):
        for (path, got), (_, want) in zip(_paths(T.stack_jax_layout(back["opt"][key].items())), _paths(trees[key])):
            assert np.array_equal(_np(got), want), (key, path)


def test_a_parameter_spec_that_splits_another_dim_raises(monkeypatch):
    """An FSDP spec whose data dim is not the moments' is refused."""
    _, _, _, state, _ = _states("gemma3-1b")
    m = _mesh((2, 1), monkeypatch)
    with S.use_rules(S.SINGLE_POD_RULES), m:
        specs = _fsdp_specs(state, m)
        other = {**specs, "final_norm": {"scale": S.P(None)}, "embed": S.P("data", None)}
        with pytest.raises(ValueError, match="splits another dim"):
            Z.place_train_state(state, m, specs, param_specs=other)


# ------------------------------------------------------------------ remat
def test_forward_and_recompute_each_gather_a_layer_once(monkeypatch):
    """Under remat each layer's leaves are gathered once in the forward and
    once in the backward's recompute, on each data shard's lead; the
    embedding and the head outside the layers once each a shard; after the
    step every copy holds its stored parts again."""
    _, cfg, _, state, _ = _states("gemma3-1b")
    batch = _batch(cfg, b=4, s=12)
    m = _mesh((2, 1), monkeypatch)
    placed, specs = _place(state, m)
    calls: dict = {}
    real = S.DataShards.gather

    def spy(self, name, q):
        calls[(name, q)] = calls.get((name, q), 0) + 1
        return real(self, name, q)

    monkeypatch.setattr(S.DataShards, "gather", spy)
    stored = [dict(c.named_parameters()) for c in placed["params"]]
    with S.use_rules(S.SINGLE_POD_RULES), m:
        step = loop.make_train_step(cfg, _tcfgs()[1], grad_pspecs=specs, param_pspecs=specs)
    step(placed, batch)
    for q in range(2):
        for layer in range(cfg.num_layers):
            assert calls[(f"layers.{layer}.attn.wq", q)] == 2, (q, layer)
            assert calls[(f"layers.{layer}.mlp_norm.scale", q)] == 2, (q, layer)
        assert calls[("embed", q)] == 2 and calls[("final_norm.scale", q)] == 1  # tied: lookup and logits
    for c, named in zip(placed["params"], stored):
        assert all(w is named[n] for n, w in c.named_parameters())


def test_gathered_layer_is_freed_after_the_forward(monkeypatch):
    """A layer's gathered leaves live only inside the layer: the
    forward's graph keeps none of them, the copy holds its stored parts
    again, and the backward's recompute gathers them anew, its gradient
    reaching the owner's stored layer."""
    _, cfg, _, state, _ = _states("gemma3-1b")
    m = _mesh((2, 1), monkeypatch)
    placed, specs = _place(state, m)
    with S.use_rules(S.SINGLE_POD_RULES):
        layout = Z.Layout(placed["params"][0], m, specs, param_specs=specs)
    fsdp = S.DataShards(m.flat, placed["params"], layout)
    blk = placed["params"][1].layers[1]  # data index 0 owns layer 1: data index 1 gathers it from there
    refs = []
    real = S.DataShards.gather

    def spy(self, name, q):
        out = real(self, name, q)
        refs.append(weakref.ref(out))
        return out

    monkeypatch.setattr(S.DataShards, "gather", spy)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 4, cfg.d_model)).astype(np.float32))
    x.requires_grad_(True)
    whole = (cfg.d_model, cfg.num_heads * cfg.resolved_head_dim)
    with S.use_rules(S.SINGLE_POD_RULES), m, S.data_shards(fsdp), m.flat[1].scope():
        with S.gathered(blk):
            assert blk.attn.wq.shape == whole
        assert blk.attn.wq.numel() == 0
        refs.clear()
        y = T._run(T._block_full, True, blk, cfg, x, torch.arange(4), True)
    n = len(refs)
    assert n == len(list(blk.parameters())) and all(r() is None for r in refs)
    owner = fsdp.named[0]["layers.1.attn.wq"]
    (g,) = torch.autograd.grad(y.sum(), [owner])
    assert len(refs) == 2 * n and g.shape == whole and bool(g.abs().sum() > 0)


# ------------------------------------------------------------ collectives
def test_send_and_its_gradient(monkeypatch):
    """``send`` copies a tensor to another device, made there; its
    gradient comes back to the source."""
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "2")
    from repro_torch import device as D

    devices = D.mesh_devices("cpu")
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(3, 5)), dtype=torch.float32, requires_grad=True)
    y = C.send(x, devices, 0, 1)
    assert torch.equal(y, x.detach()) and y.data_ptr() != x.data_ptr()
    w = torch.tensor(rng.normal(size=(3, 5)), dtype=torch.float32)
    (g,) = torch.autograd.grad((y * w).sum(), [x])
    assert torch.equal(g, w)


def test_role_mesh_layer_owners_have_stand_ins():
    """On a ``RoleMesh`` of (4, 4), which keeps data indices 0-2, a layer
    that data index 3 owns is gathered from a stand-in: the column's
    device at index 3 mod 3 and its own layer at the same offset (the same
    shape); a present owner is itself."""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-32b"), num_layers=8)
    model = T.TransformerLM(cfg, "meta", torch.float32)
    roles = RoleMesh(make_mesh((4, 4), ("data", "model"), H.trace_devices(16)))
    with S.use_rules(S.SINGLE_POD_RULES), roles:
        specs = Z.zero_pspecs(model, S.param_pspecs(model), roles)
        layout = Z.Layout(model, roles, specs, param_specs=specs)
    assert layout.fsdp_dim["layers.7.attn.wq"] == -1
    pos = 4  # data index 1, model index 1
    column = layout.column(pos)
    assert [layout.data_index[q] for q in column] == [0, 1, 2]
    assert layout.owner("layers.5.attn.wq", pos) == (column[2], "layers.5.attn.wq")
    assert layout.owner("layers.7.attn.wq", pos) == (column[1], "layers.3.attn.wq")  # (1 + 3) % 3
    assert layout.owner("layers.7.attn.wq", column[0]) == (column[0], "layers.1.attn.wq")
    assert layout.holds("layers.3.attn.wq", column[1]) and not layout.holds("layers.7.attn.wq", column[1])


@pytest.mark.parametrize("shape", [(4, 1), (4, 2)])
def test_role_mesh_trace_equals_a_full_trace_under_fsdp(monkeypatch, shape):
    """A train cell of qwen3-32b's smoke config at 8 layers placed under
    the FSDP tree on (4, 1) and (4, 2), traced on its RoleMesh (data
    indices 0-2: layers by whole layers, a stand-in for the owner of
    layers 6-7; the embedding, the head and the final norm on a feature
    dim) counts what a trace of every device counts, per device — its
    gathers and the reduce-scatters each stored feature slice receives
    from every data shard's gather (the RoleMesh's last data shard stands
    for the one it leaves out, ``_build.counted``), its launches, FLOPs
    and placed bytes.  Its traffic is short by exactly the autograd
    engine's sums of those scatters, which run outside the collective: a
    stored slice adds up one gradient fewer for the data shard left out,
    and each such add reads two slices and writes one.  The bytes made are
    left out: the grad norm's ring over a data column pads its buffer to a
    multiple of the column's 3 devices, not 4."""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-32b"), num_layers=8, head_dim=64)
    monkeypatch.setattr(LS, "FSDP_THRESHOLD_BYTES", 0)
    cell = InputShape("c", "train", 32, 16)
    mesh = make_mesh(shape, ("data", "model"), H.trace_devices(shape[0] * shape[1]))
    short = dryrun.run_cell(cfg, cell, mesh)
    monkeypatch.setattr(LS, "RoleMesh", lambda m: m)
    full = dryrun.run_cell(cfg, cell, mesh)
    fed = ("traffic_bytes", "temp_bytes")
    assert {k: v for k, v in short["hlo"].items() if k not in fed} == {
        k: v for k, v in full["hlo"].items() if k not in fed}
    got, want = short["hlo"]["collective_bytes"], full["hlo"]["collective_bytes"]
    assert got == want and got["reduce-scatter"] > 0
    model = T.TransformerLM(cfg, "meta", torch.float32)
    with S.use_rules(S.SINGLE_POD_RULES), mesh:
        specs = _fsdp_specs({"params": model}, mesh)
        layout = Z.Layout(model, mesh, specs, param_specs=specs)
    stored = sum(p.numel() * 4 // shape[0] // (shape[1] if layout.model_dim[n] is not None else 1)
                 for n, p in model.named_parameters() if layout.fsdp_dim[n] not in (None, -1))
    assert stored > 0
    assert full["hlo"]["traffic_bytes"] - short["hlo"]["traffic_bytes"] == 3 * (shape[0] - 3) * stored
    for key in ("argument_bytes", "reference_layout_argument_bytes"):
        assert short["memory"][key] == full["memory"][key], key
    assert short["memory"]["argument_bytes"] == short["memory"]["reference_layout_argument_bytes"]
