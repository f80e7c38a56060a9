"""The training mesh's collectives, compression, ZeRO specs and sharding
rules in the port against the reference, on 2, 3 and 4 logical CPU
devices (``REPRO_TORCH_FORCE_DEVICE_COUNT``, set per test).

The reference's side is its own single-device form: ``vmap`` with an axis
name over a stacked leading axis, as ``tests/test_distributed.py`` runs it;
``zero_pspecs`` reads only ``mesh.shape``, so a stand-in with a ``shape``
dict serves for its meshes.  Tolerances, each with its reason:

* ``ring_allreduce``, ``quantize_int8`` and ``ef_quantize``: bitwise (the
  same f32 adds in the same order; ``torch.round`` and ``jnp.round`` both
  round half to even, and both divide by the scale);
* ``psum_in_chunks`` and ``compressed_psum_pod``: 1e-6 relative to the
  largest |sum| (the reference's ``psum`` and ``sum`` add in XLA's order);
  the bucket assignment and the int8 payloads exactly;
* specs and ratios: equal.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import collectives as RC  # noqa: E402
from repro.distributed import compression as RCOMP  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.distributed import zero as RZ  # noqa: E402
from repro.launch import mesh as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import device as D  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import compression as COMP  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

PSUM_RTOL = 1e-6
DEVICE_COUNTS = [2, 3, 4]
RULES = {"single": RS.SINGLE_POD_RULES, "multi": RS.MULTI_POD_RULES}
PORT_RULES = {"single": S.SINGLE_POD_RULES, "multi": S.MULTI_POD_RULES}


def _devices(n, monkeypatch):
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, str(n))
    return D.mesh_devices("cpu")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _parts(x):
    return [torch.from_numpy(np.array(row)) for row in x]


# ------------------------------------------------------------------- ring
@pytest.mark.parametrize("shape", [(37,), (64,), (3, 5, 7)], ids=["37-padded", "64", "3x5x7"])
@pytest.mark.parametrize("n", DEVICE_COUNTS)
def test_ring_allreduce_is_the_references_bitwise(n, shape, monkeypatch):
    devices = _devices(n, monkeypatch)
    x = np.random.default_rng(n).normal(size=(n, *shape)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda v: RC.ring_allreduce(v, "r"), axis_name="r")(jnp.asarray(x)))
    parts = _parts(x)
    got = C.ring_allreduce(parts, devices)
    for i in range(n):
        assert got[i].shape == shape
        np.testing.assert_array_equal(got[i].numpy(), want[i])
        np.testing.assert_array_equal(got[i].numpy(), got[0].numpy())  # the same bits everywhere
        np.testing.assert_array_equal(parts[i].numpy(), x[i])  # inputs unchanged


def test_ring_allreduce_on_one_device_is_the_input(monkeypatch):
    devices = _devices(1, monkeypatch)
    x = torch.arange(5.0)
    assert C.ring_allreduce([x], devices)[0] is x


# ---------------------------------------------------------- psum_in_chunks
def _tree(rng, n):
    shapes = {"a": (8,), "b": (3, 4), "c": (2,), "d": (5, 3), "e": (12,), "f": (3, 4), "g": (1,)}
    return {key: rng.normal(size=(n, *shape)).astype(np.float32) for key, shape in shapes.items()}


@pytest.mark.parametrize("num_buckets", [2, 4])
@pytest.mark.parametrize("n", DEVICE_COUNTS)
def test_psum_in_chunks_is_the_references(n, num_buckets, monkeypatch):
    devices = _devices(n, monkeypatch)
    tree = _tree(np.random.default_rng(10 + n), n)
    calls = []
    psum = jax.lax.psum

    def spy(x, axis_name, **kw):
        calls.append([tuple(leaf.shape) for leaf in x])
        return psum(x, axis_name, **kw)

    monkeypatch.setattr(jax.lax, "psum", spy)
    want = jax.vmap(lambda t: RC.psum_in_chunks(t, "x", num_buckets=num_buckets), axis_name="x")(
        jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(jax.lax, "psum", psum)
    keys = sorted(tree)
    sizes = [tree[k][0].size for k in keys]
    buckets = [b for b in C.bucket_leaves(sizes, num_buckets) if b]
    assert [[tree[keys[i]].shape[1:] for i in b] for b in buckets] == calls
    got = C.psum_in_chunks([{k: torch.from_numpy(v[i]) for k, v in tree.items()} for i in range(n)], devices,
                           num_buckets=num_buckets)
    for i in range(n):
        assert list(got[i]) == list(tree)
        for k in keys:
            assert got[i][k].shape == tree[k].shape[1:]
            assert _rel(got[i][k].numpy(), np.asarray(want[k][i])) <= PSUM_RTOL, k
            np.testing.assert_array_equal(got[i][k].numpy(), got[0][k].numpy())


# ------------------------------------------------------------- compression
def _quant_inputs():
    rng = np.random.default_rng(3)
    return {
        "normal": rng.normal(size=(7, 13)).astype(np.float32),
        "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -3.5], np.float32),  # scale 1: half-even
        "tiny": (1e-14 * rng.normal(size=(9,))).astype(np.float32),  # the 1e-12 floor
    }


@pytest.mark.parametrize("case", list(_quant_inputs()))
def test_quantize_int8_is_the_references_bitwise(case):
    x = _quant_inputs()[case]
    q, s = COMP.quantize_int8(torch.from_numpy(x))
    rq, rs = RCOMP.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(COMP.dequantize_int8(q, s).numpy(), np.asarray(RCOMP.dequantize_int8(rq, rs)))


@pytest.mark.parametrize("steps", [1, 5])
def test_ef_quantize_is_the_references_bitwise(steps):
    rng = np.random.default_rng(4)
    err, rerr = torch.zeros(40), jnp.zeros(40)
    for _ in range(steps):
        g = rng.normal(size=(40,)).astype(np.float32)
        q, s, err = COMP.ef_quantize(torch.from_numpy(g), err)
        rq, rs, rerr = RCOMP.ef_quantize(jnp.asarray(g), rerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(err.numpy(), np.asarray(rerr))


def test_compress_gradients_is_the_references():
    rng = np.random.default_rng(5)
    grads = {"w": rng.normal(size=(4, 6)).astype(np.float32), "b": {"x": rng.normal(size=(3,)).astype(np.float32)}}
    (q, s), errs = COMP.compress_gradients(jax.tree.map(torch.from_numpy, grads),
                                           COMP.init_error_state(jax.tree.map(torch.from_numpy, grads)))
    (rq, rs), rerrs = RCOMP.compress_gradients(jax.tree.map(jnp.asarray, grads),
                                               RCOMP.init_error_state(jax.tree.map(jnp.asarray, grads)))
    for a, b in ((q, rq), (s, rs), (errs, rerrs), (COMP.decompress_gradients((q, s)),
                                                   RCOMP.decompress_gradients((rq, rs)))):
        assert jax.tree.structure(jax.tree.map(lambda t: 0, a)) == jax.tree.structure(jax.tree.map(lambda t: 0, b))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("n", DEVICE_COUNTS)
def test_compressed_psum_pod_is_the_references(n, monkeypatch):
    devices = _devices(n, monkeypatch)
    rng = np.random.default_rng(20 + n)
    xs = rng.normal(size=(n, 16)).astype(np.float32)
    es = (1e-3 * rng.normal(size=(n, 16))).astype(np.float32)
    want, want_err = jax.vmap(lambda x, e: RCOMP.compressed_psum_pod(x, e, "pod"), axis_name="pod")(
        jnp.asarray(xs), jnp.asarray(es))
    got, got_err = COMP.compressed_psum_pod(_parts(xs), _parts(es), devices)
    for i in range(n):
        assert _rel(got[i].numpy(), np.asarray(want[i])) <= PSUM_RTOL
        np.testing.assert_array_equal(got[i].numpy(), got[0].numpy())
        np.testing.assert_array_equal(got_err[i].numpy(), np.asarray(want_err[i]))
    assert _rel(got[0].numpy(), xs.sum(0)) < 2e-2  # the reference's own bound on the exact sum


@pytest.mark.parametrize("shapes", [((1000,), (10,)), ((3, 4), (1,), (256, 2))])
def test_compression_ratio_is_the_references(shapes):
    tree = {f"l{i}": np.zeros(shape, np.float32) for i, shape in enumerate(shapes)}
    assert COMP.compression_ratio(jax.tree.map(torch.from_numpy, tree)) == RCOMP.compression_ratio(
        jax.tree.map(jnp.asarray, tree))


# ------------------------------------------------------------------ specs
def _flat_specs(tree) -> dict:
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: s for k, v in tree.items() for p, s in _flat_specs(v).items()}
    return {"": tuple(tree)}


def _ref_flat_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {RS._path_str(path): tuple(spec) for path, spec in flat}


def _specs(arch, rules):
    """(the reference's param specs and shapes, the port's specs and
    meta model) for the smoke config, under ``rules``."""
    ref_cfg = ref_configs.get_smoke_config(arch)
    shapes = jax.eval_shape(lambda: RT.init_lm(ref_cfg, jax.random.PRNGKey(0)))
    model = T.TransformerLM(configs.get_smoke_config(arch), "meta", torch.float32)
    with RS.use_rules(RULES[rules]):
        ref = RS.param_pspecs(shapes)
    with S.use_rules(PORT_RULES[rules]):
        got = S.param_pspecs(model)
    return shapes, ref, model, got


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("arch", ref_configs.ARCH_NAMES)
def test_param_pspecs_are_the_references(arch, rules):
    _, ref, _, got = _specs(arch, rules)
    assert _flat_specs(got) == _ref_flat_specs(ref)


MESHES = {"1x1": ((1, 1), ("data", "model")), "2x1": ((2, 1), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_pspecs_are_the_references(mesh, rules):
    shape, axes = MESHES[mesh]
    stand_in = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    for arch in ("gemma3-1b", "olmoe-1b-7b", "deepseek-v2-236b", "hymba-1.5b"):
        shapes, ref, model, got = _specs(arch, rules)
        with RS.use_rules(RULES[rules]):
            want = RZ.zero_pspecs(shapes, ref, stand_in)
        with S.use_rules(PORT_RULES[rules]):
            mine = Z.zero_pspecs(model, got, stand_in)
        assert _flat_specs(mine) == _ref_flat_specs(want), arch


@pytest.mark.parametrize("spec,shape,data_axes,size", [
    ((None, "model"), (8, 4), "data", 2),
    ((), (3, 8), "data", 4),
    (("model",), (6, 5, 7), ("pod", "data"), 4),  # nothing divisible past the first: replicated
    ((None, None), (2, 16), ("pod", "data"), 16),
])
def test_zero_spec_for_is_the_references(spec, shape, data_axes, size):
    assert tuple(Z.zero_spec_for(S.P(*spec), shape, data_axes, size)) == tuple(
        RZ.zero_spec_for(JP(*spec), shape, data_axes, size))


def test_shard_is_the_identity():
    x = torch.ones(4, 4)
    assert S.shard(x, "batch", None) is x
    with S.use_rules(S.SINGLE_POD_RULES):
        assert S.shard(x, "batch", "mlp") is x
        assert S.logical_to_pspec(("batch", None, "mlp")) == S.P("data", None, "model")
    assert S.logical_to_pspec(("batch",)) == S.P()


def test_use_rules_nests_and_restores():
    assert S.get_rules() is None
    with S.use_rules(S.SINGLE_POD_RULES):
        with S.use_rules(S.MULTI_POD_RULES):
            assert S.get_rules()["batch"] == ("pod", "data")
            with S.use_rules(None):
                assert S.get_rules() is None
            assert S.get_rules() is S.MULTI_POD_RULES
        assert S.get_rules() is S.SINGLE_POD_RULES
    assert S.get_rules() is None
    assert M.rules_for(True) is S.MULTI_POD_RULES and M.rules_for(False) is S.SINGLE_POD_RULES


# ------------------------------------------------------------------- mesh
def test_make_mesh_raises_like_the_reference(monkeypatch):
    devices = _devices(1, monkeypatch)
    with pytest.raises(ValueError) as want:
        RM.make_mesh((len(jax.devices()) + 1, 1), ("data", "model"))
    with pytest.raises(ValueError) as got:
        M.make_mesh((len(jax.devices()) + 1, 1), ("data", "model"), devices)
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(M, "mesh_devices", lambda: _devices(4, monkeypatch))  # the card's, as 4 CPU parts
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="must be >= the product of mesh_shape"):
            M.make_production_mesh(multi_pod=multi_pod)


def test_mesh_shape_groups_and_context(monkeypatch):
    devices = _devices(4, monkeypatch)
    monkeypatch.setattr(M, "mesh_devices", lambda: devices)
    host = M.make_host_mesh()
    assert dict(host.shape) == dict(RM.make_host_mesh().shape) and host.flat == devices[:1]
    mesh = M.make_mesh((2, 2), ("data", "model"), devices)
    assert list(mesh.shape.items()) == [("data", 2), ("model", 2)] and mesh.size == 4
    assert [mesh.coords(pos) for pos in (1, 2)] == [{"data": 0, "model": 1}, {"data": 1, "model": 0}]
    assert mesh.model_groups("data") == [[devices[0], devices[1]], [devices[2], devices[3]]]
    assert mesh.model_groups(("pod", "data")) == mesh.model_groups("data")
    cube = M.make_mesh((2, 2, 1), ("pod", "data", "model"), devices)
    assert cube.model_groups(("pod", "data")) == [[d] for d in devices]
    assert cube.model_groups("data") == [[devices[0]], [devices[1]]]  # "pod" replicated: index 0
    assert S.current_mesh() is None
    with mesh:
        with host:
            assert S.current_mesh() is host
        assert S.current_mesh() is mesh
    assert S.current_mesh() is None


# -------------------------------------------------------------- autograd
@pytest.mark.parametrize("n", DEVICE_COUNTS)
def test_broadcast_and_ring_sum_are_each_others_backward(n, monkeypatch):
    """x broadcast to n devices, each copy scaled by its own weight, the
    parts ring-summed: the value and both gradients against the same
    function on one device."""
    devices = _devices(n, monkeypatch)
    rng = np.random.default_rng(30 + n)
    x0 = rng.normal(size=(5, 3)).astype(np.float32)
    ws = rng.normal(size=(n, 5, 3)).astype(np.float32)
    x = torch.from_numpy(x0).requires_grad_()
    w = [torch.from_numpy(wi).requires_grad_() for wi in ws]
    y = C.ring_sum([xi * wi for xi, wi in zip(C.broadcast(x, devices), w)], devices)
    (y.square().sum()).backward()
    x_ref = torch.from_numpy(x0).requires_grad_()
    w_ref = [torch.from_numpy(wi).requires_grad_() for wi in ws]
    y_ref = sum(x_ref * wi for wi in w_ref)
    (y_ref.square().sum()).backward()
    assert _rel(y.detach().numpy(), y_ref.detach().numpy()) <= PSUM_RTOL
    assert _rel(x.grad.numpy(), x_ref.grad.numpy()) <= PSUM_RTOL
    for a, b in zip(w, w_ref):
        assert _rel(a.grad.numpy(), b.grad.numpy()) <= PSUM_RTOL
