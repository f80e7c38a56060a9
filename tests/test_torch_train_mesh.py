"""The training mesh in the port against the reference on the CPU:
``make_train_step(grad_pspecs=zero_pspecs(...))`` under meshes of logical
CPU devices (``REPRO_TORCH_FORCE_DEVICE_COUNT``), the state placed with
``zero.place_train_state`` and read back with ``gather_train_state``, and
MoE's expert-parallel branch.

Same inputs on both sides: the seeded weights, AdamW moments at count 3
and batches of ``tests/test_torch_training.py``.  The reference's step
runs on one JAX device (its result does not depend on the mesh), except
for OLMoE's expert-parallel branch, whose capacity is counted per data
shard: that runs under a (2, 2) JAX mesh in a subprocess with 4 forced
host devices.  Tolerances: :data:`STEP_RTOL` (1e-5) for the loss, the grad
norm and each leaf's update, as ``test_torch_training.py`` holds the
single-device step (f32 sums in another order: the ring's, the shards');
1e-5 for the expert-parallel ``moe_apply`` against the reference's
per-shard dispatches; bitwise for the copies of a parameter after a step.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_loop as ref_loop  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import device as D  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as loop  # noqa: E402

from test_torch_training import F32_EPS, STEP_AT, STEP_RTOL, _batch, _np, _paths, _rel, _states  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DENSE_ARCHS = ["gemma3-1b", "qwen3-32b", "xlstm-125m", "hymba-1.5b", "whisper-large-v3", "internvl2-26b"]
MESHES = {"2x1": (2, 1), "4x1": (4, 1)}
SUBPROCESS_TIMEOUT_S = 600
EP_ARCH = "olmoe-1b-7b"


def _tcfgs(accum=1):
    return (ref_loop.TrainConfig(optimizer=ref_opt.AdamWConfig(lr=1e-3), warmup_steps=2, total_steps=20,
                                 grad_accum=accum),
            loop.TrainConfig(optimizer=opt.AdamWConfig(lr=1e-3), warmup_steps=2, total_steps=20, grad_accum=accum))


def _mesh(shape, monkeypatch, axes=("data", "model")):
    monkeypatch.setenv(D.FORCE_DEVICE_COUNT_ENV, str(int(np.prod(shape))))
    return M.make_mesh(shape, axes, D.mesh_devices("cpu"))


def _mesh_step(state, cfg, tcfg, batch, mesh, rules=S.SINGLE_POD_RULES):
    """Place ``state`` on ``mesh``, take one step, read it back -> (the
    placed state after the step, its metrics, the gathered state, the
    specs)."""
    with S.use_rules(rules), mesh:
        specs = Z.zero_pspecs(state["params"], S.param_pspecs(state["params"]), mesh)
        placed = Z.place_train_state(state, mesh, specs)
        step = loop.make_train_step(cfg, tcfg, grad_pspecs=specs)
    new, metrics = step(placed, batch)
    with S.use_rules(rules):
        return new, metrics, Z.gather_train_state(new, mesh, specs), specs


def _assert_step(got, metrics, ref_params, ref_metrics, params0, what=""):
    """Loss, grad norm and each leaf's update against the reference's, as
    ``test_torch_training.test_train_step_against_reference`` holds them."""
    assert _rel(_np(metrics["loss"]), ref_metrics["loss"]) <= STEP_RTOL, what
    assert _rel(_np(metrics["grad_norm"]), ref_metrics["grad_norm"]) <= STEP_RTOL, what
    got_tree = T.to_jax_layout(got["params"])
    for (path, p_new), (_, p_ref), (_, p0) in zip(_paths(got_tree), _paths(ref_params), _paths(params0)):
        upd_ref = np.asarray(p_ref, np.float64) - p0
        upd = _np(p_new).astype(np.float64) - p0
        bound = STEP_RTOL * np.abs(upd_ref).max() + F32_EPS * np.abs(np.asarray(p_ref, np.float64))
        assert (np.abs(upd - upd_ref) <= bound).all(), (what, path, np.abs(upd - upd_ref).max() / np.abs(upd_ref).max())


_REF: dict = {}


def _reference(arch, kind="mask", accum=1):
    """The reference's step from ``_states(arch)`` on one device, cached:
    (batch, its new params as numpy, its metrics as floats, the start
    params)."""
    key = (arch, kind, accum)
    if key not in _REF:
        ref_cfg, cfg, ref_state, _, params = _states(arch)
        batch = _batch(cfg, b=4 * accum, s=12)
        if kind == "skewed":  # shard 0's rows all counted, the others' few
            batch["loss_mask"][:2] = 1.0
            batch["loss_mask"][2:] = (np.arange(12) % 5 == 0).astype(np.float32)
        if kind == "nomask":
            del batch["loss_mask"]
        if accum > 1:
            batch = {k: v.reshape(accum, -1, *v.shape[1:]) for k, v in batch.items()}
        ref_new, ref_m = jax.jit(ref_loop.make_train_step(ref_cfg, _tcfgs(accum)[0]))(
            ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        _REF[key] = (batch, jax.tree.map(np.asarray, ref_new["params"]),
                     {k: float(v) for k, v in ref_m.items()}, params)
    return _REF[key]


# --------------------------------------------------------------- dense
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_mesh_step_against_reference(arch, mesh, monkeypatch):
    batch, ref_params, ref_m, params = _reference(arch)
    _, cfg, _, state, _ = _states(arch)
    _, metrics, got, _ = _mesh_step(state, cfg, _tcfgs()[1], batch, _mesh(MESHES[mesh], monkeypatch))
    _assert_step(got, metrics, ref_params, ref_m, params, arch)
    assert int(_np(got["step"])) == STEP_AT + 1 and int(_np(got["opt"]["count"])) == 4


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["gemma3-1b", "hymba-1.5b", "whisper-large-v3"])
def test_mesh_step_against_the_ports_single_device_step(arch, mesh, monkeypatch):
    batch, _, _, _ = _reference(arch)
    _, cfg, _, state, _ = _states(arch)
    _, _, _, single, _ = _states(arch)
    tcfg = _tcfgs()[1]
    one, m1 = loop.make_train_step(cfg, tcfg)(single, batch)
    _, metrics, got, _ = _mesh_step(state, cfg, tcfg, batch, _mesh(MESHES[mesh], monkeypatch))
    assert _rel(_np(metrics["loss"]), _np(m1["loss"])) <= STEP_RTOL
    assert _rel(_np(metrics["grad_norm"]), _np(m1["grad_norm"])) <= STEP_RTOL
    for (name, a), b in zip(got["params"].named_parameters(), one["params"].parameters()):
        assert _rel(_np(a), _np(b)) <= STEP_RTOL, name
    for key in ("m", "v"):
        for name, a in got["opt"][key].items():
            assert _rel(_np(a), _np(one["opt"][key][name])) <= STEP_RTOL, (key, name)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_loss_mask_keeps_the_global_denominator(mesh, monkeypatch):
    """Shards whose mask sums differ: the loss is the sum over the whole
    batch over the whole mask's sum (the reference's), not the mean of the
    shards' masked means, which differs here by far more than the
    tolerance."""
    batch, ref_params, ref_m, params = _reference("gemma3-1b", "skewed")
    _, cfg, _, state, _ = _states("gemma3-1b")
    _, metrics, got, _ = _mesh_step(state, cfg, _tcfgs()[1], batch, _mesh(MESHES[mesh], monkeypatch))
    _assert_step(got, metrics, ref_params, ref_m, params, mesh)
    _, _, _, fresh, _ = _states("gemma3-1b")
    n = MESHES[mesh][0]
    with torch.no_grad():
        means = [float(loop.lm_loss(fresh["params"], cfg, torch.from_numpy(t[:, :-1]).long(),
                                    torch.from_numpy(t[:, 1:]).long(), torch.from_numpy(mk)))
                 for t, mk in zip(np.split(batch["tokens"], n), np.split(batch["loss_mask"], n))]
    assert abs(np.mean(means) - ref_m["loss"]) > 100 * STEP_RTOL * ref_m["loss"]


def test_no_mask_is_the_global_mean(monkeypatch):
    batch, ref_params, ref_m, params = _reference("gemma3-1b", "nomask")
    _, cfg, _, state, _ = _states("gemma3-1b")
    _, metrics, got, _ = _mesh_step(state, cfg, _tcfgs()[1], batch, _mesh((4, 1), monkeypatch))
    _assert_step(got, metrics, ref_params, ref_m, params)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_grad_accum_on_the_mesh(mesh, monkeypatch):
    """grad_accum=2: each microbatch splits over the data axes."""
    batch, ref_params, ref_m, params = _reference("gemma3-1b", accum=2)
    _, cfg, _, state, _ = _states("gemma3-1b")
    _, metrics, got, _ = _mesh_step(state, cfg, _tcfgs(2)[1], batch, _mesh(MESHES[mesh], monkeypatch))
    _assert_step(got, metrics, ref_params, ref_m, params, mesh)


def test_multi_pod_rules_split_over_pod_and_data(monkeypatch):
    """Under MULTI_POD_RULES the batch splits over ("pod", "data")."""
    batch, ref_params, ref_m, params = _reference("gemma3-1b")
    _, cfg, _, state, _ = _states("gemma3-1b")
    mesh = _mesh((2, 2, 1), monkeypatch, ("pod", "data", "model"))
    _, metrics, got, _ = _mesh_step(state, cfg, _tcfgs()[1], batch, mesh, S.MULTI_POD_RULES)
    _assert_step(got, metrics, ref_params, ref_m, params)


# ------------------------------------------------------------ placement
@pytest.mark.parametrize("arch,shape", [("gemma3-1b", (2, 1)), ("gemma3-1b", (4, 1)), ("olmoe-1b-7b", (2, 2))])
def test_copies_equal_and_moments_sliced(arch, shape, monkeypatch):
    """After a step every copy of a parameter (every device of a model
    index; for a leaf whose spec does not split it over "model", every
    device) holds the same bits, every device clipped with the same grad
    norm, a split leaf is its 1/TP slice, and each device holds only its
    ZeRO slice of m and v: the spec's data dimension cut in data_size
    parts, or whole layers of a layer group."""
    _, cfg, _, state, _ = _states(arch)
    batch = _batch(cfg, b=4, s=128 if cfg.is_moe else 12)
    mesh = _mesh(shape, monkeypatch)
    new, metrics, got, specs = _mesh_step(state, cfg, _tcfgs()[1], batch, mesh)
    ds, tp = shape
    assert len(metrics["grad_norms"]) == mesh.size
    assert all(torch.equal(g, metrics["grad_norm"]) for g in metrics["grad_norms"])
    named = [dict(c.named_parameters()) for c in new["params"]]
    for q in range(mesh.size):
        col = q % tp
        for name, w in named[q].items():
            assert torch.equal(w, named[col][name]), (q, name)
            if "model" not in tuple(S.spec_at(specs, name)):
                assert torch.equal(w, named[0][name]), (q, name)
    for name, w in got["params"].named_parameters():
        index = T._jax_path(name)[1]
        spec = tuple(S.spec_at(specs, name))
        stacked = index is not None
        held = [(q, new["opt"]["m"][q].get(name)) for q in range(mesh.size)]
        local = list(named[0][name].shape)
        if "model" in spec and tp > 1:
            md = spec.index("model") - stacked
            assert local[md] == w.shape[md] // tp, name
        zd = next((j for j, a in enumerate(spec) if a == "data"), None)
        if zd is None:
            assert all(m is not None and list(m.shape) == local for _, m in held), name
        elif stacked and zd == 0:  # whole layers: one owner a model index
            owners = [q for q, m in held if m is not None]
            assert len(owners) == tp and all(list(held[q][1].shape) == local for q in owners), name
        else:
            want = list(local)
            want[zd - stacked] //= ds
            assert all(list(m.shape) == want for _, m in held), (name, want)
        assert new["opt"]["m"][0].keys() == new["opt"]["v"][0].keys()


def test_current_mesh_and_expert_shard_nest_with_the_rules(monkeypatch):
    """``with mesh:`` and ``sharding.expert_shard`` nest and unwind, and a
    layer's recompute reinstalls what was current at its forward."""
    mesh = _mesh((2, 1), monkeypatch)
    assert S.current_mesh() is None and S.current_expert_shard() is None and S.remat_kwargs() == {}
    with S.use_rules(S.SINGLE_POD_RULES), mesh, S.expert_shard({"a": 1}):
        inner = M.make_mesh((1, 1), ("data", "model"), D.mesh_devices("cpu"))
        with inner, S.expert_shard(None):
            assert S.current_mesh() is inner and S.current_expert_shard() is None
        assert S.current_mesh() is mesh and S.current_expert_shard() == {"a": 1}
        _, recompute = S.remat_kwargs()["context_fn"]()
    assert S.current_mesh() is None and S.get_rules() is None
    with recompute:
        assert S.current_mesh() is mesh and S.current_expert_shard() == {"a": 1}
        assert S.get_rules() is S.SINGLE_POD_RULES
    assert S.current_mesh() is None and S.current_expert_shard() is None


def test_mesh_without_a_current_mesh_raises():
    cfg = configs.get_smoke_config("gemma3-1b")
    with pytest.raises(ValueError, match="current mesh"):
        loop.make_train_step(cfg, loop.TrainConfig(), grad_pspecs={})


def test_moe_shard_without_the_ep_branch_raises(monkeypatch):
    """A data-split mesh whose MoE layers the reference would route over
    the whole batch (too few tokens a shard for its EP branch)."""
    _, cfg, _, state, _ = _states(EP_ARCH)
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        _mesh_step(state, cfg, _tcfgs()[1], _batch(cfg, b=4, s=12), _mesh((2, 1), monkeypatch))


# -------------------------------------------------------- expert parallel
def _ep_layer(cfg, seed=0):
    """The OLMoE smoke config's first MoE layer in both packages, from
    ``_states``' seeded weights."""
    _, _, _, state, params = _states(EP_ARCH, seed)
    return state["params"].layers[0].moe, jax.tree.map(lambda a: jnp.asarray(a[0]), params["layers"]["moe"])


def _ref_ep_sum(rp, cfg, x, data_size, tp):
    """Per data shard, the reference's dispatch of each model device's
    expert slice (``local_expert_range``), summed in model order."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n_local, t_local = e // tp, (b // data_size) * s
    cap = max(int(cfg.moe_capacity_factor * t_local * k / e), min(t_local * k, 8))
    xt = jnp.asarray(x.reshape(b * s, d))
    shards = []
    for i in range(data_size):
        parts = [RL._moe_dispatch_compute(xt[i * t_local:(i + 1) * t_local], rp["router"],
                                          jax.tree.map(lambda w: w[m * n_local:(m + 1) * n_local], rp["experts"]),
                                          e, k, cap, "silu", jnp.float32, local_expert_range=(m * n_local, n_local))
                 for m in range(tp)]
        shards.append(sum(parts[1:], parts[0]))
    return np.asarray(jnp.concatenate(shards)).reshape(b, s, d)


@pytest.mark.parametrize("capacity", [4.0, 0.5])
@pytest.mark.parametrize("shape", [(2, 2), (2, 1), (1, 2), (1, 4)])
def test_moe_apply_expert_parallel_against_reference(shape, capacity, monkeypatch):
    """moe_apply's EP branch on a logical mesh (capacity 0.5 drops tokens,
    counted per data shard) against the reference's per-shard dispatches;
    each model device's dispatch sees its expert range."""
    cfg = dataclasses.replace(configs.get_smoke_config(EP_ARCH), moe_capacity_factor=capacity)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(EP_ARCH), moe_capacity_factor=capacity)
    p, rp = _ep_layer(cfg)
    x = np.random.default_rng(7).normal(size=(4, 128, cfg.d_model)).astype(np.float32)
    mesh = _mesh(shape, monkeypatch)
    ranges = []
    real = L._moe_dispatch_compute

    def spy(*args, **kw):
        ranges.append(kw.get("local_expert_range"))
        return real(*args, **kw)

    monkeypatch.setattr(L, "_moe_dispatch_compute", spy)
    with torch.no_grad(), S.use_rules(S.SINGLE_POD_RULES), mesh:
        got = L.moe_apply(p, cfg, torch.from_numpy(x)).numpy()
    ds, tp = shape
    n_local = cfg.num_experts // tp
    assert ranges == [(m * n_local, n_local) for _ in range(ds) for m in range(tp)]
    assert _rel(got, _ref_ep_sum(rp, ref_cfg, x, ds, tp)) <= STEP_RTOL


def test_moe_apply_below_the_ep_threshold_is_the_single_device_branch(monkeypatch):
    cfg = configs.get_smoke_config(EP_ARCH)
    p, _ = _ep_layer(cfg)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(4, 12, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        plain = L.moe_apply(p, cfg, x)
        with S.use_rules(S.SINGLE_POD_RULES), _mesh((2, 2), monkeypatch):
            assert torch.equal(L.moe_apply(p, cfg, x), plain)
        with _mesh((2, 2), monkeypatch):  # no rules: no EP, as the reference
            assert torch.equal(L.moe_apply(p, cfg, x), plain)


def test_ep_mesh_step_against_the_ports_single_device_step(monkeypatch):
    """OLMoE's smoke config (capacity 4: no token drops, so per-shard
    capacity routes as the whole batch does) trained on a (2, 2) mesh
    through the EP branch, against the port's single-device step."""
    _, cfg, _, state, _ = _states(EP_ARCH)
    _, _, _, single, _ = _states(EP_ARCH)
    batch = _batch(cfg, b=4, s=128)
    tcfg = _tcfgs()[1]
    one, m1 = loop.make_train_step(cfg, tcfg)(single, batch)
    _, metrics, got, _ = _mesh_step(state, cfg, tcfg, batch, _mesh((2, 2), monkeypatch))
    assert _rel(_np(metrics["loss"]), _np(m1["loss"])) <= STEP_RTOL
    assert _rel(_np(metrics["grad_norm"]), _np(m1["grad_norm"])) <= STEP_RTOL
    for (name, a), b in zip(got["params"].named_parameters(), one["params"].parameters()):
        assert _rel(_np(a), _np(b)) <= STEP_RTOL, name


_REFERENCE_EP = textwrap.dedent(
    """
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.distributed.sharding import SINGLE_POD_RULES, param_pspecs, use_rules
    from repro.distributed.zero import zero_pspecs
    from repro.launch.mesh import make_mesh
    from repro.models import layers as L
    from repro.training.optimizer import AdamWConfig
    from repro.training.train_loop import TrainConfig, make_train_step

    data = dict(np.load(sys.argv[1]))

    def tree(prefix):
        out = {}
        for key, value in data.items():
            if key.startswith(prefix + "/"):
                *path, leaf = key[len(prefix) + 1:].split("/")
                node = out
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = jnp.asarray(value)
        return out

    ranges = []
    real = L._moe_dispatch_compute

    def spy(*a, **k):
        ranges.append(k.get("local_expert_range") is not None)
        return real(*a, **k)

    L._moe_dispatch_compute = spy
    cfg = configs.get_smoke_config("olmoe-1b-7b")
    mesh = make_mesh((2, 2), ("data", "model"))
    params = tree("params")
    state = {"params": params, "opt": {"m": tree("m"), "v": tree("v"), "count": jnp.asarray(3, jnp.int32)},
             "step": jnp.asarray(int(data["step"]), jnp.int32)}
    batch = {"tokens": jnp.asarray(data["tokens"]), "loss_mask": jnp.asarray(data["loss_mask"])}
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=2, total_steps=20)
    with use_rules(SINGLE_POD_RULES), jax.set_mesh(mesh):
        moe0 = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
        y = jax.jit(lambda p, x: L.moe_apply(p, cfg, x))(moe0, jnp.asarray(data["x"]))
        zs = zero_pspecs(params, param_pspecs(params), mesh)
        new, metrics = jax.jit(make_train_step(cfg, tcfg, grad_pspecs=zs))(state, batch)
    out = {"y": np.asarray(y), "loss": np.asarray(metrics["loss"]), "grad_norm": np.asarray(metrics["grad_norm"]),
           "ep": np.asarray(len(ranges) >= 2 and all(ranges))}
    for path, leaf in jax.tree_util.tree_flatten_with_path(new["params"])[0]:
        out["params/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    np.savez(sys.argv[2], **out)
    print("EP_OK", len(jax.devices()))
    """
)


def test_ep_mesh_step_against_the_reference_on_a_4_device_mesh(tmp_path, monkeypatch):
    """The reference's ``moe_apply`` and one ``make_train_step(grad_pspecs=
    ...)`` step of the OLMoE smoke config under a (2, 2) JAX mesh (4 forced
    host devices, in a subprocess with a time limit of its own), against
    the port on 4 logical CPU devices."""
    ref_cfg, cfg, ref_state, state, params = _states(EP_ARCH)
    batch = _batch(cfg, b=4, s=128)
    x = np.random.default_rng(9).normal(size=(4, 128, cfg.d_model)).astype(np.float32)
    arrays = {"x": x, "step": np.asarray(STEP_AT), **batch}
    for name, tree in (("params", params), ("m", ref_state["opt"]["m"]), ("v", ref_state["opt"]["v"])):
        for path, leaf in _paths(tree):
            arrays[name + "/" + "/".join(path)] = np.asarray(leaf)
    np.savez(tmp_path / "in.npz", **arrays)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _REFERENCE_EP, str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=SUBPROCESS_TIMEOUT_S)
    assert "EP_OK 4" in out.stdout, out.stdout + out.stderr
    ref = dict(np.load(tmp_path / "out.npz"))
    assert bool(ref["ep"])  # the reference took its expert-parallel branch
    mesh = _mesh((2, 2), monkeypatch)
    with torch.no_grad(), S.use_rules(S.SINGLE_POD_RULES), mesh:
        y = L.moe_apply(state["params"].layers[0].moe, cfg, torch.from_numpy(x)).numpy()
    assert _rel(y, ref["y"]) <= STEP_RTOL
    _, metrics, got, _ = _mesh_step(state, cfg, _tcfgs()[1], batch, mesh)
    ref_params = {}
    for key, value in ref.items():
        if key.startswith("params/"):
            *path, leaf = key[len("params/"):].split("/")
            node = ref_params
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value
    _assert_step(got, metrics, ref_params, {"loss": float(ref["loss"]), "grad_norm": float(ref["grad_norm"])},
                 params)
