"""The port's checkpoint module against the reference's, both ways, on
the CPU: a checkpoint the reference's ``save`` wrote restores in the port
(through ``from_jax_params``) to a model whose logits equal the
reference's weights' loaded directly; one the port's ``save`` wrote (from
``to_jax_layout``) restores in the reference to equal arrays; the leaf
order and the treedef text are ``jax.tree.flatten``'s; and the durability
protocol's sweep of a ``.tmp`` left behind and its retention.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import checkpoint as ref_ckpt  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ["whisper-large-v3", "internvl2-26b", "deepseek-v2-236b"]


def _ref_params(arch, seed=0):
    return RT.init_lm(ref_configs.get_smoke_config(arch), jax.random.PRNGKey(seed))


def _target(cfg):
    return {"params": T.to_jax_layout(T.TransformerLM(cfg, "meta"))}


@pytest.mark.parametrize("arch", ARCHS)
def test_to_jax_layout_is_the_inverse_of_from_jax_params(arch):
    params = jax.tree.map(np.asarray, _ref_params(arch))
    cfg = configs.get_smoke_config(arch)
    layout = T.to_jax_layout(T.from_jax_params(params, cfg))
    assert jax.tree.structure(layout) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(layout), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got.numpy(), want)
    # the meta model gives the same layout's shapes alone
    shapes = jax.tree.map(lambda x: tuple(x.shape), _target(cfg)["params"])
    assert shapes == jax.tree.map(lambda x: x.shape, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_order_and_treedef_are_jax_tree_flatten(arch):
    tree = {"params": jax.tree.map(np.asarray, _ref_params(arch)), "step": np.int32(3)}
    leaves, treedef = ckpt.flatten(tree)
    ref_leaves, ref_treedef = jax.tree.flatten(tree)
    assert treedef == str(ref_treedef)
    assert len(leaves) == len(ref_leaves)
    assert all(a is b for a, b in zip(leaves, ref_leaves))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    arch = "whisper-large-v3"
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    params = _ref_params(arch, seed=4)
    ref_ckpt.save(str(tmp_path), 7, {"params": params})
    restored, step = ckpt.restore(str(tmp_path), None, _target(cfg))
    assert step == 7
    model = T.from_jax_params(restored["params"], cfg)
    direct = T.from_jax_params(jax.tree.map(np.asarray, params), cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 6))
    frames = torch.from_numpy(rng.normal(size=(2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    got = T.forward(model, cfg, toks, encoder_frames=frames)
    assert torch.equal(got, T.forward(direct, cfg, toks, encoder_frames=frames))
    want = np.asarray(RT.forward(params, ref_cfg, jnp.asarray(toks), encoder_frames=jnp.asarray(frames.numpy())))
    scale = np.abs(want[..., :cfg.vocab_size]).max()
    assert np.abs(got.numpy() - want)[..., :cfg.vocab_size].max() <= 1e-4 * scale


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    arch = "internvl2-26b"
    cfg = configs.get_smoke_config(arch)
    model = T.init_lm(cfg, torch.Generator().manual_seed(2), device="cpu")
    path = ckpt.save(str(tmp_path), 3, {"params": T.to_jax_layout(model)})
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = {"params": _ref_params(arch)}
    assert manifest["treedef"] == str(jax.tree.structure(like))
    restored, step = ref_ckpt.restore(str(tmp_path), None, like)
    assert step == 3
    back = T.from_jax_params(jax.tree.map(np.asarray, restored["params"]), cfg)
    for (name, a), b in zip(model.named_parameters(), back.parameters()):
        assert torch.equal(a, b), name


def test_bf16_leaves_are_written_as_float32(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3), "b": np.ones(2, np.int64)}
    path = ckpt.save(str(tmp_path), 1, tree)
    restored, _ = ckpt.restore(str(tmp_path), 1, tree)
    assert restored["w"].dtype == np.float32 and restored["b"].dtype == np.int64
    np.testing.assert_array_equal(restored["w"], np.arange(6, dtype=np.float32).reshape(2, 3))
    with pytest.raises(ValueError, match="leaf 1"):
        ckpt.restore(str(tmp_path), 1, {"w": np.zeros((3, 2)), "b": np.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 1, {"w": np.zeros((2, 3))})
    assert os.path.basename(path) == "step_000000001"


def test_stale_tmp_is_swept_and_old_steps_retired(tmp_path):
    root = str(tmp_path)
    assert ckpt.all_steps(root) == [] and ckpt.latest_step(root) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(root, None, {"x": np.zeros(1)})
    stale = tmp_path / "step_000000009.tmp"
    stale.mkdir()
    (stale / "leaf_00000.npy").write_bytes(b"partial")
    for step in range(1, 6):
        ckpt.save(root, step, {"x": np.full(2, step, np.float32)}, keep=3)
        assert not stale.exists()
    assert ckpt.all_steps(root) == ref_ckpt.all_steps(root) == [3, 4, 5]
    assert ckpt.latest_step(root) == 5
    restored, step = ckpt.restore(root, None, {"x": np.zeros(2)})
    assert step == 5 and restored["x"].tolist() == [5.0, 5.0]
    # a directory with no manifest (a write cut before its rename) is no step
    (tmp_path / "step_000000008").mkdir()
    assert ckpt.latest_step(root) == 5
