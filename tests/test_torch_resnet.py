"""The port's ResNet module against ``repro.models.resnet.resnet_forward`` on
the same weights (converted with ``from_jax_params``) and the same seeded
inputs, at even and odd sizes — the XLA "SAME" padding hazard."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import resnet as R  # noqa: E402
from repro_torch.models import resnet as T  # noqa: E402

NARROW_BOTTLENECK = ("narrow_bottleneck", "bottleneck", (1, 1), 10, 8)


def _numpy_params(cfg, seed):
    """init_resnet's pytree as numpy, with non-identity batch-norm stats so
    the conversion of every leaf is exercised."""
    params = jax.tree.map(np.asarray, R.init_resnet(cfg, jax.random.PRNGKey(seed), num_classes=10))
    rng = np.random.default_rng(seed)

    def perturb(p):
        if isinstance(p, dict) and set(p) == {"scale", "bias", "mean", "var"}:
            c = p["scale"].shape[0]
            return {
                "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0, 0.1, c).astype(np.float32),
                "mean": rng.normal(0, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
            }
        if isinstance(p, dict):
            return {k: perturb(v) for k, v in p.items()}
        if isinstance(p, list):
            return [perturb(v) for v in p]
        return p

    return perturb(params)


@pytest.mark.parametrize("which", ["tiny", "bottleneck"])
@pytest.mark.parametrize("size", [32, 33])
def test_forward_matches_reference(which, size):
    if which == "tiny":
        ref_cfg, t_cfg = R.TINY_RESNET, T.TINY_RESNET
    else:
        ref_cfg, t_cfg = R.ResNetConfig(*NARROW_BOTTLENECK), T.ResNetConfig(*NARROW_BOTTLENECK)
    params = _numpy_params(ref_cfg, seed=size)
    x = np.random.default_rng(size).normal(size=(2, 3, size, size)).astype(np.float32)
    ref = np.asarray(R.resnet_forward(jax.tree.map(jnp.asarray, params), ref_cfg, jnp.asarray(x)))
    model = T.from_jax_params(params, t_cfg)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 10)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "size,k,s,pads", [(224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
                      (33, 3, 2, (1, 1)), (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0))]
)
def test_same_pads(size, k, s, pads):
    assert T.same_pads(size, k, s) == pads


def test_resnet50_full_width_builds_from_a_generator():
    a = T.ResNet(T.RESNET50, generator=torch.Generator().manual_seed(3))
    b = T.ResNet(T.RESNET50, generator=torch.Generator().manual_seed(3))
    # torchvision's resnet50 without the fc bias: 25,557,032 - 1,000
    assert T.count_params(a) == 25_556_032
    assert not a.training
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 3, 64, 64)).astype(np.float32))
    with torch.inference_mode():
        ya, yb = a(x), b(x)
    assert ya.shape == (1, 1000) and torch.isfinite(ya).all()
    assert torch.equal(ya, yb)
