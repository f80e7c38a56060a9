"""The port's preprocessing ops: each torch ``apply_device`` against the
reference's jnp one on the same seeded inputs (the uint8 re-quantize
included), and the copied numpy host halves against the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from conftest import smooth_image  # noqa: E402
from repro.core import dag as ref_dag  # noqa: E402
from repro.core.planner import standard_chain as ref_standard_chain  # noqa: E402
from repro.preprocessing import ops as R  # noqa: E402
from repro_torch.core import dag as t_dag  # noqa: E402
from repro_torch.core.planner import standard_chain as t_standard_chain  # noqa: E402
from repro_torch.preprocessing import ops as T  # noqa: E402

RNG = np.random.default_rng(12)
U8 = RNG.integers(0, 256, size=(37, 53, 3)).astype(np.uint8)
F32 = RNG.uniform(0, 1, size=(37, 53, 3)).astype(np.float32)
CHW = RNG.uniform(0, 1, size=(3, 21, 17)).astype(np.float32)


def _pair(name, *args):
    return getattr(R, name)(*args), getattr(T, name)(*args)


def _device_both(ref_op, t_op, x):
    ref = np.asarray(ref_op.apply_device(jnp.asarray(x)))
    out = t_op.apply_device(torch.from_numpy(x)).numpy()
    return out, ref


CASES = [
    ("ResizeShortSide", (24,), U8),
    ("ResizeShortSide", (70,), U8),  # upsample
    ("ResizeShortSide", (24,), F32),
    ("Resize", (19, 41), U8),
    ("Resize", (19, 41), F32),
    ("CenterCrop", (17,), U8),
    ("ToFloat", (), U8),
    ("Normalize", (), F32),
    ("Normalize", (), CHW),
    ("ChannelsFirst", (), F32),
]


@pytest.mark.parametrize("name,args,x", CASES, ids=[f"{c[0]}{c[1]}-{c[2].dtype}{c[2].shape}" for c in CASES])
def test_apply_device_matches_jnp(name, args, x):
    ref_op, t_op = _pair(name, *args)
    out, ref = _device_both(ref_op, t_op, x)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if out.dtype == np.uint8:
        # resize re-quantizes to uint8 with half-to-even rounding on both
        # sides (torch.round / jnp.round); same arithmetic, so no tie moves
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_fused_elementwise_matches_jnp():
    ref_op = R.FusedElementwise((R.ToFloat(), R.Normalize(), R.ChannelsFirst()))
    t_op = T.FusedElementwise((T.ToFloat(), T.Normalize(), T.ChannelsFirst()))
    out, ref = _device_both(ref_op, t_op, U8)
    assert out.shape == (3, 37, 53)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_center_crop_fraction_matches_jnp():
    out, ref = _device_both(ref_dag.CenterCropFraction(0.7), t_dag.CenterCropFraction(0.7), U8)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("optimized", [False, True])
def test_standard_chain_device_matches_jnp(optimized):
    meta_r = R.TensorMeta(U8.shape, "uint8", "HWC")
    meta_t = T.TensorMeta(U8.shape, "uint8", "HWC")
    ref_ops, t_ops = ref_standard_chain(24), t_standard_chain(24)
    if optimized:
        ref_ops = ref_dag.optimize(ref_ops, meta_r).ops
        t_ops = t_dag.optimize(t_ops, meta_t).ops
    assert [op.spec() for op in t_ops] == [op.spec() for op in ref_ops]
    ref = np.asarray(R.apply_chain_device(ref_ops, jnp.asarray(U8)))
    out = T.apply_chain_device(t_ops, torch.from_numpy(U8)).numpy()
    assert out.shape == ref.shape == (3, 24, 24)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,args,x", CASES[:6], ids=[f"{c[0]}{c[1]}" for c in CASES[:6]])
def test_host_halves_identical(name, args, x):
    ref_op, t_op = _pair(name, *args)
    np.testing.assert_array_equal(t_op.apply_host(x), ref_op.apply_host(x))
    assert t_op.flops(T.TensorMeta(x.shape, str(x.dtype), "HWC")) == ref_op.flops(
        R.TensorMeta(x.shape, str(x.dtype), "HWC")
    )


# sizes where the reference's host and device ResizeShortSide put a .5 tie
# of the uint8 re-quantize on different sides (tests/test_preproc_ops.py
# test_chain_host_device_parity draws such sizes at random); the port's
# device chain must equal the reference's device chain there, bitwise
TIE_SIZES = [(136, 156), (190, 196), (120, 118), (174, 40), (87, 112)]


@pytest.mark.parametrize("h,w", TIE_SIZES, ids=[f"{h}x{w}" for h, w in TIE_SIZES])
def test_standard_resnet_chain_device_matches_jnp_at_tie_sizes(h, w):
    img = smooth_image(np.random.default_rng(7), h, w)
    ref = np.asarray(R.apply_chain_device(R.STANDARD_RESNET_CHAIN, jnp.asarray(img)))
    out = T.apply_chain_device(T.STANDARD_RESNET_CHAIN, torch.from_numpy(img)).numpy()
    assert out.shape == ref.shape == (3, 224, 224) and out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
