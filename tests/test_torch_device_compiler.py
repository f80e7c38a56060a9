"""The port's device compiler against the reference's on the CPU: the same
lowering, the pixel program and the split-decode coefficient program (factors
1/2/4, padded/packed, 4:4:4 and 4:2:0) on the same staged batch and the same
linear model, plus the one-dispatch contract and the program cache.

Tolerances follow ``tests/test_device_compiler.py``: <= 1e-4 on float chains;
one uint8 quantization step on chains that re-quantize (the two sides' fp32
IDCT/resample sums run in different orders, so a value on a rounding tie
may land one step apart), on a vanishing fraction of values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import smooth_image  # noqa: E402
from repro.core import dag as ref_dag  # noqa: E402
from repro.core import device_compiler as RDC  # noqa: E402
from repro.core.planner import standard_chain as ref_chain  # noqa: E402
from repro.preprocessing import jpeg as ref_jpeg  # noqa: E402
from repro.preprocessing import ops as RP  # noqa: E402
from repro_torch.core import dag as t_dag  # noqa: E402
from repro_torch.core import device_compiler as TDC  # noqa: E402
from repro_torch.core.planner import standard_chain as t_chain  # noqa: E402
from repro_torch.preprocessing import jpeg as t_jpeg  # noqa: E402
from repro_torch.preprocessing import ops as TP  # noqa: E402

RNG = np.random.default_rng(7)
QSTEP = (1.0 / 255.0) / 0.224  # one uint8 step through the steepest Normalize std
IMPLS = ["plain", "kernel"]  # on the CPU "kernel" runs the wrapper's plain path


def _ops(input_size, meta_shape, optimize=True):
    r_meta = RP.TensorMeta(meta_shape, "uint8", "HWC")
    t_meta = TP.TensorMeta(meta_shape, "uint8", "HWC")
    r_ops, t_ops = ref_chain(input_size), t_chain(input_size)
    if optimize:
        r_ops, t_ops = ref_dag.optimize(r_ops, r_meta).ops, t_dag.optimize(t_ops, t_meta).ops
    return r_ops, t_ops, r_meta, t_meta


def _assert_within_one_step(out, ref, frac=1e-2):
    diff = np.abs(out - ref)
    assert diff.max() <= QSTEP + 1e-4, f"max diff {diff.max()}"
    assert (diff > 1e-4).mean() < frac, f"{(diff > 1e-4).mean():.2e} of values off"


def test_lowering_matches_reference():
    r_ops, t_ops, r_meta, t_meta = _ops(224, (161, 193, 3))
    r_low, t_low = RDC.lower_device_ops(r_ops, r_meta), TDC.lower_device_ops(t_ops, t_meta)
    for field in ("pre_crop", "resize", "post_crop", "round_uint8", "scale", "bias", "stages"):
        assert getattr(t_low, field) == getattr(r_low, field), field
    assert t_low.out_meta.shape == r_low.out_meta.shape


# ------------------------------------------------------------ pixel program
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("h,w,c,oh,ow", [(97, 131, 3, 64, 80), (64, 64, 1, 48, 33)])
def test_float_chain_program_matches_reference(impl, h, w, c, oh, ow):
    mean, std = (0.45, 0.41, 0.38)[:c], (0.229, 0.224, 0.225)[:c]
    r_ops = [RP.Resize(oh, ow), RP.Normalize(mean, std), RP.ChannelsFirst()]
    t_ops = [TP.Resize(oh, ow), TP.Normalize(mean, std), TP.ChannelsFirst()]
    batch = RNG.uniform(0, 1, size=(3, h, w, c)).astype(np.float32)
    ref = np.asarray(RDC.compile_device_program(
        r_ops, RP.TensorMeta((h, w, c), "float32", "HWC"), lambda x: x, 3, impl="jnp")(batch))
    prog = TDC.compile_device_program(
        t_ops, TP.TensorMeta((h, w, c), "float32", "HWC"), lambda x: x, 3, impl=impl, device="cpu")
    assert prog.fused and prog.impl == impl
    out = prog(batch).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_uint8_standard_chain_program_matches_reference(impl, backend):
    r_ops, t_ops, r_meta, t_meta = _ops(64, (101, 87, 3))
    batch = RNG.integers(0, 256, size=(2, 101, 87, 3)).astype(np.uint8)
    ref = np.asarray(RDC.compile_device_program(r_ops, r_meta, lambda x: x, 2, impl="jnp")(batch))
    prog = TDC.compile_device_program(
        t_ops, t_meta, lambda x: x, 2, backend=backend, impl=impl, device="cpu")
    assert prog.fused == (backend == "fused")
    out = prog(batch).numpy()
    assert out.shape == ref.shape == (2, 3, 64, 64)
    _assert_within_one_step(out, ref, frac=1e-3)


def test_program_with_model_counts_dispatches_and_caches():
    _, t_ops, _, t_meta = _ops(32, (48, 40, 3))
    w = torch.from_numpy(RNG.normal(size=(3 * 32 * 32, 5)).astype(np.float32))
    cache = TDC.ProgramCache(4)

    def model(x):
        return x.reshape(x.shape[0], -1) @ w

    prog = TDC.compile_device_program(t_ops, t_meta, model, 2, cache=cache, device="cpu")
    assert TDC.compile_device_program(t_ops, t_meta, model, 2, cache=cache, device="cpu") is prog
    assert TDC.compile_device_program(t_ops, t_meta, model, 4, cache=cache, device="cpu") is not prog
    batch = RNG.integers(0, 256, size=(2, 48, 40, 3)).astype(np.uint8)
    out = prog(batch)
    assert out.shape == (2, 5) and prog.dispatch_count == 1 and prog.dispatches_per_batch == 1
    assert prog.first_dispatch_seconds is not None and prog.build_seconds >= 0
    prog(batch)
    assert prog.dispatch_count == 2
    assert cache.stats().entries == 2 and cache.stats().hits == 1


class _TPosterize(TP.PreprocOp):
    """Opaque op (no lowering_spec): quantize to 8 levels."""

    name = "posterize"

    def out_meta(self, m):
        return m

    def apply_host(self, x):
        return (np.asarray(x) // 32) * 32

    def apply_device(self, x):
        return (x // 32) * 32

    def flops(self, m):
        return float(m.numel)

    def spec(self):
        return ("Posterize", 32)


def test_non_fusible_chain_falls_back_to_per_op_chain():
    ops = [TP.ResizeShortSide(48), _TPosterize(), TP.ToFloat(), TP.ChannelsFirst()]
    meta = TP.TensorMeta((64, 80, 3), "uint8", "HWC")
    prog = TDC.compile_device_program(ops, meta, lambda x: x, 2, device="cpu")
    assert not prog.fused and prog.impl == "chain"
    batch = np.stack([smooth_image(RNG, 64, 80) for _ in range(2)])
    out = prog(batch).numpy()
    ref = np.stack([TP.apply_chain_host(ops, im) for im in batch])
    diff = np.abs(out - ref)
    assert diff.max() <= 1.0 / 255.0 + 1e-6 and (diff > 1e-4).mean() < 1e-2


# ------------------------------------------------------ coefficient program
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize(
    "factor,subsample,layout",
    [(1, False, "padded"), (1, True, "padded"), (1, True, "packed"),
     (2, True, "packed"), (2, False, "padded"), (4, True, "packed")],
)
def test_coeff_program_matches_reference(impl, factor, subsample, layout):
    h, w = 48 * factor + 1, 64 * factor + 3  # odd sizes: partial blocks
    img = smooth_image(np.random.default_rng(factor), h, w)
    data = ref_jpeg.encode(img, quality=90, subsample=subsample)
    r_ops, t_ops, _, _ = _ops(32, (h, w, 3))
    wts = RNG.normal(size=(3 * 32 * 32, 6)).astype(np.float32) * 0.02
    wt = torch.from_numpy(wts)
    r_prog = RDC.compile_coeff_program(
        ref_jpeg.peek_header(data), r_ops, lambda x: x.reshape(x.shape[0], -1) @ wts, 2,
        factor=factor, layout=layout, impl="jnp")
    t_prog = TDC.compile_coeff_program(
        t_jpeg.peek_header(data), t_ops, lambda x: torch.stack([r.reshape(-1) @ wt for r in x]), 2,
        factor=factor, layout=layout, impl=impl, device="cpu")
    assert t_prog.coeff_factor == factor and t_prog.coeff_layout == layout
    assert tuple(t_prog.in_meta.shape) == tuple(r_prog.in_meta.shape)
    assert ("chroma_upsample[2x2]" in t_prog.stages) == subsample
    hdr, planes, _, _ = t_jpeg.decode_to_coefficients(data)
    staged = t_jpeg.stage_coefficients(planes, hdr, layout)
    batch = np.stack([staged, staged])
    out = t_prog(batch).numpy()
    ref = np.asarray(r_prog(batch))
    # batch rows independent; the linear model runs row by row, because a CPU
    # matmul's bits can depend on a row's position in the batch (MKL)
    np.testing.assert_array_equal(out[0], out[1])
    # a pixel that flips one uint8 step moves a logit by at most QSTEP*max|w|
    assert np.abs(out - ref).max() <= 4 * QSTEP * np.abs(wts).max() + 1e-4
    np.testing.assert_array_equal(out.argmax(1), ref.argmax(1))


@pytest.mark.parametrize("impl", IMPLS)
def test_coeff_program_preprocessed_pixels_match_reference(impl):
    # identity model: compare the DNN input itself, pixel for pixel
    img = smooth_image(np.random.default_rng(5), 97, 131)
    data = ref_jpeg.encode(img, quality=90, subsample=True)
    r_ops, t_ops, _, _ = _ops(64, (97, 131, 3))
    r_prog = RDC.compile_coeff_program(
        ref_jpeg.peek_header(data), r_ops, lambda x: x, 1, layout="packed", impl="jnp")
    t_prog = TDC.compile_coeff_program(
        t_jpeg.peek_header(data), t_ops, lambda x: x, 1, layout="packed", impl=impl, device="cpu")
    hdr, planes, _, _ = t_jpeg.decode_to_coefficients(data)
    staged = t_jpeg.stage_coefficients(planes, hdr, "packed")[None]
    out, ref = t_prog(staged).numpy(), np.asarray(r_prog(staged))
    assert out.shape == ref.shape == (1, 3, 64, 64)
    _assert_within_one_step(out, ref)
    # and the host golden: full pixel decode + the host chain
    golden = TP.apply_chain_host(list(t_ops), t_jpeg.decode(data))
    _assert_within_one_step(out[0], golden)


def test_coeff_program_rejects_grayscale():
    data = t_jpeg.encode(smooth_image(np.random.default_rng(4), 64, 64)[..., 0], quality=85)
    with pytest.raises(ValueError, match="3-channel"):
        TDC.compile_coeff_program(t_jpeg.peek_header(data), t_chain(48), lambda x: x, 2, device="cpu")


def test_compile_on_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t_ops, _, t_meta = _ops(32, (48, 40, 3))
    with pytest.raises(RuntimeError, match="cuda"):
        TDC.compile_device_program(t_ops, t_meta, lambda x: x, 2)  # default device: the card
    with pytest.raises(RuntimeError, match="cuda"):
        TDC.measure_dispatch_overhead(device="cuda")
    assert TDC.resolve_impl("auto", torch.device("cpu")) == "plain"
    assert TDC.resolve_impl("auto", torch.device("cuda")) == "kernel"
    with pytest.raises(ValueError):
        TDC.resolve_impl("pallas", torch.device("cpu"))
