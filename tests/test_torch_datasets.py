"""The port's copies of the paper's data side against the reference's, in
one process on the CPU: the eight synthetic datasets (labels, images,
frames, counts and every stored variant's bytes), low-res augmentation, the
paper's model set; then the slice as a whole — ``SmolRuntime`` in both
packages over ``image_dataset("bike-bird", 8)`` into the same TINY_RESNET,
once on the full-resolution JPEG through split decode and once on the
161-px PNG thumbnail through the pixel program.

``make_video`` seeds from ``hash(name)``, which Python salts per process
(in both packages alike), so every comparison here runs in one process."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import smol_resnets as ref_smol  # noqa: E402
from repro.core.planner import ModelSpec as RModelSpec  # noqa: E402
from repro.data import datasets as ref_datasets  # noqa: E402
from repro.models import resnet as ref_resnet  # noqa: E402
from repro.preprocessing import formats as ref_formats  # noqa: E402
from repro.runtime import DeviceCompilerConfig as RDevCfg  # noqa: E402
from repro.runtime import RuntimeConfig as RConfig  # noqa: E402
from repro.runtime import SmolRuntime as RRuntime  # noqa: E402
from repro.training import lowres_aug as ref_aug  # noqa: E402
from repro_torch.configs import smol_resnets as t_smol  # noqa: E402
from repro_torch.core.planner import ModelSpec as TModelSpec  # noqa: E402
from repro_torch.data import datasets as t_datasets  # noqa: E402
from repro_torch.models import resnet as t_resnet  # noqa: E402
from repro_torch.preprocessing import formats as t_formats  # noqa: E402
from repro_torch.runtime import DeviceCompilerConfig as TDevCfg  # noqa: E402
from repro_torch.runtime import RuntimeConfig as TConfig  # noqa: E402
from repro_torch.runtime import SmolRuntime as TRuntime  # noqa: E402
from repro_torch.training import lowres_aug as t_aug  # noqa: E402

IMAGE_NAMES = list(ref_datasets.IMAGE_DATASETS)
VIDEO_NAMES = list(ref_datasets.VIDEO_DATASETS)


def test_dataset_tables_match_reference():
    assert list(t_datasets.IMAGE_DATASETS) == IMAGE_NAMES
    assert t_datasets.VIDEO_DATASETS == VIDEO_NAMES
    for name, spec in ref_datasets.IMAGE_DATASETS.items():
        assert dataclasses.astuple(t_datasets.IMAGE_DATASETS[name]) == dataclasses.astuple(spec)
    assert [f.key for f in t_formats.PAPER_IMAGE_FORMATS] == [
        f.key for f in ref_formats.PAPER_IMAGE_FORMATS]


def _assert_same_variants(t_item, r_item):
    assert [f.key for f in t_item.formats()] == [f.key for f in r_item.formats()]
    for t_fmt, r_fmt in zip(t_item.formats(), r_item.formats()):
        assert t_item.variants[t_fmt] == r_item.variants[r_fmt], t_fmt.key
    assert t_item.native_shape == r_item.native_shape


@pytest.mark.parametrize("name", IMAGE_NAMES)
def test_image_dataset_matches_reference(name):
    t_stored, t_labels = t_datasets.image_dataset(name, 3, seed=4)
    r_stored, r_labels = ref_datasets.image_dataset(name, 3, seed=4)
    assert t_labels.dtype == r_labels.dtype
    np.testing.assert_array_equal(t_labels, r_labels)
    for t_item, r_item in zip(t_stored, r_stored):
        _assert_same_variants(t_item, r_item)


@pytest.mark.parametrize("name", IMAGE_NAMES)
def test_raw_image_batch_matches_reference(name):
    t_imgs, t_labels = t_datasets.raw_image_batch(name, 3, seed=2)
    r_imgs, r_labels = ref_datasets.raw_image_batch(name, 3, seed=2)
    np.testing.assert_array_equal(t_labels, r_labels)
    assert t_imgs.dtype == r_imgs.dtype == np.uint8
    spec = ref_datasets.IMAGE_DATASETS[name]
    assert t_imgs.shape == (3, spec.native_size, spec.native_size, 3)
    np.testing.assert_array_equal(t_imgs, r_imgs)


@pytest.mark.parametrize("name", VIDEO_NAMES)
def test_make_video_matches_reference(name):
    t_frames, t_counts = t_datasets.make_video(name, 16, seed=3, size=32, mean_objects=3.0)
    r_frames, r_counts = ref_datasets.make_video(name, 16, seed=3, size=32, mean_objects=3.0)
    assert t_frames.shape == (16, 32, 32, 3) and t_counts.dtype == r_counts.dtype
    np.testing.assert_array_equal(t_frames, r_frames)
    np.testing.assert_array_equal(t_counts, r_counts)


@pytest.mark.parametrize("name", VIDEO_NAMES)
def test_video_dataset_matches_reference(name):
    t_sv, t_counts = t_datasets.video_dataset(name, 10, seed=6, size=48)
    r_sv, r_counts = ref_datasets.video_dataset(name, 10, seed=6, size=48)
    np.testing.assert_array_equal(t_counts, r_counts)
    _assert_same_variants(t_sv, r_sv)
    assert [f.key for f in t_sv.formats()] == ["svid_full_q75", "svid_24p_q75"]
    for t_fmt, r_fmt in zip(t_sv.formats(), r_sv.formats()):
        np.testing.assert_array_equal(t_sv.decode(t_fmt), r_sv.decode(r_fmt))


# ------------------------------------------------------- low-res augmentation
@pytest.fixture(scope="module")
def raw_batch():
    return ref_datasets.raw_image_batch("animals-10", 4, seed=9)[0][:, :64, :48]


@pytest.mark.parametrize("jpeg_quality", [None, 75])
def test_lowres_augment_matches_reference(raw_batch, jpeg_quality):
    out = t_aug.lowres_augment(raw_batch[0], 20, 32, jpeg_quality)
    ref = ref_aug.lowres_augment(raw_batch[0], 20, 32, jpeg_quality)
    assert out.shape == (32, 32, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("prob,seeded", [(1.0, False), (0.5, True)], ids=["all", "prob0.5"])
@pytest.mark.parametrize("jpeg_quality", [None, 50])
def test_augment_batch_matches_reference(raw_batch, jpeg_quality, prob, seeded):
    t_rng = np.random.default_rng(17) if seeded else None
    r_rng = np.random.default_rng(17) if seeded else None
    out = t_aug.augment_batch(raw_batch, 24, 40, jpeg_quality, prob=prob, rng=t_rng)
    ref = ref_aug.augment_batch(raw_batch, 24, 40, jpeg_quality, prob=prob, rng=r_rng)
    assert out.shape == (len(raw_batch), 40, 40, 3)
    np.testing.assert_array_equal(out, ref)


# -------------------------------------------------------- the paper's model set
def test_smol_resnets_match_reference():
    assert list(t_smol.CONFIGS) == list(ref_smol.CONFIGS)
    for name, ref_cfg in ref_smol.CONFIGS.items():
        t_cfg = t_smol.CONFIGS[name]
        for field in dataclasses.fields(ref_cfg):
            assert getattr(t_cfg, field.name) == getattr(ref_cfg, field.name), (name, field.name)
    assert t_smol.T4_THROUGHPUT == ref_smol.T4_THROUGHPUT


# ------------------------------------------------------------ the slice
INPUT = 224
# synthetic accuracy table over the paper's formats (full JPEG q95, PNG 161,
# JPEG 161 q95, JPEG 161 q75): 0.85 admits only the full JPEG, 0.75 also
# the PNG thumbnail, which decodes cheaper
ACCURACY = (0.90, 0.80, 0.50, 0.40)
PLANS = [(0.85, "tiny_resnet@jpeg_full_q95"), (0.75, "tiny_resnet@png_161")]


@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree.map(np.array, ref_resnet.init_resnet(
        ref_resnet.TINY_RESNET, jax.random.PRNGKey(5), num_classes=2))


def _runtime(pkg, min_accuracy, params):
    """One package's SmolRuntime over bike-bird with every measured cost
    pinned, so both packages plan alike."""
    if pkg == "ref":
        datasets, formats, Spec, Config, DevCfg, Runtime = (
            ref_datasets, ref_formats, RModelSpec, RConfig, RDevCfg, RRuntime)
        model = lambda x: ref_resnet.resnet_forward(params, ref_resnet.TINY_RESNET, x)
        kw = {}
    else:
        datasets, formats, Spec, Config, DevCfg, Runtime = (
            t_datasets, t_formats, TModelSpec, TConfig, TDevCfg, TRuntime)
        model = t_resnet.from_jax_params(params, t_resnet.TINY_RESNET)
        kw = {"device": "cpu"}
    stored, labels = datasets.image_dataset("bike-bird", 8, seed=1)
    fmts = formats.PAPER_IMAGE_FORMATS
    spec = Spec("tiny_resnet", INPUT, exec_throughput=10_000.0,
                accuracy_by_format={f.key: a for f, a in zip(fmts, ACCURACY)})
    rt = Runtime(
        [spec], fmts, {"tiny_resnet": model}, calibration=stored[:2],
        config=Config(batch_size=4, num_workers=2, min_accuracy=min_accuracy,
                      device=DevCfg(split_decode="full", dispatch_overhead_s=0.0)),
        decode_time=lambda fmt: 2e-3 if fmt.short_side is None else 1e-4,
        **kw,
    )
    rt._entropy_time_cache.update({f.key: 1e-3 if f.short_side is None else 5e-5 for f in fmts})
    return rt, stored, labels


@pytest.mark.parametrize("min_accuracy,plan_key", PLANS, ids=["split-decode", "pixel-program"])
def test_runtime_over_bike_bird_matches_reference(tiny_params, min_accuracy, plan_key):
    r_rt, r_stored, r_labels = _runtime("ref", min_accuracy, tiny_params)
    t_rt, t_stored, t_labels = _runtime("port", min_accuracy, tiny_params)
    np.testing.assert_array_equal(t_labels, r_labels)
    r_outs, r_report = r_rt.run(r_stored)
    t_outs, t_report = t_rt.run(t_stored)
    assert t_report.plan_key == r_report.plan_key == plan_key
    compiled = t_rt.compile()
    prog = compiled.device_program
    if plan_key.endswith("jpeg_full_q95"):
        assert compiled.coeff is not None and compiled.coeff.factor == 1
        assert "dequant_idct" in prog.stages
    else:  # the pixel program, every op of the chain on the device
        assert compiled.coeff is None and compiled.placement.split == 0
        assert r_rt.compile().placement.split == 0
        assert prog.fused and "dequant_idct" not in prog.stages
    assert t_report.stats.num_items == 8 and t_report.stats.batches == r_report.stats.batches == 2
    assert len(t_outs) == len(r_outs) == 8
    for a, b in zip(t_outs, r_outs):
        assert a.shape == (2,)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
        assert np.argmax(a) == np.argmax(b)
