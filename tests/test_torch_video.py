"""The port's copied SVID video codec and ``StoredVideo`` against the
reference's, in one process on the CPU: byte-identical encodes over a grid
of quality, GOP length and frame size (one not a multiple of 16), bitwise
equal decodes (deblocking on and off, seeks, ``max_frames``), headers and
the deblocking filter; then decoded frames of a synthetic video dataset
through both packages' pixel program into the same tiny ResNet."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from conftest import smooth_image  # noqa: E402
from repro.core import dag as ref_dag  # noqa: E402
from repro.core import device_compiler as RDC  # noqa: E402
from repro.core.planner import standard_chain as ref_chain  # noqa: E402
from repro.data import datasets as ref_datasets  # noqa: E402
from repro.models import resnet as ref_resnet  # noqa: E402
from repro.preprocessing import formats as ref_formats  # noqa: E402
from repro.preprocessing import ops as RP  # noqa: E402
from repro.preprocessing import video as ref_video  # noqa: E402
from repro_torch.core import dag as t_dag  # noqa: E402
from repro_torch.core import device_compiler as TDC  # noqa: E402
from repro_torch.core.planner import standard_chain as t_chain  # noqa: E402
from repro_torch.data import datasets as t_datasets  # noqa: E402
from repro_torch.models import resnet as t_resnet  # noqa: E402
from repro_torch.preprocessing import formats as t_formats  # noqa: E402
from repro_torch.preprocessing import ops as TP  # noqa: E402
from repro_torch.preprocessing import video as t_video  # noqa: E402

SIZES = [(32, 48), (40, 52)]  # the second is no multiple of 16 (nor of 8 in w)


def _frames(h, w, t=10, seed=5):
    """A smooth image panning right, plus a little per-frame noise."""
    rng = np.random.default_rng(seed)
    base = smooth_image(rng, h, w).astype(np.int64)
    return np.stack([
        np.clip(np.roll(base, 3 * i, axis=1) + rng.integers(-4, 5, base.shape), 0, 255).astype(np.uint8)
        for i in range(t)
    ])


def _assert_frames_equal(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("gop", [1, 4, 8])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_encode_bytes_match_reference(quality, gop, hw):
    frames = _frames(*hw)
    blob = t_video.encode(frames, quality=quality, gop=gop)
    assert blob == ref_video.encode(frames, quality=quality, gop=gop)
    # the header's fields one by one: the two packages' classes differ
    t_hdr, r_hdr = t_video.peek_header(blob), ref_video.peek_header(blob)
    for name in r_hdr.__dataclass_fields__:
        assert getattr(t_hdr, name) == getattr(r_hdr, name), name


DECODE_CASES = [
    ("all", {}),
    ("seek", {"frame_indices": [9, 2, 5, 2]}),
    ("max_frames", {"max_frames": 5}),
]


@pytest.mark.parametrize("deblock", [True, False])
@pytest.mark.parametrize("label,kw", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_matches_reference(label, kw, deblock):
    blob = ref_video.encode(_frames(*SIZES[1]), quality=60, gop=4)
    _assert_frames_equal(t_video.decode(blob, deblock=deblock, **kw),
                         ref_video.decode(blob, deblock=deblock, **kw))


@pytest.mark.parametrize("strength", [0.5, 0.9])
@pytest.mark.parametrize("shape", [(40, 52), (7, 9), (8, 8)])
def test_deblock_plane_matches_reference(shape, strength):
    plane = np.random.default_rng(11).normal(0, 40, size=shape)
    np.testing.assert_array_equal(t_video.deblock_plane(plane, strength),
                                  ref_video.deblock_plane(plane, strength))


def test_peek_header_rejects_other_streams():
    for mod in (t_video, ref_video):
        with pytest.raises(ValueError, match="SVID"):
            mod.peek_header(b"SJPG" + bytes(40))


FORMAT_LISTS = [
    ("default", None),
    ("renditions", [(None, 75), (24, 75), (16, 50), (None, 95)]),
]


@pytest.mark.parametrize("label,fmts", FORMAT_LISTS, ids=[c[0] for c in FORMAT_LISTS])
def test_stored_video_matches_reference(label, fmts):
    frames = _frames(*SIZES[1], t=6)
    if fmts is None:
        r_sv = ref_formats.StoredVideo.from_frames(frames, gop=4)
        t_sv = t_formats.StoredVideo.from_frames(frames, gop=4)
    else:
        r_sv = ref_formats.StoredVideo.from_frames(
            frames, [ref_formats.VideoFormat(short_side=s, quality=q) for s, q in fmts], gop=4)
        t_sv = t_formats.StoredVideo.from_frames(
            frames, [t_formats.VideoFormat(short_side=s, quality=q) for s, q in fmts], gop=4)
    assert t_sv.native_shape == r_sv.native_shape
    assert [f.key for f in t_sv.formats()] == [f.key for f in r_sv.formats()]
    assert [str(f) for f in t_sv.formats()] == [str(f) for f in r_sv.formats()]
    for t_fmt, r_fmt in zip(t_sv.formats(), r_sv.formats()):
        assert t_sv.variants[t_fmt] == r_sv.variants[r_fmt]
        assert t_sv.nbytes(t_fmt) == r_sv.nbytes(r_fmt)
        for kw in ({}, {"deblock": False}, {"frame_indices": [4, 1]}, {"max_frames": 2}):
            _assert_frames_equal(t_sv.decode(t_fmt, **kw), r_sv.decode(r_fmt, **kw))


# ------------------------------------------- the slice: frames -> pixel program
INPUT = 32
FRAMES = 12


def _tiny_resnet(num_classes=9, seed=0):
    """The reference's TINY_RESNET parameters (numpy) and the port's module
    holding them."""
    params = jax.tree.map(np.array, ref_resnet.init_resnet(
        ref_resnet.TINY_RESNET, jax.random.PRNGKey(seed), num_classes=num_classes))
    return params, t_resnet.from_jax_params(params, t_resnet.TINY_RESNET)


@pytest.mark.parametrize("rendition,deblock", [(0, True), (1, False)], ids=["full", "low-no-deblock"])
def test_video_frames_through_pixel_program_match_reference(rendition, deblock):
    """``video_dataset``'s renditions decoded in both packages (the same
    frames), then ``standard_chain(32)`` + TINY_RESNET as one pixel program
    in each: the reference's fused stage through its Pallas kernel in
    interpret mode, the port's kernel wrapper on its plain path."""
    r_sv, r_counts = ref_datasets.video_dataset("rialto", FRAMES, seed=1, size=48)
    t_sv, t_counts = t_datasets.video_dataset("rialto", FRAMES, seed=1, size=48)
    np.testing.assert_array_equal(t_counts, r_counts)
    r_fmt, t_fmt = r_sv.formats()[rendition], t_sv.formats()[rendition]
    r_frames = r_sv.decode(r_fmt, deblock=deblock)
    t_frames = t_sv.decode(t_fmt, deblock=deblock)
    _assert_frames_equal(t_frames, r_frames)
    shape = t_frames.shape[1:]
    r_meta, t_meta = RP.TensorMeta(shape, "uint8", "HWC"), TP.TensorMeta(shape, "uint8", "HWC")
    r_ops = ref_dag.optimize(ref_chain(INPUT), r_meta).ops
    t_ops = t_dag.optimize(t_chain(INPUT), t_meta).ops
    params, model = _tiny_resnet()
    r_prog = RDC.compile_device_program(
        r_ops, r_meta, lambda x: ref_resnet.resnet_forward(params, ref_resnet.TINY_RESNET, x),
        FRAMES, impl="pallas")
    t_prog = TDC.compile_device_program(t_ops, t_meta, model, FRAMES, impl="kernel", device="cpu")
    assert t_prog.fused and "requant" in " ".join(t_prog.stages)
    ref = np.asarray(r_prog(r_frames))
    with torch.inference_mode():
        out = t_prog(t_frames).numpy()
    assert out.shape == ref.shape == (FRAMES, 9)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out.argmax(1), ref.argmax(1))
