"""The port's copied SJPG/SPNG codecs against the reference's, on the CPU:
byte-identical encodes and identical decodes, entropy-stage coefficients and
staged coefficient tensors (4:4:4 and 4:2:0, padded and packed)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import smooth_image  # noqa: E402
from repro.preprocessing import formats as ref_formats  # noqa: E402
from repro.preprocessing import jpeg as ref_jpeg  # noqa: E402
from repro.preprocessing import png as ref_png  # noqa: E402
from repro_torch.preprocessing import formats as t_formats  # noqa: E402
from repro_torch.preprocessing import jpeg as t_jpeg  # noqa: E402
from repro_torch.preprocessing import png as t_png  # noqa: E402


def _image(h, w, seed=21):
    return smooth_image(np.random.default_rng(seed), h, w)


def _assert_same(a, b):
    """Recursive equality over the codecs' return values."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__
        for name in a.__dataclass_fields__:
            _assert_same(getattr(a, name), getattr(b, name))
    else:
        assert a == b


@pytest.mark.parametrize("subsample", [False, True])
@pytest.mark.parametrize("h,w", [(64, 80), (97, 131)])
def test_sjpg_encode_decode_identical(subsample, h, w):
    img = _image(h, w)
    data = ref_jpeg.encode(img, quality=85, subsample=subsample)
    assert t_jpeg.encode(img, quality=85, subsample=subsample) == data
    _assert_same(t_jpeg.peek_header(data), ref_jpeg.peek_header(data))
    np.testing.assert_array_equal(t_jpeg.decode(data), ref_jpeg.decode(data))
    np.testing.assert_array_equal(t_jpeg.decode_scaled(data, 2), ref_jpeg.decode_scaled(data, 2))
    t_coeffs = t_jpeg.decode_to_coefficients(data)
    r_coeffs = ref_jpeg.decode_to_coefficients(data)
    _assert_same(t_coeffs, r_coeffs)
    hdr, planes = r_coeffs[0], r_coeffs[1]
    for layout in ("padded", "packed"):
        staged = t_jpeg.stage_coefficients(t_coeffs[1], t_coeffs[0], layout)
        ref = ref_jpeg.stage_coefficients(planes, hdr, layout)
        assert staged.dtype == ref.dtype == np.int16
        np.testing.assert_array_equal(staged, ref)
        assert t_jpeg.staged_coeff_shape(t_coeffs[0], layout) == ref.shape


def test_sjpg_grayscale_identical():
    img = _image(72, 80)[..., 0]
    data = ref_jpeg.encode(img, quality=90)
    assert t_jpeg.encode(img, quality=90) == data
    np.testing.assert_array_equal(t_jpeg.decode(data), ref_jpeg.decode(data))


def test_spng_encode_decode_identical():
    img = _image(70, 90)
    data = ref_png.encode(img)
    assert t_png.encode(img) == data
    np.testing.assert_array_equal(t_png.decode(data), ref_png.decode(data))
    np.testing.assert_array_equal(t_png.decode(data, max_rows=20), ref_png.decode(data, max_rows=20))


def test_stored_image_variants_identical():
    img = _image(96, 120)
    keys = [("jpeg", None, 95, False), ("jpeg", 48, 75, True), ("png", 48, None, False)]
    t_img = t_formats.StoredImage.from_array(img, [t_formats.ImageFormat(*k) for k in keys])
    r_img = ref_formats.StoredImage.from_array(img, [ref_formats.ImageFormat(*k) for k in keys])
    for k in keys:
        t_fmt, r_fmt = t_formats.ImageFormat(*k), ref_formats.ImageFormat(*k)
        assert t_fmt.key == r_fmt.key
        assert t_img.variants[t_fmt] == r_img.variants[r_fmt]
        np.testing.assert_array_equal(t_img.decode(t_fmt), r_img.decode(r_fmt))
