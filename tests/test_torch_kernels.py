"""Port kernels (repro_torch.kernels) against the reference Pallas kernels
(interpret mode) and their jnp oracles, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card by
``chip_smoke.py``.  Same inputs (numpy, seeded) on both sides.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.device_compiler import _resize_affine_jnp  # noqa: E402
from repro.kernels.fused_preproc import ops as ref_fp  # noqa: E402
from repro.kernels.fused_preproc.ref import fused_resize_normalize_ref  # noqa: E402
from repro.kernels.idct import ops as ref_idct  # noqa: E402
from repro.kernels.idct.ref import dequant_idct_ref  # noqa: E402
from repro.preprocessing import dct  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fused_preproc import ops as fp  # noqa: E402
from repro_torch.kernels.fused_preproc import plain as fp_plain  # noqa: E402
from repro_torch.kernels.idct import ops as idct  # noqa: E402

# the port's entry points default to the card; the CPU is asked for by name
dequant_idct = functools.partial(idct.dequant_idct, device="cpu")
fused_resize_normalize = functools.partial(fp.fused_resize_normalize, device="cpu")

RNG = np.random.default_rng(0)
SCALE = (1 / 255 / np.array([0.229, 0.224, 0.225])).astype(np.float32)
BIAS = (-np.array([0.485, 0.456, 0.406]) / np.array([0.229, 0.224, 0.225])).astype(np.float32)


# ------------------------------------------------------------------ IDCT (K1)
@pytest.mark.parametrize("n", [1, 5, 512, 777])
@pytest.mark.parametrize("quality", [50, 95])
def test_idct_sweep(n, quality):
    coeffs = RNG.integers(-300, 300, size=(n, 8, 8)).astype(np.int16)
    q = dct.quality_scale(dct.QTABLE_LUMA, quality)
    out = dequant_idct(coeffs, q).numpy()
    ref = np.asarray(dequant_idct_ref(jnp.asarray(coeffs), jnp.asarray(q)))
    np.testing.assert_allclose(out, ref, atol=2e-2)
    pallas = np.asarray(ref_idct.dequant_idct(coeffs, q))  # interpret mode
    np.testing.assert_allclose(out, pallas, atol=2e-2)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10-bit mantissa), to nearest with ties away from
    zero: the kernel's ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _k1_3xtf32_emulation(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """K1's point-8 arithmetic in torch: x and m split into TF32 hi + lo,
    per k-step of 8 the three products lo.hi + hi.lo + hi.hi from zero,
    each k-step's sum added to the f32 result."""
    xh, mh = _tf32(x), _tf32(m)
    xl, ml = _tf32(x - xh), _tf32(m - mh)
    acc = torch.zeros((x.shape[0], m.shape[1]))
    for k0 in range(0, 64, 8):
        ks = slice(k0, k0 + 8)
        acc += xl[:, ks] @ mh[ks] + xh[:, ks] @ ml[ks] + xh[:, ks] @ mh[ks]
    return acc


@pytest.mark.parametrize("quality", [50, 95])
def test_k1_3xtf32_arithmetic_within_bound(quality):
    # the bound of every K1 check (2e-2): 3xTF32 keeps near-fp32 accuracy
    # where one TF32 product (10 mantissa bits) does not
    coeffs = RNG.integers(-300, 300, size=(512, 8, 8)).astype(np.int16)
    q = dct.quality_scale(dct.QTABLE_LUMA, quality)
    m = torch.from_numpy(idct.idct_matrix(q, 8))
    x = torch.from_numpy(coeffs.reshape(-1, 64).astype(np.float32))
    got = _k1_3xtf32_emulation(x, m).numpy().reshape(-1, 8, 8)
    pallas = np.asarray(ref_idct.dequant_idct(coeffs, q))  # interpret mode
    np.testing.assert_allclose(got, pallas, atol=2e-2)
    one_pass = (_tf32(x) @ _tf32(m)).numpy().reshape(-1, 8, 8)
    assert np.abs(one_pass - pallas).max() > 2e-2


@pytest.mark.parametrize("point", [8, 4, 2, 1])
@pytest.mark.parametrize("n", [3, 512])
def test_scaled_idct_matches_ref(point, n):
    coeffs = RNG.integers(-300, 300, size=(n, 8, 8)).astype(np.int16)
    q = dct.quality_scale(dct.QTABLE_CHROMA, 75)
    out = dequant_idct(coeffs, q, point=point).numpy()
    assert out.shape == (n, point, point)
    ref = np.asarray(dequant_idct_ref(jnp.asarray(coeffs), jnp.asarray(q), point=point))
    np.testing.assert_allclose(out, ref, atol=2e-2)


def test_scaled_idct_point8_is_full_and_point1_is_dc():
    coeffs = RNG.integers(-200, 200, size=(16, 8, 8)).astype(np.int16)
    q = dct.quality_scale(dct.QTABLE_LUMA, 85)
    full = dequant_idct(coeffs, q, point=8).numpy()
    default = dequant_idct(coeffs, q).numpy()
    np.testing.assert_array_equal(full, default)
    dc = dequant_idct(coeffs, q, point=1).numpy()[:, 0, 0]
    np.testing.assert_allclose(dc, coeffs[:, 0, 0] * q[0, 0] / 8.0, atol=1e-3)


def test_scaled_idct_mean_preservation():
    coeffs = RNG.integers(-200, 200, size=(64, 8, 8)).astype(np.int16)
    q = dct.quality_scale(dct.QTABLE_LUMA, 90)
    full = dequant_idct(coeffs, q, point=8).numpy()
    for point in (4, 2, 1):
        scaled = dequant_idct(coeffs, q, point=point).numpy()
        np.testing.assert_allclose(scaled.mean(axis=(1, 2)), full.mean(axis=(1, 2)), atol=1e-2)


@pytest.mark.parametrize("point", [8, 4, 2, 1])
def test_idct_matrix_is_reference_matrix_unpadded(point):
    # the kernel computes only the point^2 columns the reference keeps
    q = dct.quality_scale(dct.QTABLE_LUMA, 70)
    ref = ref_idct._m2q_t(np.ascontiguousarray(q, np.int32).tobytes(), point)
    np.testing.assert_array_equal(idct.idct_matrix(q, point), ref[:, : point * point])


# ------------------------------------------------------- fused preproc (K2)
@pytest.mark.parametrize(
    "h,w,oh,ow", [(161, 193, 224, 224), (64, 64, 224, 224), (300, 200, 96, 128)]
)
def test_fused_preproc_sweep(h, w, oh, ow):
    x = RNG.uniform(0, 255, size=(3, h, w)).astype(np.float32)
    out = fused_resize_normalize(x, oh, ow, SCALE, BIAS).numpy()
    ref = np.asarray(
        fused_resize_normalize_ref(jnp.asarray(x), oh, ow, jnp.asarray(SCALE), jnp.asarray(BIAS))
    )
    np.testing.assert_allclose(out, ref, atol=5e-4)
    pallas = np.asarray(ref_fp.fused_resize_normalize(x, oh, ow, SCALE, BIAS))
    np.testing.assert_allclose(out, pallas, atol=5e-4)


@pytest.mark.parametrize("round_uint8", [False, True])
def test_fused_resize_affine_crop_sliced_matrices(round_uint8):
    # the reference wrapper's API: crop-sliced interpolation matrices and a
    # per-plane affine over batch*channels planes
    n, h, w = 2, 97, 131
    ry = ref_fp.bilinear_matrix(h, 80)[8:72]
    rxt = np.ascontiguousarray(ref_fp.bilinear_matrix(w, 90)[5:69].T)
    x = RNG.integers(0, 256, size=(n * 3, h, w)).astype(np.float32)
    scale, bias = np.tile(SCALE, n), np.tile(BIAS, n)
    out = fp.fused_resize_affine(torch.from_numpy(x), ry, rxt, scale, bias, round_uint8).numpy()
    ref = np.asarray(
        ref_fp.fused_resize_affine(
            jnp.asarray(x), ry, rxt, jnp.asarray(scale), jnp.asarray(bias), round_uint8=round_uint8
        )
    )
    assert out.shape == ref.shape == (n * 3, 64, 64)
    diff = np.abs(out - ref)
    if round_uint8:
        # the reference resamples by matmul: a value on a rounding tie can
        # land one uint8 step away from the gather's
        assert diff.max() <= SCALE.max() + 5e-4
        assert (diff > 5e-4).mean() < 1e-2
    else:
        assert diff.max() <= 5e-4


@pytest.mark.parametrize("round_uint8", [False, True])
def test_plain_resample_matches_reference_gather_bitwise(round_uint8):
    # the plain version repeats _resize_affine_jnp's expression tree, so the
    # CPU result equals the reference gather lowering (and the CUDA kernel
    # equals the plain version, checked on the card)
    n, h, w, oh, ow = 2, 50, 70, 40, 64
    rows, cols = (4, 32), (10, 48)
    x = RNG.integers(0, 256, size=(n, 3, h, w)).astype(np.float32)
    ref = np.asarray(
        _resize_affine_jnp(jnp.asarray(x), oh, ow, rows, cols, jnp.asarray(SCALE),
                           jnp.asarray(BIAS), round_uint8)
    )
    taps = [torch.from_numpy(t) for t in (*fp.bilinear_taps(h, oh, *rows), *fp.bilinear_taps(w, ow, *cols))]
    out = fp_plain.resize_affine_planar(
        torch.from_numpy(x.reshape(n * 3, h, w)), *taps,
        torch.from_numpy(np.tile(SCALE, n)), torch.from_numpy(np.tile(BIAS, n)), round_uint8,
    ).numpy()
    np.testing.assert_allclose(out.reshape(ref.shape), ref, rtol=0, atol=1e-6)


def _main_path_taps():
    # SmolRuntime's standard chain at 224 over 384x512 images: crop 336x336
    # at (24, 88), resize to 224x224 (what chip_smoke.py's main path runs)
    from repro_torch.core import dag as dag_mod
    from repro_torch.core import device_compiler as DC
    from repro_torch.core.planner import standard_chain
    from repro_torch.preprocessing.ops import TensorMeta

    meta = TensorMeta((384, 512, 3), "uint8", "HWC")
    return DC.lowering_taps(DC.lower_device_ops(dag_mod.optimize(standard_chain(224), meta).ops, meta))


@pytest.mark.parametrize("shape", ["main path", "upsample 161x193->224x300", "wide 40x20000->30x1500"])
def test_k2_band_plan_stages_every_tap_within_budget(shape):
    if shape == "main path":
        y0, y1, _, x0, x1, _ = _main_path_taps()
    elif shape.startswith("upsample"):
        (y0, y1, _), (x0, x1, _) = fp.bilinear_taps(161, 224), fp.bilinear_taps(193, 300)
    else:
        (y0, y1, _), (x0, x1, _) = fp.bilinear_taps(40, 30), fp.bilinear_taps(20000, 1500)
    plan = fp.band_plan(y0, y1, x0, x1)
    oh, ow = len(y0), len(x0)
    for t0 in range(0, ow, fp.TILE_COLS):
        tile = [p for p in plan if p["t0"] == t0]
        cols = slice(t0, t0 + fp.TILE_COLS)
        # the sub-bands cut each band of BAND_ROWS output rows, in order
        assert [p["r0"] for p in tile] == [0] + [p["r1"] for p in tile[:-1]] and tile[-1]["r1"] == oh
        assert all(p["r0"] // fp.BAND_ROWS == (p["r1"] - 1) // fp.BAND_ROWS for p in tile)
        for p in tile:
            rows = slice(p["r0"], p["r1"])
            assert p["cmin"] <= min(x0[cols].min(), x1[cols].min())
            assert max(x0[cols].max(), x1[cols].max()) <= p["cmax"] < p["pitch"] + p["cmin"] - 3
            if p["staged"]:  # the staged input rows hold every row tap, within the budget
                assert p["lo"] <= min(y0[rows].min(), y1[rows].min())
                assert max(y0[rows].max(), y1[rows].max()) <= p["hi"]
                assert (p["hi"] - p["lo"] + 1) * p["pitch"] * 4 <= fp.STAGE_BYTES
            else:  # one output row whose two input rows do not fit: direct reads
                assert p["r1"] == p["r0"] + 1 and 2 * p["pitch"] * 4 > fp.STAGE_BYTES
    if shape != "wide 40x20000->30x1500":
        # one staged pass per band: 16 output rows of a plane per block
        assert all(p["staged"] for p in plan) and len(plan) == -(-oh // fp.BAND_ROWS)


def test_taps_recovered_from_matrix():
    for in_dim, out_dim in ((161, 224), (224, 161), (7, 7), (5, 1)):
        got = fp.taps_from_matrix(fp.bilinear_matrix(in_dim, out_dim))
        i0, i1, w1 = fp.bilinear_taps(in_dim, out_dim)
        np.testing.assert_array_equal(got[0], i0)
        # where a row has one tap (weight 0 or clamped edge) the gather
        # reads v[i0] either way
        one = got[0] == got[1]
        np.testing.assert_array_equal(got[1][~one], i1[~one])
        np.testing.assert_array_equal(got[2][~one], w1[~one])


# ------------------------------------------------------- no quiet fallback
def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(None)  # the default is the card, not the CPU
    assert resolve_device("cpu").type == "cpu"
    coeffs = RNG.integers(-50, 50, size=(4, 8, 8)).astype(np.int16)
    with pytest.raises(RuntimeError, match="cuda"):
        idct.dequant_idct(coeffs, dct.QTABLE_LUMA)  # a numpy input goes to the card
    with pytest.raises(RuntimeError, match="cuda"):
        fp.fused_resize_normalize(np.zeros((3, 8, 8), np.float32), 4, 4, SCALE, BIAS, device="cuda")


def test_wrappers_never_fall_back_to_plain_off_the_cpu():
    # a tensor that is not on the CPU goes to the kernel or raises; the
    # meta device stands in for "not the CPU" here
    m = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        idct.idct_rows(torch.empty((4, 64), device="meta"), m)
    taps = [torch.empty(8, dtype=dt, device="meta") for dt in (torch.int32,) * 2 + (torch.float32,)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fp.resize_affine_planar(
            torch.empty((3, 8, 8), device="meta"), *taps, *taps,
            torch.empty(3, device="meta"), torch.empty(3, device="meta"),
        )


def test_wrappers_check_dtype_and_shape():
    with pytest.raises(TypeError):
        idct.idct_rows(torch.zeros((4, 64), dtype=torch.float64), torch.zeros((64, 64)))
    with pytest.raises(ValueError):
        idct.idct_rows(torch.zeros((4, 63)), torch.zeros((64, 64)))
    with pytest.raises(ValueError):
        idct.idct_rows(torch.zeros((4, 64)), torch.zeros((64, 9)))
    taps = [torch.from_numpy(t) for t in (*fp.bilinear_taps(8, 4), *fp.bilinear_taps(8, 4))]
    with pytest.raises(ValueError, match="scale"):
        fp.resize_affine_planar(torch.zeros((3, 8, 8)), *taps, torch.ones(2), torch.zeros(3))


def test_failed_build_raises(monkeypatch, tmp_path):
    # no nvcc anywhere: the first kernel launch must raise, not degrade
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()


def test_launch_counters_ignore_cpu_calls():
    before = (idct.idct_rows.launches, fp.resize_affine_planar.launches)
    dequant_idct(RNG.integers(-5, 5, size=(2, 8, 8)).astype(np.int16), dct.QTABLE_LUMA)
    fused_resize_normalize(RNG.uniform(size=(3, 8, 8)).astype(np.float32), 4, 4, SCALE, BIAS)
    assert (idct.idct_rows.launches, fp.resize_affine_planar.launches) == before
