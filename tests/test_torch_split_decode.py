"""The split-decode program's device tail, port against reference, on the CPU.

K1's int16 zigzag entry (``kernels/idct`` ``idct_zigzag_rows``, the staged
batch read in place through views) against the reference's Pallas kernel
in interpret mode; the zigzag-ordered matrix the kernel multiplies by; K5
(``kernels/blocks_to_rgb``) against the reference's jnp tail rebuilt here
from the same K1 outputs; the wrappers' checks; and the launches a
coefficient program makes per dispatch.  On a CPU tensor each wrapper runs
its plain version; ``chip_smoke.py`` holds the CUDA kernels against those
on the card.  Inputs are numpy, seeded, on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from conftest import smooth_image  # noqa: E402
from repro.core import device_compiler as RDC  # noqa: E402
from repro.core import dag as ref_dag  # noqa: E402
from repro.core.planner import standard_chain as ref_chain  # noqa: E402
from repro.kernels.idct import ops as ref_idct  # noqa: E402
from repro.preprocessing import dct as ref_dct  # noqa: E402
from repro.preprocessing import jpeg as ref_jpeg  # noqa: E402
from repro.preprocessing import ops as RP  # noqa: E402
from repro_torch.core import dag as t_dag  # noqa: E402
from repro_torch.core import device_compiler as TDC  # noqa: E402
from repro_torch.core.planner import standard_chain as t_chain  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.blocks_to_rgb import ops as b2r  # noqa: E402
from repro_torch.kernels.blocks_to_rgb import plain as b2r_plain  # noqa: E402
from repro_torch.kernels.fused_preproc import ops as fp  # noqa: E402
from repro_torch.kernels.idct import ops as idct  # noqa: E402
from repro_torch.kernels.idct import plain as idct_plain  # noqa: E402
from repro_torch.preprocessing import jpeg as t_jpeg  # noqa: E402
from repro_torch.preprocessing import ops as TP  # noqa: E402

K1_ATOL = 2e-2  # as tests/test_torch_kernels.py: values reach ~1e4
PRE_ROUND_ATOL = 1e-4  # K5 before rounding: only the 3-term sum's order differs
QSTEP = (1.0 / 255.0) / 0.224  # one uint8 step through the steepest Normalize std
N_IMG, N_BR, N_BC = 2, 3, 5  # a small 4:2:0 batch: chroma grid 2 x 3
CBR, CBC = (N_BR + 1) // 2, (N_BC + 1) // 2


def _qtable(which: str, quality: int = 90) -> np.ndarray:
    base = ref_dct.QTABLE_LUMA if which == "luma" else ref_dct.QTABLE_CHROMA
    return ref_dct.quality_scale(base, quality)


def _staged(layout: str, seed: int = 0) -> np.ndarray:
    """A batch of staged int16 zigzag coefficients in ``layout``."""
    rng = np.random.default_rng(seed)
    if layout == "padded":
        shape = (N_IMG, 3, N_BR, N_BC, 64)
    else:
        shape = (N_IMG, N_BR * N_BC + 2 * CBR * CBC, 64)
    return rng.integers(-300, 300, size=shape).astype(np.int16)


def _view(zz: torch.Tensor, layout: str, plane: str) -> torch.Tensor:
    """The split-decode program's views of the staged batch."""
    n_luma = N_BR * N_BC
    if layout == "padded":
        return zz[:, 0] if plane == "luma" else zz[:, 1:, :CBR, :CBC]
    return zz[:, :n_luma] if plane == "luma" else zz[:, n_luma:]


# ------------------------------------------------------ K1, int16 zigzag rows
@pytest.mark.parametrize("point", [8, 4, 2])
@pytest.mark.parametrize("table", ["luma", "chroma"])
@pytest.mark.parametrize("layout,plane", [("padded", "luma"), ("padded", "chroma"),
                                          ("packed", "luma"), ("packed", "chroma")])
def test_zigzag_rows_match_reference(point, table, layout, plane):
    q = _qtable(table)
    x = _view(torch.from_numpy(_staged(layout)), layout, plane)
    got = idct.idct_zigzag_rows(x, torch.from_numpy(idct.zigzag_matrix(q, point))).numpy()
    rows = x.numpy().reshape(-1, 64)[:, ref_dct.UNZIGZAG].reshape(-1, 8, 8)
    want = np.asarray(ref_idct.dequant_idct(rows, q, point=point))  # interpret mode
    assert got.shape == (rows.shape[0], point * point)
    np.testing.assert_allclose(got, want.reshape(-1, point * point), atol=K1_ATOL)


@pytest.mark.parametrize("layout,plane", [("padded", "luma"), ("padded", "chroma"),
                                          ("packed", "chroma")])
def test_zigzag_plain_is_the_former_arithmetic(layout, plane):
    # the program computed unzigzag -> cast -> natural product before K1
    # read the staged rows in place; the plain version is that, bit for bit
    q = _qtable("chroma" if plane == "chroma" else "luma")
    x = _view(torch.from_numpy(_staged(layout, seed=1)), layout, plane)
    unzigzag = torch.from_numpy(np.asarray(ref_dct.UNZIGZAG, np.int64))
    before = x.index_select(-1, unzigzag).reshape(-1, 64).to(torch.float32) @ torch.from_numpy(
        idct.idct_matrix(q, 8))
    got = idct_plain.idct_zigzag_rows(x, torch.from_numpy(idct.zigzag_matrix(q, 8)))
    assert torch.equal(got, before)


@pytest.mark.parametrize("order,point", sorted(idct.K_ROWS))
@pytest.mark.parametrize("quality", [10, 50, 90, 100])
def test_k_rows_cover_every_nonzero_matrix_row(order, point, quality):
    # the kernel reads only a row's first K_ROWS coefficients
    matrix = idct.zigzag_matrix if order == "zigzag" else idct.idct_matrix
    for table in ("luma", "chroma"):
        m = matrix(_qtable(table, quality), point)
        k = idct.K_ROWS[order, point]
        assert k % 8 == 0 and np.abs(m[:k]).max() > 0, (order, k)
        assert not m[k:].any(), (order, point, np.nonzero(m[k:].any(1))[0] + k)


@pytest.mark.parametrize("point", [8, 4, 2])
@pytest.mark.parametrize("table", ["luma", "chroma"])
def test_permuted_truncated_product_matches_natural(point, table):
    # what the kernel computes (up to 3xTF32): the zigzag row's first K
    # values times the zigzag-ordered matrix's first K rows
    q = _qtable(table)
    zz = _staged("packed", seed=2).reshape(-1, 64)
    k = idct.K_ROWS["zigzag", point]
    m_zz = torch.from_numpy(idct.zigzag_matrix(q, point))
    got = torch.from_numpy(zz[:, :k].astype(np.float32)) @ m_zz[:k]
    natural = torch.from_numpy(zz[:, ref_dct.UNZIGZAG].astype(np.float32)) @ torch.from_numpy(
        idct.idct_matrix(q, point))
    np.testing.assert_allclose(got.numpy(), natural.numpy(), atol=K1_ATOL)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10-bit mantissa), to nearest, ties away: the
    kernel's ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("point", [8, 4, 2])
def test_k1_int16_3xtf32_arithmetic_within_bound(point):
    # the kernel's arithmetic on int16 rows: hi + lo holds an int16 exactly,
    # so only a_lo b_lo is dropped per product, summed per k-step of 8
    q = _qtable("luma", 95)
    zz = _staged("packed", seed=3).reshape(-1, 64)
    k = idct.K_ROWS["zigzag", point]
    x = torch.from_numpy(zz[:, :k].astype(np.float32))
    m = torch.from_numpy(idct.zigzag_matrix(q, point))[:k]
    xh, mh = _tf32(x), _tf32(m)
    xl, ml = _tf32(x - xh), _tf32(m - mh)
    assert torch.equal(xh + xl, x)
    acc = torch.zeros((x.shape[0], m.shape[1]))
    for k0 in range(0, k, 8):
        ks = slice(k0, k0 + 8)
        acc += xl[:, ks] @ mh[ks] + xh[:, ks] @ ml[ks] + xh[:, ks] @ mh[ks]
    rows = zz[:, ref_dct.UNZIGZAG].reshape(-1, 8, 8)
    want = np.asarray(ref_idct.dequant_idct(rows, q, point=point)).reshape(-1, point * point)
    np.testing.assert_allclose(acc.numpy(), want, atol=K1_ATOL)


# ------------------------------------------------------------- K5
def _reference_tail(luma, chroma, grid):
    """The reference program's jnp tail after its IDCT calls
    (``repro.core.device_compiler.compile_coeff_program``), before and
    after its round and clamp."""
    p, n = grid.point, luma.shape[0] // (grid.n_br * grid.n_bc)
    y = (jnp.asarray(luma).reshape(n, grid.n_br, grid.n_bc, p, p)
         .transpose(0, 1, 3, 2, 4).reshape(n, grid.n_br * p, grid.n_bc * p))
    c = (jnp.asarray(chroma).reshape(n, 2, grid.cbr, grid.cbc, p, p)
         .transpose(0, 1, 2, 4, 3, 5).reshape(n, 2, grid.cbr * p, grid.cbc * p))
    if grid.subsample:
        c = jnp.repeat(jnp.repeat(c, 2, axis=2), 2, axis=3)
    hs, ws = grid.hs, grid.ws
    ycc = jnp.concatenate([y[:, None, :hs, :ws], c[:, :, :hs, :ws]], axis=1) + 128.0
    rgb = jnp.einsum("rc,nchw->nrhw", jnp.asarray(RDC._YCBCR_TO_RGB),
                     ycc - jnp.asarray([0.0, 128.0, 128.0])[:, None, None])
    return np.asarray(rgb), np.asarray(jnp.clip(jnp.round(rgb), 0.0, 255.0))


def _grid(point: int, subsample: bool) -> b2r.BlockGrid:
    cbr, cbc = (CBR, CBC) if subsample else (N_BR, N_BC)
    # odd crops that cut the last block row and column
    return b2r.BlockGrid(N_BR, N_BC, cbr, cbc, point, N_BR * point - 1, N_BC * point - 3, subsample)


def _k1_outputs(grid: b2r.BlockGrid, seed: int = 4):
    rng = np.random.default_rng(seed)
    p2 = grid.point**2
    luma = rng.uniform(-180, 180, size=(N_IMG * grid.n_br * grid.n_bc, p2)).astype(np.float32)
    chroma = rng.uniform(-140, 140, size=(N_IMG * 2 * grid.cbr * grid.cbc, p2)).astype(np.float32)
    return luma, chroma


@pytest.mark.parametrize("point", [8, 4, 2])
@pytest.mark.parametrize("subsample", [True, False])
def test_blocks_to_rgb_matches_reference_tail(point, subsample):
    grid = _grid(point, subsample)
    luma, chroma = _k1_outputs(grid)
    mat = torch.from_numpy(TDC._YCBCR_TO_RGB)
    pre = b2r_plain.rgb_unrounded(torch.from_numpy(luma), torch.from_numpy(chroma), mat, grid).numpy()
    got = b2r.blocks_to_rgb(torch.from_numpy(luma), torch.from_numpy(chroma), mat, grid).numpy()
    want_pre, want = _reference_tail(luma, chroma, grid)
    assert got.shape == want.shape == (N_IMG, 3, grid.hs, grid.ws)
    np.testing.assert_allclose(pre, want_pre, rtol=0, atol=PRE_ROUND_ATOL)
    near_tie = np.abs(np.abs(want_pre - np.floor(want_pre)) - 0.5) <= PRE_ROUND_ATOL
    assert ((got == want) | near_tie).all()
    assert (got == 0).any() and (got == 255).any()  # both clamps ran


def test_blocks_to_rgb_rounds_half_to_even():
    # luma blocks that land exactly on .5 after the level shift
    grid = b2r.BlockGrid(1, 1, 1, 1, 2, 2, 2, False)
    luma = torch.tensor([[-127.5, -126.5, 0.5, 1.5]])
    chroma = torch.zeros((2, 4))
    got = b2r.blocks_to_rgb(luma, chroma, torch.from_numpy(TDC._YCBCR_TO_RGB), grid)
    assert got[0, 0].flatten().tolist() == [0.0, 2.0, 128.0, 130.0]


# -------------------------------------------------------------- wrappers
def test_row_view_sizes_strides_and_alignment():
    zz = torch.zeros((N_IMG, 3, N_BR, N_BC, 64), dtype=torch.int16)
    sizes, strides = idct.row_view(zz[:, 1:, :CBR, :CBC])
    assert sizes == [N_IMG, 2, CBR, CBC]
    assert strides == [3 * N_BR * N_BC * 64, N_BR * N_BC * 64, N_BC * 64, 64]
    assert idct.row_view(zz[:, 0]) == ([1, N_IMG, N_BR, N_BC], [0, 3 * N_BR * N_BC * 64, N_BC * 64, 64])
    wide = torch.zeros((4, 68), dtype=torch.int16)[:, :64]  # 136-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        idct.row_view(wide)
    flat = torch.zeros(8 * 64 + 4, dtype=torch.int16)
    with pytest.raises(ValueError, match="16-byte"):
        idct.row_view(flat[4:].view(8, 64))  # base 8 bytes past alignment
    with pytest.raises(ValueError, match="contiguous"):
        idct.row_view(torch.zeros((64, 4), dtype=torch.int16).t())
    with pytest.raises(ValueError, match="four"):
        idct.row_view(torch.zeros((1, 1, 1, 1, 1, 64), dtype=torch.int16))


def test_wrappers_check_dtype_and_shape():
    m = torch.from_numpy(idct.zigzag_matrix(_qtable("luma"), 4))
    with pytest.raises(TypeError):
        idct.idct_zigzag_rows(torch.zeros((4, 64)), m)  # f32 rows: natural order goes to idct_rows
    with pytest.raises(ValueError):
        idct.idct_zigzag_rows(torch.zeros((4, 63), dtype=torch.int16), m)
    with pytest.raises(ValueError):
        idct.idct_zigzag_rows(torch.zeros((4, 64), dtype=torch.int16), torch.zeros((64, 9)))
    with pytest.raises(ValueError, match="point"):  # point 1 takes natural rows only
        idct.idct_zigzag_rows(torch.zeros((4, 64), dtype=torch.int16), torch.zeros((64, 1)))
    with pytest.raises(TypeError):
        idct.idct_zigzag_rows(torch.zeros((4, 64), dtype=torch.int16), m.double())
    grid = _grid(4, True)
    luma, chroma = (torch.from_numpy(a) for a in _k1_outputs(grid))
    mat = torch.from_numpy(TDC._YCBCR_TO_RGB)
    with pytest.raises(TypeError):
        b2r.blocks_to_rgb(luma.double(), chroma, mat, grid)
    with pytest.raises(ValueError, match="chroma"):
        b2r.blocks_to_rgb(luma, chroma[:-1], mat, grid)
    with pytest.raises(ValueError, match="luma"):
        b2r.blocks_to_rgb(luma[:, :4], chroma, mat, grid)
    with pytest.raises(ValueError, match="point"):
        b2r.blocks_to_rgb(luma, chroma, mat, grid._replace(point=1))
    with pytest.raises(ValueError, match="outside the luma"):
        b2r.blocks_to_rgb(luma, chroma, mat, grid._replace(ws=N_BC * 4 + 1))
    with pytest.raises(ValueError, match="outside the chroma"):
        b2r.blocks_to_rgb(luma, chroma, mat, grid._replace(subsample=False))


def test_wrappers_never_fall_back_to_plain_off_the_cpu():
    # the meta device stands in for "not the CPU"
    m = torch.empty((64, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        idct.idct_zigzag_rows(torch.empty((4, 64), dtype=torch.int16, device="meta"), m)
    grid = b2r.BlockGrid(1, 1, 1, 1, 4, 4, 4, False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        b2r.blocks_to_rgb(torch.empty((1, 16), device="meta"), torch.empty((2, 16), device="meta"),
                          torch.empty((3, 3), device="meta"), grid)


# --------------------------------------------------- the program as a whole
def _coeff_programs(factor, subsample, layout, impl="kernel"):
    h, w = 48 * factor + 1, 64 * factor + 3  # odd sizes: partial blocks
    data = ref_jpeg.encode(smooth_image(np.random.default_rng(10 + factor), h, w),
                           quality=90, subsample=subsample)
    r_meta, t_meta = RP.TensorMeta((h, w, 3), "uint8", "HWC"), TP.TensorMeta((h, w, 3), "uint8", "HWC")
    r_ops = ref_dag.optimize(ref_chain(32), r_meta).ops
    t_ops = t_dag.optimize(t_chain(32), t_meta).ops
    r_prog = RDC.compile_coeff_program(ref_jpeg.peek_header(data), r_ops, lambda x: x, 2,
                                       factor=factor, layout=layout, impl="jnp")
    t_prog = TDC.compile_coeff_program(t_jpeg.peek_header(data), t_ops, lambda x: x, 2,
                                       factor=factor, layout=layout, impl=impl, device="cpu")
    hdr, planes, _, _ = t_jpeg.decode_to_coefficients(data)
    staged = t_jpeg.stage_coefficients(planes, hdr, layout)
    return r_prog, t_prog, np.stack([staged, staged])


@pytest.mark.parametrize("factor,subsample,layout", [(1, False, "packed"), (2, True, "padded"),
                                                     (4, True, "padded"), (4, False, "packed")])
def test_coeff_program_pixels_match_reference(factor, subsample, layout):
    # identity model: the DNN input itself, within one uint8 step, on
    # layouts and factors beside tests/test_torch_device_compiler.py's
    r_prog, t_prog, batch = _coeff_programs(factor, subsample, layout)
    out, ref = t_prog(batch).numpy(), np.asarray(r_prog(batch))
    assert out.shape == ref.shape == (2, 3, 32, 32)
    diff = np.abs(out - ref)
    assert diff.max() <= QSTEP + 1e-4
    assert (diff > 1e-4).mean() < 1e-2


def _count_cpu_calls(monkeypatch):
    """Make each wrapper's CPU path count as a launch, as a card would."""
    for wrapper, module, name in ((idct.idct_rows, idct.plain, "idct_zigzag_rows"),
                                  (b2r.blocks_to_rgb, b2r.plain, "blocks_to_rgb"),
                                  (fp.resize_affine_planar, fp.plain, "resize_affine_planar")):
        def counted(*args, _fn=getattr(module, name), _w=wrapper, **kwargs):
            _build.count_launch(_w)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)


def test_program_launches_k1_twice_k5_once_k2_once(monkeypatch):
    # what capture_program records per graph: the launches of the wrappers
    # that _kernel_counters names, counted on the capturing thread over one
    # run of the program (the same as the counters' deltas)
    _, t_prog, batch = _coeff_programs(2, True, "padded")
    counters = TDC._kernel_counters()
    assert counters["blocks_to_rgb"] is b2r.blocks_to_rgb
    assert counters["idct"] is idct.idct_rows
    _count_cpu_calls(monkeypatch)
    before = {name: fn.launches for name, fn in counters.items()}
    with torch.inference_mode(), _build.thread_launches() as counted:
        t_prog.fn(torch.from_numpy(batch))
    launches = {name: fn.launches - before[name] for name, fn in counters.items()}
    assert launches == {"idct": 2, "blocks_to_rgb": 1, "fused_preproc": 1}
    assert {name: counted.get(fn, 0) for name, fn in counters.items()} == launches
    assert t_prog.stages[:5] == ("unzigzag", "dequant_idct/4pt", "unblockify",
                                 "chroma_upsample[2x2]", "ycbcr->rgb")


def test_plain_impl_and_cpu_calls_launch_nothing():
    counters = TDC._kernel_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    for impl in ("kernel", "plain"):
        r_prog, t_prog, batch = _coeff_programs(1, True, "packed", impl=impl)
        np.testing.assert_array_equal(t_prog(batch).numpy()[0], t_prog(batch).numpy()[1])
    assert {name: fn.launches for name, fn in counters.items()} == before
