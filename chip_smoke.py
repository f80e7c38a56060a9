#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100, ``nvcc`` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. environment: torch/CUDA versions, the card's name and power limit, the
   build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at ragged ones, then its median time (CUDA
   events, cold L2) beside the plain version's, one library call's, and
   the least time the card could take (the bound);
3. main path: ``SmolRuntime.run`` with split decode over a seeded SJPG
   corpus (384x512, 4:2:0, q90; 2 full batches of 64 + a ragged tail) into
   a full-width ResNet-50 with seeded random weights; checks the outputs,
   the plan, the kernels' launch counts, and the first batch's logits
   against a CPU run of the same program;
4. the kernels' JSON line, the card line, and ``{"ok": true, ...}`` last.

It imports nothing of JAX and nothing of the reference ``repro`` package.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 CUDA-core
# FLOP/s — the denominators of every bound_ms below
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

SEED = 0
BATCH = 64
N_ITEMS = 2 * BATCH + 22  # two full batches + a ragged tail
IMG_H, IMG_W = 384, 512
INPUT = 224
K1_ATOL = 2e-2  # fp32 FMA order vs cuBLAS fp32: values reach the thousands
LOGIT_RTOL = 1e-3  # card vs CPU logits, relative to the largest |logit|


def log(msg: str) -> None:
    print(msg, flush=True)


def smooth_image(rng: np.random.Generator, h: int, w: int, block: int = 16) -> np.ndarray:
    """Piecewise-smooth uint8 image (codec-friendly), as the tests make them."""
    base = rng.normal(size=(-(-h // block), -(-w // block), 3))
    img = np.kron(base, np.ones((block, block, 1))) * 35 + 128
    return np.clip(img, 0, 255).astype(np.uint8)[:h, :w]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def median_ms(fn, flush: torch.Tensor | None, iters: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn()`` on the card (CUDA events).  With ``flush``,
    L2 is flushed before each launch so the operands come from device
    memory, as on the main path."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- phase 2: K1
def check_idct(dev, luma_rows: int) -> float:
    """K1 against its plain version: every point, two qualities, ragged and
    main-path row counts.  Returns the largest |kernel - plain|."""
    from repro_torch.kernels.idct import ops as idct_ops
    from repro_torch.kernels.idct import plain as idct_plain
    from repro_torch.preprocessing import dct

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for point in idct_ops.SCALED_POINTS:
        for quality in (50, 95):
            q = dct.quality_scale(dct.QTABLE_LUMA, quality)
            m = torch.from_numpy(idct_ops.idct_matrix(q, point)).to(dev)
            for n in (1, 777, luma_rows):
                coeffs = rng.integers(-300, 300, size=(n, 64)).astype(np.float32)
                x = torch.from_numpy(coeffs).to(dev)
                got = idct_ops.idct_rows(x, m)
                want = idct_plain.idct_rows(x, m)
                err = (got - want).abs().max().item()
                log(f"  idct point={point} q={quality} n={n}: max|kernel-plain|={err:.3e}")
                if not err <= K1_ATOL:
                    raise AssertionError(f"idct disagrees with its plain version: {err} > {K1_ATOL}")
                worst = max(worst, err)
    return worst


def time_idct(dev, luma_rows: int, chroma_rows: int, flush) -> dict:
    """The two launches of one main-path batch (luma + chroma, point 8)."""
    from repro_torch.kernels.idct import ops as idct_ops
    from repro_torch.kernels.idct import plain as idct_plain
    from repro_torch.preprocessing import dct

    rng = np.random.default_rng(SEED)
    q = dct.quality_scale(dct.QTABLE_LUMA, 90)
    m = torch.from_numpy(idct_ops.idct_matrix(q, 8)).to(dev)
    xs = [
        torch.from_numpy(rng.integers(-300, 300, size=(n, 64)).astype(np.float32)).to(dev)
        for n in (luma_rows, chroma_rows)
    ]
    kernel = median_ms(lambda: [idct_ops.idct_rows(x, m) for x in xs], flush)
    plain = median_ms(lambda: [idct_plain.idct_rows(x, m) for x in xs], flush)
    library = median_ms(lambda: [torch.matmul(x, m) for x in xs], flush)
    rows = luma_rows + chroma_rows
    b_ms, b_by = bound_ms(rows * 64 * 4 + 2 * 64 * 64 * 4 + rows * 64 * 4, 2.0 * rows * 64 * 64)
    log(f"  idct per batch ({luma_rows}+{chroma_rows} rows, point 8): kernel {kernel:.4f} ms, "
        f"plain {plain:.4f} ms, torch.matmul {library:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {
        "name": "idct",
        "route": "cuda",
        "source": "src/repro_torch/csrc/idct.cu",
        "replaces": "src/repro/kernels/idct/idct.py:41",
        "ms": kernel,
        "plain_ms": plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library,
    }


# --------------------------------------------------------------- phase 2: K2
def _taps(low, dev):
    from repro_torch.core.device_compiler import lowering_taps

    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in lowering_taps(low)]


def check_fused_preproc(dev, low) -> None:
    """K2 against its plain version, bitwise: the main path's crop windows
    and a non-square upsample, with and without the uint8 re-quantize."""
    from repro_torch.kernels.fused_preproc import ops as fp_ops
    from repro_torch.kernels.fused_preproc import plain as fp_plain

    rng = np.random.default_rng(SEED + 1)
    scale = np.asarray(low.scale, np.float32)
    bias = np.asarray(low.bias, np.float32)
    h, w = low.in_meta.spatial
    main_taps = _taps(low, dev)
    cases = [("main path crop+resize", BATCH * 3, h, w, main_taps)]
    # a non-square upsample, no crop
    cases.append(("upsample 161x193->224x300", 6, 161, 193, [
        torch.from_numpy(a).to(dev)
        for a in (*fp_ops.bilinear_taps(161, 224), *fp_ops.bilinear_taps(193, 300))]))
    for label, planes, ph, pw, taps in cases:
        x = torch.from_numpy(rng.uniform(0, 255, size=(planes, ph, pw)).astype(np.float32)).to(dev)
        s = torch.from_numpy(np.tile(scale, planes // 3)).to(dev)
        b = torch.from_numpy(np.tile(bias, planes // 3)).to(dev)
        for round_uint8 in (True, False):
            got = fp_ops.resize_affine_planar(x, *taps, s, b, round_uint8)
            want = fp_plain.resize_affine_planar(x, *taps, s, b, round_uint8)
            same = torch.equal(got, want)
            log(f"  fused_preproc {label} round_uint8={round_uint8}: "
                f"shape {tuple(got.shape)}, bitwise equal {same}")
            if not same:
                err = (got - want).abs().max().item()
                raise AssertionError(f"fused_preproc differs from its plain version by {err}")


def time_fused_preproc(dev, low, flush) -> dict:
    """One main-path batch: 64x3 planes, crop + resize to 224, uint8 chain."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_preproc import ops as fp_ops
    from repro_torch.kernels.fused_preproc import plain as fp_plain

    rng = np.random.default_rng(SEED + 1)
    scale = np.asarray(low.scale, np.float32)
    bias = np.asarray(low.bias, np.float32)
    h, w = low.in_meta.spatial
    main_taps = _taps(low, dev)
    planes = BATCH * 3
    x = torch.from_numpy(rng.uniform(0, 255, size=(planes, h, w)).astype(np.float32)).to(dev)
    s = torch.from_numpy(np.tile(scale, BATCH)).to(dev)
    b = torch.from_numpy(np.tile(bias, BATCH)).to(dev)
    kernel = median_ms(lambda: fp_ops.resize_affine_planar(x, *main_taps, s, b, True), flush)
    plain = median_ms(lambda: fp_plain.resize_affine_planar(x, *main_taps, s, b, True), flush)
    t0, l0, ch, cw = low.pre_crop if low.pre_crop is not None else (0, 0, h, w)
    oh, ow = main_taps[0].shape[0], main_taps[3].shape[0]
    xb = x.view(BATCH, 3, h, w)[:, :, t0:t0 + ch, l0:l0 + cw]
    sc = torch.from_numpy(scale).to(dev)[None, :, None, None]
    bc = torch.from_numpy(bias).to(dev)[None, :, None, None]
    library = median_ms(
        lambda: F.interpolate(xb, size=(oh, ow), mode="bilinear", align_corners=False) * sc + bc,
        flush,
    )
    out_bytes = planes * oh * ow * 4
    b_ms, b_by = bound_ms(planes * ch * cw * 4 + out_bytes, 13.0 * planes * oh * ow)
    log(f"  fused_preproc per batch ({planes} planes {h}x{w}, crop {ch}x{cw} -> {oh}x{ow}): "
        f"kernel {kernel:.4f} ms, plain {plain:.4f} ms, F.interpolate + affine (two calls) "
        f"{library:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {
        "name": "fused_preproc",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_preproc.cu",
        "replaces": "src/repro/kernels/fused_preproc/fused_preproc.py:51",
        "max_abs_err": 0.0,  # bitwise equal in every check above
        "ms": kernel,
        "plain_ms": plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library,
    }


# ------------------------------------------------------------ phase 3: main
def make_corpus(formats):
    from repro_torch.preprocessing.formats import StoredImage

    rng = np.random.default_rng(SEED)
    return [
        StoredImage.from_array(smooth_image(rng, IMG_H, IMG_W), formats, uid=i)
        for i in range(N_ITEMS)
    ]


def run_main_path(dev, corpus, full, thumb) -> dict:
    """``SmolRuntime.run`` over ``corpus`` into ResNet-50 on ``dev``, with
    the kernels' launch counters zeroed just before the run and read just
    after; then the first batch again through the same program on the CPU."""
    from repro_torch.core import device_compiler as DC
    from repro_torch.core import planner as planner_mod
    from repro_torch.core.planner import ModelSpec
    from repro_torch.kernels.fused_preproc import ops as fp_ops
    from repro_torch.kernels.idct import ops as idct_ops
    from repro_torch.models.resnet import RESNET50, ResNet
    from repro_torch.preprocessing import jpeg
    from repro_torch.runtime import DeviceCompilerConfig, RuntimeConfig, SmolRuntime

    model = ResNet(RESNET50, generator=torch.Generator().manual_seed(SEED)).to(dev)
    exec_tput = SmolRuntime.measure_exec_throughput(model, INPUT, batch_size=BATCH, device=dev)
    log(f"[main] ResNet-50 exec throughput (synthetic, batch {BATCH}): {exec_tput:.1f} items/s")
    spec = ModelSpec("resnet50", INPUT, exec_throughput=exec_tput,
                     accuracy_by_format={full.key: 0.9, thumb.key: 0.6})
    rt = SmolRuntime(
        [spec], [full, thumb], {"resnet50": model}, calibration=corpus[:4],
        config=RuntimeConfig(batch_size=BATCH, num_workers=8, min_accuracy=0.8,
                             device=DeviceCompilerConfig(split_decode="full")),
        device=dev,
    )
    compiled = rt.compile()
    prog = compiled.device_program
    log(f"[main] plan {compiled.plan.key}, impl {prog.impl}, stages {prog.stages}")
    dispatch_before = prog.dispatch_count
    idct_ops.idct_rows.launches = 0
    fp_ops.resize_affine_planar.launches = 0
    outs, report = rt.run(corpus)
    launches = {"idct": idct_ops.idct_rows.launches,
                "fused_preproc": fp_ops.resize_affine_planar.launches}
    dispatches = prog.dispatch_count - dispatch_before

    staged = np.stack([compiled.host_fn(item) for item in corpus[:BATCH]])
    header = jpeg.peek_header(corpus[0].variants[full])
    cpu_prog = DC.compile_coeff_program(
        header, list(compiled.plan.dag_plan.ops), copy.deepcopy(model).cpu(), BATCH,
        factor=compiled.coeff.factor, layout=compiled.coeff.layout, device="cpu",
    )
    t0 = time.perf_counter()
    cpu_logits = cpu_prog(staged).numpy()
    log(f"[main] first batch on the CPU in {time.perf_counter() - t0:.1f} s")

    # where one batch's time goes: the host entropy stage (one thread) vs
    # the device program on an already-resident batch, and its DNN share
    entropy_s = planner_mod.measure_entropy_decode_time(corpus[:8], full)
    on_dev = torch.from_numpy(staged).to(dev)
    images = torch.zeros((BATCH, 3, INPUT, INPUT), device=dev)
    with torch.inference_mode():
        program_ms = median_ms(lambda: prog.fn(on_dev), None, iters=5, warmup=1)
        model_ms = median_ms(lambda: model(images), None, iters=5, warmup=1)
    log(f"[main] per batch of {BATCH}: host entropy stage {entropy_s * BATCH * 1e3:.1f} ms "
        f"on one thread ({entropy_s * 1e3:.2f} ms/item); device program {program_ms:.3f} ms, "
        f"of which ResNet-50 {model_ms:.3f} ms and decode + preprocessing "
        f"{program_ms - model_ms:.3f} ms (CUDA events)")
    return dict(compiled=compiled, prog=prog, outs=outs, report=report, launches=launches,
                dispatches=dispatches, cpu_logits=cpu_logits)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dag as dag_mod
    from repro_torch.core import device_compiler as DC
    from repro_torch.core.planner import standard_chain
    from repro_torch.kernels import _build
    from repro_torch.preprocessing import jpeg
    from repro_torch.preprocessing.formats import ImageFormat
    from repro_torch.preprocessing.ops import TensorMeta

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    log(f"[env] card: {card}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[env] kernels ready in {time.perf_counter() - t0:.2f} s (nvcc "
        f"{_build.build_info['seconds']:.2f} s, {_build.build_info['path']})")
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[env] ptxas: {line.strip()}")

    # ---- phase 2: kernels at the main path's shapes
    full = ImageFormat("jpeg", None, 90, subsample=True)
    thumb = ImageFormat("jpeg", 161, 75, subsample=True)
    pixel_meta = TensorMeta((IMG_H, IMG_W, 3), "uint8", "HWC")
    low = DC.lower_device_ops(dag_mod.optimize(standard_chain(INPUT), pixel_meta).ops, pixel_meta)
    probe = jpeg.peek_header(jpeg.encode(smooth_image(np.random.default_rng(1), IMG_H, IMG_W),
                                         quality=90, subsample=True))
    cbr, cbc = jpeg.chroma_grid(probe)
    luma_rows, chroma_rows = BATCH * probe.n_br * probe.n_bc, BATCH * 2 * cbr * cbc
    log("[kernels] idct vs plain (atol 2e-2), fused_preproc vs plain (bitwise)")
    idct_err = check_idct(dev, luma_rows)
    check_fused_preproc(dev, low)
    torch.cuda.synchronize()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    rows = [time_idct(dev, luma_rows, chroma_rows, flush), time_fused_preproc(dev, low, flush)]
    rows[0]["max_abs_err"] = idct_err
    del flush

    # ---- phase 3: the main path
    log(f"[main] corpus: {N_ITEMS} images {IMG_H}x{IMG_W}, SJPG 4:2:0 q90 + 161-px q75 thumbnail")
    t0 = time.perf_counter()
    corpus = make_corpus([full, thumb])
    log(f"[main] corpus encoded in {time.perf_counter() - t0:.1f} s")
    torch.set_num_threads(8)
    res = run_main_path(dev, corpus, full, thumb)
    compiled, prog, outs, st = res["compiled"], res["prog"], res["outs"], res["report"].stats
    launches, dispatches = res["launches"], res["dispatches"]
    log(f"[main] {st.num_items} items in {st.batches} batches + 1 warmup dispatch: "
        f"{st.throughput:.2f} items/s, wall {st.wall_seconds:.3f} s, "
        f"host busy {st.host_busy_seconds:.3f} s, device busy {st.device_busy_seconds:.3f} s "
        f"[{card}]")
    log(f"[main] launches {launches}, program dispatches {dispatches}")
    if compiled.coeff is None or "dequant_idct" not in prog.stages or prog.impl != "kernel":
        raise AssertionError(f"plan is not the coefficient program on the kernels: {prog.stages}")
    if compiled.plan.fmt != full:
        raise AssertionError(f"accuracy floor should select {full.key}, got {compiled.plan.fmt.key}")
    if st.batches != -(-N_ITEMS // BATCH) or dispatches != st.batches + 1:
        raise AssertionError(f"expected {-(-N_ITEMS // BATCH)} batches + warmup, "
                             f"got {st.batches} / {dispatches}")
    if launches != {"idct": 2 * dispatches, "fused_preproc": dispatches}:
        raise AssertionError(f"launch counts {launches} != 2 / 1 per dispatch ({dispatches})")
    if len(outs) != N_ITEMS or any(o is None or o.shape != (1000,) for o in outs):
        raise AssertionError("expected one (1000,) output per item")
    if not all(np.isfinite(o).all() for o in outs):
        raise AssertionError("non-finite logits")
    cpu_logits, card_logits = res["cpu_logits"], np.stack(outs[:BATCH])
    diff = float(np.abs(card_logits - cpu_logits).max())
    scale = float(np.abs(cpu_logits).max())
    same_argmax = bool((card_logits.argmax(1) == cpu_logits.argmax(1)).all())
    log(f"[main] first batch, card vs CPU: max|dlogit| {diff:.4e}, max|logit| {scale:.4e} "
        f"(tolerance {LOGIT_RTOL} x max|logit|), argmax identical {same_argmax}")
    if not (diff <= LOGIT_RTOL * scale and same_argmax):
        raise AssertionError("card logits differ from the CPU run of the same program")

    for row in rows:
        row["launches"] = launches[row["name"]]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for row in rows
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
