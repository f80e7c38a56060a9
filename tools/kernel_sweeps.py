#!/usr/bin/env python3
"""Where K4's, K2's and K1's time goes on the card, beyond ``chip_smoke.py``.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/kernel_sweeps.py [k4] [k2] [k1]   (no argument: all three)

1. K4 stages: builds a copy of ``src/repro_torch/csrc/decode_attention.cu``
   (under ``build/kernel_sweeps/``) with a timestamp (``clock64`` and
   ``%globaltimer``) taken by thread 0 of every block at each stage, runs it
   once at the Gemma3-1B decode shape (4 sequences at 2048..2060 keys of a
   2112-key bf16 cache, 4 query heads over 1 KV head of 256; L2 flushed
   before the launch) for the global and the local (window 512) layer, and
   prints the median cycles of each stage over the blocks (the merge
   stages over the merging blocks only).
2. K4 split plans: the shipped kernel's time (``chip_smoke.median_ms``) at
   the plans ``split_plan`` picks for 1/4, 1/2, 1 and 2 times the card's SM
   count.
3. K2 stage sizes: the shipped kernel's time at the main path's shape for
   other output rows per block and stage sizes, each checked bitwise
   against the plain version.
4. K1 ablations: copies of ``src/repro_torch/csrc/idct.cu`` (under
   ``build/kernel_sweeps/``) with one part of the int16 zigzag kernel taken
   out (the tensor-core products, the output stores, the input loads) or
   changed (the k-step loop unrolled; the a_lo products skipped when a
   warp's low parts are all zero), each timed on packed staged batches:
   phase 3's (64 x 384x512, point 8) and 6C's (16 x 768x1024, point 4),
   and 4 times their rows, whole and per launch (luma, chroma).  The
   variants that compute the same function are held to the plain version.

Every line names the card and its power limit.  It exits non-zero without
a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402

STAGES = ["issue loads", "K landed", "scores", "softmax, V landed", "p V, warp sums",
          "partial written", "arrived (merging block)", "max, weights, sums", "output"]


def stamp(k: int) -> str:
    return ("{ if (threadIdx.x == 0) { unsigned long long t = clock64(), g; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g)); "
            f"a.stamps[(blockIdx.y * gridDim.x + blockIdx.x) * 20 + {2 * k}] = t; "
            f"a.stamps[(blockIdx.y * gridDim.x + blockIdx.x) * 20 + {2 * k + 1}] = g; }} }}")


def stamped_source() -> str:
    """decode_attention.cu with a stamp before each stage and after the last."""
    src = (ROOT / "src/repro_torch/csrc/decode_attention.cu").read_text()
    anchors = [
        ("  float scale;\n};", "  float scale;\n  unsigned long long* stamps;\n};"),
        ("  __shared__ int s_last;\n", "  __shared__ int s_last;\n" + stamp(0) + "\n"),
        ("  const long long n_part", stamp(1) + "\n  const long long n_part"),
        ("    hopper::mbar_wait(bar_k, 0);\n", "    hopper::mbar_wait(bar_k, 0);\n" + stamp(2) + "\n"),
        ("    // 3. softmax over the chunk", stamp(3) + "\n    // 3. softmax over the chunk"),
        ("    hopper::mbar_wait(bar_v, 0);\n    __syncthreads();\n",
         "    hopper::mbar_wait(bar_v, 0);\n    __syncthreads();\n" + stamp(4) + "\n"),
        ("    for (int i = threadIdx.x; i < G * D; i += kThreads) {\n      float s = 0.0f;",
         stamp(5) + "\n    for (int i = threadIdx.x; i < G * D; i += kThreads) {\n      float s = 0.0f;"),
        ("  // 5. the last block of this", stamp(6) + "\n  // 5. the last block of this"),
        ("  if (!s_last) return;\n", "  if (!s_last) return;\n" + stamp(7) + "\n"),
        ("  TQ* out = static_cast<TQ*>(a.out)", stamp(8) + "\n  TQ* out = static_cast<TQ*>(a.out)"),
        ("      out[g * D + d + 3] = from_f32<TQ>(__fdividef(o[k].w, sum));\n    }\n  }\n}",
         "      out[g * D + d + 3] = from_f32<TQ>(__fdividef(o[k].w, sum));\n    }\n  }\n" + stamp(9) + "\n}"),
        ("                                      void* stream) {",
         "                                      void* stream, void* stamps) {"),
        ("window, scale};", "window, scale, static_cast<unsigned long long*>(stamps)};"),
    ]
    for old, new in anchors:
        if src.count(old) != 1:
            raise RuntimeError(f"decode_attention.cu changed: anchor {old[:50]!r} not found once")
        src = src.replace(old, new)
    return src


def k4_stages(dev, card: str) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da

    out_dir = ROOT / "build" / "kernel_sweeps"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "decode_stamped.cu").write_text(stamped_source())
    lib_path = out_dir / "libdecode_stamped.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                    "-o", str(lib_path), str(out_dir / "decode_stamped.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.repro_decode_attention.argtypes = [I, I, P, L, L, P, L, L, L, P, L, L, L, P, P, P, P,
                                           I, I, I, I, I, I, I, F, I, P, P]
    lib.repro_decode_attention.restype = I
    rng = np.random.default_rng(C.SEED + 5)
    b, s, h, d = C.PREFILL_B, C.DECODE_MAX_LEN, 4, 256
    q = C._randn(rng, (b, h, d), torch.bfloat16, dev)
    kc, vc = (C._randn(rng, (b, s, 1, d), torch.bfloat16, dev) for _ in range(2))
    lens = torch.tensor([2048, 2052, 2056, 2060], dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    counters = torch.zeros(b, dtype=torch.int32, device=dev)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for window in (None, C.GEMMA_WINDOW):
        chunk, n_split = da.split_plan(b, s, window, d, 2, n_sm)
        part = torch.empty(b * n_split * h * (2 + d), device=dev)
        stamps = torch.zeros(b * n_split * 20, dtype=torch.int64, device=dev)
        for _ in range(2):  # the second launch is the one read
            stamps.zero_()
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            status = lib.repro_decode_attention(
                1, 1, q.data_ptr(), q.stride(0), q.stride(1), kc.data_ptr(), *kc.stride()[:3],
                vc.data_ptr(), *vc.stride()[:3], lens.data_ptr(), out.data_ptr(),
                part.data_ptr(), counters.data_ptr(), b, s, 1, h, d, chunk, n_split, d**-0.5,
                -1 if window is None else window, torch.cuda.current_stream(dev).cuda_stream,
                stamps.data_ptr())
            if status:
                raise RuntimeError(f"stamped K4 failed to launch: {status}")
            torch.cuda.synchronize()
        t = stamps.view(-1, 10, 2).cpu().numpy().astype(np.float64)
        clk, ns = t[:, :, 0], t[:, :, 1]
        merging = clk[:, 7] > 0
        t0 = ns[:, 0].min()
        rate = np.median((clk[merging, 9] - clk[merging, 0]) / (ns[merging, 9] - ns[merging, 0]))
        layer = "global" if window is None else f"local (window {window})"
        print(f"K4 stages, {layer} layer, {b * n_split} blocks of {chunk} keys: partials written "
              f"by {np.median(ns[:, 6]) - t0:.0f} ns (median block), last output at "
              f"{ns[merging, 9].max() - t0:.0f} ns after the first block started; SM clock "
              f"{rate:.3f} GHz [{card}]", flush=True)
        working = clk[:, 2] > 0  # blocks with keys (an empty chunk skips stages 1-5)
        for k, name in enumerate(STAGES):
            sel = merging if k >= 6 else working if k >= 1 else np.ones(len(clk), bool)
            print(f"  {name:>24}: {np.median(clk[sel, k + 1] - clk[sel, k]):8.0f} cycles (median)",
                  flush=True)


def k4_plans(dev, card: str, flush) -> None:
    from repro_torch.kernels.decode_attention import ops as da

    rng = np.random.default_rng(C.SEED + 5)
    b, s, h, d = C.PREFILL_B, C.DECODE_MAX_LEN, 4, 256
    q = C._randn(rng, (b, h, d), torch.bfloat16, dev)
    kc, vc = (C._randn(rng, (b, s, 1, d), torch.bfloat16, dev) for _ in range(2))
    lens = torch.tensor([2048, 2052, 2056, 2060], dtype=torch.int32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    shipped = da._sm_count
    try:
        for factor in (0.25, 0.5, 1, 2):
            da._sm_count = lambda index, n=int(n_sm * factor): n
            for window in (None, C.GEMMA_WINDOW):
                ms = C.median_ms(lambda: da.decode_attention_cache(q, kc, vc, lens, window=window), flush)
                chunk, n_split = da.split_plan(b, s, window, d, 2, int(n_sm * factor))
                print(f"K4 plan for {factor} x {n_sm} SMs, window {window}: {n_split} chunks of "
                      f"{chunk} keys x {b}: {ms * 1e3:.2f} us [{card}]", flush=True)
    finally:
        da._sm_count = shipped


def k2_stages(dev, card: str, flush) -> None:
    from repro_torch.core import dag as dag_mod
    from repro_torch.core import device_compiler as DC
    from repro_torch.core.planner import standard_chain
    from repro_torch.kernels.fused_preproc import ops as fp
    from repro_torch.kernels.fused_preproc import plain as fp_plain
    from repro_torch.preprocessing.ops import TensorMeta

    meta = TensorMeta((C.IMG_H, C.IMG_W, 3), "uint8", "HWC")
    low = DC.lower_device_ops(dag_mod.optimize(standard_chain(C.INPUT), meta).ops, meta)
    taps = C._taps(low, dev)
    h, w = low.in_meta.spatial
    planes = C.BATCH * 3
    rng = np.random.default_rng(C.SEED + 1)
    x = torch.from_numpy(rng.uniform(0, 255, size=(planes, h, w)).astype(np.float32)).to(dev)
    scale, bias = torch.ones(planes, device=dev), torch.zeros(planes, device=dev)
    want = fp_plain.resize_affine_planar(x, *taps, scale, bias, True)
    shipped = fp.BAND_ROWS, fp.STAGE_BYTES
    try:
        for rows, kib in ((16, 33), (16, 40), (12, 25), (8, 20), (32, 72)):
            fp.BAND_ROWS, fp.STAGE_BYTES = rows, kib * 1024
            same = torch.equal(fp.resize_affine_planar(x, *taps, scale, bias, True), want)
            ms = C.median_ms(lambda: fp.resize_affine_planar(x, *taps, scale, bias, True), flush)
            print(f"K2 with {rows} output rows a block, a {kib} KiB stage: {ms:.4f} ms, bitwise "
                  f"equal {same} [{card}]", flush=True)
    finally:
        fp.BAND_ROWS, fp.STAGE_BYTES = shipped


K1_MMA = """        mma_tf32(c, lo, b.hi0, b.hi1);
        mma_tf32(c, hi, b.lo0, b.lo1);
        mma_tf32(c, hi, b.hi0, b.hi1);"""
K1_LO = "        lo[e] = tf32(a[e] - hi[e]);\n      }\n"
K1_STORES = "if (r{} < n) *reinterpret_cast<float2*>"
K1_PREFETCH = ("      load_tile_async<T, K>(buf + ((it + 1) & 1) * L::kValues, x, view, "
               "(tile + stride) * kTileRows, n, lane);")
K1_UNROLL = "#pragma unroll 1  // unrolled, the k-steps' fragments outgrow the registers"
K1_VOTE = ("      const bool any_lo = __any_sync(0xffffffffu, lo[0] != 0.0f || lo[1] != 0.0f || "
           "lo[2] != 0.0f || lo[3] != 0.0f);\n")
# name: (source edits, whether the variant still computes K1's function)
K1_VARIANTS = {
    "shipped": ((), True),
    "no tensor-core products": (((K1_MMA, "        c[0] = hi[0] * b.hi0; c[1] = hi[1] * b.hi1; "
                                          "c[2] = lo[2] * b.lo0; c[3] = lo[3] * b.lo1;"),), False),
    "no output stores": (((K1_STORES.format(0), K1_STORES.format(0).replace("< n", "< -n")),
                          (K1_STORES.format(1), K1_STORES.format(1).replace("< n", "< -n"))), False),
    "no input loads": (((K1_PREFETCH, "      hopper::cp_async_commit();"),), False),
    "k-steps unrolled": (((K1_UNROLL, "#pragma unroll"),), True),
    "a_lo products skipped when zero": (((K1_LO, K1_LO + K1_VOTE),
                                         ("        mma_tf32(c, lo, b.hi0, b.hi1);",
                                          "        if (any_lo) mma_tf32(c, lo, b.hi0, b.hi1);")), True),
}


def k1_ablations(dev, card: str, flush) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.idct import ops as idct
    from repro_torch.kernels.idct import plain as idct_plain

    src = (_build.CSRC / "idct.cu").read_text()
    nvcc, out_dir = _build.find_nvcc(), ROOT / "build" / "kernel_sweeps"
    procs = {}
    for i, (name, (edits, _)) in enumerate(K1_VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"idct.cu changed: anchor {old[:50]!r} not found once")
            text = text.replace(old, new)
        cu = out_dir / f"idct_v{i}.cu"
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(text)
        procs[name] = (out_dir / f"libidct_v{i}.so", subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
             str(out_dir / f"libidct_v{i}.so"), str(cu), str(_build.CSRC / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"K1 variant {name!r} failed to build:\n{log[-2000:]}")
        lib = ctypes.CDLL(str(path))
        lib.repro_idct_rows.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 10 + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        libs[name] = lib

    def launch(lib, v, m):
        sizes, strides = idct.row_view(v)
        point = int(round(m.shape[1] ** 0.5))
        out = torch.empty((int(np.prod(sizes)), m.shape[1]), device=dev)
        status = lib.repro_idct_rows(v.data_ptr(), 1, *sizes, *strides, idct.K_ROWS["zigzag", point],
                                     m.data_ptr(), out.data_ptr(), m.shape[1],
                                     torch.cuda.current_stream(dev).cuda_stream)
        if status:
            raise RuntimeError(f"K1 variant failed to launch: {status}")
        return out

    rng = np.random.default_rng(C.SEED)
    for (n, n_br, n_bc, sub), point in ((C.PHASE3_GRID, 8), (C.SCALED_GRID, 4)):
        for scale in (1, 4):
            views = C.staged_batch(rng, n * scale, n_br, n_bc, sub, "packed", dev)
            ms_ = [torch.from_numpy(idct.zigzag_matrix(q, point)).to(dev) for q in C._qtables()]
            pairs = list(zip(views, ms_))
            want = [idct_plain.idct_zigzag_rows(v, m) for v, m in pairs]
            rows = sum(v.numel() // 64 for v in views)
            for name, lib in libs.items():
                same = K1_VARIANTS[name][1]
                err = max((launch(lib, v, m) - w).abs().max().item() for (v, m), w in zip(pairs, want))
                both = C.median_ms(lambda: [launch(lib, v, m) for v, m in pairs], flush)
                alone = [C.median_ms(lambda: launch(lib, v, m), flush) for v, m in pairs]
                check = f", max|variant-plain| {err:.3e}" if same else ""
                print(f"K1 {name}, point {point}, {n * scale} images ({rows} rows): {both:.4f} ms "
                      f"(luma alone {alone[0]:.4f}, chroma alone {alone[1]:.4f}){check} [{card}]",
                      flush=True)
                if same and not err <= C.K1_ATOL:
                    raise AssertionError(f"K1 variant {name!r} disagrees with the plain version: {err}")
            del views, pairs, want


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_sweeps: no CUDA device", file=sys.stderr)
        return 2
    parts = set(sys.argv[1:]) or {"k4", "k2", "k1"}
    dev = torch.device("cuda")
    card = C.card_line()
    if "k4" in parts:
        k4_stages(dev, card)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    if "k4" in parts:
        k4_plans(dev, card, flush)
    if "k2" in parts:
        k2_stages(dev, card, flush)
    if "k1" in parts:
        k1_ablations(dev, card, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
