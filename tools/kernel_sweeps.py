#!/usr/bin/env python3
"""Where K4's and K2's time goes on the card, beyond ``chip_smoke.py``.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/kernel_sweeps.py

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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_sweeps: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = C.card_line()
    k4_stages(dev, card)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    k4_plans(dev, card, flush)
    k2_stages(dev, card, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
