#!/usr/bin/env python3
"""Where K4's, K2's, K1's, K3's and K6's (and their backwards') time goes on the card, beyond ``chip_smoke.py``.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/kernel_sweeps.py [k4] [k2] [k1] [k3 [PARENT]] [k6 [PARENT]] [k3bwd [PARENT]]
                                   [k6bwd [PARENT]]
    (no argument: k4, k2, k1)

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
5. K3 (``k3``): first the overlapped loop's steps, from a copy of
   ``src/repro_torch/csrc/flash_attention.cu`` (under
   ``build/kernel_sweeps/``) with a ``clock64`` stamp by thread 0 of each
   consumer warpgroup at each step (wait for the K/V tile, issue S(t) and
   P V(t - 1), wait for S(t), softmax, wait for P V(t - 1), rescale O and
   split P): median cycles per step at OLMoE's and DeepSeek-V2's shapes,
   with the SM clock from ``%globaltimer``, for the shipped kernel and with
   the products taken out (the raw stamps of the shipped one go to
   ``build/kernel_sweeps/k3_stamps_*.npz``).  Then the design steps and ablations:
   copies with the ring depth or the schedule changed (one product in
   flight; 2, 3 or 4 stages; (256, 256) overlapped too) or one part taken
   out (the P_lo V products, all P V, S, the softmax, every product, the
   K/V loads), each under several tile orders (one group of every head;
   head-major; groups whose K/V fit 8 or 16 MiB), at each bf16 instance's
   path shape: Gemma3-1B's global and local layer (4 x 2048, 4 heads over 1
   of 256), OLMoE's (4 x 1024, 16 heads of 128) and DeepSeek-V2's (4 x 1024,
   128 heads, q/k 192, v 128), beside SDPA (``is_causal``; the local layer
   with its mask); the variants that compute K3's function are held to the
   plain version at ``chip_smoke``'s bf16 bound.  With ``PARENT``, a
   directory holding another checkout (``git archive <commit> | tar -x -C
   build/parent``), the shipped kernels of that checkout and this one are
   then timed at the same shapes in turns (other, this, this, other; one
   process each, each building its own kernels).
6. K6 (``k6``): copies of ``src/repro_torch/csrc/selective_scan.cu``
   (under ``build/kernel_sweeps/``) with the design changed (2 or 8 states
   a thread, 2 channels a thread, 64-step chunks, 8 warps a block; y's
   lane sum in order, as before the backward's tree of halves; the
   per-pass test for h_chunks taken out, which serving never writes) or one
   stage taken out (the exps, the staging copies, the sum over states,
   the whole epilogue), each timed gated at hymba-1.5b's prefill layer (4 x
   2048, 3200 channels x 16 states, bf16) and at a decode step's (S = 1,
   with h0), with its registers and spills; the variants that compute K6's
   function are held to the plain version (``chip_smoke``'s ``SCAN_RTOL``
   on y and h_last).  The shipped kernel is also timed with ``z=None``.
   With ``PARENT`` (a checkout unpacked as for ``k3``), that checkout's K6
   and this one's are then timed in turns (other, this, this, other): the
   kernel alone, and the scan section of a Mamba layer — from the x_proj
   output to the gated rows, which an older K6 leaves to eager ops (split,
   cast, softplus, -exp(a_log), y.to(bf16) * silu(z)) — then hymba-1.5b's
   prefill of 4 x 2048 and a decode graph replay, each with its device
   kernels (profiler).  Before the design steps, the shipped kernel's
   chunk phases from ``clock64`` stamps by lane 0 of each warp (unpack,
   walk, barrier waits, the gated epilogue) and the SM clock.

7. K3's backward (``k3bwd``): at Gemma3-1B's global and local training
   layers (4 x 1024, 4 heads over 1 of 256, window 512 on the local one)
   and DeepSeek-V2's MLA layer (4 x 1024, 128 heads, q/k 192, v 128), all
   causal and bf16, the shipped backward call beside SDPA's backward
   (``chip_smoke._bwd_layer_ms``) and each of its kernels' device time per
   launch (profiler: the dQ kernel, the dK/dV kernel, the GQA group sum).
   With ``PARENT`` (a checkout unpacked as for ``k3``), that checkout's
   backward and this one's are then timed at the same shapes in turns
   (other, this, this, other; one process each, each building its own
   kernels; a checkout without the (192, 128) instance says so), then
   ``chip_smoke.run_training_path`` (phase 4E: Gemma3-1B trained at full
   size, its step ms, tokens/s and device time by kernel family) on each
   checkout's package in turns the same way.

8. K6's backward (``k6bwd``): at hymba-1.5b's training layer (4 x 1024,
   3200 channels x 16 states, bf16, gated), for each checkout (PARENT
   first, when given) a copy of its ``csrc`` built whole with
   ``clock64`` stamps by lane 0 of each warp of 8 blocks at the top of
   each chunk and before the chunk loop's ``// 1.`` .. ``// 5.`` phases:
   the median cycles of each phase (rows barrier, unpack, forward walk,
   y/dz or dC, back walk, the sums over channels and the rows), the SM
   clock, blocks an SM from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
   and the shared memory a block, and how the launch's blocks land on
   the SMs (``%smid``); then this checkout's design steps and ablations
   (copies of ``selective_scan_bwd.cu``: 4 or 1 warps a block, other
   cluster sizes, none, odd clusters started late; the cluster sums, the
   dz/dx rows, the unpack's gates or the passes over the channels taken
   out), each built with its registers and spills (ptxas), held to the
   plain backward where it computes the function, timed with its
   residency; then each checkout's shipped backward (each kernel per
   launch, profiler) and K6's forward rows (prefill layer, decode step,
   the training layer with and without h_chunks) in turns (other, this,
   this, other), a process each.

Every line names the card and its power limit.  It exits non-zero without
a card.
"""

from __future__ import annotations

import ctypes
import re
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
    lib.repro_decode_attention.argtypes = [I, I, P, L, L, P, L, L, L, P, L, L, L, P, P, P, P, P,
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
                vc.data_ptr(), *vc.stride()[:3], lens.data_ptr(), out.data_ptr(), None,
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
    shipped = da._build.sm_count
    try:
        for factor in (0.25, 0.5, 1, 2):
            da._build.sm_count = lambda device, n=int(n_sm * factor): n
            for window in (None, C.GEMMA_WINDOW):
                ms = C.median_ms(lambda: da.decode_attention_cache(q, kc, vc, lens, window=window), flush)
                chunk, n_split = da.split_plan(b, s, window, d, 2, int(n_sm * factor))
                print(f"K4 plan for {factor} x {n_sm} SMs, window {window}: {n_split} chunks of "
                      f"{chunk} keys x {b}: {ms * 1e3:.2f} us [{card}]", flush=True)
    finally:
        da._build.sm_count = shipped


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


# K3: each bf16 instance at its path shape: label, B, S, H, KVH, q/k width, v width, window
K3_SHAPES = (("Gemma3-1B global", 4, 2048, 4, 1, 256, 256, None),
             ("Gemma3-1B local", 4, 2048, 4, 1, 256, 256, 512),
             ("OLMoE", 4, 1024, 16, 16, 128, 128, None),
             ("DeepSeek-V2", 4, 1024, 128, 128, 192, 128, None))
K3_STAGES = "constexpr int kMaxStages = 3;"
K3_OVERLAP = "static constexpr bool kOverlap = DV <= 128;"
K3_LO = """#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<DV>(o, plo[kk], hopper::desc_b128(va + kk * 16 * kRowBytes, kTcBK * kRowBytes, 1024));
"""
K3_PV = "                                         const uint32_t (&plo)[4][4], uint32_t va) {\n"
K3_QK = "__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t qa, uint32_t ka) {\n"
K3_SOFTMAX = "                                             int window, float scale_log2) {\n"
K3_NO_LOADS = (("          hopper::mbar_arrive_expect_tx(full, L::kKTile + L::kVTile);\n",
                "          hopper::mbar_arrive(full);\n          continue;\n"),)
K3_NO_PRODUCTS = ((K3_PV, K3_PV + "  return;\n"), (K3_QK, K3_QK + "  return;\n"))
K3_NO_SOFTMAX = ((K3_SOFTMAX, K3_SOFTMAX + "  corr0 = corr1 = 1.0f;\n  return;\n"),)
K3_SERIAL = (K3_OVERLAP, "static constexpr bool kOverlap = false;")


def _stages(n: int) -> tuple:
    return (K3_STAGES, f"constexpr int kMaxStages = {n};")


# name: (source edits, whether the variant still computes K3's function):
# the design steps, the shipped kernel, then ablations that take one part
# of the shipped kernel out (their outputs are not K3's)
K3_VARIANTS = {
    "one product in flight, 2 stages": ((_stages(2), K3_SERIAL), True),
    "one product in flight, 3 stages": ((K3_SERIAL,), True),
    "shipped": ((), True),
    "shipped at 2 stages": ((_stages(2),), True),
    "shipped at 4 stages": ((_stages(4),), True),
    "(256, 256) overlapped too": (((K3_OVERLAP, "static constexpr bool kOverlap = true;"),), True),
    "no P_lo V products": (((K3_LO, ""),), False),
    "no P V products": (((K3_PV, K3_PV + "  return;\n"),), False),
    "no S = Q K^T products": (((K3_QK, K3_QK + "  return;\n"),), False),
    "no softmax": (K3_NO_SOFTMAX, False),
    "no products": (K3_NO_PRODUCTS, False),
    "K/V loads and barriers only": (K3_NO_PRODUCTS + K3_NO_SOFTMAX, False),
    "no K/V loads": (K3_NO_LOADS, False),
    "no K/V loads, no products": (K3_NO_LOADS + K3_NO_PRODUCTS, False),
}
# tile orders: K/V bytes a group of heads may hold (ops.KV_L2_BYTES); the
# ablations run at the shipped one only
K3_ORDERS = (("one group of all heads", 1 << 60), ("head-major", 0), ("8 MiB groups", 8 << 20),
             ("16 MiB groups", 16 << 20))


def ptxas_summary(log: str, key: str = "flash_attention_tc_kernel") -> str:
    """Registers and spills of each instance of kernel ``key`` in a ptxas
    report, and any line where ptxas serialises its ``wgmma``s."""
    parts, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name[name.index(key) + len(key):][:14] if key in name else None
        elif entry and ("registers" in line or "spill stores" in line):
            parts.append(f"{entry} {line.split(':', 1)[-1].strip()}")
        if "wgmma" in line and key in line:
            parts.append(line.strip())
    return " | ".join(parts)


K3_STAMP_BLOCKS, K3_STAMP_TILES = 160, 256  # blocks (one per SM), loop iterations of a warpgroup
K3_STAGE_NAMES = ("wait for the K/V tile", "issue S(t), P V(t - 1)", "wait for S(t)", "softmax",
                  "wait for P V(t - 1)", "rescale O, split P")


def k3_stamped_source(edits=()) -> str:
    """flash_attention.cu with ``edits`` made (a K3_VARIANTS entry's), a
    clock64 stamp, by thread 0 of each consumer warpgroup, at each step of
    the overlapped schedule's loop (blocks below K3_STAMP_BLOCKS, a
    warpgroup's first K3_STAMP_TILES iterations), and a C function that
    copies the stamps out (clear: zero them instead)."""
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"flash_attention.cu changed: anchor {old[:50]!r} not found once")
        src = src.replace(old, new)
    head = '#include "hopper.cuh"\n'
    counter = "    Ring ring;\n    for (int r = 0;; ++r) {\n"
    for anchor in (head, counter):
        if src.count(anchor) != 1:
            raise RuntimeError(f"flash_attention.cu changed: anchor {anchor[:50]!r} not found once")
    src = src.replace(counter, "    int k3_it = 0;\n" + counter)

    def stamp(k: int) -> str:
        slot = f"k3_stamps[((blockIdx.x * 2 + wg) * {K3_STAMP_TILES} + k3_it) * 10 + {{}}]"
        timer = ""
        if k in (0, 6):  # and the global timer (ns), for the SM clock rate
            timer = (f" unsigned long long g; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g)); "
                     f"{slot.format(8 + k // 6)} = g;")
        step = " ++k3_it;" if k == 6 else ""
        return (f"            if ((threadIdx.x & 127) == 0 && blockIdx.x < {K3_STAMP_BLOCKS} && "
                f"k3_it < {K3_STAMP_TILES}) {{ {slot.format(k)} = clock64();{timer}{step} }}\n")

    full = "            hopper::mbar_wait(bar_full + 8 * ring.stage, ring.phase);\n"
    fence = "            fence_softmax(s, rs, corr0, corr1);\n"
    wait0 = "            hopper::wgmma_wait<0>();\n"
    edits = [  # each once in the overlapped schedule's loop
        ("          for (++t; t < w_end; ++t) {\n",
         "          for (++t; t < w_end; ++t) {\n" + stamp(0)),
        (full + "            hopper::fence_regs(s);\n", full + stamp(1) + "            hopper::fence_regs(s);\n"),
        ("            hopper::wgmma_commit();\n            hopper::wgmma_wait<1>();",
         "            hopper::wgmma_commit();\n" + stamp(2) + "            hopper::wgmma_wait<1>();"),
        ("            hopper::wgmma_wait<1>();  // S(t) is done; P V(t - 1) may still run\n",
         "            hopper::wgmma_wait<1>();  // S(t) is done; P V(t - 1) may still run\n" + stamp(3)),
        (fence + wait0, fence + stamp(4) + wait0 + stamp(5)),
        ("            split_p(s, phi, plo);\n            pv_stage = ring.stage;\n",
         "            split_p(s, phi, plo);\n" + stamp(6) + "            pv_stage = ring.stage;\n"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"flash_attention.cu changed: anchor {old[:50]!r} not found once")
        src = src.replace(old, new)
    n = K3_STAMP_BLOCKS * 2 * K3_STAMP_TILES * 10
    return src.replace(head, head + f"""
__device__ unsigned long long k3_stamps[{n}];
extern "C" int repro_k3_stamps(void* dst, int clear) {{
  static unsigned long long zeros[{n}];
  return static_cast<int>(clear ? cudaMemcpyToSymbol(k3_stamps, zeros, sizeof(zeros))
                                : cudaMemcpyFromSymbol(dst, k3_stamps, sizeof(zeros)));
}}
""")


# the shipped kernel's loop, and the same with one part taken out
K3_STAMPED = ("shipped", "no products")


def k3_stages(dev, card: str, flush) -> None:
    """Median cycles of each step of the overlapped loop, per warpgroup and
    tile, at OLMoE's and DeepSeek-V2's shapes (the second launch is read),
    for the shipped kernel and the K3_STAMPED ablations."""
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "kernel_sweeps"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.find_nvcc(), {}
    for i, name in enumerate(K3_STAMPED):
        cu, lib_path = out_dir / f"flash_stamped{i}.cu", out_dir / f"libflash_stamped{i}.so"
        cu.write_text(k3_stamped_source(K3_VARIANTS[name][0]))
        procs[name] = (lib_path, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(lib_path), str(cu),
             str(_build.CSRC / "errors.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib_path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"stamped K3 {name!r} failed to build:\n{log[-3000:]}")
        k3_stage_profile(dev, card, flush, k3_variant_lib(lib_path), name)


def k3_variant_lib(path: Path) -> ctypes.CDLL:
    """A copy of the kernel library built from edited sources, declared as
    the shipped one (its flash-attention entry and error text)."""
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(path))
    lib.repro_flash_attention.argtypes = _build.load_library().repro_flash_attention.argtypes
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def k3_stage_profile(dev, card: str, flush, lib, name: str) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa

    lib.repro_k3_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.repro_k3_stamps.restype = ctypes.c_int
    load = _build.load_library
    stamps = np.zeros(K3_STAMP_BLOCKS * 2 * K3_STAMP_TILES * 10, np.uint64)
    try:
        _build.load_library = lambda: lib
        for shape in K3_SHAPES[2:]:
            label, b, s, h, kvh, dqk, dv, window = shape
            q, k, v = k3_inputs(dev, shape)
            for _ in range(2):  # the second launch is read
                if lib.repro_k3_stamps(None, 1):
                    raise RuntimeError("stamps could not be cleared")
                flush.zero_()
                torch.cuda._sleep(2_000_000)
                fa.flash_attention_bshd(q, k, v, window=window, scale=dqk**-0.5)
                torch.cuda.synchronize()
            if lib.repro_k3_stamps(stamps.ctypes.data, 0):
                raise RuntimeError("stamps could not be read")
            if name == K3_STAMPED[0]:  # the raw stamps, for timelines of the two warpgroups
                np.savez_compressed(ROOT / "build" / "kernel_sweeps" / f"k3_stamps_{label.split()[0]}.npz",
                                    stamps=stamps)
            rec = stamps.reshape(-1, K3_STAMP_TILES, 10).astype(np.float64)  # (block, warpgroup), tile, slot
            t, ns = rec[..., :7], rec[..., 8:]
            full = (t > 0).all(axis=2)
            d = np.diff(t, axis=2)[full]
            period = (t[:, 1:, 0] - t[:, :-1, 0])[full[:, 1:] & full[:, :-1]]
            span = ns[..., 1][full] - ns[..., 0][full]
            ghz = np.median((t[..., 6][full] - t[..., 0][full])[span > 0] / span[span > 0])
            print(f"K3 loop steps, {name}, {label} ({b}x{s}, {h} heads, q/k {dqk} v {dv}): {len(d)} "
                  f"iterations of a warpgroup, median {np.median(period):.0f} cycles from one to the next, "
                  f"SM clock {ghz:.3f} GHz [{card}]", flush=True)
            for step, col in zip(K3_STAGE_NAMES, d.T):
                print(f"  {step:>22}: median {np.median(col):6.0f}, mean {col.mean():7.1f} cycles", flush=True)
            del q, k, v
    finally:
        _build.load_library = load


def k3_inputs(dev, shape):
    """q, k, v at a K3 shape, v a view of a wider (k_nope | v) product where
    it is narrower than q/k, as DeepSeek-V2 passes it."""
    _, b, s, h, kvh, dqk, dv, _ = shape
    rng = np.random.default_rng(C.SEED + 9)
    q, k = (C._randn(rng, (b, s, n, dqk), torch.bfloat16, dev) for n in (h, kvh))
    if dv == dqk:
        return q, k, C._randn(rng, (b, s, kvh, dv), torch.bfloat16, dev)
    return q, k, C._randn(rng, (b, s, kvh, 128 + dv), torch.bfloat16, dev)[..., 128:]


def k3_sdpa_ms(q, k, v, window, scale, flush) -> float:
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window is None:
        return C.median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale,
                                                                  enable_gqa=True), flush)
    pos = torch.arange(q.shape[1], device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    return C.median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale,
                                                              enable_gqa=True), flush)


def k3_design_steps(dev, card: str, flush) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import plain as fa_plain

    src = (_build.CSRC / "flash_attention.cu").read_text()
    nvcc, out_dir = _build.find_nvcc(), ROOT / "build" / "kernel_sweeps"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (edits, _)) in enumerate(K3_VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"flash_attention.cu changed: anchor {old[:50]!r} not found once")
            text = text.replace(old, new)
        cu = out_dir / f"flash_v{i}.cu"
        cu.write_text(text)
        procs[name] = (out_dir / f"libflash_v{i}.so", subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
             str(out_dir / f"libflash_v{i}.so"), str(cu), str(_build.CSRC / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"K3 variant {name!r} failed to build:\n{log[-3000:]}")
        print(f"K3 variant {name!r}, ptxas per bf16 instance: {ptxas_summary(log)} [{card}]", flush=True)
        libs[name] = k3_variant_lib(path)

    load, budget = _build.load_library, fa.KV_L2_BYTES
    try:
        for shape in K3_SHAPES:
            label, b, s, h, kvh, dqk, dv, window = shape
            q, k, v = k3_inputs(dev, shape)
            scale = dqk**-0.5
            want = fa_plain.flash_attention_bshd(q, k, v, window=window, scale=scale)
            sdpa = k3_sdpa_ms(q, k, v, window, scale, flush)
            print(f"K3 {label} ({b}x{s}, {h} heads over {kvh}, q/k {dqk} v {dv}, window {window}): "
                  f"SDPA {sdpa:.4f} ms [{card}]", flush=True)
            for name, lib in libs.items():
                _build.load_library = lambda lib=lib: lib
                same = K3_VARIANTS[name][1]
                for order, kv_bytes in K3_ORDERS if same else (("shipped order", budget),):
                    fa.KV_L2_BYTES = kv_bytes
                    got = fa.flash_attention_bshd(q, k, v, window=window, scale=scale)
                    err, inside, tol = C._attn_bound(got, want, torch.bfloat16)
                    ms = C.median_ms(lambda: fa.flash_attention_bshd(q, k, v, window=window, scale=scale),
                                     flush)
                    check = f", max|kernel-plain| {err:.3e} (inside {tol}: {inside})" if same else ""
                    print(f"  {name}, {order} ({fa.tile_group(b, h, kvh, s, dqk, dv)} heads a group): "
                          f"{ms:.4f} ms, {sdpa / ms:.2f}x SDPA{check} [{card}]", flush=True)
                    if same and not inside:
                        raise AssertionError(f"K3 variant {name!r} disagrees with the plain version")
            del q, k, v, want
    finally:
        _build.load_library, fa.KV_L2_BYTES = load, budget


def k3_shipped(tree: Path, label: str) -> None:
    """One checkout's shipped K3 at each shape (run in a process of its own)."""
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa

    dev, card = torch.device("cuda"), C.card_line()
    _build.load_library()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    for shape in K3_SHAPES:
        name, b, s, h, kvh, dqk, dv, window = shape
        q, k, v = k3_inputs(dev, shape)
        scale = dqk**-0.5
        ms = C.median_ms(lambda: fa.flash_attention_bshd(q, k, v, window=window, scale=scale), flush)
        sdpa = k3_sdpa_ms(q, k, v, window, scale, flush)
        print(f"[{label}] K3 {name}: kernel {ms:.4f} ms, SDPA {sdpa:.4f} ms ({tree}) [{card}]", flush=True)
        del q, k, v


def k3_ab(parent: Path) -> int:
    for tree, label in ((parent, "other"), (ROOT, "this"), (ROOT, "this"), (parent, "other")):
        proc = subprocess.run([sys.executable, __file__, "k3-child", str(tree), label], timeout=600)
        if proc.returncode:
            return proc.returncode
    return 0


# K3's backward: Gemma3-1B's training layers (4 x 1024, 4 heads over 1 of
# 256) and DeepSeek-V2's MLA layer (4 x 1024, 128 heads, q/k 192, v 128):
# label, B, S, H, KVH, DQK, DV, window; all causal, bf16
K3BWD_SHAPES = (("Gemma3-1B global layer", 4, 1024, 4, 1, 256, 256, None),
                ("Gemma3-1B local layer", 4, 1024, 4, 1, 256, 256, 512),
                ("DeepSeek-V2 MLA layer", 4, 1024, 128, 128, 192, 128, None))


def k3bwd_inputs(dev, shape) -> tuple:
    """(q, k, v, out, lse, dO) at a K3 backward shape, seeded."""
    _, b, s, h, kvh, dqk, dv, window = shape
    return C._bwd_inputs(np.random.default_rng(C.SEED + 14), b, s, s, h, kvh, dqk, dv, True, window,
                         torch.bfloat16, dev)


def k3bwd_kernels(dev, card: str, flush) -> None:
    """This checkout's K3 backward at each shape: the call (every kernel of
    it) beside SDPA's backward, and each of its kernels' device time per
    launch (profiler, L2 flushed before each call)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa

    _build.load_library()
    for shape in K3BWD_SHAPES:
        window = shape[-1]
        q, k, v, out, lse, do = k3bwd_inputs(dev, shape)
        mask = None
        if window is not None:
            pos = torch.arange(q.shape[1], device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        ms, _, sdpa, backend = C._bwd_layer_ms(q, k, v, out, lse, do, window, flush, mask)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                flush.zero_()
                fa.flash_attention_bwd_bshd(q, k, v, out, lse, do, window=window)
            torch.cuda.synchronize()
        parts = []
        for e in prof.key_averages():
            name = re.search(r"flash_attention_bwd_\w+", e.key)
            if name and getattr(e, "self_device_time_total", 0) > 0:
                parts.append(f"{name.group(0)} {e.self_device_time_total / 1e3 / e.count:.4f} ms")
        print(f"K3 backward {shape[0]}: {ms:.4f} ms, SDPA backward {sdpa:.4f} ms ({backend}); per launch: "
              f"{', '.join(parts)} [{card}]", flush=True)
        del q, k, v, out, lse, do


def k3bwd_shipped(tree: Path, label: str) -> None:
    """One checkout's K3 backward at each shape (run in a process of its own)."""
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa

    dev, card = torch.device("cuda"), C.card_line()
    _build.load_library()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    for shape in K3BWD_SHAPES:
        window = shape[-1]
        q, k, v, out, lse, do = k3bwd_inputs(dev, shape)
        try:
            ms = C.median_ms(lambda: fa.flash_attention_bwd_bshd(q, k, v, out, lse, do, window=window), flush)
        except NotImplementedError as e:  # a checkout whose backward lacks the instance
            print(f"[{label}] K3 backward {shape[0]}: {e} ({tree}) [{card}]", flush=True)
            continue
        print(f"[{label}] K3 backward {shape[0]}: {ms:.4f} ms ({tree}) [{card}]", flush=True)
        del q, k, v, out, lse, do


def k3bwd_train(tree: Path, label: str) -> None:
    """Phase 4E (``chip_smoke.run_training_path``, Gemma3-1B trained at full
    size) on one checkout's package, in a process of its own: this
    checkout's measuring code either way, so only the package differs."""
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    print(f"[{label}] phase 4E on {tree}", flush=True)
    C.run_training_path(torch.device("cuda"), C.card_line())


def k3bwd_ab(parent: Path) -> int:
    """The two checkouts' backward alone, then their training steps, each
    in turns (other, this, this, other)."""
    for child in ("k3bwd-child", "k3bwd-train-child"):
        for tree, label in ((parent, "other"), (ROOT, "this"), (ROOT, "this"), (parent, "other")):
            proc = subprocess.run([sys.executable, __file__, child, str(tree), label], timeout=600)
            if proc.returncode:
                return proc.returncode
    return 0


# K6: hymba-1.5b's prefill layer and a decode step's: label, B, S, with h0
K6_SHAPES = (("prefill layer", 4, 2048, False), ("decode step", 4, 1, True))
K6_EXP = "            h[m][k] = scan::step(h[m][k], s, a2[m][k], bq[k], x);\n"
K6_UNPACK_BC = "    for (int i = tid; i < kChunk * N / 4; i += kThreads) {\n"
K6_UNPACK_X = ("    for (int i = tid; i < kCh / 2 * (kChunk / 4); i += kThreads) {\n"
               "      const int ch = 2 * (i % (kCh / 2)), t = 4 * (i / (kCh / 2));\n")
K6_WALK = "    const int steps = (len + 3) & ~3;\n"
K6_LOOP = "    for (int t = 0; t < steps; t += 4) {\n"
K6_STAGE = "  auto stage = [&](int c, int buf) {\n"
K6_EPILOGUE = ("    for (int i = tid; i < kCh / 2 * (kChunk / 4); i += kThreads) {\n"
               "      const int t = 4 * (i / (kCh / 2));\n")
K6_SUM = ("      const float4 y0 = scan::lane_sum<Lay::kLanes, float4>(\n"
          "          [&](int ln) { return *reinterpret_cast<const float4*>(s_p + Lay::prow(ln, pair) + t); });\n"
          "      const float4 y1 = scan::lane_sum<Lay::kLanes, float4>(\n")
K6_PARTIAL = "        *reinterpret_cast<float4*>(s_p + Lay::prow(l, m * (kCh / kChans) + g) + t) =\n"
K6_CHUNKS = "  const int chunks = (S + kChunk - 1) / kChunk;\n"
K6_STATES = ("      if (a.h_chunks != nullptr && t % scan::kStateStride == 0) {  "
             "// the state entering steps t0 + t..\n")
# y's sum over lanes in lane order, ((p0 + p1) + p2) + p3 (the forward's
# before its tree of halves)
K6_IN_ORDER = ("namespace {\n", "namespace {\n\ntemplate <int kLanes, typename V, typename Part>\n"
               "__device__ __forceinline__ V in_order_sum(Part part) {\n  using scan::operator+;\n"
               "  V y = part(0);\n#pragma unroll\n  for (int ln = 1; ln < kLanes; ++ln) y = y + part(ln);\n"
               "  return y;\n}\n")
K6_HLAST = "      for (int k = 0; k < kStates; ++k) a.h_last[(static_cast<long long>(b) * D + d) * N + n0 + k] = h[m][k];\n"


# B and C staged as one word per state (C << 16 | B, exact in bf16): half
# the shared-memory words of the walk, two bit operations per state more
K6_PACK_UNPACK = (
    "        const float s = dt[t];\n"
    "        vb = make_float4(s * raw_at<T>(pr, e), s * raw_at<T>(pr, e + 1), s * raw_at<T>(pr, e + 2),\n"
    "                         s * raw_at<T>(pr, e + 3));\n",
    "        const float s = dt[t];\n"
    "        if constexpr (sizeof(T) == 2) {\n"
    "          const uint16_t* p16 = reinterpret_cast<const uint16_t*>(pr);\n"
    "          vb = make_float4(__uint_as_float(uint32_t(p16[e + N]) << 16 | p16[e]),\n"
    "                           __uint_as_float(uint32_t(p16[e + N + 1]) << 16 | p16[e + 1]),\n"
    "                           __uint_as_float(uint32_t(p16[e + N + 2]) << 16 | p16[e + 2]),\n"
    "                           __uint_as_float(uint32_t(p16[e + N + 3]) << 16 | p16[e + 3]));\n"
    "        } else {\n"
    "        vb = make_float4(s * raw_at<T>(pr, e), s * raw_at<T>(pr, e + 1), s * raw_at<T>(pr, e + 2),\n"
    "                         s * raw_at<T>(pr, e + 3));\n"
    "        }\n")
K6_PACK_WALK = (
    "        load_states(cq, s_c + (t + j) * N + n0);\n"
    "        const float s = comp(dt4, j);\n",
    "        const float s = comp(dt4, j);\n"
    "        if constexpr (sizeof(T) == 2) {\n"
    "#pragma unroll\n"
    "          for (int m = 0; m < kChans; ++m) {\n"
    "            const float xd = s * comp(x4[m], j);\n"
    "            float acc = 0.0f;\n"
    "#pragma unroll\n"
    "            for (int k = 0; k < kStates; ++k) {\n"
    "              const uint32_t w = __float_as_uint(bq[k]);\n"
    "              h[m][k] = scan::step(h[m][k], s, a2[m][k], __uint_as_float(w << 16), xd);\n"
    "              acc = fmaf(h[m][k], __uint_as_float(w & 0xffff0000u), acc);\n"
    "            }\n"
    "            p[m][j] = acc;\n"
    "          }\n"
    "          continue;\n"
    "        }\n"
    "        load_states(cq, s_c + (t + j) * N + n0);\n")


K6_SHIPPED = {"kStates": 4, "kChans": 1, "kChunk": 32, "kWarps": 4}  # the kernel's constants


def _k6_const(name: str, value: int) -> tuple:
    return (f"constexpr int {name} = {K6_SHIPPED[name]};", f"constexpr int {name} = {value};")


# name: (source edits, whether the variant still computes K6's function):
# the shipped kernel, design steps, then ablations that take one stage out
K6_VARIANTS = {
    "shipped": ((), True),
    "2 states a thread": ((_k6_const("kStates", 2),), True),
    "8 states a thread": ((_k6_const("kStates", 8),), True),
    "2 channels a thread": ((_k6_const("kChans", 2),), True),
    "64-step chunks": ((_k6_const("kChunk", 64),), True),
    "2 warps a block": ((_k6_const("kWarps", 2),), True),
    "2 channels a thread, 2 warps a block": ((_k6_const("kChans", 2), _k6_const("kWarps", 2)), True),
    "8 warps a block": ((_k6_const("kWarps", 8),), True),
    "B and C packed as bf16 pairs": ((K6_PACK_UNPACK, K6_PACK_WALK), True),
    "y's lane sum in order": ((K6_IN_ORDER, (K6_SUM, K6_SUM.replace("scan::lane_sum", "in_order_sum"))), True),
    "no h_chunks test in the walk": (((K6_STATES, "      if (false) {\n"),), True),
    "walk unrolled to 8 steps": (((K6_LOOP, "#pragma unroll 2\n" + K6_LOOP),), True),
    "no exps": (((K6_EXP, K6_EXP.replace("scan::step(h[m][k], s, a2[m][k], bq[k], x)",
                                         "fmaf(s * a2[m][k], h[m][k], bq[k] * x)")),), False),
    "no walk": (((K6_WALK, K6_WALK.replace("(len + 3) & ~3", "0 * len")),), False),
    "no staging copies": (((K6_STAGE, K6_STAGE + "    if (c >= 0) { hopper::cp_async_commit(); "
                                      "hopper::cp_async_commit(); return; }\n"),), False),
    # the partial sums go to a register that is stored once, so the h C
    # products stay; the epilogue adds none
    "no sum over states": (((K6_PARTIAL, "        if ((sink += p[m][0] + p[m][1] + p[m][2] + p[m][3]) == 1e30f)\n"
                                          "          *reinterpret_cast<float4*>(s_p) =\n"),
                            (K6_SUM, K6_SUM.replace("lane_sum<Lay::kLanes", "lane_sum<0")),
                            (K6_CHUNKS, "  float sink = 0.0f;\n" + K6_CHUNKS),
                            (K6_HLAST, K6_HLAST.replace("= h[m][k];", "= h[m][k] + 0.0f * sink;"))), False),
    "no unpacking": (((K6_UNPACK_BC, K6_UNPACK_BC.replace("i < kChunk * N / 4", "i < 0 * N")),
                      (K6_UNPACK_X, K6_UNPACK_X.replace("i < kCh / 2", "i < 0 * kCh"))), False),
    "no epilogue": (((K6_EPILOGUE, K6_EPILOGUE.replace("i < kCh / 2", "i < 0 * kCh / 2")),), False),
}


def _k6_args(t: dict, with_h0: bool, gated: bool = True) -> tuple:
    return C._scan_args(t, with_h0, gated)


# K6's per-chunk phases, from clock64 stamps by lane 0 of each warp of the
# first 8 blocks of sequence 0 (8 slots a chunk: 5 clocks, 2 %globaltimer)
K6_STAMP_BLOCKS, K6_STAMP_CHUNKS = 8, 64
K6_PHASES = ("unpack (after the chunk's barrier)", "walk", "wait for the walk's barrier",
             "sum, gate, stores (and warp 0's softplus)", "wait for the next chunk's barrier")


def k6_stamped_source() -> str:
    def stamp(k: int) -> str:
        timer = ("unsigned long long g; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g)); "
                 f"g_k6_stamps[i + {5 + (k == 4)}] = g; ") if k in (0, 4) else ""
        return ("    if (lane == 0 && blockIdx.y == 0 && blockIdx.x < %d && c < %d) { "
                "const long long i = ((blockIdx.x * kWarps + warp) * %d + c) * 8; "
                "g_k6_stamps[i + %d] = clock64(); %s}\n" % (K6_STAMP_BLOCKS, K6_STAMP_CHUNKS,
                                                             K6_STAMP_CHUNKS, k, timer))

    src = (ROOT / "src/repro_torch/csrc/selective_scan.cu").read_text()
    anchors = [
        ("namespace {\n", "namespace {\n\n__device__ unsigned long long* g_k6_stamps;\n"),
        ("    __syncthreads();  // chunk c's rows and dt are in; chunk c - 1 is written out\n",
         "    __syncthreads();  // chunk c's rows and dt are in; chunk c - 1 is written out\n" + stamp(0)),
        ("    // 2. walk the chunk", stamp(1) + "    // 2. walk the chunk"),
        ("    hopper::cp_async_wait<1>();  // chunk c + 1", stamp(2) + "    hopper::cp_async_wait<1>();  // chunk c + 1"),
        ("    if (warp == 0 && c + 1 < chunks) softplus_rows", stamp(3) + "    if (warp == 0 && c + 1 < chunks) softplus_rows"),
        ("        }\n      }\n    }\n  }\n#pragma unroll\n  for (int m = 0; m < kChans; ++m) {",
         "        }\n      }\n    }\n" + stamp(4) + "  }\n#pragma unroll\n  for (int m = 0; m < kChans; ++m) {"),
    ]
    for old, new in anchors:
        if src.count(old) != 1:
            raise RuntimeError(f"selective_scan.cu changed: anchor {old[:50]!r} not found once")
        src = src.replace(old, new)
    return src + ("\nextern \"C\" int repro_k6_set_stamps(void* p) {\n"
                  "  return static_cast<int>(cudaMemcpyToSymbol(g_k6_stamps, &p, sizeof(p)));\n}\n")


def k6_stages(dev, card: str, flush) -> None:
    """Median cycles of each phase of a chunk, per warp, at hymba's prefill
    layer (gated; the second launch is read), and the SM clock."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import ops as scan_ops

    out_dir = ROOT / "build" / "kernel_sweeps"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib_path = out_dir / "scan_stamped.cu", out_dir / "libscan_stamped.so"
    cu.write_text(k6_stamped_source())
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
                           str(lib_path), str(cu), str(_build.CSRC / "errors.cu")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"stamped K6 failed to build:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_selective_scan.argtypes = _build.load_library().repro_selective_scan.argtypes
    lib.repro_selective_scan.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_k6_set_stamps.argtypes = [ctypes.c_void_p]
    lib.repro_k6_set_stamps.restype = ctypes.c_int
    warps = int(re.search(r"constexpr int kWarps = (\d+);", cu.read_text()).group(1))
    stamps = torch.zeros(K6_STAMP_BLOCKS * warps * K6_STAMP_CHUNKS * 8, dtype=torch.int64, device=dev)
    if lib.repro_k6_set_stamps(stamps.data_ptr()):
        raise RuntimeError("the stamp buffer could not be set")
    rng = np.random.default_rng(C.SEED + 13)
    label, b, s, with_h0 = K6_SHAPES[0]
    t = C._scan_inputs(rng, b, s, C.HYMBA_D_INNER, C.HYMBA_STATE, torch.bfloat16, dev)
    load = _build.load_library
    try:
        _build.load_library = lambda: lib
        for _ in range(2):  # the second launch is read
            stamps.zero_()
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            scan_ops.selective_scan(*_k6_args(t, with_h0))
            torch.cuda.synchronize()
    finally:
        _build.load_library = load
    rec = stamps.cpu().numpy().reshape(-1, K6_STAMP_CHUNKS, 8).astype(np.float64)  # warp, chunk, slot
    clocks, ns = rec[..., :5], rec[..., 5:7]
    steady = clocks[:, 1:-1]  # chunks 1..62: the first one waits for its copies, the last stages nothing
    phases = np.concatenate([np.diff(steady, axis=2), (clocks[:, 2:, 0] - clocks[:, 1:-1, 4])[..., None]], axis=2)
    period = clocks[:, 2:, 0] - clocks[:, 1:-1, 0]
    span = ns[:, :, 1] - ns[:, :, 0]
    ghz = np.median((clocks[:, :, 4] - clocks[:, :, 0])[span > 0] / span[span > 0])
    print(f"K6 chunk phases, {label} ({b}x{s}, {C.HYMBA_D_INNER} channels x {C.HYMBA_STATE} states, bf16, "
          f"gated): {phases.shape[0]} warps x {phases.shape[1]} chunks, median {np.median(period):.0f} cycles "
          f"from one chunk to the next, SM clock {ghz:.3f} GHz [{card}]", flush=True)
    for name, col in zip(K6_PHASES, phases.reshape(-1, 5).T):
        print(f"  {name:>42}: median {np.median(col):6.0f}, mean {col.mean():7.1f} cycles", flush=True)
    del t


def k6_design_steps(dev, card: str, flush) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import plain as scan_plain

    src = (_build.CSRC / "selective_scan.cu").read_text()
    nvcc, out_dir = _build.find_nvcc(), ROOT / "build" / "kernel_sweeps"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (edits, _)) in enumerate(K6_VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"selective_scan.cu changed: anchor {old[:50]!r} not found once")
            text = text.replace(old, new)
        cu = out_dir / f"scan_v{i}.cu"
        cu.write_text(text)
        procs[name] = (out_dir / f"libscan_v{i}.so", subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
             str(out_dir / f"libscan_v{i}.so"), str(cu), str(_build.CSRC / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"K6 variant {name!r} failed to build:\n{log[-3000:]}")
        print(f"K6 variant {name!r}, ptxas per instance: {ptxas_summary(log, 'selective_scan_kernel')} "
              f"[{card}]", flush=True)
        lib = ctypes.CDLL(str(path))
        lib.repro_selective_scan.argtypes = _build.load_library().repro_selective_scan.argtypes
        lib.repro_selective_scan.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    rng = np.random.default_rng(C.SEED + 13)
    load = _build.load_library
    try:
        for label, b, s, with_h0 in K6_SHAPES:
            t = C._scan_inputs(rng, b, s, C.HYMBA_D_INNER, C.HYMBA_STATE, torch.bfloat16, dev)
            y_want, h_want = scan_plain.selective_scan(*_k6_args(t, with_h0, False))
            print(f"K6 {label} ({b}x{s}, {C.HYMBA_D_INNER} channels x {C.HYMBA_STATE} states, bf16, gated) "
                  f"[{card}]", flush=True)
            for name, lib in libs.items():
                _build.load_library = lambda lib=lib: lib
                same = K6_VARIANTS[name][1]
                ms = C.median_ms(lambda: scan_ops.selective_scan(*_k6_args(t, with_h0)), flush)
                check = ""
                if same:
                    y, h = scan_ops.selective_scan(*_k6_args(t, with_h0, False))
                    errs = [((got - want).abs().max() / want.abs().max()).item()
                            for got, want in ((y, y_want), (h, h_want))]
                    check = f", max|variant-plain| / max|plain| y {errs[0]:.3e}, h_last {errs[1]:.3e}"
                    if not max(errs) <= C.SCAN_RTOL:
                        raise AssertionError(f"K6 variant {name!r} disagrees with the plain version: {errs}")
                print(f"  {name}: {ms:.4f} ms{check} [{card}]", flush=True)
                if name == "shipped":
                    ms = C.median_ms(lambda: scan_ops.selective_scan(*_k6_args(t, with_h0, False)), flush)
                    print(f"  shipped, z=None (y in f32): {ms:.4f} ms [{card}]", flush=True)
            del t, y_want, h_want
    finally:
        _build.load_library = load


def k6_shipped(tree: Path, label: str) -> None:
    """One checkout's shipped K6 at each shape, alone and as the scan section
    of a Mamba layer (run in a process of its own)."""
    import inspect

    sys.path.insert(0, str(tree / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import ops as scan_ops

    dev, card = torch.device("cuda"), C.card_line()
    _build.load_library()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    fused = "proj" in inspect.signature(scan_ops.selective_scan).parameters
    rng = np.random.default_rng(C.SEED + 13)
    for name, b, s, with_h0 in K6_SHAPES:
        t = C._scan_inputs(rng, b, s, C.HYMBA_D_INNER, C.HYMBA_STATE, torch.bfloat16, dev)
        if fused:
            kernel = section = lambda: scan_ops.selective_scan(*_k6_args(t, with_h0))
        else:  # the older API: the prologue and the gate are eager ops around the kernel
            n = C.HYMBA_STATE

            def prologue():
                bmat, cmat, dt_raw = t["proj"].float().split([n, n, 1], dim=-1)
                dt = F.softplus(dt_raw + t["dt_bias"].mean())[..., 0]
                return (t["xc"], dt.contiguous(), bmat.contiguous(), cmat.contiguous(), -torch.exp(t["a_log"]),
                        t["d_skip"], t["h0"] if with_h0 else None)

            args = prologue()
            kernel = lambda: scan_ops.selective_scan(*args)  # noqa: E731

            def section():
                y, h = scan_ops.selective_scan(*prologue())
                return y.to(torch.bfloat16) * F.silu(t["z"]), h

        ms, sec = C.median_ms(kernel, flush), C.median_ms(section, flush)
        print(f"[{label}] K6 {name}: kernel {ms:.4f} ms, scan section {sec:.4f} ms ({tree}) [{card}]", flush=True)
        del t
    del flush
    k6_model(dev, card, label)


def k6_model(dev, card: str, label: str) -> None:
    """hymba-1.5b (full, seeded random weights) on the checkout imported:
    prefill of 4 x 2048 (wall, back to back) and one decode step as a graph
    replay (wall, 20 back to back), each with its device kernels (profiler)."""
    from repro_torch import configs
    from repro_torch.models import decode as D
    from repro_torch.serving import engine as E

    cfg = configs.get_config("hymba-1.5b")
    model, _ = C._build_lm(dev, cfg, cfg.name)
    prompts = torch.from_numpy(np.random.default_rng(C.SEED + 15).integers(
        0, cfg.vocab_size, size=(C.PREFILL_B, C.PREFILL_S))).to(dev)
    prefill = lambda: D.prefill(model, cfg, prompts, max_len=C.DECODE_MAX_LEN)  # noqa: E731
    prefill_ms = C.wall_ms(prefill, iters=5, warmup=1)
    _, busy, rows = C.profile_steps(prefill, n=1)
    logits, cache, lens = prefill()
    graph = E.DecodeGraph(model, cfg, cache)
    tok = logits.argmax(-1)
    replay_ms = C.wall_ms(lambda: graph.run(tok, lens))
    _, replay_busy, replay_rows = C.profile_steps(lambda: graph.run(tok, lens))
    print(f"[{label}] hymba-1.5b prefill 4x2048: {prefill_ms:.1f} ms (wall, 5 back to back), device busy "
          f"{busy:.1f} ms in {sum(e.count for e in rows)} kernels; decode replay {replay_ms:.3f} ms/step (wall, "
          f"20 back to back), device busy {replay_busy:.3f} ms in {sum(e.count for e in replay_rows) / 4:g} "
          f"kernels a step [{card}]", flush=True)


def k6_ab(parent: Path) -> int:
    for tree, label in ((parent, "other"), (ROOT, "this"), (ROOT, "this"), (parent, "other")):
        proc = subprocess.run([sys.executable, __file__, "k6-child", str(tree), label], timeout=600)
        if proc.returncode:
            return proc.returncode
    return 0


# K6's backward at hymba-1.5b's training layer (4 x 1024, 3200 channels x 16
# states, bf16, gated, no h0): per-chunk phases from clock64 stamps by lane 0
# of each warp of the first 8 blocks of sequence 0, 8 slots a chunk (6
# clocks, then %globaltimer at the chunk's start).  Stamp k goes before the
# chunk loop's "// k. " comment (k = 1..5), stamp 0 at the top of the loop,
# so each phase runs up to the next stamp (the last up to the next chunk's
# top); both designs name their phases so.
K6BWD_STAMP_BLOCKS, K6BWD_STAMP_CHUNKS = 8, 64
K6BWD_SM_BLOCKS = 4096  # blocks whose SM is recorded (all of hymba's)
K6BWD_PHASES = ("wait for the chunk's rows (barrier)", "unpack", "forward walk", "y, dz (and dC)", "back walk",
                "dx, dB, d dt (and the sums over channels)")
K6BWD_LOOP = re.compile(r"  for \(int c = chunks - 1[^\n]*\{\n")


def k6bwd_stamped_source(src: str) -> str:
    """selective_scan_bwd.cu (either design) with the phase stamps, a setter
    for the stamp buffer and the hymba instance's occupancy (blocks an SM
    from cudaOccupancyMaxActiveBlocksPerMultiprocessor, threads, dynamic
    shared memory)."""
    def stamp(k: int) -> str:
        timer = ("unsigned long long g_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_)); "
                 "g_k6bwd_stamps[i_ + 6] = g_; ") if k == 0 else ""
        return ("    if (lane == 0 && blockIdx.y == 0 && blockIdx.x < %d && it < %d) { "
                "const long long i_ = ((static_cast<long long>(blockIdx.x) * kWarps + warp) * %d + it) * 8; "
                "g_k6bwd_stamps[i_ + %d] = clock64(); %s}\n" % (K6BWD_STAMP_BLOCKS, K6BWD_STAMP_CHUNKS,
                                                               K6BWD_STAMP_CHUNKS, k, timer))

    if src.count("namespace {\n") != 1 or len(K6BWD_LOOP.findall(src)) != 1:
        raise RuntimeError("selective_scan_bwd.cu changed: its namespace or chunk loop not found once")
    src = src.replace("namespace {\n", "namespace {\n\n__device__ unsigned long long* g_k6bwd_stamps;\n")
    top = K6BWD_LOOP.search(src).end()
    # each block's SM, in the slot after the stamps of its first warp's last chunk
    smid = ("  if (threadIdx.x == 0 && blockIdx.y * gridDim.x + blockIdx.x < %d) { unsigned int s_; "
            "asm volatile(\"mov.u32 %%0, %%%%smid;\" : \"=r\"(s_)); "
            "g_k6bwd_stamps[%d + blockIdx.y * gridDim.x + blockIdx.x] = s_; }\n"
            % (K6BWD_SM_BLOCKS, K6BWD_STAMP_BLOCKS * 4 * K6BWD_STAMP_CHUNKS * 8))
    src = src[:top] + stamp(0) + src[top:]
    first = src.index("  for (int c = chunks - 1")
    src = src[:first] + smid + src[first:]
    for k in range(1, 6):
        anchor = f"\n    // {k}. "
        if src.count(anchor) != 1:
            raise RuntimeError(f"selective_scan_bwd.cu changed: phase anchor {anchor!r} not found once")
        src = src.replace(anchor, "\n" + stamp(k) + anchor[1:])
    return src + (
        "\nextern \"C\" int repro_k6bwd_set_stamps(void* p) {\n"
        "  return static_cast<int>(cudaMemcpyToSymbol(g_k6bwd_stamps, &p, sizeof(p)));\n}\n"
        "extern \"C\" int repro_k6bwd_occupancy(int* out) {\n"
        "  using Lay = Layout<16, __nv_bfloat16>;\n"
        "  auto* k = selective_scan_bwd_kernel<16, __nv_bfloat16>;\n"
        "  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);\n"
        "  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, kThreads, Lay::kBytes);\n"
        "  out[1] = kThreads, out[2] = Lay::kBytes;\n"
        "  return static_cast<int>(e);\n}\n")


def k6bwd_case(dev, with_chunks: bool = True):
    """(args, dout, h_chunks) at hymba's training layer, seeded; h_chunks
    from the imported checkout's forward (its own stride)."""
    from repro_torch.kernels.selective_scan import ops as scan_ops

    rng = np.random.default_rng(C.SEED + 17)
    t = C._scan_inputs(rng, C.TRAIN_B, C.TRAIN_S, C.HYMBA_D_INNER, C.HYMBA_STATE, torch.bfloat16, dev)
    args = C._scan_args(t, False, True)
    out, _, h_chunks = scan_ops._forward(*args, 256, with_chunks=with_chunks)
    dout = C._randn(rng, tuple(out.shape), out.dtype, dev)
    return args, dout, h_chunks


def k6bwd_stamps(tree: Path, label: str) -> None:
    """One checkout's K6 backward with phase stamps (run in a process of its
    own): its csrc copied under build/kernel_sweeps/ with the stamped
    backward, built whole, the backward launched twice (the second read);
    median cycles of each phase, the SM clock, and the instance's occupancy."""
    import shutil

    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import ops as scan_ops

    dev, card = torch.device("cuda"), C.card_line()
    work = ROOT / "build" / "kernel_sweeps" / f"k6bwd_{label}"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC, work / "csrc")
    bwd = work / "csrc" / "selective_scan_bwd.cu"
    bwd.write_text(k6bwd_stamped_source(bwd.read_text()))
    _build.CSRC = work / "csrc"
    _build.build_dir = lambda: work / "lib"
    lib = _build.load_library()
    lib.repro_k6bwd_set_stamps.argtypes = [ctypes.c_void_p]
    lib.repro_k6bwd_set_stamps.restype = ctypes.c_int
    lib.repro_k6bwd_occupancy.argtypes = [ctypes.c_void_p]
    lib.repro_k6bwd_occupancy.restype = ctypes.c_int
    occ = (ctypes.c_int * 3)()
    if lib.repro_k6bwd_occupancy(occ):
        raise RuntimeError("cudaOccupancyMaxActiveBlocksPerMultiprocessor failed")
    warps = occ[1] // 32
    stamps = torch.zeros(K6BWD_STAMP_BLOCKS * 4 * K6BWD_STAMP_CHUNKS * 8 + K6BWD_SM_BLOCKS, dtype=torch.int64,
                         device=dev)
    if lib.repro_k6bwd_set_stamps(stamps.data_ptr()):
        raise RuntimeError("the stamp buffer could not be set")
    args, dout, h_chunks = k6bwd_case(dev)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    for _ in range(2):  # the second launch is read
        stamps.zero_()
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        scan_ops.selective_scan_bwd(*args, dout, None, h_chunks)
        torch.cuda.synchronize()
    chunk = scan_ops.state_chunk()
    chunks = min(K6BWD_STAMP_CHUNKS, -(-C.TRAIN_S // chunk))
    host = stamps.cpu().numpy()
    nstamp = K6BWD_STAMP_BLOCKS * warps * K6BWD_STAMP_CHUNKS * 8
    rec = host[:nstamp].reshape(-1, K6BWD_STAMP_CHUNKS, 8)[:, :chunks].astype(np.float64)
    base = K6BWD_STAMP_BLOCKS * 4 * K6BWD_STAMP_CHUNKS * 8
    blocks = C.TRAIN_B * -(-C.HYMBA_D_INNER // (8 * warps))  # 8 channels a warp at 16 states
    sms = host[base:base + K6BWD_SM_BLOCKS][:blocks]
    per_sm = np.bincount(sms, minlength=132)
    clocks, ns = rec[..., :6], rec[..., 6]
    steady = clocks[:, 1:-1]  # not the first chunk (its copies in flight) nor the last
    ends = clocks[:, 2:, 0]  # each steady chunk's last phase runs to the next chunk's top
    phases = np.concatenate([np.diff(steady, axis=2), (ends - steady[..., 5])[..., None]], axis=2)
    period = ends - steady[..., 0]
    span = ns[:, 2:] - ns[:, 1:-1]
    ghz = np.median(period[span > 0] / span[span > 0])
    print(f"[{label}] K6 backward chunk phases, training layer ({C.TRAIN_B}x{C.TRAIN_S}, {C.HYMBA_D_INNER} "
          f"channels x {C.HYMBA_STATE} states, bf16, gated; {chunk}-step chunks): {phases.shape[0]} warps x "
          f"{phases.shape[1]} chunks, median {np.median(period):.0f} cycles a chunk ({np.median(period) / chunk:.1f} "
          f"a step), SM clock {ghz:.3f} GHz; occupancy {occ[0]} blocks of {warps} warps an SM ({occ[0] * warps} "
          f"warps), {occ[2]} bytes of shared memory a block ({tree}) [{card}]", flush=True)
    print(f"[{label}]   the {len(sms)} blocks over the SMs: " + ", ".join(
        f"{k} blocks on {int((per_sm == k).sum())} SMs" for k in range(int(per_sm.max()) + 1)), flush=True)
    for name, col in zip(K6BWD_PHASES, phases.reshape(-1, 6).T):
        print(f"[{label}]   {name:>44}: median {np.median(col):7.0f}, mean {col.mean():8.1f} cycles "
              f"({np.median(col) / np.median(period):.1%})", flush=True)


def k6bwd_shipped(tree: Path, label: str) -> None:
    """One checkout's shipped K6 backward (run in a process of its own): the
    call at hymba's training layer, each of its kernels' device time per
    launch (profiler), the main kernel's registers and spills (ptxas, when
    this process built the library); then K6's forward rows: the serving
    prefill layer (4 x 2048) and decode step (S = 1, h0), and the training
    layer (4 x 1024) with and without h_chunks."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import ops as scan_ops

    dev, card = torch.device("cuda"), C.card_line()
    _build.load_library()
    ptxas = ptxas_summary(_build.build_info.get("ptxas", ""), "selective_scan_bwd_kernel")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    args, dout, h_chunks = k6bwd_case(dev)
    ms = C.median_ms(lambda: scan_ops.selective_scan_bwd(*args, dout, None, h_chunks), flush)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flush.zero_()
            scan_ops.selective_scan_bwd(*args, dout, None, h_chunks)
        torch.cuda.synchronize()
    parts = [f"{e.key} {e.self_device_time_total / 1e3 / e.count:.4f} ms" for e in prof.key_averages()
             if "selective_scan_bwd" in e.key and getattr(e, "self_device_time_total", 0) > 0]
    print(f"[{label}] K6 backward training layer: {ms:.4f} ms; per launch: {', '.join(parts)}; h_chunks "
          f"{h_chunks.numel() * 4 / 1e6:.1f} MB; ptxas: {ptxas or 'not built here'} ({tree}) [{card}]", flush=True)
    del args, dout, h_chunks
    rng = np.random.default_rng(C.SEED + 13)
    rows = []
    for name, b, s, with_h0 in K6_SHAPES + (("training layer", C.TRAIN_B, C.TRAIN_S, False),):
        t = C._scan_inputs(rng, b, s, C.HYMBA_D_INNER, C.HYMBA_STATE, torch.bfloat16, dev)
        fwd = C._scan_args(t, with_h0, True)
        rows.append(f"{name} {C.median_ms(lambda: scan_ops._forward(*fwd, 256, with_chunks=False), flush):.4f}")
        if name == "training layer":
            rows.append("with h_chunks "
                        f"{C.median_ms(lambda: scan_ops._forward(*fwd, 256, with_chunks=True), flush):.4f}")
        del t, fwd
    print(f"[{label}] K6 forward (gated, bf16), ms: {', '.join(rows)} ({tree}) [{card}]", flush=True)


# K6 backward design steps: name -> (source edits (old, new), each old found
# at least once and replaced everywhere; whether the variant still computes
# the function)
K6BWD_CLUSTER = "for (int c = kMaxCluster; c > 1; --c)"
K6BWD_STAGE0 = "  stage(chunks - 1, 0);  // in flight while the block reads its parameters"


def _k6bwd_stagger(cycles: int) -> tuple:
    """Odd clusters (all their blocks alike) start ``cycles`` late."""
    return ((K6BWD_STAGE0, "  if ((blockIdx.x / a.cluster) & 1) { const long long t_ = clock64(); "
             f"while (clock64() - t_ < {cycles}) {{}} }}\n" + K6BWD_STAGE0),)


K6BWD_WARPS = "constexpr int kWarps = 2;"
K6BWD_DEFAULT_PTXAS = "ptxas at its default level, not -O1 (spills)"
K6BWD_VARIANTS = {
    "shipped": ((), True),
    K6BWD_DEFAULT_PTXAS: ((), True),
    "4 warps a block": (((K6BWD_WARPS, "constexpr int kWarps = 4;"),), True),
    "1 warp a block": (((K6BWD_WARPS, "constexpr int kWarps = 1;"),), True),
    "clusters of up to 4 blocks": (((K6BWD_CLUSTER, "for (int c = 4; c > 1; --c)"),), True),
    "no clusters (a partial per block)": (((K6BWD_CLUSTER, "for (int c = 1; c > 1; --c)"),), True),
    "odd clusters start 11,000 cycles late": (_k6bwd_stagger(11000), True),
    # ablations: one part taken out (timing only)
    "no sums over the cluster": ((("j < len * kW; j += cl * kThreads", "j < 0; j += cl * kThreads"),), False),
    "no dz and dx rows": ((("i = t * kCh + ch;\n        const long long o",
                            "i = t * kCh + ch;\n        if (c >= 0) continue;\n        const long long o"),), False),
    "no gates in the unpack": ((("gated ? scan::gate_dy<T>(raw_at<T>(dr, i), to_f32(zr[i]))",
                                 "gated ? raw_at<T>(dr, i)"),), False),
    "no passes over the channels": ((("    channel_sums<N, kL, kG>(", "    if (c < 0) channel_sums<N, kL, kG>("),
                                     ("    block_channel_sums<N, kL, kG, kCh>(",
                                      "    if (c < 0) block_channel_sums<N, kL, kG, kCh>(")), False),
}


def k6bwd_design_steps(dev, card: str, flush) -> None:
    """Copies of this checkout's backward with one design step changed, each
    built with the forward into a library of its own (one nvcc each, all at
    once), held to the plain backward at chip_smoke's bounds where it still
    computes the function, and timed at hymba's training layer (the whole
    call) with its registers and spills."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import plain as scan_plain

    src = (_build.CSRC / "selective_scan_bwd.cu").read_text()
    nvcc, out_dir = _build.find_nvcc(), ROOT / "build" / "kernel_sweeps"
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped = _build.load_library()
    procs = {}
    for i, (name, (edits, _)) in enumerate(K6BWD_VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"selective_scan_bwd.cu changed: anchor {old[:50]!r} not found")
            text = text.replace(old, new)
        cu = out_dir / f"scan_bwd_v{i}.cu"
        cu.write_text(text)
        lib_path = out_dir / f"libscan_bwd_v{i}.so"
        flags = _build.UNIT_FLAGS.get("selective_scan_bwd.cu", ()) if name != K6BWD_DEFAULT_PTXAS else ()
        procs[name] = (lib_path, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-shared", "-o", str(lib_path), str(cu),
             str(_build.CSRC / "selective_scan.cu"), str(_build.CSRC / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"K6 backward variant {name!r} failed to build:\n{log[-3000:]}")
        print(f"K6 backward variant {name!r}, ptxas per instance: "
              f"{ptxas_summary(log, 'selective_scan_bwd_kernel')} [{card}]", flush=True)
        lib = ctypes.CDLL(str(path))
        for fn in ("repro_selective_scan", "repro_selective_scan_chunk", "repro_selective_scan_bwd",
                   "repro_selective_scan_bwd_scratch", "repro_selective_scan_bwd_info", "repro_cuda_error_string"):
            getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
            getattr(lib, fn).restype = getattr(shipped, fn).restype
        libs[name] = lib
    names = ("dxc", "dproj", "da_log", "ddt_bias", "dd_skip", "dh0", "dz")
    load = _build.load_library
    try:
        for name, lib in libs.items():
            _build.load_library = lambda lib=lib: lib
            args, dout, h_chunks = k6bwd_case(dev)
            ms = C.median_ms(lambda: scan_ops.selective_scan_bwd(*args, dout, None, h_chunks), flush)
            check = ""
            if K6BWD_VARIANTS[name][1]:
                got = scan_ops.selective_scan_bwd(*args, dout, None, h_chunks)
                want = scan_plain.selective_scan_bwd(*args, dout)
                errs = {k: ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                        for k, g, w in zip(names, got, want) if w is not None}
                check = ", max|variant-plain| / max|plain| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                if max(errs.values()) > 4 * C.SCAN_BF16_RTOL:
                    raise AssertionError(f"K6 backward variant {name!r} disagrees with the plain backward: {errs}")
            info = (ctypes.c_int * 6)()
            lib.repro_selective_scan_bwd_info(1, C.HYMBA_STATE, C.HYMBA_D_INNER, info)
            print(f"  {name}: {ms:.4f} ms{check}; {info[0]} blocks of {info[1]} warps an SM, {info[2]} bytes of "
                  f"shared memory a block, {info[3]} blocks a cluster, {info[4]} clusters at once [{card}]", flush=True)
            del args, dout, h_chunks
    finally:
        _build.load_library = load


def k6bwd_steps(tree: Path, label: str) -> None:
    """The design steps of this checkout (a process of its own)."""
    dev, card = torch.device("cuda"), C.card_line()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    print(f"K6 backward design steps, training layer ({C.TRAIN_B}x{C.TRAIN_S}, {C.HYMBA_D_INNER} channels x "
          f"{C.HYMBA_STATE} states, bf16, gated) ({tree}) [{card}]", flush=True)
    k6bwd_design_steps(dev, card, flush)


def k6bwd_ab(parent: Path | None) -> int:
    """Each checkout's phase stamps, this checkout's design steps, then the
    two shipped backwards and K6's forward rows in turns (other, this,
    this, other), a process each."""
    runs = [("k6bwd-stamps-child", tree, label) for tree, label in ((parent, "other"), (ROOT, "this")) if tree]
    runs.append(("k6bwd-steps-child", ROOT, "this"))
    turns = ((parent, "other"), (ROOT, "this"), (ROOT, "this"), (parent, "other")) if parent else ((ROOT, "this"),)
    runs += [("k6bwd-child", tree, label) for tree, label in turns]
    for child, tree, label in runs:
        proc = subprocess.run([sys.executable, __file__, child, str(tree), label], timeout=900)
        if proc.returncode:
            return proc.returncode
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_sweeps: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["k3-child"]:
        k3_shipped(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if sys.argv[1:2] == ["k6-child"]:
        k6_shipped(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if sys.argv[1:2] == ["k3bwd-child"]:
        k3bwd_shipped(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if sys.argv[1:2] == ["k3bwd-train-child"]:
        k3bwd_train(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if sys.argv[1:2] == ["k6bwd-stamps-child"]:
        k6bwd_stamps(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if sys.argv[1:2] == ["k6bwd-steps-child"]:
        k6bwd_steps(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    if sys.argv[1:2] == ["k6bwd-child"]:
        k6bwd_shipped(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    parts = ({a for a in sys.argv[1:] if a in ("k4", "k2", "k1", "k3", "k6", "k3bwd", "k6bwd")}
             or {"k4", "k2", "k1"})
    others = [Path(a).resolve() for a in sys.argv[1:] if a not in parts]
    if others and (parts not in ({"k3"}, {"k6"}, {"k3bwd"}, {"k6bwd"}) or len(others) > 1
                   or not others[0].is_dir()):
        print(__doc__, file=sys.stderr)
        return 2
    if parts == {"k6bwd"}:  # each checkout in processes of its own
        return k6bwd_ab(others[0] if others else None)
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
    if "k3" in parts:
        k3_stages(dev, card, flush)
        k3_design_steps(dev, card, flush)
        if others:
            del flush
            return k3_ab(others[0])
    if "k6" in parts:
        k6_stages(dev, card, flush)
        k6_design_steps(dev, card, flush)
        if others:
            del flush
            return k6_ab(others[0])
    if "k3bwd" in parts:
        k3bwd_kernels(dev, card, flush)
        if others:
            del flush
            return k3bwd_ab(others[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
