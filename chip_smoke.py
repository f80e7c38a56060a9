#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100, ``nvcc`` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. environment: torch/CUDA versions, the card's name and power limit, the
   build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a),
   and the redesigned kernels' SASS (tensor-core, TMA or ``cp.async``
   instructions in every instance of a template, no spills);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at ragged ones (K1's int16 entry on views of
   staged batches at points 8/4/2, K5 on 4:2:0 and 4:4:4 with odd crops),
   then its median time (CUDA events, cold L2) beside the plain version's,
   one library call's, and the least time the card could take (the
   bound); K1 at phase 3's batch (point 8) and 6C's (point 4); K3 also
   with S_k != S_q (whisper's cross attention); for K4 also per layer,
   beside the launch floor of an empty kernel; K6 (the selective scan,
   from the x_proj output to the gated rows) at hymba-1.5b's layer, S =
   1, 37 and 2048, with and without h0, ``z=None`` (y in f32) and gated,
   timed at the prefill layer and at a decode step; K3's row log-sum-exp
   (the backward's input) and K3's backward (dQ, then dK/dV) against their
   plain versions at Gemma3-1B's training layers (4 x 1024, global and
   window 512, bf16 and f32) and ragged, GQA, D 64/128 and Sk != Sq
   cases, the backward timed per training step beside SDPA's backward;
   K3 also over K and V expanded (stride 0) over the batch or the KV
   heads; K6's backward against the plain backward at hymba-1.5b's
   training layer (4 x 1024, bf16, gated) and at S = 37 and 130 with h0,
   bf16 and f32, and the 8-state instance over 80 channels, bitwise equal
   from launch to launch, timed at the training layer;
3. main path: ``SmolRuntime.run`` with split decode over a seeded SJPG
   corpus (384x512, 4:2:0, q90; 2 full batches of 64 + a ragged tail) into
   a full-width ResNet-50 with seeded random weights; checks the outputs,
   the plan, the kernels' launch counts (K1 x2, K5 x1, K2 x1 a dispatch),
   and the first batch's logits against a CPU run of the same program;
4. LM path: Gemma3-1B at full width (26 layers, bf16, seeded random
   weights): ``prefill`` of 4 x 2048 tokens, ``forward`` over the same
   prompts, 16 ``decode_step``s, and ``ServingEngine.serve`` of 16
   requests over 8 slots; checks the K3/K4 launch counts of each phase,
   finite logits, prefill and decode logits against the same model with
   plain attention and forward's last position against prefill's; prints
   prefill tokens/s, decode ms/step, serve tokens/s and a profile of
   decode steps (K4 must launch one kernel per layer there); phase 4B
   does the same for OLMoE-1B-7B and DeepSeek-V2 (1 + 3 layers); phase
   4C for whisper-large-v3 (full: ``encode`` of 4 x 1500 stub frames,
   prefill of 4 x 224 over them into a 448-token cache, K3 over 1500 keys
   for cross attention, K4 over the cross cache, serve of 8 over 4 slots)
   and internvl2-26b (full: 256 stub vision tokens + 768 text), then
   qwen3-32b and internlm2-20b at full width and 4 layers (prefill of
   4 x 512, 4 decode steps), each model freed before the next; phase 4D
   the same as phase 4 for hymba-1.5b (full: attention beside Mamba heads,
   K3/K4 and K6 a layer, logits held against plain attention and the
   plain scan) and xlstm-125m (full: mLSTM and sLSTM, no kernel), each
   first decode step also against ``forward`` over the prompt and that
   token, and the launches of one sLSTM layer's token loop; phase 4E
   trains Gemma3-1B at full size (f32 master weights, bf16 compute,
   AdamW): the first step twice from one state, on the kernels and on
   plain attention (loss and grad norm held to each other), then
   ``train()`` for 10 steps of 4 x 1024 tokens (each step's loss, grad
   norm, ms and peak memory; K3 forward 52 and backward 26 launches a
   step; the loss must fall), then hymba-1.5b the same way for 6 steps
   (the first step also on plain attention and the plain scan; K3 and K6
   each 64 forward and 32 backward launches a step), each step profiled
   once by kernel family;
5. vision serving: a ``SmolRuntime`` over phase 3's model and corpus with
   ``warmup="full"`` (one CUDA graph per batch bucket), two tenants
   (weights 4 and 1), telemetry and a 64 MiB rendition cache serves every
   item as a ``ClassificationQuery``, 32 thumbnail-first ``CascadeQuery``s
   with a full-resolution refetch and one ``AggregationQuery``; checks the
   predictions against phase 3, that every bucket was captured before
   serving and nothing after, a ragged batch of 37 through bucket 64, the
   K1/K5/K2 kernels inside one replay (profiler), no warm failures, and a
   ``run()`` with ``RecalConfig(every=64)``; prints serving items/s, p50/p99
   latency, capture seconds per bucket, the graph pool's memory and the
   program's time per batch eager and as a replay;
6. the paper's data: (A) each image dataset (bike-bird, animals-10,
   birds-200, imagenet-sim; 64 images in the paper's four formats) through
   a ``SmolRuntime`` over full-width ResNet-18/34/50 with seeded random
   weights, exec throughputs measured on the card (printed beside the
   paper's T4 figures) and a synthetic accuracy table, under two accuracy
   floors: one selects the full JPEG on the split-decode program (K1, K5, K2),
   the other the 161-px PNG on the pixel program (K2); (B) each video
   dataset (night-street, taipei, amsterdam, rialto; 96 frames of 96 px,
   two renditions): encode and host decode times, then the full rendition
   deblocked and the low one without deblocking through the pixel program
   into TINY_RESNET; (C) scaled split decode: 16 smooth 768x1024 images at
   factor 2, K1 at point 4 and K5, into phase 3's ResNet-50.  Each checks the
   plan, the launches per dispatch, the outputs, and the logits against
   the CPU run of the same program;
7. the kernels' JSON line, the card line, and ``{"ok": true, ...}`` last.

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
PEAK_TF32_FLOPS = 495e12  # dense TF32 tensor cores
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores
# exp2 results per second on the SFUs: 132 SMs x 16 a clock (CUDA C
# programming guide, arithmetic instruction throughput, compute
# capability 9.0) x the 1.98 GHz boost clock of the H100 SXM
PEAK_SFU_OPS = 132 * 16 * 1.98e9

SEED = 0
BATCH = 64
N_ITEMS = 2 * BATCH + 22  # two full batches + a ragged tail
IMG_H, IMG_W = 384, 512
INPUT = 224
K1_ATOL = 2e-2  # 3xTF32 sums vs cuBLAS fp32: values reach the thousands
LOGIT_RTOL = 1e-3  # card vs CPU logits, relative to the largest |logit|

# the LM path: Gemma3-1B at full width, bf16
PREFILL_B, PREFILL_S = 4, 2048  # prompts x tokens: past the 512-token window
DECODE_STEPS = 16
DECODE_MAX_LEN = PREFILL_S + 64  # cache length of the prefill + decode phases
SERVE_REQUESTS, SERVE_SLOTS, SERVE_MAX_LEN, SERVE_MAX_NEW = 16, 8, 256, 16
GEMMA_WINDOW, N_GLOBAL, N_LOCAL = 512, 4, 22  # 26 layers, 5:1 local:global
# phase 4B: OLMoE-1B-7B (full) and DeepSeek-V2 (full width, 1 dense + 3 MoE
# layers), bf16
MOE_PREFILL_B, MOE_PREFILL_S = 4, 1024
MOE_MAX_LEN = MOE_PREFILL_S + 64
DEEPSEEK_LAYERS = 4  # of 60: ~27 GB in bf16; all 60 (~470 GB) do not fit one card
MLA_DIMS = (192, 128)  # DeepSeek-V2's q/k width (nope 128 + rope 64) and v width
MLA_HEADS = 128  # DeepSeek-V2's query heads (MLA: group 1)
OLMOE_HEADS, OLMOE_HD = 16, 128
# phase 4C: whisper-large-v3 (full), internvl2-26b (full), qwen3-32b and
# internlm2-20b (full width, 4 layers), bf16
WHISPER_B, WHISPER_PROMPT, WHISPER_MAX_LEN = 4, 224, 448  # 448: whisper's decoder ceiling
WHISPER_FRAMES, WHISPER_HEADS, WHISPER_HD = 1500, 20, 64  # 30 s of audio after the conv frontend
VLM_B, VLM_TEXT = 4, 768  # + the config's 256 vision tokens
DENSE_CUT_LAYERS, DENSE_B, DENSE_S = 4, 4, 512  # qwen3-32b whole is ~65 GB in bf16
CUT_DECODE_STEPS = 4
SERVE_4C_REQUESTS, SERVE_4C_SLOTS = 8, 4
SERVE_4C_TEXT = "request {i}"  # ~11 tokens: the eager serve's token-by-token prompt steps stay short
# phase 4D: hymba-1.5b (attention + Mamba) and xlstm-125m, full, bf16; the
# 4 x 2048 prompts pass hymba's 1024 window
HYMBA_LAYERS, HYMBA_D_INNER, HYMBA_STATE = 32, 3200, 16
# K6 vs its plain version, f32 state both: the kernel walks time in order,
# the plain version scans chunks as a tree; relative to the largest |value|
SCAN_RTOL = 1e-4
# K6's bf16(y), which its gate multiplies: one bf16 step apart at most
# (K3's bf16 rule, the constant term relative to the largest |value|)
SCAN_BF16_RTOL, SCAN_BF16_ATOL = 2**-7, 1e-4
# K6's bf16 dz against the plain backward: it rounds three times after y
# (bf16(y), dout bf16(y), silu_backward), so one step of y between the two
# (which sum y in another order) can become about 2.5 steps of dz: held to
# three of SCAN_BF16_RTOL (the count outside one step is logged)
SCAN_DZ_STEPS = 3
# kernel vs plain on the card, both f32 inside: f32 outputs sum in another
# order (the CPU tests' 2e-5 bound); bf16 outputs may round one bf16 step
# apart, at most 2^-7 of the value, held elementwise (plus f32 noise)
ATTN_F32_ATOL = 2e-5
ATTN_BF16_RTOL, ATTN_BF16_ATOL = 2**-7, 1e-4
# forward vs prefill on the card: the same layers; only the logits product's
# shape differs, so cuBLAS may round a bf16 logit one step apart
FORWARD_LOGIT_RTOL = 2**-7
# Gemma3-1B logits, kernels vs plain attention on the card, relative to the
# largest |logit|: both run bf16 activations; the attention outputs round to
# bf16 one step apart now and then, and 26 layers carry that on
LM_LOGIT_RTOL = 5e-2
# phase 4E: Gemma3-1B trained at full size, f32 master weights, bf16 compute
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 10
HYMBA_TRAIN_STEPS = 6  # hymba-1.5b's steps in phase 4E, at the same 4 x 1024
# K3's backward vs its plain backward (the same inputs, both f32 inside),
# per gradient relative to its largest |value|: bf16 gradients may round
# one bf16 step apart (2^-8 of a value, 2^-7 with room), f32 ones sum in
# another order
BWD_BF16_RTOL, BWD_F32_RTOL = 2**-7, 1e-5
# plus, elementwise, f32 cancellation noise: a gradient that is zero in exact
# arithmetic (dq of a row with one key: dP - Delta = dO.v - dO.O) comes out
# of both versions as ~2e-7 of noise (added after the first card run)
BWD_ATOL = 1e-5
# K3's row log-sum-exp (base 2) vs the plain one's: the bf16 kernel sums
# exp2 of f32 scores in MUFU.EX2 (~2^-22 relative each); base-2 units
LSE_ATOL = 1e-3
# the first step on the kernels vs under plain attention (autograd through
# the plain version), bf16 compute: loss and grad norm, relative
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-2, 5e-2

# the vision serving phase
SERVE_TENANTS = (("gold", 4.0), ("bronze", 1.0))
N_CASCADES = 32
RAGGED_ROWS = 37
RECAL_EVERY = 64
RENDITION_CACHE_BYTES = 64 * 2**20
SERVE_TIMEOUT_S = 300.0
TIMED_BUCKETS = (1, 8, BATCH)  # eager vs replay per batch
# kernel launches per split-decode dispatch, as a graph records them
REPLAY_KERNELS = {"idct": 2, "blocks_to_rgb": 1, "fused_preproc": 1}

# the paper's datasets (phase 6)
PAPER_N, PAPER_BATCH = 64, 32  # images per image dataset, batch
PAPER_MODELS = ("resnet18", "resnet34", "resnet50")
# synthetic accuracies (random weights have none to measure) over the
# paper's formats: full JPEG q95, PNG 161, JPEG 161 q95, JPEG 161 q75
PAPER_ACCURACY = {"resnet18": (0.80, 0.79, 0.62, 0.58),
                  "resnet34": (0.84, 0.81, 0.66, 0.62),
                  "resnet50": (0.88, 0.83, 0.70, 0.66)}
# (program, accuracy floor, the format the floor must select): 0.86 admits
# only ResNet-50 on the full JPEG; 0.79 also the PNG thumbnail, which
# decodes cheapest and can only take the pixel program
PAPER_PLANS = (("split decode", 0.86, "jpeg_full_q95"), ("pixel program", 0.79, "png_161"))
VIDEO_FRAMES, VIDEO_SIZE = 96, 96
VIDEO_INPUT, VIDEO_BATCH = 64, 32  # TINY_RESNET's input side, frames per dispatch
VIDEO_CLASSES = 9  # object counts 0-8 (make_video caps them at 8)
SCALED_N, SCALED_H, SCALED_W = 16, 768, 1024
LONG_SPIN = 40_000_000  # clock cycles, ~23 ms: longer than a program's eager enqueue
# how many times decode steps are profiled before a K4/K6 device-launch
# count that is off fails: the profiler can lose a kernel record in an eager
# window of ~16k (whisper's decode on an H100 once gave 255 of 256 K4 records)
PROFILE_ATTEMPTS = 3


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


def median_ms(fn, flush: torch.Tensor | None, iters: int = 20, warmup: int = 3,
              spin: int = 2_000_000) -> float:
    """Median time of ``fn()`` on the card (CUDA events).  With ``flush``,
    L2 is flushed before each launch so the operands come from device
    memory, as on the main path.  A spin of ``spin`` clock cycles (~1 ms by
    default) on the card before the start event keeps it busy while the
    host enqueues ``fn``'s launches, so a small kernel's time is its own,
    not its wrapper's host time; a program of hundreds of launches needs a
    longer one."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)  # clock cycles
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Wall time per call of ``fn`` issued back to back, from the first
    call to the card finishing the last (host clock): host launch cost
    included, which CUDA graphs remove."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ phase 1: build
# the redesigned kernels and the instruction their SASS must hold: tensor
# cores (K3 bf16, K1 at every point), TMA bulk copies (K4), cp.async
# copies into shared memory (K2; K6's and K6 backward's double-buffered rows)
DESIGNED_KERNELS = {"flash_attention_tc_kernel": "HGMMA", "idct_rows_tc_kernel": "HMMA",
                    "flash_decode_kernel": "UBLKCP", "resize_affine_band_kernel": "LDGSTS",
                    "selective_scan_kernel": "LDGSTS", "flash_attention_bwd_dq_tc_kernel": "HGMMA",
                    "flash_attention_bwd_dkdv_tc_kernel": "HGMMA", "selective_scan_bwd_kernel": "LDGSTS"}
# instances a kernel template must have, where that is checked: K1's int16
# zigzag entry at points 8/4/2 and its f32 natural entry at 8/4/2/1; K3's
# bf16 kernels, forward and backward's two, at (q/k, v) widths (64, 64),
# (128, 128), (256, 256), (192, 128); K6 and its backward at 8 and 16
# states, the model dtype (xc, proj, z, the gated out) f32 and bf16
DESIGNED_INSTANCES = {"idct_rows_tc_kernel": 7, "flash_attention_tc_kernel": 4, "selective_scan_kernel": 4,
                      "flash_attention_bwd_dq_tc_kernel": 4, "flash_attention_bwd_dkdv_tc_kernel": 4,
                      "selective_scan_bwd_kernel": 4}
# kernels held to no spills alone: K3's f32 backward (SIMT dQ and dK/dV, the 4 widths each)
NO_SPILL_KERNELS = {"flash_attention_bwd_dq_kernel": 4, "flash_attention_bwd_dkdv_kernel": 4}


def check_kernel_code(build) -> None:
    """The redesigned kernels were compiled as designed: their SASS
    (``cuobjdump --dump-sass`` of the built library) holds HGMMA (K3 bf16
    and its backward's dQ and dK/dV kernels, ``wgmma``), HMMA (every instance of K1's template, ``mma.sync`` tf32),
    UBLKCP (K4, TMA bulk copies) and LDGSTS (``cp.async``: K2, and every
    instance of K6, its staged rows), and ptxas reports no spills for
    them and serialises no ``wgmma`` (when this process built the
    library)."""
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", build.build_info["path"]],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts[name] = {op: 0 for op in set(DESIGNED_KERNELS.values())}
        elif name is not None:
            for op in counts[name]:
                counts[name][op] += f" {op}." in line or f" {op} " in line
    spills, entry, serialized = {}, None, []
    for line in build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry is not None:
            spills[entry] = line.strip()
        if "wgmma" in line and "serialized" in line:
            serialized.append(line.strip())
    for key, op in DESIGNED_KERNELS.items():
        found = {n: c[op] for n, c in counts.items() if key in n}
        log(f"[env] sass: {key}: {op} instructions per instance {sorted(found.values())}")
        if not found or min(found.values()) == 0:
            raise AssertionError(f"{key}: no {op} in its SASS ({found})")
        if key in DESIGNED_INSTANCES and len(found) != DESIGNED_INSTANCES[key]:
            raise AssertionError(f"{key}: {len(found)} instances, expected "
                                 f"{DESIGNED_INSTANCES[key]} ({sorted(found)})")
        for n, report in spills.items():
            if key in n and "0 bytes spill stores, 0 bytes spill loads" not in report:
                raise AssertionError(f"{n} spills: {report}")
    for key, n in NO_SPILL_KERNELS.items():
        found = [report for e, report in spills.items() if key in e]
        if spills and (len(found) != n or any("0 bytes spill stores, 0 bytes spill loads" not in r
                                              for r in found)):
            raise AssertionError(f"{key}: {len(found)} instances (expected {n}) or spills: {found}")
    if serialized:  # ptxas waits after every wgmma where it cannot prove the overlap safe
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")
    if not spills:
        log("[env] ptxas report: none (the library was built by an earlier process)")


# --------------------------------------------------------------- phase 2: K1
def check_idct(dev, luma_rows: int) -> dict:
    """K1's f32 natural-order entry (``idct_rows``, the reference's
    ``dequant_idct`` API) against its plain version: every point, two
    qualities, the main path's luma row count and ragged ones: 1, one tile
    of 128 rows less and more one, 777, and a count past three sweeps of
    the largest persistent grid (4 blocks x 8 warps x 16 rows per SM) that
    is no multiple of it.  Returns the largest |kernel - plain| per point."""
    from repro_torch.kernels.idct import ops as idct_ops
    from repro_torch.kernels.idct import plain as idct_plain
    from repro_torch.preprocessing import dct

    rng = np.random.default_rng(SEED)
    sweep = 4 * 8 * 16 * torch.cuda.get_device_properties(dev).multi_processor_count
    worst = {point: 0.0 for point in idct_ops.SCALED_POINTS}
    for point in idct_ops.SCALED_POINTS:
        for quality in (50, 95):
            q = dct.quality_scale(dct.QTABLE_LUMA, quality)
            m = torch.from_numpy(idct_ops.idct_matrix(q, point)).to(dev)
            for n in (1, 127, 129, 777, 3 * sweep + 37, luma_rows):
                x = torch.from_numpy(rng.integers(-300, 300, size=(n, 64)).astype(np.float32)).to(dev)
                err = (idct_ops.idct_rows(x, m) - idct_plain.idct_rows(x, m)).abs().max().item()
                log(f"  idct f32 natural point={point} q={quality} n={n}: max|kernel-plain|={err:.3e}")
                if not err <= K1_ATOL:
                    raise AssertionError(f"idct disagrees with its plain version: {err} > {K1_ATOL}")
                worst[point] = max(worst[point], err)
    return worst


def staged_batch(rng, n: int, n_br: int, n_bc: int, subsample: bool, layout: str, dev):
    """A staged int16 zigzag batch on the card in ``layout`` and the split-
    decode program's (luma, chroma) views of it."""
    cbr, cbc = ((n_br + 1) // 2, (n_bc + 1) // 2) if subsample else (n_br, n_bc)
    n_luma = n_br * n_bc
    shape = (n, 3, n_br, n_bc, 64) if layout == "padded" else (n, n_luma + 2 * cbr * cbc, 64)
    zz = torch.from_numpy(rng.integers(-300, 300, size=shape, dtype=np.int16)).to(dev)
    if layout == "padded":
        return zz[:, 0], zz[:, 1:, :cbr, :cbc]
    return zz[:, :n_luma], zz[:, n_luma:]


def _qtables(quality: int = 90):
    from repro_torch.preprocessing import dct

    return dct.quality_scale(dct.QTABLE_LUMA, quality), dct.quality_scale(dct.QTABLE_CHROMA, quality)


# (images, luma block rows, block columns, 4:2:0) of the split-decode batches
PHASE3_GRID = (BATCH, IMG_H // 8, IMG_W // 8, True)
SCALED_GRID = (SCALED_N, SCALED_H // 8, SCALED_W // 8, True)


def check_idct_zigzag(dev) -> dict:
    """K1's int16 zigzag entry against its plain version, reading the staged
    rows in place: points 8/4/2, both quant tables, both layouts' views, at
    phase 3's and 6C's batches and at a ragged one (3 images of 13 x 17
    blocks: 4-d chroma views, rows no multiple of a tile).  Returns the
    largest |kernel - plain| at point 8 and at points 4/2."""
    from repro_torch.kernels.idct import ops as idct_ops
    from repro_torch.kernels.idct import plain as idct_plain

    rng = np.random.default_rng(SEED + 6)
    worst = {"idct": 0.0, "idct_scaled": 0.0}
    for n, n_br, n_bc, sub in (PHASE3_GRID, SCALED_GRID, (3, 13, 17, True), (3, 13, 17, False)):
        for layout in ("padded", "packed"):
            views = staged_batch(rng, n, n_br, n_bc, sub, layout, dev)
            for point in (8, 4, 2):
                for plane, v, q in zip(("luma", "chroma"), views, _qtables()):
                    m = torch.from_numpy(idct_ops.zigzag_matrix(q, point)).to(dev)
                    got = idct_ops.idct_zigzag_rows(v, m)
                    want = idct_plain.idct_zigzag_rows(v, m)
                    err = (got - want).abs().max().item()
                    extra = ""
                    if (n, n_br, n_bc, sub) == PHASE3_GRID and point == 8:  # both against f64
                        exact = v.reshape(-1, 64).double() @ m.double()
                        extra = (f" (vs f64: kernel {(got.double() - exact).abs().max().item():.3e}, "
                                 f"plain {(want.double() - exact).abs().max().item():.3e}, "
                                 f"max|value| {exact.abs().max().item():.0f})")
                    log(f"  idct int16 zigzag {n}x{n_br}x{n_bc} {'4:2:0' if sub else '4:4:4'} "
                        f"{layout} {plane} view {tuple(v.shape)} point={point}: rows {got.shape[0]}, "
                        f"max|kernel-plain|={err:.3e}{extra}")
                    if got.shape != want.shape or not err <= K1_ATOL:
                        raise AssertionError(f"idct int16 disagrees with its plain version: {err}")
                    key = "idct" if point == 8 else "idct_scaled"
                    worst[key] = max(worst[key], err)
            del views
    return worst


def time_idct(dev, grid, point: int, flush) -> dict:
    """K1's two launches of one split-decode batch (luma, chroma) at
    ``point``, from the staged int16 batch (packed, as the planner stages
    4:2:0): 8 at phase 3's batch, 4 at phase 6C's.  The library yardstick
    is ``zz.to(float32) @ m_zz`` on the same views; the f32 natural-row
    forms (K1's other entry and ``torch.matmul``) are printed beside it."""
    from repro_torch.kernels.idct import ops as idct_ops
    from repro_torch.kernels.idct import plain as idct_plain

    rng = np.random.default_rng(SEED)
    n, n_br, n_bc, sub = grid
    views = staged_batch(rng, n, n_br, n_bc, sub, "packed", dev)
    m_zz = [torch.from_numpy(idct_ops.zigzag_matrix(q, point)).to(dev) for q in _qtables()]
    m_nat = [torch.from_numpy(idct_ops.idct_matrix(q, point)).to(dev) for q in _qtables()]
    pairs = list(zip(views, m_zz))
    kernel = median_ms(lambda: [idct_ops.idct_zigzag_rows(v, m) for v, m in pairs], flush)
    plain = median_ms(lambda: [idct_plain.idct_zigzag_rows(v, m) for v, m in pairs], flush)
    library = median_ms(lambda: [v.to(torch.float32) @ m for v, m in pairs], flush)
    rows_f32 = [torch.from_numpy(rng.integers(-300, 300, size=(v.numel() // 64, 64)).astype(np.float32))
                .to(dev) for v in views]
    nat = list(zip(rows_f32, m_nat))
    f32_kernel = median_ms(lambda: [idct_ops.idct_rows(x, m) for x, m in nat], flush)
    f32_matmul = median_ms(lambda: [torch.matmul(x, m) for x, m in nat], flush)
    rows, p2, k = sum(v.numel() // 64 for v in views), point * point, idct_ops.K_ROWS["zigzag", point]
    # each row's first K int16 in, P f32 out, the two matrices' K rows; three
    # TF32 products per multiply-add (3xTF32)
    b_ms, b_by = bound_ms(rows * (k * 2 + p2 * 4) + 2 * k * p2 * 4, 3 * 2.0 * rows * k * p2,
                          PEAK_TF32_FLOPS)
    log(f"  idct per batch ({rows} int16 zigzag rows, point {point}, K {k}): kernel {kernel:.4f} ms, "
        f"plain {plain:.4f} ms, zz.to(float32) @ m_zz {library:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / kernel:.1%} of it; f32 natural rows: kernel {f32_kernel:.4f} ms, torch.matmul "
        f"{f32_matmul:.4f} ms")
    return {
        "name": "idct" if point == 8 else "idct_scaled",
        "route": "cuda",
        "source": "src/repro_torch/csrc/idct.cu",
        "replaces": "src/repro/kernels/idct/idct.py:41",
        "ms": kernel,
        "plain_ms": plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library,
    }


# --------------------------------------------------------------- phase 2: K5
def _block_grid(n_br: int, n_bc: int, sub: bool, point: int, hs: int, ws: int):
    from repro_torch.kernels.blocks_to_rgb.ops import BlockGrid

    cbr, cbc = ((n_br + 1) // 2, (n_bc + 1) // 2) if sub else (n_br, n_bc)
    return BlockGrid(n_br, n_bc, cbr, cbc, point, hs, ws, sub)


def _decoded_blocks(rng, n: int, grid, dev):
    """K1-like outputs: level-shifted pixels, some past both clamps, some on
    .5 ties after the shift."""
    p2 = grid.point**2
    out = []
    for rows in (n * grid.n_br * grid.n_bc, n * 2 * grid.cbr * grid.cbc):
        v = rng.uniform(-200, 200, size=(rows, p2)).astype(np.float32)
        ties = rng.random(size=v.shape) < 0.05
        v[ties] = np.round(v[ties]) + 0.5
        out.append(torch.from_numpy(v).to(dev))
    return out


def _ycbcr_to_rgb_matrix(dev):
    from repro_torch.core.device_compiler import _YCBCR_TO_RGB

    return torch.from_numpy(_YCBCR_TO_RGB).to(dev)


def check_blocks_to_rgb(dev) -> float:
    """K5 against its plain version, value for value (``torch.equal``):
    phase 3's batch (point 8) and 6C's (point 4), 4:2:0 and 4:4:4 at
    points 8/4/2 with crops that cut partial blocks (odd sizes, widths no
    multiple of 4).  Returns the largest |kernel - plain|."""
    from repro_torch.kernels.blocks_to_rgb import ops as b2r_ops
    from repro_torch.kernels.blocks_to_rgb import plain as b2r_plain

    rng = np.random.default_rng(SEED + 7)
    mat = _ycbcr_to_rgb_matrix(dev)
    cases = [(BATCH, _block_grid(IMG_H // 8, IMG_W // 8, True, 8, IMG_H, IMG_W)),
             (SCALED_N, _block_grid(SCALED_H // 8, SCALED_W // 8, True, 4, SCALED_H // 2, SCALED_W // 2))]
    for sub in (True, False):
        for point in (8, 4, 2):  # 97 x 131 at factor 8 // point: 13 x 17 blocks
            f = 8 // point
            cases.append((3, _block_grid(13, 17, sub, point, -(-97 // f), -(-131 // f))))
    worst = 0.0
    for n, grid in cases:
        luma, chroma = _decoded_blocks(rng, n, grid, dev)
        got = b2r_ops.blocks_to_rgb(luma, chroma, mat, grid)
        want = b2r_plain.blocks_to_rgb(luma, chroma, mat, grid)
        if got.shape != want.shape:
            raise AssertionError(f"blocks_to_rgb shape {tuple(got.shape)}, plain {tuple(want.shape)}")
        same = torch.equal(got, want)
        err = (got - want).abs().max().item()
        log(f"  blocks_to_rgb {n} images {grid}: shape {tuple(got.shape)}, equal {same}, "
            f"max|kernel-plain|={err:.3e}")
        if not same:
            raise AssertionError(f"blocks_to_rgb differs from its plain version by {err}")
        worst = max(worst, err)
    return worst


def eager_tail(luma, chroma, rgb_mat, grid):
    """The eager torch ops K5 replaced in the split-decode program:
    unblockify, repeat_interleave, cat, +128, einsum, round, clamp."""
    p, n = grid.point, luma.shape[0] // (grid.n_br * grid.n_bc)
    y = luma.reshape(n, grid.n_br, grid.n_bc, p, p).permute(0, 1, 3, 2, 4).reshape(
        n, grid.n_br * p, grid.n_bc * p)
    c = chroma.reshape(n, 2, grid.cbr, grid.cbc, p, p).permute(0, 1, 2, 4, 3, 5).reshape(
        n, 2, grid.cbr * p, grid.cbc * p)
    if grid.subsample:
        c = c.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    ycc = torch.cat([y[:, None, :grid.hs, :grid.ws], c[:, :, :grid.hs, :grid.ws]], dim=1) + 128.0
    shift = torch.tensor([0.0, 128.0, 128.0], device=luma.device)[:, None, None]
    rgb = torch.einsum("rc,nchw->nrhw", rgb_mat, ycc - shift)
    return torch.clamp(torch.round(rgb), 0.0, 255.0)


def time_blocks_to_rgb(dev, flush) -> dict:
    """K5 on one phase-3 batch (64 x 384 x 512, 4:2:0, point 8), and on
    6C's (16 images at factor 2, point 4), beside its plain version and
    the eager ops it replaced (the library yardstick)."""
    from repro_torch.kernels.blocks_to_rgb import ops as b2r_ops
    from repro_torch.kernels.blocks_to_rgb import plain as b2r_plain

    rng = np.random.default_rng(SEED + 8)
    mat = _ycbcr_to_rgb_matrix(dev)
    row = None
    for n, grid in ((BATCH, _block_grid(IMG_H // 8, IMG_W // 8, True, 8, IMG_H, IMG_W)),
                    (SCALED_N, _block_grid(SCALED_H // 8, SCALED_W // 8, True, 4,
                                           SCALED_H // 2, SCALED_W // 2))):
        luma, chroma = _decoded_blocks(rng, n, grid, dev)
        kernel = median_ms(lambda: b2r_ops.blocks_to_rgb(luma, chroma, mat, grid), flush)
        plain = median_ms(lambda: b2r_plain.blocks_to_rgb(luma, chroma, mat, grid), flush)
        library = median_ms(lambda: eager_tail(luma, chroma, mat, grid), flush)
        pixels = n * grid.hs * grid.ws
        nbytes = (luma.numel() + chroma.numel()) * 4 + 3 * pixels * 4
        # per pixel: 5 level-shift adds, 3 x (3 multiplies + 2 adds), round, 2 clamps
        b_ms, b_by = bound_ms(nbytes, 23.0 * pixels)
        log(f"  blocks_to_rgb per batch ({n} x {grid.hs}x{grid.ws}, point {grid.point}, "
            f"{'4:2:0' if grid.subsample else '4:4:4'}): kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
            f"the eager ops it replaced {library:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{b_ms / kernel:.1%} of it, {nbytes / kernel / 1e9:.3f} TB/s")
        if row is None:  # phase 3's batch is the kernels line's
            row = {
                "name": "blocks_to_rgb",
                "route": "cuda",
                "source": "src/repro_torch/csrc/blocks_to_rgb.cu",
                "replaces": "src/repro/core/device_compiler.py:846",
                "ms": kernel,
                "plain_ms": plain,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": library,
            }
    return row


# --------------------------------------------------------------- phase 2: K2
def _taps(low, dev):
    from repro_torch.core.device_compiler import lowering_taps

    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in lowering_taps(low)]


def check_fused_preproc(dev, low) -> float:
    """K2 against its plain version, bitwise, with and without the uint8
    re-quantize: the main path's crop windows, a non-square upsample, a
    crop at odd offsets, output widths that are no multiple of 4, two
    column tiles whose bands must be cut into sub-bands, and a downsample
    so wide that not even two input rows fit the stage (direct reads).
    Returns the largest |kernel - plain|."""
    from repro_torch.kernels.fused_preproc import ops as fp_ops
    from repro_torch.kernels.fused_preproc import plain as fp_plain

    rng = np.random.default_rng(SEED + 1)
    scale = np.asarray(low.scale, np.float32)
    bias = np.asarray(low.bias, np.float32)
    h, w = low.in_meta.spatial

    def bilinear(rows, cols):  # (in, out, start, count, offset) per axis
        return [torch.from_numpy(a).to(dev)
                for a in (*fp_ops.bilinear_taps(*rows), *fp_ops.bilinear_taps(*cols))]

    cases = [
        ("main path crop+resize", BATCH * 3, h, w, _taps(low, dev)),
        ("upsample 161x193->224x300", 6, 161, 193, bilinear((161, 224), (193, 300))),
        ("crop (5, 3) 110x190 of 120x203 ->64x100", 3, 120, 203,
         bilinear((110, 64, 0, None, 5), (190, 100, 0, None, 3))),
        ("odd widths 161x193->97x131", 3, 161, 193, bilinear((161, 97), (193, 131))),
        ("two column tiles 50x3000->60x1100", 3, 50, 3000, bilinear((50, 60), (3000, 1100))),
        ("wide downsample 40x20000->30x1500", 3, 40, 20000, bilinear((40, 30), (20000, 1500))),
    ]
    worst = 0.0
    for label, planes, ph, pw, taps in cases:
        x = torch.from_numpy(rng.uniform(0, 255, size=(planes, ph, pw)).astype(np.float32)).to(dev)
        s = torch.from_numpy(np.tile(scale, planes // 3)).to(dev)
        b = torch.from_numpy(np.tile(bias, planes // 3)).to(dev)
        for round_uint8 in (True, False):
            got = fp_ops.resize_affine_planar(x, *taps, s, b, round_uint8)
            want = fp_plain.resize_affine_planar(x, *taps, s, b, round_uint8)
            same = torch.equal(got, want)
            err = (got - want).abs().max().item()
            log(f"  fused_preproc {label} round_uint8={round_uint8}: "
                f"shape {tuple(got.shape)}, bitwise equal {same}")
            if not same:
                raise AssertionError(f"fused_preproc differs from its plain version by {err}")
            worst = max(worst, err)
    return worst


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
    blocks = -(-oh // fp_ops.BAND_ROWS) * planes
    log(f"  fused_preproc per batch ({planes} planes {h}x{w}, crop {ch}x{cw} -> {oh}x{ow}; "
        f"{blocks} blocks of {fp_ops.BAND_ROWS} rows): kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
        f"F.interpolate + affine (two calls) {library:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / kernel:.1%} of it, {(planes * ch * cw * 4 + out_bytes) / kernel / 1e9:.3f} TB/s")
    return {
        "name": "fused_preproc",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_preproc.cu",
        "replaces": "src/repro/kernels/fused_preproc/fused_preproc.py:51",
        "ms": kernel,
        "plain_ms": plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library,
    }


# ------------------------------------------------------------ phase 2: K3
def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)


def _attn_bound(got: torch.Tensor, want: torch.Tensor, dt: torch.dtype) -> tuple[float, bool, str]:
    """(max |kernel - plain|, every element inside its bound, the bound)."""
    d = (got.float() - want.float()).abs()
    if dt == torch.float32:
        return d.max().item(), bool((d <= ATTN_F32_ATOL).all()), f"{ATTN_F32_ATOL}"
    bound = ATTN_BF16_RTOL * want.float().abs() + ATTN_BF16_ATOL
    return d.max().item(), bool((d <= bound).all()), f"2^-7 |plain| + {ATTN_BF16_ATOL}"


def check_flash_attention(dev) -> dict:
    """K3 against its plain version: head_dim 256 (MQA, the Gemma3 prefill
    shape 4 x 2048, window and none, in f32 and bf16) and 128/64 (GQA),
    ragged S, causal and not; for the bf16 tensor-core kernel also the
    edges of its 128-row query and 64-key tiles (S = 1, 63, 65, 127, 129,
    2049), windows that end inside a tile (64, 100), groups 1/4/8, D
    64/128/256, causal off, and q/k/v as (B, H, S, D) views; K and V
    expanded (stride 0) over the batch or the KV heads; then the MLA
    instance, q/k 192 and v 128: DeepSeek-V2's prefill shape (4 x 1024, 128
    heads, group 1, causal) in bf16 and f32, OLMoE's (16 heads of 128),
    and ragged and edge cases: S where the 3-stage ring and the tiles wrap
    (193, 257, 1025), a window ending inside a tile, more (batch, head)
    pairs than SMs at groups 1 and 2 (tile groups that end inside a batch
    row), v as a view of a wider (k_nope | v) product as the model passes
    it and once contiguous; the work-tile counters are back at 0 after all
    the launches.  Returns the largest |kernel - plain|
    over the f32 cases per instance family ("flash_attention": D = DV,
    "flash_attention_mla": 192/128; the bf16 ones are held to their own
    bound)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain

    rng = np.random.default_rng(SEED + 2)
    cases = [  # B, S, H, KVH, D, causal, window, dtype
        (PREFILL_B, PREFILL_S, 4, 1, 256, True, GEMMA_WINDOW, torch.float32),
        (PREFILL_B, PREFILL_S, 4, 1, 256, True, None, torch.float32),
        (PREFILL_B, PREFILL_S, 4, 1, 256, True, GEMMA_WINDOW, torch.bfloat16),
        (PREFILL_B, PREFILL_S, 4, 1, 256, True, None, torch.bfloat16),
        (2, 777, 4, 1, 256, True, 100, torch.float32),
        (2, 777, 4, 1, 256, True, None, torch.float32),
        (1, 300, 16, 8, 128, True, None, torch.float32),
        (1, 300, 16, 8, 128, True, 64, torch.bfloat16),
        (2, 200, 4, 2, 64, False, None, torch.float32),
        (1, 65, 2, 1, 128, False, 16, torch.bfloat16),
        # the bf16 kernel's tile edges
        (1, 1, 4, 1, 256, True, None, torch.bfloat16),
        (2, 63, 4, 1, 256, True, None, torch.bfloat16),
        (2, 65, 4, 1, 256, True, GEMMA_WINDOW, torch.bfloat16),
        (1, 127, 4, 1, 256, True, None, torch.bfloat16),
        (1, 129, 4, 1, 256, True, 64, torch.bfloat16),
        (1, 2049, 4, 1, 256, True, None, torch.bfloat16),
        (1, 2049, 4, 1, 256, True, GEMMA_WINDOW, torch.bfloat16),
        (2, 300, 4, 1, 256, True, 64, torch.bfloat16),
        (2, 300, 4, 1, 256, True, 100, torch.bfloat16),
        (1, 300, 2, 2, 128, True, None, torch.bfloat16),  # group 1
        (1, 300, 8, 1, 64, True, 100, torch.bfloat16),  # group 8
        (1, 300, 48, 8, 128, True, None, torch.bfloat16),  # group 6 (internvl2-26b, internlm2-20b)
        (1, 300, 64, 8, 128, True, None, torch.bfloat16),  # group 8 at D 128 (qwen3-32b)
        (1, 1500, 20, 20, 64, False, None, torch.bfloat16),  # whisper's encoder
        (1, 200, 4, 1, 64, False, None, torch.bfloat16),
        (1, 200, 4, 2, 128, False, 100, torch.bfloat16),
        (1, 129, 4, 1, 256, False, None, torch.bfloat16),
    ]
    worst = 0.0
    for i, (b, s, h, kvh, d, causal, window, dt) in enumerate(cases):
        if i == len(cases) - 1:  # (B, H, S, D) tensors read through (B, S, H, D) views
            q, k, v = (_randn(rng, (b, n, s, d), dt, dev).transpose(1, 2) for n in (h, kvh, kvh))
        else:
            q, k, v = (_randn(rng, (b, s, n, d), dt, dev) for n in (h, kvh, kvh))
        got = fa_ops.flash_attention_bshd(q, k, v, causal=causal, window=window)
        want = fa_plain.flash_attention_bshd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err, inside, tol = _attn_bound(got, want, dt)
        log(f"  flash_attention B={b} S={s} H={h} KVH={kvh} D={d} causal={causal} "
            f"window={window} {str(dt)[6:]}: max|kernel-plain|={err:.3e} (bound {tol})")
        if not (got.dtype == dt and got.shape == q.shape and inside):
            raise AssertionError(f"flash_attention disagrees with its plain version: {err}, bound {tol}")
        if dt == torch.float32:
            worst = max(worst, err)

    # K and V expanded (a dimension of stride 0) over the batch and over the
    # KV heads: the bf16 kernel hands the stride to TMA as it is
    expanded = (("batch", (2, 300, 8, 2, 64, torch.bfloat16)), ("KV heads", (2, 300, 8, 4, 128, torch.bfloat16)),
                ("batch", (2, 300, 8, 2, 64, torch.float32)))
    for what, (b, s, h, kvh, d, dt) in expanded:
        q = _randn(rng, (b, s, h, d), dt, dev)
        one = (1, s, kvh, d) if what == "batch" else (b, s, 1, d)
        k, v = (_randn(rng, one, dt, dev).expand(b, s, kvh, d) for _ in range(2))
        got = fa_ops.flash_attention_bshd(q, k, v)
        want = fa_plain.flash_attention_bshd(q, k, v)
        torch.cuda.synchronize()
        err, inside, tol = _attn_bound(got, want, dt)
        log(f"  flash_attention B={b} S={s} H={h} KVH={kvh} D={d} causal=True, K and V expanded over the {what} "
            f"(strides {k.stride()}) {str(dt)[6:]}: max|kernel-plain|={err:.3e} (bound {tol})")
        if not (got.dtype == dt and got.shape == q.shape and inside):
            raise AssertionError(f"flash_attention over an expanded K/V disagrees with its plain version: {err}")
        if dt == torch.float32:
            worst = max(worst, err)

    dqk, dv = MLA_DIMS
    b4, s4 = MOE_PREFILL_B, MOE_PREFILL_S
    mla_cases = [  # B, S, H, KVH, causal, window, dtype (q/k 192, v 128)
        (b4, s4, 128, 128, True, None, torch.bfloat16),  # DeepSeek-V2's prefill
        (b4, s4, 128, 128, True, None, torch.float32),
        (1, 1, 4, 4, True, None, torch.bfloat16),
        (2, 63, 4, 4, True, None, torch.bfloat16),
        (2, 300, 8, 8, True, None, torch.bfloat16),
        (2, 300, 8, 8, True, None, torch.float32),
        (1, 129, 4, 2, True, 64, torch.bfloat16),  # group 2, a window
        (1, 777, 4, 4, True, 100, torch.float32),
        (1, 200, 4, 4, False, None, torch.bfloat16),
        (1, 2049, 2, 2, True, None, torch.bfloat16),  # the plain version's blockwise branch
        # the 3-stage ring and the 64-key tiles wrap at these S
        (2, 193, 4, 4, True, None, torch.bfloat16),
        (1, 257, 4, 2, True, None, torch.bfloat16),
        (1, 1025, 8, 8, True, None, torch.bfloat16),
        (1, 1025, 4, 4, True, 100, torch.bfloat16),  # a window ending inside a tile
        # more (batch, head) pairs than SMs: tile groups end inside a batch row
        (1, 300, 136, 136, True, None, torch.bfloat16),
        (2, 300, 136, 68, True, 100, torch.bfloat16),  # group 2
    ]
    worst_mla = 0.0
    for i, (b, s, h, kvh, causal, window, dt) in enumerate(mla_cases):
        q, k = (_randn(rng, (b, s, n, dqk), dt, dev) for n in (h, kvh))
        v = _randn(rng, (b, s, kvh, 128 + dv), dt, dev)[..., 128:]  # the model's (k_nope | v) split
        if i == len(mla_cases) - 1:
            v = v.contiguous()  # and once a tensor of its own
        got = fa_ops.flash_attention_bshd(q, k, v, causal=causal, window=window, scale=dqk**-0.5)
        want = fa_plain.flash_attention_bshd(q, k, v, causal=causal, window=window, scale=dqk**-0.5)
        torch.cuda.synchronize()
        err, inside, tol = _attn_bound(got, want, dt)
        log(f"  flash_attention (MLA) B={b} S={s} H={h} KVH={kvh} D={dqk}/{dv} causal={causal} "
            f"window={window} {str(dt)[6:]}: max|kernel-plain|={err:.3e} (bound {tol})")
        if not (got.dtype == dt and got.shape == (b, s, h, dv) and inside):
            raise AssertionError(f"flash_attention (192/128) disagrees with its plain version: {err}, "
                                 f"bound {tol}")
        if dt == torch.float32:
            worst_mla = max(worst_mla, err)
    _expect_zero_counters("flash_attention", f"after {len(cases) + len(expanded) + len(mla_cases)} launches")
    return {"flash_attention": worst, "flash_attention_mla": worst_mla}


def time_flash_attention_mla(dev, flush) -> dict:
    """K3's MLA instance (q/k 192, v 128) at DeepSeek-V2's prefill shape:
    4 prompts x 1024 tokens, 128 heads, group 1, causal, bf16 — one launch
    per layer, 4 layers (1 dense + 3 MoE) per prefill.  The library
    yardstick is SDPA with ``is_causal=True`` (the backend that ran is
    logged); the (256, 256) instance on zero-padded copies is logged as a
    yardstick of what padding would cost."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain

    rng = np.random.default_rng(SEED + 8)
    dqk, dv = MLA_DIMS
    b, s, h, dt = MOE_PREFILL_B, MOE_PREFILL_S, 128, torch.bfloat16
    q, k = (_randn(rng, (b, s, h, dqk), dt, dev) for _ in range(2))
    v = _randn(rng, (b, s, h, 128 + dv), dt, dev)[..., 128:]
    scale = dqk**-0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kernel = median_ms(lambda: fa_ops.flash_attention_bshd(q, k, v, scale=scale), flush)
    plain = median_ms(lambda: fa_plain.flash_attention_bshd(q, k, v, scale=scale), flush, iters=5, warmup=1)
    library = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale),
                        flush)
    pad = lambda x: F.pad(x, (0, 256 - x.shape[-1]))  # noqa: E731
    qp, kp, vp = pad(q), pad(k), pad(v)
    padded = median_ms(lambda: fa_ops.flash_attention_bshd(qp, kp, vp, scale=scale), flush)
    pairs = attention_pairs(s, True, None) * b * h
    flops = 2.0 * (dqk + dv) * pairs
    nbytes = b * s * h * (2 * dqk + 2 * dv) * 2  # q, k, v, out once, bf16
    layer_bound, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    log(f"  flash_attention MLA layer ({b}x{s}, {h} heads, q/k {dqk} v {dv}, causal, bf16): kernel "
        f"{kernel:.4f} ms ({layer_bound / kernel:.1%} of its {layer_bound:.4f} ms bound, {by}), plain "
        f"{plain:.4f} ms, SDPA is_causal {library:.4f} ms ({_sdpa_backend(qt, kt, vt, None, True)}); "
        f"yardstick: the (256, 256) instance on zero-padded copies {padded:.4f} ms")
    n = DEEPSEEK_LAYERS
    b_ms, b_by = bound_ms(n * nbytes, n * flops, PEAK_BF16_FLOPS)
    return {
        "name": "flash_attention_mla",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:99",
        "ms": n * kernel,
        "plain_ms": n * plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": n * library,
    }


def check_flash_attention_cross(dev) -> float:
    """K3 with a key length other than the query length: whisper's cross
    attention (20 heads of 64, group 1, non-causal) at its prefill shape
    (4 x 224 decoder rows over 1500 encoder frames) and at ragged Sq (1, 63,
    129, 224) x Sk (1, 100, 1500), in f32 and bf16; then GQA groups 4 and
    6, causal (both positions from 0: ``kpos <= qpos``) with Sk below and
    above Sq, and a window.  Sk 1500 takes the plain version's blockwise
    branch (Sk > 1024).  Returns the largest |kernel - plain| over the f32
    cases."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain

    rng = np.random.default_rng(SEED + 10)
    h, d = WHISPER_HEADS, WHISPER_HD
    cases = [(WHISPER_B, WHISPER_PROMPT, WHISPER_FRAMES, h, h, d, False, None, dt)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(2, sq, sk, h, h, d, False, None, dt) for dt in (torch.float32, torch.bfloat16)
              for sq in (1, 63, 129, 224) for sk in (1, 100, WHISPER_FRAMES)]
    cases += [  # B, Sq, Sk, H, KVH, D, causal, window, dtype
        (1, 130, 1500, 8, 2, 128, False, None, torch.bfloat16),
        (1, 130, 300, 48, 8, 128, False, None, torch.bfloat16),  # group 6
        (1, 300, 130, 8, 2, 128, True, None, torch.bfloat16),  # causal, Sk < Sq
        (1, 130, 300, 8, 2, 128, True, None, torch.bfloat16),  # causal, Sk > Sq
        (1, 300, 130, 4, 1, 64, True, None, torch.float32),
        (1, 200, 1100, 4, 4, 64, True, 64, torch.bfloat16),
        (1, 200, 1100, 4, 4, 64, True, 64, torch.float32),
    ]
    worst = 0.0
    for b, sq, sk, h_, kvh, d_, causal, window, dt in cases:
        q = _randn(rng, (b, sq, h_, d_), dt, dev)
        k, v = (_randn(rng, (b, sk, kvh, d_), dt, dev) for _ in range(2))
        got = fa_ops.flash_attention_bshd(q, k, v, causal=causal, window=window)
        want = fa_plain.flash_attention_bshd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err, inside, tol = _attn_bound(got, want, dt)
        log(f"  flash_attention (cross) B={b} Sq={sq} Sk={sk} H={h_} KVH={kvh} D={d_} causal={causal} "
            f"window={window} {str(dt)[6:]}: max|kernel-plain|={err:.3e} (bound {tol})")
        if not (got.dtype == dt and got.shape == q.shape and inside):
            raise AssertionError(f"flash_attention (Sk != Sq) disagrees with its plain version: {err}, "
                                 f"bound {tol}")
        if dt == torch.float32:
            worst = max(worst, err)
    _expect_zero_counters("flash_attention", f"after {len(cases)} cross launches")
    return worst


def time_flash_attention_cross(dev, flush) -> dict:
    """K3's cross attention at whisper-large-v3's prefill: 4 x 224 decoder
    rows over 1500 encoder frames, 20 heads of 64, non-causal, bf16 — one
    launch per decoder layer, 32 per prefill.  The library yardstick is
    SDPA with no mask (the backend that ran is logged).  Also K4 over
    whisper's cross cache (4 sequences, every one of the 1500 keys valid):
    logged beside its bytes bound and SDPA, one launch per decoder layer
    and decode step."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import plain as da_plain
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain

    rng = np.random.default_rng(SEED + 11)
    b, sq, sk, h, d, dt = WHISPER_B, WHISPER_PROMPT, WHISPER_FRAMES, WHISPER_HEADS, WHISPER_HD, torch.bfloat16
    q = _randn(rng, (b, sq, h, d), dt, dev)
    k, v = (_randn(rng, (b, sk, h, d), dt, dev) for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kernel = median_ms(lambda: fa_ops.flash_attention_bshd(q, k, v, causal=False), flush)
    plain = median_ms(lambda: fa_plain.flash_attention_bshd(q, k, v, causal=False), flush, iters=5, warmup=1)
    library = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), flush)
    nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * 2  # q, out, k, v once, bf16
    flops = 4.0 * d * sq * sk * b * h
    layer_bound, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    log(f"  flash_attention cross layer (whisper: {b}x{sq} rows over {sk} frames, {h} heads of {d}, "
        f"non-causal, bf16): kernel {kernel:.4f} ms ({layer_bound / kernel:.1%} of its {layer_bound:.4f} ms "
        f"bound, {by}), plain {plain:.4f} ms, SDPA no mask {library:.4f} ms "
        f"({_sdpa_backend(qt, kt, vt, None, False)})")
    n = 32  # decoder layers of whisper-large-v3
    b_ms, b_by = bound_ms(n * nbytes, n * flops, PEAK_BF16_FLOPS)
    # K4 over the cross cache: one query token per sequence, all 1500 keys valid
    qd = _randn(rng, (b, h, d), dt, dev)
    kc, vc = (_randn(rng, (b, sk, h, d), dt, dev) for _ in range(2))
    lens = torch.full((b,), sk, dtype=torch.int32, device=dev)
    k4 = median_ms(lambda: da_ops.decode_attention_cache(qd, kc, vc, lens), flush)
    k4_plain = median_ms(lambda: da_plain.decode_attention(qd, kc, vc, lens), flush)
    k4_lib = median_ms(lambda: F.scaled_dot_product_attention(qd[:, :, None], kc.transpose(1, 2),
                                                              vc.transpose(1, 2)), flush)
    k4_bound, k4_by = bound_ms(h * b * sk * d * 2 * 2 + 2 * b * h * d * 2 + b * 4, 4.0 * h * d * b * sk,
                               PEAK_BF16_FLOPS)
    log(f"  decode_attention cross layer (whisper: {b} seqs over {sk} frames, {h} heads of {d}, bf16): "
        f"kernel {k4:.4f} ms ({k4_bound / k4:.1%} of its {k4_bound:.4f} ms bound, {k4_by}), plain "
        f"{k4_plain:.4f} ms, SDPA no mask {k4_lib:.4f} ms")
    return {
        "name": "flash_attention_cross",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:99",
        "ms": n * kernel,
        "plain_ms": n * plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": n * library,
    }


def attention_pairs(s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask lets through: what attention must compute."""
    qpos = np.arange(s)
    hi = qpos + 1 if causal else np.full(s, s)
    lo = np.maximum(0, qpos - window + 1) if window is not None else np.zeros(s, np.int64)
    return int((hi - lo).sum())


def _sdpa_backend(q, k, v, mask, causal: bool) -> str:
    """The backend SDPA picks for these inputs (logged beside its time)."""
    from torch.nn.attention import SDPBackend

    try:
        choice = torch._fused_sdp_choice(q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True)
    except (AttributeError, TypeError, RuntimeError) as e:  # a private API: log, never fail on it
        return f"unknown ({type(e).__name__})"
    return SDPBackend(choice).name


def time_flash_attention(dev, flush) -> dict:
    """One Gemma3-1B prefill's K3 launches (4 prompts x 2048 tokens, D 256,
    4 query heads over 1 KV head, bf16): 4 global layers + 22 local
    (window 512), each shape timed alone and summed.  The library
    yardstick is SDPA's faster form: with the explicit mask, and for the
    global layers also ``is_causal=True`` (no mask: PyTorch may pick its
    flash backend)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain

    rng = np.random.default_rng(SEED + 3)
    b, s, h, kvh, d, dt = PREFILL_B, PREFILL_S, 4, 1, 256, torch.bfloat16
    q, k, v = (_randn(rng, (b, s, n, d), dt, dev) for n in (h, kvh, kvh))
    # SDPA's (B, H, S, D) layout, made once outside the timed calls
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pos = torch.arange(s, device=dev)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0)
    for window, n_layers in ((None, N_GLOBAL), (GEMMA_WINDOW, N_LOCAL)):
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[None, :] > pos[:, None] - window
        kernel = median_ms(lambda: fa_ops.flash_attention_bshd(q, k, v, window=window), flush)
        plain = median_ms(lambda: fa_plain.flash_attention_bshd(q, k, v, window=window), flush,
                          iters=5, warmup=1)
        library = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush)
        forms = f"SDPA with mask {library:.4f} ms ({_sdpa_backend(qt, kt, vt, mask, False)})"
        if window is None:
            causal_ms = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush)
            forms += f", is_causal {causal_ms:.4f} ms ({_sdpa_backend(qt, kt, vt, None, True)})"
            library = min(library, causal_ms)
        log(f"  flash_attention {'global' if window is None else f'local (window {window})'} "
            f"layer ({b}x{s}, D {d}, bf16): kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
            f"{forms}")
        totals["ms"] += n_layers * kernel
        totals["plain_ms"] += n_layers * plain
        totals["library_ms"] += n_layers * library
        totals["flops"] += n_layers * 4.0 * d * attention_pairs(s, True, window) * b * h
    nbytes = (N_GLOBAL + N_LOCAL) * (2 * b * s * h * d + 2 * b * s * kvh * d) * 2
    b_ms, b_by = bound_ms(nbytes, totals["flops"], PEAK_BF16_FLOPS)
    log(f"  flash_attention per prefill ({N_GLOBAL} global + {N_LOCAL} local launches): "
        f"kernel {totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, SDPA (faster form) "
        f"{totals['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, bf16 peak)")
    # OLMoE's prefill layer (16 heads of 128, group 1), logged: the same instance family
    b, s, h, d = MOE_PREFILL_B, MOE_PREFILL_S, OLMOE_HEADS, OLMOE_HD
    q, k, v = (_randn(rng, (b, s, h, d), dt, dev) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    olmoe = median_ms(lambda: fa_ops.flash_attention_bshd(q, k, v), flush)
    plain = median_ms(lambda: fa_plain.flash_attention_bshd(q, k, v), flush, iters=5, warmup=1)
    library = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), flush)
    layer_bound, by = bound_ms(b * s * h * 4 * d * 2, 4.0 * d * attention_pairs(s, True, None) * b * h,
                               PEAK_BF16_FLOPS)
    log(f"  flash_attention OLMoE layer ({b}x{s}, {h} heads of {d}, causal, bf16): kernel "
        f"{olmoe:.4f} ms ({layer_bound / olmoe:.1%} of its {layer_bound:.4f} ms bound, {by}), plain "
        f"{plain:.4f} ms, SDPA is_causal {library:.4f} ms ({_sdpa_backend(qt, kt, vt, None, True)})")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:99",
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": totals["library_ms"],
    }


def check_flash_attention_lse(dev) -> float:
    """K3's row log-sum-exp (base 2, the backward's input) against the
    plain version's: both kernels (bf16 tensor-core, f32 SIMT) at the
    training shape (4 x 1024, D 256, 4 heads over 1, causal, window 512 and
    none), and ragged, GQA, D 64/128/192-128 and Sk != Sq cases; the output
    is held to the plain one as in :func:`check_flash_attention`.  Returns
    the largest |lse - plain lse|."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain

    rng = np.random.default_rng(SEED + 12)
    cases = [  # B, Sq, Sk, H, KVH, D, DV, causal, window, dtype
        (TRAIN_B, TRAIN_S, TRAIN_S, 4, 1, 256, 256, True, None, torch.bfloat16),
        (TRAIN_B, TRAIN_S, TRAIN_S, 4, 1, 256, 256, True, GEMMA_WINDOW, torch.bfloat16),
        (2, 777, 777, 4, 1, 256, 256, True, 100, torch.float32),
        (1, 300, 300, 8, 2, 128, 128, True, None, torch.bfloat16),
        (1, 129, 129, 4, 4, 64, 64, False, None, torch.float32),
        (1, 130, 300, 4, 4, 64, 64, False, None, torch.bfloat16),
        (1, 257, 257, 4, 4, 192, 128, True, None, torch.bfloat16),
    ]
    worst = 0.0
    for b, sq, sk, h, kvh, d, dv, causal, window, dt in cases:
        q = _randn(rng, (b, sq, h, d), dt, dev)
        k, v = _randn(rng, (b, sk, kvh, d), dt, dev), _randn(rng, (b, sk, kvh, dv), dt, dev)
        got, lse = fa_ops._forward(q, k, v, causal, window, d**-0.5, with_lse=True)
        want, want_lse = fa_plain.flash_attention_bshd(q, k, v, causal=causal, window=window, return_lse=True)
        torch.cuda.synchronize()
        err = (lse - want_lse).abs().max().item()
        out_err, inside, tol = _attn_bound(got, want, dt)
        log(f"  flash_attention lse B={b} Sq={sq} Sk={sk} H={h} KVH={kvh} D={d}/{dv} causal={causal} "
            f"window={window} {str(dt)[6:]}: max|lse-plain|={err:.3e} (atol {LSE_ATOL}), "
            f"max|out-plain|={out_err:.3e} (bound {tol})")
        if not (lse.shape == (b, h, sq) and err <= LSE_ATOL and inside):
            raise AssertionError(f"flash_attention's lse disagrees with the plain one: {err} / {out_err}")
        worst = max(worst, err)
    _expect_zero_counters("flash_attention", f"after {len(cases)} launches with lse")
    return worst


def _bwd_inputs(rng, b, sq, sk, h, kvh, d, dv, causal, window, dt, dev):
    """q, k, v, dO and the plain forward's (out, lse) for them: the inputs
    both backward versions take (q and k D wide, v and dO DV wide)."""
    from repro_torch.kernels.flash_attention import plain as fa_plain

    q = _randn(rng, (b, sq, h, d), dt, dev)
    k, v = _randn(rng, (b, sk, kvh, d), dt, dev), _randn(rng, (b, sk, kvh, dv), dt, dev)
    do = _randn(rng, (b, sq, h, dv), dt, dev)
    out, lse = fa_plain.flash_attention_bshd(q, k, v, causal=causal, window=window, return_lse=True)
    return q, k, v, out, lse, do


def check_flash_attention_bwd(dev) -> float:
    """K3's backward (dQ kernel, then dK/dV kernel; bf16 with GQA also the
    group sum) against the plain backward on the same (q, k, v, out, lse,
    dO): Gemma3-1B's training layers (4 x 1024, 4 heads over 1 of 256,
    causal, global and window 512) in bf16 and f32, then ragged S (1, 33,
    777), GQA groups 2 and 4, D 64 and 128, non-causal, Sk != Sq, a window
    that ends inside a tile, and DeepSeek-V2's MLA layer (1 x 1024, 128
    heads of q/k 192 and v 128, group 1, causal) in bf16 and f32.  dq, dk
    and dv each within BWD_BF16_RTOL (bf16) or BWD_F32_RTOL (f32) of their
    largest |plain| value, plus BWD_ATOL, elementwise.  Then two launches
    on Gemma's global layer give bitwise-equal dq, dk and dv (no atomics).
    Returns the largest relative error over the f32 cases."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain

    rng = np.random.default_rng(SEED + 13)
    cases = [  # B, Sq, Sk, H, KVH, D, DV, causal, window, dtype
        (TRAIN_B, TRAIN_S, TRAIN_S, 4, 1, 256, 256, True, None, torch.bfloat16),
        (TRAIN_B, TRAIN_S, TRAIN_S, 4, 1, 256, 256, True, GEMMA_WINDOW, torch.bfloat16),
        (TRAIN_B, TRAIN_S, TRAIN_S, 4, 1, 256, 256, True, GEMMA_WINDOW, torch.float32),
        (1, TRAIN_S, TRAIN_S, 4, 1, 256, 256, True, None, torch.float32),
        (1, 1, 1, 4, 1, 256, 256, True, None, torch.bfloat16),
        (2, 33, 33, 4, 1, 256, 256, True, None, torch.bfloat16),
        (2, 777, 777, 4, 1, 256, 256, True, 100, torch.bfloat16),
        (1, 300, 300, 8, 2, 128, 128, True, None, torch.bfloat16),
        (1, 300, 300, 8, 2, 128, 128, True, 64, torch.float32),
        (1, 200, 200, 4, 1, 64, 64, False, None, torch.bfloat16),
        (1, 130, 300, 4, 4, 64, 64, False, None, torch.bfloat16),  # cross attention
        (1, 300, 130, 8, 2, 64, 64, True, None, torch.float32),  # causal, Sk < Sq
        (1, MOE_PREFILL_S, MOE_PREFILL_S, MLA_HEADS, MLA_HEADS, *MLA_DIMS, True, None, torch.bfloat16),
        (1, MOE_PREFILL_S, MOE_PREFILL_S, MLA_HEADS, MLA_HEADS, *MLA_DIMS, True, None, torch.float32),
    ]
    worst = 0.0
    for b, sq, sk, h, kvh, d, dv, causal, window, dt in cases:
        q, k, v, out, lse, do = _bwd_inputs(rng, b, sq, sk, h, kvh, d, dv, causal, window, dt, dev)
        got = fa_ops.flash_attention_bwd_bshd(q, k, v, out, lse, do, causal=causal, window=window)
        want = fa_plain.flash_attention_bwd_bshd(q, k, v, out, lse, do, causal=causal, window=window)
        torch.cuda.synchronize()
        rtol = BWD_F32_RTOL if dt == torch.float32 else BWD_BF16_RTOL
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            scale = w.float().abs().max().item()
            diff = (g.float() - w.float()).abs()
            err = diff.max().item() / max(scale, 1e-30)
            if not (g.dtype == dt and g.shape == w.shape and bool(torch.isfinite(g.float()).all())
                    and bool((diff <= rtol * scale + BWD_ATOL).all())):
                raise AssertionError(f"flash_attention_bwd {name} disagrees with its plain version: {err:.3e} "
                                     f"of max|plain| {scale:.3e} (bound {rtol:g} + {BWD_ATOL:g}), B={b} Sq={sq} "
                                     f"Sk={sk} H={h} KVH={kvh} D={d}/{dv} causal={causal} window={window} {dt}")
            errs.append(err)
        log(f"  flash_attention_bwd B={b} Sq={sq} Sk={sk} H={h} KVH={kvh} D={d}/{dv} causal={causal} "
            f"window={window} {str(dt)[6:]}: max|kernel-plain|/max|plain| dq {errs[0]:.2e} dk {errs[1]:.2e} "
            f"dv {errs[2]:.2e} (bound {rtol:g} of max|plain| + {BWD_ATOL:g})")
        if dt == torch.float32:
            worst = max(worst, *errs)
        del q, k, v, out, lse, do, got, want
    b, s, _, h, kvh, d, _, causal, window, dt = cases[0]
    q, k, v, out, lse, do = _bwd_inputs(rng, b, s, s, h, kvh, d, d, causal, window, dt, dev)
    first, second = (fa_ops.flash_attention_bwd_bshd(q, k, v, out, lse, do, causal=causal, window=window)
                     for _ in range(2))
    same = [bool(torch.equal(x, y)) for x, y in zip(first, second)]
    log(f"  flash_attention_bwd twice on the global layer ({b}x{s}, bf16): dq, dk, dv bitwise equal {same}")
    if not all(same):
        raise AssertionError(f"flash_attention_bwd is not the same from run to run: {same}")
    fa_ops.flash_attention_bwd_bshd.launches = 0
    return worst


def _bwd_layer_ms(q, k, v, out, lse, do, window, flush, mask=None) -> tuple:
    """(kernel, plain, SDPA backward) ms of one layer's backward.  SDPA's
    backward alone: ``torch.autograd.grad`` on a graph kept from one
    forward, ``is_causal`` without a mask, else the explicit mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain

    kernel = median_ms(lambda: fa_ops.flash_attention_bwd_bshd(q, k, v, out, lse, do, window=window), flush)
    plain = median_ms(lambda: fa_plain.flash_attention_bwd_bshd(q, k, v, out, lse, do, window=window),
                      flush, iters=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if mask is None:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=gqa)
    else:
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=gqa)
    dot = do.transpose(1, 2).contiguous()
    library = median_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), flush)
    backend = _sdpa_backend(qt.detach(), kt.detach(), vt.detach(), mask, mask is None)
    return kernel, plain, library, backend


def time_flash_attention_bwd(dev, flush) -> dict:
    """One Gemma3-1B training step's K3 backward launches (4 x 1024 tokens,
    D 256, 4 heads over 1, bf16): 4 global + 22 local (window 512) layers,
    each shape timed alone (every kernel of one call together) and summed.
    The bound is the larger of the operations, 5 products of 2 D flops
    over the masked pairs at the bf16 tensor-core peak, and the bytes, q,
    k, v, out, dO and lse read and dq, dk, dv written once.  The library
    yardstick is SDPA's backward (:func:`_bwd_layer_ms`), ``is_causal``
    for the global layer and the explicit mask for the local one (the
    backend that ran is logged).  Then DeepSeek-V2's MLA layer (4 x 1024,
    128 heads, q/k 192, v 128, causal), logged beside SDPA ``is_causal``:
    DeepSeek-V2 is not trained on the card, so it is not in the step."""
    rng = np.random.default_rng(SEED + 14)
    b, s, h, kvh, d, dt = TRAIN_B, TRAIN_S, 4, 1, 256, torch.bfloat16
    pos = torch.arange(s, device=dev)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0)
    for window, n_layers in ((None, N_GLOBAL), (GEMMA_WINDOW, N_LOCAL)):
        q, k, v, out, lse, do = _bwd_inputs(rng, b, s, s, h, kvh, d, d, True, window, dt, dev)
        mask = None if window is None else (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        kernel, plain, library, backend = _bwd_layer_ms(q, k, v, out, lse, do, window, flush, mask)
        pairs = attention_pairs(s, True, window) * b * h
        layer_bound, by = bound_ms(b * s * (4 * h + 4 * kvh) * d * 2 + b * h * s * 4, 10.0 * d * pairs,
                                   PEAK_BF16_FLOPS)
        log(f"  flash_attention_bwd {'global' if window is None else f'local (window {window})'} layer "
            f"({b}x{s}, D {d}, bf16): kernel {kernel:.4f} ms ({layer_bound / kernel:.1%} of its "
            f"{layer_bound:.4f} ms bound, {by}), plain {plain:.4f} ms, SDPA backward {library:.4f} ms "
            f"({backend})")
        totals["ms"] += n_layers * kernel
        totals["plain_ms"] += n_layers * plain
        totals["library_ms"] += n_layers * library
        totals["flops"] += n_layers * 10.0 * d * pairs
        del q, k, v, out, lse, do
    nbytes = (N_GLOBAL + N_LOCAL) * (b * s * (4 * h + 4 * kvh) * d * 2 + b * h * s * 4)
    b_ms, b_by = bound_ms(nbytes, totals["flops"], PEAK_BF16_FLOPS)
    log(f"  flash_attention_bwd per step ({N_GLOBAL} global + {N_LOCAL} local launches): kernel "
        f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, SDPA backward {totals['library_ms']:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}, bf16 peak)")
    (dqk, dv), b, s, h = MLA_DIMS, MOE_PREFILL_B, MOE_PREFILL_S, MLA_HEADS
    q, k, v, out, lse, do = _bwd_inputs(rng, b, s, s, h, h, dqk, dv, True, None, dt, dev)
    kernel, plain, library, backend = _bwd_layer_ms(q, k, v, out, lse, do, None, flush)
    pairs = attention_pairs(s, True, None) * b * h
    mla_bound, by = bound_ms(b * s * h * (4 * dqk + 4 * dv) * 2 + b * h * s * 4,
                             2.0 * (3 * dqk + 2 * dv) * pairs, PEAK_BF16_FLOPS)
    log(f"  flash_attention_bwd MLA layer ({b}x{s}, {h} heads, q/k {dqk} v {dv}, causal, bf16): kernel "
        f"{kernel:.4f} ms ({mla_bound / kernel:.1%} of its {mla_bound:.4f} ms bound, {by}), plain {plain:.4f} "
        f"ms, SDPA backward {library:.4f} ms ({backend})")
    del q, k, v, out, lse, do
    from repro_torch.kernels.flash_attention import ops as fa_ops

    fa_ops.flash_attention_bwd_bshd.launches = 0
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:86",
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": totals["library_ms"],
    }


# ------------------------------------------------------------ phase 2: K4
def _lengths(rng, b: int, s: int, dev) -> torch.Tensor:
    """Ragged lengths with the edge cases: 1 key, a full cache, and one past
    it (an idle serving slot keeps counting)."""
    lens = rng.integers(1, s + 1, size=b)
    lens[0] = 1
    if b > 2:
        lens[1], lens[2] = s, s + 5
    return torch.from_numpy(lens.astype(np.int32)).to(dev)


def check_decode_attention(dev) -> float:
    """K4 against its plain version on layer slices of a stacked cache (so
    through strides): head_dim 256 (MQA, the Gemma3 decode shape 4 x 2112
    with q in f32 and bf16, the decode phase's lengths 2048..2060, and the
    serve shape) and 128/64 (GQA, up to 8 heads a group), window and none,
    ragged lengths (int32, and int64 the wrapper converts), q f32/bf16 and
    the cache f32/bf16; and sequences with no valid key (length 0, length
    >= S + window), whose rows must be the mean of the cache's S value
    rows, as the reference gives.  The per-(sequence, KV head) arrival counters must be back at 0
    after every launch."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import plain as da_plain

    rng = np.random.default_rng(SEED + 4)
    s, w = DECODE_MAX_LEN, GEMMA_WINDOW
    decode_lens = PREFILL_S + np.arange(PREFILL_B) * (DECODE_STEPS // PREFILL_B)
    cases = [  # B, S, H, KVH, D, window, q dtype, cache dtype, lengths (None: ragged)
        (PREFILL_B, s, 4, 1, 256, w, torch.float32, torch.bfloat16, None),
        (PREFILL_B, s, 4, 1, 256, None, torch.float32, torch.bfloat16, None),
        (PREFILL_B, s, 4, 1, 256, w, torch.float32, torch.float32, None),
        (PREFILL_B, s, 4, 1, 256, w, torch.bfloat16, torch.bfloat16, None),
        (PREFILL_B, s, 4, 1, 256, None, torch.bfloat16, torch.bfloat16, None),
        (PREFILL_B, s, 4, 1, 256, w, torch.bfloat16, torch.bfloat16, decode_lens),
        (PREFILL_B, s, 4, 1, 256, None, torch.bfloat16, torch.bfloat16, decode_lens),
        (SERVE_SLOTS, SERVE_MAX_LEN, 4, 1, 256, None, torch.bfloat16, torch.float32, None),
        (SERVE_SLOTS, SERVE_MAX_LEN, 4, 1, 256, 40, torch.float32, torch.float32, None),
        (5, 300, 16, 8, 128, None, torch.float32, torch.float32, None),
        (5, 300, 16, 8, 128, 64, torch.bfloat16, torch.float32, None),
        (3, 1000, 8, 1, 64, None, torch.float32, torch.bfloat16, None),
        # no valid key: length 0, and length >= S + window (an idle slot
        # counting past the cache)
        (PREFILL_B, s, 4, 1, 256, w, torch.float32, torch.bfloat16, [0, s + w, s + w + 7, 1000]),
        (PREFILL_B, s, 4, 1, 256, None, torch.float32, torch.float32, [0, s, 2055, 0]),
        (PREFILL_B, s, 4, 1, 256, w, torch.bfloat16, torch.bfloat16, [s + w, 0, 2051, 513]),
        (SERVE_SLOTS, SERVE_MAX_LEN, 4, 1, 256, 40, torch.float32, torch.float32,
         [0, SERVE_MAX_LEN + 40, 5, 296, 295, 1, 256, 0]),
        (5, 300, 16, 8, 128, 64, torch.float32, torch.float32, [364, 0, 363, 65, 300]),
        (3, 1000, 8, 1, 64, 100, torch.float32, torch.bfloat16, [0, 1100, 50]),
        # OLMoE-1B-7B (16 heads of 128, group 1): phase 4B's decode (bf16
        # cache, 1024.. keys) and serve (f32 cache, 8 slots of 256) shapes
        (MOE_PREFILL_B, MOE_MAX_LEN, OLMOE_HEADS, OLMOE_HEADS, OLMOE_HD, None, torch.bfloat16,
         torch.bfloat16, MOE_PREFILL_S + np.arange(MOE_PREFILL_B) * (DECODE_STEPS // MOE_PREFILL_B)),
        (SERVE_SLOTS, SERVE_MAX_LEN, OLMOE_HEADS, OLMOE_HEADS, OLMOE_HD, None, torch.bfloat16,
         torch.float32, None),
        (SERVE_SLOTS, SERVE_MAX_LEN, OLMOE_HEADS, OLMOE_HEADS, OLMOE_HD, None, torch.bfloat16,
         torch.float32, [0, 1, 30, 255, 256, 257, 300, 100]),
        # internvl2-26b's decode (48 heads over 8 of 128: group 6), and
        # whisper's cross cache (20 heads of 64, group 1, every key valid)
        (VLM_B, 1088, 48, 8, 128, None, torch.bfloat16, torch.bfloat16, [1024, 1028, 1032, 1036]),
        (SERVE_4C_SLOTS, SERVE_MAX_LEN, 48, 8, 128, None, torch.bfloat16, torch.float32, None),
        (WHISPER_B, WHISPER_FRAMES, WHISPER_HEADS, WHISPER_HEADS, WHISPER_HD, None, torch.bfloat16,
         torch.bfloat16, [WHISPER_FRAMES] * WHISPER_B),
        (SERVE_4C_SLOTS, WHISPER_FRAMES, WHISPER_HEADS, WHISPER_HEADS, WHISPER_HD, None, torch.bfloat16,
         torch.float32, [WHISPER_FRAMES] * SERVE_4C_SLOTS),
    ]
    worst = 0.0
    for i, (b, s_, h, kvh, d, window, qdt, cdt, lens_list) in enumerate(cases):
        q = _randn(rng, (b, h, d), qdt, dev)
        kc, vc = (_randn(rng, (2, b, s_, kvh, d), cdt, dev) for _ in range(2))
        if lens_list is None:
            lens = _lengths(rng, b, s_, dev)
        else:
            lens = torch.tensor(np.asarray(lens_list), dtype=torch.int64 if i % 2 else torch.int32,
                                device=dev)
        got = da_ops.decode_attention_cache(q, kc[1], vc[1], lens, window=window)
        want = da_plain.decode_attention(q, kc[1], vc[1], lens, window=window)
        torch.cuda.synchronize()
        err, inside, tol = _attn_bound(got, want, qdt)
        lo = (lens - window).clamp(min=0) if window is not None else torch.zeros_like(lens)
        empty = (lens.clamp(max=s_) <= lo).nonzero().flatten().tolist()
        note = ""
        if empty:  # the reference's value there: the mean of V's S rows
            mean = vc[1][empty].float().mean(1).repeat_interleave(h // kvh, dim=1)
            e_err, e_in, _ = _attn_bound(got[empty], mean.to(qdt), qdt)
            inside &= e_in
            note = f"; no valid key in sequences {empty}: max|kernel-mean(V)|={e_err:.3e}"
        log(f"  decode_attention B={b} S={s_} H={h} KVH={kvh} D={d} window={window} "
            f"q {str(qdt)[6:]} cache {str(cdt)[6:]} lengths {str(lens.dtype)[6:]}: "
            f"max|kernel-plain|={err:.3e} (bound {tol}){note}")
        if not (got.dtype == qdt and got.shape == q.shape and inside):
            raise AssertionError(f"decode_attention disagrees with its plain version: {err}, bound {tol}")
        if qdt == torch.float32:
            worst = max(worst, err)
    _expect_zero_counters("decode_attention", f"after {len(cases)} launches")
    return worst


def _expect_zero_counters(kernel: str, when: str) -> None:
    """The kernel's per-stream counters (K4's arrivals, K3's work tiles) are
    back at 0 once its launches are done, as the next launch needs them."""
    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    left = sum(int(c.count_nonzero()) for key, c in _build._counters.items() if key[0] == kernel)
    log(f"  {kernel} counters {when}: {left} non-zero")
    if left:
        raise AssertionError(f"{left} {kernel} counters were left non-zero")


def time_decode_attention(dev, flush) -> dict:
    """One Gemma3-1B decode step's K4 launches at the decode phase's shape
    (4 sequences at 2048..2060 keys in a 2112-key bf16 cache, q bf16):
    4 global layers + 22 local (window 512), each timed alone and summed.
    Per layer it prints the time beside the layer's bytes bound (its share
    of it and the bytes/s reached) and the launch floor: an empty kernel
    from the same library, on the local layer's grid, timed the same way."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import plain as da_plain

    rng = np.random.default_rng(SEED + 5)
    b, s, h, kvh, d, dt = PREFILL_B, DECODE_MAX_LEN, 4, 1, 256, torch.bfloat16
    q = _randn(rng, (b, h, d), dt, dev)
    kc, vc = (_randn(rng, (b, s, kvh, d), dt, dev) for _ in range(2))
    lens_np = PREFILL_S + np.arange(b, dtype=np.int32) * (DECODE_STEPS // b)
    lens = torch.from_numpy(lens_np).to(dev)
    qt = q[:, :, None, :]  # SDPA: (B, H, 1, D) against (B, KVH, S, D) views of the cache
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    pos = torch.arange(s, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    for window, n_layers in ((None, N_GLOBAL), (GEMMA_WINDOW, N_LOCAL)):
        mask = pos[None, :] < lens[:, None]
        if window is not None:
            mask &= pos[None, :] >= lens[:, None] - window
        mask = mask[:, None, None, :]
        kernel = median_ms(lambda: da_ops.decode_attention_cache(q, kc, vc, lens, window=window), flush)
        plain = median_ms(lambda: da_plain.decode_attention(q, kc, vc, lens, window=window), flush)
        library = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush)
        keys = np.minimum(lens_np, s) - (np.maximum(0, lens_np - window) if window else 0)
        nbytes = kvh * keys.sum() * d * 2 * 2 + 2 * b * h * d * 2 + b * 4
        flops = 4.0 * h * d * keys.sum()
        layer_bound, _ = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        chunk, n_split = da_ops.split_plan(b * kvh, s, window, d, 2, n_sm)
        line = (f"  decode_attention {'global' if window is None else f'local (window {window})'} "
                f"layer ({b} seqs, cache {s}, D {d}, bf16; {n_split} chunks of {chunk} keys x "
                f"{b * kvh} = {n_split * b * kvh} blocks, one launch): kernel {kernel:.4f} ms, plain "
                f"{plain:.4f} ms, SDPA {library:.4f} ms; bytes bound {layer_bound:.4f} ms, "
                f"{layer_bound / kernel:.1%} of it, {nbytes / kernel / 1e9:.3f} TB/s")
        if window is not None:
            lib = _build.load_library()

            def empty():
                status = lib.repro_empty_kernel(n_split * b * kvh, 256,
                                                torch.cuda.current_stream(dev).cuda_stream)
                _build.check(lib, status, "empty_kernel")

            floor = median_ms(empty, flush)
            line += f"; launch floor (empty kernel, same grid) {floor:.4f} ms"
        log(line)
        totals["ms"] += n_layers * kernel
        totals["plain_ms"] += n_layers * plain
        totals["library_ms"] += n_layers * library
        totals["flops"] += n_layers * flops
        totals["bytes"] += n_layers * nbytes
    b_ms, b_by = bound_ms(totals["bytes"], totals["flops"], PEAK_BF16_FLOPS)
    log(f"  decode_attention per decode step ({N_GLOBAL} global + {N_LOCAL} local launches): "
        f"kernel {totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, SDPA "
        f"{totals['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # OLMoE's decode layer (4 sequences at 1024.. keys, 16 heads of 128, group 1), logged
    s, h, d = MOE_MAX_LEN, OLMOE_HEADS, OLMOE_HD
    q = _randn(rng, (b, h, d), dt, dev)
    kc, vc = (_randn(rng, (b, s, h, d), dt, dev) for _ in range(2))
    lens_np = MOE_PREFILL_S + np.arange(b, dtype=np.int32) * (DECODE_STEPS // b)
    lens = torch.from_numpy(lens_np).to(dev)
    kernel = median_ms(lambda: da_ops.decode_attention_cache(q, kc, vc, lens), flush)
    keys = int(np.minimum(lens_np, s).sum())
    layer_bound, _ = bound_ms(h * keys * d * 2 * 2 + 2 * b * h * d * 2 + b * 4, 4.0 * h * d * keys,
                              PEAK_BF16_FLOPS)
    log(f"  decode_attention OLMoE layer ({b} seqs, cache {s}, {h} heads of {d}, bf16): kernel "
        f"{kernel:.4f} ms, bytes bound {layer_bound:.4f} ms")
    return {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:91",
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": totals["library_ms"],
    }


# ------------------------------------------------------------ phase 2: K6
def _scan_inputs(rng, b: int, s: int, d: int, n: int, x_dtype, dev) -> dict:
    """K6's operands as hymba's Mamba hands them over, in the model dtype:
    the x_proj output ``proj`` (B, C, dt_raw: N(0, 1)), the conv output
    ``xc``, and ``z`` as the second half of the in_proj output's rows (a
    strided view); ``a_log`` = log(1..N) per channel (its init) plus
    N(0, 0.1), ``dt_bias`` N(0, 0.1), ``d_skip`` 1, h0 N(0, 1)."""
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)).expand(d, n)
    return {"xc": _randn(rng, (b, s, d), x_dtype, dev),
            "proj": _randn(rng, (b, s, 2 * n + 1), x_dtype, dev),
            "z": _randn(rng, (b, s, 2 * d), x_dtype, dev)[..., d:],
            "a_log": (a_log + 0.1 * _randn(rng, (d, n), torch.float32, dev)).contiguous(),
            "dt_bias": 0.1 * _randn(rng, (d,), torch.float32, dev),
            "d_skip": torch.ones(d, dtype=torch.float32, device=dev),
            "h0": _randn(rng, (b, d, n), torch.float32, dev)}


def _scan_args(t: dict, with_h0: bool, gated: bool) -> tuple:
    return (t["xc"], t["proj"], t["a_log"], t["dt_bias"], t["d_skip"], t["h0"] if with_h0 else None,
            t["z"] if gated else None)


def check_selective_scan(dev) -> float:
    """K6 against its plain version: hymba-1.5b's layer (4 sequences, 3200
    channels, 16 states) at S = 1 (a decode step), 37 (ragged against the
    kernel's 32-step chunks) and 2048 (the prefill), with and without h0,
    the model dtype bf16 and f32; then the 8-state instance over 80
    channels (the smoke config's: a ragged last block).  With ``z=None``
    y and h_last are held to ``SCAN_RTOL`` of the plain version's largest
    |value| (the recurrence in f32).  The gated output (the main path's
    form) rounds twice in bf16, bf16(bf16(y) bf16(silu(z))): bf16(y) is
    held elementwise to the rule K3's bf16 kernel is held to, 2^-7 |plain|
    + 1e-4 max|plain| (one bf16 step), and the gated output to the eager
    gate on the kernel's own y, bit for bit; so it differs from the plain
    gated output only where bf16(y) does, by one step of bf16(y), which the
    second rounding can make two steps of out (counted and logged).  In f32
    the gated output is held to ``SCAN_RTOL`` too.  Returns the largest
    |kernel - plain| of y."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import plain as scan_plain

    silu = torch.nn.functional.silu
    rng = np.random.default_rng(SEED + 12)
    b, d, n = PREFILL_B, HYMBA_D_INNER, HYMBA_STATE
    cases = [(b, s, d, n, dt, h0) for s in (1, 37, PREFILL_S) for h0 in (False, True)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(3, s, 80, 8, torch.float32, True) for s in (1, 37, 130)]
    worst = 0.0
    for bb, s, dd, nn, dt, with_h0 in cases:
        t = _scan_inputs(rng, bb, s, dd, nn, dt, dev)
        y, h = scan_ops.selective_scan(*_scan_args(t, with_h0, False))
        out, h_g = scan_ops.selective_scan(*_scan_args(t, with_h0, True))
        y_want, h_want = scan_plain.selective_scan(*_scan_args(t, with_h0, False))
        out_want = y_want.to(dt) * silu(t["z"])  # the plain version's gate
        torch.cuda.synchronize()
        errs = [(got - want).abs().max().item() / want.abs().max().item() for got, want in ((y, y_want),
                                                                                          (h, h_want))]
        own = torch.equal(out, y.to(dt) * silu(t["z"]))  # the eager gate on the kernel's own y
        gap = (out.float() - out_want.float()).abs()
        scale = out_want.float().abs().max().item()
        if dt == torch.bfloat16:
            yb, yb_want = y.to(dt).float(), y_want.to(dt).float()
            y_out = int(((yb - yb_want).abs() > SCAN_BF16_RTOL * yb_want.abs()
                         + SCAN_BF16_ATOL * yb_want.abs().max()).sum())
            out_out = int((gap > SCAN_BF16_RTOL * out_want.float().abs() + SCAN_BF16_ATOL * scale).sum())
            gated = (f"bf16(y): {y_out} elements outside 2^-7 |plain| + {SCAN_BF16_ATOL:g} max|plain|; "
                     f"gated out max|kernel-plain| {gap.max().item():.3e} of max|plain| {scale:.3e}, "
                     f"{out_out} of {gap.numel()} elements outside the same rule (two roundings)")
            inside = not y_out
        else:
            inside = gap.max().item() <= SCAN_RTOL * scale
            gated = (f"gated out max|kernel-plain| {gap.max().item():.3e} of max|plain| {scale:.3e} "
                     f"(tolerance {SCAN_RTOL:g} of it)")
        log(f"  selective_scan B={bb} S={s} D={dd} N={nn} {str(dt)[6:]} h0={with_h0}: max|kernel-plain| / "
            f"max|plain| y {errs[0]:.3e}, h_last {errs[1]:.3e} (tolerance {SCAN_RTOL:g}); {gated}; gated out "
            f"equal to the eager gate on the kernel's y: {own}")
        if not (y.shape == out.shape == (bb, s, dd) and out.dtype == dt and h.shape == (bb, dd, nn)
                and max(errs) <= SCAN_RTOL and inside and own and torch.equal(h, h_g)):
            raise AssertionError(f"selective_scan disagrees with its plain version: {errs}, gated inside "
                                 f"{inside}, own gate {own}")
        worst = max(worst, (y - y_want).abs().max().item())
        del t, y, h, out, h_g, y_want, h_want, out_want, gap
    return worst


def time_selective_scan(dev, flush) -> list:
    """K6 as the main path runs it, gated, the model dtype bf16: at one
    hymba-1.5b prefill layer (4 x 2048 tokens, 3200 channels, 16 states,
    no h0) and at a decode step's (S = 1, with h0), beside its plain
    version and its bound.  The bound is the larger of the bytes (proj,
    xc and the z half of the in_proj rows read once; a_log, dt_bias,
    d_skip and h0 read once; out and h_last written once; at 3.35 TB/s)
    and the operations: on the SFUs (16 a clock per SM) one exp per (b,
    t, d, n), the gate's exp and reciprocal per (b, t, d), softplus's exp
    and log per (b, t); on the f32 pipes 6 flops per (b, t, d, n) (dt a,
    B x, the h FMA, h C).  No single PyTorch call computes this function.
    Returns the two rows: ``selective_scan`` (the prefill layer) and
    ``selective_scan_step``."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import plain as scan_plain

    rng = np.random.default_rng(SEED + 13)
    rows = []
    b, d, n = PREFILL_B, HYMBA_D_INNER, HYMBA_STATE
    for s, with_h0, name in ((PREFILL_S, False, "selective_scan"), (1, True, "selective_scan_step")):
        t = _scan_inputs(rng, b, s, d, n, torch.bfloat16, dev)
        args = _scan_args(t, with_h0, True)
        kernel = median_ms(lambda: scan_ops.selective_scan(*args), flush)
        plain = median_ms(lambda: scan_plain.selective_scan(*args), flush, iters=5, warmup=1)
        elems, rows_, nbytes = b * s * d * n, b * s * d, 0
        for x in (t["xc"], t["proj"], t["a_log"], t["dt_bias"], t["d_skip"]) + ((t["h0"],) if with_h0 else ()):
            nbytes += x.numel() * x.element_size()
        nbytes += 2 * rows_ * 2 + b * d * n * 4  # z read, out written (bf16); h_last (f32)
        sfu = elems + 2 * rows_ + 2 * b * s
        t_bytes, t_sfu, t_f32 = nbytes / PEAK_BYTES_S, sfu / PEAK_SFU_OPS, 6.0 * elems / PEAK_FP32_FLOPS
        b_ms, b_by = max(t_bytes, t_sfu, t_f32) * 1e3, "bytes" if t_bytes >= max(t_sfu, t_f32) else "operations"
        log(f"  {name} {'prefill layer' if s > 1 else 'decode step layer'} ({b}x{s}, {d} channels x {n} "
            f"states, bf16, gated): kernel {kernel:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"bytes {t_bytes * 1e3:.4f}, SFU ops {t_sfu * 1e3:.4f}, f32 flops {t_f32 * 1e3:.4f}), "
            f"{b_ms / kernel:.1%} of it; x {HYMBA_LAYERS} layers: {HYMBA_LAYERS * kernel:.3f} ms")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/selective_scan.cu",
            "replaces": "src/repro/models/ssm.py:39",
            "ms": kernel,
            "plain_ms": plain,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
        del t, args
    return rows


def _scan_bwd_case(rng, b, s, d, n, dt, with_h0, gated, with_dh_last, dev) -> tuple:
    """K6's operands, the forward's h_chunks (the kernel with ``with_chunks``)
    and seeded cotangents: (args, dout, dh_last or None, h_chunks)."""
    from repro_torch.kernels.selective_scan import ops as scan_ops

    t = _scan_inputs(rng, b, s, d, n, dt, dev)
    args = _scan_args(t, with_h0, gated)
    out, h_last, h_chunks = scan_ops._forward(*args, 256, with_chunks=True)
    dout = _randn(rng, tuple(out.shape), out.dtype, dev)
    dh_last = _randn(rng, tuple(h_last.shape), torch.float32, dev) if with_dh_last else None
    return args, dout, dh_last, h_chunks


def check_selective_scan_bwd(dev) -> float:
    """K6's backward (the per-chunk walks, the sums over channel blocks,
    the parameter sums) against the plain backward on the same inputs and
    cotangents, from the kernel forward's h_chunks: hymba-1.5b's training
    layer (4 x 1024, 3200 channels x 16 states, bf16, gated, no h0), S =
    37 and 130 with h0 (dh0) and a cotangent on h_last in bf16 and f32,
    and the 8-state instance over 80 channels (a ragged last block), gated
    and ``z=None``.  In f32 every gradient is held to ``SCAN_RTOL`` of its
    largest |plain| value (the recurrences in another order); in bf16,
    dxc and d proj elementwise to one bf16 step, 2^-7 |plain| +
    ``SCAN_BF16_ATOL`` max|plain| (both sum in f32 and round once), the f32
    gradients to ``SCAN_RTOL``.  dz rounds three times where autograd's
    gate does (bf16(y), dout bf16(y), silu_backward): it is held to the
    eager gate's backward on the kernel forward's own y within one bf16
    step (expected bit for bit: the backward recomputes the forward's y
    from its h_chunks), and to the plain backward (whose y sums in another
    order) within ``SCAN_DZ_STEPS`` bf16 steps, its count of elements
    outside one step logged.
    Then two launches at the training layer are bitwise equal (no
    atomics).  Returns the largest |kernel - plain| / max|plain| over the
    f32 cases."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import plain as scan_plain

    silu = torch.nn.functional.silu
    rng = np.random.default_rng(SEED + 16)
    d, n, bf16, f32 = HYMBA_D_INNER, HYMBA_STATE, torch.bfloat16, torch.float32
    cases = [  # B, S, D, N, dtype, h0, gated, a cotangent on h_last
        (TRAIN_B, TRAIN_S, d, n, bf16, False, True, False),
        (TRAIN_B, 37, d, n, bf16, True, True, True),
        (TRAIN_B, 130, d, n, bf16, True, True, True),
        (TRAIN_B, 37, d, n, f32, True, True, True),
        (TRAIN_B, 130, d, n, f32, True, True, True),
        (3, 37, 80, 8, f32, True, True, True),
        (3, 130, 80, 8, f32, True, False, True),
        (3, 130, 80, 8, bf16, False, True, False),
    ]
    names = ("dxc", "dproj", "da_log", "ddt_bias", "dd_skip", "dh0", "dz")
    worst = 0.0
    for b, s, dd, nn, dt, with_h0, gated, with_dh in cases:
        args, dout, dh_last, h_chunks = _scan_bwd_case(rng, b, s, dd, nn, dt, with_h0, gated, with_dh, dev)
        got = scan_ops.selective_scan_bwd(*args, dout, dh_last, h_chunks)
        want = scan_plain.selective_scan_bwd(*args, dout, dh_last)
        torch.cuda.synchronize()
        errs, notes = {}, []
        for name, g, w in zip(names, got, want):
            if w is None:
                if g is not None:
                    raise AssertionError(f"selective_scan_bwd returned {name} where the plain backward has none")
                continue
            scale = w.float().abs().max().item()
            diff = (g.float() - w.float()).abs()
            errs[name] = diff.max().item() / max(scale, 1e-30)
            finite = g.dtype == w.dtype and g.shape == w.shape and bool(torch.isfinite(g.float()).all())
            if name == "dz" and dt == bf16:
                outside = int((diff > SCAN_BF16_RTOL * w.float().abs() + SCAN_BF16_ATOL * scale).sum())
                notes.append(f"dz: {outside} of {diff.numel()} elements outside 2^-7 |plain| + "
                             f"{SCAN_BF16_ATOL:g} max|plain| (three roundings; held to {SCAN_DZ_STEPS} steps)")
                inside = finite and bool((diff <= SCAN_DZ_STEPS * SCAN_BF16_RTOL * w.float().abs()
                                          + SCAN_BF16_ATOL * scale).all())
            elif g.dtype == bf16:
                inside = finite and bool((diff <= SCAN_BF16_RTOL * w.float().abs() + SCAN_BF16_ATOL * scale).all())
            else:
                inside = finite and errs[name] <= SCAN_RTOL
            if not inside:
                raise AssertionError(f"selective_scan_bwd {name} disagrees with the plain backward: {errs[name]:.3e} "
                                     f"of max|plain| {scale:.3e}, B={b} S={s} D={dd} N={nn} {dt} h0={with_h0} "
                                     f"gated={gated}")
        if gated:  # dz against the eager gate's backward on the kernel forward's own y
            xc, proj, a_log, dt_bias, d_skip, h0, z = args
            y = scan_ops._forward(xc, proj, a_log, dt_bias, d_skip, h0, None, 256, with_chunks=False)[0]
            zz = z.detach().requires_grad_(True)
            own = torch.autograd.grad(y.to(dt) * silu(zz), zz, dout)[0]
            gap = (got[6].float() - own.float()).abs()
            equal = int((got[6] == own).sum())
            notes.append(f"dz equal to the eager gate's backward on the kernel's y at {equal} of {own.numel()}")
            if not bool((gap <= SCAN_BF16_RTOL * own.float().abs() + 1e-30).all()):
                raise AssertionError(f"selective_scan_bwd dz is not the eager gate's backward on the kernel's y: "
                                     f"{gap.max().item():.3e}")
        log(f"  selective_scan_bwd B={b} S={s} D={dd} N={nn} {str(dt)[6:]} h0={with_h0} gated={gated} dh_last="
            f"{with_dh}: max|kernel-plain| / max|plain| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + ("; " + "; ".join(notes) if notes else ""))
        if dt == f32:
            worst = max(worst, *errs.values())
        del args, dout, dh_last, h_chunks, got, want
    b, s, dd, nn, dt, with_h0, gated, with_dh = cases[0]
    args, dout, dh_last, h_chunks = _scan_bwd_case(rng, b, s, dd, nn, dt, with_h0, gated, with_dh, dev)
    first, second = (scan_ops.selective_scan_bwd(*args, dout, dh_last, h_chunks) for _ in range(2))
    same = [x is None and y is None or bool(torch.equal(x, y)) for x, y in zip(first, second)]
    log(f"  selective_scan_bwd twice on the training layer ({b}x{s}, bf16): every gradient bitwise equal {same}")
    if not all(same):
        raise AssertionError(f"selective_scan_bwd is not the same from run to run: {same}")
    scan_ops.selective_scan_bwd.launches = 0
    return worst


def time_selective_scan_bwd(dev, flush) -> dict:
    """K6's backward as a hymba-1.5b training step runs it, one launch a
    layer: the training layer (4 x 1024 tokens, 3200 channels x 16
    states, bf16, gated, no h0), the kernel (its three kernels) beside the
    plain backward, and x 32 layers a step.  The bound is the larger of
    the bytes (xc, proj, the z half of the in_proj rows, dout, h_chunks,
    a_log, dt_bias and d_skip read once; dxc, d proj, dz and the
    parameter gradients written once; at 3.35 TB/s) and the SFU exps, at
    least one per (b, t, d, n) (16 a clock per SM).  No single PyTorch
    call computes this function."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import plain as scan_plain

    rng = np.random.default_rng(SEED + 17)
    b, s, d, n = TRAIN_B, TRAIN_S, HYMBA_D_INNER, HYMBA_STATE
    args, dout, _, h_chunks = _scan_bwd_case(rng, b, s, d, n, torch.bfloat16, False, True, False, dev)
    kernel = median_ms(lambda: scan_ops.selective_scan_bwd(*args, dout, None, h_chunks), flush)
    plain = median_ms(lambda: scan_plain.selective_scan_bwd(*args, dout), flush, iters=3, warmup=1)
    rows_, f32_params = b * s * d, 3 * d * 4 + d * n * 4
    nbytes = (3 * rows_ * 2 + 2 * b * s * (2 * n + 1) * 2 + h_chunks.numel() * 4  # xc, z, dout; proj, d proj;
              + 2 * rows_ * 2 + 2 * f32_params)  # h_chunks; dxc, dz out; the parameters and their gradients
    t_bytes, t_sfu = nbytes / PEAK_BYTES_S, b * s * d * n / PEAK_SFU_OPS
    b_ms, b_by = max(t_bytes, t_sfu) * 1e3, "bytes" if t_bytes >= t_sfu else "operations"
    log(f"  selective_scan_bwd training layer ({b}x{s}, {d} channels x {n} states, bf16, gated): kernel "
        f"{kernel:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}: bytes {t_bytes * 1e3:.4f}, SFU exps "
        f"{t_sfu * 1e3:.4f}), {b_ms / kernel:.1%} of it; x {HYMBA_LAYERS} layers a step: kernel "
        f"{HYMBA_LAYERS * kernel:.3f} ms, plain {HYMBA_LAYERS * plain:.3f} ms")
    scan_ops.selective_scan_bwd.launches = 0
    return {
        "name": "selective_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/selective_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:39",
        "ms": kernel,
        "plain_ms": plain,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


# ------------------------------------------------------------ phase 3: main
def cpu_program(compiled, model, batch: int, header=None):
    """``compiled``'s device program built again on the CPU around a copy
    of ``model``: the same ops, factor and layout; the kernels' plain
    versions.  ``header`` (a split-decode plan's JPEG header) picks the
    coefficient program."""
    from repro_torch.core import device_compiler as DC

    cpu_model = copy.deepcopy(model).cpu()
    if compiled.coeff is not None:
        return DC.compile_coeff_program(
            header, list(compiled.plan.dag_plan.ops), cpu_model, batch,
            factor=compiled.coeff.factor, layout=compiled.coeff.layout, device="cpu")
    prog = compiled.device_program
    return DC.compile_device_program(list(compiled.placement.device_ops), prog.in_meta, cpu_model,
                                     batch, backend=prog.backend, device="cpu")


def hold_to_cpu(what: str, card_logits: np.ndarray, cpu_logits: np.ndarray) -> None:
    """Card logits against the CPU's for the same rows: within LOGIT_RTOL
    of the largest |logit|, with identical argmax."""
    diff = float(np.abs(card_logits - cpu_logits).max())
    scale = float(np.abs(cpu_logits).max())
    same = bool((card_logits.argmax(1) == cpu_logits.argmax(1)).all())
    log(f"{what}, card vs CPU: max|dlogit| {diff:.4e}, max|logit| {scale:.4e} "
        f"(tolerance {LOGIT_RTOL} x max|logit|), argmax identical {same}")
    if not (card_logits.shape == cpu_logits.shape and diff <= LOGIT_RTOL * scale and same):
        raise AssertionError(f"{what}: card logits differ from the CPU run of the same program")


def _check_outputs(what: str, outs, n: int, classes: int) -> None:
    if len(outs) != n or any(o is None or o.shape != (classes,) for o in outs):
        raise AssertionError(f"{what}: expected {n} outputs of shape ({classes},)")
    if not all(np.isfinite(o).all() for o in outs):
        raise AssertionError(f"{what}: non-finite logits")


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
    from repro_torch.core import planner as planner_mod
    from repro_torch.core.planner import ModelSpec
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
    log(f"[main] plan {compiled.plan.key}, coefficient option {compiled.coeff}, impl {prog.impl}, "
        f"stages {prog.stages}")
    dispatch_before = prog.dispatch_count
    _kernel_counts(zero=True)
    outs, report = rt.run(corpus)
    launches = _kernel_counts()
    dispatches = prog.dispatch_count - dispatch_before

    staged = np.stack([compiled.host_fn(item) for item in corpus[:BATCH]])
    header = jpeg.peek_header(corpus[0].variants[full])
    cpu_prog = cpu_program(compiled, model, BATCH, header)
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
        long_ms = [median_ms(f, None, iters=5, warmup=1, spin=LONG_SPIN)
                   for f in (lambda: prog.fn(on_dev), lambda: model(images))]
    log(f"[main] per batch of {BATCH}: host entropy stage {entropy_s * BATCH * 1e3:.1f} ms "
        f"on one thread ({entropy_s * 1e3:.2f} ms/item); device program {program_ms:.3f} ms, "
        f"of which ResNet-50 {model_ms:.3f} ms and decode + preprocessing "
        f"{program_ms - model_ms:.3f} ms (CUDA events; after a ~23 ms spin {long_ms[0]:.3f}, "
        f"{long_ms[1]:.3f} and {long_ms[0] - long_ms[1]:.3f} ms)")
    return dict(compiled=compiled, prog=prog, outs=outs, report=report, launches=launches,
                dispatches=dispatches, cpu_logits=cpu_logits, model=model, spec=spec)


# ------------------------------------------------------- phase 5: serving
def _same_as_run(what: str, got: np.ndarray, want: np.ndarray) -> None:
    """Scores against ``run()``'s for the same item: the same argmax, and
    within LOGIT_RTOL of the largest |logit|."""
    diff = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    if int(np.argmax(got)) != int(np.argmax(want)) or diff > LOGIT_RTOL * scale:
        raise AssertionError(f"{what}: argmax {int(np.argmax(got))} vs {int(np.argmax(want))}, "
                             f"max|dlogit| {diff:.4e} vs tolerance {LOGIT_RTOL * scale:.4e}")


def _kernel_counts(zero: bool = False) -> dict:
    """The vision kernels' wrapper launch counts (set to 0 first when
    ``zero``): K1 at point 8 ("idct") and at points 4/2/1 ("idct_scaled"),
    K5, K2."""
    from repro_torch.kernels.blocks_to_rgb import ops as b2r_ops
    from repro_torch.kernels.fused_preproc import ops as fp_ops
    from repro_torch.kernels.idct import ops as idct_ops

    if zero:
        idct_ops.idct_rows.launches = 0
        idct_ops.idct_rows.launches_by_point = dict.fromkeys(idct_ops.SCALED_POINTS, 0)
        b2r_ops.blocks_to_rgb.launches = 0
        fp_ops.resize_affine_planar.launches = 0
    by_point = idct_ops.idct_rows.launches_by_point
    return {"idct": by_point[8], "idct_scaled": by_point[4] + by_point[2] + by_point[1],
            "blocks_to_rgb": b2r_ops.blocks_to_rgb.launches,
            "fused_preproc": fp_ops.resize_affine_planar.launches}


def _expect_vision_counts(what: str, got: dict, point: int, split: int, pixel: int = 0) -> None:
    """Per split-decode dispatch K1 x2 (at ``point``), K5 x1, K2 x1; per
    pixel-program dispatch K2 x1."""
    want = {"idct": 2 * split if point == 8 else 0, "idct_scaled": 2 * split if point != 8 else 0,
            "blocks_to_rgb": split, "fused_preproc": split + pixel}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def profile_replay(prog, batch, active: int = 3) -> dict:
    """torch.profiler over graph replays of ``prog``: the device launches of
    K1, K5 and K2 per replay, by their CUDA kernel names, and their device
    time.  A schedule skips a
    wait step and a warm-up step first, so the profiler is fully on before
    the ``active`` replays it counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    prog(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=active, repeat=1)) as prof:
        for _ in range(2 + active):
            prog(batch)
            torch.cuda.synchronize()
            prof.step()
    # device rows only: the cudaGraphLaunch row also carries its kernels' time
    rows = [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0 and e.self_cpu_time_total == 0]
    names = {"idct": "idct_rows_tc_kernel", "blocks_to_rgb": "blocks_to_rgb_kernel",
             "fused_preproc": "resize_affine_band_kernel"}
    per_replay = {k: sum(e.count for e in rows if n in e.key) / active for k, n in names.items()}
    device_ms = {k: round(sum(e.self_device_time_total for e in rows if n in e.key) / 1e3 / active, 4)
                 for k, n in names.items()}
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / active
    log(f"[serve] profile of {active} replays: {len(rows)} kernel names, device busy "
        f"{busy_ms:.3f} ms a replay, K1/K5/K2 device launches a replay {per_replay}, "
        f"their device ms a replay {device_ms}, all three {sum(device_ms.values()):.4f} ms")
    return per_replay


def run_vision_serving(dev, corpus, full, thumb, main: dict, card: str) -> None:
    """The vision serving path on the card (see the module docstring)."""
    from repro_torch.core import device_compiler as DC
    from repro_torch.core.aggregation import control_variate_aggregate
    from repro_torch.core.planner import ModelSpec
    from repro_torch.runtime import (AggregationQuery, CascadeQuery, CascadeStageSpec,
                                     ClassificationQuery, DeviceCompilerConfig, MemoryConfig,
                                     RecalConfig, RuntimeConfig, SmolRuntime, TelemetryConfig,
                                     TenantConfig)

    model, spec, ref = main["model"], main["spec"], main["outs"]
    ref_argmax = np.array([int(np.argmax(o)) for o in ref])
    # stage 0 of the cascade: the same network on the thumbnail; its
    # accuracy is below the floor, so only a cascade stage naming it uses it
    thumb_spec = ModelSpec("resnet50-thumb", INPUT, exec_throughput=spec.exec_throughput,
                           accuracy_by_format={full.key: 0.7, thumb.key: 0.6})
    rt = SmolRuntime(
        [spec, thumb_spec], [full, thumb], {"resnet50": model, "resnet50-thumb": model},
        calibration=corpus[:4],
        config=RuntimeConfig(
            batch_size=BATCH, num_workers=8, min_accuracy=0.8, max_wait_ms=5.0,
            device=DeviceCompilerConfig(split_decode="full"), warmup="full",
            tenants=tuple(TenantConfig(n, weight=w) for n, w in SERVE_TENANTS),
            telemetry=TelemetryConfig(spans=True),
            memory=MemoryConfig(rendition_cache_bytes=RENDITION_CACHE_BYTES),
            recal=RecalConfig(every=RECAL_EVERY)),
        device=dev,
    )
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved(dev)
    captures0 = DC.capture_program.captures
    _kernel_counts(zero=True)
    t0 = time.perf_counter()
    rt.start_serving()
    try:
        t_start = time.perf_counter() - t0
        if not rt.wait_warm(timeout=SERVE_TIMEOUT_S):
            raise AssertionError("background warmup did not finish")
        t_warm = time.perf_counter() - t0
        torch.cuda.synchronize()
        reserved1 = torch.cuda.memory_reserved(dev)
        compiled = rt.compile()
        ps = compiled.program_sets[0]
        warm = rt.stats().warmup
        log(f"[serve] plan {compiled.plan.key}; start_serving {t_start:.2f} s (bucket {BATCH} "
            f"captured inline), all buckets warm after {t_warm:.2f} s")
        log(f"[serve] capture seconds per bucket "
            f"{ {b: round(v, 4) for b, v in sorted(warm.graphs.items())} } [{card}]")
        log(f"[serve] memory reserved {reserved0 / 2**20:.1f} MiB before warmup, "
            f"{reserved1 / 2**20:.1f} MiB after ({(reserved1 - reserved0) / 2**20:.1f} MiB "
            f"for {len(warm.graphs)} graphs in one pool and their warm-up runs)")
        want = DC.batch_buckets(BATCH)
        if ps.buckets != want or warm.ready != want or sorted(warm.graphs) != list(want):
            raise AssertionError(f"buckets {ps.buckets}, ready {warm.ready}, captured "
                                 f"{sorted(warm.graphs)}; expected all of {want}")
        if DC.capture_program.captures - captures0 != len(want):
            raise AssertionError(f"{DC.capture_program.captures - captures0} captures at "
                                 f"startup, expected {len(want)}")
        per_graph = {b: g.kernel_launches for b, g in ps.graphs().items()}
        if any(k != REPLAY_KERNELS for k in per_graph.values()):
            raise AssertionError(f"kernels captured per graph {per_graph}, expected {REPLAY_KERNELS}")

        # every item as a ClassificationQuery, spread over both tenants
        captures1 = DC.capture_program.captures
        replays0 = {b: g.replays for b, g in ps.graphs().items()}
        t1 = time.perf_counter()
        uids = {}
        for i, item in enumerate(corpus):
            uids[rt.submit(ClassificationQuery(item), tenant=SERVE_TENANTS[i % 2][0])] = i
        rt.flush(timeout=SERVE_TIMEOUT_S)
        done = rt.drain(timeout=SERVE_TIMEOUT_S)
        serve_s = time.perf_counter() - t1
        if len(done) != len(corpus) or any(r.error is not None for r in done):
            raise AssertionError(f"{len(done)} results, errors "
                                 f"{[r.error for r in done if r.error is not None][:3]}")
        for r in done:
            _same_as_run(f"classification of item {uids[r.uid]}", r.scores, ref[uids[r.uid]])
        replays = {b: g.replays - replays0.get(b, 0) for b, g in ps.graphs().items()}
        e2e = rt.stats().latency.stages["e2e"]
        log(f"[serve] {len(corpus)} classifications in {serve_s:.3f} s: "
            f"{len(corpus) / serve_s:.2f} items/s, e2e latency p50 {e2e.p50 * 1e3:.2f} ms, "
            f"p99 {e2e.p99 * 1e3:.2f} ms; graph replays by bucket {replays}; argmax and "
            f"scores as run() (tolerance {LOGIT_RTOL} x max|logit|) [{card}]")
        if DC.capture_program.captures != captures1 or sum(replays.values()) == 0:
            raise AssertionError("classification traffic captured a graph or replayed none")

        # cascades: the thumbnail first; an item whose max softmax stays
        # below 1.0 is refetched at full resolution (random weights give
        # huge logits, so about half the items exit at the thumbnail)
        stages = (CascadeStageSpec(1.0, "resnet50-thumb"), CascadeStageSpec(0.0, "resnet50"))
        uids = {rt.submit(CascadeQuery(corpus[i], stages), tenant=SERVE_TENANTS[0][0]): i
                for i in range(N_CASCADES)}
        rt.flush(timeout=SERVE_TIMEOUT_S)
        done = rt.drain(timeout=SERVE_TIMEOUT_S)
        if len(done) != N_CASCADES or any(r.error is not None or r.refetched != (r.exit_stage == 1)
                                          for r in done):
            raise AssertionError(f"cascades: {[(r.exit_stage, r.refetched, r.error) for r in done][:4]}")
        # a refetched item has run()'s full-resolution scores; one that
        # exited has the thumbnail stage's, held against that stage's
        # program run eagerly on the same items
        thumb_stage = next(iter(rt._cascades.values())).cheap
        exited = [r for r in done if r.exit_stage == 0]
        staged = np.zeros((BATCH, *thumb_stage.out_shape), thumb_stage.out_dtype)
        for row, r in enumerate(exited):
            staged[row] = thumb_stage.host_fn(corpus[uids[r.uid]])
        with torch.inference_mode():
            thumb_scores = thumb_stage.device_program.fn(torch.from_numpy(staged).to(dev))
        thumb_scores = thumb_scores.cpu().numpy()
        for r in done:
            if r.exit_stage == 1:
                _same_as_run(f"cascade of item {uids[r.uid]}", r.scores, ref[uids[r.uid]])
        for row, r in enumerate(exited):
            _same_as_run(f"cascade exit of item {uids[r.uid]}", r.scores, thumb_scores[row])
        if not exited or len(exited) == len(done):
            raise AssertionError(f"{len(exited)} of {len(done)} cascades exited at the thumbnail; "
                                 "expected both exits")
        cascade = rt.stats().cascade
        if rt.wait_warm(timeout=SERVE_TIMEOUT_S) is not True:
            raise AssertionError("the cascade's stage warmup did not finish")
        stage_captures = DC.capture_program.captures - captures1
        log(f"[serve] {N_CASCADES} cascades: stage items {[s.items for s in cascade.stages]}, "
            f"refetched {cascade.refetched_items}; the thumbnail stage's program set "
            f"warmed at its first query: {stage_captures} captures, all in warm passes")

        # one aggregation query over the corpus, against the same estimator
        # over run()'s argmax values
        captures2 = DC.capture_program.captures
        query = AggregationQuery(corpus, eps=25.0, delta=0.1, seed=SEED)
        agg = rt.submit(query, tenant=SERVE_TENANTS[1][0])
        want_agg = control_variate_aggregate(
            ref_argmax.astype(np.float64), lambda idx: ref_argmax[np.asarray(idx)].astype(np.float64),
            eps=query.eps, delta=query.delta, batch=query.batch, min_samples=query.min_samples,
            max_samples=query.max_samples, seed=query.seed)
        log(f"[serve] aggregation: estimate {agg.estimate:.6f} +- {agg.ci_halfwidth:.4f}, "
            f"{agg.num_specialized_invocations} scanned, {agg.num_target_invocations} refetched, "
            f"{agg.latency:.3f} s; from run()'s argmax {want_agg.estimate:.6f}")
        if (agg.num_specialized_invocations != len(corpus)
                or abs(agg.estimate - want_agg.estimate) > 1e-6
                or DC.capture_program.captures != captures2):
            raise AssertionError("aggregation differs from run()'s values or captured a graph")
    finally:
        rt.stop_serving()
    # the wrappers count the warm-up runs and captures (a replay bypasses
    # them); the replays launch each graph's captured kernels
    wrapper = _kernel_counts()
    via_replays = {k: sum(g.replays * g.kernel_launches.get(k, 0) for g in ps.graphs().values())
                   for k in REPLAY_KERNELS}
    log(f"[serve] K1/K5/K2 launches in the serving phase: through the wrappers {wrapper}, "
        f"in graph replays {via_replays}")
    if min(wrapper[k] for k in REPLAY_KERNELS) == 0 or min(via_replays.values()) == 0:
        raise AssertionError("the serving phase launched K1, K5 or K2 no time")
    stats = rt.stats()
    log(f"[serve] warm failures {stats.warmup.failures}, programs compiled post warmup "
        f"{rt.programs_compiled_post_warmup}, program compile+capture seconds "
        f"{rt.program_compile_seconds_total:.2f}; requests "
        f"{ {n: (t.stats.completed, t.stats.failed) for n, t in stats.tenants.items()} }; "
        f"rendition cache hits {stats.cache.hits} misses {stats.cache.misses} resident "
        f"{stats.cache.resident_bytes / 2**20:.1f} MiB")
    if stats.warmup.failures or rt.programs_compiled_post_warmup:
        raise AssertionError(f"warm failures {stats.warmup.errors}, "
                             f"{rt.programs_compiled_post_warmup} post-warmup compiles")

    # a ragged batch of 37 through bucket 64: the replay against the eager
    # program on the same rows, then through run()
    prog, bucket = ps.program_for(RAGGED_ROWS)
    staged = np.zeros((bucket, *compiled.out_shape), compiled.out_dtype)
    staged[:RAGGED_ROWS] = np.stack([compiled.host_fn(it) for it in corpus[:RAGGED_ROWS]])
    replayed = prog(staged)[:RAGGED_ROWS].cpu().numpy()
    on_dev = torch.from_numpy(staged).to(dev)
    with torch.inference_mode():
        eager = prog.fn(on_dev)[:RAGGED_ROWS].cpu().numpy()
    diff = float(np.abs(replayed - eager).max())
    outs, _ = rt.run(corpus[:RAGGED_ROWS])
    log(f"[serve] ragged batch of {RAGGED_ROWS}: bucket {bucket}, replay vs eager max|dlogit| "
        f"{diff:.4e}")
    if bucket != BATCH or diff > LOGIT_RTOL * float(np.abs(eager).max()):
        raise AssertionError(f"ragged batch: bucket {bucket}, replay vs eager {diff:.4e}")
    for i, o in enumerate(outs):
        _same_as_run(f"run() of the ragged batch, item {i}", o, ref[i])

    # K1 twice, K5 and K2 once inside one replay, by their CUDA kernel names
    counts = profile_replay(prog, staged)
    if counts != REPLAY_KERNELS:
        raise AssertionError(f"a replay launched {counts}, expected {REPLAY_KERNELS}")

    # the device program per batch, eager vs graph replay on a resident
    # batch: device time (CUDA events, host enqueue hidden) and wall time
    # per dispatch back to back (host clock, launches included)
    for b in TIMED_BUCKETS:
        bprog = ps.programs[b]
        graph = bprog.graph
        with torch.inference_mode():
            eager_ms = median_ms(lambda: bprog.fn(graph.static_in), None, iters=10, warmup=2)
            replay_ms = median_ms(graph.graph.replay, None, iters=10, warmup=2)
            eager_wall = wall_ms(lambda: bprog.fn(graph.static_in))
            replay_wall = wall_ms(graph.graph.replay)
        log(f"[serve] device program at bucket {b}: eager {eager_ms:.3f} ms, replay "
            f"{replay_ms:.3f} ms (CUDA events); per dispatch back to back eager "
            f"{eager_wall:.3f} ms, replay {replay_wall:.3f} ms (host clock) [{card}]")

    # run() with online recalibration every 64 items
    n_recal = len(rt.recalibrations)
    outs, report = rt.run(corpus)
    log(f"[serve] run() with RecalConfig(every={RECAL_EVERY}): {len(report.recalibrations)} "
        f"recalibrations {[(e.old_split, e.new_split, e.new_factor) for e in report.recalibrations]}, "
        f"{report.stats.throughput:.2f} items/s")
    expected = -(-len(corpus) // RECAL_EVERY) - 1
    if len(report.recalibrations) != expected or len(rt.recalibrations) - n_recal != expected:
        raise AssertionError(f"{len(report.recalibrations)} recalibrations, expected {expected}")
    for i, o in enumerate(outs):
        _same_as_run(f"recalibrated run(), item {i}", o, ref[i])


# ------------------------------------------------------------ phase 4: LM
def _attention_counts() -> dict:
    """The LM kernels' launches: K3's by instance family (D = DV with
    S_k = S_q; S_k != S_q, cross attention; MLA's 192/128), K4's, and K6's
    over a prompt (S > 1) and at a decode step (S = 1)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops

    by_dims, cross = fa_ops.flash_attention_bshd.launches_by_dims, fa_ops.flash_attention_bshd.launches_cross
    return {"flash_attention": sum(n for dims, n in by_dims.items() if dims != MLA_DIMS) - cross,
            "flash_attention_cross": cross,
            "flash_attention_mla": by_dims[MLA_DIMS],
            "decode_attention": da_ops.decode_attention_cache.launches,
            "selective_scan": scan_ops.selective_scan.launches - scan_ops.selective_scan.launches_step,
            "selective_scan_step": scan_ops.selective_scan.launches_step}


def _zero_attention_counts() -> None:
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops

    fa_ops.flash_attention_bshd.launches = 0
    fa_ops.flash_attention_bshd.launches_by_dims = dict.fromkeys(fa_ops.HEAD_DIMS, 0)
    fa_ops.flash_attention_bshd.launches_cross = 0
    da_ops.decode_attention_cache.launches = 0
    scan_ops.selective_scan.launches = 0
    scan_ops.selective_scan.launches_step = 0
    fa_ops.flash_attention_bwd_bshd.launches = 0
    scan_ops.selective_scan_bwd.launches = 0


def _plain_kernels():
    """The model with K3/K4/K6 swapped for their plain versions (the card
    comparison's reference): patches the three wrappers the layers call."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import plain as da_plain
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import plain as scan_plain

    stack = ExitStack()
    stack.enter_context(mock.patch.object(fa_ops, "flash_attention_bshd", fa_plain.flash_attention_bshd))
    stack.enter_context(mock.patch.object(da_ops, "decode_attention_cache", da_plain.decode_attention))
    stack.enter_context(mock.patch.object(scan_ops, "selective_scan", scan_plain.selective_scan))
    return stack


def _recorded_routing(record: list):
    """Record every MoE layer call's expert choices (top-k ids), in order."""
    from unittest import mock

    from repro_torch.models import layers as L

    gates = L.moe_gates

    def recording(xt, router, k):
        w, idx = gates(xt, router, k)
        record.append(idx)
        return w, idx

    return mock.patch.object(L, "moe_gates", recording)


def _pinned_routing(record: list, differ: list):
    """Replay ``record``'s expert choices, in order, with this run's own
    gate weights at them: the plain-attention model routes each token as
    the kernel run did, so a gate that a bf16 step tips (top-8 of 64
    near-equal random gates) does not swap a token's experts and hide the
    kernels' own difference.  ``differ`` accumulates [tokens whose own
    top-k set differs, tokens]."""
    from unittest import mock

    from repro_torch.models import layers as L

    replay = iter(record)

    def pinned(xt, router, k):
        gates = torch.softmax(xt.float() @ router.float(), dim=-1)
        idx = next(replay)
        own = torch.topk(gates, k, dim=-1).indices
        differ[0] += (own.sort(-1).values != idx.sort(-1).values).any(-1).sum()
        differ[1] += idx.shape[0]
        w = gates.gather(-1, idx)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx

    return mock.patch.object(L, "moe_gates", pinned)


def _rel_err(got: torch.Tensor, want: torch.Tensor, vocab: int) -> tuple[float, float]:
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale, scale


def _expect_counts(phase: str, got: dict, want: dict) -> None:
    log(f"[lm] {phase} launches {got}")
    if got != want:
        raise AssertionError(f"{phase}: kernel launches {got}, expected {want}")


def _counts(**kw) -> dict:
    return {"flash_attention": 0, "flash_attention_cross": 0, "flash_attention_mla": 0, "decode_attention": 0,
            "selective_scan": 0, "selective_scan_step": 0, **kw}


def _times(per: dict, n: int) -> dict:
    return {k: v * n for k, v in per.items()}


def _per_pass(cfg) -> dict:
    """K3 and K6 launches of one prefill or forward: K3 a layer's each
    (MLA's instance under MLA); an encoder-decoder's encoder layers and
    decoder layers, and a cross launch (S_k = S_enc) per decoder layer; a
    hybrid layer's K3 and K6 (its Mamba scan); none for the xLSTM."""
    if cfg.family == "ssm":
        return {}
    if cfg.attn_type == "mla":
        return {"flash_attention_mla": cfg.num_layers}
    if cfg.is_encdec:
        return {"flash_attention": cfg.encoder_layers + cfg.num_layers, "flash_attention_cross": cfg.num_layers}
    if cfg.family == "hybrid":
        return {"flash_attention": cfg.num_layers, "selective_scan": cfg.num_layers}
    return {"flash_attention": cfg.num_layers}


def _per_step(cfg) -> dict:
    """K4 and K6 launches of one decode step: K4 one per GQA layer, and one
    more per decoder layer over an encoder-decoder's cross cache; none
    under MLA (its absorbed decode is plain torch) or for the xLSTM; K6
    one per hybrid layer (the scan at S = 1)."""
    k4 = 0 if cfg.attn_type == "mla" or cfg.family == "ssm" else cfg.num_layers * (2 if cfg.is_encdec else 1)
    return {"decode_attention": k4, "selective_scan_step": cfg.num_layers if cfg.family == "hybrid" else 0}


def _graph_counts(graph) -> dict:
    """A decode graph's launches a replay under ``_attention_counts``'
    names: every K6 launch of a decode step is one at S = 1."""
    counts = dict(graph.kernel_launches)
    counts["selective_scan_step"] = counts.pop("selective_scan")
    return counts


def _routing_note(differ: list) -> str:
    if not differ[1]:
        return ""
    return (f"; the plain run's own gates would route {int(differ[0])} of {differ[1]} MoE "
            f"token-layers to other experts (it takes the kernel run's)")


def _add(total: dict, part: dict) -> dict:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v
    return total


def profile_steps(fn, n: int = 4) -> tuple[float, float, list]:
    """torch.profiler over ``n`` calls of ``fn`` (after one unprofiled):
    (wall ms per call, device busy ms per call, the device-kernel rows).
    Device rows only: a graph replay's cudaGraphLaunch row also carries its
    kernels' time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0 and e.self_cpu_time_total == 0]
    return wall, sum(e.self_device_time_total for e in rows) / 1e3 / n, rows


def decode_graph_vs_eager(model, cfg, tag: str, cache, lens, cache_g, lens0, tokens, kernel_logits,
                          card: str) -> dict:
    """``decode_step`` as one CUDA graph (``serving.engine.DecodeGraph``)
    over ``cache_g``, a copy of the prefill's cache: its logits over the
    eager run's tokens must equal the eager logits bitwise.  Then decode
    ms/step eager against replay (host clock, 20 steps back to back) and
    each one's device busy time per step (profiler, 4 steps), with K4's
    device launches per step.  The idle share is printed twice: busy time
    over the unprofiled step (the profiler's own cost left out; noise can
    take it a little below 0) and over the profiled window (which holds
    the profiler's cost, ~2 ms a replay).  Returns the launches (the wrappers' during
    warm-up and capture, plus the replays')."""
    from repro_torch.models import decode as D
    from repro_torch.serving import engine as E

    per_step = _per_step(cfg)
    _zero_attention_counts()
    t0 = time.perf_counter()
    graph = E.DecodeGraph(model, cfg, cache_g)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launches = _attention_counts()
    _expect_counts(f"{tag} decode graph warm-up + capture", launches, _counts(**_times(per_step, 2)))
    if _graph_counts(graph) != {"flash_attention": 0, **per_step}:
        raise AssertionError(f"the decode graph holds {graph.kernel_launches} launches")
    lens_g, differ = lens0.clone(), 0
    for tk, lg in zip(tokens, kernel_logits):
        differ += not torch.equal(graph.run(tk, lens_g), lg)
        lens_g += 1
    log(f"[lm] {tag} decode graph: captured in {capture_s:.3f} s (warm-up run included), "
        f"{graph.kernel_launches['decode_attention']} K4 and {graph.kernel_launches['selective_scan']} K6 "
        f"launches a replay; {len(tokens)} replays vs "
        f"eager steps: logits bitwise equal in {len(tokens) - differ} of {len(tokens)}")
    if differ:
        raise AssertionError(f"{tag}: {differ} replays' logits differ from the eager step's")
    tok = tokens[-1]
    eager_ms = wall_ms(lambda: D.decode_step(model, cfg, tok, cache, lens))
    replay_ms = wall_ms(lambda: graph.run(tok, lens))
    want = [[per_step["decode_attention"]] * 2, [per_step["selective_scan_step"]] * 2]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        eager_wall, eager_busy, eager_rows = profile_steps(lambda: D.decode_step(model, cfg, tok, cache, lens))
        replay_wall, replay_busy, replay_rows = profile_steps(lambda: graph.run(tok, lens))
        k4, k6 = ([sum(e.count for e in rows if name in e.key) / 4 for rows in (eager_rows, replay_rows)]
                  for name in ("flash_decode_kernel", "selective_scan_kernel"))
        if [k4, k6] == want or attempt == PROFILE_ATTEMPTS:
            break
        # the launches themselves were counted exactly by the wrappers above; a
        # trace that misses a kernel record is measured again, never accepted
        log(f"[lm] {tag}: profile {attempt} holds K4 / K6 {k4} / {k6} device launches a step, not "
            f"{per_step}; profiling again")
    log(f"[lm] {tag} decode ms/step ({lens.shape[0]} seqs, host clock, 20 steps back to back): eager "
        f"{eager_ms:.3f}, graph replay {replay_ms:.3f} ({eager_ms / replay_ms:.2f}x); device busy per "
        f"step (profiler, 4 steps) eager {eager_busy:.3f} ms, replay {replay_busy:.3f} ms; idle share "
        f"over the unprofiled step eager {1 - eager_busy / eager_ms:.1%}, replay "
        f"{1 - replay_busy / replay_ms:.1%}; over the profiled window ({eager_wall:.3f} / "
        f"{replay_wall:.3f} ms a step) eager {1 - eager_busy / eager_wall:.1%}, replay "
        f"{1 - replay_busy / replay_wall:.1%}; K4 device launches per step eager {k4[0]:g}, replay "
        f"{k4[1]:g}; K6 eager {k6[0]:g}, replay {k6[1]:g}; device kernels per step eager "
        f"{sum(e.count for e in eager_rows) / 4:g}, replay {sum(e.count for e in replay_rows) / 4:g} [{card}]")
    if k4 != [per_step["decode_attention"]] * 2 or k6 != [per_step["selective_scan_step"]] * 2:
        raise AssertionError(f"{tag}: K4 / K6 device launches per step {k4} / {k6}, expected {per_step}")
    for e in sorted(replay_rows, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[lm]   replay device {e.self_device_time_total / 1e3 / 4:8.3f} ms/step  "
            f"{e.count // 4:4d}x  {e.key[:80]}")
    _add(launches, _times(per_step, graph.replays))
    del graph
    return launches


def serve_graph_vs_eager(model, cfg, dev, tag: str, text: str, card: str, n_requests: int = SERVE_REQUESTS,
                         slots: int = SERVE_SLOTS) -> dict:
    """``ServingEngine.serve`` of ``n_requests`` requests over ``slots``
    slots, eagerly and on the decode graph: the same greedy ids per
    request.  Returns the launches."""
    from repro_torch.serving import engine as E

    per_step = _per_step(cfg)
    vocab = cfg.vocab_size
    runs = {}
    for mode in ("eager", "graph"):
        engine = E.ServingEngine(model, cfg, batch_slots=slots, max_len=SERVE_MAX_LEN, device=dev,
                                 cuda_graph=mode == "graph")
        reqs = [E.Request(uid=i, text=text.format(i=i), max_new_tokens=SERVE_MAX_NEW)
                for i in range(n_requests)]
        _zero_attention_counts()
        t0 = time.perf_counter()
        graph = engine.warm()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        done, stats = engine.serve(reqs)
        c = _attention_counts()
        if graph is None:
            _expect_counts(f"{tag} serve ({mode})", c, _counts(**_times(per_step, engine.model_steps)))
        else:
            _expect_counts(f"{tag} serve ({mode}) warm-up + capture", c, _counts(**_times(per_step, 2)))
            if graph.replays != engine.model_steps:
                raise AssertionError(f"{graph.replays} replays for {engine.model_steps} model steps")
            _add(c, _times({k: _graph_counts(graph)[k] for k in per_step}, graph.replays))
        if stats.completed != n_requests or sorted(r.uid for r in done) != list(range(n_requests)):
            raise AssertionError(f"served {stats.completed} of {n_requests} requests")
        if not all(1 <= len(r.output_ids) <= SERVE_MAX_NEW and all(0 <= t < vocab for t in r.output_ids)
                   for r in done):
            raise AssertionError("a request came back with no tokens or ids outside the vocabulary")
        log(f"[lm] {tag} serve ({mode}) {n_requests} requests over {slots} slots: "
            f"{stats.tokens_generated} tokens in {stats.wall_seconds:.3f} s, "
            f"{stats.tokens_per_second:.1f} tokens/s; {stats.decode_steps} serve steps + "
            f"{engine.model_steps - stats.decode_steps} prompt steps, "
            f"{stats.wall_seconds / engine.model_steps * 1e3:.3f} ms per model step"
            f"{f'; graph captured in {warm_s:.3f} s before it' if graph is not None else ''} [{card}]")
        runs[mode] = ({r.uid: r.output_ids for r in done}, stats, c)
        del engine, graph
    same = sum(runs["eager"][0][u] == runs["graph"][0][u] for u in range(n_requests))
    log(f"[lm] {tag} serve: graph {runs['graph'][1].tokens_per_second:.1f} tokens/s against eager "
        f"{runs['eager'][1].tokens_per_second:.1f} "
        f"({runs['graph'][1].tokens_per_second / runs['eager'][1].tokens_per_second:.2f}x); output ids "
        f"equal for {same} of {n_requests} requests")
    if same != n_requests:
        raise AssertionError(f"{tag}: the graph engine's ids differ from the eager engine's")
    return _add(dict(runs["eager"][2]), runs["graph"][2])


def drive_lm(dev, card: str, cfg, model, tag: str, b: int, s: int, max_len: int, serve_text: str,
             inputs: dict | None = None, steps: int = DECODE_STEPS, serve: tuple | None = (SERVE_REQUESTS,
                                                                                         SERVE_SLOTS),
             full: bool = True) -> dict:
    """One LM through its serving path in bf16: ``prefill`` of b x s
    tokens (after the VLM's vision tokens, or over the encoder-decoder's
    frames: ``inputs``, prefill's and forward's keyword arguments),
    ``forward`` over the same prompts, ``steps`` ``decode_step``s, the
    decode graph against them, and ``serve`` (``serve``: requests, slots)
    eager and on the graph; with ``full`` False only prefill and decode.
    Each phase runs with the K3/K4/K6 counters zeroed just before it and
    read just after; prefill and decode logits are held against the same
    model with plain attention and the plain scan (an MoE model's plain run
    routes every token to the kernel run's experts, and how many tokens its
    own gates would send elsewhere is logged), forward's last position
    against prefill; for a recurrent model (hybrid, xLSTM) the first decode
    step's logits against forward over the prompt and that token.  Returns
    the launches."""
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T

    inputs = inputs or {}
    vocab = cfg.vocab_size
    per_pass, per_step = _per_pass(cfg), _per_step(cfg)
    rng = np.random.default_rng(SEED + 6)
    prompts = torch.from_numpy(rng.integers(0, vocab, size=(b, s))).to(dev)
    n_vis = inputs["vision_embeds"].shape[1] if "vision_embeds" in inputs else 0
    s_total = n_vis + s

    # ---- prefill (one warm-up call first: cuBLAS handles, allocator)
    D.prefill(model, cfg, prompts, max_len=max_len, **inputs)
    torch.cuda.synchronize()
    _zero_attention_counts()
    routing, differ = [], [0, 0]
    t0 = time.perf_counter()
    with _recorded_routing(routing):
        logits, cache, lens = D.prefill(model, cfg, prompts, max_len=max_len, **inputs)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = _attention_counts()
    _expect_counts(f"{tag} prefill", launches, _counts(**per_pass))
    if logits.shape != (b, cfg.padded_vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits: shape {tuple(logits.shape)} or non-finite")
    if lens.tolist() != [s_total] * b:
        raise AssertionError(f"prefill lengths {lens.tolist()}, expected {s_total}")
    with _plain_kernels(), _pinned_routing(routing, differ):
        plain_logits, plain_cache, _ = D.prefill(model, cfg, prompts, max_len=max_len, **inputs)
    err, scale = _rel_err(logits, plain_logits, vocab)
    what = (f"{b}x({n_vis} vision + {s} text)" if n_vis else f"{b}x{s}") + " tokens" + (
        f" over {b}x{cfg.encoder_seq_len} frames" if cfg.is_encdec else "")
    log(f"[lm] {tag} prefill {what}: {prefill_s * 1e3:.1f} ms, {b * s_total / prefill_s:.0f} tokens/s; "
        f"last-token logits vs plain kernels: max|d| / max|logit| {err:.3e} (max|logit| {scale:.3e}, "
        f"tolerance {LM_LOGIT_RTOL}){_routing_note(differ)} [{card}]")
    if not err <= LM_LOGIT_RTOL:
        raise AssertionError(f"prefill logits differ from the plain-kernel model by {err}")

    if full:
        # ---- forward over the same prompts (its K3 call site is gqa_apply / mla_apply)
        _zero_attention_counts()
        t0 = time.perf_counter()
        all_logits = T.forward(model, cfg, prompts, **inputs)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        _expect_counts(f"{tag} forward", _attention_counts(), _counts(**per_pass))
        _add(launches, per_pass)
        if all_logits.shape != (b, s_total, cfg.padded_vocab_size):
            raise AssertionError(f"forward logits: shape {tuple(all_logits.shape)}")
        err, _ = _rel_err(all_logits[:, -1], logits, vocab)
        finite = bool(torch.isfinite(all_logits).all())
        del all_logits
        log(f"[lm] {tag} forward {what}: {forward_s * 1e3:.1f} ms (one call); last-position logits vs "
            f"prefill's: max|d| / max|logit| {err:.3e} (tolerance {FORWARD_LOGIT_RTOL:.4g}), all finite "
            f"{finite} [{card}]")
        if not (finite and err <= FORWARD_LOGIT_RTOL):
            raise AssertionError(f"forward logits non-finite or differ from prefill's by {err}")

    # ---- decode: greedy tokens of the kernel path, fed to both paths
    cache_g, lens0 = ({k: v.clone() for k, v in cache.items()}, lens.clone()) if full else (None, lens.clone())
    tok = logits.argmax(-1)
    tokens, kernel_logits, step_ms = [], [], []
    routing, differ = [], [0, 0]
    _zero_attention_counts()
    with _recorded_routing(routing):
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache, lens = D.decode_step(model, cfg, tok, cache, lens)
            nxt = logits.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            tokens.append(tok)
            kernel_logits.append(logits)
            tok = nxt
    c = _attention_counts()
    _expect_counts(f"{tag} decode", c, _counts(**_times(per_step, steps)))
    _add(launches, c)
    if not all(torch.isfinite(lg).all() for lg in kernel_logits):
        raise AssertionError("non-finite decode logits")
    plain_lens = lens0.clone()
    worst = 0.0
    with _plain_kernels(), _pinned_routing(routing, differ):
        for tk, lg in zip(tokens, kernel_logits):
            plain_lg, plain_cache, plain_lens = D.decode_step(model, cfg, tk, plain_cache, plain_lens)
            worst = max(worst, _rel_err(lg, plain_lg, vocab)[0])
    log(f"[lm] {tag} decode {steps} steps x {b} sequences from {s_total} tokens: "
        f"{statistics.median(step_ms):.3f} ms/step median, {statistics.mean(step_ms):.3f} mean "
        f"(host clock, synchronised); logits vs plain kernels: max|d| / max|logit| {worst:.3e} "
        f"(tolerance {LM_LOGIT_RTOL}){_routing_note(differ)} [{card}]")
    if not worst <= LM_LOGIT_RTOL:
        raise AssertionError(f"decode logits differ from the plain-kernel model by {worst}")
    del plain_cache
    if T.main_block_kind(cfg) in ("hybrid", "xlstm"):
        # ---- the recurrent state carries what a full pass computes: the
        # first decode step's logits against forward over the prompt + token
        _zero_attention_counts()
        full_logits = T.forward(model, cfg, torch.cat([prompts, tokens[0][:, None]], dim=1), **inputs)
        _expect_counts(f"{tag} forward over prompt + token", _attention_counts(), _counts(**per_pass))
        _add(launches, per_pass)
        err, _ = _rel_err(kernel_logits[0], full_logits[:, -1], vocab)
        del full_logits
        log(f"[lm] {tag} first decode step from the prefill's state vs forward over the {s_total} + 1 "
            f"tokens: max|d| / max|logit| {err:.3e} (tolerance {LM_LOGIT_RTOL}) [{card}]")
        if not err <= LM_LOGIT_RTOL:
            raise AssertionError(f"decode step logits differ from forward over prompt + token by {err}")
    if full:
        _add(launches, decode_graph_vs_eager(model, cfg, tag, cache, lens, cache_g, lens0, tokens,
                                             kernel_logits, card))
    del cache, cache_g, kernel_logits

    # ---- serving (f32 cache, the engine's default)
    if full and serve is not None:
        _add(launches, serve_graph_vs_eager(model, cfg, dev, tag, serve_text, card, *serve))
    return launches


def run_lm_path(dev, card: str) -> dict:
    """Phase 4: Gemma3-1B at full width in bf16 (random weights from a
    seeded generator on the card) through :func:`drive_lm`: prefill and
    forward of 4 x 2048 tokens, decode from a 2112-key cache.  Returns the
    launches."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    cfg = configs.get_config("gemma3-1b")
    t0 = time.perf_counter()
    model = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers ({sum(model.is_local)} local, window "
        f"{cfg.sliding_window}), d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params "
        f"{cfg.dtype}, built on the card in {time.perf_counter() - t0:.1f} s")
    return drive_lm(dev, card, cfg, model, cfg.name, PREFILL_B, PREFILL_S, DECODE_MAX_LEN,
                    "request {i}: the quick brown fox jumps over the lazy dog")


def run_moe_mla_path(dev, card: str) -> dict:
    """Phase 4B: OLMoE-1B-7B at full width and depth, then DeepSeek-V2 at
    full width and 1 dense + 3 MoE layers, each in bf16 with random weights
    from a seeded generator on the card, through :func:`drive_lm`: prefill
    and forward of 4 x 1024 tokens, decode from a 1088-key cache, serve.
    The first model is freed before the second is built.  Returns the
    launches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as T

    launches = {}
    for arch, layers in (("olmoe-1b-7b", None), ("deepseek-v2-236b", DEEPSEEK_LAYERS)):
        cfg = configs.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        attn = (f"MLA q_lora {cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank}, {cfg.num_heads} heads of "
                f"{cfg.nope_head_dim}+{cfg.rope_head_dim}/{cfg.v_head_dim}" if cfg.attn_type == "mla"
                else f"{cfg.num_heads} heads of {cfg.resolved_head_dim}, qk-norm {cfg.qk_norm}")
        log(f"[lm] {cfg.name}: {cfg.num_layers} layers ({cfg.first_dense_layers} dense prefix, d_ff "
            f"{cfg.dense_d_ff}) of {configs.get_config(arch).num_layers}, d_model {cfg.d_model}, {attn}; "
            f"{cfg.num_experts} experts top-{cfg.experts_per_token} + {cfg.num_shared_experts} shared, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B params {cfg.dtype}, built "
            f"on the card in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _add(launches, drive_lm(dev, card, cfg, model, cfg.name, MOE_PREFILL_B, MOE_PREFILL_S,
                                MOE_MAX_LEN, "request {i}: the quick brown fox"))
        log(f"[lm] {cfg.name} took {time.perf_counter() - t0:.1f} s; memory reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        del model
    torch.cuda.empty_cache()
    return launches


def _build_lm(dev, cfg, tag: str) -> tuple:
    """A model of ``cfg`` with random weights from a seeded generator on
    the card (peak memory counted from here); logs its size."""
    from repro_torch.models import transformer as T

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[lm] {tag}: {cfg.num_layers} layers{f' + {cfg.encoder_layers} encoder' if cfg.is_encdec else ''}, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} of {cfg.resolved_head_dim}"
        f"{', qk-norm' if cfg.qk_norm else ''}, d_ff {cfg.d_ff} ({cfg.mlp_act}, {cfg.norm_type}), vocab "
        f"{cfg.vocab_size}{f', {cfg.num_vision_tokens} vision tokens' if cfg.num_vision_tokens else ''}; "
        f"{n_params / 1e9:.3f} B params {cfg.dtype}, built on the card in {time.perf_counter() - t0:.1f} s")
    return model, n_params


def _memory_line(tag: str, t0: float, card: str) -> None:
    log(f"[lm] {tag} took {time.perf_counter() - t0:.1f} s; memory reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")


def run_encdec_vlm_path(dev, card: str) -> dict:
    """Phase 4C, each model bf16 with random weights from a seeded
    generator on the card, freed before the next is built:
    whisper-large-v3 at full width and depth (``encode`` of 4 x 1500
    frames from ``conv_stub_frames``, then :func:`drive_lm`: prefill of
    4 x 224 prompt tokens over them into a 448-token cache, forward, 16
    decode steps eager and as graph replays, serve of 8 requests over 4
    slots); internvl2-26b at full width and depth (4 x (256 vision tokens
    from ``vit_stub_embeddings`` + 768 text) into a 1088-token cache, the
    same steps); qwen3-32b and internlm2-20b at full width and 4 layers
    (prefill of 4 x 512 and 4 decode steps).  Returns the launches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import frontends
    from repro_torch.models import transformer as T

    launches = {}
    # ---- whisper-large-v3: encoder-decoder, K3 cross attention
    cfg = configs.get_config("whisper-large-v3")
    t0 = time.perf_counter()
    model, _ = _build_lm(dev, cfg, cfg.name)
    frames = frontends.conv_stub_frames(torch.Generator(device=dev).manual_seed(SEED + 1), WHISPER_B,
                                        frontends.audio_frames_for_seconds(30), cfg.d_model, device=dev)
    if frames.shape[1] != cfg.encoder_seq_len or frames.shape[1] != WHISPER_FRAMES:
        raise AssertionError(f"30 s of audio gave {frames.shape[1]} frames, not {cfg.encoder_seq_len}")
    T.encode(model, cfg, frames)
    torch.cuda.synchronize()
    _zero_attention_counts()
    t1 = time.perf_counter()
    enc = T.encode(model, cfg, frames)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t1
    c = _attention_counts()
    _expect_counts(f"{cfg.name} encode", c, _counts(flash_attention=cfg.encoder_layers))
    _add(launches, c)
    with _plain_kernels():
        plain_enc = T.encode(model, cfg, frames)
    err = ((enc.float() - plain_enc.float()).abs().max() / plain_enc.float().abs().max()).item()
    log(f"[lm] {cfg.name} encode {WHISPER_B}x{frames.shape[1]} frames: {enc_s * 1e3:.1f} ms, "
        f"{WHISPER_B * frames.shape[1] / enc_s:.0f} frames/s; vs plain attention: max|d| / max|x| {err:.3e} "
        f"(tolerance {LM_LOGIT_RTOL}), finite {bool(torch.isfinite(enc).all())} [{card}]")
    if not (torch.isfinite(enc).all() and err <= LM_LOGIT_RTOL):
        raise AssertionError(f"encoder output non-finite or differs from plain attention by {err}")
    del enc, plain_enc
    _add(launches, drive_lm(dev, card, cfg, model, cfg.name, WHISPER_B, WHISPER_PROMPT, WHISPER_MAX_LEN,
                            SERVE_4C_TEXT, inputs={"encoder_frames": frames},
                            serve=(SERVE_4C_REQUESTS, SERVE_4C_SLOTS)))
    _memory_line(cfg.name, t0, card)
    del model, frames

    # ---- internvl2-26b: the VLM backbone, K3/K4 at group 6
    cfg = configs.get_config("internvl2-26b")
    t0 = time.perf_counter()
    model, _ = _build_lm(dev, cfg, cfg.name)
    vis = frontends.vit_stub_embeddings(torch.Generator(device=dev).manual_seed(SEED + 2), VLM_B,
                                        frontends.num_patches_for_resolution(448), cfg.d_model, device=dev)
    if vis.shape[1] != cfg.num_vision_tokens:
        raise AssertionError(f"448 px gave {vis.shape[1]} patches, not {cfg.num_vision_tokens}")
    _add(launches, drive_lm(dev, card, cfg, model, cfg.name, VLM_B, VLM_TEXT,
                            cfg.num_vision_tokens + VLM_TEXT + 64, SERVE_4C_TEXT,
                            inputs={"vision_embeds": vis}, serve=(SERVE_4C_REQUESTS, SERVE_4C_SLOTS)))
    _memory_line(cfg.name, t0, card)
    del model, vis

    # ---- the dense configurations at full width, depth cut
    for arch in ("qwen3-32b", "internlm2-20b"):
        full_cfg = configs.get_config(arch)
        cfg = dataclasses.replace(full_cfg, num_layers=DENSE_CUT_LAYERS)
        why = ("do not fit the 80 GB card beside its activations and caches" if arch == "qwen3-32b" else
               "are internvl2-26b's backbone, which runs whole above; cut for the run's time")
        log(f"[lm] reduced: {arch} depth {full_cfg.num_layers} -> {DENSE_CUT_LAYERS} layers at full width: "
            f"all {full_cfg.num_layers} ({full_cfg.param_count() * 2 / 1e9:.0f} GB of bf16 weights) {why}")
        t0 = time.perf_counter()
        model, _ = _build_lm(dev, cfg, f"{cfg.name} ({DENSE_CUT_LAYERS} layers)")
        _add(launches, drive_lm(dev, card, cfg, model, f"{cfg.name} ({DENSE_CUT_LAYERS} layers)", DENSE_B,
                                DENSE_S, DENSE_S + 64, "", steps=CUT_DECODE_STEPS, full=False))
        _memory_line(cfg.name, t0, card)
        del model
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- phase 6: paper datasets
def slstm_launches(model, cfg, dev, card: str) -> None:
    """Kernel launches and device time of one sLSTM layer's ``slstm_apply``
    over the LM phases' 4 x 2048 (torch.profiler), and its wall time
    unprofiled: the token loop's cost, a kernel candidate."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm

    blk = next(b for b in model.layers if b.is_slstm)
    x = _randn(np.random.default_rng(SEED + 14), (PREFILL_B, PREFILL_S, cfg.d_model), torch.bfloat16, dev)
    ssm.slstm_apply(blk.slstm, x, cfg.num_heads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ssm.slstm_apply(blk.slstm, x, cfg.num_heads)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ssm.slstm_apply(blk.slstm, x, cfg.num_heads)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0 and e.self_cpu_time_total == 0]
    kernels, busy = sum(e.count for e in rows), sum(e.self_device_time_total for e in rows) / 1e3
    n_slstm = sum(b.is_slstm for b in model.layers)
    log(f"[lm] {cfg.name} sLSTM layer over {PREFILL_B}x{PREFILL_S}: {kernels} kernel launches "
        f"({kernels / PREFILL_S:.2f} a token), {wall:.1f} ms wall (unprofiled), device busy {busy:.1f} ms "
        f"(idle {1 - busy / wall:.1%}); {n_slstm} sLSTM layers: {n_slstm * kernels} launches a prefill [{card}]")


def profile_prefill(model, cfg, dev, card: str) -> None:
    """torch.profiler over one prefill of the LM phases' 4 x 2048 (after
    one unprofiled): device busy time against the wall time, and the
    device time by kernel family — the GEMMs (cuBLAS), K6, K3, and the
    rest (elementwise, reductions, copies)."""
    from repro_torch.models import decode as D

    prompts = torch.from_numpy(np.random.default_rng(SEED + 15).integers(
        0, cfg.vocab_size, size=(PREFILL_B, PREFILL_S))).to(dev)
    wall, busy, rows = profile_steps(lambda: D.prefill(model, cfg, prompts, max_len=DECODE_MAX_LEN), n=1)
    families = {"GEMMs": ("nvjet", "gemm", "xmma", "cutlass"), "K6": ("selective_scan_kernel",),
                "K3": ("flash_attention",)}
    parts = {}
    for e in rows:
        fam = next((f for f, keys in families.items() if any(k in e.key for k in keys)), "other")
        ms, n = parts.get(fam, (0.0, 0))
        parts[fam] = (ms + e.self_device_time_total / 1e3, n + e.count)
    log(f"[lm] {cfg.name} prefill profile ({PREFILL_B}x{PREFILL_S}): {wall:.1f} ms wall (profiled), device "
        f"busy {busy:.1f} ms (idle {1 - busy / wall:.1%}); by family: "
        + ", ".join(f"{fam} {ms:.2f} ms in {n} kernels" for fam, (ms, n) in
                    sorted(parts.items(), key=lambda kv: -kv[1][0])) + f" [{card}]")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[lm]   prefill device {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d}x  {e.key[:80]}")


def run_ssm_path(dev, card: str) -> dict:
    """Phase 4D, bf16 with random weights from a seeded generator on the
    card, each model freed before the next: hymba-1.5b (full: 32 layers of
    attention — 25 query heads over 5 KV heads of 64, window 1024 but at
    layers 0/16/31 — beside Mamba heads of 3200 channels x 16 states) and
    xlstm-125m (full: 12 layers, sLSTM at 5 and 11, mLSTM elsewhere), each
    through :func:`drive_lm`: prefill and forward of 4 x 2048, 16 decode
    steps into a 2112 cache eagerly and as graph replays, the first step
    against forward over prompt + token, serve of 16 requests over 8
    slots; before it, hymba's prefill by kernel family (profiler) and one
    xlstm sLSTM layer's launches.  hymba launches K3 and K6 per layer and pass, K4 and K6 per
    layer and step; xlstm launches none of them.  Returns the launches."""
    from repro_torch import configs

    launches = {}
    for arch in ("hymba-1.5b", "xlstm-125m"):
        cfg = configs.get_config(arch)
        t0 = time.perf_counter()
        model, _ = _build_lm(dev, cfg, cfg.name)
        if cfg.family == "hybrid":
            log(f"[lm] {cfg.name}: {sum(model.is_local)} layers at window {cfg.sliding_window}, "
                f"{cfg.num_layers - sum(model.is_local)} global; Mamba {2 * cfg.d_model} channels x "
                f"{cfg.ssm_state} states, conv {cfg.ssm_conv}, beside the attention in every layer")
            profile_prefill(model, cfg, dev, card)
        else:
            n_slstm = [i for i, b in enumerate(model.layers) if b.is_slstm]
            log(f"[lm] {cfg.name}: sLSTM at layers {n_slstm}, mLSTM elsewhere ({cfg.num_heads} heads of "
                f"{2 * cfg.d_model // cfg.num_heads}); every layer holds both")
            slstm_launches(model, cfg, dev, card)
        _add(launches, drive_lm(dev, card, cfg, model, cfg.name, PREFILL_B, PREFILL_S, DECODE_MAX_LEN,
                                SERVE_4C_TEXT))
        _memory_line(cfg.name, t0, card)
        del model
    torch.cuda.empty_cache()
    return launches


def _train_counts() -> tuple[int, int, int, int]:
    """(K3 forward, K3 backward, K6 forward, K6 backward) launches so far."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops

    return (fa_ops.flash_attention_bshd.launches, fa_ops.flash_attention_bwd_bshd.launches,
            scan_ops.selective_scan.launches, scan_ops.selective_scan_bwd.launches)


def _first_step_twice(cfg, tcfg, batch, dev, card: str) -> None:
    """The first step with lr > 0 (step 1: the schedule gives lr 0 at step
    0), taken twice from one state: on the kernels (K3 forward with lse,
    K3's backward; for the hybrid K6 with h_chunks and K6's backward), then
    with K3 (and K6) swapped for their plain versions, which autograd
    differentiates.  Loss and grad norm are held to each other within
    TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL; how far the updated leaves and
    AdamW's m differ, and each run's peak memory, are printed."""
    from repro_torch.training import train_loop as loop

    state = loop.init_train_state(cfg, SEED, dev)
    state["step"].fill_(1)
    leaves = list(state["params"].parameters())
    start = [p.detach().clone() for p in leaves]
    step_fn = loop.make_train_step(cfg, tcfg)
    kernel_run = None
    plain = "plain attention" + (" and the plain scan" if cfg.family == "hybrid" else "")
    for name in ("kernels", plain):
        with torch.no_grad():
            for p, p0 in zip(leaves, start):
                p.copy_(p0)
            for t in (*state["opt"]["m"].values(), *state["opt"]["v"].values()):
                t.zero_()
        state["opt"]["count"].zero_()
        state["step"].fill_(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if name == "kernels":
            state, metrics = step_fn(state, batch)
        else:
            with _plain_kernels():
                state, metrics = step_fn(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        log(f"[train] {cfg.name} first step (step 1, {batch['tokens'].shape[0]}x{batch['tokens'].shape[1] - 1}) "
            f"on {name}: loss {loss:.6f}, grad norm {gnorm:.6f}, {ms:.1f} ms, peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        moments = list(state["opt"]["m"].values())
        if kernel_run is None:  # the kernel run's update and m, held for the plain run
            kernel_run = (loss, gnorm, [p.detach() - p0 for p, p0 in zip(leaves, start)],
                          [m.clone() for m in moments])
            continue
        lk, gk, uk, mk = kernel_run
        upd = max(((p.detach() - p0) - u).abs().max().item() for p, p0, u in zip(leaves, start, uk))
        upd /= max(u.abs().max().item() for u in uk)
        mom = max((a - b).abs().max().item() for a, b in zip(moments, mk)) / max(m.abs().max().item() for m in mk)
        log(f"[train] kernels vs {plain}: loss {abs(lk - loss) / abs(loss):.3e} (bound "
            f"{TRAIN_LOSS_RTOL}), grad norm {abs(gk - gnorm) / gnorm:.3e} (bound {TRAIN_GNORM_RTOL}) relative; "
            f"updated leaves max|Δ update| / max|update| {upd:.3e}, AdamW m {mom:.3e}")
        if abs(lk - loss) > TRAIN_LOSS_RTOL * abs(loss) or abs(gk - gnorm) > TRAIN_GNORM_RTOL * gnorm:
            raise AssertionError(f"the kernel step disagrees with the step on {plain}: loss {lk} vs {loss}, "
                                 f"grad norm {gk} vs {gnorm}")
    del state, leaves, start, kernel_run, moments
    torch.cuda.empty_cache()


def profile_train_step(step, vocab: int, card: str, tag: str) -> None:
    """torch.profiler over one steady training step (after one unprofiled,
    shapes recorded): device busy against the wall time, and the device
    time by family — K3's backward and forward and K6's backward and
    forward (kernel names; K6 for the hybrid only), AdamW with
    the gradient clip (``multi_tensor_apply`` kernels), the logits and
    cross-entropy (every op with a ``vocab``-wide input, the padded
    vocabulary the logits have: the logits
    products forward and backward, the f32 logits, logsumexp, gather and
    their gradients), the other GEMMs (cuBLAS kernel names, less the
    logits products), and the rest (norms, elementwise, copies)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0 and e.self_cpu_time_total == 0]

    def ms(rows) -> float:
        return sum(e.self_device_time_total for e in rows) / 1e3

    def named(*keys) -> list:
        return [e for e in kernels if any(k in e.key for k in keys)]

    total = ms(kernels)
    bwd, fwd = named("flash_attention_bwd"), [e for e in named("flash_attention") if "bwd" not in e.key]
    scan_bwd, scan_fwd = named("selective_scan_bwd"), named("selective_scan_kernel")
    adam, gemms = named("multi_tensor_apply"), named("nvjet", "gemm", "xmma", "cutlass", "sm90_")
    vocab_ops = [e for e in prof.key_averages(group_by_input_shape=True)
                 if e.self_cpu_time_total > 0 and "_foreach" not in e.key
                 and any(vocab in (shape or []) for shape in (e.input_shapes or []))]
    logits_mm = ms(e for e in vocab_ops if e.key == "aten::mm")
    parts = {"K3 backward": ms(bwd), "K3 forward": ms(fwd), "AdamW and clip": ms(adam),
             **({"K6 backward": ms(scan_bwd), "K6 forward": ms(scan_fwd)} if scan_fwd else {}),
             f"the {vocab}-vocab logits and cross-entropy": ms(vocab_ops), "other GEMMs": ms(gemms) - logits_mm}
    parts["norms, elementwise, copies"] = total - sum(parts.values())
    log(f"[train] {tag}: one steady step profiled: {wall:.1f} ms wall, device busy {total:.1f} ms (idle "
        f"{1 - total / wall:.1%}); by family: " + ", ".join(
            f"{name} {t:.2f} ms" for name, t in sorted(parts.items(), key=lambda kv: -kv[1]))
        + f" (of the logits and cross-entropy, the logits products {logits_mm:.2f} ms) [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[train]   step device {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d}x  {e.key[:80]}")


def train_lm(dev, card: str, arch: str, steps: int) -> dict:
    """One configuration trained at full size (f32 master weights, bf16
    compute, AdamW): the first step twice from one state, on the kernels
    and on their plain versions (:func:`_first_step_twice`); then
    ``train()`` — what ``launch/train.py`` drives — over
    ``synthetic_lm_batch_fn`` at TRAIN_B x TRAIN_S (+1) tokens for
    ``steps`` steps (warmup 1), each step's loss, grad norm, step ms
    (synchronised) and peak memory printed; per step K3 forward 2 x layers
    (the forward and each layer's recompute) and K3 backward one a layer,
    and for the hybrid the same for K6 and K6's backward, asserted; every
    loss and grad norm finite and the last loss below the first; then one
    more steady step by kernel family (:func:`profile_train_step`).
    Returns the launches of the ``steps`` steps."""
    from repro_torch import configs
    from repro_torch.data.pipeline import PrefetchIterator, ShardedBatchSource, synthetic_lm_batch_fn
    from repro_torch.training import train_loop as loop
    from repro_torch.training.optimizer import AdamWConfig

    cfg = configs.get_config(arch)
    tcfg = loop.TrainConfig(optimizer=AdamWConfig(), warmup_steps=1, total_steps=steps)
    fn = synthetic_lm_batch_fn(cfg.vocab_size, TRAIN_B, TRAIN_S)
    torch.cuda.empty_cache()
    _first_step_twice(cfg, tcfg, fn(0, 0, 0, 1), dev, card)

    torch.cuda.reset_peak_memory_stats()
    _zero_attention_counts()
    per_step, grad_norms = [], []
    last = [_train_counts()]

    def on_step(i, state, metrics):
        gnorm = float(metrics["grad_norm"])
        now = _train_counts()
        per_step.append(tuple(n - b for n, b in zip(now, last[0])))
        last[0] = now
        grad_norms.append(gnorm)
        log(f"[train] {cfg.name} step {i}: grad norm {gnorm:.4f}, K3 launches {per_step[-1][0]} forward / "
            f"{per_step[-1][1]} backward, K6 {per_step[-1][2]} forward / {per_step[-1][3]} backward, peak "
            f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    it = PrefetchIterator(ShardedBatchSource(fn, seed=0))
    t0 = time.perf_counter()
    try:
        state, history = loop.train(cfg, tcfg, it, steps, key=SEED, device=dev, log_every=10**9, on_step=on_step)
    finally:
        it.close()
    wall = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"].parameters())
    for h in history:
        log(f"[train] {cfg.name} step {h['step']}: loss {h['loss']:.4f}, step {h['sec'] * 1e3:.1f} ms "
            f"(synchronised)")
    steady = [h["sec"] for h in history[1:]]
    med = statistics.median(steady)
    log(f"[train] {cfg.name} full ({n_params / 1e9:.3f} B f32 params, bf16 compute), {steps} steps of "
        f"{TRAIN_B}x{TRAIN_S} tokens in {wall:.1f} s: step {med * 1e3:.1f} ms median of steps 1-{steps - 1} "
        f"({min(steady) * 1e3:.1f}-{max(steady) * 1e3:.1f}), {TRAIN_B * TRAIN_S / med:.0f} tokens/s, loss "
        f"{history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    losses = [h["loss"] for h in history]
    if not (len(history) == steps and all(np.isfinite(losses)) and all(np.isfinite(grad_norms))):
        raise AssertionError(f"training {cfg.name}: losses {losses}, grad norms {grad_norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training {cfg.name} did not lower the loss: {losses}")
    hybrid = cfg.family == "hybrid"
    want = (2 * cfg.num_layers, cfg.num_layers, 2 * cfg.num_layers * hybrid, cfg.num_layers * hybrid)
    if any(c != want for c in per_step):
        raise AssertionError(f"{cfg.name}: launches per step (K3 forward, K3 backward, K6 forward, K6 backward) "
                             f"{per_step}, expected {want}")
    launches = dict(zip(("flash_attention", "flash_attention_bwd", "selective_scan", "selective_scan_bwd"),
                        _train_counts()))
    step_fn, batch = loop.make_train_step(cfg, tcfg), fn(0, 0, 0, 1)
    profile_train_step(lambda: step_fn(state, batch), cfg.padded_vocab_size, card, cfg.name)
    del state, step_fn, batch
    torch.cuda.empty_cache()
    return launches


def run_training_path(dev, card: str) -> dict:
    """Phase 4E, :func:`train_lm` over two configurations: Gemma3-1B (26
    layers, d_model 1152, 4 query heads over 1 KV head of 256, window 512
    on 22 layers, vocab 262144, tied embeddings) for TRAIN_STEPS steps,
    then hymba-1.5b (32 hybrid layers: d_model 1600, 25 query heads over 5
    KV heads of 64, window 1024, Mamba 3200 channels x 16 states, conv 4,
    vocab 32001; K3 and K6 forward and backward in every layer) for
    HYMBA_TRAIN_STEPS.  Returns the launches of the trained steps."""
    launches = train_lm(dev, card, "gemma3-1b", TRAIN_STEPS)
    return _add(launches, train_lm(dev, card, "hymba-1.5b", HYMBA_TRAIN_STEPS))


def run_paper_images(dev, card: str) -> dict:
    """Phase 6A: each image dataset in the paper's four formats through a
    ``SmolRuntime`` over ResNet-18/34/50 (full depth and width, seeded
    random weights, exec throughput measured here), once under each of
    PAPER_PLANS' accuracy floors.  Returns the K1/K2 launches."""
    from repro_torch.configs.smol_resnets import CONFIGS, T4_THROUGHPUT
    from repro_torch.core.planner import ModelSpec
    from repro_torch.data import datasets
    from repro_torch.models.resnet import ResNet
    from repro_torch.preprocessing import jpeg
    from repro_torch.preprocessing.formats import PAPER_IMAGE_FORMATS
    from repro_torch.runtime import DeviceCompilerConfig, RuntimeConfig, SmolRuntime

    keys = [f.key for f in PAPER_IMAGE_FORMATS]
    log(f"[paper] accuracy table (synthetic constants: random weights have no accuracy to "
        f"measure) over {keys}: {PAPER_ACCURACY}")
    total = dict.fromkeys(_kernel_counts(), 0)
    for name, spec in datasets.IMAGE_DATASETS.items():
        t0 = time.perf_counter()
        stored, labels = datasets.image_dataset(name, PAPER_N, SEED)
        log(f"[paper] {name}: {PAPER_N} images {spec.native_size}x{spec.native_size}, "
            f"{spec.num_classes} classes, {len(set(labels.tolist()))} drawn, encoded in {keys} in "
            f"{time.perf_counter() - t0:.1f} s")
        models, specs = {}, []
        for i, mname in enumerate(PAPER_MODELS):
            model = ResNet(CONFIGS[mname], num_classes=spec.num_classes,
                           generator=torch.Generator().manual_seed(SEED + i)).to(dev)
            tput = SmolRuntime.measure_exec_throughput(model, INPUT, batch_size=BATCH, iters=8, device=dev)
            log(f"[paper]   {mname} exec throughput {tput:.1f} items/s (batch {BATCH}, {INPUT}x{INPUT}, "
                f"fp32) [{card}]; the paper's T4 (Table 2): {T4_THROUGHPUT[mname]:.0f} im/s")
            models[mname] = model
            specs.append(ModelSpec(mname, INPUT, exec_throughput=tput,
                                   accuracy_by_format=dict(zip(keys, PAPER_ACCURACY[mname]))))
        for label, min_acc, fmt_key in PAPER_PLANS:
            what = f"[paper] {name} min_accuracy {min_acc}"
            rt = SmolRuntime(
                specs, PAPER_IMAGE_FORMATS, models, calibration=stored[:4],
                config=RuntimeConfig(batch_size=PAPER_BATCH, num_workers=8, min_accuracy=min_acc,
                                     device=DeviceCompilerConfig(split_decode="full")),
                device=dev,
            )
            compiled = rt.compile()
            prog, split = compiled.device_program, label == "split decode"
            log(f"{what}: plan {compiled.plan.key}, {label}, impl {prog.impl}, stages {prog.stages}")
            if compiled.plan.fmt.key != fmt_key or prog.impl != "kernel":
                raise AssertionError(f"{what}: plan {compiled.plan.key} on {prog.impl}, expected "
                                     f"{fmt_key} on the kernels")
            if split != (compiled.coeff is not None) or split != ("dequant_idct" in prog.stages) \
                    or not prog.fused or (split and compiled.coeff.factor != 1):
                raise AssertionError(f"{what}: expected the {label} program, got {prog.stages}")
            before = prog.dispatch_count
            _kernel_counts(zero=True)
            outs, report = rt.run(stored)
            launches = _kernel_counts()
            dispatches = prog.dispatch_count - before
            st = report.stats
            log(f"{what}: {st.num_items} items in {st.batches} batches of {PAPER_BATCH}: "
                f"{st.throughput:.2f} items/s, wall {st.wall_seconds:.3f} s, host busy "
                f"{st.host_busy_seconds:.3f} s, device busy {st.device_busy_seconds:.3f} s; "
                f"launches {launches} in {dispatches} dispatches [{card}]")
            if st.batches != -(-PAPER_N // PAPER_BATCH) or dispatches != st.batches + (before == 0):
                raise AssertionError(f"{what}: {st.batches} batches, {dispatches} dispatches")
            _expect_vision_counts(what, launches, 8, dispatches if split else 0,
                                  0 if split else dispatches)
            _check_outputs(what, outs, PAPER_N, spec.num_classes)
            for k in total:
                total[k] += launches[k]
            staged = np.stack([compiled.host_fn(item) for item in stored[:PAPER_BATCH]])
            header = jpeg.peek_header(stored[0].variants[compiled.plan.fmt]) if split else None
            cpu_prog = cpu_program(compiled, models[compiled.plan.model.name], PAPER_BATCH, header)
            hold_to_cpu(f"{what} first batch", np.stack(outs[:PAPER_BATCH]), cpu_prog(staged).numpy())
        del models
    return total


def run_paper_videos(dev, card: str) -> dict:
    """Phase 6B: each video dataset at VIDEO_FRAMES frames of VIDEO_SIZE px
    (full rendition + half-size rendition): encode and host decode times
    per rendition (deblocking on and off), then the full rendition
    deblocked and the low one without deblocking through the pixel program
    (``standard_chain(VIDEO_INPUT)`` + TINY_RESNET, seeded random weights,
    one class per object count), held against the CPU.  Returns the K1/K2
    launches."""
    from repro_torch.core import dag as dag_mod
    from repro_torch.core import device_compiler as DC
    from repro_torch.core.planner import standard_chain
    from repro_torch.data import datasets
    from repro_torch.models.resnet import TINY_RESNET, ResNet
    from repro_torch.preprocessing.formats import StoredVideo
    from repro_torch.preprocessing.ops import TensorMeta

    model = ResNet(TINY_RESNET, num_classes=VIDEO_CLASSES,
                   generator=torch.Generator().manual_seed(SEED)).to(dev)
    total = dict.fromkeys(_kernel_counts(), 0)
    for name in datasets.VIDEO_DATASETS:
        t0 = time.perf_counter()
        stored, counts = datasets.video_dataset(name, VIDEO_FRAMES, SEED, size=VIDEO_SIZE)
        build_s = time.perf_counter() - t0
        # the same frames again (one process: make_video seeds from hash(name)),
        # each rendition encoded alone to time it
        frames, _ = datasets.make_video(name, VIDEO_FRAMES, SEED, VIDEO_SIZE)
        enc_ms = {}
        for fmt in stored.formats():
            t0 = time.perf_counter()
            alone = StoredVideo.from_frames(frames, formats=[fmt])
            enc_ms[fmt.key] = (time.perf_counter() - t0) * 1e3 / VIDEO_FRAMES
            if alone.variants[fmt] != stored.variants[fmt]:
                raise AssertionError(f"[video] {name}: {fmt.key} encodes differently alone")
        full, low = stored.formats()
        decoded, dec_ms = {}, {}
        for fmt, deblock in ((full, True), (full, False), (low, True), (low, False)):
            t0 = time.perf_counter()
            decoded[fmt.key, deblock] = stored.decode(fmt, deblock=deblock)
            dec_ms[f"{fmt.key} deblock={deblock}"] = (time.perf_counter() - t0) * 1e3 / VIDEO_FRAMES
        log(f"[video] {name}: {VIDEO_FRAMES} frames {VIDEO_SIZE}x{VIDEO_SIZE}, mean objects/frame "
            f"{counts.mean():.3f}, dataset built in {build_s:.2f} s; bytes "
            f"{ {f.key: stored.nbytes(f) for f in stored.formats()} }; encode ms/frame "
            f"{ {k: round(v, 4) for k, v in enc_ms.items()} }; host decode ms/frame (one thread) "
            f"{ {k: round(v, 4) for k, v in dec_ms.items()} }")
        for fmt, deblock in ((full, True), (low, False)):
            x = decoded[fmt.key, deblock]
            what = f"[video] {name} {fmt.key} deblock={deblock}"
            meta = TensorMeta(x.shape[1:], "uint8", "HWC")
            ops = dag_mod.optimize(standard_chain(VIDEO_INPUT), meta).ops
            prog = DC.compile_device_program(ops, meta, model, VIDEO_BATCH, model_key="tiny_resnet",
                                             device=dev)
            if not (prog.fused and prog.impl == "kernel"):
                raise AssertionError(f"{what}: the pixel program is not on the kernels: {prog.impl}")
            _kernel_counts(zero=True)
            t0 = time.perf_counter()
            outs = [prog(x[i:i + VIDEO_BATCH]).cpu().numpy() for i in range(0, len(x), VIDEO_BATCH)]
            prog_s = time.perf_counter() - t0
            launches = _kernel_counts()
            log(f"{what}: pixel program stages {prog.stages}, {len(outs)} dispatches of "
                f"{VIDEO_BATCH} frames in {prog_s * 1e3:.1f} ms (host clock, the first dispatch's "
                f"cold start included), launches {launches} [{card}]")
            if launches["fused_preproc"] < len(outs) or sum(launches.values()) != launches["fused_preproc"]:
                raise AssertionError(f"{what}: launches {launches} over {len(outs)} dispatches")
            for k in total:
                total[k] += launches[k]
            card_logits = np.concatenate(outs)
            _check_outputs(what, list(card_logits), VIDEO_FRAMES, VIDEO_CLASSES)
            cpu_prog = DC.compile_device_program(ops, meta, copy.deepcopy(model).cpu(), VIDEO_BATCH,
                                                 model_key="tiny_resnet", device="cpu")
            cpu_logits = np.concatenate([cpu_prog(x[i:i + VIDEO_BATCH]).numpy()
                                         for i in range(0, len(x), VIDEO_BATCH)])
            hold_to_cpu(f"{what}, all frames", card_logits, cpu_logits)
    return total


def run_scaled_decode(dev, model, exec_tput: float, card: str) -> dict:
    """Phase 6C: split decode with ``split_decode="scaled"`` over SCALED_N
    smooth 768x1024 SJPG images (4:2:0 q90): factor 2 still covers
    ``ResizeShortSide(256)``, so K1 runs at point 4 inside the program
    into phase 3's ResNet-50.  Returns the kernels' launches."""
    from repro_torch.core.planner import ModelSpec
    from repro_torch.kernels.idct import ops as idct_ops
    from repro_torch.preprocessing import jpeg
    from repro_torch.preprocessing.formats import ImageFormat, StoredImage
    from repro_torch.runtime import DeviceCompilerConfig, RuntimeConfig, SmolRuntime

    fmt = ImageFormat("jpeg", None, 90, subsample=True)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    corpus = [StoredImage.from_array(smooth_image(rng, SCALED_H, SCALED_W), [fmt], uid=i)
              for i in range(SCALED_N)]
    log(f"[scaled] corpus: {SCALED_N} images {SCALED_H}x{SCALED_W} SJPG 4:2:0 q90, encoded in "
        f"{time.perf_counter() - t0:.1f} s")
    spec = ModelSpec("resnet50", INPUT, exec_throughput=exec_tput, accuracy_by_format={fmt.key: 0.9})
    rt = SmolRuntime(
        [spec], [fmt], {"resnet50": model}, calibration=corpus[:4],
        config=RuntimeConfig(batch_size=SCALED_N, num_workers=8,
                             device=DeviceCompilerConfig(split_decode="scaled")),
        device=dev,
    )
    compiled = rt.compile()
    prog = compiled.device_program
    log(f"[scaled] plan {compiled.plan.key}, coefficient option {compiled.coeff}, impl {prog.impl}, "
        f"stages {prog.stages}")
    if compiled.coeff is None or compiled.coeff.factor != 2 or "dequant_idct/4pt" not in prog.stages:
        raise AssertionError(f"expected split decode at factor 2 (K1 at point 4): {compiled.coeff}")
    before = prog.dispatch_count
    _kernel_counts(zero=True)
    outs, report = rt.run(corpus)
    launches, by_point = _kernel_counts(), dict(idct_ops.idct_rows.launches_by_point)
    dispatches = prog.dispatch_count - before
    st = report.stats
    log(f"[scaled] {st.num_items} items in {st.batches} batch: {st.throughput:.2f} items/s, wall "
        f"{st.wall_seconds:.3f} s; launches {launches}, K1 by point {by_point}, {dispatches} "
        f"dispatches [{card}]")
    if by_point != {8: 0, 4: 2 * dispatches, 2: 0, 1: 0}:
        raise AssertionError(f"K1 by point {by_point}; expected K1 x2 at point 4 in each of "
                             f"{dispatches} dispatches")
    _expect_vision_counts("[scaled]", launches, 4, dispatches)
    _check_outputs("[scaled]", outs, SCALED_N, 1000)
    staged = np.stack([compiled.host_fn(item) for item in corpus])
    header = jpeg.peek_header(corpus[0].variants[fmt])
    t0 = time.perf_counter()
    cpu_logits = cpu_program(compiled, model, SCALED_N, header)(staged).numpy()
    log(f"[scaled] the batch on the CPU in {time.perf_counter() - t0:.1f} s")
    hold_to_cpu("[scaled] the batch", np.stack(outs), cpu_logits)
    on_dev = torch.from_numpy(staged).to(dev)
    with torch.inference_mode():
        program_ms = median_ms(lambda: prog.fn(on_dev), None, iters=5, warmup=1)
        device_ms = median_ms(lambda: prog.fn(on_dev), None, iters=5, warmup=1, spin=LONG_SPIN)
    log(f"[scaled] device program per batch of {SCALED_N} at factor 2: {program_ms:.3f} ms after a "
        f"~1 ms spin, {device_ms:.3f} ms after a ~23 ms spin (the host's enqueue hidden; CUDA "
        f"events) [{card}]")
    return launches


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
        if any(w in line for w in ("registers", "spill", "Compiling entry", "warning", "wgmma")):
            log(f"[env] ptxas: {line.strip()}")
    check_kernel_code(_build)

    # ---- phase 2: kernels at the main path's shapes
    full = ImageFormat("jpeg", None, 90, subsample=True)
    thumb = ImageFormat("jpeg", 161, 75, subsample=True)
    pixel_meta = TensorMeta((IMG_H, IMG_W, 3), "uint8", "HWC")
    low = DC.lower_device_ops(dag_mod.optimize(standard_chain(INPUT), pixel_meta).ops, pixel_meta)
    for (n, n_br, n_bc, _), (h, w) in ((PHASE3_GRID, (IMG_H, IMG_W)), (SCALED_GRID, (SCALED_H, SCALED_W))):
        probe = jpeg.peek_header(jpeg.encode(smooth_image(np.random.default_rng(1), h, w),
                                             quality=90, subsample=True))
        if (probe.n_br, probe.n_bc) != (n_br, n_bc):
            raise AssertionError(f"{h}x{w} codes {probe.n_br}x{probe.n_bc} blocks, not {n_br}x{n_bc}")
    log("[kernels] idct vs plain (atol 2e-2), blocks_to_rgb and fused_preproc vs plain (equal)")
    idct_err = check_idct(dev, PHASE3_GRID[0] * PHASE3_GRID[1] * PHASE3_GRID[2])
    zigzag_err = check_idct_zigzag(dev)
    b2r_err = check_blocks_to_rgb(dev)
    fp_err = check_fused_preproc(dev, low)
    torch.cuda.synchronize()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    rows = [time_idct(dev, PHASE3_GRID, 8, flush), time_idct(dev, SCALED_GRID, 4, flush),
            time_blocks_to_rgb(dev, flush), time_fused_preproc(dev, low, flush)]
    rows[0]["max_abs_err"] = max(idct_err[8], zigzag_err["idct"])
    rows[1]["max_abs_err"] = max(idct_err[4], idct_err[2], zigzag_err["idct_scaled"])
    rows[2]["max_abs_err"] = b2r_err
    rows[3]["max_abs_err"] = fp_err
    log(f"[kernels] flash_attention and decode_attention vs plain (f32 atol {ATTN_F32_ATOL}; "
        f"bf16 elementwise 2^-7 |plain| + {ATTN_BF16_ATOL})")
    attn_errs = {**check_flash_attention(dev), "flash_attention_cross": check_flash_attention_cross(dev),
                 "decode_attention": check_decode_attention(dev)}
    log(f"[kernels] flash_attention's lse vs plain (atol {LSE_ATOL}, base 2); flash_attention_bwd vs its plain "
        f"backward (dq, dk, dv each: bf16 {BWD_BF16_RTOL:g}, f32 {BWD_F32_RTOL:g} of max|plain|)")
    lse_err = check_flash_attention_lse(dev)
    log(f"[kernels] flash_attention lse: largest |kernel - plain| {lse_err:.3e}")
    attn_errs["flash_attention_bwd"] = check_flash_attention_bwd(dev)
    for timed in (time_flash_attention(dev, flush), time_flash_attention_mla(dev, flush),
                  time_flash_attention_cross(dev, flush), time_decode_attention(dev, flush),
                  time_flash_attention_bwd(dev, flush)):
        timed["max_abs_err"] = attn_errs[timed["name"]]
        rows.append(timed)
    log(f"[kernels] selective_scan vs plain (f32 state; {SCAN_RTOL:g} of max|plain|; bf16(y) 2^-7 |plain| + "
        f"{SCAN_BF16_ATOL:g} max|plain|; the gate bitwise the eager gate on the kernel's y)")
    scan_err = check_selective_scan(dev)
    rows += [{**row, "max_abs_err": scan_err} for row in time_selective_scan(dev, flush)]
    log(f"[kernels] selective_scan_bwd vs its plain backward (f32 {SCAN_RTOL:g} of max|plain|; bf16 dxc, d proj "
        f"2^-7 |plain| + {SCAN_BF16_ATOL:g} max|plain|; dz against the eager gate's backward on the kernel's y, and "
        f"{SCAN_DZ_STEPS} such steps of the plain backward's)")
    scan_bwd_err = check_selective_scan_bwd(dev)
    rows.append({**time_selective_scan_bwd(dev, flush), "max_abs_err": scan_bwd_err})
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
    _expect_vision_counts("[main]", launches, 8, dispatches)
    _check_outputs("[main]", outs, N_ITEMS, 1000)
    hold_to_cpu("[main] first batch", np.stack(outs[:BATCH]), res["cpu_logits"])

    del compiled, prog, outs
    # ---- phase 4: the LM serving path (Gemma3-1B)
    t0 = time.perf_counter()
    launches.update(run_lm_path(dev, card))
    log(f"[lm] phase 4 took {time.perf_counter() - t0:.1f} s")
    # ---- phase 4B: the MoE and MLA decoders (OLMoE-1B-7B, DeepSeek-V2 at 1 + 3 layers)
    t0 = time.perf_counter()
    _add(launches, run_moe_mla_path(dev, card))
    log(f"[lm] phase 4B took {time.perf_counter() - t0:.1f} s")
    # ---- phase 4C: encoder-decoder and VLM (whisper-large-v3, internvl2-26b), and the dense configurations
    t0 = time.perf_counter()
    _add(launches, run_encdec_vlm_path(dev, card))
    log(f"[lm] phase 4C took {time.perf_counter() - t0:.1f} s")
    # ---- phase 4D: the hybrid and xLSTM stacks (hymba-1.5b, xlstm-125m)
    t0 = time.perf_counter()
    _add(launches, run_ssm_path(dev, card))
    log(f"[lm] phase 4D took {time.perf_counter() - t0:.1f} s")
    # ---- phase 4E: Gemma3-1B and hymba-1.5b trained at full size (K3 and K6 forward and backward)
    t0 = time.perf_counter()
    _add(launches, run_training_path(dev, card))
    log(f"[train] phase 4E took {time.perf_counter() - t0:.1f} s")
    # ---- phase 5: the vision serving path over phase 3's model and corpus
    t0 = time.perf_counter()
    run_vision_serving(dev, corpus, full, thumb, res, card)
    log(f"[serve] phase 5 took {time.perf_counter() - t0:.1f} s")
    model, exec_tput = res["model"], res["spec"].exec_throughput
    del res, corpus
    # ---- phase 6: the paper's datasets, and scaled split decode
    t0 = time.perf_counter()
    for part in (run_paper_images(dev, card), run_paper_videos(dev, card),
                 run_scaled_decode(dev, model, exec_tput, card)):
        for k, v in part.items():
            launches[k] += v
    log(f"[paper] phase 6 took {time.perf_counter() - t0:.1f} s")
    del model
    for row in rows:
        row["launches"] = launches[row["name"]]
    idle = [row["name"] for row in rows if not row["launches"]]
    if idle:
        raise AssertionError(f"kernels the path never launched: {idle}")
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
