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
   beside the launch floor of an empty kernel, and K4 with its
   log-sum-exp on a model device's slice of a sequence-split cache (the
   lengths less the slice's first key), 8 such slices merged against one
   launch over the whole cache; K6 (the selective scan,
   from the x_proj output to the gated rows) at hymba-1.5b's layer, S =
   1, 37 and 2048, with and without h0, ``z=None`` (y in f32) and gated,
   and at the serving mesh's per-shard shapes (2 rows of 2048 and S = 1
   at 2 rows and 1), timed at the prefill layer and at a decode step;
   K3's row log-sum-exp (the backward's input) and K3's backward (dQ,
   then dK/dV) against their plain versions at Gemma3-1B's training layers (4 x 1024, global and
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
   once by kernel family; phase 4F drives the training mesh on logical
   devices of the card (one CUDA stream each): the ring all-reduce on 2
   and 4 streams bitwise the CPU's (also behind a ~23 ms spin on a
   sender's stream), the bucketed psum and the EF-int8 all-reduce, the
   ring's time over 4 GiB a device against its byte bound; Gemma3-1B full
   data-parallel on two streams with ZeRO-1 moments (the first step
   against the single-device step, the copies bitwise equal after it, 3
   more steps, K3 forward 52 and backward 26 launches a data shard a
   step); OLMoE-1B-7B at full width and 2 layers (``reduced``) on a
   (2, 2) mesh, its expert-parallel MoE forward bitwise its serial
   definition, then 3 steps; phase 4G serves on (2, 2) streams
   (``decode.make_mesh_prefill`` / ``make_mesh_decode_step``, the cache
   split by heads and rows): Gemma3-1B full (prefill 4 x 2048, 16 greedy
   steps from a 2112-key cache), qwen3-32b and OLMoE-1B-7B at full width
   and 2 layers (``reduced``; OLMoE's prefill expert-parallel, its decode
   routing the whole batch on the first shard's model group, the experts
   split), each against the single-device run, bitwise its serial run,
   K3/K4 once a layer on each model device as the dry run counts, placed
   bytes the spec trees' at 2 bytes plus the port's f32 leaves; then the
   cache split by sequence (Gemma3-1B's 4 heads over 1 split no group):
   (a) Gemma3-1B full on (1, 8), the same prefill and steps, K3 on the
   lead alone and K4 on every device with its log-sum-exp, the partials
   merged; (b) Gemma3-1B full on (2, 8) at batch 1 over a seeded random
   cache of long_500k's 524,288 keys placed with ``place_cache``, 4 steps,
   held the same way; then the recurrent states: xlstm-125m full on (2, 2)
   (its 4 mLSTM heads split) and (1, 8) (the heads whole on every device,
   96 sLSTM channels a device), hymba-1.5b full on (2, 2) (Mamba's
   channels split beside its sequence-split attention cache), each layer's
   recurrent branch on the data shard's lead (K6 there for Mamba) and the
   new state sent to every holder; (c) hymba-1.5b full on (2, 8) at batch
   1 over 524,288 keys, its Mamba states whole on both data indices;
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
   program's time per batch eager and as a replay; phase 5B drives the
   replica mesh on two logical devices of the card (each its own CUDA
   stream; ``REPRO_TORCH_FORCE_DEVICE_COUNT=2`` for the phase): a readback
   ordered behind a program that spins on the second stream, one replica
   and ``MeshConfig(replicas=2)`` serving the corpus in turns (outputs as
   ``run()``'s, both replicas serving, each replica's graphs its own with
   K1 x2, K5 x1 and K2 x1), ``fail_replica(1)`` halfway through a burst
   (no request lost), and one replica sharded over both devices (even
   buckets, each member's graphs replayed); prints items/s of one replica
   and of two, the memory reserved around each warmup, and the two
   replicas' graphs replayed on one stream against two at once;
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
7. the dry run against the card (``repro_torch.launch.dryrun``): inside
   phase 4, Gemma3-1B's prefill of 4 x 2048 and a decode step at phase 4's
   batch and cache; inside phase 4E, one Gemma3-1B and one hymba-1.5b
   training step at 4 x 1024.  Each step's record, traced on the host (meta
   tensors, nothing on the card), is held against one call of the step on
   the card: argument bytes against the bytes placed (2%), the peak
   estimate against the step's peak (10%; both as the allocator requested
   them, its rounded memory_allocated figures printed beside), the aten
   dot FLOPs against the profiler's (1%), the kernel launches exactly, and
   each roofline term at most 1.05x the step's device busy time; and the
   CLI on one cell of the single-pod mesh, on the host beside phase 2;
8. the kernels' JSON line, the card line, and ``{"ok": true, ...}`` last.

It imports nothing of JAX and nothing of the reference ``repro`` package.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the H100 SXM's published peaks (the denominators of every bound below) and
# the LM kernels' cost functions live in the package: kernels/cost.py and
# each kernel's ops.py (imported where used: the A/B tools import this file
# beside another checkout's package)

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
# K4's log-sum-exp (natural log, f32) vs the plain one's: the kernel sums exp of f32 scores over its chunks in
# another order (~1e-6 relative of sums of a few hundred); scores of random q, k are ~N(0, 1), lse ~ 6-12
DECODE_LSE_ATOL = 1e-4
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


def bound_ms(nbytes: float, flops: float, dtype: str = "float32") -> tuple[float, str]:
    """The vision kernels' bounds: ``flops`` at ``dtype``'s peak against
    ``nbytes`` at the HBM's rate."""
    from repro_torch.kernels.cost import KernelCost

    return KernelCost({dtype: flops}, 0.0, nbytes).bound_ms()


# ------------------------------------------------------------ phase 1: build
# the redesigned kernels and the instruction their SASS must hold: tensor
# cores (K3 bf16, K1 at every point), TMA bulk copies (K4), cp.async
# copies into shared memory (K2; K6's double-buffered rows), the cluster
# barrier (K6 backward: its sums over channels through distributed shared
# memory, PR 27; was LDGSTS)
DESIGNED_KERNELS = {"flash_attention_tc_kernel": "HGMMA", "idct_rows_tc_kernel": "HMMA",
                    "flash_decode_kernel": "UBLKCP", "resize_affine_band_kernel": "LDGSTS",
                    "selective_scan_kernel": "LDGSTS", "flash_attention_bwd_dq_tc_kernel": "HGMMA",
                    "flash_attention_bwd_dkdv_tc_kernel": "HGMMA", "selective_scan_bwd_kernel": "UCGABAR_ARV"}
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


_SASS: dict = {}


def sass_text(build) -> str:
    """``cuobjdump --dump-sass`` of the built library (once a process)."""
    path = build.build_info["path"]
    if path not in _SASS:
        cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
        _SASS[path] = subprocess.run([str(cuobjdump), "--dump-sass", path], capture_output=True, text=True,
                                     timeout=300, check=True).stdout
    return _SASS[path]


# SASS opcodes by the pipe that issues them
SASS_PIPES = {"fma": ("FFMA", "FMUL", "FADD", "FMNMX", "HFMA2"), "sfu": ("MUFU",), "shfl": ("SHFL",),
              "smem": ("LDS", "STS", "LD", "ST"), "global": ("LDG", "STG", "LDGSTS", "LDL", "STL"),
              "alu": ("FSEL", "FSETP", "ISETP", "LOP3", "SEL", "SHF", "IADD3", "LEA", "PLOP3", "MOV", "IMAD", "PRMT",
                      "F2F", "F2FP", "I2F", "F2I", "IABS", "VIADD", "CS2R", "S2R")}


def sass_opcodes(build, key: str) -> dict:
    """Static opcode counts (predicates and modifiers dropped) of each
    function of the built library whose name holds ``key``."""
    import collections
    import re

    counts, name = {}, None
    for line in sass_text(build).splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            if key in name:
                counts[name] = collections.Counter()
        elif name in counts:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[name][m.group(1)] += 1
    return counts


def check_kernel_code(build) -> None:
    """The redesigned kernels were compiled as designed: their SASS
    (``cuobjdump --dump-sass`` of the built library) holds HGMMA (K3 bf16
    and its backward's dQ and dK/dV kernels, ``wgmma``), HMMA (every instance of K1's template, ``mma.sync`` tf32),
    UBLKCP (K4, TMA bulk copies), LDGSTS (``cp.async``: K2, and every
    instance of K6, its staged rows) and UCGABAR_ARV (every instance of
    K6's backward, its cluster barrier), by the opcodes of
    :func:`sass_opcodes`, and ptxas reports no spills for
    them and serialises no ``wgmma`` (when this process built the
    library)."""
    counts = sass_opcodes(build, "")
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
                          "tf32")
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
    shape 4 x 2048, window and none, in f32 and bf16; a model device's
    share of Gemma3-1B's training layer on the (2, 2) training mesh, 2 x
    1024, 2 heads over 1, window 512 and none, bf16; a model device's
    share in phase 4G's prefill, 2 x 2048: Gemma3-1B's 2 heads over 1,
    window 512 and none, qwen3-32b's 32 over 4 and OLMoE's 8 over 8 of
    128, bf16) and 128/64 (GQA; whisper-large-v3's 10 heads of 64 a model
    device of (2, 2), 2 x 1500 non-causal, its encoder, and 2 x 224
    causal),
    ragged S, causal and not; for the bf16 tensor-core kernel also the
    edges of its 128-row query and 64-key tiles (S = 1, 63, 65, 127, 129,
    2049), windows that end inside a tile (64, 100), groups 1/4/8, D
    64/128/256, causal off, and q/k/v as (B, H, S, D) views; K and V
    expanded (stride 0) over the batch or the KV heads; then the MLA
    instance, q/k 192 and v 128: DeepSeek-V2's prefill shape (4 x 1024, 128
    heads, group 1, causal) in bf16 and f32, a model device's share in
    phase 4G's prefill (2 x 2048 at 64 heads on (2, 2), 4 x 2048 at 16 on
    (1, 8)), OLMoE's (16 heads of 128),
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
        # a model device's heads of Gemma3-1B on the (2, 2) training mesh: 2 query heads over the 1 KV head
        (TRAIN_B // 2, TRAIN_S, 2, 1, 256, True, GEMMA_WINDOW, torch.bfloat16),
        (TRAIN_B // 2, TRAIN_S, 2, 1, 256, True, None, torch.bfloat16),
        # a model device's heads in phase 4G's prefill on (2, 2): a data shard's 2 x 2048 rows, Gemma3-1B's 2 query
        # heads over its 1 KV head, qwen3-32b's 32 over 4 and OLMoE's 8 over 8
        (PREFILL_B // 2, PREFILL_S, 2, 1, 256, True, GEMMA_WINDOW, torch.bfloat16),
        (PREFILL_B // 2, PREFILL_S, 2, 1, 256, True, None, torch.bfloat16),
        (PREFILL_B // 2, PREFILL_S, 32, 4, 128, True, None, torch.bfloat16),
        (PREFILL_B // 2, PREFILL_S, 8, 8, 128, True, None, torch.bfloat16),
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
        # a model device's heads of whisper-large-v3 in phase 4G's prefill on (2, 2): a data shard's 2 rows, 10 of
        # the 20 heads, the encoder over 1500 frames and the decoder's self attention over the 224-token prompt
        (WHISPER_B // 2, WHISPER_FRAMES, WHISPER_HEADS // 2, WHISPER_HEADS // 2, WHISPER_HD, False, None,
         torch.bfloat16),
        (WHISPER_B // 2, WHISPER_PROMPT, WHISPER_HEADS // 2, WHISPER_HEADS // 2, WHISPER_HD, True, None,
         torch.bfloat16),
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
        # a model device's heads in phase 4G's prefill: a data shard's 2 x 2048 rows, 64 of the 128 heads on (2, 2);
        # the 4 x 2048 rows, 16 heads on (1, 8)
        (PREFILL_B // 2, PREFILL_S, 64, 64, True, None, torch.bfloat16),
        (PREFILL_B, PREFILL_S, 16, 16, True, None, torch.bfloat16),
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
    cost = fa_ops.flash_attention_cost(b, s, s, h, h, dqk, dv, True, None, dt)
    layer_bound, by = cost.bound_ms()
    log(f"  flash_attention MLA layer ({b}x{s}, {h} heads, q/k {dqk} v {dv}, causal, bf16): kernel "
        f"{kernel:.4f} ms ({layer_bound / kernel:.1%} of its {layer_bound:.4f} ms bound, {by}), plain "
        f"{plain:.4f} ms, SDPA is_causal {library:.4f} ms ({_sdpa_backend(qt, kt, vt, None, True)}); "
        f"yardstick: the (256, 256) instance on zero-padded copies {padded:.4f} ms")
    n = DEEPSEEK_LAYERS
    b_ms, b_by = (n * cost).bound_ms()
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
    (4 x 224 decoder rows over 1500 encoder frames; a model device's share
    in phase 4G's prefill on (2, 2), 2 x 224 at 10 heads) and at ragged Sq (1, 63,
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
    # a model device's cross attention in phase 4G's prefill on (2, 2): 2 rows x 224 over 1500 frames, 10 heads
    cases.append((WHISPER_B // 2, WHISPER_PROMPT, WHISPER_FRAMES, h // 2, h // 2, d, False, None, torch.bfloat16))
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
    cost = fa_ops.flash_attention_cost(b, sq, sk, h, h, d, d, False, None, dt)
    layer_bound, by = cost.bound_ms()
    log(f"  flash_attention cross layer (whisper: {b}x{sq} rows over {sk} frames, {h} heads of {d}, "
        f"non-causal, bf16): kernel {kernel:.4f} ms ({layer_bound / kernel:.1%} of its {layer_bound:.4f} ms "
        f"bound, {by}), plain {plain:.4f} ms, SDPA no mask {library:.4f} ms "
        f"({_sdpa_backend(qt, kt, vt, None, False)})")
    n = 32  # decoder layers of whisper-large-v3
    b_ms, b_by = (n * cost).bound_ms()
    # K4 over the cross cache: one query token per sequence, all 1500 keys valid
    qd = _randn(rng, (b, h, d), dt, dev)
    kc, vc = (_randn(rng, (b, sk, h, d), dt, dev) for _ in range(2))
    lens = torch.full((b,), sk, dtype=torch.int32, device=dev)
    k4 = median_ms(lambda: da_ops.decode_attention_cache(qd, kc, vc, lens), flush)
    k4_plain = median_ms(lambda: da_plain.decode_attention(qd, kc, vc, lens), flush)
    k4_lib = median_ms(lambda: F.scaled_dot_product_attention(qd[:, :, None], kc.transpose(1, 2),
                                                              vc.transpose(1, 2)), flush)
    k4_bound, k4_by = da_ops.decode_attention_cost(b, sk, h, h, d, None, dt, dt, keys=b * sk).bound_ms()
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

    from repro_torch.kernels.cost import KernelCost
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain

    rng = np.random.default_rng(SEED + 3)
    b, s, h, kvh, d, dt = PREFILL_B, PREFILL_S, 4, 1, 256, torch.bfloat16
    q, k, v = (_randn(rng, (b, s, n, d), dt, dev) for n in (h, kvh, kvh))
    # SDPA's (B, H, S, D) layout, made once outside the timed calls
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pos = torch.arange(s, device=dev)
    totals, cost = dict(ms=0.0, plain_ms=0.0, library_ms=0.0), KernelCost()
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
        cost = cost + n_layers * fa_ops.flash_attention_cost(b, s, s, h, kvh, d, d, True, window, dt)
    b_ms, b_by = cost.bound_ms()
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
    layer_bound, by = fa_ops.flash_attention_cost(b, s, s, h, h, d, d, True, None, dt).bound_ms()
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
    causal, global and window 512) in bf16 and f32, a model device's share
    of them on the (2, 2) training mesh (2 x 1024, 2 heads over 1) in
    bf16, then ragged S (1, 33,
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
        # a model device's heads on the (2, 2) training mesh: 2 x 1024, 2 query heads over the 1 KV head
        (TRAIN_B // 2, TRAIN_S, TRAIN_S, 2, 1, 256, 256, True, None, torch.bfloat16),
        (TRAIN_B // 2, TRAIN_S, TRAIN_S, 2, 1, 256, 256, True, GEMMA_WINDOW, torch.bfloat16),
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
    from repro_torch.kernels.cost import KernelCost
    from repro_torch.kernels.flash_attention import ops as fa_ops

    rng = np.random.default_rng(SEED + 14)
    b, s, h, kvh, d, dt = TRAIN_B, TRAIN_S, 4, 1, 256, torch.bfloat16
    pos = torch.arange(s, device=dev)
    totals, cost = dict(ms=0.0, plain_ms=0.0, library_ms=0.0), KernelCost()
    for window, n_layers in ((None, N_GLOBAL), (GEMMA_WINDOW, N_LOCAL)):
        q, k, v, out, lse, do = _bwd_inputs(rng, b, s, s, h, kvh, d, d, True, window, dt, dev)
        mask = None if window is None else (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        kernel, plain, library, backend = _bwd_layer_ms(q, k, v, out, lse, do, window, flush, mask)
        layer = fa_ops.flash_attention_bwd_cost(b, s, s, h, kvh, d, d, True, window, dt)
        layer_bound, by = layer.bound_ms()
        log(f"  flash_attention_bwd {'global' if window is None else f'local (window {window})'} layer "
            f"({b}x{s}, D {d}, bf16): kernel {kernel:.4f} ms ({layer_bound / kernel:.1%} of its "
            f"{layer_bound:.4f} ms bound, {by}), plain {plain:.4f} ms, SDPA backward {library:.4f} ms "
            f"({backend})")
        totals["ms"] += n_layers * kernel
        totals["plain_ms"] += n_layers * plain
        totals["library_ms"] += n_layers * library
        cost = cost + n_layers * layer
        del q, k, v, out, lse, do
    b_ms, b_by = cost.bound_ms()
    log(f"  flash_attention_bwd per step ({N_GLOBAL} global + {N_LOCAL} local launches): kernel "
        f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, SDPA backward {totals['library_ms']:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}, bf16 peak)")
    (dqk, dv), b, s, h = MLA_DIMS, MOE_PREFILL_B, MOE_PREFILL_S, MLA_HEADS
    q, k, v, out, lse, do = _bwd_inputs(rng, b, s, s, h, h, dqk, dv, True, None, dt, dev)
    kernel, plain, library, backend = _bwd_layer_ms(q, k, v, out, lse, do, None, flush)
    mla_bound, by = fa_ops.flash_attention_bwd_cost(b, s, s, h, h, dqk, dv, True, None, dt).bound_ms()
    log(f"  flash_attention_bwd MLA layer ({b}x{s}, {h} heads, q/k {dqk} v {dv}, causal, bf16): kernel "
        f"{kernel:.4f} ms ({mla_bound / kernel:.1%} of its {mla_bound:.4f} ms bound, {by}), plain {plain:.4f} "
        f"ms, SDPA backward {library:.4f} ms ({backend})")
    del q, k, v, out, lse, do
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
    serve shape; a model device's cache slice in phase 4G's decode, 2 rows
    of 2112 keys from 2048: Gemma3-1B's 2 heads over 1, window 512 and
    none, qwen3-32b's 32 over 4 and OLMoE's 8 over 8 of 128;
    whisper-large-v3's 10 heads of 64 over 2 rows of its 1500-key cross
    cache and of its 448-key self cache) and 128/64 (GQA, up to 8 heads a
    group), window and none,
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
        # a model device's cache slice in phase 4G's decode on (2, 2): a data shard's 2 rows of the 2112-key cache,
        # Gemma3-1B's 2 query heads over its 1 cache head (kv 1 stored twice), qwen3-32b's 32 over 4, OLMoE's 8 over 8
        (PREFILL_B // 2, s, 2, 1, 256, w, torch.bfloat16, torch.bfloat16, [PREFILL_S, PREFILL_S + 9]),
        (PREFILL_B // 2, s, 2, 1, 256, None, torch.bfloat16, torch.bfloat16, [PREFILL_S + 4, PREFILL_S + 15]),
        (PREFILL_B // 2, s, 32, 4, 128, None, torch.bfloat16, torch.bfloat16, [PREFILL_S + 1, PREFILL_S + 3]),
        (PREFILL_B // 2, s, 8, 8, 128, None, torch.bfloat16, torch.bfloat16, [PREFILL_S, PREFILL_S + 2]),
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
        # a model device's slices in phase 4G's whisper decode on (2, 2): a data shard's 2 rows, 10 of the 20 heads,
        # its cross cache (every one of the 1500 keys valid) and its self cache of 448 keys from 224
        (WHISPER_B // 2, WHISPER_FRAMES, WHISPER_HEADS // 2, WHISPER_HEADS // 2, WHISPER_HD, None, torch.bfloat16,
         torch.bfloat16, [WHISPER_FRAMES] * (WHISPER_B // 2)),
        (WHISPER_B // 2, WHISPER_MAX_LEN, WHISPER_HEADS // 2, WHISPER_HEADS // 2, WHISPER_HD, None, torch.bfloat16,
         torch.bfloat16, [WHISPER_PROMPT + 1, WHISPER_PROMPT + 4]),
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
    worst = max(worst, check_decode_attention_lse(dev))
    _expect_zero_counters("decode_attention", f"after {len(cases)} launches and the lse cases")
    return worst


def check_decode_attention_lse(dev) -> float:
    """K4 with its log-sum-exp (``return_lse``) against the plain version
    at phase 4G's sequence-split shapes: head_dim 256, Gemma3-1B's 4 heads
    over 1, a bf16 cache, q f32 — a model device's slice of the 2112-key
    cache over 8 (264 keys) called with the global lengths less its first
    key (below 0 and above S among them), a 512-key window straddling two
    slices, and slices with no valid key (lse -1e30, the output the mean of
    V); the output held as every f32 case, the lse within DECODE_LSE_ATOL.
    Then 8 slices' (out, lse) merged (``merge_partials``) against one K4
    call on the whole cache, within the f32 bound.  The same at phase 4G's
    whisper-large-v3 self-attention slices on (1, 8): 4 rows, 56 of 448
    keys a device, 20 heads of 64.  The same at phase 4G
    (b)'s shapes: batch 1, a seeded random bf16 cache of LONG_KEYS keys
    over its 16 devices (32,768 keys a slice, where K4 takes 64-key chunks
    and 512 splits), at the last decode step's length LONG_FROM +
    LONG_STEPS — with no window every slice up to device 15, which holds
    the last keys; with the 512-key window the keys straddling devices 14
    and 15, and 14 slices with no valid key, whose output averages V's
    32,768 rows — each slice against the plain version, then the 16 merged
    as the model merges them (each group of 8, then the two) against one K4
    call over all LONG_KEYS keys.  Returns the largest output error."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import plain as da_plain

    rng = np.random.default_rng(SEED + 14)
    n, dt = 8, torch.float32
    w, ww = DECODE_MAX_LEN // n, WHISPER_MAX_LEN // n
    cases = [  # B, the cache's keys, H, KVH, D, [(global lengths, window)]: Gemma3-1B's decode's, a window across
        # slices 1 and 2, past the cache, none valid; whisper-large-v3's on (1, 8), 56 of 448 keys a device, 20
        # heads of 64 (its decode's lengths, and lengths ending in slices 1, 2 and 7)
        (PREFILL_B, DECODE_MAX_LEN, 4, 1, 256, [
            ([PREFILL_S, PREFILL_S + 5, PREFILL_S + 9, PREFILL_S + 15], None),
            ([PREFILL_S, PREFILL_S + 5, PREFILL_S + 9, PREFILL_S + 15], GEMMA_WINDOW),
            ([w + 100, 2 * w + 40, 2 * w + 200, w + 1], GEMMA_WINDOW),
            ([0, DECODE_MAX_LEN + GEMMA_WINDOW, 5, 3 * w], GEMMA_WINDOW)]),
        (WHISPER_B, WHISPER_MAX_LEN, WHISPER_HEADS, WHISPER_HEADS, WHISPER_HD, [
            ([WHISPER_PROMPT + i for i in range(WHISPER_B)], None),
            ([ww + 3, 2 * ww + 17, WHISPER_MAX_LEN - 1, 0], None)]),
    ]
    worst = 0.0
    for b, s, h, kvh, d, glob in cases:
        w = s // n
        q = _randn(rng, (b, h, d), dt, dev)
        kc, vc = (_randn(rng, (2, b, s, kvh, d), torch.bfloat16, dev) for _ in range(2))
        for lens_list, window in glob:
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            outs, lses = [], []
            for j in range(n):
                ks, vs = kc[1][:, j * w:(j + 1) * w], vc[1][:, j * w:(j + 1) * w]
                local = lens - j * w
                got, lse = da_ops.decode_attention_cache(q, ks, vs, local, window=window, return_lse=True)
                want, want_lse = da_plain.decode_attention(q, ks, vs, local, window=window, return_lse=True)
                torch.cuda.synchronize()
                err, inside, tol = _attn_bound(got, want, dt)
                lse_err = (lse - want_lse).abs().max().item()
                empty = want_lse <= da_plain.NEG_INF
                inside &= lse_err <= DECODE_LSE_ATOL and bool((lse[empty] == want_lse[empty]).all())
                log(f"  decode_attention lse B={b} H={h} KVH={kvh} D={d} slice {j} of {n} ({w} keys from {j * w}) "
                    f"lengths {local.tolist()} window={window}: max|kernel-plain| out {err:.3e} (bound {tol}), lse "
                    f"{lse_err:.3e} (bound {DECODE_LSE_ATOL}); no valid key in {int(empty[:, 0].sum())} rows")
                if not (lse.dtype == torch.float32 and lse.shape == (b, h) and inside):
                    raise AssertionError(f"decode_attention's lse disagrees with its plain version: {err} / {lse_err}")
                worst = max(worst, err)
                outs.append(got)
                lses.append(lse)
            merged = da_ops.merge_partials(outs, lses)
            whole = da_ops.decode_attention_cache(q, kc[1], vc[1], lens, window=window)
            torch.cuda.synchronize()
            err, inside, tol = _attn_bound(merged, whole, dt)
            log(f"  decode_attention: {n} slices merged vs one launch over the {s}-key cache (H={h}, D={d}), "
                f"lengths {lens_list} window={window}: max|merged-whole|={err:.3e} (bound {tol})")
            if not inside:
                raise AssertionError(f"{n} merged K4 slices differ from the whole cache's K4 by {err}")
            worst = max(worst, err)
    return max(worst, _check_decode_attention_lse_long(dev))


def _check_decode_attention_lse_long(dev) -> float:
    """K4 with its lse at phase 4G (b)'s per-device shape, and the 16
    slices merged against one launch over the whole cache
    (:func:`check_decode_attention_lse`).  Returns the largest output
    error."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import plain as da_plain

    n, group = LONG_MESH[0] * LONG_MESH[1], LONG_MESH[1]
    w, h, d, dt = LONG_KEYS // n, 4, 256, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    q = torch.empty((1, h, d), dtype=dt, device=dev).normal_(generator=gen)
    kc, vc = (torch.empty((1, LONG_KEYS, 1, d), dtype=torch.bfloat16, device=dev).normal_(generator=gen)
              for _ in range(2))
    lens = torch.full((1,), LONG_FROM + LONG_STEPS, dtype=torch.int32, device=dev)
    worst = 0.0
    for window in (None, GEMMA_WINDOW):
        outs, lses, keyless, errs = [], [], [], []
        for j in range(n):
            ks, vs = kc[:, j * w:(j + 1) * w], vc[:, j * w:(j + 1) * w]
            local = lens - j * w
            got, lse = da_ops.decode_attention_cache(q, ks, vs, local, window=window, return_lse=True)
            want, want_lse = da_plain.decode_attention(q, ks, vs, local, window=window, return_lse=True)
            torch.cuda.synchronize()
            err, inside, tol = _attn_bound(got, want, dt)
            lse_err = (lse - want_lse).abs().max().item()
            empty = bool((want_lse <= da_plain.NEG_INF).all())
            if empty:
                keyless.append(j)
                inside &= bool((lse == want_lse).all())
            else:
                inside &= lse_err <= DECODE_LSE_ATOL
            errs.append((err, 0.0 if empty else lse_err))
            if j in (0, n - 2, n - 1) or (empty and len(keyless) == 1):  # the named slices, the first keyless
                log(f"  decode_attention lse B=1 slice {j} of {n} ({w} keys from {j * w}) length "
                    f"{int(local.item())} window={window}: max|kernel-plain| out {err:.3e} (bound {tol}), lse "
                    f"{lse_err:.3e} (bound {DECODE_LSE_ATOL}){'; no valid key' if empty else ''}")
            if not (lse.dtype == torch.float32 and lse.shape == (1, h) and inside):
                raise AssertionError(f"decode_attention's lse disagrees with its plain version at B=1, slice {j} "
                                     f"of {n}, window {window}: {err} / {lse_err}")
            outs.append(got)
            lses.append(lse)
        halves = [da_ops.merge_partials(outs[i:i + group], lses[i:i + group], return_lse=True)
                  for i in range(0, n, group)]
        merged = da_ops.merge_partials([o for o, _ in halves], [lse for _, lse in halves])
        whole = da_ops.decode_attention_cache(q, kc, vc, lens, window=window)
        torch.cuda.synchronize()
        err, inside, tol = _attn_bound(merged, whole, dt)
        log(f"  decode_attention lse B=1, {n} slices of {w} keys, window={window}: every slice max|kernel-plain| "
            f"out {max(e for e, _ in errs):.3e}, lse {max(e for _, e in errs):.3e}; no valid key in slices "
            f"{keyless}; merged by {group}s then {n // group} vs one launch over {LONG_KEYS} keys at length "
            f"{int(lens.item())}: max|merged-whole|={err:.3e} (bound {tol})")
        if not inside:
            raise AssertionError(f"{n} merged K4 slices differ from the whole {LONG_KEYS}-key cache's K4 by {err}")
        worst = max(worst, err, *(e for e, _ in errs))
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


def _efficient_attention_lse(q, ks, vs, lengths, window, flush) -> str:
    """One PyTorch call computing K4-with-lse's function on a slice:
    ``aten._scaled_dot_product_efficient_attention`` with
    ``compute_log_sumexp``, the lengths (and window) as an additive bias
    (0 on a valid key, -1e30 elsewhere, as K4 masks), q (B, H, D) in the
    cache's dtype (the library takes one dtype: K4 reads q in f32), K and V
    expanded over the query heads.  Returns its log line: the median ms and
    its largest |lse - K4's plain lse| over the rows with a valid key."""
    from repro_torch.kernels.decode_attention import plain as da_plain

    b, h, d = q.shape
    s = ks.shape[1]
    pos = torch.arange(s, device=q.device)
    valid = (pos[None, :] < lengths[:, None]) & (pos[None, :] >= 0)
    if window is not None:
        valid &= pos[None, :] >= lengths[:, None] - window
    pad = -(-s // 16) * 16  # the kernel reads the bias rows at a 16-element stride
    bias = torch.full((b, h, 1, pad), -1e30, dtype=ks.dtype, device=q.device)[..., :s]
    bias.masked_fill_(valid[:, None, None, :], 0.0)
    qt = q[:, :, None, :].to(ks.dtype)
    kt, vt = (x.transpose(1, 2).expand(b, h, s, d) for x in (ks, vs))
    call = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(  # noqa: E731
        qt, kt, vt, bias, True, scale=d**-0.5)
    try:
        _, lse = call()[:2]
        ms = median_ms(call, flush)
    except Exception as e:  # a private op: log, never fail on it
        return f"library (SDPA efficient with lse) not run: {type(e).__name__}: {str(e)[:160]}"
    _, want = da_plain.decode_attention(q, ks, vs, lengths, window=window, return_lse=True)
    rows = valid.any(-1)
    err = (lse[..., 0].float() - want)[rows].abs().max().item() if bool(rows.any()) else 0.0
    return f"library (SDPA efficient with lse, q bf16) {ms:.4f} ms, max|lse - plain| {err:.3e}"


def time_decode_attention(dev, flush) -> dict:
    """One Gemma3-1B decode step's K4 launches at the decode phase's shape
    (4 sequences at 2048..2060 keys in a 2112-key bf16 cache, q bf16):
    4 global layers + 22 local (window 512), each timed alone and summed.
    Per layer it prints the time beside the layer's bytes bound (its share
    of it and the bytes/s reached) and the launch floor: an empty kernel
    from the same library, on the local layer's grid, timed the same way."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.cost import KernelCost
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
    totals, cost = dict(ms=0.0, plain_ms=0.0, library_ms=0.0), KernelCost()
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
        layer = da_ops.decode_attention_cost(b, s, h, kvh, d, window, dt, dt, keys=int(keys.sum()))
        layer_bound, _ = layer.bound_ms()
        chunk, n_split = da_ops.split_plan(b * kvh, s, window, d, 2, n_sm)
        line = (f"  decode_attention {'global' if window is None else f'local (window {window})'} "
                f"layer ({b} seqs, cache {s}, D {d}, bf16; {n_split} chunks of {chunk} keys x "
                f"{b * kvh} = {n_split * b * kvh} blocks, one launch): kernel {kernel:.4f} ms, plain "
                f"{plain:.4f} ms, SDPA {library:.4f} ms; bytes bound {layer_bound:.4f} ms, "
                f"{layer_bound / kernel:.1%} of it, {layer.bytes / kernel / 1e9:.3f} TB/s")
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
        cost = cost + n_layers * layer
    b_ms, b_by = cost.bound_ms()
    log(f"  decode_attention per decode step ({N_GLOBAL} global + {N_LOCAL} local launches): "
        f"kernel {totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, SDPA "
        f"{totals['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # the log-sum-exp variant at phase 4G (a)'s slice shape: a model device's 264 keys of the 2112-key cache
    # over 8, q f32, lengths less the slice's first key — device 0 (every key valid in a global layer) and
    # device 7 (the decode lengths' last keys, valid in every layer)
    n_dev, qf, card = 8, q.float(), card_line()
    w = s // n_dev
    for j, window in ((0, None), (n_dev - 1, None), (n_dev - 1, GEMMA_WINDOW)):
        ks, vs = kc[:, j * w:(j + 1) * w], vc[:, j * w:(j + 1) * w]
        local = lens - j * w
        kernel = median_ms(lambda: da_ops.decode_attention_cache(qf, ks, vs, local, window=window,
                                                                 return_lse=True), flush)
        plain = median_ms(lambda: da_plain.decode_attention(qf, ks, vs, local, window=window, return_lse=True),
                          flush)
        hi = np.clip(lens_np - j * w, 0, w)
        lo = np.clip(lens_np - j * w - window, 0, None) if window else np.zeros_like(hi)
        keys = int(np.maximum(hi - lo, 0).sum())
        slice_bound, slice_by = da_ops.decode_attention_cost(b, w, h, kvh, d, window, torch.float32, dt, keys=keys,
                                                             lse=True).bound_ms()
        library = _efficient_attention_lse(q, ks, vs, local, window, flush)
        log(f"  decode_attention with lse, device {j}'s slice of {n_dev} ({b} seqs x {w} keys from {j * w}, "
            f"{keys} valid, window {window}, q f32, bf16 cache): kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
            f"bound {slice_bound:.4f} ms ({slice_by}); {library} [{card}]")
    # OLMoE's decode layer (4 sequences at 1024.. keys, 16 heads of 128, group 1), logged
    s, h, d = MOE_MAX_LEN, OLMOE_HEADS, OLMOE_HD
    q = _randn(rng, (b, h, d), dt, dev)
    kc, vc = (_randn(rng, (b, s, h, d), dt, dev) for _ in range(2))
    lens_np = MOE_PREFILL_S + np.arange(b, dtype=np.int32) * (DECODE_STEPS // b)
    lens = torch.from_numpy(lens_np).to(dev)
    kernel = median_ms(lambda: da_ops.decode_attention_cache(q, kc, vc, lens), flush)
    keys = int(np.minimum(lens_np, s).sum())
    layer_bound, _ = da_ops.decode_attention_cost(b, s, h, h, d, None, dt, dt, keys=keys).bound_ms()
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
    channels (the smoke config's: a ragged last block); then the serving
    mesh's data-shard shapes in bf16 (phase 4G: 2 rows of 2048 without h0,
    2 rows and 1 row at S = 1 with h0).  With ``z=None``
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
    # phase 4G's per-shard shapes: a data shard's 2 rows on (2, 2) (the prompt, a step), part (c)'s 1 row
    cases += [(2, s, d, n, torch.bfloat16, s == 1) for s in (PREFILL_S, 1)] + [(1, 1, d, n, torch.bfloat16, True)]
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
    from repro_torch.kernels.cost import PEAK_BYTES_S
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
        cost = scan_ops.selective_scan_cost(b, s, d, n, torch.bfloat16, with_h0, True)
        b_ms, b_by = cost.bound_ms()
        t_bytes, t_sfu, t_f32 = cost.bytes / PEAK_BYTES_S, cost.op_seconds()["sfu"], cost.op_seconds()["float32"]
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
    the 8-state instance over 80 channels (a ragged last block), gated
    and ``z=None``; and the edges of the 8-step chunks and the clusters
    of channel blocks: S = 17 (a last chunk of one step) over 200 channels
    (13 blocks of 16, no cluster but one block, the last block ragged) and
    S = 48 over 352 (22 blocks: clusters of 2).  In f32 every gradient is
    held to ``SCAN_RTOL`` of its largest |plain| value (the recurrences in another order); in bf16,
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
        (2, 17, 200, n, bf16, True, True, True),
        (2, 48, 352, n, f32, False, True, False),
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
    the bytes (xc, proj, the z half of the in_proj rows, dout, a saved
    state every ``cost.BOUND_STATE_STRIDE`` steps, a_log, dt_bias and d_skip
    read once; dxc, d proj, dz and the parameter gradients written once;
    at 3.35 TB/s) and the SFU exps, at least one per (b, t, d, n) (16 a
    clock per SM).  No single PyTorch call computes this function.  Also
    logged: each of the three kernels' share of the call (profiler), the
    main kernel's residency (blocks and warps an SM, blocks a cluster) and
    the bytes of the partial rows it leaves the rows kernel, and its static
    SASS per (b, t, d, n) by pipe (the bf16 16-state instance's opcodes
    over the (t, d, n) a warp walks a chunk, 8 channels x 16 states x
    ``state_chunk()`` steps; its walks are unrolled, so each runs once a
    chunk): a static count, which neither bounds nor measures the time."""
    import ctypes
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.cost import PEAK_BYTES_S
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import plain as scan_plain

    rng = np.random.default_rng(SEED + 17)
    b, s, d, n = TRAIN_B, TRAIN_S, HYMBA_D_INNER, HYMBA_STATE
    args, dout, _, h_chunks = _scan_bwd_case(rng, b, s, d, n, torch.bfloat16, False, True, False, dev)
    kernel = median_ms(lambda: scan_ops.selective_scan_bwd(*args, dout, None, h_chunks), flush)
    plain = median_ms(lambda: scan_plain.selective_scan_bwd(*args, dout), flush, iters=3, warmup=1)
    cost = scan_ops.selective_scan_bwd_cost(b, s, d, n, torch.bfloat16, False, True)
    b_ms, b_by = cost.bound_ms()
    t_bytes, t_sfu = cost.bytes / PEAK_BYTES_S, cost.op_seconds()["sfu"]
    log(f"  selective_scan_bwd training layer ({b}x{s}, {d} channels x {n} states, bf16, gated): kernel "
        f"{kernel:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}: bytes {t_bytes * 1e3:.4f}, SFU exps "
        f"{t_sfu * 1e3:.4f}), {b_ms / kernel:.1%} of it; x {HYMBA_LAYERS} layers a step: kernel "
        f"{HYMBA_LAYERS * kernel:.3f} ms, plain {HYMBA_LAYERS * plain:.3f} ms")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flush.zero_()
            scan_ops.selective_scan_bwd(*args, dout, None, h_chunks)
        torch.cuda.synchronize()
    parts = {re.search(r"selective_scan_bwd\w*", e.key).group(0): e.self_device_time_total / 1e3 / e.count
             for e in prof.key_averages() if "selective_scan_bwd" in e.key and e.self_device_time_total > 0}
    total = sum(parts.values())
    lib = _build.load_library()
    info = (ctypes.c_int * 6)()
    _build.check(lib, lib.repro_selective_scan_bwd_info(1, n, d, info), "selective_scan_bwd_info")
    blocks, warps, smem, cluster, clusters, chans = info
    partial = b * s * (-(-d // chans) // cluster) * (2 * n + 1) * 4
    log(f"  selective_scan_bwd launches: " + ", ".join(f"{k} {v:.4f} ms ({v / total:.1%})" for k, v in parts.items())
        + f"; main kernel: {blocks} blocks of {warps} warps an SM ({blocks * warps} warps), {smem} bytes of shared "
        f"memory a block, {chans} channels a block, {cluster} blocks a cluster ({clusters} clusters resident at "
        f"once); partial rows {partial / 1e6:.1f} MB written and read back")
    ops = [c for name, c in sass_opcodes(_build, "selective_scan_bwd_kernel").items()
           if "ILi16E13__nv_bfloat16" in name]
    if ops:
        per_warp = 8 * n * scan_ops.state_chunk() / 32  # (t, d, n) a warp's chunk, per lane
        per = {pipe: sum(ops[0][o] for o in codes) / per_warp for pipe, codes in SASS_PIPES.items()}
        log("  selective_scan_bwd static SASS instructions per (b, t, d, n), bf16 16 states (a static count, "
            "not a time): " + ", ".join(f"{pipe} {v:.2f}" for pipe, v in per.items())
            + f", all {sum(ops[0].values()) / per_warp:.2f}; beside the bound {b_ms:.4f} ms ({b_by})")
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


# ----------------------------------------------- phase 5B: the replica mesh
MESH_PARTS = 2  # logical devices the card is split into (one stream each)
OVERLAP_BUCKETS = (8, BATCH)  # replays timed on one stream vs two at once
OVERLAP_REPLAYS = 10


@contextlib.contextmanager
def _forced_device_count(n: int):
    """``REPRO_TORCH_FORCE_DEVICE_COUNT=n`` for the block, restored after."""
    from repro_torch import device as D

    old = os.environ.get(D.FORCE_DEVICE_COUNT_ENV)
    os.environ[D.FORCE_DEVICE_COUNT_ENV] = str(n)
    try:
        yield
    finally:
        if old is None:
            del os.environ[D.FORCE_DEVICE_COUNT_ENV]
        else:
            os.environ[D.FORCE_DEVICE_COUNT_ENV] = old


def check_mesh_readback(dev) -> None:
    """A program on a logical device's stream that spins ~23 ms on the card
    before it writes its output, read back from the default stream (the
    caller waits on the program's event) and inside the target's scope (a
    replica dispatcher's order): each readback must see the values written
    after the spin, never the memory before them."""
    from repro_torch import device as D
    from repro_torch.core import device_compiler as DC
    from repro_torch.preprocessing.ops import TensorMeta
    from repro_torch.runtime.scheduler import _to_host

    target = D.mesh_devices(dev)[1]

    def late(x):
        torch.cuda._sleep(LONG_SPIN)
        return x * 2.0 + 1.0

    prog = DC.compile_device_program([], TensorMeta((1, 1, 256), "float32", "HWC"), late, 8,
                                     device=target)
    for i in range(4):
        batch = np.full((8, 1, 1, 256), float(i), np.float32)
        if i % 2:
            with D.dispatch_scope(prog):
                got = _to_host(prog(batch))
        else:
            got = _to_host(prog(batch))
        if not (got == 2.0 * i + 1.0).all():
            raise AssertionError(f"readback {i} ({'in the scope' if i % 2 else 'default stream'}) "
                                 f"ran before the program's stream: {got.ravel()[:4]}")
    log(f"[mesh] readback after a ~23 ms spin on {target.label}'s stream: ordered, from the "
        "default stream and from the target's scope")


def _mesh_runtime(dev, corpus, full, thumb, main: dict, mesh):
    from repro_torch.runtime import (DeviceCompilerConfig, RuntimeConfig, SmolRuntime,
                                     TenantConfig)

    return SmolRuntime(
        [main["spec"]], [full, thumb], {"resnet50": main["model"]}, calibration=corpus[:4],
        config=RuntimeConfig(
            batch_size=BATCH, num_workers=8, min_accuracy=0.8, max_wait_ms=5.0,
            device=DeviceCompilerConfig(split_decode="full"), warmup="full",
            tenants=tuple(TenantConfig(n, weight=w) for n, w in SERVE_TENANTS), mesh=mesh),
        device=dev,
    )


def _warm_mesh(rt, what: str, dev, card: str) -> tuple:
    """start_serving() and the background warmup, with the memory reserved
    around them; every set's buckets captured, K1 x2, K5 x1 and K2 x1 in
    each graph, on its own program set (one per replica target)."""
    from repro_torch.core import device_compiler as DC

    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved(dev)
    captures0 = DC.capture_program.captures
    t0 = time.perf_counter()
    rt.start_serving()
    if not rt.wait_warm(timeout=SERVE_TIMEOUT_S):
        raise AssertionError(f"{what}: background warmup did not finish")
    t_warm = time.perf_counter() - t0
    torch.cuda.synchronize()
    reserved1 = torch.cuda.memory_reserved(dev)
    sets = rt.compile().program_sets
    graphs = [g for ps in sets for p in ps.programs.values()
              for g in [m.graph for m in (p.members or (p,))]]
    if any(g is None for g in graphs) or not all(ps.fully_warm for ps in sets):
        raise AssertionError(f"{what}: a bucket was not captured")
    for g in graphs:
        _expect_vision_counts(f"{what} graph", {**g.kernel_launches, "idct_scaled": 0}, 8, 1)
    captures = DC.capture_program.captures - captures0
    if captures != len(graphs):
        raise AssertionError(f"{what}: {captures} captures for {len(graphs)} graphs")
    log(f"{what} {len(sets)} program set(s), {len(graphs)} graphs captured in {t_warm:.2f} s; "
        f"memory reserved {reserved0 / 2**20:.1f} MiB before warmup, {reserved1 / 2**20:.1f} "
        f"MiB after ({(reserved1 - reserved0) / 2**20:.1f} MiB) [{card}]")
    return sets, graphs


def _serve_corpus(rt, corpus, ref, what: str, fail_at: int | None = None) -> float:
    """Every item as a ClassificationQuery over both tenants (replica 1
    failed after ``fail_at`` submissions); every uid back without an error
    and as run(); returns the items/s of the whole burst."""
    from repro_torch.runtime import ClassificationQuery

    t0 = time.perf_counter()
    uids = {}
    for i, item in enumerate(corpus):
        if i == fail_at:
            rt.fail_replica(1)
        uids[rt.submit(ClassificationQuery(item), tenant=SERVE_TENANTS[i % 2][0])] = i
    rt.flush(timeout=SERVE_TIMEOUT_S)
    done = rt.drain(timeout=SERVE_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if sorted(r.uid for r in done) != sorted(uids) or any(r.error is not None for r in done):
        raise AssertionError(f"{what}: {len(done)} of {len(uids)} results, errors "
                             f"{[r.error for r in done if r.error is not None][:3]}")
    for r in done:
        _same_as_run(f"{what} item {uids[r.uid]}", r.scores, ref[uids[r.uid]])
    return len(corpus) / seconds


def mesh_stream_overlap(sets, card: str) -> None:
    """Device time of OVERLAP_REPLAYS replays of each replica's graph at a
    bucket: both back to back on replica 0's stream, then each on its own
    stream at once (CUDA events; the same graphs, their static inputs as
    the last dispatch left them).  Printed, not gated."""
    for b in OVERLAP_BUCKETS:
        progs = [ps.programs[b] for ps in sets]
        streams = [p.target.stream for p in progs]
        results = {}
        for mode in ("one stream", "two streams", "two streams", "one stream"):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(streams[0]):
                torch.cuda._sleep(LONG_SPIN)
                start.record()
            for i, (prog, stream) in enumerate(zip(progs, streams)):
                run_on = streams[0] if mode == "one stream" else stream
                run_on.wait_event(start)
                with torch.cuda.stream(run_on):
                    for _ in range(OVERLAP_REPLAYS):
                        prog.graph.graph.replay()
                if run_on is not streams[0]:
                    streams[0].wait_stream(run_on)
            with torch.cuda.stream(streams[0]):
                end.record()
            end.synchronize()
            results.setdefault(mode, []).append(start.elapsed_time(end))
        one, two = (min(results[m]) for m in ("one stream", "two streams"))
        log(f"[mesh] {len(progs)} x {OVERLAP_REPLAYS} replays at bucket {b}: {one:.3f} ms on one "
            f"stream, {two:.3f} ms on two at once (each the better of two turns: "
            f"{results['one stream']}, {results['two streams']}); the streams overlapped "
            f"{(one - two) / one * 100:.1f}% of the serial time [{card}]")


def run_mesh_serving(dev, corpus, full, thumb, main: dict, card: str) -> None:
    """Phase 5B: the replica mesh on two logical devices of the one card."""
    from repro_torch.runtime import MeshConfig

    ref = main["outs"]
    with _forced_device_count(MESH_PARTS):
        check_mesh_readback(dev)
        _kernel_counts(zero=True)
        # (a) one replica (the default mesh) and two replicas, in turns
        one = _mesh_runtime(dev, corpus, full, thumb, main, MeshConfig())
        two = _mesh_runtime(dev, corpus, full, thumb, main, MeshConfig(replicas=MESH_PARTS))
        try:
            _warm_mesh(one, "[mesh] one replica:", dev, card)
            sets, graphs = _warm_mesh(two, "[mesh] two replicas:", dev, card)
            streams = {ps.programs[BATCH].target.stream for ps in sets}
            if len(sets) != MESH_PARTS or len(streams) != MESH_PARTS:
                raise AssertionError(f"{len(sets)} program sets on {len(streams)} streams")
            rates = {"one": [], "two": []}
            for name in ("one", "two", "two", "one"):
                rt = one if name == "one" else two
                rates[name].append(_serve_corpus(rt, corpus, ref, f"[mesh] {name} replica(s):"))
            replicas = two.stats().mesh.replicas
            log(f"[mesh] {len(corpus)} classifications, items/s in turns: one replica "
                f"{rates['one']}, two replicas {rates['two']}; items per replica "
                f"{[(r.device, r.items) for r in replicas]} [{card}]")
            if any(r.items == 0 for r in replicas):
                raise AssertionError(f"a replica served nothing: {replicas}")
            mesh_stream_overlap(sets, card)
            # (b) replica 1 fails halfway through a burst
            _serve_corpus(two, corpus, ref, "[mesh] fail_replica(1):", fail_at=len(corpus) // 2)
            stats = two.stats()
            log(f"[mesh] after fail_replica(1): alive {stats.mesh.alive}, elastic plan "
                f"{stats.mesh.elastic_plan}, redispatched "
                f"{[r.redispatched_items for r in stats.mesh.replicas]}")
            if stats.mesh.alive != 1 or stats.mesh.elastic_plan is None:
                raise AssertionError(f"mesh after fail_replica(1): {stats.mesh}")
            for rt in (one, two):
                if rt.stats().warmup.failures or rt.programs_compiled_post_warmup:
                    raise AssertionError(f"warm failures {rt.stats().warmup.errors}, "
                                         f"{rt.programs_compiled_post_warmup} post-warmup builds")
            replays = sum(g.replays for g in graphs)
        finally:
            one.stop_serving()
            two.stop_serving()
        del one, two, sets, graphs
        torch.cuda.empty_cache()
        # (c) one replica sharded over both logical devices
        rt = _mesh_runtime(dev, corpus, full, thumb, main, MeshConfig(sharded=True))
        try:
            (ps,), graphs = _warm_mesh(rt, "[mesh] sharded group of two:", dev, card)
            members = {b: [m.target.label for m in p.members] for b, p in ps.programs.items()}
            if any(b % MESH_PARTS for b in ps.buckets) or any(
                    len(set(m)) != MESH_PARTS for m in members.values()):
                raise AssertionError(f"sharded buckets {ps.buckets}, members {members}")
            replays0 = [g.replays for g in graphs]
            rate = _serve_corpus(rt, corpus, ref, "[mesh] sharded:")
            by_member = [0] * MESH_PARTS
            for p in ps.programs.values():
                for i, m in enumerate(p.members):
                    by_member[i] += m.graph.replays
            log(f"[mesh] sharded group: buckets {ps.buckets}, members {members[BATCH]}, "
                f"{rate:.2f} items/s, replays by member {by_member} [{card}]")
            if min(by_member) == 0 or sum(g.replays for g in graphs) == sum(replays0):
                raise AssertionError(f"a member replayed no graph: {by_member}")
            if rt.stats().warmup.failures or rt.programs_compiled_post_warmup:
                raise AssertionError("sharded group: warm failures or post-warmup builds")
        finally:
            rt.stop_serving()
        del rt, ps, graphs
        torch.cuda.empty_cache()
    wrapper = _kernel_counts()
    log(f"[mesh] K1/K5/K2 launches in phase 5B through the wrappers {wrapper} (warm-up runs "
        f"and captures), plus {replays} graph replays of the two replicas")
    if min(wrapper[k] for k in REPLAY_KERNELS) == 0 or replays == 0:
        raise AssertionError("phase 5B launched K1, K5 or K2 no time")


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


# ------------------------------------------ phase 7: the dry run against the card
DRYRUN_ARGS_RTOL = 0.02  # the record's argument bytes against the bytes placed (as requested)
DRYRUN_PEAK_RTOL = 0.10  # its peak estimate against the peak over the step (as requested)
DRYRUN_FLOPS_RTOL = 0.01  # its aten dot FLOPs against the profiler's (with_flops) over the step
DRYRUN_ROOFLINE_SLACK = 1.05  # a roofline term above this x the step's device busy time is a wrong count
DRYRUN_DOTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")  # the profiler's product rows
DRYRUN_CLI = ("--arch", "gemma3-1b", "--shape", "train_4k", "--mesh", "single")


def device_bytes() -> tuple[int, int]:
    """(memory_allocated(), the allocator's requested bytes): the caching
    allocator rounds each block up (to 512 bytes, or a large block's whole
    segment when what is left over is under 1 MiB), so the tensors' own
    bytes are what it records as requested."""
    return torch.cuda.memory_allocated(), torch.cuda.memory_stats().get("requested_bytes.all.current", 0)


def _kernel_launches() -> dict:
    """The LM kernels' launches so far, by the names a trace counts them."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops

    return {"flash_attention": fa_ops.flash_attention_bshd.launches,
            "flash_attention_bwd": fa_ops.flash_attention_bwd_bshd.launches,
            "decode_attention": da_ops.decode_attention_cache.launches,
            "selective_scan": scan_ops.selective_scan.launches,
            "selective_scan_bwd": scan_ops.selective_scan_bwd.launches}


def start_dryrun_cli() -> subprocess.Popen:
    """Phase 7's smoke test of the entry point, host only: ``python -m
    repro_torch.launch.dryrun`` on one cell of the single-pod mesh (its
    record under build/dryrun), started beside phase 2, whose kernel
    times are device times (CUDA events behind a spin)."""
    import atexit

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_CLI, "--out", str(ROOT / "build" / "dryrun")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env)
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))  # a failed phase leaves none running
    return proc


def finish_dryrun_cli(proc: subprocess.Popen) -> None:
    """Wait for :func:`start_dryrun_cli`'s run: it must exit 0 with an OK
    line."""
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for line in out.strip().splitlines()[-3:]:
        log(f"[dryrun] cli: {line}")
    if proc.returncode != 0 or not any(ln.startswith("OK ") for ln in out.splitlines()):
        raise AssertionError(f"dryrun CLI {' '.join(DRYRUN_CLI)} failed (exit {proc.returncode}):\n{out[-4000:]}")


def dryrun_against_card(tag: str, cfg, shape, step, placed: tuple, card: str) -> dict:
    """Phase 7 for one step: the dry run's record of ``shape`` on the 1x1
    host mesh (traced on the CPU, nothing on the card) held against one
    call of ``step`` on the card, which runs the same program: the argument
    bytes against ``placed`` (:func:`device_bytes` the state or cache took:
    allocated, requested), the peak estimate against the peak over the
    call, the aten dot FLOPs against the profiler's, the kernel launches
    exactly, and each roofline term against the call's device busy time
    (profiler).  Bytes are held as the allocator requested them; its
    rounded figures (memory_allocated) are printed beside them.  Returns
    the call's kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    rec = dryrun.run_cell(cfg, shape, make_host_mesh(H.trace_devices(1)))
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, before = device_bytes(), _kernel_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_flops=True) as prof:
        step()
        torch.cuda.synchronize()
    measured_args = placed[1]
    peak = measured_args + torch.cuda.memory_stats()["requested_bytes.all.peak"] - start[1]
    peak_allocated = placed[0] + torch.cuda.max_memory_allocated() - start[0]
    launched = {k: v - before[k] for k, v in _kernel_launches().items() if v != before[k]}
    # a product counts where it launched a kernel: checkpoint's recompute
    # stops at the last tensor the backward needs, inside the layer's last
    # product, which the profiler records and the card never runs
    dots = [e for e in prof.events() if e.name in DRYRUN_DOTS]
    flops = sum(e.flops for e in dots if e.device_time_total > 0)
    stopped = [e for e in dots if e.device_time_total == 0 and e.flops]
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0 and e.self_cpu_time_total == 0) / 1e6
    mem, hlo, roof = rec["memory"], rec["hlo"], rec["roofline"]
    args_err = abs(mem["argument_bytes"] - measured_args) / measured_args
    peak_err = (mem["peak_estimate_bytes"] - peak) / peak
    flops_err = abs(hlo["dot_flops"] - flops) / flops
    shares = {k: roof[f"{k}_seconds"] / busy for k in ("compute", "memory", "collective")}
    log(f"[dryrun] {tag} ({shape.global_batch}x{shape.seq_len}, traced in {trace_s:.1f} s): argument bytes "
        f"{mem['argument_bytes']} vs {measured_args} placed ({args_err:.3%}, bound {DRYRUN_ARGS_RTOL:.0%}; "
        f"memory_allocated {placed[0]}, {(placed[0] - mem['argument_bytes']) / mem['argument_bytes']:+.3%}); peak "
        f"estimate {mem['peak_estimate_bytes'] / 2**30:.3f} GiB vs {peak / 2**30:.3f} GiB measured ({peak_err:+.2%}, "
        f"bound {DRYRUN_PEAK_RTOL:.0%}; max_memory_allocated {peak_allocated / 2**30:.3f} GiB, "
        f"{(mem['peak_estimate_bytes'] - peak_allocated) / peak_allocated:+.2%}); aten dot FLOPs {hlo['dot_flops']:.6e} vs profiler {flops:.6e} "
        f"({flops_err:.4%}, bound {DRYRUN_FLOPS_RTOL:.0%}; {len(stopped)} recorded products launched nothing, "
        f"{sum(e.flops for e in stopped):.4e} FLOPs); launches {hlo['launches']} vs {launched}; device "
        f"busy {busy * 1e3:.3f} ms, roofline compute {roof['compute_seconds'] * 1e3:.3f} ms ({shares['compute']:.1%}), "
        f"memory {roof['memory_seconds'] * 1e3:.3f} ms ({shares['memory']:.1%}), collective "
        f"{roof['collective_seconds'] * 1e3:.3f} ms, dominant {roof['dominant']} [{card}]")
    bad = []
    if args_err > DRYRUN_ARGS_RTOL:
        bad.append(f"argument bytes {args_err:.3%} off")
    if abs(peak_err) > DRYRUN_PEAK_RTOL:
        bad.append(f"peak estimate {peak_err:+.2%} off")
    if flops_err > DRYRUN_FLOPS_RTOL:
        bad.append(f"dot FLOPs {flops_err:.4%} off")
    if hlo["launches"] != launched:
        bad.append(f"launches {hlo['launches']} traced, {launched} on the card")
    bad += [f"{k} roofline {v:.1%} of the measured busy time" for k, v in shares.items() if v > DRYRUN_ROOFLINE_SLACK]
    if bad:
        raise AssertionError(f"dry run vs the card, {tag}: " + "; ".join(bad))
    return launched


def dryrun_serving(dev, cfg, model, params_bytes: tuple, card: str) -> dict:
    """Phase 7 for Gemma3-1B's serving (phase 4's model): a prefill of
    PREFILL_B x PREFILL_S into a cache of that length (the prefill cell's),
    then a decode step over a DECODE_MAX_LEN cache (phase 4's batch and
    cache).  ``params_bytes``: :func:`device_bytes` the model took."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.models import decode as D

    def plus(before):
        return tuple(p + now - b for p, now, b in zip(params_bytes, device_bytes(), before))

    launches = {}
    rng = np.random.default_rng(SEED + 21)
    before = device_bytes()
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(PREFILL_B, PREFILL_S)).astype(np.int32)).to(dev)
    args = plus(before)
    shape = InputShape("phase4_prefill", "prefill", PREFILL_S, PREFILL_B)
    _add(launches, dryrun_against_card(f"{cfg.name} prefill", cfg, shape,
                                       lambda: D.prefill(model, cfg, prompts, max_len=PREFILL_S), args, card))
    before = device_bytes()
    logits, cache, lens = D.prefill(model, cfg, prompts, max_len=DECODE_MAX_LEN)
    tok = logits.argmax(-1).to(torch.int32)
    del logits
    torch.cuda.synchronize()
    args = plus(before)
    shape = InputShape("phase4_decode", "decode", DECODE_MAX_LEN, PREFILL_B)
    _add(launches, dryrun_against_card(f"{cfg.name} decode step", cfg, shape,
                                       lambda: D.decode_step(model, cfg, tok, cache, lens), args, card))
    del cache, prompts
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
    before = device_bytes()
    model = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    params_bytes = tuple(now - b for now, b in zip(device_bytes(), before))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers ({sum(model.is_local)} local, window "
        f"{cfg.sliding_window}), d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params "
        f"{cfg.dtype}, built on the card in {time.perf_counter() - t0:.1f} s")
    launches = drive_lm(dev, card, cfg, model, cfg.name, PREFILL_B, PREFILL_S, DECODE_MAX_LEN,
                        "request {i}: the quick brown fox jumps over the lazy dog")
    t0 = time.perf_counter()
    _add(launches, dryrun_serving(dev, cfg, model, params_bytes, card))
    log(f"[dryrun] phase 7 on {cfg.name}'s serving took {time.perf_counter() - t0:.1f} s")
    return launches


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
    counts = _kernel_launches()
    return tuple(counts[k] for k in ("flash_attention", "flash_attention_bwd", "selective_scan", "selective_scan_bwd"))


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
    from repro_torch.configs.shapes import InputShape
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
    before = device_bytes()
    try:
        state, history = loop.train(cfg, tcfg, it, steps, key=SEED, device=dev, log_every=10**9, on_step=on_step)
    finally:
        it.close()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    state_bytes = tuple(now - b for now, b in zip(device_bytes(), before))
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
    t0 = time.perf_counter()
    shape = InputShape("phase4e_train", "train", TRAIN_S, TRAIN_B)
    _add(launches, dryrun_against_card(f"{cfg.name} training step", cfg, shape, lambda: step_fn(state, batch),
                                       state_bytes, card))
    log(f"[dryrun] phase 7 on {cfg.name}'s training step took {time.perf_counter() - t0:.1f} s")
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


# ---------------------------------------------- phase 4F: the training mesh
MESH_RING_LENGTHS = (37, 2**24 + 3)  # f32 elements a device: one whose last chunk is short, one of 64 MB
MESH_TIMED_RING = 2**30  # f32 elements a device for the timed ring: 4 GiB each ("1.0 B f32 leaves")
MESH_PSUM_RTOL = 1e-6  # psum_in_chunks against the plain sum, of the largest |sum|
MESH_COMPRESSED_ATOL = 2e-2  # the int8 all-reduce against the exact sum, of the largest |sum|
MESH_TRAIN_STEPS = 3  # steps after the first, on each mesh
MESH_LOSS_RTOL, MESH_GNORM_RTOL = 1e-3, 1e-2  # the first mesh step against the single-device one
OLMOE_TRAIN_LAYERS = 2  # of 16: f32 weights, grads and AdamW state of all 16 (~110 GB) do not fit
# FSDP on (2, 2): the bytes a device stores (parameters, m and v parts, count and step) under the FSDP tree
GEMMA_FSDP_BYTES = 2_999_701_256
QWEN_FSDP_LAYERS = 2  # of 64: full widths, 2.531 B params (28.30 GiB of f32 state whole)
# AdamW's rate for (f): at d_model 5120 its sign-like first steps at the default 3e-4 drive the loss up
# on one device as on the mesh (tools/fsdp_lr_probe.py)
QWEN_FSDP_LR = 3e-5
QWEN_FSDP_BYTES = 7_597_089_800


def _mesh_devices(dev, n: int) -> list:
    from repro_torch import device as D

    with _forced_device_count(n):
        return D.mesh_devices(dev)


def check_collectives(dev, card: str) -> None:
    """The ring, the bucketed psum and the EF-int8 all-reduce on 2 and 4
    logical devices of the card (one stream each) against the same
    collectives on as many logical CPU devices: the ring bit for bit
    (IEEE f32 adds in the same order), also when the second device's part
    is written behind a ~23 ms spin on its stream (a missing wait would
    read the memory before it); ``psum_in_chunks`` within MESH_PSUM_RTOL
    of the plain sum; ``compressed_psum_pod`` within MESH_COMPRESSED_ATOL
    of the exact sum, its int8 payloads and scales the CPU's.  Then the
    in-place ring (``ring_allreduce_``, what each psum bucket runs) over
    MESH_TIMED_RING f32 a device on 2 devices, timed against its bytes."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import compression as COMP
    from repro_torch.kernels.cost import PEAK_BYTES_S

    rng = np.random.default_rng(SEED)
    for n in (2, 4):
        devices, cpus = _mesh_devices(dev, n), _mesh_devices("cpu", n)
        for length in MESH_RING_LENGTHS:
            x = rng.normal(size=(n, length)).astype(np.float32)
            want = C.ring_allreduce([torch.from_numpy(row) for row in x], cpus)[0].numpy()
            for spin in (False, True):
                parts = [torch.from_numpy(row).to(dev) for row in x]
                if spin:
                    late = torch.zeros_like(parts[1])
                    if devices[1].stream is not None:  # written on its stream, after the default stream's zeros
                        devices[1].stream.wait_stream(torch.cuda.current_stream())
                        late.record_stream(devices[1].stream)
                    with devices[1].scope():
                        torch.cuda._sleep(LONG_SPIN)
                        late.copy_(parts[1])
                    parts[1] = late
                got = C.ring_allreduce(parts, devices)
                for i, g in enumerate(got):
                    if not np.array_equal(g.cpu().numpy(), want):
                        raise AssertionError(f"ring_allreduce on {n} streams, length {length}"
                                             f"{' behind a spin' if spin else ''}: device {i} differs from the CPU's")
        tree = {f"l{j}": rng.normal(size=(n, *shape)).astype(np.float32)
                for j, shape in enumerate(((4096, 33), (517,), (3, 5), (70001,), (1,)))}
        got = C.psum_in_chunks([{k: torch.from_numpy(v[i]).to(dev) for k, v in tree.items()} for i in range(n)],
                               devices)
        for k, v in tree.items():
            plain = torch.from_numpy(v).to(dev).sum(0)
            for g in got:
                err = float((g[k] - plain).abs().max() / plain.abs().max())
                if err > MESH_PSUM_RTOL:
                    raise AssertionError(f"psum_in_chunks on {n} streams: {k} {err:.3e} from the plain sum")
        xs = rng.normal(size=(n, 4099)).astype(np.float32)
        es = (1e-3 * rng.normal(size=(n, 4099))).astype(np.float32)
        totals, _ = COMP.compressed_psum_pod([torch.from_numpy(r).to(dev) for r in xs],
                                             [torch.from_numpy(r).to(dev) for r in es], devices)
        cpu_totals, _ = COMP.compressed_psum_pod([torch.from_numpy(r) for r in xs], [torch.from_numpy(r) for r in es],
                                                 cpus)
        exact = xs.sum(0)
        err = max(float(np.abs(t.cpu().numpy() - exact).max() / np.abs(exact).max()) for t in totals)
        for i in range(n):
            q, s_, _ = COMP.ef_quantize(torch.from_numpy(xs[i]).to(dev), torch.from_numpy(es[i]).to(dev))
            cq, cs, _ = COMP.ef_quantize(torch.from_numpy(xs[i]), torch.from_numpy(es[i]))
            if not (np.array_equal(q.cpu().numpy(), cq.numpy()) and float(s_) == float(cs)):
                raise AssertionError(f"compressed_psum_pod on {n} streams: device {i}'s int8 payload or scale "
                                     "differs from the CPU's")
        cpu_err = max(float(np.abs(t.cpu().numpy() - c.numpy()).max() / np.abs(exact).max())
                      for t, c in zip(totals, cpu_totals))
        if err > MESH_COMPRESSED_ATOL or cpu_err > MESH_PSUM_RTOL:
            raise AssertionError(f"compressed_psum_pod on {n} streams: {err:.3e} from the exact sum, "
                                 f"{cpu_err:.3e} from the CPU's")
        log(f"[train-mesh] {n} streams: ring_allreduce bitwise the CPU's at lengths {MESH_RING_LENGTHS} "
            f"(also behind a ~23 ms spin on {devices[1].label}'s stream); psum_in_chunks within "
            f"{MESH_PSUM_RTOL:g} of the plain sum; compressed_psum_pod {err:.3e} of the exact sum (bound "
            f"{MESH_COMPRESSED_ATOL:g}), {cpu_err:.3e} of the CPU's, int8 payloads and scales the CPU's")
    devices = _mesh_devices(dev, 2)
    flats = []
    for d in devices:
        with d.scope():
            flats.append(torch.randn(MESH_TIMED_RING, device=dev))
    torch.cuda.synchronize()

    def ring():
        caller = C._enter(devices)
        C.ring_allreduce_(flats, devices)
        C._leave(devices, caller, [])

    ms = median_ms(ring, None, iters=5, warmup=1)
    p, nbytes = len(devices), MESH_TIMED_RING * 4
    bound = p * 2 * (2 * (p - 1) / p) * nbytes / PEAK_BYTES_S * 1e3
    log(f"[train-mesh] ring_allreduce_ of {MESH_TIMED_RING / 1e9:.3f} B f32 ({nbytes / 2**30:.0f} GiB) a device on "
        f"{p} streams of the card: {ms:.3f} ms (CUDA events, median of 5); byte bound {bound:.3f} ms (each device "
        f"moves 2(P-1)/P of its bytes, read and written, all {p} devices in one card's HBM at "
        f"{PEAK_BYTES_S / 1e12:.2f} TB/s) [{card}]")
    del flats
    torch.cuda.empty_cache()


def _place(state, mesh, rules, fsdp: bool = False):
    """``state`` placed on ``mesh`` under ``rules`` -> (the placed state,
    the ZeRO specs); with ``fsdp`` the parameters too are placed under the
    ZeRO specs (what ``maybe_fsdp_pspecs`` returns above its threshold)."""
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import zero as Z

    with S.use_rules(rules), mesh:
        specs = Z.zero_pspecs(state["params"], S.param_pspecs(state["params"]), mesh)
        return Z.place_train_state(state, mesh, specs, param_specs=specs if fsdp else None), specs


def _same_norms(tag: str, metrics) -> None:
    """Every device clipped with the same grad norm (the reduced gradients
    are the same bits on every device)."""
    norms = [float(g) for g in metrics["grad_norms"]]
    if any(g != norms[0] for g in norms):
        raise AssertionError(f"{tag}: the devices' grad norms differ: {norms}")


def _hold_step(tag: str, against: str, params: list, moments: list, lr: float, card: str,
               hold_m: bool = True) -> None:
    """A mesh step's updated leaves and AdamW m held against another run
    of the same first step (m and v zero before it): ``params`` and
    ``moments`` are (name, got, want) triples.  A first AdamW step moves
    an element by lr·g/(|g| + eps) plus the same decay, so two runs whose
    gradients differ only in rounding differ by at most 2·lr where an
    element's gradient changes sign (and by f32 rounding elsewhere); m is
    (1 - b1) times the clipped gradient, held per leaf within
    MESH_GNORM_RTOL in L2 (with ``hold_m`` off, only printed).  Prints the
    share of elements whose update differs by more than lr."""
    worst_p, flipped, n_el, worst_m, worst_name = 0.0, 0, 0, 0.0, None
    with torch.no_grad():
        for name, got, want in params:
            d = (got - want).abs()
            if not bool((d <= 2 * lr + 2**-22 * want.abs()).all()):
                raise AssertionError(f"{tag}: {name} moved {float(d.max()):.3e} from the {against}, more than two "
                                     f"AdamW steps of lr {lr:g}")
            worst_p = max(worst_p, float(d.max()))
            flipped += int((d > lr).sum())
            n_el += d.numel()
        for name, got, want in moments:
            scale = float(want.norm())
            err = float((got - want).norm()) / scale if scale > 0 else float((got - want).abs().max())
            if err >= worst_m:
                worst_m, worst_name = err, name
    log(f"[train-mesh] {tag} first step against the {against}: updated leaves max|Δ| {worst_p:.3e} (bound 2·lr "
        f"{2 * lr:g}), {flipped} of {n_el} elements ({flipped / n_el:.2e}) updated more than lr apart; AdamW m "
        f"|Δm| / |m| {worst_m:.3e} at worst ({worst_name}; "
        f"{f'bound {MESH_GNORM_RTOL:g} a leaf' if hold_m else 'not held'}) [{card}]")
    if hold_m and worst_m > MESH_GNORM_RTOL:
        raise AssertionError(f"{tag}: AdamW m of {worst_name} is {worst_m:.3e} from the {against}'s")


def _mesh_steps(step, placed, fn, cfg, tag: str, mesh, card: str, first: int, check=None) -> tuple:
    """MESH_TRAIN_STEPS more steps of ``step`` over ``fn``'s batches: each
    step's loss, grad norm, ms (synchronised), K3 launches and peak
    memory; asserts every device's grad norm the same and K3 forward 2 x
    layers and backward one a layer per data shard a step, on each of its
    model devices where the heads split over them (``layers.heads_split``)
    and on its lead alone where they do not; ``check(placed, metrics)``,
    if given, sees the first step's outcome.  Returns (placed, losses,
    median ms, launches)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers as L

    replicas = len(mesh.model_groups(("data",)))
    tp = mesh.shape.get("model", 1)
    replicas *= tp if tp > 1 and L.heads_split(cfg, tp) else 1
    want = (2 * cfg.num_layers * replicas, cfg.num_layers * replicas)
    losses, times, launches = [], [], {"flash_attention": 0, "flash_attention_bwd": 0}
    for i in range(first, first + MESH_TRAIN_STEPS):
        batch = fn(0, i, 0, 1)
        _zero_attention_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed, metrics = step(placed, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _same_norms(f"{tag} step {i}", metrics)
        got = (fa_ops.flash_attention_bshd.launches, fa_ops.flash_attention_bwd_bshd.launches)
        launches["flash_attention"] += got[0]
        launches["flash_attention_bwd"] += got[1]
        losses.append(loss)
        log(f"[train-mesh] {tag} step {i}: loss {loss:.4f}, grad norm {gnorm:.4f}, {times[-1]:.1f} ms, K3 "
            f"{got[0]} forward / {got[1]} backward ({replicas} devices running attention), peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        if got != want:
            raise AssertionError(f"{tag}: K3 launches a step {got}, expected {want} ({2 * cfg.num_layers} forward "
                                 f"and {cfg.num_layers} backward on each of {replicas} devices)")
        if check is not None and i == first:
            check(placed, metrics)
    return placed, losses, statistics.median(times), launches


def train_mesh_gemma(dev, card: str) -> dict:
    """(b) Gemma3-1B at full width and depth (f32 master weights, bf16
    compute) data-parallel on two streams of the card,
    ``make_mesh((2, 1), ("data", "model"))``, ZeRO-1 moments: the first
    step (step 1) from phase 4E's seeded state and batch against the
    single-device step on the kernels, the two copies bitwise equal after
    it and held to the single-device step's updated leaves and m
    (:func:`_hold_step`), then MESH_TRAIN_STEPS steps; the ring's share
    of a step."""
    from repro_torch import configs
    from repro_torch.data.pipeline import synthetic_lm_batch_fn
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import zero as Z
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import train_loop as loop
    from repro_torch.training.optimizer import AdamWConfig

    cfg = configs.get_config("gemma3-1b")
    tcfg = loop.TrainConfig(optimizer=AdamWConfig(), warmup_steps=1, total_steps=MESH_TRAIN_STEPS + 2)
    fn = synthetic_lm_batch_fn(cfg.vocab_size, TRAIN_B, TRAIN_S)
    batch = fn(0, 0, 0, 1)
    mesh = make_mesh((2, 1), ("data", "model"), _mesh_devices(dev, 2))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = loop.init_train_state(cfg, SEED, dev)
    state["step"].fill_(1)
    placed, specs = _place(state, mesh, S.SINGLE_POD_RULES)
    with S.use_rules(S.SINGLE_POD_RULES), mesh:
        step = loop.make_train_step(cfg, tcfg, grad_pspecs=specs)
    state, single = loop.make_train_step(cfg, tcfg)(state, batch)
    loss1, gnorm1 = float(single["loss"]), float(single["grad_norm"])
    # the single-device step's updated leaves and m, held for the mesh step's
    want_p, want_m = dict(state["params"].named_parameters()), state["opt"]["m"]
    del state, single
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_attention_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed, metrics = step(placed, batch)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    first_ms = (time.perf_counter() - t0) * 1e3
    got = (fa_ops.flash_attention_bshd.launches, fa_ops.flash_attention_bwd_bshd.launches)
    launches = {"flash_attention": got[0], "flash_attention_bwd": got[1]}
    log(f"[train-mesh] {cfg.name} full ({cfg.num_layers} layers), {TRAIN_B}x{TRAIN_S} over 2 streams "
        f"(data-parallel, ZeRO-1): first step (step 1) loss {loss:.6f}, grad norm {gnorm:.6f}, {first_ms:.1f} ms; "
        f"the single-device step on the kernels: loss {loss1:.6f}, grad norm {gnorm1:.6f}; relative "
        f"{abs(loss - loss1) / abs(loss1):.3e} (bound {MESH_LOSS_RTOL:g}), {abs(gnorm - gnorm1) / gnorm1:.3e} "
        f"(bound {MESH_GNORM_RTOL:g}); K3 {got[0]} forward / {got[1]} backward [{card}]")
    if abs(loss - loss1) > MESH_LOSS_RTOL * abs(loss1) or abs(gnorm - gnorm1) > MESH_GNORM_RTOL * gnorm1:
        raise AssertionError(f"{cfg.name} on the mesh: loss {loss} vs {loss1}, grad norm {gnorm} vs {gnorm1}")
    if got != (2 * 2 * cfg.num_layers, 2 * cfg.num_layers):
        raise AssertionError(f"{cfg.name} on the mesh: K3 launches {got}")
    _same_norms(cfg.name, metrics)
    copies = [dict(c.named_parameters()) for c in placed["params"]]
    unequal = [name for name, w in copies[0].items() if not torch.equal(w, copies[1][name])]
    if unequal:
        raise AssertionError(f"{cfg.name}: the two copies differ after a step in {unequal[:4]}")
    log(f"[train-mesh] {cfg.name}: the two copies of all {len(copies[0])} parameters bitwise equal after the step, "
        f"both devices' grad norms the same")
    layout = Z.Layout(placed["params"][0], mesh, specs, S.SINGLE_POD_RULES)
    _hold_step(cfg.name, "single-device step", [(n, w, want_p[n]) for n, w in copies[0].items()],
               [(n, m, Z.take(want_m[n], layout.moment_slice(n, q, want_m[n].shape)))
                for q, ms in enumerate(placed["opt"]["m"]) for n, m in ms.items()], tcfg.optimizer.lr, card)
    del want_p, want_m, layout
    torch.cuda.empty_cache()
    placed, losses, med, more = _mesh_steps(step, placed, fn, cfg, cfg.name, mesh, card, 2)
    _add(launches, more)
    losses = [loss] + losses
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{cfg.name} on the mesh: losses {losses}")
    # the ring's share: the step's gradient reduction alone, on the same devices and leaf sizes
    devices = mesh.flat
    trees = []
    for d, c in zip(devices, placed["params"]):
        with d.scope():
            trees.append([torch.zeros_like(w) for w in c.parameters()])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C.psum_in_chunks(trees, devices)
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    del trees
    n_params = sum(w.numel() for w in placed["params"][0].parameters())
    log(f"[train-mesh] {cfg.name} full ({n_params / 1e9:.3f} B f32 params a copy) on 2 streams: step "
        f"{med:.1f} ms median of {MESH_TRAIN_STEPS}, {TRAIN_B * TRAIN_S / med * 1e3:.0f} tokens/s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"the gradients' psum_in_chunks alone {ring_ms:.1f} ms ({ring_ms / med:.1%} of the step) [{card}]")
    del placed, step, copies
    torch.cuda.empty_cache()
    return launches


class _ByDevice:
    """A kernel wrapper, forwarded to, that also counts its launches by the
    logical device whose scope each call ran in (its own ``launches``
    attribute reads and writes go to the wrapper's)."""

    def __init__(self, fn, counts: dict):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_counts", counts)

    def __call__(self, *args, **kw):
        from repro_torch.device import current_logical

        before = self._fn.launches
        out = self._fn(*args, **kw)
        dev = current_logical()
        label = "no device" if dev is None else dev.label
        self._counts[label] = self._counts.get(label, 0) + self._fn.launches - before
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def _k3_by_device():
    """For the block, K3's forward and backward launches by logical device:
    yields ({label: forward launches}, {label: backward launches})."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    fwd, bwd, real = {}, {}, (fa_ops.flash_attention_bshd, fa_ops.flash_attention_bwd_bshd)
    fa_ops.flash_attention_bshd, fa_ops.flash_attention_bwd_bshd = _ByDevice(real[0], fwd), _ByDevice(real[1], bwd)
    try:
        yield fwd, bwd
    finally:
        fa_ops.flash_attention_bshd, fa_ops.flash_attention_bwd_bshd = real


def _placed_bytes(placed: dict, q: int) -> int:
    """What device ``q`` of a placed training state holds: its parameters,
    its m and v slices, count and step."""
    ts = [*placed["params"][q].parameters(), *placed["opt"]["m"][q].values(), *placed["opt"]["v"][q].values(),
          placed["opt"]["count"][q], placed["step"][q]]
    return sum(t.numel() * t.element_size() for t in ts)


def train_mesh_gemma_tp(dev, card: str, fsdp: bool = False) -> dict:
    """(c) Gemma3-1B at full width and depth (f32 master weights, bf16
    compute) tensor- and data-parallel on four streams of the card,
    ``make_mesh((2, 2), ("data", "model"))`` in the reference's layout:
    each model device stores its slice of every "model"-ruled leaf (2 of
    the 4 query heads' columns of wq, rows of wo, half of each MLP, half
    the vocabulary; wk/wv's half-head slices, gathered before use) and
    computes its heads (K3 at 2 x 1024, 2 heads over 1), its columns and
    its vocab rows.  Per device the placed bytes equal the reference
    layout's for the same spec trees.  The first step (step 1) from phase
    4E's seeded state and batch: held to the single-device step on the
    kernels (loss, grad norm, each device's slice of the updated leaves
    within 2·lr an element; AdamW m printed, not held: the partial
    outputs round in bf16 before their sum, about 2% of m a leaf where
    the single-device step rounds once), and bitwise to the same step run
    serially on the default stream (every leaf and m: no cross-stream
    race); K3's launches per model device.  Then MESH_TRAIN_STEPS steps
    (the loss falls).

    (e) With ``fsdp``, the same with the parameters placed under the ZeRO
    specs too (``zero_pspecs`` of ``param_pspecs``: what
    ``maybe_fsdp_pspecs`` returns above its threshold): each device stores
    its data part of every leaf (whole layers: data index 0 layers 0-12,
    index 1 layers 13-25; the embedding and the final norm on d_model),
    2,999,701,256 bytes with m and v (GEMMA_FSDP_BYTES), each layer
    gathered over the data axes inside its remat and AdamW updating the
    stored parts in place."""
    from repro_torch import configs
    from repro_torch import device as D
    from repro_torch.data.pipeline import synthetic_lm_batch_fn
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import zero as Z
    from repro_torch.launch import specs as LS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import train_loop as loop
    from repro_torch.training.optimizer import AdamWConfig

    cfg = configs.get_config("gemma3-1b")
    tcfg = loop.TrainConfig(optimizer=AdamWConfig(), warmup_steps=1, total_steps=MESH_TRAIN_STEPS + 2)
    fn = synthetic_lm_batch_fn(cfg.vocab_size, TRAIN_B, TRAIN_S)
    batch = fn(0, 0, 0, 1)
    mesh = make_mesh((2, 2), ("data", "model"), _mesh_devices(dev, 4))
    serial_mesh = make_mesh((2, 2), ("data", "model"),
                            [D.LogicalDevice(d.device, d.id, None, f"{d.label} serial") for d in mesh.flat])
    tag = f"{cfg.name} (2, 2){' FSDP' if fsdp else ''}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = loop.init_train_state(cfg, SEED, dev)
    state["step"].fill_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed, specs = _place(state, mesh, S.SINGLE_POD_RULES, fsdp)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    with S.use_rules(S.SINGLE_POD_RULES), mesh:
        step = loop.make_train_step(cfg, tcfg, grad_pspecs=specs, param_pspecs=specs if fsdp else None)
        pspecs = specs if fsdp else S.param_pspecs(state["params"])
        shapes = Z._shapes(state["params"])
        ref_bytes = LS._spec_bytes(shapes, pspecs, mesh, 4) + 2 * LS._spec_bytes(shapes, specs, mesh, 4) + 2 * 4
    if fsdp and ref_bytes != GEMMA_FSDP_BYTES:
        raise AssertionError(f"{tag}: the FSDP spec trees give {ref_bytes} bytes a device, not {GEMMA_FSDP_BYTES}")
    held = [_placed_bytes(placed, q) for q in range(mesh.size)]
    whole = sum(t.numel() * t.element_size() for t in [*state["params"].parameters(), *state["opt"]["m"].values(),
                                                        *state["opt"]["v"].values()])
    log(f"[train-mesh] {tag}: placed per device {held} bytes ({held[0] / 2**30:.3f} GiB); the reference "
        f"layout's spec trees give {ref_bytes} bytes a device; the whole state {whole / 2**30:.3f} GiB; placement "
        f"{place_s:.1f} s [{card}]")
    if any(b != ref_bytes for b in held):
        raise AssertionError(f"{tag}: placed bytes {held} per device, the reference layout {ref_bytes}")
    placed_s, _ = _place(state, serial_mesh, S.SINGLE_POD_RULES, fsdp)
    state, single = loop.make_train_step(cfg, tcfg)(state, batch)
    loss1, gnorm1 = float(single["loss"]), float(single["grad_norm"])
    want_p, want_m = dict(state["params"].named_parameters()), state["opt"]["m"]
    del state, single
    with S.use_rules(S.SINGLE_POD_RULES), serial_mesh:
        placed_s, metrics_s = loop.make_train_step(cfg, tcfg, grad_pspecs=specs,
                                                   param_pspecs=specs if fsdp else None)(placed_s, batch)
    loss_s, gnorm_s = float(metrics_s["loss"]), float(metrics_s["grad_norm"])
    placed_s["opt"]["v"] = None  # what is held: each device's leaves and m
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_attention_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _k3_by_device() as (fwd, bwd):
        placed, metrics = step(placed, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    first_ms = (time.perf_counter() - t0) * 1e3
    got = (sum(fwd.values()), sum(bwd.values()))
    launches = {"flash_attention": got[0], "flash_attention_bwd": got[1]}
    log(f"[train-mesh] {tag} full ({cfg.num_layers} layers), {TRAIN_B}x{TRAIN_S} over 4 streams (2 data shards x 2 "
        f"model devices, {'FSDP' if fsdp else 'ZeRO-1'}): first step (step 1) loss {loss:.6f}, grad norm {gnorm:.6f}, {first_ms:.1f} ms; the "
        f"single-device step on the kernels: loss {loss1:.6f}, grad norm {gnorm1:.6f}; relative "
        f"{abs(loss - loss1) / abs(loss1):.3e} (bound {MESH_LOSS_RTOL:g}), {abs(gnorm - gnorm1) / gnorm1:.3e} "
        f"(bound {MESH_GNORM_RTOL:g}); serially on the default stream: loss {loss_s:.6f}, grad norm {gnorm_s:.6f}; "
        f"K3 forward launches by device {fwd}, backward {bwd} [{card}]")
    if abs(loss - loss1) > MESH_LOSS_RTOL * abs(loss1) or abs(gnorm - gnorm1) > MESH_GNORM_RTOL * gnorm1:
        raise AssertionError(f"{tag}: loss {loss} vs {loss1}, grad norm {gnorm} vs {gnorm1}")
    labels = [d.label for d in mesh.flat]
    if fwd != dict.fromkeys(labels, 2 * cfg.num_layers) or bwd != dict.fromkeys(labels, cfg.num_layers):
        raise AssertionError(f"{tag}: K3 launches by device {fwd} forward, {bwd} backward; expected "
                             f"{2 * cfg.num_layers} and {cfg.num_layers} on each of {labels}")
    _same_norms(tag, metrics)
    differ = [f"{d.label} {n}" for d, c, cs_ in zip(mesh.flat, placed["params"], placed_s["params"])
              for (n, w), w_s in zip(c.named_parameters(), cs_.parameters()) if not torch.equal(w, w_s)]
    differ += [f"{d.label} m {n}" for d, ms, ms_s in zip(mesh.flat, placed["opt"]["m"], placed_s["opt"]["m"])
               for n, m in ms.items() if not torch.equal(m, ms_s[n])]
    if (loss, gnorm) != (loss_s, gnorm_s) or differ:
        raise AssertionError(f"{tag}: the step on streams differs from the serial run: loss {loss} / {loss_s}, "
                             f"grad norm {gnorm} / {gnorm_s}, {len(differ)} tensors, e.g. {differ[:4]}")
    n_tensors = sum(len(list(c.parameters())) + len(ms) for c, ms in zip(placed["params"], placed["opt"]["m"]))
    log(f"[train-mesh] {tag}: the step on 4 streams bitwise the serial run's: loss, grad norm and all {n_tensors} "
        f"leaves and m slices of the 4 devices [{card}]")
    del placed_s
    layout = Z.Layout(placed["params"][0], mesh, specs, S.SINGLE_POD_RULES, specs if fsdp else None)
    params, moments = [], []
    for q, (d, copy_q) in enumerate(zip(mesh.flat, placed["params"])):
        for n, w in copy_q.named_parameters():
            psl = layout.param_slice(n, q, want_p[n].shape)
            dsl = layout.data_slice(n, q, layout.model_shape(n))  # the moments' part; under FSDP the stored one
            if layout.fsdp_dim[n] is None:
                params.append((f"{d.label} {n}", w, Z.take(want_p[n], psl)))
            elif dsl is not None:
                params.append((f"{d.label} {n}", w, Z.take(Z.take(want_p[n], psl), dsl)))
            if n in placed["opt"]["m"][q]:
                moments.append((f"{d.label} {n}", placed["opt"]["m"][q][n], Z.take(Z.take(want_m[n], psl), dsl)))
    _hold_step(tag, "single-device step", params, moments, tcfg.optimizer.lr, card, hold_m=False)
    del want_p, want_m, layout, params, moments
    torch.cuda.empty_cache()
    placed, losses, med, more = _mesh_steps(step, placed, fn, cfg, tag, mesh, card, 2)
    _add(launches, more)
    losses = [loss] + losses
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{tag}: losses {losses}")
    log(f"[train-mesh] {tag} full, tensor-parallel (heads, MLP columns, vocab) x data-parallel"
        f"{' (FSDP)' if fsdp else ''} on 4 streams: step "
        f"{med:.1f} ms median of {MESH_TRAIN_STEPS}, {TRAIN_B * TRAIN_S / med * 1e3:.0f} tokens/s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{card}]")
    del placed, step
    torch.cuda.empty_cache()
    return launches


def train_mesh_olmoe(dev, card: str) -> dict:
    """(d) OLMoE-1B-7B at full width and OLMOE_TRAIN_LAYERS layers
    (``reduced``) on ``make_mesh((2, 2), ("data", "model"))`` under
    SINGLE_POD_RULES, four streams: one forward of ``moe_apply``'s
    expert-parallel branch on a layer's input bitwise its serial
    definition on the default stream (per data shard, each model device's
    ``_moe_dispatch_compute`` over its 32 experts, the two added), then
    MESH_TRAIN_STEPS steps (losses finite and falling, K3 launches), the
    first held to the same step run serially: the same four logical
    devices without streams, every op on the default stream in program
    order, where no cross-stream race can happen — loss, grad norm, and
    each device's updated leaves and m (:func:`_hold_step`)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import device as D
    from repro_torch.data.pipeline import synthetic_lm_batch_fn
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.training import train_loop as loop
    from repro_torch.training.optimizer import AdamWConfig

    full = configs.get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(full, num_layers=OLMOE_TRAIN_LAYERS)
    tcfg = loop.TrainConfig(optimizer=AdamWConfig(), warmup_steps=1, total_steps=MESH_TRAIN_STEPS + 2)
    fn = synthetic_lm_batch_fn(cfg.vocab_size, TRAIN_B, TRAIN_S)
    mesh = make_mesh((2, 2), ("data", "model"), _mesh_devices(dev, 4))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = loop.init_train_state(cfg, SEED, dev)
    state["step"].fill_(1)
    n_params = sum(w.numel() for w in state["params"].parameters())
    moe = state["params"].layers[0].moe
    dt = torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(SEED).normal(size=(TRAIN_B, TRAIN_S, cfg.d_model)).astype(np.float32))
    x = x.to(dev, dt)
    with torch.no_grad():
        with S.use_rules(S.SINGLE_POD_RULES), mesh:
            y = L.moe_apply(moe, cfg, x)
        e, k, tp = cfg.num_experts, cfg.experts_per_token, mesh.shape["model"]
        n_local, t_local = e // tp, (TRAIN_B // 2) * TRAIN_S
        cap = L.moe_capacity(cfg, t_local)
        xt, serial = x.reshape(-1, cfg.d_model), []
        for i in range(2):
            parts = [L._moe_dispatch_compute(
                xt[i * t_local:(i + 1) * t_local], moe.router,
                types.SimpleNamespace(**{w: getattr(moe.experts, w)[m * n_local:(m + 1) * n_local]
                                         for w in ("w_gate", "w_up", "w_down")}),
                e, k, cap, cfg.mlp_act, dt, local_expert_range=(m * n_local, n_local)) for m in range(tp)]
            serial.append(parts[0] + parts[1])
        serial = torch.cat(serial).reshape(y.shape)
    if not torch.equal(y, serial):
        raise AssertionError(f"OLMoE's expert-parallel moe_apply differs from its serial definition: "
                             f"{float((y.float() - serial.float()).abs().max()):.3e}")
    log(f"[train-mesh] {full.name} moe_apply's expert-parallel branch on (2, 2) streams ({n_local} experts a model "
        f"device, capacity {cap} a data shard of {t_local} tokens): bitwise its serial definition on the default "
        f"stream")
    del y, serial, x, xt
    tag = f"{full.name} reduced"
    serial_mesh = make_mesh((2, 2), ("data", "model"),
                            [D.LogicalDevice(d.device, d.id, None, f"{d.label} serial") for d in mesh.flat])
    placed_s, specs = _place(state, serial_mesh, S.SINGLE_POD_RULES)
    with S.use_rules(S.SINGLE_POD_RULES), serial_mesh:
        placed_s, metrics_s = loop.make_train_step(cfg, tcfg, grad_pspecs=specs)(placed_s, fn(0, 1, 0, 1))
    _same_norms(f"{tag} serial", metrics_s)
    loss_s, gnorm_s = float(metrics_s["loss"]), float(metrics_s["grad_norm"])
    placed_s["opt"]["v"] = None  # what is held: each device's leaves and m
    placed, specs = _place(state, mesh, S.SINGLE_POD_RULES)
    with S.use_rules(S.SINGLE_POD_RULES), mesh:
        step = loop.make_train_step(cfg, tcfg, grad_pspecs=specs)
    del state, moe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def against_serial(placed, metrics):
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        log(f"[train-mesh] {tag} step 1 on (2, 2) streams: loss {loss:.6f}, grad norm {gnorm:.6f}; serially on the "
            f"default stream: loss {loss_s:.6f}, grad norm {gnorm_s:.6f}; relative {abs(loss - loss_s) / abs(loss_s):.3e} "
            f"(bound {MESH_LOSS_RTOL:g}), {abs(gnorm - gnorm_s) / gnorm_s:.3e} (bound {MESH_GNORM_RTOL:g}) [{card}]")
        if abs(loss - loss_s) > MESH_LOSS_RTOL * abs(loss_s) or abs(gnorm - gnorm_s) > MESH_GNORM_RTOL * gnorm_s:
            raise AssertionError(f"{tag} on streams: loss {loss} vs {loss_s}, grad norm {gnorm} vs {gnorm_s} serially")
        params = [(f"{dev.label} {n}", w, dict(cs.named_parameters())[n])
                  for dev, c, cs in zip(mesh.flat, placed["params"], placed_s["params"]) for n, w in c.named_parameters()]
        moments = [(f"{dev.label} {n}", m, ms_s[n])
                   for dev, ms, ms_s in zip(mesh.flat, placed["opt"]["m"], placed_s["opt"]["m"]) for n, m in ms.items()]
        _hold_step(tag, "serial run on the default stream", params, moments, tcfg.optimizer.lr, card)
        placed_s.clear()

    placed, losses, med, launches = _mesh_steps(step, placed, fn, cfg, tag, mesh, card, 1, check=against_serial)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{full.name} on the mesh: losses {losses}")
    log(f"[train-mesh] {full.name} full width, reduced to {OLMOE_TRAIN_LAYERS} of {full.num_layers} layers "
        f"({n_params / 1e9:.3f} B f32 params), EP + data-parallel on (2, 2) streams: step {med:.1f} ms median of "
        f"{MESH_TRAIN_STEPS}, {TRAIN_B * TRAIN_S / med * 1e3:.0f} tokens/s, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del placed, step
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _gather_sizes():
    """For the block, the bytes each FSDP gather scope (``sharding.gathered``:
    a layer, the embedding, the head) holds on the card while it is open:
    yields the list they are appended to."""
    from repro_torch.distributed import sharding as S

    sizes, real = [], S.gathered

    @contextlib.contextmanager
    def probe(*modules, **kw):
        before = torch.cuda.memory_allocated()
        with real(*modules, **kw):
            sizes.append(torch.cuda.memory_allocated() - before)
            yield

    S.gathered = probe
    try:
        yield sizes
    finally:
        S.gathered = real


def train_mesh_qwen_fsdp(dev, card: str) -> dict:
    """(f) qwen3-32b at full width and QWEN_FSDP_LAYERS layers (``reduced``)
    on ``make_mesh((2, 2), ("data", "model"))`` under SINGLE_POD_RULES, four
    streams, where ``maybe_fsdp_pspecs`` itself returns FSDP (2.531 B f32
    parameters, 5.06 GB a model device, above its 4 GiB): each device
    stores QWEN_FSDP_BYTES (its data part of each leaf: whole layers, the
    embedding and the LM head on d_model) and each layer gathers its
    leaves inside its remat.  The step's loss, from the same seeded state
    and batch, within MESH_LOSS_RTOL of a single-device forward without
    gradients (run and freed before placement: the whole state and a
    placed one do not fit together with its activations), a finite grad
    norm on every device alike, then MESH_TRAIN_STEPS more steps at AdamW's
    QWEN_FSDP_LR (the loss falls, K3 32 heads over 4 KV heads a model
    device); peak allocated and step ms, and what each gather holds while
    its layer runs (:func:`_gather_sizes`): the largest must be one layer's
    or the head's leaves on a shard's two model devices, far below the
    step's sum of gathers."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import synthetic_lm_batch_fn
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import zero as Z
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import specs as LS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import train_loop as loop
    from repro_torch.training.optimizer import AdamWConfig

    full = configs.get_config("qwen3-32b")
    cfg = dataclasses.replace(full, num_layers=QWEN_FSDP_LAYERS)
    tcfg = loop.TrainConfig(optimizer=AdamWConfig(lr=QWEN_FSDP_LR), warmup_steps=1, total_steps=MESH_TRAIN_STEPS + 2)
    fn = synthetic_lm_batch_fn(cfg.vocab_size, TRAIN_B, TRAIN_S)
    batch = fn(0, 1, 0, 1)
    mesh = make_mesh((2, 2), ("data", "model"), _mesh_devices(dev, 4))
    tag = f"{full.name} reduced FSDP"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = loop.init_train_state(cfg, SEED, dev)
    state["step"].fill_(1)
    n_params = sum(w.numel() for w in state["params"].parameters())
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    with torch.no_grad():
        loss1 = float(loop.lm_loss(state["params"], cfg, tokens[:, :-1], tokens[:, 1:]))
    del tokens
    torch.cuda.empty_cache()
    single_peak = torch.cuda.max_memory_allocated()
    with S.use_rules(S.SINGLE_POD_RULES), mesh:
        pspecs = S.param_pspecs(state["params"])
        specs = Z.zero_pspecs(state["params"], pspecs, mesh)
        fsdp_specs, fsdp = LS.maybe_fsdp_pspecs(cfg, state["params"], pspecs, mesh, bytes_per_param=4)
        shapes = Z._shapes(state["params"])
        want_bytes = 3 * LS._spec_bytes(shapes, fsdp_specs, mesh, 4) + 2 * 4
        if not fsdp or fsdp_specs != specs or want_bytes != QWEN_FSDP_BYTES:
            raise AssertionError(f"{tag}: maybe_fsdp_pspecs gave FSDP {fsdp}, its tree the moments' "
                                 f"{fsdp_specs == specs}, {want_bytes} bytes a device (want {QWEN_FSDP_BYTES})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed = Z.place_train_state(state, mesh, specs, param_specs=fsdp_specs)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        step = loop.make_train_step(cfg, tcfg, grad_pspecs=specs, param_pspecs=fsdp_specs)
    del state
    torch.cuda.empty_cache()
    held = [_placed_bytes(placed, q) for q in range(mesh.size)]
    log(f"[train-mesh] {tag}: {n_params / 1e9:.3f} B f32 params ({cfg.param_count() * 4 / 2 / 1e9:.2f} GB a model "
        f"device, above maybe_fsdp_pspecs' {LS.FSDP_THRESHOLD_BYTES / 2**30:.0f} GiB): placed per device {held} bytes "
        f"({held[0] / 2**30:.3f} GiB), _spec_bytes of the FSDP tree {want_bytes}; placement {place_s:.1f} s; the "
        f"single-device no-grad forward peaked at {single_peak / 2**30:.2f} GiB [{card}]")
    if any(b != want_bytes for b in held):
        raise AssertionError(f"{tag}: placed bytes {held} per device, the FSDP tree's {want_bytes}")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    _zero_attention_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _gather_sizes() as sizes:
        placed, metrics = step(placed, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    first_ms = (time.perf_counter() - t0) * 1e3
    got = (fa_ops.flash_attention_bshd.launches, fa_ops.flash_attention_bwd_bshd.launches)
    log(f"[train-mesh] {tag}: {len(sizes)} gathers in the step (forward and recompute), each holding at most "
        f"{max(sizes) / 2**30:.3f} GiB while its layer runs, {sum(sizes) / 2**30:.3f} GiB in all [{card}]")
    if max(sizes) > sum(sizes) / 3:
        raise AssertionError(f"{tag}: a gather holds {max(sizes)} bytes of the step's {sum(sizes)}")
    launches = {"flash_attention": got[0], "flash_attention_bwd": got[1]}
    log(f"[train-mesh] {tag} ({QWEN_FSDP_LAYERS} of {full.num_layers} layers), {TRAIN_B}x{TRAIN_S} over 4 streams: "
        f"first step (step 1) loss {loss:.6f}, grad norm {gnorm:.6f}, {first_ms:.1f} ms, K3 {got[0]} forward / "
        f"{got[1]} backward; the single-device forward "
        f"without gradients: loss {loss1:.6f}; relative {abs(loss - loss1) / abs(loss1):.3e} (bound "
        f"{MESH_LOSS_RTOL:g}); peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB over "
        f"{resident / 2**30:.2f} GiB resident [{card}]")
    if not np.isfinite(gnorm) or abs(loss - loss1) > MESH_LOSS_RTOL * abs(loss1):
        raise AssertionError(f"{tag}: loss {loss} vs {loss1} single-device, grad norm {gnorm}")
    if got != (2 * 4 * cfg.num_layers, 4 * cfg.num_layers):
        raise AssertionError(f"{tag}: K3 launches {got} a step, not {2 * cfg.num_layers} forward and "
                             f"{cfg.num_layers} backward on each of the 4 devices")
    _same_norms(tag, metrics)
    placed, losses, med, more = _mesh_steps(step, placed, fn, cfg, tag, mesh, card, 2)
    _add(launches, more)
    losses = [loss] + losses
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{tag}: losses {losses}")
    log(f"[train-mesh] {full.name} full width, reduced to {QWEN_FSDP_LAYERS} of {full.num_layers} layers, FSDP x "
        f"tensor-parallel on (2, 2) streams: step {med:.1f} ms median of {MESH_TRAIN_STEPS}, "
        f"{TRAIN_B * TRAIN_S / med * 1e3:.0f} tokens/s, loss {losses[0]:.4f} -> {losses[-1]:.4f}, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del placed, step
    torch.cuda.empty_cache()
    return launches


def run_train_mesh(dev, card: str) -> dict:
    """Phase 4F, the training mesh on logical devices of the card: the
    collectives (:func:`check_collectives`), Gemma3-1B data-parallel on
    two streams (:func:`train_mesh_gemma`), Gemma3-1B tensor- and
    data-parallel in the reference's layout on four
    (:func:`train_mesh_gemma_tp`), OLMoE-1B-7B expert-parallel (its
    attention head-parallel) on four (:func:`train_mesh_olmoe`), then FSDP
    on four: Gemma3-1B under the FSDP tree (:func:`train_mesh_gemma_tp`
    with ``fsdp``) and qwen3-32b at 2 layers, where ``maybe_fsdp_pspecs``
    chooses it (:func:`train_mesh_qwen_fsdp`).  Returns the K3 launches of
    the driven steps."""
    check_collectives(dev, card)
    launches = train_mesh_gemma(dev, card)
    launches = _add(launches, train_mesh_gemma_tp(dev, card))
    launches = _add(launches, train_mesh_olmoe(dev, card))
    t0 = time.perf_counter()
    launches = _add(launches, train_mesh_gemma_tp(dev, card, fsdp=True))
    launches = _add(launches, train_mesh_qwen_fsdp(dev, card))
    log(f"[train-mesh] FSDP parts (e) and (f) took {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


# ------------------------------------------------- phase 4G: serving on a mesh
# (2, 2) streams: two data shards of two model devices.  Gemma3-1B at full size (kv 1 stored twice: one cache
# head a model device), qwen3-32b and OLMoE-1B-7B at full width and 2 layers (``reduced``).  (a) Gemma3-1B at
# full size on (1, 8): its 4 heads over 1 KV head split no group over 8, so its cache splits by sequence over
# "model" (264 keys of the 2112 a device).  The recurrent states, at full size: xlstm-125m on (2, 2) (2 mLSTM heads
# and 384 sLSTM channels a device) and on (1, 8) (4 heads over 8 stay whole on every device, 96 channels a
# device: 16x16's layout), hymba-1.5b on (2, 2) (1600 Mamba channels a device beside its sequence-split cache).  The
# encoder-decoder, at phase 4C's sizes: whisper-large-v3 at full size on (2, 2) (its 20 heads split: 10 a device of
# the self and the cross cache) and on (1, 8) (they do not: the self cache split by sequence, 56 of 448 keys a
# device, the cross cache whole on each of 8).  MLA: deepseek-v2-236b at full width reduced to 2 layers (the dense
# prefix and one MoE layer; all 60, ~470 GB, do not fit) on (2, 2) (64 of the 128 heads a device) and (1, 8) (16),
# its latent cache split by sequence over "model" (1056 or 264 of the 2112 keys a device)
SERVE_MESH_MODELS = (("gemma3-1b", None, DECODE_STEPS, (2, 2)), ("qwen3-32b", 2, CUT_DECODE_STEPS, (2, 2)),
                     ("olmoe-1b-7b", 2, CUT_DECODE_STEPS, (2, 2)), ("gemma3-1b", None, DECODE_STEPS, (1, 8)),
                     ("xlstm-125m", None, CUT_DECODE_STEPS, (2, 2)), ("xlstm-125m", None, CUT_DECODE_STEPS, (1, 8)),
                     ("hymba-1.5b", None, CUT_DECODE_STEPS, (2, 2)),
                     ("whisper-large-v3", None, CUT_DECODE_STEPS, (2, 2)),
                     ("whisper-large-v3", None, CUT_DECODE_STEPS, (1, 8)),
                     ("deepseek-v2-236b", 2, CUT_DECODE_STEPS, (2, 2)),
                     ("deepseek-v2-236b", 2, CUT_DECODE_STEPS, (1, 8)))
# the prompt length the dry run traces a prefill cell with where the model has an sLSTM: its token loop is traced op
# by op (ms a step on the host), and no launch count depends on the length
SLSTM_TRACE_S = 64
# (b) Gemma3-1B and (c) hymba-1.5b at full size on (2, 8) at batch 1 over long_500k's 524,288 keys (32,768 a
# device: the sequence splits over "data" and "model"), a seeded random cache; decode from a length whose sliding
# window (512 keys, 1024) straddles devices 14 and 15; hymba's Mamba states whole on both data indices
SERVE_MESH_LONG = ("gemma3-1b", "hymba-1.5b")
LONG_MESH, LONG_KEYS, LONG_FROM, LONG_STEPS = (2, 8), 524_288, 491_720, 4


@contextlib.contextmanager
def _launches_by_device():
    """For the block, K3's, K4's and K6's launches by logical device:
    yields ({label: K3 launches}, {label: K4 launches}, {label: K6
    launches})."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops

    k3, k4, k6 = {}, {}, {}
    real = (fa_ops.flash_attention_bshd, da_ops.decode_attention_cache, scan_ops.selective_scan)
    fa_ops.flash_attention_bshd, da_ops.decode_attention_cache = _ByDevice(real[0], k3), _ByDevice(real[1], k4)
    scan_ops.selective_scan = _ByDevice(real[2], k6)
    try:
        yield k3, k4, k6
    finally:
        fa_ops.flash_attention_bshd, da_ops.decode_attention_cache, scan_ops.selective_scan = real


def _lead_routing(record: list, leads: set):
    """Record every MoE routing the shards' leads make (top-k ids, in
    order): a shard's other model devices route the same tokens again for
    their own experts (the expert-parallel branch)."""
    from unittest import mock

    from repro_torch.device import current_logical
    from repro_torch.models import layers as L

    gates = L.moe_gates

    def recording(xt, router, k):
        w, idx = gates(xt, router, k)
        if current_logical() is None or current_logical().label in leads:
            record.append(idx)
        return w, idx

    return mock.patch.object(L, "moe_gates", recording)


def _mesh_routing_note(differ: list) -> str:
    if not differ[1]:
        return ""
    return (f"; the single device's own gates would route {int(differ[0])} of {differ[1]} MoE token-layers to other "
            f"experts (it takes the mesh's)")


def _per_layer(record: list, tokens: int) -> list:
    """The mesh's lead routings joined into one (tokens, k) routing a layer
    call, in the shards' row order (the single-device run's calls)."""
    out, part = [], []
    for idx in record:
        part.append(idx)
        if sum(p.shape[0] for p in part) == tokens:
            out.append(torch.cat(part))
            part = []
    if part:
        raise AssertionError(f"mesh routings of {[p.shape[0] for p in part]} rows do not make {tokens}")
    return out


def serve_mesh_model(dev, card: str, arch: str, layers, steps: int, shape=(2, 2)) -> dict:
    """One model served on ``shape`` streams of the card
    (``decode.make_mesh_prefill`` / ``make_mesh_decode_step`` over
    ``zero.place_params``' copies, the cache split as
    ``choose_cache_policy`` says: by heads and rows, or by sequence where
    the heads do not split; a recurrent state by rows and, where they split,
    its heads or channels; an encoder-decoder's cross cache by rows and
    heads where the heads split, else whole on each model device; MLA's
    latent cache by rows and sequence beside its heads over "model"), bf16,
    seeded weights: a prefill of PREFILL_B x PREFILL_S into a DECODE_MAX_LEN
    cache (an encoder-decoder's WHISPER_B x WHISPER_PROMPT over
    WHISPER_FRAMES seeded stub frames each, ``conv_stub_frames``, into a
    WHISPER_MAX_LEN cache), then ``steps`` greedy decode steps.  Held: each
    call's logits against the same weights' single-device run on the same
    tokens within LM_LOGIT_RTOL (an MoE model's single-device run takes the
    mesh's routing, and how many token-layers its own gates would route
    elsewhere is logged); the same calls on a mesh of the same devices
    without streams (every op on the default stream in program order)
    bitwise, logits and every cache slice; K3 once a layer on each model
    device in prefill (on each data shard's lead alone with a GQA cache
    split by sequence: attention runs whole there; MLA's head-parallel on
    every model device, its decode no kernel) and K4 once a layer a step on each,
    K6 once a layer a call on each data shard's lead (hymba's Mamba), none
    for the xLSTM; an encoder-decoder's K3 also once an encoder layer and
    once a cross layer and K4 once a cross layer a step, on every model
    device where the heads split, on each lead where they do not; the
    busiest device's counts equal to the dry run's per-device count of the
    same cell (an sLSTM's prefill cell traced at SLSTM_TRACE_S tokens); each
    device's placed bytes (weights, cache) equal to the reference layout's
    spec trees' (the weights at 2 bytes, each cache leaf at the reference's
    dtype: the recurrent states f32), plus 2 for each element of the leaves
    the port keeps in f32.  Prefill and decode ms, mesh and single device."""
    import dataclasses
    from unittest import mock

    from repro_torch import configs
    from repro_torch import device as Dv
    from repro_torch.configs.shapes import InputShape
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import zero as Z
    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import specs as LS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decode as D
    from repro_torch.models import frontends
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.kv_cache import choose_cache_policy

    full = configs.get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
    tag = f"{full.name}{'' if layers is None else f' reduced to {layers} of {full.num_layers} layers'}"
    b, s, max_len, vocab = PREFILL_B, PREFILL_S, DECODE_MAX_LEN, cfg.vocab_size
    if cfg.is_encdec:
        b, s, max_len = WHISPER_B, WHISPER_PROMPT, WHISPER_MAX_LEN
    n_dev, on = shape[0] * shape[1], f"({shape[0]}, {shape[1]}) streams"
    kind = T.main_block_kind(cfg)
    t0 = time.perf_counter()
    trace_mesh = make_mesh(shape, ("data", "model"), H.trace_devices(n_dev))
    # the mesh places the weights under the tensor-parallel specs (``param_pspecs``) and the trace follows: above
    # the reference's FSDP threshold (deepseek-v2-236b's 2 layers at TP 2) its cell would add FSDP (ROADMAP 26b.4b)
    with mock.patch.object(LS, "FSDP_THRESHOLD_BYTES", float("inf")):
        traced = {k: dryrun.run_cell(cfg, InputShape(f"4g_{k}", k, n, b), trace_mesh)
                  for k, n in (("prefill", SLSTM_TRACE_S if kind == "xlstm" else s), ("decode", max_len))}
    want_k3 = traced["prefill"]["hlo"]["launches"].get("flash_attention")
    want_k4 = traced["decode"]["hlo"]["launches"].get("decode_attention")
    want_k6 = [traced[k]["hlo"]["launches"].get("selective_scan") for k in ("prefill", "decode")]
    trace_s = time.perf_counter() - t0
    model, _ = _build_lm(dev, cfg, f"{tag} (phase 4G)")
    mesh = make_mesh(shape, ("data", "model"), _mesh_devices(dev, n_dev))
    serial = make_mesh(shape, ("data", "model"),
                       [Dv.LogicalDevice(d.device, d.id, None, f"{d.label} serial") for d in mesh.flat])
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, shape[1], b, shape[0])
        pspecs = S.param_pspecs(model)
        placed = Z.place_params(model, mesh, pspecs)
        prefill, step = D.make_mesh_prefill(cfg, mesh, pspecs, policy), D.make_mesh_decode_step(cfg, mesh, pspecs,
                                                                                                   policy)
        prefill_s, step_s = (D.make_mesh_prefill(cfg, serial, pspecs, policy),
                             D.make_mesh_decode_step(cfg, serial, pspecs, policy))
        want_params, surplus = LS._param_spec_bytes(LS.param_structs(cfg), pspecs, mesh)
        whole_cache = D.init_cache(cfg, b, max_len, policy.kv_repeat, device="meta")
        want_cache = LS._cache_spec_bytes(whole_cache, D.cache_pspecs(whole_cache, policy, mesh), mesh)
    rng = np.random.default_rng(SEED + 6)
    prompts = torch.from_numpy(rng.integers(0, vocab, size=(b, s))).to(dev)
    leads = {mesh.flat[i * shape[1]].label for i in range(shape[0])}
    inputs = {}
    if cfg.is_encdec:
        inputs["encoder_frames"] = frontends.conv_stub_frames(torch.Generator(device=dev).manual_seed(SEED + 9), b,
                                                              WHISPER_FRAMES, cfg.d_model, device=dev)

    # ---- prefill: single device, then the mesh (a warm-up call each), then the serial mesh
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    with S.use_rules(S.SINGLE_POD_RULES), mesh:
        ep = cfg.is_moe and L._expert_parallel(cfg, b, s) is not None
    shards = shape[0] if ep else 1
    mla = cfg.attn_type == "mla"
    n_moe = cfg.num_layers - (cfg.first_dense_layers if cfg.is_moe else 0)  # the MoE layers' routings a call

    def single_prefill():
        """The single-device prefill of the same function: with the
        expert-parallel branch each data shard's rows route alone (a
        capacity a shard's tokens), so each shard's rows run alone."""
        rows = b // shards
        parts = [D.prefill(model, cfg, prompts[i * rows:(i + 1) * rows], max_len=max_len,
                           kv_repeat=policy.kv_repeat, **{k: v[i * rows:(i + 1) * rows] for k, v in inputs.items()})
                 for i in range(shards)]
        if shards == 1:
            return parts[0]
        return (torch.cat([p[0] for p in parts]), {k: torch.cat([p[1][k] for p in parts], 1) for k in parts[0][1]},
                torch.cat([p[2] for p in parts]))

    single_prefill()
    prefill(placed, prompts, max_len=max_len, **inputs)
    routing, differ = [], [0, 0]
    _zero_attention_counts()
    with _launches_by_device() as (k3, k4, k6), _lead_routing(routing, leads):
        (logits, cache, lens), mesh_prefill_ms = timed(lambda: prefill(placed, prompts, max_len=max_len, **inputs))
    n_cross, n_mla = (_attention_counts()[k] for k in ("flash_attention_cross", "flash_attention_mla"))
    launches = {"flash_attention": sum(k3.values()) - n_cross - n_mla, "flash_attention_cross": n_cross,
                "flash_attention_mla": n_mla, "selective_scan": sum(k6.values())}
    per_layer = _per_layer(routing, b * s // shards)  # each layer's routing, a shard's at a time under EP
    per_layer = [per_layer[layer * shards + i] for i in range(shards) for layer in range(len(per_layer) // shards)]
    with _pinned_routing(per_layer, differ):
        (single_logits, single_cache, single_lens), single_prefill_ms = timed(single_prefill)
    serial_logits, serial_cache, serial_lens = prefill_s(placed, prompts, max_len=max_len, **inputs)
    err, scale = _rel_err(logits, single_logits, vocab)
    labels = [d.label for d in mesh.flat]
    held = [sum(t.numel() * t.element_size() for t in c.parameters()) for c in placed]
    held_cache = [sum(t.numel() * t.element_size() for t in mine.values()) for mine in cache]
    held_cross = [sum(t.numel() * t.element_size() for k, t in mine.items() if k.startswith("cross_"))
                  for mine in cache]
    routed = ("; MoE expert-parallel per data shard (each shard's rows alone on one device)" if ep else
              "; MoE routing the whole batch" if cfg.is_moe else "")
    log(f"[serve-mesh] {tag} on {on} (cache policy {policy}{routed}): prefill {b}x{s} in "
        f"{mesh_prefill_ms:.1f} ms against {single_prefill_ms:.1f} ms on one device; last-token logits vs the single "
        f"device's: max|d| / "
        f"max|logit| {err:.3e} (max|logit| {scale:.3e}, tolerance {LM_LOGIT_RTOL}){_mesh_routing_note(differ)}; K3 "
        f"launches by device {k3}, K6 {k6} (dry run of the {shape} cell: K3 {want_k3}, K6 {want_k6[0]} a device, "
        f"traced in {trace_s:.1f} s); placed bytes a device: weights {held}, cache {held_cache}"
        f"{f' (of it the cross K/V {held_cross})' if cfg.is_encdec else ''}; the reference "
        f"layout's spec trees (weights at 2 bytes, the cache at its leaves' dtypes) give {want_params} and "
        f"{want_cache}, and the port's f32 norm scales, routers and Mamba leaves add {surplus} [{card}]")
    if not err <= LM_LOGIT_RTOL:
        raise AssertionError(f"{tag}: mesh prefill logits differ from the single device's by {err}")
    # attention whole on the leads where a GQA model's heads do not split; MLA's head-parallel on every device
    k3_on = leads if policy.seq_axes and not mla else labels
    n_attn = None if kind == "xlstm" or mla else cfg.num_layers  # K4's a step: MLA decodes in plain torch
    n_k3 = cfg.num_layers if mla else n_attn
    n_scan = cfg.num_layers if kind == "hybrid" else None
    # an encoder-decoder's K3 also over the encoder's frames and from the prompt over them, where self attention runs
    n_k3 = cfg.encoder_layers + 2 * cfg.num_layers if cfg.is_encdec else n_k3
    if (k3 != (dict.fromkeys(k3_on, n_k3) if n_k3 else {}) or want_k3 != n_k3 or set(k4)
            or n_mla != (cfg.num_layers * len(k3_on) if mla else 0)
            or k6 != (dict.fromkeys(leads, n_scan) if n_scan else {}) or want_k6 != [n_scan, n_scan]
            or n_cross != (cfg.num_layers * len(k3_on) if cfg.is_encdec else 0)):
        raise AssertionError(f"{tag}: prefill launches K3 {k3} ({n_cross} cross), K4 {k4}, K6 {k6}; the dry run's "
                             f"K3 {want_k3}, K6 {want_k6} a device")
    if any(n != want_params + surplus for n in held) or any(n != want_cache for n in held_cache):
        raise AssertionError(f"{tag}: placed bytes {held} / {held_cache}, the spec trees' {want_params} + {surplus} "
                             f"/ {want_cache}")
    whole_cross = sum(t.numel() * t.element_size() for k, t in whole_cache.items() if k.startswith("cross_"))
    if held_cross != [whole_cross // (shape[0] * (1 if policy.seq_axes else shape[1]))] * n_dev:
        raise AssertionError(f"{tag}: cross K/V bytes a device {held_cross}, {whole_cross} whole")
    if lens.tolist() != single_lens.tolist() or not torch.equal(logits, serial_logits):
        raise AssertionError(f"{tag}: prefill lengths {lens.tolist()}, or its logits differ from the serial run's")

    # ---- decode: the mesh's greedy tokens fed to all three
    tok = logits.argmax(-1)
    mesh_ms, single_ms, worst, agree, n_tok = [], [], 0.0, 0, 0
    routing, differ = [], [0, 0]
    by_step = []
    for i in range(steps):
        with _launches_by_device() as (k3, k4, k6), _lead_routing(routing, leads):
            (lg, cache, lens), ms = timed(lambda: step(placed, tok, cache, lens))
        by_step.append((dict(k4), dict(k6)))
        mesh_ms.append(ms)
        per_layer = _per_layer(routing[-n_moe:] if cfg.is_moe else [], b)
        with _pinned_routing(per_layer, differ):
            (slg, single_cache, single_lens), ms = timed(
                lambda: D.decode_step(model, cfg, tok, single_cache, single_lens, kv_repeat=policy.kv_repeat))
        single_ms.append(ms)
        serial_lg, serial_cache, serial_lens = step_s(placed, tok, serial_cache, serial_lens)
        worst = max(worst, _rel_err(lg, slg, vocab)[0])
        if not torch.equal(lg, serial_lg):
            raise AssertionError(f"{tag}: decode step {i} logits differ from the serial run's")
        nxt = lg.argmax(-1)
        agree += int((nxt == slg.argmax(-1)).sum())
        n_tok += b
        tok = nxt
    launches["decode_attention"] = sum(sum(c.values()) for c, _ in by_step)
    launches["selective_scan_step"] = sum(sum(c.values()) for _, c in by_step)
    racy = [f"{mesh.flat[q].label} {k}" for q, (mine, theirs) in enumerate(zip(cache, serial_cache))
            for k in mine if not torch.equal(mine[k], theirs[k])]
    log(f"[serve-mesh] {tag}: decode {steps} steps x {b} from {s} keys: {statistics.median(mesh_ms):.2f} ms/step "
        f"median on the mesh against {statistics.median(single_ms):.2f} on one device (host clock, synchronised); "
        f"logits vs the single device's: max|d| / max|logit| {worst:.3e} (tolerance {LM_LOGIT_RTOL})"
        f"{_mesh_routing_note(differ)}; greedy tokens the single device's own argmax agrees with: {agree} of {n_tok}; K4 "
        f"launches by device a step {by_step[0][0]}, K6 {by_step[0][1]} (dry run: K4 {want_k4}, K6 {want_k6[1]} a "
        f"device); the mesh on streams bitwise the serial run: every call's logits and "
        f"{'all' if not racy else 'NOT all'} {sum(len(c) for c in cache)} cache slices [{card}]")
    if not worst <= LM_LOGIT_RTOL:
        raise AssertionError(f"{tag}: mesh decode logits differ from the single device's by {worst}")
    want_c4 = dict.fromkeys(labels, n_attn) if n_attn else {}
    if cfg.is_encdec:  # K4 over the cross cache on each device that holds its heads, or on each lead
        want_c4 = {label: n + (cfg.num_layers if label in k3_on else 0) for label, n in want_c4.items()}
    if (any(c4 != want_c4 or c6 != (dict.fromkeys(leads, n_scan) if n_scan else {}) for c4, c6 in by_step)
            or want_k4 != max(want_c4.values(), default=None)):
        raise AssertionError(f"{tag}: K4 and K6 launches by device a step {by_step}, the dry run's K4 {want_k4}")
    if racy:
        raise AssertionError(f"{tag}: cache slices differ from the serial run's: {racy}")
    del model, placed, cache, serial_cache, single_cache, prefill, step, prefill_s, step_s
    torch.cuda.empty_cache()
    return launches


def serve_mesh_long(dev, card: str, arch: str = "gemma3-1b") -> dict:
    """(b) Gemma3-1B, or (c) hymba-1.5b, at full size, bf16, seeded
    weights, on (2, 8) streams of the card at batch 1 over long_500k's
    cache: ``choose_cache_policy`` splits its sequence over ("data",
    "model"), LONG_KEYS / 16 keys a device; hymba's Mamba states split by
    channels over "model" and whole on both data indices.  A seeded random
    cache (every leaf, every layer) is placed with ``place_cache``, once
    for the mesh and once for the same mesh without streams; LONG_STEPS
    greedy decode steps from LONG_FROM (a local layer's window, 512 keys or
    1024, straddles devices 14 and 15) on the mesh (the first data index's
    model group runs the layers, every device K4 on its slice, the
    partials merged within each model group, then over the groups; the
    Mamba step on the first lead, its new state sent to all 16 devices),
    on the serial mesh and on one device over the whole cache.  Held: the
    logits within LM_LOGIT_RTOL of the single device's, bitwise the serial
    run's (logits and every cache slice); K4 once a layer a step on every
    device, K6 once a layer a step on the first lead (hymba) and K3 never,
    equal to the dry run's per-device count of the same cell; each
    device's placed bytes (weights, cache) equal to the reference layout's
    spec trees' (the weights at 2 bytes, each cache leaf at its dtype) plus
    2 for each element of the port's f32 leaves.  Decode ms, mesh and one
    device."""
    from repro_torch import configs
    from repro_torch import device as Dv
    from repro_torch.configs.shapes import InputShape
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import zero as Z
    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import specs as LS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decode as D
    from repro_torch.serving.kv_cache import choose_cache_policy

    cfg = configs.get_config(arch)
    part = "(b)" if arch == "gemma3-1b" else "(c)"
    tag = f"{arch} {part}"
    shape, keys, start, steps = LONG_MESH, LONG_KEYS, LONG_FROM, LONG_STEPS
    n_dev, vocab = shape[0] * shape[1], cfg.vocab_size
    t0 = time.perf_counter()
    traced = dryrun.run_cell(cfg, InputShape("4g_long", "decode", keys, 1),
                             make_mesh(shape, ("data", "model"), H.trace_devices(n_dev)))
    want_launches = traced["hlo"]["launches"]
    trace_s = time.perf_counter() - t0
    model, _ = _build_lm(dev, cfg, f"{arch} (phase 4G {part})")
    mesh = make_mesh(shape, ("data", "model"), _mesh_devices(dev, n_dev))
    serial = make_mesh(shape, ("data", "model"),
                       [Dv.LogicalDevice(d.device, d.id, None, f"{d.label} serial") for d in mesh.flat])
    with S.use_rules(S.SINGLE_POD_RULES):
        policy = choose_cache_policy(cfg, shape[1], 1, shape[0])
        pspecs = S.param_pspecs(model)
        placed = Z.place_params(model, mesh, pspecs)
        step, step_s = D.make_mesh_decode_step(cfg, mesh, pspecs, policy), D.make_mesh_decode_step(
            cfg, serial, pspecs, policy)
        want_params, surplus = LS._param_spec_bytes(LS.param_structs(cfg), pspecs, mesh)
        whole_meta = D.init_cache(cfg, 1, keys, policy.kv_repeat, device="meta")
        want_cache = LS._cache_spec_bytes(whole_meta, D.cache_pspecs(whole_meta, policy, mesh), mesh)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cache = D.init_cache(cfg, 1, keys, policy.kv_repeat, device=dev)
    for leaf in cache.values():
        for layer in leaf:
            layer.normal_(generator=gen)
    with S.use_rules(S.SINGLE_POD_RULES):
        placed_cache, serial_cache = D.place_cache(cache, mesh, policy), D.place_cache(cache, serial, policy)
    torch.cuda.synchronize()
    whole_gb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e9
    held = [sum(t.numel() * t.element_size() for t in c.parameters()) for c in placed]
    held_cache = [sum(t.numel() * t.element_size() for t in mine.values()) for mine in placed_cache]
    log(f"[serve-mesh] {tag} on ({shape[0]}, {shape[1]}) streams (cache policy {policy}): a seeded random "
        f"cache of 1 x {keys} keys, {whole_gb:.2f} GB whole, {sum(held_cache) / 1e9:.2f} GB placed "
        f"({held_cache[0]} B a device), made and placed twice in {time.perf_counter() - t0:.1f} s; placed bytes a "
        f"device: weights {held}; the reference layout's spec trees (weights at 2 bytes, the cache at its leaves' "
        f"dtypes) give {want_params} and {want_cache}, and the port's f32 leaves add {surplus} [{card}]")
    if any(n != want_params + surplus for n in held) or any(n != want_cache for n in held_cache):
        raise AssertionError(f"{tag}: placed bytes {held} / {held_cache}, the spec trees' {want_params} + "
                             f"{surplus} / {want_cache}")
    lens_m = lens_s = lens_ser = torch.full((1,), start, dtype=torch.int32, device=dev)
    tok = torch.from_numpy(np.random.default_rng(SEED + 8).integers(0, vocab, size=1)).to(dev)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    labels = [d.label for d in mesh.flat]
    scans = cfg.num_layers if cfg.family == "hybrid" else None
    mesh_ms, single_ms, worst, by_step = [], [], 0.0, []
    _zero_attention_counts()
    for i in range(steps):
        with _launches_by_device() as (k3, k4, k6):
            (lg, placed_cache, lens_m), ms = timed(lambda: step(placed, tok, placed_cache, lens_m))
        by_step.append((dict(k3), dict(k4), dict(k6)))
        mesh_ms.append(ms)
        (slg, cache, lens_s), ms = timed(lambda: D.decode_step(model, cfg, tok, cache, lens_s))
        single_ms.append(ms)
        serial_lg, serial_cache, lens_ser = step_s(placed, tok, serial_cache, lens_ser)
        worst = max(worst, _rel_err(lg, slg, vocab)[0])
        if not torch.equal(lg, serial_lg):
            raise AssertionError(f"{tag}: decode step {i} logits differ from the serial run's")
        tok = lg.argmax(-1)
    racy = [f"{mesh.flat[q].label} {k}" for q, (mine, theirs) in enumerate(zip(placed_cache, serial_cache))
            for k in mine if not torch.equal(mine[k], theirs[k])]
    log(f"[serve-mesh] {tag}: decode {steps} steps x 1 from {start} of {keys} keys: "
        f"{statistics.median(mesh_ms):.2f} ms/step median on the mesh against {statistics.median(single_ms):.2f} on "
        f"one device over the whole cache (host clock, synchronised); logits vs the single device's: max|d| / "
        f"max|logit| {worst:.3e} (tolerance {LM_LOGIT_RTOL}); K4 launches by device a step {by_step[0][1]}, K6 "
        f"{by_step[0][2]}, K3 {by_step[0][0]} (dry run of the {shape} long_500k-size cell: {want_launches} a device, "
        f"traced in {trace_s:.1f} s); lengths {lens_m.tolist()}; the mesh on streams bitwise the serial run: every "
        f"step's logits and {'all' if not racy else 'NOT all'} {sum(len(c) for c in placed_cache)} cache slices "
        f"[{card}]")
    if not worst <= LM_LOGIT_RTOL:
        raise AssertionError(f"{tag}: mesh decode logits differ from the single device's by {worst}")
    want = {"decode_attention": cfg.num_layers, **({"selective_scan": scans} if scans else {})}
    if (any(k3 or k4 != dict.fromkeys(labels, cfg.num_layers)
            or k6 != ({labels[0]: scans} if scans else {}) for k3, k4, k6 in by_step) or want_launches != want):
        raise AssertionError(f"{tag}: launches by device a step {by_step}, the dry run's {want_launches}")
    if racy:
        raise AssertionError(f"{tag}: cache slices differ from the serial run's: {racy}")
    if lens_m.tolist() != [start + steps] or lens_s.tolist() != [start + steps]:
        raise AssertionError(f"{tag}: lengths {lens_m.tolist()} / {lens_s.tolist()}")
    del model, placed, cache, placed_cache, serial_cache, step, step_s
    torch.cuda.empty_cache()
    return {"decode_attention": sum(sum(k4.values()) for _, k4, _ in by_step),
            "selective_scan_step": sum(sum(k6.values()) for _, _, k6 in by_step)}


def run_serve_mesh(dev, card: str) -> dict:
    """Phase 4G, prefill and decode on streams of the card
    (:func:`serve_mesh_model` for each of SERVE_MESH_MODELS on its mesh,
    then :func:`serve_mesh_long` for each of SERVE_MESH_LONG; each model
    freed before the next).  Returns the K3, K4 and K6 launches."""
    launches = {}
    for arch, layers, steps, shape in SERVE_MESH_MODELS:
        t0 = time.perf_counter()
        _add(launches, serve_mesh_model(dev, card, arch, layers, steps, shape))
        log(f"[serve-mesh] {arch} on {shape} took {time.perf_counter() - t0:.1f} s [{card}]")
    for arch in SERVE_MESH_LONG:
        t0 = time.perf_counter()
        _add(launches, serve_mesh_long(dev, card, arch))
        log(f"[serve-mesh] {arch} on {LONG_MESH} at {LONG_KEYS} keys took {time.perf_counter() - t0:.1f} s "
            f"[{card}]")
    return launches


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
    # ---- phase 7's smoke test of the dry run's entry point, on the host beside phase 2 (its checks
    # against the card run inside phases 4 and 4E)
    dryrun_cli = start_dryrun_cli()

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
    t0 = time.perf_counter()
    finish_dryrun_cli(dryrun_cli)
    log(f"[dryrun] phase 7's CLI done (waited {time.perf_counter() - t0:.1f} s after phase 2)")

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
    # ---- phase 4: the LM serving path (Gemma3-1B), and phase 7's dry run of its prefill and decode step
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
    # ---- phase 4E: Gemma3-1B and hymba-1.5b trained at full size (K3 and K6 forward and backward), and
    # phase 7's dry run of one training step of each
    t0 = time.perf_counter()
    _add(launches, run_training_path(dev, card))
    log(f"[train] phase 4E took {time.perf_counter() - t0:.1f} s")
    # ---- phase 4F: the training mesh on logical devices of the card (collectives, DP, EP)
    t0 = time.perf_counter()
    _add(launches, run_train_mesh(dev, card))
    log(f"[train-mesh] phase 4F took {time.perf_counter() - t0:.1f} s [{card}]")
    # ---- phase 4G: prefill and decode on (2, 2) streams (Gemma3-1B, qwen3-32b and OLMoE at 2 layers), then
    # Gemma3-1B's sequence-split cache on (1, 8) and at long_500k's length on (2, 8), the recurrent states
    # (xlstm-125m on (2, 2) and (1, 8), hymba-1.5b on (2, 2) and at long_500k's length on (2, 8)), then the
    # encoder-decoder's cross cache (whisper-large-v3 on (2, 2) and (1, 8))
    t0 = time.perf_counter()
    _add(launches, run_serve_mesh(dev, card))
    log(f"[serve-mesh] phase 4G took {time.perf_counter() - t0:.1f} s [{card}]")
    # ---- phase 5: the vision serving path over phase 3's model and corpus
    t0 = time.perf_counter()
    run_vision_serving(dev, corpus, full, thumb, res, card)
    log(f"[serve] phase 5 took {time.perf_counter() - t0:.1f} s")
    # ---- phase 5B: the replica mesh on two streams of the card
    t0 = time.perf_counter()
    run_mesh_serving(dev, corpus, full, thumb, res, card)
    log(f"[mesh] phase 5B took {time.perf_counter() - t0:.1f} s")
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
