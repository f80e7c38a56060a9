#!/usr/bin/env python3
"""Two checkouts' split-decode programs on one card, in turns.

Run from the root of a checkout on a machine with one NVIDIA H100, with
another commit unpacked into a directory (``git archive <commit> | tar -x
-C build/parent``):

    python3 tools/split_decode_ab.py build/parent

It measures the other checkout, this one, this one, the other (one process
each, each building its own kernels).  Each builds the split-decode program
(``compile_coeff_program``, packed staging) of phase 3's batch (64 smooth
384x512 SJPG 4:2:0 q90 images at factor 1) and of phase 6C's (16 at
768x1024, factor 2) around a full-width ResNet-50 with seeded random
weights and ``standard_chain(224)``, and prints the device time per batch
(CUDA events, median of 7, on a batch already on the card) of the program,
of the same program with the DNN left out (decode + preprocessing), and of
the DNN alone, each after a ~1 ms and a ~23 ms spin of the card (the
longer one hides the host's enqueue of a program's hundreds of launches).
Every line names the card and its power limit.  It exits non-zero without
a card.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
BATCHES = (("phase 3", 64, 384, 512, 1), ("6C", 16, 768, 1024, 2))
SPINS = ((2_000_000, "~1 ms spin"), (40_000_000, "~23 ms spin"))  # clock cycles


def median_ms(fn, spin: int, iters: int = 7, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def measure(tree: Path, label: str) -> None:
    """One checkout's numbers (run in a process of its own)."""
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core import dag as dag_mod
    from repro_torch.core import device_compiler as DC
    from repro_torch.core.planner import standard_chain
    from repro_torch.kernels import _build
    from repro_torch.models.resnet import RESNET50, ResNet
    from repro_torch.preprocessing import jpeg
    from repro_torch.preprocessing.ops import TensorMeta

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[{label}] {tree}: kernels ready in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    dev = torch.device("cuda")
    model = ResNet(RESNET50, generator=torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.default_rng(0)
    for name, n, h, w, factor in BATCHES:
        datas = []
        for _ in range(n):  # piecewise-smooth images, as chip_smoke.smooth_image makes them
            base = rng.normal(size=(-(-h // 16), -(-w // 16), 3))
            img = np.clip(np.kron(base, np.ones((16, 16, 1))) * 35 + 128, 0, 255).astype(np.uint8)
            datas.append(jpeg.encode(img[:h, :w], quality=90, subsample=True))
        hdr = jpeg.peek_header(datas[0])
        staged = np.stack([jpeg.stage_coefficients(jpeg.decode_to_coefficients(d)[1], hdr, "packed")
                           for d in datas])
        meta = TensorMeta((-(-h // factor), -(-w // factor), 3), "uint8", "HWC")
        ops = dag_mod.optimize(standard_chain(224), meta).ops
        progs = {
            "program": DC.compile_coeff_program(hdr, ops, model, n, factor=factor, layout="packed",
                                                device=dev),
            "decode + preprocessing": DC.compile_coeff_program(hdr, ops, lambda x: x, n, factor=factor,
                                                               layout="packed", device=dev),
        }
        on_dev = torch.from_numpy(staged).to(dev)
        images = torch.zeros((n, 3, 224, 224), device=dev)
        with torch.inference_mode():
            for spin, spin_name in SPINS:
                times = {k: median_ms(lambda: p.fn(on_dev), spin) for k, p in progs.items()}
                times["ResNet-50 alone"] = median_ms(lambda: model(images), spin)
                print(f"[{label}] {name} batch of {n} ({h}x{w}, factor {factor}), {spin_name}: "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()) + f" [{card}]",
                      flush=True)


def main() -> int:
    if len(sys.argv) == 3:
        measure(Path(sys.argv[1]).resolve(), sys.argv[2])
        return 0
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__ if len(sys.argv) != 2 else "split_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    for tree, label in ((other, "other"), (ROOT, "this"), (ROOT, "this"), (other, "other")):
        proc = subprocess.run([sys.executable, __file__, str(tree), label], timeout=900)
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
