#!/usr/bin/env python3
"""Two checkouts' LM training path (``chip_smoke.py`` phase 4E) on one
card, in turns.

Run from the root of a checkout on a machine with one NVIDIA H100, with
another commit unpacked into a directory (``git archive <commit> | tar -x
-C build/parent``):

    python3 tools/train_step_ab.py build/parent [rounds]

Each round measures the other checkout, this one, this one, the other (one
process each, each importing its own ``chip_smoke.py`` and building its own
kernels; ``rounds`` defaults to 3).  A process runs that checkout's
``run_training_path``: Gemma3-1B and hymba-1.5b trained at full size, 4 x
1024 tokens a step from a seeded state, with their own checks.  The
processes' lines pass through; at the end each configuration's step time
(the median of a run's steady steps, synchronised) is listed per side, with
the card's name and power limit.  It exits non-zero without a card or when
a run fails.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEP = re.compile(r"^\[train\] (\S+) full \(.*: step ([0-9.]+) ms median")


def measure(tree: Path, label: str) -> None:
    import torch

    sys.path.insert(0, str(tree))
    import chip_smoke as C

    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = C.card_line()
    _build.load_library()
    C.log(f"[ab] {label}: phase 4E of {tree} [{card}]")
    t0 = time.perf_counter()
    C.run_training_path(torch.device("cuda"), card)
    C.log(f"[ab] {label}: phase 4E took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[2] in ("other", "this"):
        measure(Path(sys.argv[1]).resolve(), sys.argv[2])
        return 0
    import torch

    if len(sys.argv) not in (2, 3) or not torch.cuda.is_available():
        print(__doc__ if len(sys.argv) not in (2, 3) else "train_step_ab: no CUDA device", file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    rounds = int(sys.argv[2]) if len(sys.argv) == 3 else 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    steps: dict = {}
    for r in range(rounds):
        for tree, label in ((other, "other"), (ROOT, "this"), (ROOT, "this"), (other, "other")):
            proc = subprocess.run([sys.executable, __file__, str(tree), label], capture_output=True, text=True,
                                  timeout=900)
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode:
                print(f"[ab] round {r + 1} {label} failed: rc {proc.returncode}", flush=True)
                return 1
            for line in proc.stdout.splitlines():
                m = STEP.match(line)
                if m:
                    steps.setdefault((m.group(1), label), []).append(float(m.group(2)))
    for (arch, label), ms in sorted(steps.items()):
        print(f"[ab] {arch} {label} ({other if label == 'other' else ROOT}): step ms median of each run "
              f"{', '.join(f'{t:.1f}' for t in ms)}; median {statistics.median(ms):.1f} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
