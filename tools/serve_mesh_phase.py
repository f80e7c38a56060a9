#!/usr/bin/env python3
"""Phase 4G of ``chip_smoke.py`` alone, with the K3, K4 and K6 checks
against their plain versions before it: prefill and decode on (2, 2)
streams of one card, Gemma3-1B's sequence-split cache on (1, 8) (part a),
the recurrent states (xlstm-125m on (2, 2) and (1, 8), hymba-1.5b on
(2, 2)), the encoder-decoder (whisper-large-v3 on (2, 2) and (1, 8)),
MLA (deepseek-v2-236b at full width and 2 layers on (2, 2) and (1, 8)),
then long_500k's length on (2, 8) for Gemma3-1B (part b) and hymba-1.5b
(part c).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/serve_mesh_phase.py                 # K3/K4 checks, then 4G
    KERNELS=0 python3 tools/serve_mesh_phase.py       # 4G only
    ONLY=olmoe-1b-7b python3 tools/serve_mesh_phase.py
    KERNELS=0 ONLY=gemma3-1b@1x8,long:gemma3-1b python3 tools/serve_mesh_phase.py   # parts (a) and (b)
    ONLY=xlstm-125m,hymba-1.5b,long:hymba-1.5b python3 tools/serve_mesh_phase.py   # the recurrent states
    ONLY=whisper-large-v3 python3 tools/serve_mesh_phase.py   # the encoder-decoder's cross cache
    ONLY=deepseek-v2-236b python3 tools/serve_mesh_phase.py   # MLA's latent cache split by sequence

It builds the kernels, runs ``check_flash_attention``,
``check_flash_attention_cross``, ``check_decode_attention`` and
``check_selective_scan`` (every case, the
serving mesh's per-device and per-shard shapes and K4's log-sum-exp cases
among them) and times K4 (its log-sum-exp variant at part (a)'s slice
shape among the lines, beside the library's memory-efficient SDPA with its
log-sum-exp) unless ``KERNELS=0``, then ``run_serve_mesh`` for
the entries of ``SERVE_MESH_MODELS`` and ``SERVE_MESH_LONG`` (or those
named in ``ONLY``, comma separated: an architecture, an architecture on
one mesh as ``arch@DxM``, ``long`` for every long_500k part, ``long:arch``
for one).  Every line carries the card's name and power
limit.  A watchdog ends the process after ``WATCHDOG_S`` seconds (default
700).  It exits non-zero without a card or on any miss.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def _watchdog(seconds: float) -> None:
    time.sleep(seconds)
    print("watchdog: out of time", flush=True)
    os._exit(3)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    threading.Thread(target=_watchdog, args=(float(os.environ.get("WATCHDOG_S", "700")),), daemon=True).start()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    card = cs.card_line()
    cs.log(f"[env] kernels ready in {time.perf_counter() - t0:.1f} s; card {card}")
    only = os.environ.get("ONLY")
    if only:
        names = only.split(",")
        cs.SERVE_MESH_MODELS = tuple(m for m in cs.SERVE_MESH_MODELS
                                     if m[0] in names or f"{m[0]}@{m[3][0]}x{m[3][1]}" in names)
        cs.SERVE_MESH_LONG = tuple(a for a in cs.SERVE_MESH_LONG if "long" in names or f"long:{a}" in names)
    dev = torch.device("cuda")
    if os.environ.get("KERNELS", "1") == "1":
        t0 = time.perf_counter()
        cs.check_flash_attention(dev)
        cs.check_flash_attention_cross(dev)
        cs.check_decode_attention(dev)
        cs.check_selective_scan(dev)
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
        cs.time_decode_attention(dev, flush)
        del flush
        cs.log(f"[kernels] K3 (cross too), K4 and K6 checks and K4's times took {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    launches = cs.run_serve_mesh(dev, card)
    cs.log(f"[serve-mesh] phase 4G took {time.perf_counter() - t0:.1f} s, launches {launches} [{card}]")
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
