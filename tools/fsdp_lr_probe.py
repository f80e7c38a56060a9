#!/usr/bin/env python3
"""How qwen3-32b at full width and 2 layers trains at two learning rates,
on one device and under FSDP on (2, 2) logical devices of one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/fsdp_lr_probe.py

From ``chip_smoke.py`` phase 4F's seeded state (step 1) and batches (4 x
1024 tokens, ``synthetic_lm_batch_fn`` at steps 1-4), AdamW with
``warmup_steps=1`` (its first step is sign-like: every element moves by
about lr): four single-device steps at lr 3e-4 (``AdamWConfig``'s
default) and at ``chip_smoke.QWEN_FSDP_LR``, then the same four steps at
each rate on the FSDP mesh of phase 4F's part (f).  It prints each run's
losses, so the mesh's trajectory can be read against one device's at the
same rate.  Every line carries the card's name and power limit.  It exits
non-zero without a card.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import synthetic_lm_batch_fn  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.training import train_loop as loop  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402

STEPS = 4


def losses(cfg, tcfg, dev, mesh=None) -> list[float]:
    """STEPS steps from the seeded state, on one device or FSDP on
    ``mesh``."""
    state = loop.init_train_state(cfg, cs.SEED, dev)
    state["step"].fill_(1)
    if mesh is None:
        step = loop.make_train_step(cfg, tcfg)
    else:
        with S.use_rules(S.SINGLE_POD_RULES), mesh:
            specs = Z.zero_pspecs(state["params"], S.param_pspecs(state["params"]), mesh)
            state = Z.place_train_state(state, mesh, specs, param_specs=specs)
            step = loop.make_train_step(cfg, tcfg, grad_pspecs=specs, param_pspecs=specs)
        torch.cuda.empty_cache()
    fn = synthetic_lm_batch_fn(cfg.vocab_size, cs.TRAIN_B, cs.TRAIN_S)
    out = []
    for i in range(1, STEPS + 1):
        state, m = step(state, fn(0, i, 0, 1))
        out.append(float(m["loss"]))
    del state, step
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fsdp_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    _build.load_library()
    cfg = dataclasses.replace(configs.get_config("qwen3-32b"), num_layers=cs.QWEN_FSDP_LAYERS)
    mesh = make_mesh((2, 2), ("data", "model"), cs._mesh_devices(dev, 4))
    for lr in (3e-4, cs.QWEN_FSDP_LR):
        tcfg = loop.TrainConfig(optimizer=AdamWConfig(lr=lr), warmup_steps=1, total_steps=STEPS + 1)
        for where, m in (("one device", None), ("FSDP (2, 2)", mesh)):
            got = losses(cfg, tcfg, dev, m)
            cs.log(f"[fsdp-lr] {cfg.name} at {cfg.num_layers} layers, lr {lr:g}, {where}: losses "
                   f"{', '.join(f'{x:.4f}' for x in got)}; peak allocated "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
