#!/usr/bin/env python3
"""Where a tensor-parallel training step's numbers part from the
single-device step's: Gemma3-1B at full size on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/tp_numerics.py

From ``chip_smoke.py`` phase 4E's seeded state and batch (4 x 1024 tokens,
step 1), one step on one device, then the same step on meshes of logical
devices of the card: (2, 2) on four streams, the same (2, 2) with every op
on the default stream in program order, and (2, 1) data-parallel on two
streams; in bf16 compute (the model's) and, for (2, 2), in f32 compute.
For each mesh step it prints the loss and grad norm against the
single-device step's, the eight leaves whose AdamW m (each device's slice;
(1 - b1) times the clipped gradient) is furthest from the single-device
step's in L2, the embedding's m split into the vocab rows the batch holds
as tokens and the rest, and whether the (2, 2) step on streams is bitwise
its serial run.  Every line carries the card's name and power limit.  It
exits non-zero without a card.
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
from repro_torch import device as D  # noqa: E402
from repro_torch.data.pipeline import synthetic_lm_batch_fn  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed import zero as Z  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.training import train_loop as loop  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402

TCFG = loop.TrainConfig(optimizer=AdamWConfig(), warmup_steps=1, total_steps=5)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.norm())
    return float((got - want).norm()) / scale if scale > 0 else float((got - want).abs().max())


def _state(cfg, dev):
    state = loop.init_train_state(cfg, cs.SEED, dev)
    state["step"].fill_(1)
    return state


def _single(cfg, dev, batch) -> tuple:
    state, m = loop.make_train_step(cfg, TCFG)(_state(cfg, dev), batch)
    out = (state["opt"]["m"], float(m["loss"]), float(m["grad_norm"]))
    del state
    return out


def _mesh_step(cfg, dev, batch, shape, serial: bool) -> tuple:
    devices = cs._mesh_devices(dev, shape[0] * shape[1])
    if serial:
        devices = [D.LogicalDevice(d.device, d.id, None, f"{d.label} serial") for d in devices]
    mesh = make_mesh(shape, ("data", "model"), devices)
    placed, specs = cs._place(_state(cfg, dev), mesh, S.SINGLE_POD_RULES)
    with S.use_rules(S.SINGLE_POD_RULES), mesh:
        step = loop.make_train_step(cfg, TCFG, grad_pspecs=specs)
    placed, m = step(placed, batch)
    torch.cuda.synchronize()
    placed["opt"]["v"] = None
    return placed, Z.Layout(placed["params"][0], mesh, specs, S.SINGLE_POD_RULES), float(m["loss"]), float(m["grad_norm"])


def report(tag: str, cfg, dev, batch, want: tuple, got: tuple, card: str) -> None:
    want_m, loss1, gnorm1 = want
    placed, layout, loss, gnorm = got
    seen = torch.zeros(cfg.padded_vocab_size, dtype=torch.bool, device=dev)
    seen[torch.as_tensor(batch["tokens"]).long().flatten().to(dev)] = True
    errs = []
    for q, (copy, ms) in enumerate(zip(placed["params"], placed["opt"]["m"])):
        named = dict(copy.named_parameters())
        for n, m in ms.items():
            psl, msl = layout.param_slice(n, q, want_m[n].shape), layout.moment_slice(n, q, named[n].shape)
            ref = Z.take(Z.take(want_m[n], psl), msl)
            errs.append((_rel(m, ref), q, n))
            if n == "embed":
                rows = torch.arange(cfg.padded_vocab_size, device=dev)
                rows = Z.take(rows, psl) if psl[0] == 0 else rows
                rows = Z.take(rows, msl) if msl[0] == 0 else rows
                s = seen[rows]
                cs.log(f"[tp-numerics] {tag} device {q} embed m: {int(s.sum())} rows seen as tokens "
                       f"{_rel(m[s], ref[s]):.2e}, {int((~s).sum())} others {_rel(m[~s], ref[~s]):.2e} [{card}]")
    errs.sort(reverse=True)
    worst = ", ".join(f"{e:.2e} device {q} {n}" for e, q, n in errs[:8])
    cs.log(f"[tp-numerics] {tag}: loss {loss:.6f} vs {loss1:.6f} ({abs(loss - loss1) / abs(loss1):.2e}), grad norm "
           f"{gnorm:.6f} vs {gnorm1:.6f} ({abs(gnorm - gnorm1) / gnorm1:.2e}); AdamW m |Δm| / |m| furthest: {worst} "
           f"[{card}]")


def run(dev, card: str) -> None:
    """The steps and their reports on ``dev``."""
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(configs.get_config("gemma3-1b"), dtype=dtype)
        batch = synthetic_lm_batch_fn(cfg.vocab_size, cs.TRAIN_B, cs.TRAIN_S)(0, 0, 0, 1)
        want = _single(cfg, dev, batch)
        torch.cuda.empty_cache()
        streams = None
        for shape, serial in (((2, 2), False), ((2, 2), True), ((2, 1), False)):
            if dtype == "float32" and (serial or shape == (2, 1)):
                continue
            got = _mesh_step(cfg, dev, batch, shape, serial)
            report(f"{dtype} {shape}{' serially' if serial else ''}", cfg, dev, batch, want, got, card)
            if serial:
                same = all(torch.equal(a, b) for ca, cb in zip(streams["params"], got[0]["params"])
                           for a, b in zip(ca.parameters(), cb.parameters()))
                same &= all(torch.equal(m, ms[n]) for mq, ms in zip(streams["opt"]["m"], got[0]["opt"]["m"])
                            for n, m in mq.items())
                cs.log(f"[tp-numerics] {dtype} (2, 2) on four streams against the serial run: every leaf and m "
                       f"bitwise equal: {same} [{card}]")
                streams = None
            elif shape == (2, 2):
                streams = got[0]
            del got
            torch.cuda.empty_cache()
        del want
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_numerics: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    _build.load_library()
    run(torch.device("cuda"), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
