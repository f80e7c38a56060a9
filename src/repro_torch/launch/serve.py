"""Serving CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --smoke \
        --requests 8 --max-new 16 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b --layers 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --restore DIR
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b

Runs the batched serving engine (tokenize on host threads + decode on the
card, each model step one CUDA graph replay) with weights drawn at random
from a seeded ``torch.Generator``, or with ``--restore DIR`` the weights of
the latest checkpoint under DIR (``distributed/checkpoint.py``: the
reference's format, a ``{"params": ...}`` tree, so a checkpoint that
``repro`` wrote serves here).  ``--layers`` cuts the depth (dense prefix
included): DeepSeek-V2's 60 layers (~470 GB in bf16) do not fit one 80 GB
card, 4 (1 dense + 3 MoE, ~27 GB) do.  As in the reference, whisper
serves over a zero cross cache (no audio) and internvl2 text only; the
recurrent stacks (hymba-1.5b, xlstm-125m) keep the reference's slot
prefill, which steps every slot's state.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Request, ServingEngine


def main(argv: list[str] | None = None) -> tuple[list[Request], object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_NAMES, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--restore", default=None, help="checkpoint dir to load params from")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dev = resolve_device(args.device)
    if args.restore:
        target = {"params": T.to_jax_layout(T.TransformerLM(cfg, "meta"))}
        restored, step = ckpt.restore(args.restore, None, target)
        params = T.from_jax_params(restored["params"], cfg)
        print(f"restored params from step {step}")
    else:
        params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    engine = ServingEngine(params, cfg, batch_slots=args.slots, max_len=args.max_len, device=dev)
    reqs = [
        Request(uid=i, text=f"request {i}: the quick brown fox", max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    done, stats = engine.serve(reqs)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(
        f"completed {stats.completed} requests, {stats.tokens_generated} tokens "
        f"in {stats.wall_seconds:.2f}s ({stats.tokens_per_second:.1f} tok/s) on {name}"
    )
    return done, stats


if __name__ == "__main__":
    main()
