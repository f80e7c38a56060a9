"""Training CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --steps 10 \
        --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --smoke --steps 50 \
        --batch 8 --seq 128 --device cpu --checkpoint-dir DIR

The reference's CLI (``repro.launch.train``): the real training loop
(checkpoint/restart in the reference's format, preemption handling,
straggler accounting) over the seeded synthetic bigram stream, with f32
master weights and compute in the config dtype.  ``--device`` defaults to
the card and raises without one; ``--device cpu`` runs the kernels' plain
versions.  One process: host 0 of 1.
"""

from __future__ import annotations

import argparse
import logging

from repro_torch import configs
from repro_torch.data.pipeline import PrefetchIterator, ShardedBatchSource, synthetic_lm_batch_fn
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import PreemptionHandler
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, train


def main(argv: list[str] | None = None) -> tuple[dict, list[dict]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_NAMES, required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    dev = resolve_device(args.device)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr),
        warmup_steps=max(1, args.steps // 10),
        total_steps=args.steps,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    src = ShardedBatchSource(synthetic_lm_batch_fn(cfg.vocab_size, args.batch, args.seq), seed=0,
                             host_index=0, host_count=1)
    it = PrefetchIterator(src)
    ph = PreemptionHandler(install=True)
    try:
        state, history = train(cfg, tcfg, it, num_steps=args.steps, preemption=ph, device=dev)
    finally:
        it.close()
    print(f"final loss: {history[-1]['loss']:.4f} after {len(history)} steps")
    return state, history


if __name__ == "__main__":
    main()
