"""SMOL on PyTorch and CUDA: the port of the ``repro`` package to one NVIDIA H100.

The layout mirrors ``repro`` module for module; host-side modules (codecs,
DAG optimizer, cost model, placement, planner, memory, workers) are copies
with their imports rewritten, and every device-side piece runs on torch
tensors.  Every Pallas kernel of the reference is a hand-written CUDA C++
kernel under ``csrc/``: ``kernels/idct`` and ``kernels/fused_preproc`` on
the split-decode path, ``kernels/flash_attention`` and
``kernels/decode_attention`` on the LM serving path (``models/transformer``,
``models/decode``, ``serving/engine``, ``launch/serve``).

Devices are explicit: entry points default to ``"cuda"`` and raise when no
card is visible; ``device="cpu"`` runs every kernel's plain PyTorch version.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
