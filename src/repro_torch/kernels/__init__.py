"""Hand-written Hopper kernels of the port.

Each kernel package ships:
  ops.py   — the wrapper: checks device/dtype/shape/contiguity, launches the
             CUDA kernel on a CUDA tensor (or raises), runs the plain
             version on a CPU tensor, and counts launches;
  plain.py — the plain PyTorch version of the same function.

The CUDA sources live in ``repro_torch/csrc`` and are built once per
source hash by :mod:`repro_torch.kernels._build` (``nvcc`` for ``sm_90a``,
loaded with ``ctypes``).  The LM kernels' ``ops.py`` also hold a cost
function of the kernel's shapes (FLOPs by dtype, SFU exps, bytes), over
the H100's peaks in :mod:`repro_torch.kernels.cost`.

* idct          — dequantize + (scaled) 8x8 IDCT of coefficient rows
* fused_preproc — bilinear gather resample + uint8 re-quantize + per-plane
                  affine (the folded ToFloat/Normalize)
* flash_attention  — online-softmax prefill attention: causal, sliding
                     window, GQA (the LM's prefill and forward)
* decode_attention — flash-decoding of one token per sequence against the
                     KV cache in its own layout (every decode step)
* blocks_to_rgb    — decoded blocks to RGB pixels (the split-decode tail)
* selective_scan   — Mamba's selective scan with its state in registers,
                     from the x_proj output to the gated rows (hymba's
                     prefill, and each decode step at S = 1)

Gradients: flash_attention and selective_scan are
``torch.autograd.Function``s whose backward is a kernel too
(``csrc/flash_attention_bwd.cu``, ``csrc/selective_scan_bwd.cu``).
decode_attention (decode only) has no backward: :func:`require_no_grad`
makes its wrapper raise rather than return an output cut from the graph.
"""

import torch


def require_no_grad(kernel: str, roadmap: str, *tensors) -> None:
    """Raise where launching ``kernel``, which has no backward, would cut a
    gradient: grad mode is on and an input that requires grad lies off the
    CPU (on CPU tensors the wrappers run their plain versions, which
    autograd differentiates).  Called before the wrappers' device branch."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t is not None and t.requires_grad and t.device.type != "cpu":
            raise NotImplementedError(
                f"{kernel} has no backward: an input requires grad on {t.device}, and its output "
                f"would carry no gradient ({roadmap}); run it under torch.no_grad()")

