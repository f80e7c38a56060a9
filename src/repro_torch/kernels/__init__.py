"""Hand-written Hopper kernels of the port.

Each kernel package ships:
  ops.py   — the wrapper: checks device/dtype/shape/contiguity, launches the
             CUDA kernel on a CUDA tensor (or raises), runs the plain
             version on a CPU tensor, and counts launches;
  plain.py — the plain PyTorch version of the same function.

The CUDA sources live in ``repro_torch/csrc`` and are built once per
source hash by :mod:`repro_torch.kernels._build` (``nvcc`` for ``sm_90a``,
loaded with ``ctypes``).

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
"""
