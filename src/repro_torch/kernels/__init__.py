"""Hand-written Hopper kernels for the split-decode path.

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
"""
