"""The work a kernel's function must do, from its shapes, and the card's
peaks that turn work into the least time it can take.

Each LM kernel's wrapper module has a cost function of its shapes
(``flash_attention_cost``, ``decode_attention_cost``,
``selective_scan_cost`` and their backwards): the FLOPs by dtype, the
exps on the SFUs, and the bytes the function must move — each input read
once, each output written once, whatever the kernel reads again.
``chip_smoke.py`` bounds each kernel's time with them, and a trace
(``launch/hlo_analysis.py``) adds each launch's cost to its counts.

The peaks are the NVIDIA H100 SXM data sheet's (dense, no sparsity, at the
700 W limit): HBM 3.35 TB/s, 67 TFLOP/s fp32 on the CUDA cores, 495 TF32
and 989 bf16 on the tensor cores; NVLink 4, 900 GB/s bidirectional, 450
GB/s a direction.  The SFUs' exp2 rate is 132 SMs x 16 a clock (CUDA C
programming guide, arithmetic instruction throughput, compute capability
9.0) x the 1.98 GHz boost clock.
"""

from __future__ import annotations

import dataclasses

PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense TF32 tensor cores
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores
PEAK_SFU_OPS = 132 * 16 * 1.98e9
# NVLink bytes a second, one direction (the data sheet's 900 GB/s counts both)
NVLINK_BYTES_S = 450e9
# FLOP/s by the dtype of a product's operands (f32 products with TF32 off,
# as the port runs them: the CUDA cores; "tf32" for a kernel's TF32 products)
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float16": PEAK_BF16_FLOPS, "float32": PEAK_FP32_FLOPS,
              "tf32": PEAK_TF32_FLOPS}
# steps per saved state that K6's forward writes and its backward reads, as
# counted: the function needs the states only as a checkpoint, so a kernel
# that saves them more often pays for the extra bytes itself
BOUND_STATE_STRIDE = 32


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> "bfloat16" (a dtype or its name)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """FLOPs by dtype name, SFU exps and bytes of one or more launches;
    ``+`` adds two, ``n * cost`` is n launches."""

    flops: dict = dataclasses.field(default_factory=dict)
    exps: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: KernelCost) -> KernelCost:
        flops = dict(self.flops)
        for k, v in other.flops.items():
            flops[k] = flops.get(k, 0.0) + v
        return KernelCost(flops, self.exps + other.exps, self.bytes + other.bytes)

    def __rmul__(self, n: float) -> KernelCost:
        return KernelCost({k: n * v for k, v in self.flops.items()}, n * self.exps, n * self.bytes)

    def op_seconds(self) -> dict:
        """Seconds on each pipe: each dtype's FLOPs at its peak, the exps
        at the SFUs'."""
        out = {k: v / PEAK_FLOPS[k] for k, v in self.flops.items()}
        if self.exps:
            out["sfu"] = self.exps / PEAK_SFU_OPS
        return out

    def compute_seconds(self) -> float:
        """The busiest pipe's seconds (the pipes run side by side)."""
        return max(self.op_seconds().values(), default=0.0)

    def bound_ms(self) -> tuple[float, str]:
        """(the least ms the card could take, "bytes" or "operations"):
        the larger of the bytes at the HBM's rate and the busiest pipe."""
        t_bytes, t_ops = self.bytes / PEAK_BYTES_S, self.compute_seconds()
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
