"""The paper's own model set 𝒟: ResNet-18/34/50 + tiny specialized NN."""

from repro_torch.models.resnet import RESNET18, RESNET34, RESNET50, TINY_RESNET

CONFIGS = {
    "resnet18": RESNET18,
    "resnet34": RESNET34,
    "resnet50": RESNET50,
    "tiny_resnet": TINY_RESNET,
}

# Paper Table 2's throughputs (im/s), measured by the paper's authors on an
# NVIDIA T4 — not this port's card.  Examples and benchmarks use them as
# calibrated exec throughputs for the cost model when no accelerator is
# measured; on a card, measure with ``SmolRuntime.measure_exec_throughput``.
T4_THROUGHPUT = {
    "resnet18": 12_592.0,
    "resnet34": 6_860.0,
    "resnet50": 4_513.0,
    "tiny_resnet": 250_000.0,  # paper §5.1: specialized NNs up to 250k im/s
}
