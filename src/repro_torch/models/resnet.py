"""ResNets — the paper's 𝒟 (specialized + target DNNs), as torch modules.

Standard configurations 18/34/50 (paper Table 2) plus the BlazeIt-style
"tiny ResNet" specialized NN, in inference mode (batch norm from running
statistics).  Layouts follow ``repro.models.resnet``: NCHW activations,
``(B, num_classes)`` logits; :func:`from_jax_params` converts the
reference's parameter pytree (HWIO convolutions) into a module.

Padding follows XLA's ``"SAME"``: ``total = max((ceil(in/s) - 1)*s + k - in,
0)`` split ``lo = total // 2``, ``hi = total - lo``.  With stride 2 on an
even input that is asymmetric (the 7x7 stem pads (2, 3) at 224, the
stride-2 3x3 convs and the 3x3/2 max pool (0, 1)), so each layer computes
its pad from its input size instead of using ``padding=k//2``, which would
shift the sampling grid.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    block: str  # "basic" | "bottleneck"
    stage_sizes: tuple[int, ...]
    num_classes: int = 1000
    width: int = 64


RESNET18 = ResNetConfig("resnet18", "basic", (2, 2, 2, 2))
RESNET34 = ResNetConfig("resnet34", "basic", (3, 4, 6, 3))
RESNET50 = ResNetConfig("resnet50", "bottleneck", (3, 4, 6, 3))
TINY_RESNET = ResNetConfig("tiny_resnet", "basic", (1, 1), width=16)  # BlazeIt-style


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """(lo, hi) padding of XLA's ``"SAME"`` for one spatial axis."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SameConv(nn.Conv2d):
    """Bias-free square conv with XLA ``"SAME"`` padding computed per input."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (top, bottom), (left, right) = (same_pads(n, k, s) for n in x.shape[2:])
        if top == bottom and left == right:  # symmetric: let the conv pad
            return F.conv2d(x, self.weight, None, s, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, None, s)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``reduce_window(max, -inf, SAME)``: pad with -inf, then pool."""
    (top, bottom), (left, right) = (same_pads(n, k, s) for n in x.shape[2:])
    return F.max_pool2d(F.pad(x, (left, right, top, bottom), value=-math.inf), k, s)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1, self.bn1 = SameConv(cin, cout, 3, stride), _bn(cout)
        self.conv2, self.bn2 = SameConv(cout, cout, 3), _bn(cout)
        self.proj = self.proj_bn = None
        if stride != 1 or cin != cout:
            self.proj, self.proj_bn = SameConv(cin, cout, 1, stride), _bn(cout)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        sc = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(y + sc)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cmid: int, stride: int):
        super().__init__()
        cout = cmid * 4
        self.conv1, self.bn1 = SameConv(cin, cmid, 1), _bn(cmid)
        self.conv2, self.bn2 = SameConv(cmid, cmid, 3, stride), _bn(cmid)
        self.conv3, self.bn3 = SameConv(cmid, cout, 1), _bn(cout)
        self.proj = self.proj_bn = None
        if stride != 1 or cin != cout:
            self.proj, self.proj_bn = SameConv(cin, cout, 1, stride), _bn(cout)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(y + sc)


class ResNet(nn.Module):
    """x: (B, 3, H, W) float -> logits (B, num_classes).  Built in eval mode.

    Weights are drawn like ``repro.models.resnet.init_resnet`` (He-normal
    convolutions, ``cin**-0.5`` head, identity batch norm) from
    ``generator``; the numbers differ from the JAX ones for the same seed —
    load those with :func:`from_jax_params`.
    """

    def __init__(
        self,
        cfg: ResNetConfig,
        num_classes: int | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.cfg = cfg
        num_classes = num_classes or cfg.num_classes
        self.stem, self.stem_bn = SameConv(3, cfg.width, 7, 2), _bn(cfg.width)
        stages = []
        cin = cfg.width
        for si, n_blocks in enumerate(cfg.stage_sizes):
            cmid = cfg.width * (2**si)
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                if cfg.block == "basic":
                    blocks.append(BasicBlock(cin, cmid, stride))
                    cin = cmid
                else:
                    blocks.append(Bottleneck(cin, cmid, stride))
                    cin = cmid * 4
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.Sequential(*stages)
        self.head = nn.Linear(cin, num_classes, bias=False)
        self._init_weights(generator)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, generator: torch.Generator | None) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(generator=generator).mul_((2.0 / fan_in) ** 0.5)
        self.head.weight.normal_(generator=generator).mul_(self.head.in_features**-0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.stem_bn(self.stem(x)))
        y = max_pool_same(y)
        y = self.stages(y)
        return self.head(y.mean(dim=(2, 3)))


def _load_bn(bn: nn.BatchNorm2d, p: dict) -> None:
    bn.weight.copy_(torch.from_numpy(np.asarray(p["scale"], np.float32)))
    bn.bias.copy_(torch.from_numpy(np.asarray(p["bias"], np.float32)))
    bn.running_mean.copy_(torch.from_numpy(np.asarray(p["mean"], np.float32)))
    bn.running_var.copy_(torch.from_numpy(np.asarray(p["var"], np.float32)))


def _load_conv(conv: nn.Conv2d, w) -> None:
    oihw = np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))  # from HWIO
    conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(oihw)))


@torch.no_grad()
def from_jax_params(params: dict, cfg: ResNetConfig) -> ResNet:
    """A :class:`ResNet` holding the reference's parameters.

    ``params`` is ``repro.models.resnet.init_resnet``'s pytree with numpy
    (or array-like) leaves: convolutions HWIO, the head ``(cin, classes)``.
    """
    num_classes = np.asarray(params["head"]).shape[1]
    model = ResNet(cfg, num_classes=num_classes)
    _load_conv(model.stem, params["stem"])
    _load_bn(model.stem_bn, params["stem_bn"])
    for stage, stage_p in zip(model.stages, params["stages"]):
        for block, bp in zip(stage, stage_p):
            convs = ("conv1", "conv2") if cfg.block == "basic" else ("conv1", "conv2", "conv3")
            for name in convs:
                _load_conv(getattr(block, name), bp[name])
                _load_bn(getattr(block, "bn" + name[-1]), bp["bn" + name[-1]])
            if "proj" in bp:
                _load_conv(block.proj, bp["proj"])
                _load_bn(block.proj_bn, bp["proj_bn"])
    model.head.weight.copy_(torch.from_numpy(np.ascontiguousarray(np.asarray(params["head"], np.float32).T)))
    return model


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
