"""Architecture registry of the port.

The names are ``repro.configs``' ten; only the configurations whose every
layer the port runs are copied here (dense GQA, OLMoE's MoE, DeepSeek-V2's
MLA + MoE, whisper's encoder-decoder and internvl2's VLM backbone).  The
others raise :class:`NotImplementedError` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_MODULES = {
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
}

# the reference's other architectures and what they still need
NOT_PORTED = {
    "xlstm-125m": "xLSTM blocks (models/ssm.py)",
    "hymba-1.5b": "hybrid attention + Mamba blocks (models/ssm.py)",
}

ARCH_NAMES = list(ARCH_MODULES) + list(NOT_PORTED)


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet ({NOT_PORTED[name]}): "
            "ROADMAP port queue item 25 (LLM side stack)"
        )
    return importlib.import_module(ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
