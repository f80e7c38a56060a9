"""Architecture registry of the port: ``repro.configs``' ten, each copied
here — dense GQA, OLMoE's MoE, DeepSeek-V2's MLA + MoE, whisper's
encoder-decoder, internvl2's VLM backbone, xlstm-125m's mLSTM/sLSTM stack
and hymba-1.5b's hybrid attention + Mamba blocks."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_MODULES = {
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
}

ARCH_NAMES = list(ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    return importlib.import_module(ARCH_MODULES[name]).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return importlib.import_module(ARCH_MODULES[name]).SMOKE


# Cells skipped in the dry-run matrix, with reasons (the reference's).
SKIP_CELLS: dict[tuple[str, str], str] = {
    ("qwen3-32b", "long_500k"): "pure full attention: 500k decode is architecturally quadratic-history",
    ("internlm2-1.8b", "long_500k"): "pure full attention",
    ("internlm2-20b", "long_500k"): "pure full attention",
    ("internvl2-26b", "long_500k"): "pure full attention (VLM backbone)",
    ("deepseek-v2-236b", "long_500k"): "full attention (MLA compresses the cache but attends globally)",
    ("olmoe-1b-7b", "long_500k"): "pure full attention",
    ("whisper-large-v3", "long_500k"): "enc-dec: decoder ceiling is 448 tokens; 500k meaningless",
}


def cell_is_skipped(arch: str, shape: str) -> str | None:
    return SKIP_CELLS.get((arch, shape))
