"""Model configs: ``get_config(arch_id)`` / ``get_smoke(arch_id)`` for
every arch of the reference's registry (the dense decoders, the MoE
decoders, the encoder-only audio transformer, the zamba2 hybrid, the VLM,
the xLSTM and the paper's scaled student encoder), and the tabular APC-VFL
protocol's hyperparameters (``apcvfl_paper.TABULAR``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig,  # noqa: F401
                                      ShapeConfig)

# the reference's registry (repro/configs/__init__.py), in its order
ARCH_IDS = [
    "internlm2-20b",
    "xlstm-350m",
    "zamba2-2.7b",
    "yi-6b",
    "nemotron-4-15b",
    "hubert-xlarge",
    "llama-3.2-vision-11b",
    "internlm2-1.8b",
    "qwen3-moe-30b-a3b",
    "kimi-k2-1t-a32b",
    "apcvfl-paper",
]


def _mod(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).smoke()
