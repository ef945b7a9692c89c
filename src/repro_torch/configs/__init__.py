"""Model configs: ``get_config(arch_id)`` / ``get_smoke(arch_id)`` for the
families the port has (the dense decoders, the MoE decoders, the
encoder-only audio transformer, the zamba2 hybrid and the VLM), and the
tabular APC-VFL protocol's hyperparameters (``apcvfl_paper``).  The xLSTM
config raises ``NotImplementedError`` until its slice (ROADMAP.md, Queue 1
item 9)."""
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
# the configs ported so far: the dense decoders, the zamba2 hybrid, the MoE
# decoders, the audio encoder and the VLM; the xLSTM comes later
PORTED = ("internlm2-1.8b", "internlm2-20b", "yi-6b", "nemotron-4-15b",
          "zamba2-2.7b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
          "hubert-xlarge", "llama-3.2-vision-11b")


def _mod(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet (ROADMAP.md, Queue 1 item 9); the "
            f"port has {', '.join(PORTED)}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).smoke()
