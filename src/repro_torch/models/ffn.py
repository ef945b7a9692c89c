"""Feed-forward blocks: dense swiglu / squared-relu / gelu (a copy of the
dense half of ``repro.models.ffn``; the MoE comes with the MoE family,
ROADMAP Queue 1).

``jax.nn.gelu`` is the tanh approximation by default, so the port calls
``gelu(approximate="tanh")``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.policy import ParamDef


def schema_ffn(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn_type == "swiglu":
        return {
            "w_gate": ParamDef((d, f), ("fsdp", "tp")),
            "w_up": ParamDef((d, f), ("fsdp", "tp")),
            "w_down": ParamDef((f, d), ("tp", "fsdp")),
        }
    return {  # squared_relu | gelu: plain 2-matrix MLP
        "w_in": ParamDef((d, f), ("fsdp", "tp")),
        "w_out": ParamDef((f, d), ("tp", "fsdp")),
    }


def ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    h = x @ p["w_in"]
    if cfg.ffn_type == "squared_relu":        # nemotron-4 [arXiv:2402.16819]
        h = torch.square(torch.relu(h))
    elif cfg.ffn_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown ffn_type {cfg.ffn_type!r}")
    return h @ p["w_out"]
