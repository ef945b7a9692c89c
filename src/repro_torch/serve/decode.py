"""Serving steps (a copy of ``repro.serve.decode``): prefill (full
forward -> last-token logits) and one-token greedy decode against a
(possibly sliding-window) KV cache.  ``cache_pspecs`` comes with meshes
(ROADMAP Queue 1)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M


def prefill_step(params, cfg: ModelConfig, inputs: dict) -> torch.Tensor:
    lg, _ = M.logits(params, cfg, inputs)
    return lg[:, -1]


def make_decode_step(cfg: ModelConfig, window: int = 0):
    """``step(params, token, cache, pos) -> (next tokens (B,) int32,
    cache)``: greedy, ties to the first index as ``jnp.argmax``."""
    def step(params, token, cache, pos):
        logits, cache = M.decode(params, cfg, token, cache, pos, window)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return step


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Sliding-window slots for the given decode shape (0 = full cache)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        return cfg.long_context_window
    return cfg.sliding_window


def n_cache_slots(cfg: ModelConfig, shape: ShapeConfig) -> int:
    w = decode_window(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len
