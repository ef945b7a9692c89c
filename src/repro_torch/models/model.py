"""Model dispatch: one entry point per family (a copy of
``repro.models.model``).  The port has the dense decoder and the zamba2
hybrid; the other families raise ``NotImplementedError`` until their
slice (ROADMAP.md, Queue 1).

Public surface:
  schema(cfg)                      -> ParamDef tree
  hidden(params, cfg, inputs)      -> (B,S,d) final hidden states, moe aux
  logits(params, cfg, inputs)      -> (B,S,V) logits, moe aux
  init_cache(params, cfg, batch, n_slots) -> decode cache
  decode(params, cfg, token, cache, pos, window) -> (logits (B,V), cache)
  count_params_analytic
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, transformer
from repro_torch.sharding.policy import DTYPES, leaves, param_count


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            f"has the dense decoder and the zamba2 hybrid (ROADMAP.md, "
            f"Queue 1)")


def schema(cfg: ModelConfig):
    _check(cfg)
    if cfg.family == "hybrid":
        return hybrid.schema_zamba(cfg)
    return transformer.schema_decoder(cfg)


def hidden(params, cfg: ModelConfig, inputs: dict):
    _check(cfg)
    if cfg.family == "hybrid":
        return hybrid.zamba_hidden(params, cfg, inputs)
    return transformer.decoder_hidden(params, cfg, inputs)


def logits(params, cfg: ModelConfig, inputs: dict):
    _check(cfg)
    if cfg.family == "hybrid":
        return hybrid.zamba_logits(params, cfg, inputs)
    return transformer.decoder_logits(params, cfg, inputs)


def init_cache(params, cfg: ModelConfig, batch: int, n_slots: int):
    """The decode cache in ``cfg.dtype``, on the device of ``params``."""
    _check(cfg)
    device = leaves(params)[0].device
    dtype = DTYPES[cfg.dtype]
    if cfg.family == "hybrid":
        return hybrid.zamba_init_cache(cfg, batch, n_slots, dtype,
                                       device=device)
    return transformer.decoder_init_cache(cfg, batch, n_slots, dtype,
                                          device=device)


def decode(params, cfg: ModelConfig, token, cache, pos, window: int = 0):
    _check(cfg)
    if cfg.family == "hybrid":
        return hybrid.zamba_decode(params, cfg, token, cache, pos, window)
    return transformer.decoder_decode(params, cfg, token, cache, pos, window)


def count_params_analytic(cfg: ModelConfig) -> int:
    return param_count(schema(cfg))
