"""Model dispatch: one entry point per family (a copy of
``repro.models.model``): the dense and MoE decoders, the encoder-only audio
stack, the zamba2 hybrid, the VLM and the xLSTM (``ssm``).  A family
outside these raises ``ValueError``.

Public surface:
  schema(cfg)                      -> ParamDef tree
  hidden(params, cfg, inputs)      -> (B,S,d) final hidden states, moe aux
  logits(params, cfg, inputs)      -> (B,S,V) logits, moe aux
  supports_decode(cfg)             -> False for the encoder-only audio stack
  init_cache(params, cfg, batch, n_slots, image_embeds=None) -> cache
  decode(params, cfg, token, cache, pos, window) -> (logits (B,V), cache)
  count_params_analytic / count_active_params
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, transformer
from repro_torch.sharding.policy import DTYPES, leaves, param_count


FAMILIES = ("dense", "moe", "audio", "hybrid", "vlm", "ssm")


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r}; "
                         f"known: {FAMILIES}")


def schema(cfg: ModelConfig):
    _check(cfg)
    if cfg.family == "vlm":
        return transformer.schema_vlm(cfg)
    if cfg.family == "hybrid":
        return hybrid.schema_zamba(cfg)
    if cfg.family == "ssm":
        return hybrid.schema_xlstm(cfg)
    return transformer.schema_decoder(cfg)   # dense | moe | audio


def hidden(params, cfg: ModelConfig, inputs: dict):
    _check(cfg)
    if cfg.family == "vlm":
        return transformer.vlm_hidden(params, cfg, inputs)
    if cfg.family == "hybrid":
        return hybrid.zamba_hidden(params, cfg, inputs)
    if cfg.family == "ssm":
        return hybrid.xlstm_hidden(params, cfg, inputs)
    return transformer.decoder_hidden(params, cfg, inputs)


def logits(params, cfg: ModelConfig, inputs: dict):
    _check(cfg)
    if cfg.family == "vlm":
        return transformer.vlm_logits(params, cfg, inputs)
    if cfg.family == "hybrid":
        return hybrid.zamba_logits(params, cfg, inputs)
    if cfg.family == "ssm":
        return hybrid.xlstm_logits(params, cfg, inputs)
    return transformer.decoder_logits(params, cfg, inputs)


def supports_decode(cfg: ModelConfig) -> bool:
    return cfg.family != "audio"


def init_cache(params, cfg: ModelConfig, batch: int, n_slots: int,
               image_embeds=None):
    """The decode cache in ``cfg.dtype`` (the xLSTM's recurrent states in
    fp32, with no slots), on the device of ``params``; the audio encoder
    has none (``supports_decode``).  The VLM's needs its ``image_embeds``
    (B, T, d), whose K/V it projects once; ``batch`` is then theirs."""
    _check(cfg)
    transformer.require_decode(cfg)
    device = leaves(params)[0].device
    dtype = DTYPES[cfg.dtype]
    if cfg.family == "vlm":
        if image_embeds is None:
            raise ValueError(f"{cfg.name}: the VLM's decode cache needs "
                             f"image_embeds")
        return transformer.vlm_init_cache(params, cfg, image_embeds, n_slots,
                                          dtype, device=device)
    if cfg.family == "hybrid":
        return hybrid.zamba_init_cache(cfg, batch, n_slots, dtype,
                                       device=device)
    if cfg.family == "ssm":   # recurrent states, fp32: no slots
        return hybrid.xlstm_init_cache(cfg, batch, device=device)
    return transformer.decoder_init_cache(cfg, batch, n_slots, dtype,
                                          device=device)


def decode(params, cfg: ModelConfig, token, cache, pos, window: int = 0):
    _check(cfg)
    if cfg.family == "vlm":
        return transformer.vlm_decode(params, cfg, token, cache, pos, window)
    if cfg.family == "hybrid":
        return hybrid.zamba_decode(params, cfg, token, cache, pos, window)
    if cfg.family == "ssm":
        return hybrid.xlstm_decode(params, cfg, token, cache, pos, window)
    return transformer.decoder_decode(params, cfg, token, cache, pos, window)


def count_params_analytic(cfg: ModelConfig) -> int:
    return param_count(schema(cfg))


def count_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top-k experts count)."""
    total = count_params_analytic(cfg)
    if cfg.n_experts == 0:
        return total
    bank = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * cfg.n_layers
    active = bank * cfg.experts_per_token // cfg.n_experts
    return total - bank + active
