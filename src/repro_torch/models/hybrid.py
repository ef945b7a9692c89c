"""The zamba2 hybrid stack (a copy of the zamba2 half of
``repro.models.hybrid``; the xLSTM half comes with its family, ROADMAP
Queue 1).

zamba2 [arXiv:2411.15242]: a Mamba2 backbone with ONE shared attention+MLP
block applied after every ``attn_period`` mamba layers.  As in the
reference, the shared block consumes the hidden stream directly (no
concat-with-embedding projector, no per-application LoRA deltas).  The
mamba leaves are stacked ``(G, period, ...)`` with G = n_layers /
attn_period; Python loops over the two axes take the place of the
reference's nested ``lax.scan``.  The shared block is the dense decoder's
``block_fwd`` / ``block_decode``, so on the card its attention runs
through the flash-attention and decode-attention kernels and each mamba
layer's intra-chunk SSD through the SSD kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.common import (embed, norm_apply, schema_embed,
                                       schema_norm, unembed)
from repro_torch.models.transformer import (_layers, _positions, block_decode,
                                            block_fwd, schema_block)
from repro_torch.sharding.policy import DTYPES, stack


def _groups(cfg: ModelConfig) -> int:
    if cfg.attn_period <= 0 or cfg.n_layers % cfg.attn_period:
        raise ValueError(f"{cfg.name}: attn_period {cfg.attn_period} does "
                         f"not divide {cfg.n_layers} layers")
    return cfg.n_layers // cfg.attn_period


def schema_zamba(cfg: ModelConfig) -> dict:
    G = _groups(cfg)
    return {
        "embed": schema_embed(cfg.vocab_size, cfg.d_model),
        "mamba": stack(stack(mamba2.schema_mamba_block(cfg),
                             cfg.attn_period), G),
        "shared": schema_block(cfg),           # ONE block, applied G times
        "ln_f": schema_norm(cfg.d_model, cfg.norm),
    }


def _mamba_groups(params: dict, cfg: ModelConfig) -> list:
    """The ``(G, period, ...)`` mamba leaves as G lists of ``period``
    per-layer trees of views."""
    return [_layers(gp, cfg.attn_period)
            for gp in _layers(params["mamba"], _groups(cfg))]


def zamba_hidden(params: dict, cfg: ModelConfig, inputs: dict):
    """Token inputs -> (final hidden states (B, S, d), MoE aux 0.0)."""
    tokens = inputs["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens).to(DTYPES[cfg.dtype])
    positions = _positions(B, S, x.device)
    for group in _mamba_groups(params, cfg):
        for lp in group:
            x = mamba2.mamba_block(lp, cfg, x)
        x = block_fwd(params["shared"], cfg, x, positions, cfg.sliding_window)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def zamba_logits(params: dict, cfg: ModelConfig, inputs: dict):
    x, aux = zamba_hidden(params, cfg, inputs)
    return unembed(params["embed"], x), aux


class ZambaCache(NamedTuple):
    conv: torch.Tensor      # (G, period, B, W-1, ch)
    ssm: torch.Tensor       # (G, period, B, H, N, P) fp32
    k: torch.Tensor         # (G, B, W, K, hd)
    v: torch.Tensor
    slot_pos: torch.Tensor  # (G, W) int32, -1 = empty


def zamba_init_cache(cfg: ModelConfig, batch: int, n_slots: int, dtype,
                     device="cuda") -> ZambaCache:
    """Zeroed mamba states per layer and one slot KV cache per application
    of the shared block (slots all empty)."""
    G, per = _groups(cfg), cfg.attn_period
    ms = mamba2.init_state(cfg, batch, dtype, device=device)
    kv = attn.init_cache(cfg, batch, n_slots, dtype, device=device)
    tile = lambda t, pre: t.expand(pre + tuple(t.shape)).clone()
    return ZambaCache(conv=tile(ms.conv, (G, per)), ssm=tile(ms.ssm, (G, per)),
                      k=tile(kv.k, (G,)), v=tile(kv.v, (G,)),
                      slot_pos=tile(kv.slot_pos, (G,)))


def zamba_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
                 cache: ZambaCache, pos: int, window: int):
    """token: (B,) int -> (logits (B, vocab), cache).  ``pos`` is a host int.
    The cache is updated in place (each mamba layer's conv and ssm state,
    one new K/V row per shared-block application): the returned cache holds
    the same tensors as the one passed in."""
    x = embed(params["embed"], token[:, None]).to(DTYPES[cfg.dtype])
    pos = int(pos)
    for g, group in enumerate(_mamba_groups(params, cfg)):
        for j, lp in enumerate(group):
            x, _ = mamba2.mamba_decode(
                lp, cfg, x, mamba2.MambaState(cache.conv[g, j],
                                              cache.ssm[g, j]))
        x, _ = block_decode(params["shared"], cfg, x,
                            attn.KVCache(cache.k[g], cache.v[g],
                                         cache.slot_pos[g]), pos, window)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return unembed(params["embed"], x)[:, 0], cache
