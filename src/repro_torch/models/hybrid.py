"""Hybrid and xLSTM stack assembly (a copy of ``repro.models.hybrid``).

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

xLSTM [arXiv:2405.04517]: G = n_layers / slstm_period groups of
``slstm_period - 1`` mLSTM blocks (leaves (G, period-1, ...)) closed by one
sLSTM block (leaves (G, ...)); Python loops take the place of the two
scans here too.  The decode cache keeps the reference's ``XLSTMCache``
layout, fp32, and is updated in place.

In both stacks, with ``cfg.remat`` each block is recomputed in the
backward (``common.remat``: ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint``), where autograd records.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, xlstm
from repro_torch.models.common import (embed, norm_apply, remat,
                                       schema_embed, schema_norm, unembed)
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
            x = remat(mamba2.mamba_block, lp, cfg, x)
        x, _ = remat(block_fwd, params["shared"], cfg, x, positions,
                     cfg.sliding_window)
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


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def _xlstm_groups(cfg: ModelConfig) -> int:
    if cfg.slstm_period <= 1 or cfg.n_layers % cfg.slstm_period:
        raise ValueError(f"{cfg.name}: slstm_period {cfg.slstm_period} "
                         f"does not divide {cfg.n_layers} layers into groups")
    return cfg.n_layers // cfg.slstm_period


def schema_xlstm(cfg: ModelConfig) -> dict:
    G = _xlstm_groups(cfg)
    group = {
        "mlstms": stack(xlstm.schema_mlstm(cfg), cfg.slstm_period - 1),
        "slstm": xlstm.schema_slstm(cfg),
    }
    return {
        "embed": schema_embed(cfg.vocab_size, cfg.d_model),
        "groups": stack(group, G),
        "ln_f": schema_norm(cfg.d_model, cfg.norm),
    }


def _xlstm_layers(params: dict, cfg: ModelConfig) -> list:
    """G pairs of (the group's ``period - 1`` mLSTM layer trees, its sLSTM
    layer tree), all views of the stacked leaves."""
    return [(_layers(gp["mlstms"], cfg.slstm_period - 1), gp["slstm"])
            for gp in _layers(params["groups"], _xlstm_groups(cfg))]


def xlstm_hidden(params: dict, cfg: ModelConfig, inputs: dict):
    """Token inputs -> (final hidden states (B, S, d), MoE aux 0.0)."""
    x = embed(params["embed"], inputs["tokens"]).to(DTYPES[cfg.dtype])
    for mls, sl in _xlstm_layers(params, cfg):
        for lp in mls:
            x = remat(xlstm.mlstm_block, lp, cfg, x)
        x = remat(xlstm.slstm_block, sl, cfg, x)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def xlstm_logits(params: dict, cfg: ModelConfig, inputs: dict):
    x, aux = xlstm_hidden(params, cfg, inputs)
    return unembed(params["embed"], x), aux


class XLSTMCache(NamedTuple):
    mC: torch.Tensor   # (G, period-1, B, H, P, P) fp32
    mn: torch.Tensor   # (G, period-1, B, H, P)
    sc: torch.Tensor   # (G, B, H, Pd)
    sn: torch.Tensor
    sh: torch.Tensor
    sm: torch.Tensor


def xlstm_init_cache(cfg: ModelConfig, batch: int,
                     device="cuda") -> XLSTMCache:
    """Each block's zeroed state (the sLSTM's ``m`` at -1e30), fp32."""
    G, per = _xlstm_groups(cfg), cfg.slstm_period - 1
    m = xlstm.mlstm_init_state(cfg, batch, device=device)
    s = xlstm.slstm_init_state(cfg, batch, device=device)
    tile = lambda t, pre: t.expand(pre + tuple(t.shape)).clone()
    return XLSTMCache(mC=tile(m.C, (G, per)), mn=tile(m.n, (G, per)),
                      sc=tile(s.c, (G,)), sn=tile(s.n, (G,)),
                      sh=tile(s.h, (G,)), sm=tile(s.m, (G,)))


def xlstm_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
                 cache: XLSTMCache, pos=None, window: int = 0):
    """token: (B,) int -> (logits (B, vocab), cache); recurrent, so
    ``pos`` and ``window`` are unused.  The cache is updated in place: the
    returned cache holds the same tensors as the one passed in."""
    del pos, window
    x = embed(params["embed"], token[:, None]).to(DTYPES[cfg.dtype])
    for g, (mls, sl) in enumerate(_xlstm_layers(params, cfg)):
        for j, lp in enumerate(mls):
            x, _ = xlstm.mlstm_decode(lp, cfg, x, xlstm.MLSTMState(
                cache.mC[g, j], cache.mn[g, j]))
        x, _ = xlstm.slstm_decode(sl, cfg, x, xlstm.SLSTMState(
            cache.sc[g], cache.sn[g], cache.sh[g], cache.sm[g]))
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return unembed(params["embed"], x)[:, 0], cache
