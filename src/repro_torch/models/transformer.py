"""The dense decoder stack (a copy of the dense half of
``repro.models.transformer``; the MoE, VLM and audio stacks come with
their families, ROADMAP Queue 1).

Params keep the reference's stacked ``(L, ...)`` leaves and ``(d_in,
d_out)`` weight layout, so a JAX parameter tree crosses with
``convert.to_torch``; a Python loop over the layers takes the place of
``lax.scan``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (causal_mask, embed, norm_apply, rope,
                                       schema_embed, schema_norm, unembed)
from repro_torch.sharding.policy import DTYPES, stack


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (experts: {cfg.n_experts}) "
            f"is not ported yet; the port has the dense decoder (ROADMAP.md, "
            f"Queue 1)")


def _layers(blocks: dict, n: int) -> list:
    """The stacked ``(L, ...)`` leaves as ``n`` per-layer trees of views."""
    if isinstance(blocks, dict):
        per_key = {k: _layers(v, n) for k, v in blocks.items()}
        return [{k: per_key[k][i] for k in blocks} for i in range(n)]
    return list(blocks.unbind(0))


# ---------------------------------------------------------------------------
# one decoder block (self-attn + mlp)
# ---------------------------------------------------------------------------

def schema_block(cfg: ModelConfig) -> dict:
    return {
        "ln1": schema_norm(cfg.d_model, cfg.norm),
        "attn": attn.schema_attention(cfg),
        "ln2": schema_norm(cfg.d_model, cfg.norm),
        "mlp": ffn_mod.schema_ffn(cfg),
    }


def block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window: int) -> torch.Tensor:
    h = norm_apply(p["ln1"], x, cfg.norm)
    x = x + attn.attention(p["attn"], cfg, h, positions=positions,
                           window=window)
    h = norm_apply(p["ln2"], x, cfg.norm)
    return x + ffn_mod.ffn(p["mlp"], cfg, h)


def block_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: attn.KVCache, pos: int, window: int):
    h = norm_apply(p["ln1"], x, cfg.norm)
    a, cache = attn.decode_attention(p["attn"], cfg, h, cache, pos, window)
    x = x + a
    h = norm_apply(p["ln2"], x, cfg.norm)
    return x + ffn_mod.ffn(p["mlp"], cfg, h), cache


# ---------------------------------------------------------------------------
# dense decoder stack
# ---------------------------------------------------------------------------

def schema_decoder(cfg: ModelConfig) -> dict:
    _dense_only(cfg)
    return {
        "embed": schema_embed(cfg.vocab_size, cfg.d_model),
        "blocks": stack(schema_block(cfg), cfg.n_layers),
        "ln_f": schema_norm(cfg.d_model, cfg.norm),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def decoder_hidden(params: dict, cfg: ModelConfig, inputs: dict):
    """Token inputs -> (final hidden states (B, S, d), MoE aux 0.0)."""
    _dense_only(cfg)
    tokens = inputs["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens).to(DTYPES[cfg.dtype])
    positions = _positions(B, S, x.device)
    for lp in _layers(params["blocks"], cfg.n_layers):
        x = block_fwd(lp, cfg, x, positions, cfg.sliding_window)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def decoder_logits(params: dict, cfg: ModelConfig, inputs: dict):
    x, aux = decoder_hidden(params, cfg, inputs)
    return unembed(params["embed"], x), aux


def block_fwd_cache(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, window: int):
    """block_fwd that also emits the roped K/V for cache prefill.  On the
    card (and on the CPU with ``cfg.use_flash_kernel``) the causal attention
    is one flash-attention call, the same function as the reference's
    ``_sdpa`` with ``causal_mask``."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    B, S, _ = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (h @ p["attn"]["wq"]).reshape(B, S, H, hd)
    k = (h @ p["attn"]["wk"]).reshape(B, S, K, hd)
    v = (h @ p["attn"]["wv"]).reshape(B, S, K, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if attn.use_kernels(cfg, x):
        o = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        o = attn._sdpa(q, attn._gqa_expand(k, H, K),
                       attn._gqa_expand(v, H, K),
                       causal_mask(S, window, device=x.device))
    x = x + o.reshape(B, S, H * hd) @ p["attn"]["wo"]
    h = norm_apply(p["ln2"], x, cfg.norm)
    return x + ffn_mod.ffn(p["mlp"], cfg, h), (k, v)


def decoder_prefill_with_cache(params: dict, cfg: ModelConfig,
                               tokens: torch.Tensor, n_slots: int):
    """Prompt forward that RETURNS the KV cache ready for decode.
    tokens: (B, S) with S <= n_slots.  Returns (last_logits (B, V),
    KVCache stacked over layers: k/v (L, B, n_slots, K, hd), slot_pos
    (L, n_slots)), a new cache of its own."""
    _dense_only(cfg)
    B, S = tokens.shape
    if S > n_slots:
        raise ValueError(f"prompt of {S} tokens exceeds {n_slots} slots")
    dtype = DTYPES[cfg.dtype]
    x = embed(params["embed"], tokens).to(dtype)
    dev = x.device
    positions = _positions(B, S, dev)
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    ks = torch.zeros((L, B, n_slots, K, hd), dtype=dtype, device=dev)
    vs = torch.zeros_like(ks)
    for i, lp in enumerate(_layers(params["blocks"], L)):
        x, (k, v) = block_fwd_cache(lp, cfg, x, positions,
                                    cfg.sliding_window)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    # only the last position's logits are returned: unembed that row alone
    # (the reference slices the full logits; the rows are the same)
    x = norm_apply(params["ln_f"], x[:, -1:], cfg.norm)
    logits = unembed(params["embed"], x)[:, 0]
    slot_pos = torch.full((L, n_slots), -1, dtype=torch.int32, device=dev)
    slot_pos[:, :S] = torch.arange(S, dtype=torch.int32, device=dev)
    return logits, attn.KVCache(ks, vs, slot_pos)


def decoder_init_cache(cfg: ModelConfig, batch: int, n_slots: int, dtype,
                       device="cuda") -> attn.KVCache:
    """``attn.init_cache`` stacked over the layers: k/v (L, B, W, K, hd),
    slot_pos (L, W)."""
    c = attn.init_cache(cfg, batch, n_slots, dtype, device=device)
    return attn.KVCache(*(t.unsqueeze(0).repeat((cfg.n_layers,)
                                                + (1,) * t.dim())
                          for t in c))


def decoder_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
                   cache: attn.KVCache, pos: int, window: int):
    """token: (B,) int -> (logits (B, vocab), cache), the cache updated in
    place (one new row per layer at ``pos``)."""
    _dense_only(cfg)
    x = embed(params["embed"], token[:, None]).to(DTYPES[cfg.dtype])
    pos = int(pos)
    L = cfg.n_layers
    for lp, k, v, sp in zip(_layers(params["blocks"], L), cache.k.unbind(0),
                            cache.v.unbind(0), cache.slot_pos.unbind(0)):
        x, _ = block_decode(lp, cfg, x, attn.KVCache(k, v, sp), pos, window)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return unembed(params["embed"], x)[:, 0], cache
