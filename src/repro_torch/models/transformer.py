"""Transformer stacks: dense and MoE decoders, the bidirectional
encoder-only (audio) stack and the VLM's cross-attention groups
(llama-3.2-vision style), a copy of ``repro.models.transformer``.

Params keep the reference's stacked ``(L, ...)`` leaves and ``(d_in,
d_out)`` weight layout, so a JAX parameter tree crosses with
``convert.to_torch``; a Python loop over the layers takes the place of
``lax.scan``, and the MoE aux loss is summed over the layers in layer
order from an fp32 zero, as the scan's carry.  With ``cfg.remat`` each
block (self or cross) is recomputed in the backward (``common.remat``),
as the reference checkpoints it.

Audio (``cfg.family == "audio"``, hubert) takes pre-embedded frames
``inputs["frames"]`` (B, S, d_model) and has no token table and no decode.
Its attention is bidirectional: on the card the flash kernel with
``causal=False``; on the CPU ``_sdpa`` with a zero bias, as the
reference (whose flash path needs ``cfg.causal``).

The VLM (``cfg.family == "vlm"``) stacks its layers two deep: G =
n_layers / cross_attn_period groups, each of ``cross_attn_period - 1``
self blocks (leaves (G, g-1, ...)) and one gated cross block (leaves (G,
...)) whose ``tanh(gate)`` scales its cross-attention to the image
embeddings ``inputs["image_embeds"]`` (B, T, d).  Python loops over the
groups and their self blocks take the place of the two scans; the self
blocks are ``block_fwd`` / ``block_decode``, so their attention keeps its
flash and decode launches, and the cross blocks take theirs
(``attention.cross_attention``).  ``VLMCache`` keeps the reference's
layout and is updated in place, like the dense cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (causal_mask, embed, norm_apply, remat,
                                       rope, schema_embed, schema_norm,
                                       seq_shard, split_last, unembed)
from repro_torch.sharding.policy import DTYPES, ParamDef, stack
from repro_torch.spans import span


def require_decode(cfg: ModelConfig) -> None:
    """Refuse a family without a decode: the audio encoder (the
    reference's ``supports_decode``)."""
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: family 'audio' is encoder-only and "
                         f"has no decode (supports_decode is False)")


def _layers(blocks: dict, n: int) -> list:
    """The stacked ``(L, ...)`` leaves as ``n`` per-layer trees of views."""
    if isinstance(blocks, dict):
        per_key = {k: _layers(v, n) for k, v in blocks.items()}
        return [{k: per_key[k][i] for k in blocks} for i in range(n)]
    return list(blocks.unbind(0))


# ---------------------------------------------------------------------------
# one decoder block (self-attn + mlp/moe)
# ---------------------------------------------------------------------------

def schema_block(cfg: ModelConfig, moe: bool = False) -> dict:
    return {
        "ln1": schema_norm(cfg.d_model, cfg.norm),
        "attn": attn.schema_attention(cfg),
        "ln2": schema_norm(cfg.d_model, cfg.norm),
        "mlp": ffn_mod.schema_moe(cfg) if moe else ffn_mod.schema_ffn(cfg),
    }


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.n_experts > 0


def _mlp(p: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """The block's MLP without the MoE aux (decode and the cache prefill
    drop it, as the reference)."""
    if _is_moe(cfg):
        return ffn_mod.moe(p, cfg, h)[0]
    return ffn_mod.ffn(p, cfg, h)


def block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window: int):
    """-> (x, the MoE aux of this block: 0.0 for a dense MLP)."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    with span("block.attention"):
        x = x + attn.attention(p["attn"], cfg, h, positions=positions,
                               window=window)
    h = norm_apply(p["ln2"], x, cfg.norm)
    with span("block.mlp"):
        if _is_moe(cfg):
            y, aux = ffn_mod.moe(p["mlp"], cfg, h)
        else:
            y = ffn_mod.ffn(p["mlp"], cfg, h)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def block_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: attn.KVCache, pos, window: int):
    """One block's decode step; ``pos`` as ``attn.decode_attention``
    takes it (a host int, or a (1,) int32 tensor on x's device)."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    with span("block.attention"):
        a, cache = attn.decode_attention(p["attn"], cfg, h, cache, pos,
                                         window)
    x = x + a
    h = norm_apply(p["ln2"], x, cfg.norm)
    with span("block.mlp"):
        y = _mlp(p["mlp"], cfg, h)
    return x + y, cache


# ---------------------------------------------------------------------------
# dense / MoE decoder (and bidirectional encoder) stack
# ---------------------------------------------------------------------------

def schema_decoder(cfg: ModelConfig) -> dict:
    s = {
        "embed": schema_embed(cfg.vocab_size, cfg.d_model),
        "blocks": stack(schema_block(cfg, moe=_is_moe(cfg)), cfg.n_layers),
        "ln_f": schema_norm(cfg.d_model, cfg.norm),
    }
    if cfg.family == "audio":   # frames arrive pre-embedded; no token table
        s["embed"] = {"out": s["embed"]["out"]}
    return s


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def decoder_hidden(params: dict, cfg: ModelConfig, inputs: dict):
    """Token (or pre-embedded frame) inputs -> (final hidden states
    (B, S, d), the MoE aux summed over the layers: 0.0 without experts)."""
    if cfg.family == "audio":
        x = inputs["frames"].to(DTYPES[cfg.dtype])
        B, S = x.shape[0], x.shape[1]
    else:
        tokens = inputs["tokens"]
        B, S = tokens.shape
        x = embed(params["embed"], tokens).to(DTYPES[cfg.dtype])
    positions = _positions(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params["blocks"], cfg.n_layers):
        x = seq_shard(x, cfg)         # a no-op without a mesh
        x, a = remat(block_fwd, lp, cfg, x, positions, cfg.sliding_window)
        aux = aux + a
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return x, aux


def decoder_logits(params: dict, cfg: ModelConfig, inputs: dict):
    x, aux = decoder_hidden(params, cfg, inputs)
    return unembed(params["embed"], x), aux


def block_fwd_cache(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, window: int):
    """block_fwd that also emits the roped K/V for cache prefill.  On the
    card (and on the CPU with ``cfg.use_flash_kernel``) the causal attention
    is one flash-attention call, the same function as the reference's
    ``_sdpa`` with ``causal_mask``; under autograd it is ``_sdpa`` (the
    training route, ``attention.needs_grad``)."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    B, S, _ = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    with span("block.attention"):
        q = split_last(h @ p["attn"]["wq"], (H, hd))
        k = split_last(h @ p["attn"]["wk"], (K, hd))
        v = split_last(h @ p["attn"]["wv"], (K, hd))
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if attn.use_kernels(cfg, x, q, k, v):
            o = kops.flash_attention(q, k, v, causal=True, window=window)
        else:
            o = attn._sdpa(q, attn._gqa_expand(k, H, K),
                           attn._gqa_expand(v, H, K),
                           causal_mask(S, window, device=x.device))
        x = x + o.reshape(B, S, H * hd) @ p["attn"]["wo"]
    h = norm_apply(p["ln2"], x, cfg.norm)
    with span("block.mlp"):
        y = _mlp(p["mlp"], cfg, h)
    return x + y, (k, v)


def decoder_prefill_with_cache(params: dict, cfg: ModelConfig,
                               tokens: torch.Tensor, n_slots: int):
    """Prompt forward that RETURNS the KV cache ready for decode.
    tokens: (B, S) with S <= n_slots.  Returns (last_logits (B, V),
    KVCache stacked over layers: k/v (L, B, n_slots, K, hd), slot_pos
    (L, n_slots)), a new cache of its own."""
    require_decode(cfg)
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
                   cache: attn.KVCache, pos, window: int):
    """token: (B,) int -> (logits (B, vocab), cache), the cache updated in
    place (one new row per layer at ``pos``: a host int, or a (1,) int32
    tensor on the device, which the step then never reads on the host)."""
    require_decode(cfg)
    x = embed(params["embed"], token[:, None]).to(DTYPES[cfg.dtype])
    L = cfg.n_layers
    for lp, k, v, sp in zip(_layers(params["blocks"], L), cache.k.unbind(0),
                            cache.v.unbind(0), cache.slot_pos.unbind(0)):
        x, _ = block_decode(lp, cfg, x, attn.KVCache(k, v, sp), pos, window)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return unembed(params["embed"], x)[:, 0], cache


# ---------------------------------------------------------------------------
# VLM: groups of (cross_attn_period - 1) self blocks + 1 cross block
# ---------------------------------------------------------------------------

def schema_cross_block(cfg: ModelConfig) -> dict:
    return {
        "ln1": schema_norm(cfg.d_model, cfg.norm),
        "xattn": attn.schema_attention(cfg),
        "gate": ParamDef((1,), (None,), init="zeros", dtype="float32"),
        "ln2": schema_norm(cfg.d_model, cfg.norm),
        "mlp": ffn_mod.schema_ffn(cfg),
    }


def _cross_groups(cfg: ModelConfig) -> int:
    """G, the number of cross groups (the reference's assertion, raised)."""
    g = cfg.cross_attn_period
    if g <= 0 or cfg.n_layers % g:
        raise ValueError(f"{cfg.name}: vlm layers must tile into cross "
                         f"groups: {cfg.n_layers} layers, cross_attn_period "
                         f"{g}")
    return cfg.n_layers // g


def schema_vlm(cfg: ModelConfig) -> dict:
    G = _cross_groups(cfg)
    group = {
        "selfs": stack(schema_block(cfg), cfg.cross_attn_period - 1),
        "cross": schema_cross_block(cfg),
    }
    return {
        "embed": schema_embed(cfg.vocab_size, cfg.d_model),
        "groups": stack(group, G),
        "ln_f": schema_norm(cfg.d_model, cfg.norm),
    }


def _vlm_groups(params: dict, cfg: ModelConfig) -> list:
    """The groups' stacked leaves unstacked on both axes: G pairs of (the
    ``cross_attn_period - 1`` self blocks' trees of views, the cross
    block's tree of views)."""
    return [(_layers(gp["selfs"], cfg.cross_attn_period - 1), gp["cross"])
            for gp in _layers(params["groups"], _cross_groups(cfg))]


def _gated_cross(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 attend) -> torch.Tensor:
    """The cross block around ``attend(xattn params, h)``: the gated
    cross-attention, then the MLP; the gate is ``tanh`` in fp32 cast to
    x's dtype, as the reference."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    gate = torch.tanh(p["gate"]).to(x.dtype)
    x = x + gate * attend(p["xattn"], h)
    h = norm_apply(p["ln2"], x, cfg.norm)
    return x + ffn_mod.ffn(p["mlp"], cfg, h)


def _cross_block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     img: torch.Tensor) -> torch.Tensor:
    return _gated_cross(p, cfg, x, lambda pa, h: attn.cross_attention(
        pa, cfg, h, img))


def vlm_hidden(params: dict, cfg: ModelConfig, inputs: dict):
    """Tokens and image embeddings -> (final hidden states (B, S, d), aux
    0.0: the reference drops the self blocks' aux too)."""
    tokens, img = inputs["tokens"], inputs["image_embeds"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens).to(DTYPES[cfg.dtype])
    img = img.to(x.dtype)
    positions = _positions(B, S, x.device)
    for selfs, cross in _vlm_groups(params, cfg):
        for lp in selfs:
            x, _ = remat(block_fwd, lp, cfg, x, positions,
                         cfg.sliding_window)
        x = remat(_cross_block_fwd, cross, cfg, x, img)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def vlm_logits(params: dict, cfg: ModelConfig, inputs: dict):
    x, aux = vlm_hidden(params, cfg, inputs)
    return unembed(params["embed"], x), aux


class VLMCache(NamedTuple):
    k: torch.Tensor         # (G, g-1, B, W, K, hd)
    v: torch.Tensor
    slot_pos: torch.Tensor  # (G, g-1, W) int32, -1 = empty
    xk: torch.Tensor        # (G, B, T, K, hd)
    xv: torch.Tensor


def vlm_init_cache(params: dict, cfg: ModelConfig,
                   image_embeds: torch.Tensor, n_slots: int, dtype,
                   device="cuda") -> VLMCache:
    """Empty self-attention caches for every self block and each cross
    block's image K/V, projected once from ``image_embeds`` (B, T, d) cast
    to ``dtype`` on ``device``."""
    G, g = _cross_groups(cfg), cfg.cross_attn_period
    B = image_embeds.shape[0]
    c = attn.init_cache(cfg, B, n_slots, dtype, device=device)
    img = image_embeds.to(device=device, dtype=dtype)
    kvs = [attn.cross_kv(cross["xattn"], cfg, img)
           for _, cross in _vlm_groups(params, cfg)]
    tile = lambda t: t.expand((G, g - 1) + tuple(t.shape)).clone()
    return VLMCache(tile(c.k), tile(c.v), tile(c.slot_pos),
                    torch.stack([kv.k for kv in kvs]),
                    torch.stack([kv.v for kv in kvs]))


def vlm_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
               cache: VLMCache, pos: int, window: int):
    """token: (B,) int -> (logits (B, vocab), cache), the cache updated in
    place (one new K/V row per self block at ``pos``; the image K/V are
    read only)."""
    x = embed(params["embed"], token[:, None]).to(DTYPES[cfg.dtype])
    pos = int(pos)
    for gi, (selfs, cross) in enumerate(_vlm_groups(params, cfg)):
        for j, lp in enumerate(selfs):
            x, _ = block_decode(lp, cfg, x, attn.KVCache(
                cache.k[gi, j], cache.v[gi, j], cache.slot_pos[gi, j]), pos,
                window)
        ckv = attn.CrossKV(cache.xk[gi], cache.xv[gi])
        x = _gated_cross(cross, cfg, x, lambda pa, h: attn.
                         decode_cross_attention(pa, cfg, h, ckv))
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return unembed(params["embed"], x)[:, 0], cache
