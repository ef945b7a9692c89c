"""GQA self-attention with KV-cache decode (a copy of
``repro.models.attention``; cross-attention comes with the VLM family).

Decode uses a slot-position cache: ``k/v`` of shape (B, W, K, hd) plus an
int32 ``slot_pos`` (W,) recording the absolute position written in each
slot (-1 = empty).  Full-attention decode is the special case W = seq_len;
the sliding-window variant rolls slots with ``pos % W``.  RoPE is applied
at write time so slot order never matters.

Where the kernels sit.  On the card the attention always runs through the
kernels: ``attention`` and the cache prefill
(``transformer.block_fwd_cache``) call ``ops.flash_attention`` and the
one-token decode (``decode_attention``) calls ``ops.decode_attention``,
whatever the config says.  On the CPU ``cfg.use_flash_kernel`` keeps the
reference's meaning in ``attention`` (set: the kernels' plain versions in
``kernels/ref.py``; unset: ``_sdpa``, ``_sdpa_chunked`` under
``attn_chunk``, bf16 scores under ``softmax_bf16``), and the port routes the
cache prefill and the decode through the same two choices.  Both routes
compute the same function: the reference's own tests hold
``decode_attention`` to the model's decode softmax
(``tests/test_kernels.py``,
``test_decode_attention_matches_model_decode_path``) and the flash kernel
to ``flash_attention_ref``, the causal ``_sdpa``.  ``attn_chunk`` and
``softmax_bf16`` are memory and precision options of the plain route; the
kernels hold no (S, S) scores and keep the softmax in fp32.

The cache is updated in place (the reference returns a new one): the
returned ``KVCache`` holds the same tensors as the one passed in.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import expand_heads
from repro_torch.models.common import NEG_INF, causal_mask, rope
from repro_torch.sharding.policy import ParamDef


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, W, K, hd), or (L, B, W, K, hd) stacked
    v: torch.Tensor
    slot_pos: torch.Tensor   # (W,) int32, -1 = empty; (L, W) stacked


def schema_attention(cfg: ModelConfig) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kv_tp = None if cfg.replicate_kv else "tp"
    return {
        "wq": ParamDef((d, H * hd), ("fsdp", "tp")),
        "wk": ParamDef((d, K * hd), ("fsdp", kv_tp)),
        "wv": ParamDef((d, K * hd), ("fsdp", kv_tp)),
        "wo": ParamDef((H * hd, d), ("tp", "fsdp")),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _gqa_expand(kv: torch.Tensor, H: int, K: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head H//K times."""
    return expand_heads(kv, H)


def use_kernels(cfg: ModelConfig, x: torch.Tensor) -> bool:
    """The kernels' route: always for CUDA tensors, and on the CPU (their
    plain versions) when ``cfg.use_flash_kernel`` is set."""
    return x.is_cuda or cfg.use_flash_kernel


def _sdpa(q, k, v, bias, softmax_bf16: bool = False) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,H,hd), bias broadcastable to (B,H,S,T)."""
    hd = q.shape[-1]
    if softmax_bf16:
        scale = torch.full((), 1.0 / math.sqrt(hd), dtype=q.dtype,
                           device=q.device)
        scores = torch.einsum("bshd,bthd->bhst", q * scale, k)
        scores = scores + (bias.to(scores.dtype) if torch.is_tensor(bias)
                           else bias)
        m = torch.amax(scores.to(torch.float32), dim=-1, keepdim=True)
        p = torch.exp(scores - m.to(scores.dtype))
        probs = p / torch.sum(p, dim=-1, keepdim=True).to(p.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, v)
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _sdpa_chunked(q, k, v, *, causal: bool, window: int,
                  chunk: int) -> torch.Tensor:
    """Online-softmax attention over kv chunks (the flash recurrence in
    plain tensor ops; no (S, S) score tensor).  q/k/v: (B, S, H, hd)."""
    B, S, H, hd = q.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    f32 = torch.float32
    qf = q.to(f32) / math.sqrt(hd)
    kc = k.to(f32).reshape(B, S // chunk, chunk, H, hd)
    vc = v.to(f32).reshape(B, S // chunk, chunk, H, hd)
    rows = torch.arange(S, dtype=torch.int32, device=q.device)
    m = torch.full((B, H, S), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, S), dtype=f32, device=q.device)
    acc = torch.zeros((B, S, H, hd), dtype=f32, device=q.device)
    for j in range(S // chunk):
        s = torch.einsum("bshd,bthd->bhst", qf, kc[:, j])
        cols = j * chunk + torch.arange(chunk, dtype=torch.int32,
                                        device=q.device)
        ok = torch.ones((S, chunk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= cols[None, :] <= rows[:, None]
        if window:
            ok &= (rows[:, None] - cols[None, :]) < window
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bhst,bthd->bshd", p, vc[:, j])
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l.transpose(1, 2), min=1e-30)[..., None]
    return out.to(q.dtype)


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Full-sequence (train / prefill) causal self-attention."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _split_heads(x @ p["wq"], H, hd)
    k = _split_heads(x @ p["wk"], K, hd)
    v = _split_heads(x @ p["wv"], K, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if x.is_cuda or (cfg.use_flash_kernel and cfg.causal):
        out = kops.flash_attention(q, k, v, causal=cfg.causal,
                                   window=window if cfg.causal else 0)
    elif cfg.attn_chunk and S > cfg.attn_chunk:
        out = _sdpa_chunked(q, _gqa_expand(k, H, K), _gqa_expand(v, H, K),
                            causal=cfg.causal, window=window,
                            chunk=cfg.attn_chunk)
    else:
        bias = (causal_mask(S, window, device=x.device) if cfg.causal
                else torch.zeros((S, S), dtype=torch.float32,
                                 device=x.device))
        out = _sdpa(q, _gqa_expand(k, H, K), _gqa_expand(v, H, K), bias,
                    softmax_bf16=cfg.softmax_bf16)
    return out.reshape(B, S, H * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, n_slots: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    K, hd = cfg.n_kv_heads, cfg.hd
    return KVCache(
        k=torch.zeros((batch, n_slots, K, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, n_slots, K, hd), dtype=dtype, device=device),
        slot_pos=torch.full((n_slots,), -1, dtype=torch.int32,
                            device=device),
    )


def decode_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: KVCache, pos: int, window: int = 0):
    """One-token decode.  x: (B, 1, d); pos: the current position, an int.
    Writes the new K/V rows and ``slot_pos`` into ``cache`` in place and
    returns (out (B, 1, d), cache)."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    W = cache.k.shape[1]
    pos = int(pos)
    q = _split_heads(x @ p["wq"], H, hd)
    k_new = _split_heads(x @ p["wk"], K, hd)
    v_new = _split_heads(x @ p["wv"], K, hd)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posb, cfg.rope_theta)
    k_new = rope(k_new, posb, cfg.rope_theta)

    # dynamic_update_slice clamps the start so the update fits
    slot = min(pos % W if window else pos, W - 1)
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    cache.slot_pos[slot] = pos
    k, v, slot_pos = cache

    if use_kernels(cfg, x):
        out = kops.decode_attention(q[:, 0], k, v, slot_pos, pos,
                                    window=window)[:, None]
    else:
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        if window:
            valid &= slot_pos > pos - window
        bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)  # (W,)
        out = _sdpa(q, _gqa_expand(k, H, K), _gqa_expand(v, H, K), bias)
    return out.reshape(B, 1, H * hd) @ p["wo"], cache
