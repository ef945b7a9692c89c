"""GQA self-attention and cross-attention with KV-cache decode (a copy of
``repro.models.attention``).

Decode uses a slot-position cache: ``k/v`` of shape (B, W, K, hd) plus an
int32 ``slot_pos`` (W,) recording the absolute position written in each
slot (-1 = empty).  Full-attention decode is the special case W = seq_len;
the sliding-window variant rolls slots with ``pos % W``.  RoPE is applied
at write time so slot order never matters.

Where the kernels sit.  On the card the attention runs through the kernels
wherever no gradient is needed: ``attention`` and the cache prefill
(``transformer.block_fwd_cache``) call ``ops.flash_attention`` and the
one-token decode (``decode_attention``) calls ``ops.decode_attention``,
whatever the config says.

The training route, the one named exception to "kernels on the card":
where autograd records through the attention (``torch.is_grad_enabled()``
and an input that requires grad, ``needs_grad``), every site takes the
reference's training route instead, ``_sdpa`` (``_sdpa_chunked`` under
``attn_chunk``), on the card as on the CPU.  The kernels are forward-only
(``ops._refuse_grad``), and the JAX package differentiates no Pallas
kernel on this path either: its ``use_flash_kernel`` defaults to False,
so it trains through ``_sdpa``, and its flash kernel has no VJP.

On the CPU and without a gradient ``cfg.use_flash_kernel`` keeps the
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

Cross-attention (the VLM's gated cross blocks: S text positions attend
to T image tokens, no mask, no RoPE) is the reference's ``_sdpa`` with a
zero bias.  On the card without a gradient it takes the kernels too:
``cross_attention`` is one non-causal flash launch with a key length of its
own (T = 1600 at llama-3.2-vision-11b), and ``decode_cross_attention`` one
decode-attention launch over the image K/V, read as a slot cache whose
every slot is valid (``_all_slots``: slot_pos 0..T-1 at pos T-1, no
window).  On the CPU and under autograd both are ``_sdpa``, whatever
``cfg.use_flash_kernel`` says, as the reference's cross-attention ignores
it.

The cache is updated in place (the reference returns a new one): the
returned ``KVCache`` holds the same tensors as the one passed in.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import expand_heads
from repro_torch.models.common import NEG_INF, causal_mask, rope, split_last
from repro_torch.sharding.policy import ParamDef


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, W, K, hd), or (L, B, W, K, hd) stacked
    v: torch.Tensor
    slot_pos: torch.Tensor   # (W,) int32, -1 = empty; (L, W) stacked


def schema_attention(cfg: ModelConfig) -> dict:
    """The q/k/v/o projections (a cross block's too: the same leaves, as in
    the reference)."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kv_tp = None if cfg.replicate_kv else "tp"
    return {
        "wq": ParamDef((d, H * hd), ("fsdp", "tp")),
        "wk": ParamDef((d, K * hd), ("fsdp", kv_tp)),
        "wv": ParamDef((d, K * hd), ("fsdp", kv_tp)),
        "wo": ParamDef((H * hd, d), ("tp", "fsdp")),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return split_last(x, (n, hd))


def _gqa_expand(kv: torch.Tensor, H: int, K: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head H//K times."""
    return expand_heads(kv, H)


def needs_grad(*ts: torch.Tensor) -> bool:
    """True where autograd records through one of ``ts``: the training
    route (module docstring)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def use_kernels(cfg: ModelConfig, x: torch.Tensor, *ts: torch.Tensor) -> bool:
    """The kernels' route: for CUDA tensors, and on the CPU (their plain
    versions) when ``cfg.use_flash_kernel`` is set, except where a
    gradient is needed through ``x`` or ``ts`` (the training route)."""
    return (x.is_cuda or cfg.use_flash_kernel) and not needs_grad(x, *ts)


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
    if (x.is_cuda or (cfg.use_flash_kernel and cfg.causal)) \
            and not needs_grad(q, k, v):
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
                     cache: KVCache, pos, window: int = 0):
    """One-token decode.  x: (B, 1, d); pos: the current position, a host
    int or a (1,) int32 tensor on x's device.  Writes the new K/V rows and
    ``slot_pos`` into ``cache`` in place and returns (out (B, 1, d),
    cache).  A tensor ``pos`` is never read on the host: RoPE broadcasts
    it, the slot is computed and written on the device and the kernel
    reads it, so a CUDA graph of the step replays at any position."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    W = cache.k.shape[1]
    on_device = torch.is_tensor(pos)
    q = _split_heads(x @ p["wq"], H, hd)
    k_new = _split_heads(x @ p["wk"], K, hd)
    v_new = _split_heads(x @ p["wv"], K, hd)
    posb = (pos.view(1, 1).expand(B, 1) if on_device else
            torch.full((B, 1), pos, dtype=torch.int32, device=x.device))
    q = rope(q, posb, cfg.rope_theta)
    k_new = rope(k_new, posb, cfg.rope_theta)

    # dynamic_update_slice clamps the start so the update fits
    if on_device:
        slot = torch.clamp(pos % W if window else pos, max=W - 1).long()
        cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
        cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
        cache.slot_pos.index_copy_(0, slot, pos)
    else:
        slot = min(pos % W if window else pos, W - 1)
        cache.k[:, slot] = k_new[:, 0]
        cache.v[:, slot] = v_new[:, 0]
        cache.slot_pos[slot] = pos
    k, v, slot_pos = cache

    if use_kernels(cfg, x, q, k, v):
        out = kops.decode_attention(q[:, 0], k, v, slot_pos, pos,
                                    window=window)[:, None]
    else:
        valid = (slot_pos >= 0) & (slot_pos <= pos)
        if window:
            valid &= slot_pos > pos - window
        bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)  # (W,)
        out = _sdpa(q, _gqa_expand(k, H, K), _gqa_expand(v, H, K), bias)
    return out.reshape(B, 1, H * hd) @ p["wo"], cache


# ---------------------------------------------------------------------------
# cross-attention (the VLM's image layers)
# ---------------------------------------------------------------------------

def cross_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    kv_feats: torch.Tensor) -> torch.Tensor:
    """x: (B,S,d) attends to kv_feats (B,T,d).  No mask, no rope.  On the
    card without a gradient one flash launch at (S, T); else ``_sdpa``
    with a zero bias (module docstring)."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _split_heads(x @ p["wq"], H, hd)
    k, v = cross_kv(p, cfg, kv_feats)
    if x.is_cuda and not needs_grad(q, k, v):
        out = kops.flash_attention(q, k, v, causal=False)
    else:
        out = _sdpa(q, _gqa_expand(k, H, K), _gqa_expand(v, H, K), 0.0)
    return out.reshape(B, S, H * hd) @ p["wo"]


class CrossKV(NamedTuple):
    k: torch.Tensor   # (B, T, K, hd), or (G, B, T, K, hd) stacked
    v: torch.Tensor


def cross_kv(p: dict, cfg: ModelConfig, kv_feats: torch.Tensor) -> CrossKV:
    K, hd = cfg.n_kv_heads, cfg.hd
    return CrossKV(_split_heads(kv_feats @ p["wk"], K, hd),
                   _split_heads(kv_feats @ p["wv"], K, hd))


@functools.cache
def _all_slots(T: int, device: torch.device) -> torch.Tensor:
    """slot_pos 0..T-1: read at pos T-1 without a window, every slot of
    the image K/V is valid, so the decode kernel masks nothing.  Made once
    per (T, device)."""
    return torch.arange(T, dtype=torch.int32, device=device)


def decode_cross_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                           ckv: CrossKV) -> torch.Tensor:
    """One-token cross-attention to the image K/V: x (B, 1, d) ->
    (B, 1, d).  On the card without a gradient one decode-attention launch
    over ``ckv`` as an all-valid slot cache; else ``_sdpa`` with a zero
    bias."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _split_heads(x @ p["wq"], H, hd)
    if x.is_cuda and not needs_grad(q, ckv.k, ckv.v):
        T = ckv.k.shape[1]
        out = kops.decode_attention(q[:, 0], ckv.k, ckv.v,
                                    _all_slots(T, ckv.k.device),
                                    T - 1)[:, None]
    else:
        out = _sdpa(q, _gqa_expand(ckv.k, H, K), _gqa_expand(ckv.v, H, K),
                    0.0)
    return out.reshape(B, 1, H * hd) @ p["wo"]
