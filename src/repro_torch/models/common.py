"""Shared model pieces: norms, RoPE, embeddings, attention masks (a copy
of ``repro.models.common``; ``seq_shard`` has no meaning without a mesh and
is left out).

Where the reference mixes dtypes in a product (a bf16 activation against
an fp32 norm scale, the unembedding's cast), the promotion is written out:
``torch.matmul`` does not promote as ``jnp.matmul`` does."""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.sharding.policy import ParamDef


# ---------------------------------------------------------------------------
# norms (fp32 compute, param dtype fp32 for stability)
# ---------------------------------------------------------------------------

def schema_norm(d_model: int, kind: str = "rmsnorm") -> dict:
    s = {"scale": ParamDef((d_model,), (None,), init="ones", dtype="float32")}
    if kind == "layernorm":
        s["bias"] = ParamDef((d_model,), (None,), init="zeros", dtype="float32")
    return s


def norm_apply(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    scale = p["scale"].to(torch.float32)
    if kind == "rmsnorm":
        y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                              + eps)
        return (y * scale).to(dt)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + p["bias"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """The frequencies in numpy fp32, as the reference computes them, kept
    on ``device``: a copy from host memory per call would synchronise the
    stream twice per layer.  Callers only read the tensor."""
    half = hd // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0
                             / hd))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    frequencies in numpy fp32 and cos/sin in fp32, as the reference; the
    result is cast back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _rope_freqs(hd, float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def schema_embed(vocab: int, d_model: int) -> dict:
    return {
        "tok": ParamDef((vocab, d_model), ("vocab", "fsdp"), init="embed"),
        "out": ParamDef((d_model, vocab), ("fsdp", "vocab"), init="fan_in"),
    }


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["out"].to(x.dtype)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def causal_mask(S: int, window: int = 0, device="cpu") -> torch.Tensor:
    """(S, S) additive fp32 mask; ``window`` > 0 adds a sliding-window
    constraint."""
    i = torch.arange(S, dtype=torch.int32, device=device)[:, None]
    j = torch.arange(S, dtype=torch.int32, device=device)[None, :]
    ok = j <= i
    if window:
        ok &= (i - j) < window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)
