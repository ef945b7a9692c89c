"""Plain PyTorch layers of the reference, in fp32, one sequence at a time.

Each function follows the published equation it names; where the program
departs from a published model, the reference computes the program's
function and the departure is listed in the configuration file
(``departures``).  Nothing here imports the program or JAX.

``precision`` is ``"fp32"`` (the reference) or ``"fp8"`` (the control:
both operands of every projection rounded to float8 e4m3 with a scale a
tensor, the product summed in fp32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0          # the largest finite float8 e4m3fn
BLOCK_ELEMENTS = 1 << 28  # the largest temporary a block of rows makes


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` with ``w`` (d_in, d_out) in fp32."""
    w = w.to(F32)
    if precision == "fp8":
        x, w = fp8(x), fp8(w)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (Zhang and Sennrich, 2019): x / rms(x) * scale."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale.to(F32)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding (Su et al., 2021) of x (S, H, hd) at positions
    0..S-1, in the rotate-half form: the pair (x_i, x_{i+hd/2}) turned by
    pos * theta^(-2i/hd); angles in float64."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) * 2.0 / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos = torch.cos(ang).to(F32)[:, None, :]
    sin = torch.sin(ang).to(F32)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of q (S, H, hd) over k, v (S, K, hd), query i
    seeing keys 0..i; q head h reads kv head h // (H / K) (grouped-query
    attention, Ainslie et al., 2023).  In blocks of query rows."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty_like(q)
    rows = max(1, min(S, BLOCK_ELEMENTS // max(1, H * S)))
    cols = torch.arange(S, device=q.device)
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        s = torch.einsum("qhd,khd->hqk", q[r0:r1], k[:r1]) / math.sqrt(hd)
        ahead = cols[None, :r1] > torch.arange(r0, r1,
                                               device=q.device)[:, None]
        s = s.masked_fill(ahead, -math.inf)
        out[r0:r1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                  v[:r1])
    return out


def mlp(p: dict, x: torch.Tensor, ffn_type: str,
        precision: str) -> torch.Tensor:
    """SwiGLU (Shazeer, 2020), in blocks of rows."""
    if ffn_type != "swiglu":
        raise ValueError(f"unknown ffn_type {ffn_type!r}")
    rows = max(1, BLOCK_ELEMENTS // (2 * p["w_gate"].shape[-1]))
    out = []
    for r0 in range(0, x.shape[0], rows):
        h = x[r0:r0 + rows]
        a = F.silu(linear(h, p["w_gate"], precision)) \
            * linear(h, p["w_up"], precision)
        out.append(linear(a, p["w_down"], precision))
    return torch.cat(out)


def decoder_block(p: dict, m, x: torch.Tensor,
                  precision: str) -> torch.Tensor:
    """A pre-norm decoder block: x + Attn(norm(x)), then + MLP(norm(x))."""
    S = x.shape[0]
    H, K, hd = m.n_heads, m.n_kv_heads, m.hd
    h = rmsnorm(x, p["ln1"]["scale"])
    a = p["attn"]
    q = rope(linear(h, a["wq"], precision).view(S, H, hd), m.rope_theta)
    k = rope(linear(h, a["wk"], precision).view(S, K, hd), m.rope_theta)
    v = linear(h, a["wv"], precision).view(S, K, hd)
    o = causal_attention(q, k, v).reshape(S, H * hd)
    x = x + linear(o, a["wo"], precision)
    return x + mlp(p["mlp"], rmsnorm(x, p["ln2"]["scale"]), m.ffn_type,
                   precision)
