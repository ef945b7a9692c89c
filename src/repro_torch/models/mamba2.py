"""Mamba2 (SSD) blocks in the chunked form (a copy of
``repro.models.mamba2``).

The intra-chunk block of ``ssd_chunked`` (dense (Lc x Lc) decay-weighted
products and the chunk-final states) is ``kernels.ops.ssd_intra_chunk``
wherever no gradient is needed: the hand-written SSD kernel on the card,
and on the CPU its plain version, which is the reference's einsum form.
Under autograd (the training route, ``attention.needs_grad``) it is the
reference's einsums written in this module (``_intra_chunk_train``), on
the card as on the CPU: the SSD kernel is forward-only, and the JAX
package trains through these einsums and never through its Pallas SSD
kernel.  Both routes sum the log-decays ``cs`` in float64 and round once
(``kernels.ref.prefix_sum``).  The O(S / Lc) inter-chunk recurrence and
the ``y_inter`` product stay plain PyTorch, as the reference keeps them
outside its Pallas kernel.

Where the reference mixes dtypes, the promotion is written out
(``torch.matmul`` does not promote bf16 x fp32 as ``jnp`` does), and
``softplus`` is the reference's ``logaddexp(x, 0)`` form, not
``F.softplus``, which returns x itself above a threshold of 20.  The
decode state is updated in place (the reference returns a new one).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import expand_heads, prefix_sum
from repro_torch.models.attention import needs_grad
from repro_torch.models.common import (merge_last, norm_apply, schema_norm,
                                       split_last)
from repro_torch.sharding.policy import ParamDef


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, conv_width-1, conv_channels)
    ssm: torch.Tensor    # (B, H, N, P) fp32


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def schema_mamba_block(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    ch = conv_channels(cfg)
    return {
        "ln": schema_norm(d, cfg.norm),
        "in_proj": ParamDef((d, 2 * di + 2 * G * N + H), ("fsdp", "tp")),
        "conv_w": ParamDef((cfg.conv_width, ch), (None, "tp"), init="fan_in"),
        "conv_b": ParamDef((ch,), ("tp",), init="zeros"),
        "A_log": ParamDef((H,), (None,), init="mamba_A", dtype="float32"),
        "dt_bias": ParamDef((H,), (None,), init="dt_bias", dtype="float32"),
        "D": ParamDef((H,), (None,), init="ones", dtype="float32"),
        "ln_gate": schema_norm(di, cfg.norm),
        "out_proj": ParamDef((di, d), ("tp", "fsdp")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z, x, Bm, Cm, dt = torch.split(proj, [di, di, G * N, G * N, H], dim=-1)
    return z, x, Bm, Cm, dt


def _causal_conv(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds, in x's dtype. x: (B, S, ch)."""
    W = p["conv_w"].shape[0]
    w = p["conv_w"].to(x.dtype)
    out = x * w[-1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i, :]
        out = out + shifted * w[W - 1 - i]
    return F.silu(out + p["conv_b"].to(x.dtype))


def _intra_chunk_train(x, dt, A, Bm, Cm, cs, Lc: int, cdt):
    """The intra-chunk block and chunk-final states as the reference's
    ``ssd_chunked`` forms them (``repro/models/mamba2.py``: ``xdt`` to
    ``states``, with its ``_segsum``), differentiable: the training route.
    ``cs`` (B, Nc, Lc, H) are the float64-summed log-decays.  Returns
    ``y_intra`` (B, S, H, P) and ``states`` (B, Nc, H, N, P), fp32."""
    B_, S, H, P = x.shape
    Nc = S // Lc
    chunk = lambda t: t.reshape((B_, Nc, Lc) + tuple(t.shape[2:]))
    xdt = chunk(x * dt[..., None]).to(cdt)                 # (B,Nc,Lc,H,P)
    Bh = chunk(expand_heads(Bm, H)).to(cdt)                # (B,Nc,Lc,H,N)
    Ch = chunk(expand_heads(Cm, H)).to(cdt)
    # _segsum: lower-triangular segment sums cs[l] - cs[s], -inf above
    csh = cs.movedim(3, 2)                                 # (B,Nc,H,Lc)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(tri, csh[..., :, None] - csh[..., None, :], -torch.inf)
    Lmat = torch.exp(seg).to(cdt)                          # (B,Nc,H,Lc,Lc)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)
    y_intra = torch.einsum("bchls,bcshp->bclhp", scores * Lmat,
                           xdt).to(torch.float32)
    decay_end = torch.exp(cs[:, :, -1:, :] - cs).to(cdt)   # (B,Nc,Lc,H)
    states = torch.einsum("bcshn,bcsh,bcshp->bchnp", Bh, decay_end,
                          xdt).to(torch.float32)
    return y_intra.reshape(B_, S, H, P), states


def ssd_chunked(cfg: ModelConfig, x, dt, A, Bm, Cm, init_state=None):
    """Chunked selective-state-space scan.

    x: (B,S,H,P) fp32; dt: (B,S,H) fp32; A: (H,) fp32 (negative); Bm/Cm:
    (B,S,G,N).  Returns (y (B,S,H,P), final_state (B,H,N,P))."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Lc = min(cfg.ssm_chunk, S)
    if S % Lc:
        raise ValueError(f"ssd_chunked: chunk {Lc} does not divide "
                         f"sequence {S}")
    Nc = S // Lc
    cdt = torch.bfloat16 if cfg.ssd_bf16 else torch.float32
    cs = prefix_sum((dt * A).reshape(B_, Nc, Lc, H), 2)   # (B,Nc,Lc,H)
    if needs_grad(x, dt, A, Bm, Cm) or x.is_meta:
        # meta tensors (the dry run, launch/dryrun.py) have no kernel
        # either: they take the reference's einsums too
        y_intra, states = _intra_chunk_train(x, dt, A, Bm, Cm, cs, Lc, cdt)
    else:
        y_intra, states = kops.ssd_intra_chunk(x, dt, A, Bm, Cm, Lc,
                                               bf16=cfg.ssd_bf16)

    # inter-chunk recurrence (fp32)
    chunk_decay = torch.exp(cs[:, :, -1, :])              # (B,Nc,H)
    h = (torch.zeros((B_, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state)
    h_prev = []
    for c in range(Nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                   # (B,Nc,H,N,P)
    Ch = expand_heads(Cm, H).reshape(B_, Nc, Lc, H, N).to(cdt).to(
        torch.float32)
    y_inter = torch.einsum("bclhn,bchnp->bclhp", Ch, h_prev) * torch.exp(
        cs)[..., None]
    y = y_intra + y_inter.reshape(B_, S, H, P)
    return y, h


def mamba_block(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. x: (B,S,d)."""
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    h = norm_apply(p["ln"], x, cfg.norm)
    z, xin, Bm, Cm, dt = _split_proj(cfg, h @ p["in_proj"])
    conv_out = _causal_conv(p, torch.cat([xin, Bm, Cm], dim=-1))
    xin, Bm, Cm = torch.split(conv_out, [cfg.d_inner, G * N, G * N], dim=-1)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    f32 = torch.float32
    xh = split_last(xin.to(f32), (H, P))
    y, _ = ssd_chunked(cfg, xh, dt, A, split_last(Bm.to(f32), (G, N)),
                       split_last(Cm.to(f32), (G, N)))
    y = y + xh * p["D"][:, None]
    y = merge_last(y).to(x.dtype)
    y = y * F.silu(z)
    y = norm_apply(p["ln_gate"], y, cfg.norm)
    return x + y @ p["out_proj"]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               device="cuda") -> MambaState:
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    return MambaState(
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_channels(cfg)),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, H, N, P), dtype=torch.float32,
                        device=device),
    )


def mamba_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: MambaState):
    """x: (B, 1, d) -> (y (B,1,d), state).  ``state`` is updated in place:
    the returned state holds the same tensors."""
    B = x.shape[0]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    h = norm_apply(p["ln"], x, cfg.norm)
    z, xin, Bm, Cm, dt = _split_proj(cfg, h @ p["in_proj"])
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)[:, 0]            # (B, ch)
    w = p["conv_w"].to(x.dtype)
    hist = torch.cat([state.conv, conv_in[:, None]], dim=1)     # (B,W,ch)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, w)
                      + p["conv_b"].to(x.dtype))
    state.conv.copy_(hist[:, 1:])
    xin, Bm, Cm = torch.split(conv_out, [cfg.d_inner, G * N, G * N], dim=-1)
    dt = softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])    # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                                   # (B,H)
    f32 = torch.float32
    xh = split_last(xin.to(f32), (H, P))
    Bh = expand_heads(split_last(Bm.to(f32)[:, None], (G, N)), H)[:, 0]
    Ch = expand_heads(split_last(Cm.to(f32)[:, None], (G, N)), H)[:, 0]
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt, Bh, xh)
    ssm = state.ssm
    ssm.mul_(decay[:, :, None, None]).add_(upd)
    y = torch.einsum("bhn,bhnp->bhp", Ch, ssm) + xh * p["D"][:, None]
    y = y.reshape(B, 1, cfg.d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = norm_apply(p["ln_gate"], y, cfg.norm)
    return x + y @ p["out_proj"], state
