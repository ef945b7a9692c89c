"""xLSTM blocks: the chunked-parallel mLSTM and the sequential sLSTM
[arXiv:2405.04517], a copy of ``repro.models.xlstm``.

The mLSTM's matrix memory ``C_t = f_t C_{t-1} + i_t v_t k_t^T`` takes the
chunked decay-matmul form of the SSD: dense (Lc x Lc) decay-weighted
products inside a chunk and an O(S / Lc) recurrence over the chunk-final
states.  The sLSTM has state-to-gate feedback (the recurrent ``r``
weights) and is sequential: a Python loop over time takes the place of the
reference's ``lax.scan``, one step a token.  As in the reference, the
max-stabiliser of the mLSTM is replaced by the bounded normaliser
``max(|q . n|, 1)``.  No TPU kernel computes either block: both are plain
PyTorch, on the card as on the CPU.

Where this differs from the reference, it does so on purpose:

* the log-decay prefix sums ``cs`` accumulate in float64 and round once
  (``kernels.ref.prefix_sum``, as the SSD's): the reference's fp32
  ``jnp.cumsum`` is up to 1 ulp of ``|cs|`` off that;
* the intra-chunk decays are masked to the lower triangle BEFORE ``exp``.
  The forward's bits are the reference's (``where(tril, exp(.), 0)``), but
  above the diagonal ``diff`` is a sum of ``-log f`` terms, and once it
  passes ~88.7 the reference's ``exp`` gives ``inf``, whose gradient through
  the ``where`` is ``inf * 0 = NaN``; the port's gradient stays finite.

Dtypes follow the reference: q, k, v and the gates are fp32 while the
stream is ``cfg.dtype``, each cast written out (``torch.matmul`` does not
promote).  ``k / sqrt(P)`` divides by a tensor on k's device (PyTorch's
CUDA division by a host scalar multiplies by its reciprocal).
``log_sigmoid`` is ``-softplus(-x)`` with the reference's
``logaddexp(x, 0)`` softplus, and ``silu`` is ``z * sigmoid(z)``.  The
decode states are updated in place (the reference returns new ones).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import prefix_sum
from repro_torch.models.common import (merge_last, norm_apply, schema_norm,
                                       split_last)
from repro_torch.models.mamba2 import softplus
from repro_torch.sharding.policy import ParamDef

F32 = torch.float32


class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B, H, P, P) fp32 matrix memory
    n: torch.Tensor   # (B, H, P) fp32 normaliser


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, P) fp32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor   # log-stabiliser


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def silu(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``z * sigmoid(z)``."""
    return z * torch.sigmoid(z)


@functools.lru_cache(maxsize=64)
def _const(value: float, device: torch.device) -> torch.Tensor:
    """An fp32 scalar kept on ``device`` (a host scalar would be a
    reciprocal on the card, and a copy per call a sync).  Callers only
    read the tensor."""
    return torch.full((), value, dtype=F32, device=device)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig):
    di = cfg.d_inner
    H = cfg.n_heads
    return di, H, di // H


def schema_mlstm(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, H, P = _mlstm_dims(cfg)
    return {
        "ln": schema_norm(d, cfg.norm),
        "w_up": ParamDef((d, 2 * di), ("fsdp", "tp")),
        "wq": ParamDef((di, di), (None, "tp")),
        "wk": ParamDef((di, di), (None, "tp")),
        "wv": ParamDef((di, di), (None, "tp")),
        "w_if": ParamDef((di, 2 * H), (None, None), init="small",
                         dtype="float32"),
        "b_i": ParamDef((H,), (None,), init="zeros", dtype="float32"),
        "b_f": ParamDef((H,), (None,), init="ones", dtype="float32"),
        "ln_out": schema_norm(di, cfg.norm),
        "w_down": ParamDef((di, d), ("tp", "fsdp")),
    }


def _heads(x: torch.Tensor, H: int, P: int) -> torch.Tensor:
    return split_last(x, (H, P))


def _qkv_gates(p: dict, xin: torch.Tensor, H: int, P: int):
    """fp32 q, k / sqrt(P), v (..., H, P) and the pre-activation input
    gate ``logi`` and forget gate ``fg + b_f`` (..., H)."""
    q = _heads(xin @ p["wq"], H, P).to(F32)
    k = _heads(xin @ p["wk"], H, P).to(F32) / _const(math.sqrt(P),
                                                      xin.device)
    v = _heads(xin @ p["wv"], H, P).to(F32)
    gates = xin.to(F32) @ p["w_if"]
    ig, fg = torch.split(gates, H, dim=-1)
    return q, k, v, ig + p["b_i"], fg + p["b_f"]


def mlstm_block(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Chunked-parallel full-sequence mLSTM. x: (B, S, d)."""
    B, S, _ = x.shape
    di, H, P = _mlstm_dims(cfg)
    h = norm_apply(p["ln"], x, cfg.norm)
    xin, z = torch.split(h @ p["w_up"], di, dim=-1)
    q, k, v, logi, fpre = _qkv_gates(p, xin, H, P)
    logf = log_sigmoid(fpre)                                     # (B,S,H)

    Lc = min(cfg.ssm_chunk, S)
    if S % Lc:
        raise ValueError(f"mlstm: chunk {Lc} does not divide sequence {S}")
    Nc = S // Lc
    ch = lambda t: t.reshape((B, Nc, Lc) + tuple(t.shape[2:]))
    qc, kc, vc = ch(q), ch(k), ch(v)
    li = ch(logi)                                                # (B,Nc,Lc,H)
    cs = prefix_sum(ch(logf), 2)

    # intra-chunk: D[l, s] = exp(cs_l - cs_s + logi_s) for l >= s, masked
    # before the exp (module docstring)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]           # (B,Nc,L,S,H)
    tril = torch.ones((Lc, Lc), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    Dmat = torch.exp(torch.where(tril, diff + li[:, :, None, :, :],
                                 -torch.inf))
    scores = torch.einsum("bclhp,bcshp->bclsh", qc, kc) * Dmat
    y_intra = torch.einsum("bclsh,bcshp->bclhp", scores, vc)

    # chunk-final (C, n) contributions
    decay_end = torch.exp(cs[:, :, -1:, :] - cs + li)            # (B,Nc,Lc,H)
    Cstate = torch.einsum("bcshp,bcshq->bchpq", decay_end[..., None] * kc,
                          vc)
    nstate = torch.einsum("bcsh,bcshp->bchp", decay_end, kc)
    chunk_decay = torch.exp(cs[:, :, -1, :])                     # (B,Nc,H)

    C = torch.zeros((B, H, P, P), dtype=F32, device=x.device)
    n = torch.zeros((B, H, P), dtype=F32, device=x.device)
    C_prev, n_prev = [], []
    for c in range(Nc):
        C_prev.append(C)
        n_prev.append(n)
        C = C * chunk_decay[:, c, :, None, None] + Cstate[:, c]
        n = n * chunk_decay[:, c, :, None] + nstate[:, c]
    C_prev = torch.stack(C_prev, dim=1)                          # (B,Nc,H,P,P)
    n_prev = torch.stack(n_prev, dim=1)                          # (B,Nc,H,P)

    qdec = qc * torch.exp(cs)[..., None]
    y_inter = torch.einsum("bclhp,bchpq->bclhq", qdec, C_prev)
    n_inter = torch.einsum("bclhp,bchp->bclh", qdec, n_prev)

    n_tot = scores.sum(dim=3) + n_inter                          # q.n
    den = torch.maximum(torch.abs(n_tot), _const(1.0, x.device))
    y = (y_intra + y_inter) / den[..., None]               # (B,Nc,Lc,H,P)
    y = merge_last(y.reshape(B, S, H, P)).to(x.dtype)
    y = norm_apply(p["ln_out"], y, cfg.norm) * silu(z)
    return x + y @ p["w_down"]


def mlstm_init_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> MLSTMState:
    _, H, P = _mlstm_dims(cfg)
    return MLSTMState(torch.zeros((batch, H, P, P), dtype=F32, device=device),
                      torch.zeros((batch, H, P), dtype=F32, device=device))


def mlstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 st: MLSTMState):
    """x: (B, 1, d) -> (y (B, 1, d), state).  ``st`` is updated in place:
    the returned state holds the same tensors."""
    di, H, P = _mlstm_dims(cfg)
    h = norm_apply(p["ln"], x, cfg.norm)
    xin, z = torch.split(h @ p["w_up"], di, dim=-1)
    q, k, v, logi, fpre = _qkv_gates(p, xin[:, 0], H, P)
    i = torch.exp(logi)                                          # (B,H)
    f = torch.exp(log_sigmoid(fpre))
    st.C.mul_(f[:, :, None, None]).add_(
        i[:, :, None, None] * (k[:, :, :, None] * v[:, :, None, :]))
    st.n.mul_(f[:, :, None]).add_(i[:, :, None] * k)
    num = (q[:, :, None, :] @ st.C)[:, :, 0]                     # (B,H,P)
    den = torch.maximum(torch.abs((q * st.n).sum(-1)),
                        _const(1.0, x.device))
    y = merge_last(num / den[:, :, None])[:, None].to(x.dtype)
    y = norm_apply(p["ln_out"], y, cfg.norm) * silu(z)
    return x + y @ p["w_down"], st


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def schema_slstm(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    P = d // H
    return {
        "ln": schema_norm(d, cfg.norm),
        "wx": ParamDef((d, 4 * d), ("fsdp", "tp")),
        "r": ParamDef((H, P, 4 * P), (None, None, None), init="fan_in",
                      dtype="float32"),
        "b": ParamDef((4 * d,), (None,), init="zeros", dtype="float32"),
        "ln_out": schema_norm(d, cfg.norm),
        "w_down": ParamDef((d, d), ("tp", "fsdp")),
    }


def slstm_init_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> SLSTMState:
    """Zeros, and ``m = -1e30``; fp32 whatever ``cfg.dtype``."""
    H = cfg.n_heads
    P = cfg.d_model // H
    z = torch.zeros((batch, H, P), dtype=F32, device=device)
    return SLSTMState(z, z.clone(), z.clone(), z - 1e30)


def _slstm_cell(p: dict, cfg: ModelConfig, xt: torch.Tensor,
                st: SLSTMState) -> SLSTMState:
    """xt: (B, 4d) precomputed input projection (fp32)."""
    H = cfg.n_heads
    P = cfg.d_model // H
    # einsum("bhp,hpq->bhq") as the one batched product it lowers to,
    # without einsum's host-side parsing once a token
    rec = torch.bmm(st.h.transpose(0, 1), p["r"]).transpose(0, 1)  # (B,H,4P)
    g = split_last(xt, (H, 4 * P)) + rec + p["b"].reshape(H, 4 * P)
    zt, it, ft, ot = torch.split(g, P, dim=-1)                   # (B,H,P)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    m_new = torch.maximum(ft + st.m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + st.m - m_new)
    c = f_p * st.c + i_p * zt
    n = f_p * st.n + i_p
    h = ot * c / torch.maximum(n, _const(1e-6, n.device))
    return SLSTMState(c, n, h, m_new)


def slstm_block(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); one ``_slstm_cell`` a token."""
    B, S = x.shape[0], x.shape[1]
    hin = norm_apply(p["ln"], x, cfg.norm)
    xt = (hin @ p["wx"]).to(F32)                                 # (B,S,4d)
    st = slstm_init_state(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(p, cfg, xt[:, t], st)
        hs.append(st.h)
    y = merge_last(torch.stack(hs, dim=1)).to(x.dtype)
    y = norm_apply(p["ln_out"], y, cfg.norm)
    return x + y @ p["w_down"]


def slstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 st: SLSTMState):
    """x: (B, 1, d) -> (y (B, 1, d), state).  ``st`` is updated in place:
    the returned state holds the same tensors."""
    B = x.shape[0]
    hin = norm_apply(p["ln"], x, cfg.norm)
    xt = (hin[:, 0] @ p["wx"]).to(F32)
    new = _slstm_cell(p, cfg, xt, st)
    for old, val in zip(st, new):
        old.copy_(val)
    y = st.h.reshape(B, 1, cfg.d_model).to(x.dtype)
    y = norm_apply(p["ln_out"], y, cfg.norm)
    return x + y @ p["w_down"], st
