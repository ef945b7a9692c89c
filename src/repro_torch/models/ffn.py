"""Feed-forward blocks: dense swiglu / squared-relu / gelu and the MoE (a
copy of ``repro.models.ffn``).

``jax.nn.gelu`` is the tanh approximation by default, so the port calls
``gelu(approximate="tanh")``.

The MoE is the reference's capacity dispatch, with its semantics kept
exactly: top-k softmax routing, each expert's entries ranked in entry
order, capacity ``C = ceil(N*k/E * capacity_factor)`` in host float64,
entries of rank >= C dropped (they contribute zero), the Switch aux loss.
Where a straight translation would differ:

* ties: ``jax.lax.top_k`` orders equal probabilities by expert id, so the
  top k come from a stable descending sort (``torch.topk`` promises no
  order among ties);
* the dispatch and the combine move rows by gathers only.  The combine
  adds each token's contributions in ascending slot order (expert id,
  then rank) onto zeros, the order of the reference's scatter-add on the
  CPU, and the gradient of the dispatch sums a token's slots in the same
  order.  No atomic ``index_add_`` / ``scatter_add_`` runs, so two calls
  on the card give the same bits;
* the reference's ``seq_parallel`` reshard before routing is a
  ``DTensor`` ``redistribute`` (``common.constrain``), a no-op without a
  mesh; under a mesh (the dry run) the router probabilities are
  replicated before the sort, and the slot math (``argsort``,
  ``searchsorted``, slot writes), which ``DTensor`` has no sharding rule
  for, runs on each rank's replicated expert ids.

Under a profiler the MoE's parts are the spans ``moe.route``,
``moe.dispatch_combine`` (the slot maps and the dispatch gather; then the
weighted combine) and ``moe.experts`` (``repro_torch.spans``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import constrain, is_dtensor
from repro_torch.sharding.policy import ParamDef, batch_pspec
from repro_torch.spans import span


def schema_ffn(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn_type == "swiglu":
        return {
            "w_gate": ParamDef((d, f), ("fsdp", "tp")),
            "w_up": ParamDef((d, f), ("fsdp", "tp")),
            "w_down": ParamDef((f, d), ("tp", "fsdp")),
        }
    return {  # squared_relu | gelu: plain 2-matrix MLP
        "w_in": ParamDef((d, f), ("fsdp", "tp")),
        "w_out": ParamDef((f, d), ("tp", "fsdp")),
    }


def ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    h = x @ p["w_in"]
    if cfg.ffn_type == "squared_relu":        # nemotron-4 [arXiv:2402.16819]
        h = torch.square(torch.relu(h))
    elif cfg.ffn_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown ffn_type {cfg.ffn_type!r}")
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def schema_moe(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, E), ("fsdp", None), dtype="float32"),
        "w_gate": ParamDef((E, d, f), ("ep", "fsdp", None)),
        "w_up": ParamDef((E, d, f), ("ep", "fsdp", None)),
        "w_down": ParamDef((E, f, d), ("ep", None, "fsdp")),
    }


class Routing(NamedTuple):
    probs: torch.Tensor      # (N, E) fp32 router softmax
    topi: torch.Tensor       # (N, k) int64 experts, descending probability
    topw: torch.Tensor       # (N, k) fp32 weights, renormalised over the k
    slot: torch.Tensor       # (N, k) int64 e*C + rank in e, or E*C: dropped
    capacity: int            # C


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """C = ceil(N*k/E * capacity_factor), in host float64 in the
    reference's order."""
    return int(math.ceil(n_tokens * cfg.experts_per_token / cfg.n_experts
                         * cfg.capacity_factor))


def route(router: torch.Tensor, cfg: ModelConfig,
          xt: torch.Tensor) -> Routing:
    """Top-k routing of the tokens ``xt`` (N, d) and each entry's slot.
    Entry (t, j) is ranked among its expert's entries in entry order
    (t, then j); ranks >= C go to the drop slot E*C."""
    N = xt.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(xt.to(torch.float32) @ router, dim=-1)
    if is_dtensor(probs):
        # under a mesh the routes are decided on the probabilities
        # replicated over it (the sort below then sees every expert)
        from torch.distributed.tensor import Replicate
        probs = probs.redistribute(probs.device_mesh,
                                   [Replicate()] * probs.device_mesh.ndim)
    # ties in expert-id order, as jax.lax.top_k
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = w[:, :k], idx[:, :k]
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)
    if is_dtensor(topi):
        # the slot math (argsort, searchsorted, slot writes) has no DTensor
        # rule: it runs on this rank's replicated expert ids
        topi = topi.to_local()
    C = capacity(cfg, N)
    eid = topi.reshape(N * k)
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    # starts[e]: the exclusive cumsum of the per-expert counts
    starts = torch.searchsorted(eid_s, torch.arange(E, dtype=torch.int64,
                                                 device=eid.device))
    rank_s = torch.arange(N * k, dtype=torch.int64,
                          device=eid.device) - starts[eid_s]
    dest = torch.where(rank_s < C, eid_s * C + rank_s, E * C)
    slot = torch.empty_like(dest)
    slot[order] = dest                      # a permutation: no collisions
    return Routing(probs, topi, topw, slot.reshape(N, k), C)


def _rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src``'s rows at ``idx``; index ``len(src)`` gives a zero row."""
    return torch.cat([src, src.new_zeros((1,) + src.shape[1:])])[idx]


def _sum_rows(src: torch.Tensor, uses: torch.Tensor) -> torch.Tensor:
    """out[r] = 0 + src[uses[r, 0]] + src[uses[r, 1]] + ..., added in that
    order in ``src``'s dtype; index ``len(src)`` adds a zero row."""
    pad = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
    out = src.new_zeros((uses.shape[0],) + src.shape[1:])
    for j in range(uses.shape[1]):
        out = out + pad[uses[:, j]]
    return out


class _Gather(torch.autograd.Function):
    """``_rows(src, idx)``, whose gradient sums each row's uses in
    ascending order (``uses[r]``: the positions that read row r, ascending,
    padded with the output's length)."""

    @staticmethod
    def forward(ctx, src, idx, uses):
        ctx.save_for_backward(idx, uses)
        return _rows(src, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, uses = ctx.saved_tensors
        return _sum_rows(g, uses), None, None


class _Sum(torch.autograd.Function):
    """``_sum_rows(src, uses)``, whose gradient is ``_rows(g, idx)``
    (``idx[s]``: the output row that adds row s, or the output's length)."""

    @staticmethod
    def forward(ctx, src, uses, idx):
        ctx.save_for_backward(idx, uses)
        return _sum_rows(src, uses)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, uses = ctx.saved_tensors
        return _rows(g, idx), None, None


def _experts(p: dict, ein: torch.Tensor) -> torch.Tensor:
    """Every expert's swiglu on its C slots: (E, C, d) -> (E, C, d)."""
    h = F.silu(torch.bmm(ein, p["w_gate"])) * torch.bmm(ein, p["w_up"])
    return torch.bmm(h, p["w_down"])


def moe(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar fp32).

    Top-k softmax routing with per-expert capacity C = ceil(N*k/E * cf);
    overflow tokens are dropped (contribute zero), standard Switch
    behaviour.  The dispatch buffer, the expert products and the combine
    stay in ``x.dtype``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    N = B * S
    if cfg.seq_parallel and cfg.mesh_axes and is_dtensor(x):
        # under sequence parallelism the residual stream is seq-sharded on
        # the tp axis: re-shard tokens to batch-only before routing so the
        # dispatch crosses only the ep axis (the reference's constraint)
        x = constrain(x, (batch_pspec(cfg.mesh_axes), None, None))
    xt = x.reshape(N, d)
    with span("moe.route"):
        r = route(p["router"], cfg, xt)
    C = r.capacity

    # Switch aux load-balance loss: E * sum_e fraction_tokens_e * mean_prob_e
    me = torch.mean(r.probs, dim=0)
    ce = torch.mean(F.one_hot(r.topi[:, 0], E).to(torch.float32), dim=0)
    aux = E * torch.sum(me * ce)

    with span("moe.dispatch_combine"):
        # who fills each slot: a token (N: none) and its entry (N*k: none);
        # the drop slot E*C collects every dropped entry and is cut off
        slot = r.slot.reshape(N * k)
        dev = x.device
        entry = torch.full((E * C + 1,), N * k, dtype=torch.int64,
                           device=dev)
        entry[slot] = torch.arange(N * k, dtype=torch.int64, device=dev)
        entry = entry[:-1]
        tok_of_slot = torch.where(
            entry < N * k, torch.div(entry, k, rounding_mode="floor"), N)
        # each token's slots in ascending order, the drop slot last
        uses = torch.sort(r.slot, dim=1).values
        ein = _Gather.apply(xt, tok_of_slot, uses).reshape(E, C, d)
    with span("moe.experts"):
        eout = _experts(p, ein)                             # (E, C, d)
    with span("moe.dispatch_combine"):
        w = r.topw.reshape(N * k, 1).to(x.dtype)
        w_of_slot = _Gather.apply(w, entry, slot.reshape(N * k, 1))
        contrib = eout.reshape(E * C, d) * w_of_slot
        y = _Sum.apply(contrib, uses, tok_of_slot)
    return y.reshape(B, S, d), aux.to(torch.float32)
