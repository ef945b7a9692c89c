"""Plain PyTorch versions of the kernels in this package: what a CPU
tensor runs, and what the CUDA kernels are held against on the card.
Counterparts of ``repro.kernels.ref`` and of the closed-form backward
passes in ``repro.kernels.lane_mlp`` / ``distill_loss`` / ``probe``.

Each backward here is written out in closed form, as its Pallas kernel
computes it, and is not autograd of the forward.  Every function takes an
optional leading lane axis: weights ``(L, d_in, d_out)`` with biases
``(L, d_out)`` and inputs ``(L, B, d_in)``, or the unstacked shapes."""
from __future__ import annotations

import torch

# jax.nn.selu constants (repro/kernels/lane_mlp.py): the expm1 form, not
# torch.nn.functional.selu, so the port rounds as the reference does
SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946


def selu(a: torch.Tensor) -> torch.Tensor:
    return SELU_SCALE * torch.where(a > 0, a, SELU_ALPHA * torch.expm1(a))


def dselu(a: torch.Tensor) -> torch.Tensor:
    """Exact derivative of the expm1 form (``lane_mlp._dselu``)."""
    return SELU_SCALE * torch.where(a > 0, 1.0, SELU_ALPHA * torch.exp(a))


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(-1, -2)


def mlp2_fwd_ref(x, w0, b0, w1, b1, *, final_act: bool = False):
    """``(out, a1, a2)``: the forward and the two pre-activations the
    backward needs (``lane_mlp._fwd_kernel``)."""
    a1 = x @ w0 + b0.unsqueeze(-2)
    a2 = selu(a1) @ w1 + b1.unsqueeze(-2)
    return (selu(a2) if final_act else a2), a1, a2


def mlp2_ref(x, w0, b0, w1, b1, *, final_act: bool = False):
    """``selu(x @ w0 + b0) @ w1 + b1`` (optionally selu'd): the 2-layer
    Table-3 MLP, weights in ``(d_in, d_out)`` layout."""
    return mlp2_fwd_ref(x, w0, b0, w1, b1, final_act=final_act)[0]


def mlp2_bwd_ref(g, x, a1, a2, w0, w1, final_act: bool = False):
    """Closed-form backward of ``mlp2_ref`` for the output cotangent ``g``
    (``lane_mlp._bwd_kernel``): returns ``(dx, dw0, db0, dw1, db1)``."""
    g2 = g * dselu(a2) if final_act else g
    dw1 = _t(selu(a1)) @ g2
    db1 = g2.sum(-2)
    g1 = (g2 @ _t(w1)) * dselu(a1)
    dw0 = _t(x) @ g1
    db0 = g1.sum(-2)
    return g1 @ _t(w0), dw0, db0, dw1, db1


def distill_rows_ref(x, x_hat, z, z_t, mask, *, lam: float, kind: str):
    """Per-row Eq. 5 losses (``distill_loss._kernel``):
    ``mean_d (x - x_hat)^2 + lam * mask * mean_m |z - z_t|^p``."""
    rec = torch.mean(torch.square(x - x_hat), dim=-1)
    diff = z - z_t
    dis = torch.mean(torch.abs(diff) if kind == "mae"
                     else torch.square(diff), dim=-1)
    return rec + lam * mask * dis


def distill_rows_bwd_ref(g, x, x_hat, z, z_t, mask, *, lam: float,
                         kind: str):
    """Closed-form backward of ``distill_rows_ref`` for row cotangents
    ``g`` (``distill_loss._bwd_kernel``): returns ``(dx, dz, dmask)``;
    ``d x_hat = -dx`` and ``d z_t = -dz``.  ``sign(0) = 0``, as
    ``jnp.sign``."""
    D, M = x.shape[-1], z.shape[-1]
    diff = z - z_t
    dx = (g.unsqueeze(-1) * (2.0 / D)) * (x - x_hat)
    if kind == "mae":
        dis = torch.mean(torch.abs(diff), dim=-1)
        ddis = torch.sign(diff) / M
    else:
        dis = torch.mean(torch.square(diff), dim=-1)
        ddis = 2.0 * diff / M
    dz = (g * lam * mask).unsqueeze(-1) * ddis
    return dx, dz, g * lam * dis


def probe_grad_ref(w, b, x, y, rwn):
    """Weighted softmax-CE loss and its closed-form gradient, without the
    L2 term (``probe._probe_kernel``): returns ``(loss, dw, db)``.
    ``rwn`` are row weights already divided by ``max(sum(rw), 1)``; rows
    of weight 0 are exactly inert.  With a lane axis, ``w`` (k, d, C),
    ``b`` (k, C) and ``rwn`` (k, n) share ``x`` (n, d) and ``y`` (n,)."""
    logits = x @ w + b.unsqueeze(-2)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    se = torch.sum(e, dim=-1, keepdim=True)
    lse = torch.log(se[..., 0]) + m[..., 0]
    onehot = torch.nn.functional.one_hot(
        y.long(), logits.shape[-1]).to(logits.dtype)
    gold = torch.sum(logits * onehot, dim=-1)
    loss = torch.sum((lse - gold) * rwn, dim=-1)
    g = (e / se - onehot) * rwn.unsqueeze(-1)
    return loss, _t(x) @ g, g.sum(-2)


def int8_matmul_ref(x, w_q, scale, b):
    """Weight-only int8: dequantize per output channel, then matmul."""
    return x @ (w_q.to(torch.float32) * scale[None, :]) + b
