"""Symmetric MLP autoencoders (paper Table 3, SELU activations): the
port of ``repro.core.autoencoder``.

Parameters are plain dicts of tensors, ``{"w0", "b0", "w1", "b1", ...}``
per MLP and ``{"enc", "dec"}`` per autoencoder, with weights in the
reference's ``(d_in, d_out)`` layout, so trees cross between the packages
unchanged.  ``fused_*`` route the 2-layer Table-3 MLP through the lane-MLP
kernels (forward and closed-form backward, ``kernels.ops``).

Every function here also takes a stack of lanes: params with a leading
lane axis (weights ``(L, d_in, d_out)``, biases ``(L, d_out)``) and data
``(L, B, d)``.  The losses then return one value per lane ``(L,)``, which
is how ``training.train_lanes`` feeds a shape group to the kernels' lane
axis in one call.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import selu


def table3_encoder(role: str, n_features: int) -> list:
    """Paper Table 3 widths. role: g1_active|g1_passive|g2|g3."""
    return {
        "g1_active": [n_features, 64, 128],
        "g1_passive": [n_features, 128, 256],
        "g2": [n_features, 256, 256],
        "g3": [n_features, 256, 256],
    }[role]


def init_mlp(generator: torch.Generator, widths: Sequence[int], *,
             device="cuda") -> dict:
    """LeCun normal weights (the recommended init for SELU networks) and
    zero biases.  Drawn on the CPU from ``generator`` and then moved, so a
    seed gives the same weights on every device."""
    dev = resolve_device(device)
    params = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        w = torch.randn((a, b), generator=generator) / math.sqrt(a)
        params[f"w{i}"] = w.to(dev)
        params[f"b{i}"] = torch.zeros((b,), device=dev)
    return params


def init_autoencoder(generator: torch.Generator, enc_widths: Sequence[int],
                     *, device="cuda") -> dict:
    return {"enc": init_mlp(generator, list(enc_widths), device=device),
            "dec": init_mlp(generator, list(enc_widths)[::-1],
                            device=device)}


def _n_layers(params: dict) -> int:
    return len([k for k in params if k.startswith("w")])


def mlp_apply(params: dict, x: torch.Tensor, *,
              final_act: bool = False) -> torch.Tensor:
    n = _n_layers(params)
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"].unsqueeze(-2)
        if i < n - 1 or final_act:
            x = selu(x)
    return x


def encode(params: dict, x: torch.Tensor) -> torch.Tensor:
    return mlp_apply(params["enc"], x)


def reconstruct(params: dict, x: torch.Tensor) -> torch.Tensor:
    return mlp_apply(params["dec"], encode(params, x))


def fused_mlp_apply(params: dict, x: torch.Tensor, *,
                    final_act: bool = False) -> torch.Tensor:
    """``mlp_apply`` through the lane-MLP kernels when the MLP is the
    2-layer Table-3 shape (one fused forward, closed-form backward); MLPs
    of any other depth take the layer loop.  ``x`` of shape (L, B, d)
    with stacked params runs all L lanes in one launch."""
    if _n_layers(params) != 2:
        return mlp_apply(params, x, final_act=final_act)
    args = (x, params["w0"], params["b0"], params["w1"], params["b1"])
    if x.dim() == 3:
        return kops.lane_mlp2(*args, final_act=final_act)
    return kops.fused_mlp2(*args, final_act=final_act)


def fused_encode(params: dict, x: torch.Tensor) -> torch.Tensor:
    return fused_mlp_apply(params["enc"], x)


def fused_reconstruct(params: dict, x: torch.Tensor) -> torch.Tensor:
    return fused_mlp_apply(params["dec"], fused_encode(params, x))


def _mean_rows(t: torch.Tensor) -> torch.Tensor:
    """Mean over the last two axes: a scalar, or one value per lane."""
    return torch.mean(t, dim=(-2, -1))


def _reconstruct(params: dict, x: torch.Tensor) -> torch.Tensor:
    # the card has no path but the kernels, so a plain loss of a CUDA
    # batch reconstructs through them too (same math as the layer loop)
    return (fused_reconstruct if x.is_cuda else reconstruct)(params, x)


def recon_loss(params: dict, batch: dict) -> torch.Tensor:
    x = batch["x"]
    return _mean_rows(torch.square(x - _reconstruct(params, x)))


def _masked_mean(x, x_hat, fm, rw):
    se = torch.square(x - x_hat) * fm.unsqueeze(-2)
    per_row = torch.sum(se, dim=-1) / torch.clamp(
        torch.sum(fm, dim=-1, keepdim=True), min=1.0)
    return torch.sum(per_row * rw, dim=-1) / torch.clamp(
        torch.sum(rw, dim=-1), min=1.0)


def masked_recon_loss(params: dict, batch: dict) -> torch.Tensor:
    """``recon_loss`` over the padded-stack batches of
    ``training.train_lanes``: ``mask`` (D,) selects the party's real
    feature columns, ``row_w`` (B,) its real rows.  With no padding this
    equals ``recon_loss`` exactly (mean over real entries)."""
    x = batch["x"]
    return _masked_mean(x, _reconstruct(params, x), batch["mask"],
                        batch["row_w"])


def make_recon_loss(use_kernel: bool = False):
    """``recon_loss`` with the reconstruction routed through the lane-MLP
    kernels when ``use_kernel=True``: the same math, one fused pass per
    MLP.  On a CUDA tensor ``recon_loss`` reconstructs through the kernels
    too: the card has no other path."""
    return _fused_recon_loss if use_kernel else recon_loss


def _fused_recon_loss(params: dict, batch: dict) -> torch.Tensor:
    x = batch["x"]
    return _mean_rows(torch.square(x - fused_reconstruct(params, x)))


_fused_recon_loss.cache_key = ("repro.core.autoencoder.make_recon_loss",
                               True)


def make_masked_recon_loss(use_kernel: bool = False):
    """``masked_recon_loss`` with a fused-kernel reconstruction path: the
    lane-engine (``train_lanes``) variant of ``make_recon_loss``."""
    return _fused_masked_recon_loss if use_kernel else masked_recon_loss


def _fused_masked_recon_loss(params: dict, batch: dict) -> torch.Tensor:
    x = batch["x"]
    return _masked_mean(x, fused_reconstruct(params, x), batch["mask"],
                        batch["row_w"])


_fused_masked_recon_loss.cache_key = (
    "repro.core.autoencoder.make_masked_recon_loss", True)

