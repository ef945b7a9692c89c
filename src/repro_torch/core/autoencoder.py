"""Symmetric MLP autoencoders (paper Table 3, SELU activations): the
forward half of ``repro.core.autoencoder``.

Parameters are plain dicts of tensors, ``{"w0", "b0", "w1", "b1", ...}``
per MLP and ``{"enc", "dec"}`` per autoencoder, with weights in the
reference's ``(d_in, d_out)`` layout, so trees cross between the packages
unchanged.  ``fused_*`` route the 2-layer Table-3 MLP through the lane-MLP
kernel (``kernels.ops.fused_mlp2``).  The losses come with training.
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
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1 or final_act:
            x = selu(x)
    return x


def encode(params: dict, x: torch.Tensor) -> torch.Tensor:
    return mlp_apply(params["enc"], x)


def reconstruct(params: dict, x: torch.Tensor) -> torch.Tensor:
    return mlp_apply(params["dec"], encode(params, x))


def fused_mlp_apply(params: dict, x: torch.Tensor, *,
                    final_act: bool = False) -> torch.Tensor:
    """``mlp_apply`` through the lane-MLP kernel when the MLP is the
    2-layer Table-3 shape; MLPs of any other depth take the layer loop."""
    if _n_layers(params) != 2:
        return mlp_apply(params, x, final_act=final_act)
    return kops.fused_mlp2(x, params["w0"], params["b0"], params["w1"],
                           params["b1"], final_act=final_act)


def fused_encode(params: dict, x: torch.Tensor) -> torch.Tensor:
    return fused_mlp_apply(params["enc"], x)
