"""Plain PyTorch versions of the kernels in this package: what a CPU
tensor runs, and what the CUDA kernels are held against on the card.
Counterparts of ``repro.kernels.ref.mlp2_ref`` and ``int8_matmul_ref``."""
from __future__ import annotations

import torch

# jax.nn.selu constants (repro/kernels/lane_mlp.py): the expm1 form, not
# torch.nn.functional.selu, so the port rounds as the reference does
SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946


def selu(a: torch.Tensor) -> torch.Tensor:
    return SELU_SCALE * torch.where(a > 0, a, SELU_ALPHA * torch.expm1(a))


def mlp2_ref(x, w0, b0, w1, b1, *, final_act: bool = False):
    """``selu(x @ w0 + b0) @ w1 + b1`` (optionally selu'd): the 2-layer
    Table-3 MLP, weights in ``(d_in, d_out)`` layout."""
    out = selu(x @ w0 + b0) @ w1 + b1
    return selu(out) if final_act else out


def int8_matmul_ref(x, w_q, scale, b):
    """Weight-only int8: dequantize per output channel, then matmul."""
    return x @ (w_q.to(torch.float32) * scale[None, :]) + b
