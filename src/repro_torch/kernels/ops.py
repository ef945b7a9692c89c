"""Public wrappers around the port's kernels.

A CPU tensor takes the plain PyTorch version (``kernels.ref``); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback.
``LAUNCHES`` counts kernel launches per kernel, incremented right where a
kernel is launched and nowhere else, so a run can show that its path went
through the kernels (``reset_launches`` zeroes it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

LAUNCHES = {"lane_mlp_fwd": 0, "int8_matmul": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{what}: no kernel or plain path for device "
                     f"{x.device}")


def fused_mlp2(x, w0, b0, w1, b1, *, final_act: bool = False):
    """Fused ``selu(x @ w0 + b0) @ w1 + b1`` (optionally selu'd).
    x (B, din), w0 (din, h), w1 (h, dz): one lane-MLP kernel launch on
    CUDA, the plain version on the CPU."""
    if not _on_cuda(x, "fused_mlp2"):
        return ref.mlp2_ref(x, w0, b0, w1, b1, final_act=final_act)
    if x.shape[0] == 0:
        return x.new_zeros((0, w1.shape[1]))
    from repro_torch.kernels import lane_mlp
    out = lane_mlp.launch(x[None], w0[None], b0[None], w1[None], b1[None],
                          final_act=final_act)
    LAUNCHES["lane_mlp_fwd"] += 1
    return out[0]


def int8_matmul(x, w_q, scale, b, *, act: str = "none"):
    """Weight-only int8 matmul with the per-channel dequant fused in, plus
    an optional SELU: the quantized serving path's GEMM."""
    if act not in ("none", "selu"):
        raise ValueError(f"int8_matmul: unknown act {act!r}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul: w_q must be int8, got {w_q.dtype}")
    if not _on_cuda(x, "int8_matmul"):
        out = ref.int8_matmul_ref(x, w_q, scale, b)
        return ref.selu(out) if act == "selu" else out
    if x.shape[0] == 0:
        return x.new_zeros((0, w_q.shape[1]))
    from repro_torch.kernels import int8_matmul as i8
    out = i8.launch(x, w_q, scale, b, act=act)
    LAUNCHES["int8_matmul"] += 1
    return out
