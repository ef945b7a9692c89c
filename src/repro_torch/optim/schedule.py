"""LR schedules (fp32 functions of the int32 step) and micro-batched
gradient accumulation for the LM train step: the port of
``repro.optim.schedule``."""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``; in fp32, as the
    reference computes it.  The cosine of the fp32 angle is taken in
    float64 and rounded once: correctly rounded, as XLA's fp32 cosine is
    on these angles, where PyTorch's fp32 CPU cosine is 1 ulp off at
    some."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        angle = (math.pi * prog).to(torch.float64)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(angle).to(torch.float32))
        return torch.where(s < warmup_steps, warm, peak_lr * cos)
    return lr


def constant(lr_value: float) -> Callable:
    return lambda step: torch.full((), lr_value, dtype=torch.float32,
                                   device=step.device)


def value_and_grad(loss_fn: Callable) -> Callable:
    """``loss_fn(params, batch) -> (loss, aux)`` -> ``vag(params, batch) ->
    ((loss, aux), grads)``, with grads a tree like ``params`` in each
    leaf's dtype.  The params are not modified: autograd records through
    detached copies that require grad."""
    def vag(params, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, aux = loss_fn(p, batch)
            leaves = tree_leaves(p)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not read has a zero gradient, as in JAX
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return ((loss.detach(), tree_map(lambda a: a.detach(), aux)),
                tree_unflatten(p, grads))
    return vag


def accumulate_grads(loss_fn: Callable, n_micro: int) -> Callable:
    """Wrap ``loss_fn(params, batch) -> (loss, aux)`` with micro-batch
    gradient accumulation over the leading batch dim (batch size must be
    a multiple of ``n_micro``).  As the reference's ``lax.scan``: the
    micro-batches go in order, loss, aux and grads are summed into fp32
    zeros and then scaled by ``1 / n_micro``."""
    vag = value_and_grad(loss_fn)
    if n_micro <= 1:
        return vag

    def split(batch: dict) -> list:
        def re(x):
            b = x.shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"n_micro {n_micro}")
            return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
        micro = tree_map(re, batch)
        return [tree_map(lambda x: x[i], micro) for i in range(n_micro)]

    def acc(params, batch):
        f32 = torch.float32
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                               device=p.device), params)
        loss, aux = None, None
        for mb in split(batch):
            (l, a), g = vag(params, mb)
            grads = tree_map(torch.add, grads, g)
            if loss is None:
                loss = torch.zeros((), dtype=f32, device=l.device)
                aux = tree_map(torch.zeros_like, a)
            loss = loss + l
            aux = tree_map(torch.add, aux, a)
        scale = 1.0 / n_micro
        return ((loss * scale, tree_map(lambda a: a * scale, aux)),
                tree_map(lambda g: g * scale, grads))

    return acc
