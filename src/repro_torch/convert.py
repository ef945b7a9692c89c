"""Carry parameter trees between the JAX package and the port.

The JAX package's parameters reach the port as a dict tree of numpy
arrays (what ``ckpt.load_tree`` returns, or ``np.asarray`` of each jax
leaf); ``to_torch`` turns such a tree into tensors on a device, with the
same keys, shapes and ``(d_in, d_out)`` weight layout (int64 row ids stay
int64).  ``to_numpy`` carries a tree of tensors back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def to_torch(tree, *, device="cuda"):
    """Dict tree of arrays -> the same tree of tensors on ``device``.
    Floating leaves become float32, as ``jnp.asarray`` makes them under
    the reference's default 32-bit config; integer leaves (int64 row
    ids) keep their dtype."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device=dev) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) \
        else torch.from_numpy(np.array(tree, copy=True))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(dev)


def to_numpy(tree):
    """Dict tree of tensors (any device) -> the same tree of host arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
