"""Carry parameter trees between the JAX package and the port.

The JAX package's parameters reach the port as a dict tree of numpy
arrays (what ``ckpt.load_tree`` returns, or ``np.asarray`` of each jax
leaf); ``to_torch`` turns such a tree into tensors on a device, with the
same keys, shapes and ``(d_in, d_out)`` weight layout (int64 row ids stay
int64).  ``to_numpy`` carries a tree of tensors back.

NumPy has no bfloat16 of its own: JAX's bf16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses; they
cross bit for bit through a ``uint16`` view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16
        return torch.from_numpy(np.array(a.view(np.uint16), copy=True)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def to_torch(tree, *, device="cuda", float_dtype=torch.float32):
    """Dict tree of arrays -> the same tree of tensors on ``device``.
    Floating leaves become ``float_dtype``: float32 by default, as
    ``jnp.asarray`` makes them under the reference's default 32-bit
    config; ``float_dtype=None`` keeps each leaf's own (bf16 included, as
    an LM's params carry bf16 weights beside fp32 norm scales).  Integer
    leaves (int64 row ids) keep their dtype."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device=dev, float_dtype=float_dtype)
                for k, v in tree.items()}
    t = _tensor(tree)
    if t.is_floating_point() and float_dtype is not None:
        t = t.to(float_dtype)
    return t.to(dev)


def to_numpy(tree):
    """Dict tree of tensors (any device) -> the same tree of host arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
