"""Zero-padding for lane stacking and fold batching: the port of
``repro.core.padding``.

* the lane engine (``core.training``) zero-pads every param/data leaf
  per axis to the max shape across lanes and stacks along a new leading
  lane axis (zero rows/cols feed zero inputs and receive zero gradients,
  so each lane's real sub-block evolves exactly as it would unpadded);
* the k-fold probe (``core.classifier``) pads each fold's row-index list
  to a common length with index 0 at weight 0 (inert under the weighted
  loss).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def pad_to(arr, shape):
    """Zero-pad a tensor or numpy array at the end of every axis up to
    ``shape`` (the input itself when the shapes already match).
    Shrinking is not supported."""
    pads = [t - s for s, t in zip(arr.shape, shape)]
    if any(p < 0 for p in pads):
        raise ValueError(f"pad_to: cannot shrink {tuple(arr.shape)} to "
                         f"{tuple(shape)}")
    if not any(pads):
        return arr
    if isinstance(arr, np.ndarray):
        return np.pad(arr, [(0, p) for p in pads])
    out = arr.new_zeros(tuple(shape))
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def pad_stack(trees: Sequence):
    """Zero-pad every leaf per axis to the max shape across trees and stack
    along a new leading lane axis.  Tensor leaves stay on their device;
    numpy leaves become CPU tensors.  All trees share one structure."""
    keys = [_structure(t) for t in trees]
    if any(k != keys[0] for k in keys[1:]):
        raise ValueError("pad_stack: all trees must share one "
                         "param/data tree structure")
    leaves = [[torch.as_tensor(leaf) for leaf in tree_leaves(t)]
              for t in trees]
    stacked = []
    for pos in zip(*leaves):
        target = tuple(max(leaf.shape[d] for leaf in pos)
                       for d in range(pos[0].dim()))
        stacked.append(torch.stack([pad_to(leaf, target) for leaf in pos]))
    return tree_unflatten(trees[0], stacked)


def pad_index_rows(index_lists: Sequence[np.ndarray], *,
                   min_len: int = 0) -> tuple:
    """Pad variable-length host index arrays to one (k, max_len) int32
    matrix plus matching float32 0/1 weights.  Padded slots point at row 0
    with weight 0.0, so a gather through them is inert under any
    row-weighted reduction."""
    k = len(index_lists)
    lens = [len(ix) for ix in index_lists]
    max_len = max([min_len] + lens)
    idx = np.zeros((k, max_len), np.int32)
    w = np.zeros((k, max_len), np.float32)
    for i, ix in enumerate(index_lists):
        idx[i, :len(ix)] = ix
        w[i, :len(ix)] = 1.0
    return idx, w


def _structure(tree):
    return tree_map(lambda _: None, tree)
