"""Checkpointing without JAX: flat-path ``.npz`` plus a ``.json`` sidecar,
byte-for-byte the format of ``repro.checkpoint.ckpt.save`` /
``load_tree``, so a tree saved by either package loads in the other.

Leaves may be numpy arrays, Python scalars or torch tensors (saved from
host memory).  ``load_tree`` hands back host numpy arrays with their saved
dtypes — int64 row ids survive — and the caller decides what to upload.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix.rstrip(SEP)] = tree
    return out


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            # numpy has no bf16: save it as JAX does, an ml_dtypes array
            import ml_dtypes
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.numpy()
    return np.asarray(v)


def save(path: str, tree: Any, *, step: int = 0, meta: dict | None = None):
    arrays = {k: _host(v) for k, v in _flatten(tree).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    side = {"step": step, "meta": meta or {},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()}}
    with open(path + ".json", "w") as fh:
        json.dump(side, fh)


def load_tree(path: str) -> tuple:
    """Rebuild a saved dict-only tree (every container a dict, as trained
    params and serving bundles are).  Returns ``(tree, side)``: host
    ``np.ndarray`` leaves with their saved dtypes, and the sidecar dict
    written by ``save`` (step / meta / dtypes)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    side_path = path[:-len(".npz")] + ".json"
    if not os.path.exists(side_path):
        side_path = path + ".json"          # save("x.npz") wrote x.npz.json
    with open(side_path) as fh:
        side = json.load(fh)
    tree: dict = {}
    with np.load(path) as data:             # leaves copied out eagerly
        for k in data.files:
            parts = k.split(SEP)
            cur = tree
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = np.asarray(data[k])
    return tree, side
