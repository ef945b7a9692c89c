"""Serving steps (a copy of ``repro.serve.decode``): prefill (full
forward -> last-token logits) and one-token greedy decode against a
(possibly sliding-window) KV cache.

``cache_pspecs`` shards cache trees: the batch dim -> dp, then the largest
mesh-divisible non-batch dim -> model (for GQA caches whose kv-head count
is smaller than the tp axis this picks the slots dim: a
sequence-parallel cache).  Specs are ``sharding.policy``'s tuples."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.sharding.policy import batch_pspec, mesh_sizes
from repro_torch.spans import span
from repro_torch.tree import tree_map


def prefill_step(params, cfg: ModelConfig, inputs: dict) -> torch.Tensor:
    with span("serve.prefill_step"):
        lg, _ = M.logits(params, cfg, inputs)
        return lg[:, -1]


def make_decode_step(cfg: ModelConfig, window: int = 0):
    """``step(params, token, cache, pos) -> (next tokens (B,) int32,
    cache)``: greedy, ties to the first index as ``jnp.argmax``."""
    def step(params, token, cache, pos):
        logits, cache = M.decode(params, cfg, token, cache, pos, window)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return step


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Sliding-window slots for the given decode shape (0 = full cache)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        return cfg.long_context_window
    return cfg.sliding_window


def n_cache_slots(cfg: ModelConfig, shape: ShapeConfig) -> int:
    w = decode_window(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


def _batch_dim(shape: tuple, batch: int) -> int:
    for i, s in enumerate(shape):
        if s == batch:
            return i
    return -1


def _cache_spec(mesh, batch: int):
    """The spec of one cache leaf (anything with a ``shape``) on ``mesh``
    for a global batch of ``batch``, as a function of the leaf."""
    sizes = mesh_sizes(mesh)
    model_n = sizes.get("model", 1)
    dp_axes = ("pod", "data") if "pod" in sizes else ("data",)
    dp_n = math.prod(sizes[a] for a in dp_axes)
    dp = batch_pspec(tuple(sizes))

    def spec(x):
        sh = tuple(x.shape)
        ent = [None] * len(sh)
        b = _batch_dim(sh, batch)
        if b >= 0 and sh[b] % dp_n == 0 and batch > 1:
            ent[b] = dp
        # largest remaining dim divisible by the model axis
        cand = [(s, i) for i, s in enumerate(sh)
                if i != b and s % model_n == 0 and s >= model_n]
        if cand and model_n > 1:
            _, i = max(cand)
            ent[i] = "model"
        return tuple(ent)
    return spec


def cache_pspecs(cache, mesh, batch: int):
    """One spec a cache leaf, the cache's structure kept."""
    return map_cache(_cache_spec(mesh, batch), cache)


def map_cache(fn, cache, *rest):
    """``fn`` over a cache's tensors and the matching leaves of each tree
    in ``rest`` (a tree of the same structure, such as ``cache_pspecs``'):
    dicts, NamedTuples, lists and tuples keep their structure; None stays
    None."""
    if cache is None:
        return None
    if isinstance(cache, dict):
        return {k: map_cache(fn, v, *(r[k] for r in rest))
                for k, v in cache.items()}
    if isinstance(cache, tuple) and hasattr(cache, "_fields"):
        return type(cache)(*(map_cache(fn, *xs) for xs in zip(cache, *rest)))
    if isinstance(cache, (list, tuple)):
        return type(cache)(map_cache(fn, *xs) for xs in zip(cache, *rest))
    return fn(cache, *rest)
