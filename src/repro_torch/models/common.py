"""Shared model pieces: norms, RoPE, embeddings, attention masks and the
sequence-parallel constraint (a copy of ``repro.models.common``).

``seq_shard`` is the reference's sharding constraint as a ``DTensor``
``redistribute``: it acts only on a ``DTensor`` (the dry run's meshes,
``launch/dryrun.py``) with ``cfg.seq_parallel`` and ``cfg.mesh_axes``
set, and is a no-op everywhere else, as the reference's is without a
mesh.

Where the reference mixes dtypes in a product (a bf16 activation against
an fp32 norm scale, the unembedding's cast), the promotion is written out:
``torch.matmul`` does not promote as ``jnp.matmul`` does."""
from __future__ import annotations

import functools
import sys

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.policy import ParamDef


# ---------------------------------------------------------------------------
# norms (fp32 compute, param dtype fp32 for stability)
# ---------------------------------------------------------------------------

def schema_norm(d_model: int, kind: str = "rmsnorm") -> dict:
    s = {"scale": ParamDef((d_model,), (None,), init="ones", dtype="float32")}
    if kind == "layernorm":
        s["bias"] = ParamDef((d_model,), (None,), init="zeros", dtype="float32")
    return s


def norm_apply(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    scale = p["scale"].to(torch.float32)
    if kind == "rmsnorm":
        y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                              + eps)
        return (y * scale).to(dt)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + p["bias"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """The frequencies in numpy fp32, as the reference computes them, kept
    on ``device``: a copy from host memory per call would synchronise the
    stream twice per layer.  Callers only read the tensor."""
    half = hd // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0
                             / hd))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    frequencies in numpy fp32 and cos/sin in fp32, as the reference; the
    result is cast back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _rope_freqs(hd, float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def schema_embed(vocab: int, d_model: int) -> dict:
    return {
        "tok": ParamDef((vocab, d_model), ("vocab", "fsdp"), init="embed"),
        "out": ParamDef((d_model, vocab), ("fsdp", "vocab"), init="fan_in"),
    }


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["out"].to(x.dtype)


# ---------------------------------------------------------------------------
# sharding constraints (DTensor only)
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``; its module is loaded only where a
    mesh exists, so nothing else pays for the import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """``x`` redistributed to ``spec`` (``sharding.policy``'s tuples) over
    its own mesh, dropping what the mesh does not divide."""
    from repro_torch.sharding.policy import _divisible, placements
    mesh = x.device_mesh
    want = placements(_divisible(tuple(x.shape), spec, mesh), mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def unshard_dim(x: torch.Tensor, dim: int,
                reduce_partial: bool = False) -> torch.Tensor:
    """A DTensor with tensor dim ``dim`` gathered whole (its other
    placements kept; with ``reduce_partial`` its pending partial sums
    reduced too), for an op whose DTensor rule fails on a sharded
    ``dim``; anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.dim()
    want = tuple(Replicate() if (p.is_shard() and p.dim == dim)
                 or (reduce_partial and p.is_partial()) else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def split_last(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``x``'s last dim split into ``shape`` (heads, head dim).  A DTensor
    whose last dim is sharded over mesh axes that do not divide
    ``shape[0]`` is gathered on that dim first: DTensor refuses to split a
    dim unevenly (GQA's kv heads on a wider tp axis)."""
    if is_dtensor(x):
        last = x.dim() - 1
        m = 1
        for i, p in enumerate(x.placements):
            if p.is_shard() and p.dim == last:
                m *= x.device_mesh.size(i)
        if shape[0] % m:
            x = unshard_dim(x, last)
    return x.reshape(tuple(x.shape[:-1]) + tuple(shape))


class _MergeLast(torch.autograd.Function):
    """``x``'s last two dims merged, whose backward splits the gradient
    through ``split_last``."""

    @staticmethod
    def forward(ctx, x):
        ctx.split = tuple(x.shape[-2:])
        return x.reshape(tuple(x.shape[:-2]) + (-1,))

    @staticmethod
    def backward(ctx, g):
        return split_last(g, ctx.split)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x``'s last two dims (heads, head dim) merged into one.  On a
    DTensor the backward splits the gradient through ``split_last``: the
    reshape's own backward would split a tp-sharded dim by a head count
    the axis does not divide, which DTensor refuses."""
    if is_dtensor(x):
        return _MergeLast.apply(x)
    return x.reshape(tuple(x.shape[:-2]) + (-1,))


def remat(block, p: dict, cfg, *args):
    """``block(p, cfg, *args)``, recomputed in the backward under
    ``cfg.remat`` where autograd records (``jax.checkpoint`` in the
    reference)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(block, p, cfg, *args, use_reentrant=False)
    return block(p, cfg, *args)


def seq_shard(x: torch.Tensor, cfg) -> torch.Tensor:
    """Sequence-parallel constraint on the residual stream (B, S, d): the
    seq dim on the tp axis, the batch on dp (Korthikanti et al.).  No-op
    unless ``x`` is a DTensor, ``cfg.seq_parallel`` and ``cfg.mesh_axes``
    are set."""
    if not (getattr(cfg, "seq_parallel", False) and cfg.mesh_axes
            and is_dtensor(x)):
        return x
    from repro_torch.sharding.policy import batch_pspec
    return constrain(x, (batch_pspec(cfg.mesh_axes), "model")
                     + (None,) * (x.dim() - 2))


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def causal_mask(S: int, window: int = 0, device="cpu") -> torch.Tensor:
    """(S, S) additive fp32 mask; ``window`` > 0 adds a sliding-window
    constraint."""
    i = torch.arange(S, dtype=torch.int32, device=device)[:, None]
    j = torch.arange(S, dtype=torch.int32, device=device)[None, :]
    ok = j <= i
    if window:
        ok &= (i - j) < window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)
