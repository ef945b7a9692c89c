"""Parameter schema: a copy of the schema half of
``repro.sharding.policy``.

Every model module describes its parameters as a dict tree of
:class:`ParamDef` (shape, logical axes, init recipe).  ``init_params``
materializes it as tensors and ``param_count`` counts it without
allocating.  The logical axes are kept for the meshes of a later slice
(ROADMAP Queue 1); nothing here reads them yet.

A drawn leaf (``fan_in``, ``embed``, ``normal``, ``mamba_A``, ``dt_bias``,
``small``) is drawn in fp32 and cast to its dtype.  Where that fp32 draw
would pass ``SLICE_ELEMENTS`` (2^28 elements, 1 GiB), the leaf is drawn in
slices along its leading axis (the stacked layer axis of a block leaf; the
rows of an embedding) into a tensor of its own dtype, each slice at most
``SLICE_ELEMENTS`` (or one leading row, where a row alone is larger), with
the fan-in of the whole leaf.  So the fp32 temporaries stay the size of a
slice: qwen3-moe-30b-a3b's expert banks (48, 128, 2048, 768) are 18 GiB
each in bf16 and would need 36 GiB a draw whole, more with the scaled
copy.  At the registry's full widths the stacked block leaves and the
embeddings of the larger configs pass the size and are sliced; every
smoke config's leaves lie below it, so they keep the bits of a whole draw.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple                  # one logical-axis name (or None) per dim
    init: str = "fan_in"         # fan_in|zeros|ones|embed|normal|mamba_A|dt_bias|small
    scale: float = 1.0
    dtype: Optional[str] = None  # override model dtype (e.g. fp32 for norms)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def leaves(tree) -> list:
    """The leaves in ``jax.tree.flatten``'s order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def stack(schema: Any, n: int) -> Any:
    """Add a leading (layer) dimension to every ParamDef in a tree."""
    return tree_map(lambda d: ParamDef((n,) + tuple(d.shape),
                                       (None,) + tuple(d.axes), d.init,
                                       d.scale, d.dtype), schema)


# an fp32 draw larger than this many elements is made in slices
SLICE_ELEMENTS = 1 << 28


def _draw(d: ParamDef, shape: tuple, fan_in: int, gen: torch.Generator,
          dt: torch.dtype, device) -> torch.Tensor:
    """``d``'s recipe drawn in fp32 at ``shape`` and cast to ``dt``."""
    f32 = torch.float32
    normal = lambda: torch.randn(shape, generator=gen, dtype=f32,
                                 device=device)
    uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(
        shape, generator=gen, dtype=f32, device=device)
    if d.init == "fan_in":
        return (normal() * d.scale / math.sqrt(fan_in)).to(dt)
    if d.init == "embed":
        return (normal() * d.scale * 0.02).to(dt)
    if d.init == "normal":
        return (normal() * d.scale).to(dt)
    if d.init == "mamba_A":   # A_log: log of Uniform(1, 16)
        return torch.log(uniform(1.0, 16.0)).to(dt)
    if d.init == "dt_bias":   # softplus^-1 of Uniform(1e-3, 1e-1)
        u = uniform(1e-3, 1e-1)
        return (u + torch.log(-torch.expm1(-u))).to(dt)
    if d.init == "small":
        return (normal() * d.scale * 1e-2).to(dt)
    raise ValueError(f"unknown init {d.init}")


def _init_one(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
              device) -> torch.Tensor:
    dt = DTYPES[d.dtype] if d.dtype else dtype
    shape = tuple(int(s) for s in d.shape)
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if math.prod(shape) <= SLICE_ELEMENTS:
        return _draw(d, shape, fan_in, gen, dt, device)
    rows = max(1, SLICE_ELEMENTS // math.prod(shape[1:]))
    out = torch.empty(shape, dtype=dt, device=device)
    for i in range(0, shape[0], rows):
        n = min(rows, shape[0] - i)
        out[i:i + n] = _draw(d, (n,) + shape[1:], fan_in, gen, dt, device)
    return out


def init_params(schema: Any, gen: torch.Generator, dtype=torch.float32,
                device="cuda") -> Any:
    """Materialize ``schema`` on ``device``, drawing every leaf from
    ``gen`` (a ``torch.Generator`` on that device) in the reference's
    flatten order; leaves without a dtype of their own take ``dtype``.
    The numbers differ from the reference's ``jax.random`` draws; parity
    runs carry the reference's params across with ``convert.to_torch``."""
    dev = resolve_device(device)
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]

    def build(t):
        if not isinstance(t, dict):
            return _init_one(t, gen, dtype, dev)
        made = {k: build(t[k]) for k in sorted(t)}
        return {k: made[k] for k in t}
    return build(schema)


def param_count(schema: Any) -> int:
    return int(sum(math.prod(d.shape) for d in leaves(schema)))
