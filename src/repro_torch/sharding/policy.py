"""Parameter schema and logical-axis sharding policy: the port of
``repro.sharding.policy``.

Every model module describes its parameters as a dict tree of
:class:`ParamDef` (shape, logical axes, init recipe).  The same schema
drives:

* ``init_params``     -- materialize it as tensors on a device,
* ``param_count``     -- count it without allocating,
* ``pspec_tree``      -- one spec a leaf (below),
* ``sharding_tree``   -- one ``DTensor`` placement list a leaf, for a mesh,
* ``abstract_params`` -- ``meta`` tensors in place of the reference's
  ``ShapeDtypeStruct`` stand-ins (the dry run's parameters).

A spec is a tuple with one entry per tensor dim: ``None`` (replicated),
a mesh axis name, or a tuple of names (a dim split over several mesh
axes, major to minor): the content of the reference's ``P(...)``, so
``tuple(P)`` compares with it directly.  ``placements(spec, mesh)`` turns
a spec into one ``Shard``/``Replicate`` a MESH dim; it is the only place
that knows ``DTensor``.  A mesh here is anything with ``mesh_dim_names``
and ``shape`` (``torch.distributed.device_mesh.DeviceMesh``).

Logical axes (resolved per mesh):
  ``dp``    batch / data parallel          -> ("pod","data") or ("data",)
  ``fsdp``  fully-sharded param dim        -> ("data",)
  ``tp``    tensor parallel dim            -> ("model",)
  ``ep``    expert parallel dim            -> ("pod","model") or ("model",)
  ``vocab`` vocabulary dim                 -> ("model",)
  ``lane``  replica-lane dim (the VFL lane -> ("lane",)
            engine's stacked leading axis,
            meshes from launch.mesh.make_lane_mesh)
  ``None``  replicated

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


# ---------------------------------------------------------------------------
# logical axes -> mesh specs -> DTensor placements
# ---------------------------------------------------------------------------

def _rules(mesh_axes: tuple) -> dict:
    multi_pod = "pod" in mesh_axes
    return {
        "dp": ("pod", "data") if multi_pod else ("data",),
        "fsdp": ("data",),
        "tp": ("model",),
        "ep": ("pod", "model") if multi_pod else ("model",),
        "vocab": ("model",),
        "lane": ("lane",),
        None: None,
    }


def resolve(axes: tuple, mesh_axes: tuple) -> tuple:
    """Logical axes -> a spec (one entry a dim)."""
    r = _rules(tuple(mesh_axes))
    out = []
    for a in axes:
        v = r[a]
        out.append(None if v is None else v[0] if len(v) == 1 else v)
    return tuple(out)


def mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _divisible(shape, spec: tuple, mesh) -> tuple:
    """Drop sharding on dims the mesh does not divide evenly (smoke
    configs, odd head counts), as the reference does: ``DTensor`` would
    shard them unevenly, and the shard bytes would no longer match."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if entry is None:
            out.append(None)
            continue
        total = math.prod(sizes.get(n, 1) for n in _names(entry))
        out.append(entry if total > 0 and dim % total == 0 else None)
    return tuple(out)


def pspec_tree(schema: Any, mesh_axes: tuple) -> Any:
    return tree_map(lambda d: resolve(d.axes, mesh_axes), schema)


def batch_pspec(mesh_axes: tuple) -> Any:
    """Spec entry for a global-batch dimension."""
    r = _rules(tuple(mesh_axes))["dp"]
    return r if len(r) > 1 else r[0]


def placements(spec: tuple, mesh) -> tuple:
    """A spec as one ``Shard(d)`` or ``Replicate()`` a mesh dim.  A dim
    split over several mesh axes lists them major to minor, in the mesh's
    own order, which is the order ``DTensor`` shards a tensor dim split
    over several mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    axes = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in axes]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = _names(entry)
        pos = [axes.index(n) for n in names]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of "
                             f"the mesh's order {axes}")
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, placements: tuple, mesh) -> tuple:
    """The per-rank shard shape of a tensor of ``shape`` under
    ``placements`` (which ``_divisible`` has made even)."""
    out = list(shape)
    for n, p in zip(tuple(mesh.shape), placements):
        if p.is_shard():
            out[p.dim] //= n
    return tuple(out)


def sharding_tree(schema: Any, mesh) -> Any:
    """One placement tuple a leaf, after ``_divisible``."""
    return tree_map(lambda d: placements(
        _divisible(d.shape, resolve(d.axes, mesh.mesh_dim_names), mesh),
        mesh), schema)


def abstract_params(schema: Any, dtype=torch.bfloat16) -> Any:
    """``meta`` tensors of each leaf's shape and dtype: no memory."""
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    return tree_map(lambda d: torch.empty(
        tuple(int(s) for s in d.shape),
        dtype=DTYPES[d.dtype] if d.dtype else dtype, device="meta"), schema)
