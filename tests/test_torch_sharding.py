"""The port's sharding policy (``repro_torch.sharding.policy``) and
``serve.decode.cache_pspecs`` against the live JAX package's: every
``ParamDef`` of every registry config resolved, divided and counted the
same way on the production meshes, through stand-in meshes with more
devices than the host has (``tests/test_sharding.py``'s ``_FakeMesh``),
and the ``DTensor`` placements a spec turns into."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.serve import decode as jdecode
from repro.sharding import policy as jpolicy
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.serve import decode as tdecode
from repro_torch.sharding import policy as tpolicy

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


class JaxMesh:
    """The reference's stand-in: ``_divisible`` reads ``axis_names`` and
    ``devices.shape`` only."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


class TorchMesh:
    """The port's: ``mesh_dim_names`` and ``shape``."""

    def __init__(self, shape, axes):
        self.mesh_dim_names = axes
        self.shape = shape


def _pairs(arch):
    """(reference ParamDef, port ParamDef) in flatten order."""
    js = jax.tree.leaves(JM.schema(jget_config(arch)), is_leaf=jpolicy.is_def)
    ts = tpolicy.leaves(TM.schema(get_config(arch)))
    assert len(js) == len(ts)
    return list(zip(js, ts))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference_for_every_param(arch, mesh):
    shape, axes = MESHES[mesh]
    jm, tm = JaxMesh(shape, axes), TorchMesh(shape, axes)
    for jd, td in _pairs(arch):
        assert (tuple(jd.shape), tuple(jd.axes), jd.init, jd.dtype) == (
            tuple(td.shape), tuple(td.axes), td.init, td.dtype)
        want = jpolicy.resolve(jd.axes, axes)
        got = tpolicy.resolve(td.axes, axes)
        assert got == tuple(want)
        assert tpolicy._divisible(td.shape, got, tm) == tuple(
            jpolicy._divisible(jd.shape, want, jm))
        # shard shape: each dim over the mesh sizes of its axes, exactly
        spec = tpolicy._divisible(td.shape, got, tm)
        local = tpolicy.local_shape(td.shape,
                                     tpolicy.placements(spec, tm), tm)
        sizes = dict(zip(axes, shape))
        for dim, loc, ent in zip(td.shape, local, spec):
            names = () if ent is None else (
                ent if isinstance(ent, tuple) else (ent,))
            assert loc * int(np.prod([sizes[n] for n in names])) == dim
    assert tpolicy.batch_pspec(axes) == jpolicy.batch_pspec(axes)
    assert tpolicy.batch_pspec(("lane", "data")) == "data"
    jtree = jpolicy.pspec_tree(JM.schema(jget_config(arch)), axes)
    assert tpolicy.leaves(tpolicy.pspec_tree(
        TM.schema(get_config(arch)), axes)) == [
        tuple(x) for x in jax.tree.leaves(
            jtree, is_leaf=lambda x: isinstance(x, P))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_reference(arch):
    cfg = get_config(arch)
    jabs = jax.tree.leaves(jpolicy.abstract_params(
        JM.schema(jget_config(arch)), DTYPES[cfg.dtype]))
    tabs = tpolicy.leaves(tpolicy.abstract_params(TM.schema(cfg), cfg.dtype))
    assert len(jabs) == len(tabs)
    for j, t in zip(jabs, tabs):
        assert t.is_meta and tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)


def test_full_config_tp_and_ep_dims_divide_16():
    """Every full-size param sharded on tp / ep divides the 16-wide model
    axis (``tests/test_sharding.py``): the production mesh shards them."""
    for arch in ["internlm2-20b", "kimi-k2-1t-a32b", "qwen3-moe-30b-a3b",
                 "zamba2-2.7b", "nemotron-4-15b"]:
        for d in tpolicy.leaves(TM.schema(get_config(arch))):
            for dim, ax in zip(d.shape, d.axes):
                if ax in ("tp", "ep"):
                    assert dim % 16 == 0, (arch, d.shape, d.axes)


def test_resolve_and_divisible_cases():
    axes = ("pod", "data", "model")
    assert tpolicy.resolve(("dp", None), axes) == (("pod", "data"), None)
    assert tpolicy.resolve(("ep", "fsdp", None), axes) == (
        ("pod", "model"), "data", None)
    assert tpolicy.resolve(("lane", "dp"), ("lane", "data")) == (
        "lane", "data")
    m = TorchMesh((4, 2), ("lane", "data"))
    assert tpolicy._divisible((6, 10), ("lane", "data"), m) == (None, "data")
    assert tpolicy._divisible((8, 5, 3), ("lane",), TorchMesh(
        (4,), ("lane",))) == ("lane", None, None)


def test_placements_keep_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = TorchMesh((2, 16, 16), ("pod", "data", "model"))
    assert tpolicy.placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert tpolicy.placements((None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        tpolicy.placements((("model", "pod"),), m)
    tree = tpolicy.sharding_tree(
        {"w": tpolicy.ParamDef((6, 32), ("fsdp", "tp"))},
        TorchMesh((4, 16), ("data", "model")))
    # 6 rows do not divide the data axis: only the columns shard
    assert tree["w"] == (Replicate(), Shard(1))


def test_cache_pspecs_sharding_choices():
    """``tests/test_sharding.py``'s cache: the batch on data; the kv heads
    (8) do not divide 16, so the slots dim goes to model."""
    cache = {"k": torch.empty((48, 128, 32768, 8, 128), dtype=torch.bfloat16,
                              device="meta")}
    jcache = {"k": jax.ShapeDtypeStruct((48, 128, 32768, 8, 128),
                                        jnp.bfloat16)}
    for shape, axes in MESHES.values():
        got = tdecode.cache_pspecs(cache, TorchMesh(shape, axes), batch=128)
        want = jdecode.cache_pspecs(jcache, JaxMesh(shape, axes), batch=128)
        assert got["k"] == tuple(want["k"])
    assert got["k"] == (None, ("pod", "data"), "model", None, None)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-2.7b",
                                  "xlstm-350m", "llama-3.2-vision-11b"])
def test_cache_pspecs_match_reference_on_the_decode_caches(arch):
    """The families' own decode caches at decode_32k, built from shapes
    alone on both sides, get the same specs leaf by leaf."""
    from repro.configs.base import INPUT_SHAPES
    from repro.launch import dryrun as jdry
    shape = INPUT_SHAPES["decode_32k"]
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jparams = jpolicy.abstract_params(JM.schema(jcfg),
                                      DTYPES[jcfg.dtype])
    jc = jdry._abstract_cache(jparams, jcfg, shape)
    tparams = tpolicy.abstract_params(TM.schema(tcfg), tcfg.dtype)
    B, slots = shape.global_batch, tdecode.n_cache_slots(tcfg, shape)
    kw = {}
    if tcfg.family == "vlm":
        kw["image_embeds"] = torch.empty(
            (B, tcfg.n_image_tokens, tcfg.d_model), dtype=torch.bfloat16,
            device="meta")
    tc = TM.init_cache(tparams, tcfg, B, slots, **kw)
    for shape_, axes in MESHES.values():
        want = jax.tree.leaves(
            jdecode.cache_pspecs(jc, JaxMesh(shape_, axes), B),
            is_leaf=lambda x: isinstance(x, P))
        got = [s for s in _spec_leaves(tdecode.cache_pspecs(
            tc, TorchMesh(shape_, axes), B))]
        assert got == [tuple(w) for w in want]


def _spec_leaves(x):
    if isinstance(x, dict):
        return [s for k in sorted(x) for s in _spec_leaves(x[k])]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [s for v in x for s in _spec_leaves(v)]
    if isinstance(x, list):
        return [s for v in x for s in _spec_leaves(v)]
    return [x]
