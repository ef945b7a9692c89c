"""Carrying parameters and checkpoints between the JAX package and the
port: ``repro_torch.convert`` (numpy tree <-> tensors) and the jax-free
``repro_torch.checkpoint.ckpt`` (the same flat-path .npz + .json format)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import autoencoder as jae
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import autoencoder as tae


def _jax_params(seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {role: jax.tree.map(np.asarray, jae.init_autoencoder(
        k, jae.table3_encoder(role, d)))
        for k, (role, d) in zip(ks, (("g3", 5), ("g1_active", 5),
                                     ("g2", 384)))}


def _tree_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_carry_across_round_trip_is_exact_and_encodes_alike():
    params = _jax_params()
    t = convert.to_torch(params, device="cpu")
    assert t["g2"]["enc"]["w0"].shape == (384, 256)   # (d_in, d_out)
    assert t["g3"]["enc"]["w0"].dtype == torch.float32
    assert _tree_equal(convert.to_numpy(t), params)
    x = np.random.RandomState(0).randn(33, 5).astype(np.float32)
    for role in ("g3", "g1_active"):
        got = tae.encode(t[role], torch.from_numpy(x)).numpy()
        fused = tae.fused_encode(t[role], torch.from_numpy(x)).numpy()
        want = np.asarray(jae.encode(params[role], jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        np.testing.assert_allclose(fused, want, atol=2e-5, rtol=0)
    dec = tae.reconstruct(t["g3"], torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        dec, np.asarray(jae.reconstruct(params["g3"], jnp.asarray(x))),
        atol=2e-5, rtol=0)


def test_to_torch_makes_floats_fp32_and_keeps_integer_leaves():
    tree = {"w": np.ones((2, 3), np.float64),
            "ids": np.asarray([1, 1 << 40], np.int64)}
    t = convert.to_torch(tree, device="cpu")
    assert t["w"].dtype == torch.float32
    assert t["ids"].dtype == torch.int64 and int(t["ids"][1]) == 1 << 40


def test_to_torch_float_dtype_keeps_bf16_leaves_bit_for_bit():
    """``float_dtype=None`` keeps each floating leaf's dtype: an LM's bf16
    weights (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    cross as ``torch.bfloat16`` beside fp32 norm scales; the default still
    makes floats fp32."""
    import ml_dtypes
    w = np.asarray([[1.5, -2.25], [3e-3, 7.0]], ml_dtypes.bfloat16)
    tree = {"w": w, "scale": np.ones(2, np.float32),
            "ids": np.arange(3, dtype=np.int64)}
    t = convert.to_torch(tree, device="cpu", float_dtype=None)
    assert t["w"].dtype == torch.bfloat16
    assert t["scale"].dtype == torch.float32
    assert t["ids"].dtype == torch.int64
    assert np.array_equal(t["w"].view(torch.int16).numpy().view(np.uint16),
                          w.view(np.uint16))
    assert convert.to_torch(tree, device="cpu")["w"].dtype == torch.float32
    assert convert.to_torch(tree, device="cpu", float_dtype=torch.bfloat16
                            )["scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_packages(tmp_path, direction):
    tree = {"model": _jax_params()["g1_active"],
            "cache": {"ids": np.asarray([5, 7, 1 << 40], np.int64),
                      "z": np.arange(6, dtype=np.float32).reshape(3, 2)}}
    path = str(tmp_path / "t")
    save, load = ((jckpt.save, tckpt.load_tree)
                  if direction == "jax_to_port"
                  else (tckpt.save, jckpt.load_tree))
    save(path, tree, step=3, meta={"k": 1})
    got, side = load(path)
    assert side["step"] == 3 and side["meta"] == {"k": 1}
    assert _tree_equal(got, tree)                  # int64 ids survive


def test_port_ckpt_saves_tensors_like_arrays(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.int64),
            "b": {"w": torch.ones(2, 2)}}
    tckpt.save(str(tmp_path / "x"), tree)
    got, side = jckpt.load_tree(str(tmp_path / "x"))
    assert side["dtypes"] == {"a": "int64", "b/w": "float32"}
    assert np.array_equal(got["a"], np.arange(4))


def test_init_autoencoder_is_seeded_lecun_normal():
    widths = tae.table3_encoder("g2", 384)
    a = tae.init_autoencoder(torch.Generator().manual_seed(0), widths,
                             device="cpu")
    b = tae.init_autoencoder(torch.Generator().manual_seed(0), widths,
                             device="cpu")
    assert _tree_equal(convert.to_numpy(a), convert.to_numpy(b))
    assert a["enc"]["w0"].shape == (384, 256)
    assert a["dec"]["w1"].shape == (256, 384)
    assert float(a["enc"]["b0"].abs().max()) == 0.0
    std = float(a["enc"]["w0"].std())
    assert abs(std * np.sqrt(384) - 1.0) < 0.05
