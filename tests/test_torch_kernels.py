"""The port's kernel wrappers (``repro_torch.kernels.ops``) against the JAX
package's Pallas kernels (interpret mode) and its ``kernels/ref.py``
oracles, on the same numpy-seeded inputs.

On the CPU the wrappers take their plain PyTorch versions, so these tests
pin the arithmetic the CUDA kernels are held to on the card
(``tests/test_torch_gpu.py`` compares the CUDA kernels with those plain
versions there).  Tolerance 2e-5 max-abs: the torch and JAX CPU
forwards differ by float reassociation only (<= 2e-6 at these widths).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.int8_matmul import int8_matmul as jax_int8_matmul
from repro.kernels.lane_mlp import fused_mlp2 as jax_fused_mlp2
from repro.serve import quant as jquant
from repro_torch.kernels import _build, int8_matmul, lane_mlp, ops, ref
from repro_torch.serve import quant as tquant

TOL = 2e-5
# Table-3 encoders on the serving path: (din, h, dz)
ENCODERS = {"g1_active": (5, 64, 128), "g3": (5, 256, 256),
            "g2": (384, 256, 256)}
# the quantized active path's three layers: (d, c, act)
INT8_LAYERS = {"l0_selu": (5, 256, "selu"), "l1": (256, 256, "none"),
               "head4": (256, 4, "none"), "head2": (256, 2, "none")}


def _mlp_arrays(seed, B, din, h, dz, lanes=None):
    rng = np.random.RandomState(seed)
    pre = () if lanes is None else (lanes,)
    f = lambda *s, scale=1.0: (rng.randn(*pre, *s) * scale).astype(
        np.float32)
    return (f(B, din), f(din, h, scale=din ** -0.5), f(h, scale=0.1),
            f(h, dz, scale=h ** -0.5), f(dz, scale=0.1))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B", [1, 77, 200])
@pytest.mark.parametrize("name", list(ENCODERS))
def test_mlp2_matches_jax_kernel_and_oracle(name, B):
    arrs = _mlp_arrays(B, B, *ENCODERS[name])
    got = ops.fused_mlp2(*_t(arrs)).numpy()
    kern = np.asarray(jax_fused_mlp2(*map(jnp.asarray, arrs),
                                     interpret=True))
    oracle = np.asarray(jref.mlp2_ref(*map(jnp.asarray, arrs)))
    assert got.shape == (B, ENCODERS[name][2])
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=TOL, rtol=0)


def test_mlp2_final_act_matches_jax():
    arrs = _mlp_arrays(5, 77, *ENCODERS["g3"])
    got = ops.fused_mlp2(*_t(arrs), final_act=True).numpy()
    kern = np.asarray(jax_fused_mlp2(*map(jnp.asarray, arrs),
                                     final_act=True, interpret=True))
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)


def test_selu_is_the_expm1_form_of_jax():
    a = np.linspace(-8, 8, 1001).astype(np.float32)
    got = ref.selu(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.selu(a)),
                               atol=1e-6, rtol=1e-6)


def _int8_arrays(seed, B, d, c):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, d).astype(np.float32)
    w_q, scale = tquant.quantize_weight(
        (rng.randn(d, c) * d ** -0.5).astype(np.float32))
    b = (rng.randn(c) * 0.1).astype(np.float32)
    return x, w_q, scale, b


@pytest.mark.parametrize("B", [1, 77, 200])
@pytest.mark.parametrize("layer", list(INT8_LAYERS))
def test_int8_matmul_matches_jax_kernel_and_oracle(layer, B):
    d, c, act = INT8_LAYERS[layer]
    arrs = _int8_arrays(B + d, B, d, c)
    got = ops.int8_matmul(*_t(arrs), act=act).numpy()
    kern = np.asarray(jax_int8_matmul(*map(jnp.asarray, arrs), act=act,
                                      interpret=True))
    oracle = jref.int8_matmul_ref(*map(jnp.asarray, arrs))
    oracle = np.asarray(jax.nn.selu(oracle) if act == "selu" else oracle)
    assert got.shape == (B, c)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=TOL, rtol=0)


def test_quantize_weight_bit_identical_to_jax_package():
    rng = np.random.RandomState(3)
    w = (rng.randn(256, 64) * rng.rand(64)[None, :]).astype(np.float32)
    w[:, 5] = 0.0                                 # zero column -> scale 1
    tq, ts = tquant.quantize_weight(torch.from_numpy(w))
    jq, js = jquant.quantize_weight(w)
    assert tq.dtype == np.int8 and np.array_equal(tq, jq)
    assert np.array_equal(ts, js)
    assert np.array_equal(tquant.dequantize_weight(tq, ts),
                          jquant.dequantize_weight(jq, js))


def test_int8_matmul_rejects_bad_inputs():
    x, w_q, scale, b = _t(_int8_arrays(0, 8, 4, 2))
    with pytest.raises(TypeError, match="int8"):
        ops.int8_matmul(x, w_q.to(torch.float32), scale, b)
    with pytest.raises(ValueError, match="act"):
        ops.int8_matmul(x, w_q, scale, b, act="gelu")


def test_wrappers_refuse_devices_without_a_path():
    x = torch.empty((4, 5), device="meta")
    w0, b0 = torch.empty((5, 8)), torch.empty((8,))
    with pytest.raises(ValueError, match="meta"):
        ops.fused_mlp2(x, w0, b0, torch.empty((8, 3)), torch.empty((3,)))
    with pytest.raises(ValueError, match="meta"):
        ops.int8_matmul(x, torch.empty((5, 3), dtype=torch.int8),
                        torch.empty((3,)), torch.empty((3,)))


def test_launchers_refuse_cpu_tensors_and_cpu_path_never_counts():
    arrs = _t(_mlp_arrays(0, 4, 5, 8, 3, lanes=1))
    with pytest.raises(ValueError, match="CUDA"):
        lane_mlp.launch(*arrs)
    x, w_q, scale, b = _t(_int8_arrays(0, 4, 5, 3))
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul.launch(x, w_q, scale, b)
    before = dict(ops.LAUNCHES)
    ops.fused_mlp2(*[a[0] for a in arrs])
    ops.int8_matmul(x, w_q, scale, b)
    assert ops.LAUNCHES == before                # plain path: no launches


def test_build_flags_and_missing_nvcc(monkeypatch):
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-shared" in flags
    for name in _build.SOURCES:
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as fh:
            assert "Replaces: repro/kernels/" in fh.read()
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
