"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the serving path's shapes, within the reference's pinned bounds
(``benchmarks/kernelbench.py``: 1e-4 lane-MLP forward, 1e-5 int8 matmul).

Marked ``gpu``; each test decides inside itself whether a card exists and
skips without one.  Imports nothing of JAX, so it runs on a machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import lane_mlp, ops, ref
from repro_torch.serve import quant

# Table-3 encoders on the serving path: (din, h, dz)
ENCODERS = {"g1_active": (5, 64, 128), "g3": (5, 256, 256),
            "g2": (384, 256, 256)}
# the quantized active path's three layers: (d, c, act)
INT8_LAYERS = {"l0_selu": (5, 256, "selu"), "l1": (256, 256, "none"),
               "head4": (256, 4, "none"), "head2": (256, 2, "none")}
BATCHES = (16, 77, 256, 4096)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _mlp(seed, B, din, h, dz, dev, lanes=()):
    rng = np.random.RandomState(seed)
    return [t.to(dev) for t in (
        _randn(rng, *lanes, B, din), _randn(rng, *lanes, din, h,
                                            scale=din ** -0.5),
        _randn(rng, *lanes, h, scale=0.1),
        _randn(rng, *lanes, h, dz, scale=h ** -0.5),
        _randn(rng, *lanes, dz, scale=0.1))]


def _maxerr(a, b):
    torch.cuda.synchronize()
    return float((a - b).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ENCODERS))
def test_lane_mlp_fwd_matches_plain_on_card(name):
    dev = _card()
    for B in BATCHES:
        arrs = _mlp(B, B, *ENCODERS[name], dev)
        for fa in (False, True):
            got = ops.fused_mlp2(*arrs, final_act=fa)
            want = ref.mlp2_ref(*arrs, final_act=fa)
            assert _maxerr(got, want) <= 1e-4, (name, B, fa)


@pytest.mark.gpu
def test_lane_mlp_fwd_lane_axis_and_saved_preacts_on_card():
    dev = _card()
    xs, w0s, b0s, w1s, b1s = _mlp(1, 77, 384, 256, 256, dev, lanes=(3,))
    out, a1, a2 = lane_mlp.launch(xs, w0s, b0s, w1s, b1s, final_act=True,
                                  save=True)
    a1_ref = xs @ w0s + b0s[:, None]
    a2_ref = ref.selu(a1_ref) @ w1s + b1s[:, None]
    assert _maxerr(a1, a1_ref) <= 1e-4
    assert _maxerr(a2, a2_ref) <= 1e-4
    assert _maxerr(out, ref.selu(a2_ref)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("layer", list(INT8_LAYERS))
def test_int8_matmul_matches_plain_on_card(layer):
    dev = _card()
    d, c, act = INT8_LAYERS[layer]
    for B in BATCHES:
        rng = np.random.RandomState(B + d)
        w_q, scale = quant.quantize_weight(_randn(rng, d, c,
                                                  scale=d ** -0.5))
        x, b = _randn(rng, B, d).to(dev), _randn(rng, c, scale=0.1).to(dev)
        w_q, scale = torch.from_numpy(w_q).to(dev), \
            torch.from_numpy(scale).to(dev)
        got = ops.int8_matmul(x, w_q, scale, b, act=act)
        want = ref.int8_matmul_ref(x, w_q, scale, b)
        want = ref.selu(want) if act == "selu" else want
        assert _maxerr(got, want) <= 1e-5, (layer, B)


@pytest.mark.gpu
def test_wrappers_count_launches_on_card():
    dev = _card()
    arrs = _mlp(0, 16, 5, 64, 128, dev)
    ops.reset_launches()
    ops.fused_mlp2(*arrs)
    x = arrs[0]
    w_q = torch.ones((5, 4), dtype=torch.int8, device=dev)
    ops.int8_matmul(x, w_q, torch.ones(4, device=dev),
                    torch.zeros(4, device=dev))
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"lane_mlp_fwd": 1, "int8_matmul": 1}
