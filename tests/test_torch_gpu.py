"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the serving and training paths' shapes, within the reference's
pinned bounds (``benchmarks/kernelbench.py``: 1e-4 lane-MLP forward,
1e-5 relative lane-MLP gradients, 1e-5 int8 matmul and Eq. 5 rows, 1e-4
probe step; ``tests/test_kernels.py``: 2e-5 fp32 and 3e-2 bf16 attention,
2e-4 the SSD intra-chunk block), and the zamba2 hybrid's serving path.

Marked ``gpu``; each test decides inside itself whether a card exists and
skips without one.  Imports nothing of JAX, so it runs on a machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import hashlib
import itertools
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import lane_mlp, ops, ref
from repro_torch.serve import quant

# chip_smoke.py, for its shape sets (it imports neither JAX nor a card)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

# Table-3 encoders on the serving path: (din, h, dz)
ENCODERS = {"g1_active": (5, 64, 128), "g3": (5, 256, 256),
            "g2": (384, 256, 256)}
# the eight Table-3 autoencoder MLPs trained at mimic3 widths: (din, h, dz)
AE_SHAPES = {"g1_active.enc": (5, 64, 128), "g1_active.dec": (128, 64, 5),
             "g1_passive.enc": (10, 128, 256),
             "g1_passive.dec": (256, 128, 10),
             "g2.enc": (384, 256, 256), "g2.dec": (256, 256, 384),
             "g3.enc": (5, 256, 256), "g3.dec": (256, 256, 5)}
# the quantized active path's three layers: (d, c, act)
INT8_LAYERS = {"l0_selu": (5, 256, "selu"), "l1": (256, 256, "none"),
               "head4": (256, 4, "none"), "head2": (256, 2, "none")}
BATCHES = (16, 77, 256, 4096)
# the lane-MLP forward's rows: one row, ragged tiles, the serving buckets,
# the training batch and the 20000 rows core/pipeline.py encodes in a call
FWD_BATCHES = (1, 7, 16, 77, 128, 256, 4096, 20000)


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


def _scalederr(a, b):
    """max|a - b| over max|b| where that lies below 1, else over 1
    (chip_smoke.py's ``_scalederr``): the relative error of gradients that
    carry a factor 1/N."""
    torch.cuda.synchronize()
    scale = min(max(float(b.abs().max()), torch.finfo(torch.float32).tiny),
                1.0)
    return float((a - b).abs().max()) / scale


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ENCODERS))
def test_lane_mlp_fwd_matches_plain_on_card(name):
    dev = _card()
    for B in FWD_BATCHES:
        arrs = _mlp(B, B, *ENCODERS[name], dev)
        for fa in (False, True):
            got = ops.fused_mlp2(*arrs, final_act=fa)
            want = ref.mlp2_ref(*arrs, final_act=fa)
            assert _maxerr(got, want) <= 1e-4, (name, B, fa)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(AE_SHAPES))
def test_lane_mlp_fwd_lanes_save_and_final_act_on_card(name):
    """Each training MLP (wide and narrow outputs: h 64-256, dz 5-384) over
    one and two lanes, with and without the saved pre-activations and the
    final SELU, at a ragged tile and the training batch."""
    dev = _card()
    for L, B in itertools.product((1, 2), (7, 128)):
        arrs = _mlp(L * B, B, *AE_SHAPES[name], dev, lanes=(L,))
        for fa, save in itertools.product((False, True), (False, True)):
            got = lane_mlp.launch(*arrs, final_act=fa, save=save)
            want = ref.mlp2_fwd_ref(*arrs, final_act=fa)
            if not save:
                got, want = (got,), want[:1]
            for g, w in zip(got, want):
                assert _maxerr(g, w) <= 1e-4, (name, L, B, fa, save)


@pytest.mark.gpu
def test_lane_mlp_fwd_repeats_bit_for_bit_on_card():
    """No atomics and a fixed sum order: two launches give the same bits,
    at a batch split over clusters of 8 blocks and at one of 1."""
    dev = _card()
    for B in (256, 20000):
        arrs = _mlp(5, B, 384, 256, 256, dev)
        runs = [ops.fused_mlp2(*arrs, final_act=True) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(*runs), B


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


def _sha256(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def _relerr(a, b):
    torch.cuda.synchronize()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(AE_SHAPES))
def test_lane_mlp_bwd_matches_plain_on_card(name):
    dev = _card()
    for B, fa in ((1, False), (77, True), (128, False), (2000, False)):
        *arrs, = _mlp(B, B, *AE_SHAPES[name], dev, lanes=(1,))
        g = _randn(np.random.RandomState(B), 1, B, AE_SHAPES[name][2]).to(dev)
        _, a1, a2 = lane_mlp.launch(*arrs, final_act=fa, save=True)
        got = lane_mlp.launch_bwd(g, arrs[0], a1, a2, arrs[1], arrs[3],
                                  final_act=fa)
        want = ref.mlp2_bwd_ref(g, arrs[0], a1, a2, arrs[1], arrs[3], fa)
        for a, b in zip(got, want):
            assert _relerr(a, b) <= 1e-5, (name, B)


@pytest.mark.gpu
def test_lane_mlp_grads_through_function_with_dead_lane_on_card():
    dev = _card()
    arrs = [t.requires_grad_(True)
            for t in _mlp(3, 77, 256, 256, 384, dev, lanes=(3,))]
    live = torch.tensor([1.0, 0.0, 1.0], device=dev)
    g = _randn(np.random.RandomState(4), 3, 77, 384).to(dev)
    out = ops.fused_lane_mlp2(*arrs, live)
    got = torch.autograd.grad(torch.sum(out * g), arrs)
    cpu = [t.detach().cpu().requires_grad_(True) for t in arrs]
    out_c = ops.fused_lane_mlp2(*cpu, live.cpu())
    want = torch.autograd.grad(torch.sum(out_c * g.cpu()), cpu)
    for i, (a, b) in enumerate(zip(got, want)):
        e = _relerr(a.cpu(), b)
        # which side's bits moved, should it fail again: each gradient's
        # SHA-256 on the card and on the CPU (one set of each in 200
        # processes, tools/lane_mlp_hazard.py)
        assert e <= 1e-5, (i, e, _sha256(a), _sha256(b))
        assert not bool(a[1].any())


@pytest.mark.gpu
def test_lane_mlp_grads_through_function_repeat_bit_for_bit_on_card():
    """The dead-lane case above through autograd three times on the card:
    the forward and backward kernels give the same bits every run."""
    dev = _card()
    arrs = [t.requires_grad_(True)
            for t in _mlp(3, 77, 256, 256, 384, dev, lanes=(3,))]
    live = torch.tensor([1.0, 0.0, 1.0], device=dev)
    g = _randn(np.random.RandomState(4), 3, 77, 384).to(dev)
    runs = [torch.autograd.grad(
        torch.sum(ops.fused_lane_mlp2(*arrs, live) * g), arrs)
        for _ in range(3)]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


def _bwd_case(seed, L, B, din, h, dz, dev, final_act=False):
    """Inputs of ``launch_bwd``: the forward's, its saved pre-activations
    (from the forward kernel) and an output cotangent, with L lanes."""
    xs, w0s, b0s, w1s, b1s = _mlp(seed, B, din, h, dz, dev, lanes=(L,))
    _, a1, a2 = lane_mlp.launch(xs, w0s, b0s, w1s, b1s,
                                final_act=final_act, save=True)
    g = _randn(np.random.RandomState(seed + 1), L, B, dz).to(dev)
    return g, xs, a1, a2, w0s, w1s


@pytest.mark.gpu
def test_lane_mlp_bwd_repeats_bit_for_bit_on_card():
    """No atomics and fixed sum orders: two backwards give the same bits,
    at the training batch and over many 128-row chunks."""
    dev = _card()
    for B, fa in ((128, False), (2000, True)):
        args = _bwd_case(B, 1, B, 256, 256, 384, dev, fa)
        runs = [lane_mlp.launch_bwd(*args, final_act=fa) for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b), B


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["g1_active.enc", "g2.enc", "g3.dec"])
def test_lane_mlp_bwd_without_dx_on_card(name):
    """need_dx=False leaves the dx tiles out and changes nothing else: one
    row, a ragged tile and many tiles with a ragged tail."""
    dev = _card()
    for B in (1, 77, 2000):
        args = _bwd_case(B, 1, B, *AE_SHAPES[name], dev)
        full = lane_mlp.launch_bwd(*args)
        got = lane_mlp.launch_bwd(*args, need_dx=False)
        want = ref.mlp2_bwd_ref(*args)
        torch.cuda.synchronize()
        assert got[0] is None
        for a, b, w in zip(got[1:], full[1:], want[1:]):
            assert torch.equal(a, b), (name, B)
            assert _relerr(a, w) <= 1e-5, (name, B)


@pytest.mark.gpu
@pytest.mark.parametrize("widths", [(10, 128, 256), (256, 128, 10)])
def test_lane_mlp_bwd_two_lanes_one_dead_on_card(widths):
    """An L = 2 stack at the g1 stage's widths padded to the larger party
    (``padding.pad_stack`` over g1_active and g1_passive): the live lane
    matches its plain version, the dead lane (g = 0) gives exact zeros."""
    dev = _card()
    for B in (77, 128):
        g, *rest = _bwd_case(B, 2, B, *widths, dev)
        g[1] = 0.0
        for fa in (False, True):
            got = lane_mlp.launch_bwd(g, *rest, final_act=fa)
            want = ref.mlp2_bwd_ref(g, *rest, fa)
            for a, w in zip(got, want):
                assert _relerr(a, w) <= 1e-5, (widths, B, fa)
                assert not bool(a[1].any()), (widths, B, fa)


@pytest.mark.gpu
def test_kernels_take_widths_past_the_old_limits_on_card():
    """K streams through shared memory in slabs, so no width is refused:
    the backward at h + dz past the 7264 its rows pass once admitted, the
    int8 matmul at d past its old 7264."""
    dev = _card()
    args = _bwd_case(7, 1, 16, 8, 2000, 5300, dev)
    for a, w in zip(lane_mlp.launch_bwd(*args), ref.mlp2_bwd_ref(*args)):
        assert _relerr(a, w) <= 1e-5
    rng = np.random.RandomState(8)
    w_q, scale = quant.quantize_weight(_randn(rng, 7300, 16,
                                              scale=7300 ** -0.5))
    x, b = _randn(rng, 16, 7300).to(dev), _randn(rng, 16, scale=0.1).to(dev)
    w_q, scale = torch.from_numpy(w_q).to(dev), torch.from_numpy(scale).to(dev)
    got = ops.int8_matmul(x, w_q, scale, b)
    assert _relerr(got, ref.int8_matmul_ref(x, w_q, scale, b)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("c", [2, 4])
def test_int8_matmul_heads_repeat_bit_for_bit_on_card(c):
    """The head at the serving buckets and a ragged batch: within 1e-5 of
    the plain version and the same bits on a second launch."""
    dev = _card()
    rng = np.random.RandomState(c)
    w_q, scale = quant.quantize_weight(_randn(rng, 256, c, scale=1 / 16))
    w_q, scale = torch.from_numpy(w_q).to(dev), torch.from_numpy(scale).to(dev)
    b = _randn(rng, c, scale=0.1).to(dev)
    for B in (1, 16, 77, 256):
        x = _randn(rng, B, 256).to(dev)
        runs = [ops.int8_matmul(x, w_q, scale, b) for _ in range(2)]
        assert _maxerr(runs[0], ref.int8_matmul_ref(x, w_q, scale, b)) \
            <= 1e-5, (c, B)
        assert torch.equal(*runs), (c, B)


# the kernels as they stood before their redesign, built from git into the
# ignored build directory: the redesigns of the backward, int8, the SSD and
# Eq. 5 kept every sum order, so their bits must not move.  A key
# "<source>@<commit>" names that commit's copy of csrc/<source>.cu
BEFORE_REDESIGN = {"lane_mlp_bwd": "ba1cb40fc083caff77ebf5316ec6d49afb092394",
                   # the lane-MLP pair before its narrow route: the
                   # cluster routes alone, at every width
                   "lane_mlp_fwd@7336668":
                       "7336668ca05da8e36954167a3ff839f2c2c38827",
                   "lane_mlp_bwd@7336668":
                       "7336668ca05da8e36954167a3ff839f2c2c38827",
                   "int8_matmul": "ba1cb40fc083caff77ebf5316ec6d49afb092394",
                   "ssd_chunk": "64a7bb6392a75af0ec712db0c0376ad1fab10090",
                   "probe": "64a7bb6392a75af0ec712db0c0376ad1fab10090",
                   "distill_loss": "76aa2af0a07c532c5a7d90895e92cc22dfd38ae0",
                   # flash before its key length of its own: at T = S the
                   # kernel keeps that commit's bits
                   "flash_attention":
                       "1dea1d2980b41282bb87cd42ca6c8f7c193f61c5",
                   # flash's bf16 route on mma.sync, before wgmma and TMA
                   # (the same C interface, T included)
                   "flash_attention@9f296b7":
                       "9f296b7492627a688d09aa2617a3e35f3dbd67b4",
                   # decode before its grouped route: the slots kernel
                   # alone, at every G (the same decode_attention entry)
                   "decode_attention@010a1d7":
                       "010a1d7cdd97d971bcb8aaf7ee5fa4b56392b54f"}


def _library_before(name):
    import ctypes
    import os
    import subprocess
    from repro_torch.kernels import _build
    out = os.path.join(_build.BUILD_DIR, "before")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, f"{name}.cu")
    if not os.path.exists(cu):
        src = subprocess.run(
            ["git", "-C", os.path.dirname(_build.CSRC), "show",
             f"{BEFORE_REDESIGN[name]}:src/repro_torch/kernels/csrc/"
             f"{name.split('@')[0]}.cu"],
            capture_output=True, text=True)
        if src.returncode:
            pytest.skip(f"needs git history (or {cu}) for the kernel "
                        f"before its redesign")
        with open(cu, "w") as fh:
            fh.write(src.stdout)
    so = cu[:-3] + ".so"
    if not os.path.exists(so):
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                        cu], check=True, capture_output=True)
    return ctypes.CDLL(so)


def _bwd_before(lib, g, xs, a1, a2, w0s, w1s, final_act):
    """The backward through the old C interface, as its launcher ran it:
    rows pass, weight partials, then ``sum`` over the tile axis."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lane_mlp_bwd.argtypes = [P] * 14 + [I] * 6 + [P]
    lib.lane_mlp_bwd_tile_rows.restype = I
    L, B, din = xs.shape
    h, dz = w0s.shape[-1], w1s.shape[-1]
    T = -(-B // lib.lane_mlp_bwd_tile_rows())
    new = lambda *shape: torch.empty(shape, device=xs.device)
    dx, g1, h1, g2 = new(L, B, din), new(L, B, h), new(L, B, h), new(L, B, dz)
    parts = [new(L, T, din, h), new(L, T, h), new(L, T, h, dz), new(L, T, dz)]
    rc = lib.lane_mlp_bwd(
        *(t.data_ptr() for t in (g, xs, a1, a2, w0s, w1s, dx, *parts, g1,
                                 h1, g2)),
        L, B, din, h, dz, int(final_act),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return (dx, *(p.sum(dim=1) for p in parts))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(AE_SHAPES))
def test_lane_mlp_bwd_equals_kernel_before_redesign_on_card(name):
    dev = _card()
    lib = _library_before("lane_mlp_bwd")
    for B, fa in ((1, True), (77, False), (128, False), (128, True),
                  (2000, False)):
        args = _bwd_case(B, 1, B, *AE_SHAPES[name], dev, fa)
        got = lane_mlp.launch_bwd(*args, final_act=fa)
        want = _bwd_before(lib, *args, fa)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (name, B, fa)


# the million-row scale lanes' MLPs, (din, h, dz): the narrow route
SCALE_SHAPES = {"scale.enc": (16, 32, 64), "scale.dec": (64, 32, 16)}
SCALE_LANES, SCALE_BATCH, SCALE_VAL_ROWS = 16, 8192, 100_000


def _before_narrow():
    """The pair's libraries before the narrow route, their C interfaces
    declared."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    fwd = _library_before("lane_mlp_fwd@7336668")
    bwd = _library_before("lane_mlp_bwd@7336668")
    fwd.lane_mlp_fwd.argtypes = [P] * 8 + [I] * 7 + [P]
    bwd.lane_mlp_bwd.argtypes = [P] * 12 + [I] * 6 + [P]
    return fwd, bwd


def _fwd_before_narrow(lib, xs, w0s, b0s, w1s, b1s, final_act, save):
    """The forward through the old library, at the cluster size its
    launcher picked."""
    from repro_torch.kernels import _launch
    L, B, din = xs.shape
    h, dz = w0s.shape[-1], w1s.shape[-1]
    new = lambda *shape: torch.empty(shape, device=xs.device)
    out = new(L, B, dz)
    a1, a2 = (new(L, B, h), new(L, B, dz)) if save else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    cluster = _launch.cluster_size(L * -(-B // 16), xs.device,
                                   lane_mlp.BLOCKS_PER_SM)
    rc = lib.lane_mlp_fwd(*(t.data_ptr() for t in (xs, w0s, b0s, w1s, b1s,
                                                   out)),
                          ptr(a1), ptr(a2), L, B, din, h, dz,
                          int(final_act), cluster,
                          torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return (out, a1, a2) if save else (out,)


def _bwd_before_narrow(lib, g, xs, a1, a2, w0s, w1s, final_act, need_dx):
    L, B, din = xs.shape
    h, dz = w0s.shape[-1], w1s.shape[-1]
    new = lambda *shape: torch.empty(shape, device=xs.device)
    dx = new(L, B, din) if need_dx else None
    grads = [new(L, din, h), new(L, h), new(L, h, dz), new(L, dz)]
    rc = lib.lane_mlp_bwd(
        *(t.data_ptr() for t in (g, xs, a1, a2, w0s, w1s)),
        None if dx is None else dx.data_ptr(),
        *(t.data_ptr() for t in grads), new(L, B, h).data_ptr(),
        L, B, din, h, dz, int(final_act),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return (dx, *grads)


def _same(got, want) -> bool:
    torch.cuda.synchronize()
    return all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, want))


def _fwd_cases(name):
    """(L, B, save) of the forward test: the Table-3 MLPs at the batches
    the card tests already take, the scale MLPs at their batch, a ragged
    one and the validation pass's rows."""
    if name in SCALE_SHAPES:
        return [(SCALE_LANES, SCALE_BATCH, False),
                (SCALE_LANES, SCALE_BATCH, True), (SCALE_LANES, 300, True),
                (SCALE_LANES, SCALE_VAL_ROWS, False)]
    return [(L, B, save) for L in (1, 2) for B in (1, 7, 77, 128, 2000)
            for save in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(AE_SHAPES) + list(SCALE_SHAPES))
def test_lane_mlp_fwd_equals_kernel_before_narrow_route_on_card(name):
    """The forward keeps the parent's bits at every shape: the Table-3
    MLPs on the unchanged cluster route, the scale MLPs on the narrow
    route."""
    dev = _card()
    fwd, _ = _before_narrow()
    widths = {**AE_SHAPES, **SCALE_SHAPES}[name]
    for L, B, save in _fwd_cases(name):
        arrs = _mlp(B, B, *widths, dev, lanes=(L,))
        for fa in (False, True):
            got = lane_mlp.launch(*arrs, final_act=fa, save=save)
            got = got if save else (got,)
            want = _fwd_before_narrow(fwd, *arrs, fa, save)
            assert _same(got, want), (name, L, B, fa, save)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(AE_SHAPES) + list(SCALE_SHAPES))
def test_lane_mlp_bwd_equals_kernel_before_narrow_route_on_card(name):
    """The backward keeps the parent's bits at every shape, with and
    without dx and the final SELU; at the scale MLPs (the narrow route)
    over 16 lanes of the batch and of a ragged 300 rows, lane 1 dead."""
    dev = _card()
    _, bwd = _before_narrow()
    if name in SCALE_SHAPES:
        cases = [(SCALE_LANES, SCALE_BATCH, fa) for fa in (False, True)]
        cases.append((SCALE_LANES, 300, True))
    else:
        cases = [(1, 1, True), (1, 77, False), (1, 128, False),
                 (2, 128, True), (1, 2000, False)]
    widths = {**AE_SHAPES, **SCALE_SHAPES}[name]
    for L, B, fa in cases:
        g, *rest = _bwd_case(B, L, B, *widths, dev, fa)
        if L > 1:
            g[1] = 0.0
        for need_dx in (True, False):
            got = lane_mlp.launch_bwd(g, *rest, final_act=fa,
                                      need_dx=need_dx)
            want = _bwd_before_narrow(bwd, g, *rest, fa, need_dx)
            assert _same(got, want), (name, L, B, fa, need_dx)
            if L > 1:
                assert all(not bool(a[1].any()) for a in got
                           if a is not None), (name, B)


@pytest.mark.gpu
@pytest.mark.parametrize("layer", list(INT8_LAYERS))
def test_int8_matmul_equals_kernel_before_redesign_on_card(layer):
    """The old kernel has the same C interface: both run through the
    launcher, one with the library before the redesign."""
    from repro_torch.kernels import int8_matmul as i8
    dev = _card()
    d, c, act = INT8_LAYERS[layer]
    before = _library_before("int8_matmul")
    for B in (1, 16, 77, 256):
        rng = np.random.RandomState(B)
        w_q, scale = quant.quantize_weight(_randn(rng, d, c,
                                                  scale=d ** -0.5))
        args = (_randn(rng, B, d).to(dev), torch.from_numpy(w_q).to(dev),
                torch.from_numpy(scale).to(dev),
                _randn(rng, c, scale=0.1).to(dev))
        got = i8.launch(*args, act=act)
        loader = i8._lib
        try:
            before.int8_matmul.argtypes = loader().int8_matmul.argtypes
            i8._lib = lambda: before
            want = i8.launch(*args, act=act)
        finally:
            i8._lib = loader
        torch.cuda.synchronize()
        assert torch.equal(got, want), (layer, B)


# Eq. 5 at (N, D, M): the g3 step's batch and rows around it, mimic3's
# validation split and a 20000-row pass at D 5, M 256; then D 1, 300, 1024
# and M 1, 1000, each with ragged 128-element chunks or none
DISTILL_CASES = ([(n, 5, 256) for n in (1, 77, 128, 129, 2000, 20000)]
                 + [(129, 1, 256), (77, 300, 1000), (128, 1024, 1),
                    (2000, 1024, 1000), (20000, 300, 1000)])
G3_NEEDS = (False, True, True, False, False)     # the g3 step: x_hat, z


def _distill_case(seed, N, D, M, dev, offset=0):
    """x, x_hat, z, z_t, mask with exact ties (sign(0) = 0) and rows at 0
    and 1; ``offset`` floats in, every tensor's data starts off the 16-byte
    boundary (contiguous views into a larger buffer)."""
    rng = np.random.RandomState(seed)

    def arr(*shape):
        t = torch.empty(int(np.prod(shape)) + offset, device=dev)
        t = t[offset:].view(*shape)
        t.copy_(_randn(rng, *shape).to(dev))
        return t
    x, xh, z, zt = arr(N, D), arr(N, D), arr(N, M), arr(N, M)
    zt[::3, ::4] = z[::3, ::4]
    mask = arr(N)
    mask.copy_(torch.from_numpy((rng.rand(N) > 0.5).astype(np.float32)))
    return x, xh, z, zt, mask


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mse", "mae"])
def test_distill_rows_match_plain_on_card(kind):
    """Both forward forms and the backward for row cotangents, for the
    means' cotangents and with only the g3 step's gradients, against the
    plain versions within 1e-5 (``_scalederr``); sign(0) = 0 at the ties."""
    from repro_torch.kernels import distill_loss
    dev = _card()
    kw = dict(lam=0.3, kind=kind)
    for N, D, M in DISTILL_CASES:
        args = _distill_case(N + D, N, D, M, dev)
        rng = np.random.RandomState(N)
        want = ref.distill_rows_ref(*args, **kw)
        assert _scalederr(distill_loss.launch_fwd(*args, **kw), want) <= 1e-5
        S = N if N % 2 else N // 2                  # one or two segments
        rows, means = distill_loss.launch_fwd(*args, mean_of=S, **kw)
        assert _scalederr(rows, want) <= 1e-5
        assert _scalederr(means, torch.mean(want.reshape(-1, S), -1)) <= 1e-5
        for g, mean_of, needs in (
                (_randn(rng, N).to(dev), 0, (True,) * 5),
                (_randn(rng, N // S).to(dev), S, (True,) * 5),
                (torch.ones(1, device=dev), N, G3_NEEDS)):
            got = distill_loss.launch_bwd(g, *args, mean_of=mean_of,
                                          needs=needs, **kw)
            want_g = ref.distill_bwd_ref(g, *args, mean_of=mean_of,
                                         needs=needs, **kw)
            for a, b, need in zip(got, want_g, needs):
                assert (a is None) == (not need)
                if need:
                    assert _scalederr(a, b) <= 1e-5, (N, D, M, mean_of)
            if kind == "mae" and needs[2]:
                assert not bool(got[2][::3, ::4].any())


def _distill_before(lib, x, xh, z, zt, mask, lam, kind, g=None):
    """The kernel before its redesign through its C interface: the rows,
    or for row cotangents ``g`` its ``(dx, dz, dmask)``."""
    import ctypes
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.distill_fwd.argtypes = [P] * 6 + [I] * 3 + [F, I, P]
    lib.distill_bwd.argtypes = [P] * 9 + [I] * 3 + [F, I, P]
    (N, D), M = x.shape, z.shape[1]
    mae = int(kind == "mae")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (x, xh, z, zt, mask)]
    if g is None:
        out = torch.empty(N, device=x.device)
        rc = lib.distill_fwd(*ptrs, out.data_ptr(), N, D, M, lam, mae,
                             stream)
        assert rc == 0
        return out
    dx, dz, dm = torch.empty_like(x), torch.empty_like(z), \
        torch.empty_like(mask)
    rc = lib.distill_bwd(g.data_ptr(), *ptrs, dx.data_ptr(), dz.data_ptr(),
                         dm.data_ptr(), N, D, M, lam, mae, stream)
    assert rc == 0
    return dx, dz, dm


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mse", "mae"])
def test_distill_rows_equal_kernel_before_redesign_on_card(kind):
    """The redesign keeps each row's sum order: both forms' rows are the
    old kernel's bits, at aligned and misaligned row starts; each mean is
    within 1e-6 relative of ``torch.mean`` of the rows (its own sum
    order)."""
    from repro_torch.kernels import distill_loss
    dev = _card()
    lib = _library_before("distill_loss")
    kw = dict(lam=0.3, kind=kind)
    for (N, D, M), offset in itertools.product(DISTILL_CASES, (0, 1)):
        x, xh, z, zt, mask = _distill_case(N + offset, N, D, M, dev, offset)
        # as drawn, then with x_hat = x (the rows are lam * mask * dis, so
        # every bit of the dis sum shows) and with z_t = z (the rows are
        # rec)
        for args in ((x, xh, z, zt, mask), (x, x, z, zt, mask),
                     (x, xh, z, z, mask)):
            old = _distill_before(lib, *args, 0.3, kind)
            rows = distill_loss.launch_fwd(*args, **kw)
            rows_m, mean = distill_loss.launch_fwd(*args, mean_of=N, **kw)
            torch.cuda.synchronize()
            assert torch.equal(rows, old), (N, D, M, offset)
            assert torch.equal(rows_m, old), (N, D, M, offset)
            want = torch.mean(old)
            assert float((mean[0] - want).abs()) <= 1e-6 * float(
                want.abs()), (N, D, M, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mse", "mae"])
def test_distill_grads_equal_old_composition_on_card(kind):
    """g3's gradients keep their bits: ``fused_distill_loss``'s d x_hat
    and dz (one backward launch) against the old kernel's backward fed the
    row cotangents of PyTorch's own mean backward, then negated, as the
    path ran before the redesign; at a loss cotangent of 1 and 0.37, and
    all five gradients (dmask too) when every input needs one.  The rows
    form for random row cotangents likewise."""
    dev = _card()
    lib = _library_before("distill_loss")
    for (N, D, M), offset in itertools.product(DISTILL_CASES, (0, 1)):
        args = _distill_case(N + 7 * offset, N, D, M, dev, offset)
        old_rows = _distill_before(lib, *args, 0.3, kind)
        for cot, needs in ((1.0, G3_NEEDS), (0.37, G3_NEEDS),
                           (1.0, (True,) * 5)):
            ts = [t.detach().requires_grad_(n) for t, n in zip(args, needs)]
            loss = ops.fused_distill_loss(*ts, lam=0.3, kind=kind)
            c = torch.tensor(cot, device=dev)
            got = torch.autograd.grad(loss, [t for t in ts if t.requires_grad],
                                      c)
            r = old_rows.clone().requires_grad_(True)
            (gr,) = torch.autograd.grad(torch.mean(r), r, c)
            dx, dz, dm = _distill_before(lib, *args, 0.3, kind, gr)
            want = [w for w, n in zip((dx, -dx, dz, -dz, dm), needs) if n]
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), (N, D, M, offset, cot, needs)
        ts = [t.detach().requires_grad_(True) for t in args]
        g = _randn(np.random.RandomState(N), N).to(dev)
        got = torch.autograd.grad(ops.fused_distill_rows(
            *ts, lam=0.3, kind=kind), ts, g)
        dx, dz, dm = _distill_before(lib, *args, 0.3, kind, g)
        for a, b in zip(got, (dx, -dx, dz, -dz, dm)):
            assert torch.equal(a, b), (N, D, M, offset, "rows")


@pytest.mark.gpu
def test_distill_repeats_bit_for_bit_on_card():
    """No atomics, a fixed sum order: the mean form's rows and means and
    the backward give the same bits on every launch."""
    from repro_torch.kernels import distill_loss
    dev = _card()
    for N, D, M in ((128, 5, 256), (2000, 5, 256), (20000, 1024, 1000)):
        args = _distill_case(N, N, D, M, dev)
        g = torch.full((1,), 0.37, device=dev)
        runs = [(*distill_loss.launch_fwd(*args, lam=0.01, kind="mse",
                                          mean_of=N),
                 *distill_loss.launch_bwd(g, *args, lam=0.01, kind="mse",
                                          mean_of=N, needs=(True,) * 5))
                for _ in range(3)]
        torch.cuda.synchronize()
        for run in runs[1:]:
            for a, b in zip(run, runs[0]):
                assert torch.equal(a, b), (N, D, M)


@pytest.mark.gpu
def test_distill_refuses_what_it_cannot_take_on_card():
    from repro_torch.kernels import distill_loss
    dev = _card()
    x, xh, z, zt, mask = _distill_case(0, 8, 5, 16, dev)
    kw = dict(lam=0.01, kind="mse")
    with pytest.raises(TypeError):
        distill_loss.launch_fwd(x.double(), xh, z, zt, mask, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        distill_loss.launch_fwd(x, xh, z.t().contiguous().t(), zt, mask,
                                **kw)
    with pytest.raises(ValueError, match="mean_of"):
        distill_loss.launch_fwd(x, xh, z, zt, mask, mean_of=3, **kw)
    with pytest.raises(ValueError, match="needs"):
        distill_loss.launch_bwd(mask, x, xh, z, zt, mask, needs=(True,), **kw)


@pytest.mark.gpu
def test_eq5_step_is_two_kernels_on_card():
    """The loss of a g3 step, forward and backward with the step's
    gradients, is two device kernels in the profiler's full list (the
    parent's path was six) and one launch of each counter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = _card()
    args = _distill_case(1, 128, 5, 256, dev)
    ts = [t.detach().requires_grad_(n) for t, n in zip(args, G3_NEEDS)]
    one = torch.ones((), device=dev)
    step = lambda: torch.autograd.grad(
        ops.fused_distill_loss(*ts, lam=0.01), [ts[1], ts[2]], one)
    step()
    torch.cuda.synchronize()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 2 and all("distill" in n for n in names), names
    assert ops.LAUNCHES["distill_fwd"] == ops.LAUNCHES["distill_bwd"] == 1


@pytest.mark.gpu
def test_probe_matches_plain_on_card():
    dev = _card()
    rng = np.random.RandomState(6)
    for n, d, C, k in ((15000, 256, 4, 10), (77, 256, 2, 3)):
        x = _randn(rng, n, d).to(dev)
        y = torch.from_numpy(rng.randint(0, C, n).astype(np.int32)).to(dev)
        w, b = _randn(rng, k, d, C, scale=0.1).to(dev), \
            _randn(rng, k, C, scale=0.1).to(dev)
        rw = torch.from_numpy((rng.rand(k, n) > 0.1).astype(np.float32)
                              ).to(dev)
        got = ops.probe_grad_step(w, b, x, y, rw)
        want = [t.cuda() for t in ops.probe_grad_step(
            w.cpu(), b.cpu(), x.cpu(), y.cpu(), rw.cpu())]
        for a, bb in zip(got, want):
            assert _maxerr(a, bb) <= 1e-4


def _probe_case(rng, n, d, C, k, dev):
    x = _randn(rng, n, d).to(dev)
    y = torch.from_numpy(rng.randint(0, C, n).astype(np.int32)).to(dev)
    w, b = _randn(rng, k, d, C, scale=0.1).to(dev), \
        _randn(rng, k, C, scale=0.1).to(dev)
    rw = torch.from_numpy((rng.rand(k, n) > 0.1).astype(np.float32)).to(dev)
    return w, b, x, y, rw / rw.sum(-1, keepdim=True).clamp(min=1.0)


def _probe_before(lib, w, b, x, y, rwn):
    """The probe step through the old C interface, as its launcher ran it:
    per-tile partials, then ``sum`` over the tile axis."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.probe_tile_rows.restype = I
    K, d, C = w.shape
    n = x.shape[0]
    T = -(-n // lib.probe_tile_rows())
    new = lambda *shape: torch.empty(shape, device=x.device)
    parts = [new(K, T), new(K, T, d, C), new(K, T, C)]
    rc = lib.probe(*(t.data_ptr() for t in (x, y, rwn, w, b, *parts)), K, n,
                   d, C, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return tuple(p.sum(dim=1) for p in parts)


def _order_bound(abs_sum, m):
    """The most two summation orders of the same m fp32 terms can differ:
    2 gamma_{m-1} times the sum of the terms' magnitudes, gamma_k = k u /
    (1 - k u), u = 2^-24 (Higham, Accuracy and Stability of Numerical
    Algorithms, 2nd ed., section 4.2)."""
    ku = (m - 1) * 2.0 ** -24
    return 2.0 * ku / (1.0 - ku) * abs_sum


@pytest.mark.gpu
@pytest.mark.parametrize("n, k", [(77, 1), (77, 10), (15000, 1),
                                  (15000, 10), (40000, 10)])
def test_probe_within_sum_order_bound_of_kernel_before_redesign_on_card(
        n, k):
    """The new kernel sums each block's rows and then the blocks' partials;
    the old one summed 64-row tiles and then ``torch.sum`` over them.  The
    per-row terms are the same (each logit keeps its j order, g its
    expressions), so dW, db and the loss may differ only as two orders of
    the same n terms can (``_order_bound``, magnitudes from fp64)."""
    import torch.nn.functional as F
    from repro_torch.kernels import probe
    dev = _card()
    w, b, x, y, rwn = _probe_case(np.random.RandomState(n + k), n, 256, 4, k,
                                  dev)
    got = probe.launch(w, b, x, y, rwn)
    want = _probe_before(_library_before("probe"), w, b, x, y, rwn)
    torch.cuda.synchronize()
    logits = x.double() @ w.double() + b.double()[:, None]
    onehot = F.one_hot(y.long(), 4).double()
    g = (torch.softmax(logits, -1) - onehot) * rwn.double()[..., None]
    rows = (torch.logsumexp(logits, -1) - (logits * onehot).sum(-1)) \
        * rwn.double()
    bounds = (_order_bound(rows.abs().sum(1), n),
              _order_bound(x.double().abs().T @ g.abs(), n),
              _order_bound(g.abs().sum(1), n))
    for a, bb, bound in zip(got, want, bounds):
        assert bool(((a.double() - bb.double()).abs() <= bound).all()), (n, k)
        assert _maxerr(a, bb) <= 1e-4


@pytest.mark.gpu
def test_probe_repeats_bit_for_bit_on_card():
    from repro_torch.kernels import probe
    dev = _card()
    args = _probe_case(np.random.RandomState(16), 15000, 256, 4, 10, dev)
    runs = [probe.launch(*args) for _ in range(3)]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_probe_zero_weight_rows_are_exact_zeros_on_card():
    """A lane of weight 0 gives exact zeros; rows of weight 0 in every lane
    are inert: moving their x and labels changes no bit."""
    from repro_torch.kernels import probe
    dev = _card()
    rng = np.random.RandomState(17)
    w, b, x, y, rwn = _probe_case(rng, 15000, 256, 4, 3, dev)
    rwn[1] = 0.0
    dead = torch.from_numpy(rng.rand(15000) < 0.2).to(dev)
    rwn[:, dead] = 0.0
    got = probe.launch(w, b, x, y, rwn)
    assert not got[1][1].any() and not got[2][1].any() and \
        float(got[0][1]) == 0.0
    x2, y2 = x.clone(), y.clone()
    x2[dead] = _randn(rng, int(dead.sum()), 256, scale=3.0).to(dev)
    y2[dead] = (y2[dead] + 1) % 4
    for a, bb in zip(got, probe.launch(w, b, x2, y2, rwn)):
        assert torch.equal(a, bb)


@pytest.mark.gpu
def test_probe_wide_rows_and_many_lanes_match_plain_on_card():
    """d past 256 (more than one 256-wide j group), d off a multiple of 4
    (4-byte copies), K * C past 64 (lanes in groups), C past 64 (one lane
    in several column passes), d and C at the PR-12 kernel's limits
    (shared memory for 64 rows: d 849 at C 4, C 130 at d 256; here 32-row
    tiles) and blocks of several row tiles (n 40000, the sums carried
    through the partial): within 1e-4 of the plain version; a d whose
    32-row tile does not fit is refused."""
    from repro_torch.kernels import probe
    dev = _card()
    rng = np.random.RandomState(18)
    for n, d, C, k in ((300, 300, 4, 2), (1000, 510, 2, 3), (500, 30, 3, 1),
                       (2000, 64, 5, 20), (7, 256, 4, 10), (600, 600, 4, 3),
                       (300, 849, 4, 1), (400, 256, 130, 2), (50, 4, 800, 1),
                       (40000, 256, 4, 10)):
        args = _probe_case(rng, n, d, C, k, dev)
        for a, bb in zip(probe.launch(*args), ref.probe_grad_ref(*args)):
            assert _maxerr(a, bb) <= 1e-4, (n, d, C, k)
    with pytest.raises(ValueError, match="shared memory"):
        probe.launch(*_probe_case(rng, 10, 1500, 4, 1, dev))


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
    w = arrs[1].clone().requires_grad_(True)
    out = ops.fused_mlp2(x, w, *arrs[2:])
    out.sum().backward()
    rows = ops.fused_distill_rows(x, x, out.detach(), out.detach(),
                                  torch.ones(16, device=dev))
    ops.probe_grad_step(torch.zeros((5, 3), device=dev),
                        torch.zeros(3, device=dev), x,
                        torch.zeros(16, dtype=torch.int32, device=dev),
                        torch.ones(16, device=dev))
    torch.cuda.synchronize()
    assert rows.shape == (16,)
    assert ops.LAUNCHES == {"lane_mlp_fwd": 2, "lane_mlp_bwd": 1,
                            "int8_matmul": 1, "distill_fwd": 1,
                            "distill_bwd": 0, "probe": 1,
                            "flash_attention": 0, "decode_attention": 0,
                            "ssd_intra_chunk": 0}


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# bf16 flash vs its plain version in fp32 on the same bf16 inputs: (atol,
# rtol), chip_smoke.py's TOL_FLASH_BF16_F32
FLASH_BF16_F32_TOL = (5e-3, 1e-2)


def _allclose(got, want, tol):
    """``assert_allclose(got, want, atol=tol, rtol=tol)``, the reference's
    attention bounds (tests/test_kernels.py)."""
    torch.cuda.synchronize()
    got, want = got.float().cpu(), want.float().cpu()
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def _attn_inputs(rng, dev, dtype, *shapes):
    return [_randn(rng, *s).to(dev, dtype) for s in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_on_card(dtype):
    """The kernel against its plain version on the same card tensors, at
    the serving shapes (internlm2-1.8b heads: H 16, K 8, hd 128) and
    ragged S with small heads, causal with and without a window (48, and
    100: not a multiple of the 64-key tile) and full; the reference's
    bounds (tests/test_kernels.py).  bf16 is also held to the plain
    version in fp32 on the same bf16 inputs, at a bound near its own
    rounding."""
    dev = _card()
    rng = np.random.RandomState(7)
    for B, S, H, K, hd in ((1, 128, 16, 8, 128), (1, 32, 16, 8, 128),
                           (1, 200, 4, 2, 64), (2, 77, 4, 4, 32),
                           (2, 160, 32, 32, 80),       # zamba2's MHA, hd 80
                           (1, 300, 8, 2, 80)):
        q, k, v = _attn_inputs(rng, dev, dtype, (B, S, H, hd),
                               (B, S, K, hd), (B, S, K, hd))
        for causal, window in ((True, 0), (True, 48), (True, 100),
                               (False, 0)):
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(),
                                       causal=causal, window=window)
            assert got.dtype == dtype
            assert _allclose(got, want, ATTN_TOL[dtype]), \
                (B, S, H, K, hd, causal, window)
            if dtype == torch.bfloat16:
                want = ops.flash_attention(*(t.cpu().float() for t in
                                             (q, k, v)), causal=causal,
                                           window=window)
                atol, rtol = FLASH_BF16_F32_TOL
                err = (got.float().cpu() - want).abs()
                assert bool((err <= atol + rtol * want.abs()).all()), \
                    (B, S, H, K, hd, causal, window, float(err.max()))


@pytest.mark.gpu
def test_flash_attention_bf16_refuses_head_dim_off_16_on_card():
    """The bf16 route runs on 16-column tensor-core steps: hd 72 raises,
    while fp32 takes it."""
    dev = _card()
    q, k, v = _attn_inputs(np.random.RandomState(17), dev, torch.float32,
                           (1, 64, 2, 72), (1, 64, 2, 72), (1, 64, 2, 72))
    assert ops.flash_attention(q, k, v).shape == (1, 64, 2, 72)
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.flash_attention(*(t.bfloat16() for t in (q, k, v)))


def _forward_only_calls(dev):
    """Each forward-only wrapper with small card inputs: name -> (inputs,
    call)."""
    rng = np.random.RandomState(18)
    q, k, v = _attn_inputs(rng, dev, torch.float32, (1, 32, 4, 32),
                           (1, 32, 2, 32), (1, 32, 2, 32))
    dq, dk, dv = _attn_inputs(rng, dev, torch.float32, (2, 4, 32),
                              (2, 16, 2, 32), (2, 16, 2, 32))
    sp = torch.arange(16, dtype=torch.int32, device=dev)
    ssd = [t.to(dev) for t in _ssd_inputs(rng, 1, 64, 4, 1, 16, 16, False)]
    return {
        "flash_attention": ([q, k, v], lambda a: ops.flash_attention(*a)),
        "decode_attention": ([dq, dk, dv], lambda a: ops.decode_attention(
            *a, sp, 15)),
        "ssd_intra_chunk": (ssd, lambda a: ops.ssd_intra_chunk(*a, 32))}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssd_intra_chunk"])
def test_forward_only_kernels_refuse_autograd_on_card(name):
    """A kernel without a backward raises when an input requires grad,
    instead of returning an output detached from the graph; under
    ``torch.no_grad()`` the same call launches once."""
    dev = _card()
    args, call = _forward_only_calls(dev)[name]
    args[0].requires_grad_(True)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
        call(args)
    assert ops.LAUNCHES[name] == 0
    with torch.no_grad():
        call(args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == 1


# bf16 decode vs its plain version in fp32 on the same bf16 inputs: (atol,
# rtol), chip_smoke.py's TOL_DECODE_BF16_F32
DECODE_BF16_F32_TOL = (1e-4, 1e-2)
# decode's (H, K, hd): GQA ratios 2 (internlm2-1.8b), 1 (zamba2, hd 80), 6
# (internlm2-20b, nemotron-4-15b), 8 (yi-6b, qwen3-moe), 4 (the VLM), and
# the smokes' hd 64; in bf16, G >= 4 takes the grouped route, also at hd 64
DECODE_HEADS = ((16, 8, 128), (32, 32, 80), (48, 8, 128), (32, 4, 128),
                (4, 2, 64), (32, 8, 128), (16, 4, 64), (48, 8, 64),
                (32, 4, 64))


def _prefix_slots(W, pos):
    """Slots 0..pos written, four empty ones inside the prefix."""
    sp = np.where(np.arange(W) <= pos, np.arange(W), -1)
    sp[5:9] = -1
    return torch.from_numpy(sp.astype(np.int32))


def _ring_slots(W, steps):
    """A ring of W slots after ``steps`` writes: slot w holds the last
    position p < steps with p % W == w (not monotone once it wraps)."""
    p = np.arange(steps)
    sp = np.full(W, -1, np.int64)
    sp[p % W] = p
    return torch.from_numpy(sp.astype(np.int32))


def _decode_check(dev, dtype, q, kc, vc, sp, pos, window, what):
    """The wrapper on the card against the plain version on CPU copies in
    the reference's bound, and bf16 also against the plain version in
    fp32 on the same bf16 inputs."""
    got = ops.decode_attention(q, kc, vc, sp.to(dev), pos, window=window)
    want = ops.decode_attention(q.cpu(), kc.cpu(), vc.cpu(), sp, pos,
                                window=window)
    assert got.dtype == dtype
    assert _allclose(got, want, ATTN_TOL[dtype]), what
    if dtype == torch.bfloat16:
        want = ops.decode_attention(*(t.cpu().float() for t in (q, kc, vc)),
                                    sp, pos, window=window)
        atol, rtol = DECODE_BF16_F32_TOL
        err = (got.float().cpu() - want).abs()
        assert bool((err <= atol + rtol * want.abs()).all()), \
            (what, float(err.max()))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain_on_card(dtype):
    """GQA ratios 1, 2, 6 and 8 at W 64, 77, 1000 and 1024 (numbers of
    slots that the cluster's split does not divide among them), pos 0,
    W - 1 and inside, with and without a window; the reference's bounds,
    and bf16 also near its own rounding against fp32."""
    from repro_torch.kernels import decode_attention as da
    dev = _card()
    rng = np.random.RandomState(8)
    B = 2
    routes = set()
    for (H, K, hd), (W, pos) in itertools.product(
            DECODE_HEADS, ((64, 40), (77, 76), (1000, 0), (1024, 700))):
        q, kc, vc = _attn_inputs(rng, dev, dtype, (B, H, hd),
                                 (B, W, K, hd), (B, W, K, hd))
        routes.add(da.route(H // K, hd, dtype))
        for window in (0, 48):
            _decode_check(dev, dtype, q, kc, vc, _prefix_slots(W, pos), pos,
                          window, (H, K, hd, W, pos, window))
    assert routes == ({"slots", "grouped"} if dtype == torch.bfloat16
                      else {"slots"})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_wrapped_ring_on_card(dtype):
    """A windowed ring that has wrapped (slot positions not monotone in
    the slot index), with windows inside and equal to the ring, at the
    engine's batch of 8 (clusters of 8 blocks) and at 64 (clusters of 1);
    in bf16 G 4, 6 and 8 take the grouped route (clusters of 4, 2 and 1
    blocks)."""
    dev = _card()
    rng = np.random.RandomState(11)
    for B, (H, K, hd) in ((8, (16, 8, 128)), (64, (32, 32, 80)),
                          (8, (32, 4, 128)), (8, (48, 8, 64)),
                          (8, (32, 8, 128)), (64, (32, 8, 64))):
        W, steps = 77, 300
        q, kc, vc = _attn_inputs(rng, dev, dtype, (B, H, hd),
                                 (B, W, K, hd), (B, W, K, hd))
        for window in (5, 48, W):
            _decode_check(dev, dtype, q, kc, vc, _ring_slots(W, steps),
                          steps - 1, window, (B, H, window))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_empty_shares_on_card(dtype):
    """Blocks of a cluster whose slots are all empty while others' are
    not (three written slots at the front, or a run at the back of 1024),
    and a cache with every slot empty, which gives exact zeros; at G 2
    and, in bf16 on the grouped route, at G 8 and 4 (hd 128 and 64)."""
    dev = _card()
    rng = np.random.RandomState(12)
    B, W = 8, 1024
    back = np.full(W, -1, np.int32)
    back[1000:1010] = np.arange(10)
    for H, K, hd in ((16, 8, 128), (32, 4, 128), (32, 8, 64)):
        q, kc, vc = _attn_inputs(rng, dev, dtype, (B, H, hd), (B, W, K, hd),
                                 (B, W, K, hd))
        for sp, pos in ((_prefix_slots(3, 2), 2),
                        (torch.from_numpy(back), 9)):
            sp = torch.cat([sp, torch.full((W - len(sp),), -1,
                                           dtype=torch.int32)])
            _decode_check(dev, dtype, q, kc, vc, sp, pos, 0, (H, K, pos))
        empty = torch.full((W,), -1, dtype=torch.int32)
        got = _decode_check(dev, dtype, q, kc, vc, empty, 10, 0,
                            (H, K, "empty"))
        assert not bool((got != 0).any()), (H, K)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_repeats_bit_for_bit_on_card(dtype):
    """No atomics and a fixed merge order: two launches give the same
    bits, split over clusters of 8 blocks (B 8, K 8) and of 1 (B 64, K
    32); in bf16 the grouped route at G 8, 6 and 4 (clusters of 4, 2 and
    2 blocks)."""
    dev = _card()
    rng = np.random.RandomState(13)
    for B, H, K, hd in ((8, 16, 8, 128), (64, 32, 32, 80), (8, 32, 4, 128),
                        (8, 48, 8, 128), (8, 32, 8, 64)):
        q, kc, vc = _attn_inputs(rng, dev, dtype, (B, H, hd),
                                 (B, 1024, K, hd), (B, 1024, K, hd))
        sp = _prefix_slots(1024, 511).to(dev)
        runs = [ops.decode_attention(q, kc, vc, sp, 511) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(*runs), (B, K)


def _decode_before(lib, q, kc, vc, sp, pos, window=0):
    """One launch of 010a1d7's decode library (the slots kernel at every
    G) through its C interface, at the cluster size its launcher picked."""
    import ctypes
    import math
    from repro_torch.kernels import _launch
    from repro_torch.kernels import decode_attention as da
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention.argtypes = [P] * 5 + [I] * 7 + [F, I, I, P]
    B, H, hd = q.shape
    W, K = kc.shape[1], kc.shape[2]
    out = torch.empty_like(q)
    rc = lib.decode_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), sp.data_ptr(),
        out.data_ptr(), B, H, K, W, hd, pos, window, 1.0 / math.sqrt(hd),
        _launch.cluster_size(B * K, q.device, da.BLOCKS_PER_SM),
        da.DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


# the slots route against 010a1d7's kernel: chip_smoke.py's phase-2 decode
# sets in fp32 (every G), in bf16 at G 1 and 2, and a bf16 G 4 at hd 72 (not
# a multiple of 16, so the slots route)
_DECODE_SLOTS_SETS = (
    [(torch.float32, heads) for heads in chip_smoke.DECODE_HEADS]
    + [(torch.bfloat16, heads) for heads in chip_smoke.DECODE_HEADS
       if heads[0] // heads[1] <= 2]
    + [(torch.bfloat16, (32, 8, 72))])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,heads", _DECODE_SLOTS_SETS,
                         ids=[f"{str(d)[6:]}-{h}" for d, h in
                              _DECODE_SLOTS_SETS])
def test_decode_attention_slots_route_equals_kernel_before_grouped_on_card(
        dtype, heads):
    """fp32 at every G, and bf16 at G <= 3 or a head dim that is not a
    multiple of 16, keep the slots kernel: the same bits as 010a1d7's
    library at phase 2's W, windows and slot positions, over the VLM's
    image cache and over an empty cache."""
    from repro_torch.kernels import decode_attention as da
    dev = _card()
    lib = _library_before("decode_attention@010a1d7")
    H, K, hd = heads
    assert da.route(H // K, hd, dtype) == "slots"
    rng = np.random.RandomState(H * 7 + K + hd)
    B = chip_smoke.LM["batch"]
    cases = [(W, W * 3 // 4, chip_smoke._slot_pos(W, W * 3 // 4), window)
             for W in chip_smoke.DECODE_W
             for window in chip_smoke.DECODE_WINDOWS]
    Wi = chip_smoke.VLM_IMAGE_TOKENS
    cases += [(Wi, Wi - 1, torch.arange(Wi, dtype=torch.int32, device=dev),
               0),
              (64, 10, torch.full((64,), -1, dtype=torch.int32, device=dev),
               0)]
    for W, pos, sp, window in cases:
        q, kc, vc = _attn_inputs(rng, dev, dtype, (B, H, hd), (B, W, K, hd),
                                 (B, W, K, hd))
        got = ops.decode_attention(q, kc, vc, sp, pos, window=window)
        want = _decode_before(lib, q, kc, vc, sp, pos, window)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (W, pos, window)


@pytest.mark.gpu
def test_decode_attention_refuses_what_it_cannot_take_on_card():
    """The kernel reads 16 bytes at a time and serves at most 8 q heads a
    kv head: a bf16 head dim of 36 and 16 q heads on one kv head raise."""
    dev = _card()
    rng = np.random.RandomState(14)
    sp = torch.arange(16, dtype=torch.int32, device=dev)
    q, kc, vc = _attn_inputs(rng, dev, torch.bfloat16, (1, 2, 36),
                             (1, 16, 2, 36), (1, 16, 2, 36))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.decode_attention(q, kc, vc, sp, 15)
    q, kc, vc = _attn_inputs(rng, dev, torch.float32, (1, 16, 32),
                             (1, 16, 1, 32), (1, 16, 1, 32))
    with pytest.raises(ValueError, match="exceed the kernel's 8"):
        ops.decode_attention(q, kc, vc, sp, 15)


# (dtype, (H, K, hd)) of both routes: the slots route at G 1 and 2 in fp32
# and bf16, the grouped route at G 4 and 8
_POSITION_SETS = ([(d, h) for d in (torch.float32, torch.bfloat16)
                   for h in ((32, 32, 80), (16, 8, 128))]
                  + [(torch.bfloat16, h) for h in ((32, 8, 128),
                                                   (32, 4, 128))])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,heads", _POSITION_SETS,
                         ids=[f"{str(d)[6:]}-{h}" for d, h in
                              _POSITION_SETS])
def test_decode_attention_position_on_device_equals_int_on_card(dtype,
                                                                 heads):
    """The kernel reading the position from device memory gives the bits
    of the same launch with the host int, on a prefix cache and a wrapped
    ring, with and without a window."""
    from repro_torch.kernels import decode_attention as da
    dev = _card()
    H, K, hd = heads
    assert da.route(H // K, hd, dtype) == ("grouped" if H // K >= 4
                                           else "slots")
    rng = np.random.RandomState(H + K + hd)
    B, W = 8, 1024
    q, kc, vc = _attn_inputs(rng, dev, dtype, (B, H, hd), (B, W, K, hd),
                             (B, W, K, hd))
    for sp, pos in ((_prefix_slots(W, 700), 700), (_prefix_slots(W, 0), 0),
                    (_ring_slots(W, 2500), 2499)):
        sp = sp.to(dev)
        at = torch.tensor([pos], dtype=torch.int32, device=dev)
        for window in (0, 48):
            want = ops.decode_attention(q, kc, vc, sp, pos, window=window)
            got = ops.decode_attention(q, kc, vc, sp, at, window=window)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (pos, window)
            assert bool(want.abs().sum() > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-30b-a3b"])
def test_engine_graph_steps_equal_eager_steps_on_card(arch, dtype):
    """Twelve engine steps on the card: the first eager, the second
    captured and replayed, the rest replayed; a session retires after the
    fourth and the queue refills its slot before the fifth.  Each step's
    tokens and the cache after it equal an eager ``make_decode_step`` at
    the host position on a clone of the cache the step started from (the
    step's refills made first).  One capture, a replay every step but the
    first, and ``ops.LAUNCHES`` counts every replay's decode launches."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import build_params
    from repro_torch.models.attention import KVCache
    from repro_torch.serve.decode import make_decode_step
    from repro_torch.serve.engine import Engine, Request
    dev = _card()
    cfg = get_smoke(arch).with_(use_flash_kernel=True, dtype=dtype)
    params = build_params(cfg, seed=7, device=dev)
    B, P, steps = 2, 8, 12
    eng = Engine(params, cfg, batch=B, n_slots=48, prefill_len=P,
                 device=dev)
    rng = np.random.RandomState(12)
    for rid, new in enumerate((5, 20, 20)):
        eng.submit(Request(rid, rng.randint(0, cfg.vocab_size, P).astype(
            np.int32), max_new=new))
    step = make_decode_step(cfg)
    ops.reset_launches()
    refilled = False
    with torch.no_grad():
        for s in range(steps):
            for i in range(B):      # the step's refills, as Engine.step
                if eng.slots[i] is None and eng.queue:
                    eng._fill_slot(i, eng.queue.pop(0))
                    refilled |= s > 1
            active = [i for i in range(B) if eng.slots[i] is not None]
            cache = KVCache(*(t.clone() for t in eng.cache))
            tok = torch.as_tensor(eng.cur, device=dev)
            pos = int(eng.pos.max())
            before = ops.LAUNCHES["decode_attention"]
            assert eng.step()
            assert ops.LAUNCHES["decode_attention"] - before == cfg.n_layers
            want, cache = step(params, tok, cache, pos)
            want = want.cpu().numpy()
            assert all(eng.cur[i] == want[i] for i in active), s
            for a, b in zip(eng.cache, cache):
                assert torch.equal(a, b), s
    assert refilled and eng.stats.completed == 1
    assert eng.captures == 1 and eng.replays == steps - 1


@pytest.mark.gpu
def test_decoder_serving_path_launches_attention_kernels_on_card():
    """Prefill and decode of a smoke decoder with the switch on: one flash
    launch per layer per prefill, one decode launch per layer per step,
    and the card's logits as the CPU's."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import build_params
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_map
    dev = _card()
    cfg = get_smoke("internlm2-1.8b").with_(use_flash_kernel=True)
    params = build_params(cfg, seed=0, device="cpu")
    gpu_params = tree_map(lambda t: t.to(dev), params)
    toks = torch.from_numpy(np.random.RandomState(9).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    ops.reset_launches()
    runs = []
    for p, d in ((gpu_params, dev), (params, "cpu")):
        lg, cache = tr.decoder_prefill_with_cache(p, cfg, toks.to(d), 32)
        tok = torch.argmax(lg, -1)
        for t in range(4):
            lg2, cache = M.decode(p, cfg, tok, cache, 16 + t)
            tok = torch.argmax(lg2, -1)
        runs.append((lg.cpu(), lg2.cpu()))
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert ops.LAUNCHES["decode_attention"] == 4 * cfg.n_layers
    for a, b in zip(*runs):
        assert _maxerr(a, b) <= 1e-4 * max(float(b.abs().max()), 1.0)


@pytest.mark.gpu
def test_card_routes_attention_through_kernels_with_switch_off():
    """On the card the attention takes the kernels whatever
    ``use_flash_kernel`` says (here off, as in every registry config), and
    its logits are those of the reference's plain ``_sdpa`` sites, which the
    CPU runs with the switch off."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import build_params
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_map
    dev = _card()
    cfg = get_smoke("internlm2-1.8b")
    assert not cfg.use_flash_kernel
    params = build_params(cfg, seed=1, device="cpu")
    gpu_params = tree_map(lambda t: t.to(dev), params)
    toks = torch.from_numpy(np.random.RandomState(10).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    runs = []
    for p, d in ((gpu_params, dev), (params, "cpu")):
        ops.reset_launches()
        full, _ = tr.decoder_logits(p, cfg, {"tokens": toks.to(d)})
        lg, cache = tr.decoder_prefill_with_cache(p, cfg, toks.to(d), 32)
        lg2, cache = M.decode(p, cfg, torch.argmax(lg, -1), cache, 16)
        runs.append((full.cpu(), lg.cpu(), lg2.cpu(), dict(ops.LAUNCHES)))
    (*card, n_card), (*cpu, n_cpu) = runs
    assert n_card["flash_attention"] == 2 * cfg.n_layers
    assert n_card["decode_attention"] == cfg.n_layers
    assert n_cpu["flash_attention"] == n_cpu["decode_attention"] == 0
    for a, b in zip(card, cpu):
        assert _maxerr(a, b) <= 1e-4 * max(float(b.abs().max()), 1.0)


TOL_SSD = 2e-4          # tests/test_kernels.py::test_ssd_intra_chunk_kernel
# (B, S, H, G, N, P, Lc, steep): zamba2's width over two chunks and at
# prefill_step's B 2, S 2048; a ragged grouped chunk (S 100, so Lc 100);
# per-step log-decays down to -16; N or P off a multiple of 4 and x a view
# 4 bytes into its buffer (both take the kernel's 4-byte copies)
SSD_CASES = {"zamba2": (2, 512, 80, 1, 64, 64, 256, False),
             "zamba2 prefill": (2, 2048, 80, 1, 64, 64, 256, False),
             "ragged grouped": (1, 100, 6, 2, 16, 32, 100, False),
             "steep decay": (2, 512, 8, 1, 64, 64, 256, True),
             "N 30 P 36": (1, 256, 6, 2, 30, 36, 128, False),
             "N 36 P 30 Lc 100": (1, 200, 4, 1, 36, 30, 100, False),
             "x offset view": (2, 512, 8, 1, 64, 64, 256, False)}
SSD_X_OFFSET = {"x offset view"}


def _ssd_inputs(rng, B, S, H, G, N, P, steep):
    x, Bm, Cm = (_randn(rng, *s) for s in ((B, S, H, P), (B, S, G, N),
                                           (B, S, G, N)))
    if steep:
        dt = torch.from_numpy(rng.rand(B, S, H).astype(np.float32))
        A = -torch.from_numpy(np.exp(rng.rand(H) * np.log(16.0)).astype(
            np.float32))
    else:
        dt = torch.nn.functional.softplus(_randn(rng, B, S, H))
        A = -torch.exp(_randn(rng, H, scale=0.5))
    return x, dt, A, Bm, Cm


def _ssd_case(case, seed, dev):
    """``(args on dev, Lc)`` of an SSD case; x of an ``SSD_X_OFFSET`` case
    is a contiguous view one float into a larger buffer, so its base is
    not 16-byte aligned."""
    B, S, H, G, N, P, Lc, steep = SSD_BEFORE_CASES[case]
    args = [t.to(dev) for t in _ssd_inputs(np.random.RandomState(seed), B,
                                            S, H, G, N, P, steep)]
    if case in SSD_X_OFFSET:
        buf = torch.empty(args[0].numel() + 1, device=dev)
        buf[1:] = args[0].reshape(-1)
        args[0] = buf[1:].view(args[0].shape)
    return args, Lc


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_intra_chunk_matches_plain_on_card(case):
    dev = _card()
    B, S, H, G, N, P, Lc, steep = SSD_CASES[case]
    args, Lc = _ssd_case(case, 11, dev)
    ops.reset_launches()
    y, st = ops.ssd_intra_chunk(*args, Lc)
    assert ops.LAUNCHES["ssd_intra_chunk"] == 1
    y_want, st_want = ref.ssd_intra_chunk_ref(*args, Lc)
    assert y.shape == (B, S, H, P) and st.shape == (B, S // Lc, H, N, P)
    assert _allclose(y, y_want, TOL_SSD) and _allclose(st, st_want, TOL_SSD)
    y_cpu, st_cpu = ops.ssd_intra_chunk(*(t.cpu() for t in args), Lc)
    assert _allclose(y, y_cpu, TOL_SSD) and _allclose(st, st_cpu, TOL_SSD)


# the bf16 SSD (cfg.ssd_bf16) vs its plain bf16 version on the card, relative
# to max|y| (max|states|): chip_smoke.py's TOL_SSD_BF16, placed by the
# kernel's and the planted faults' readings in tools/ssd_planted_faults.py
TOL_SSD_BF16 = 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zamba2", "ragged grouped", "steep decay",
                                  "N 30 P 36", "x offset view"])
def test_ssd_bf16_matches_plain_on_card(case):
    """``ssd_intra_chunk(..., bf16=True)`` launches the kernel's bf16
    variant (one launch, no raise) and lies within TOL_SSD_BF16 of the
    plain bf16 version on the same card tensors; it is another function
    than the fp32 route, which the fp32 kernel keeps."""
    dev = _card()
    args, Lc = _ssd_case(case, 12, dev)
    ops.reset_launches()
    y, st = ops.ssd_intra_chunk(*args, Lc, bf16=True)
    assert ops.LAUNCHES["ssd_intra_chunk"] == 1
    y_want, st_want = ref.ssd_intra_chunk_ref(*args, Lc, bf16=True)
    assert y.dtype == st.dtype == torch.float32
    for got, want in ((y, y_want), (st, st_want)):
        assert _maxerr(got, want) <= TOL_SSD_BF16 * float(want.abs().max())
    y32, _ = ops.ssd_intra_chunk(*args, Lc)
    assert not torch.equal(y32, y)
    runs = [ops.ssd_intra_chunk(*args, Lc, bf16=True) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


# the SSD against its kernel before the redesign: SSD_CASES, chunks of 64,
# 100 and 200, two groups at N and P of 16, 32 and 64, steep decays
SSD_BEFORE_CASES = dict(SSD_CASES, **{
    "Lc 64": (2, 256, 8, 1, 64, 64, 64, False),
    "Lc 100": (1, 300, 6, 1, 64, 64, 100, False),
    "Lc 200": (2, 400, 4, 1, 64, 64, 200, False),
    "G 2 N 16 P 16": (1, 256, 8, 2, 16, 16, 256, False),
    "G 2 N 32 P 32": (2, 512, 8, 2, 32, 32, 256, False),
    "G 2 N 64 P 64": (1, 512, 8, 2, 64, 64, 256, False),
    "G 2 N 16 P 64": (1, 256, 4, 2, 16, 64, 128, False),
    "G 2 N 64 P 32 Lc 100 steep": (1, 200, 4, 2, 64, 32, 100, True)})


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SSD_BEFORE_CASES))
def test_ssd_intra_chunk_equals_kernel_before_redesign_on_card(case):
    """The redesign kept every sum order: y and the states have the bits of
    the kernel at 64a7bb6, launched through the same C interface."""
    from repro_torch.kernels import ssd_chunk
    dev = _card()
    args, Lc = _ssd_case(case, 13, dev)
    before = _library_before("ssd_chunk")
    got = ssd_chunk.launch(*args, Lc)
    loader = ssd_chunk._lib
    try:
        before.ssd_intra_chunk.argtypes = loader().ssd_intra_chunk.argtypes
        ssd_chunk._lib = lambda: before
        want = ssd_chunk.launch(*args, Lc)
    finally:
        ssd_chunk._lib = loader
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_ssd_intra_chunk_repeats_bit_for_bit_on_card():
    dev = _card()
    B, S, H, G, N, P, Lc, steep = SSD_CASES["zamba2 prefill"]
    args = [t.to(dev) for t in _ssd_inputs(np.random.RandomState(15), B, S,
                                            H, G, N, P, steep)]
    runs = [ops.ssd_intra_chunk(*args, Lc) for _ in range(3)]
    for y, st in runs[1:]:
        assert torch.equal(y, runs[0][0]) and torch.equal(st, runs[0][1])


@pytest.mark.gpu
def test_hybrid_serving_path_launches_kernels_on_card():
    """zamba2-2.7b at full width and depth (bf16, random weights): one
    prefill launches the SSD kernel once per mamba layer (54) and flash
    attention once per shared-block application (9); each decode step
    launches decode attention 9 times and nothing else."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_params
    from repro_torch.models import model as M
    from repro_torch.serve.decode import make_decode_step, prefill_step
    dev = _card()
    cfg = get_config("zamba2-2.7b")
    G = cfg.n_layers // cfg.attn_period
    params = build_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(np.random.RandomState(13).randint(
        0, cfg.vocab_size, (2, 512)).astype(np.int32)).to(dev)
    with torch.no_grad():
        ops.reset_launches()
        lg = prefill_step(params, cfg, {"tokens": toks})
        prefill = dict(ops.LAUNCHES)
        cache = M.init_cache(params, cfg, 2, 64)
        step = make_decode_step(cfg)
        tok = torch.argmax(lg, -1).to(torch.int32)
        ops.reset_launches()
        for t in range(3):
            tok, cache = step(params, tok, cache, t)
        torch.cuda.synchronize()
    assert bool(torch.isfinite(lg.float()).all())
    assert prefill["ssd_intra_chunk"] == cfg.n_layers == 54
    assert prefill["flash_attention"] == G == 9
    assert prefill["decode_attention"] == 0
    assert ops.LAUNCHES["decode_attention"] == 3 * G
    assert ops.LAUNCHES["ssd_intra_chunk"] == ops.LAUNCHES[
        "flash_attention"] == 0


@pytest.mark.gpu
def test_hybrid_smoke_card_matches_cpu():
    """The zamba2 smoke (fp32) on the card against the CPU: logits of two
    SSD chunks within 1e-4 x max|logit|, and 8 greedy decode steps from
    ``init_cache`` with identical tokens."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import build_params
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    dev = _card()
    cfg = get_smoke("zamba2-2.7b")
    params = build_params(cfg, seed=2, device="cpu")
    gpu_params = tree_map(lambda t: t.to(dev), params)
    toks = torch.from_numpy(np.random.RandomState(14).randint(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    runs = []
    for p, d in ((gpu_params, dev), (params, "cpu")):
        with torch.no_grad():
            full, _ = M.logits(p, cfg, {"tokens": toks.to(d)})
            cache = M.init_cache(p, cfg, 2, 16)
            tok, lgs = toks[:, 0].to(d), []
            for t in range(8):
                lg, cache = M.decode(p, cfg, tok, cache, t)
                lgs.append(lg.cpu())
                tok = torch.argmax(lg, -1)
        runs.append((full.cpu(), torch.stack(lgs)))
    for a, b in zip(*runs):
        assert _maxerr(a, b) <= 1e-4 * max(float(b.abs().max()), 1.0)
    assert torch.equal(runs[0][1].argmax(-1), runs[1][1].argmax(-1))


# the comparison's MLPs (chip_smoke.py phase 9) under autograd, card vs CPU:
# (din, h, dz), lanes (None: the 2-D ``fused_mlp2``), final SELU.  SplitNN's
# two party encoders end in a SELU; VFedTrans's extractor at mimic3
# (x_total 15); the K = 3 g2 at L 1; the K = 3 passives' g1 encoder and
# decoder as one lane group of two seeds x two passives
COMPARISON_MLPS = {
    "splitnn.la": ((5, 64, 128), None, True),
    "splitnn.lp": ((10, 128, 256), None, True),
    "vfedtrans.enc": ((5, 256, 15), None, False),
    "vfedtrans.dec": ((15, 256, 5), None, False),
    "g2_k3.enc L1": ((640, 256, 256), 1, False),
    "g1_passive.enc L4": ((5, 128, 256), 4, False),
    "g1_passive.dec L4": ((256, 128, 5), 4, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(COMPARISON_MLPS))
def test_comparison_mlps_through_autograd_on_card(name):
    """``ops.fused_mlp2`` / ``lane_mlp2`` as the comparison's runs call
    them, at B 128: output and every gradient (with and without dx) on
    the card within 1e-5 relative of the CPU's plain path."""
    _mlp_card_vs_cpu(name, *COMPARISON_MLPS[name], B=128)


def _mlp_card_vs_cpu(name, widths, L, fa, B):
    dev = _card()
    din, h, dz = widths
    fn = ops.fused_mlp2 if L is None else ops.lane_mlp2
    lanes = () if L is None else (L,)
    arrs = _mlp(din + dz, B, din, h, dz, torch.device("cpu"), lanes=lanes)
    g = _randn(np.random.RandomState(dz), *lanes, B, dz)
    for need_dx in (False, True):
        runs = []
        for d in (dev, torch.device("cpu")):
            a = [t.to(d).requires_grad_(i > 0 or need_dx)
                 for i, t in enumerate(arrs)]
            out = fn(*a, final_act=fa)
            grads = torch.autograd.grad(torch.sum(out * g.to(d)),
                                        [t for t in a if t.requires_grad])
            runs.append([out.detach().cpu()] + [t.cpu() for t in grads])
        got, want = runs
        assert len(got) == 5 + need_dx
        for i, (a, b) in enumerate(zip(got, want)):
            assert _relerr(a, b) <= 1e-5, (name, need_dx, i)


@pytest.mark.gpu
@pytest.mark.parametrize("d_x", [25, 10], ids=["bcw", "mimic3"])
@pytest.mark.parametrize("B", [16, 128])
def test_inverter_mlp_through_autograd_on_card(d_x, B):
    """The inversion attacker's MLP (``core.privacy``, 256 -> 128 -> the
    passive party's features, no final SELU) through ``fused_mlp2`` as its
    training calls it: at the batch of a 64-pair budget (16) and at 128,
    output and every gradient on the card within 1e-5 relative of the
    CPU's plain path."""
    _mlp_card_vs_cpu(f"inverter d_x {d_x}", (256, 128, d_x), None, False,
                     B=B)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mse", "mae"])
def test_distill_rows_over_two_lanes_through_autograd_on_card(kind):
    """``fused_distill_rows`` (``DistillRows``) at g3's widths over two
    lanes of 128 rows, as the replicated g3 lanes call it: the rows and
    the gradients of x_hat and z on the card within 1e-5 (``_scalederr``)
    of the CPU's plain path."""
    dev = _card()
    rng = np.random.RandomState(7)
    x, xh = _randn(rng, 2, 128, 5), _randn(rng, 2, 128, 5)
    z, zt = _randn(rng, 2, 128, 256), _randn(rng, 2, 128, 256)
    mask = torch.from_numpy((rng.rand(2, 128) > 0.5).astype(np.float32))
    cot = _randn(rng, 2, 128)
    runs = []
    for d in (dev, torch.device("cpu")):
        a = [t.to(d) for t in (x, xh, z, zt, mask)]
        a[1].requires_grad_(True)
        a[2].requires_grad_(True)
        rows = ops.fused_distill_rows(*a, lam=0.01, kind=kind)
        grads = torch.autograd.grad(torch.sum(rows * cot.to(d)),
                                    [a[1], a[2]])
        runs.append([rows.detach().cpu()] + [t.cpu() for t in grads])
    for i, (a, b) in enumerate(zip(*runs)):
        assert a.shape == b.shape
        assert _scalederr(a, b) <= 1e-5, (kind, i)


# ---------------------------------------------------------------------------
# the live runtime and LM training
# ---------------------------------------------------------------------------

def _serving_bundle(seed=0, n_cached=300, d=5, n_classes=4):
    """A Table-3 bundle with random weights (the runtime's decisions and
    the replay's bits do not depend on their values)."""
    from repro_torch import convert
    from repro_torch.core import autoencoder as ae
    from repro_torch.serve.vfl import ModelBundle
    gen = torch.Generator().manual_seed(seed)
    init = lambda w: convert.to_numpy(ae.init_autoencoder(gen, w,
                                                          device="cpu"))
    head = lambda: {"w": (torch.randn((256, n_classes), generator=gen)
                          / 16).numpy(),
                    "b": (torch.randn((n_classes,), generator=gen)
                          * 0.1).numpy()}
    return ModelBundle(
        meta={"n_features_active": d}, g3=init(ae.table3_encoder("g3", d)),
        head_active=head(), x_mean=np.zeros(d, np.float32),
        x_scale=np.ones(d, np.float32),
        g1_active=init(ae.table3_encoder("g1_active", d)),
        g2=init(ae.table3_encoder("g2", 128 + 256)), head_joint=head(),
        cache_ids=np.arange(n_cached, dtype=np.int64),
        cache_z=torch.randn((n_cached, 256), generator=gen).numpy())


@pytest.mark.gpu
def test_runtime_two_tenant_dispatch_parity_bit_identical_on_card():
    """An fp32 and an int8 tenant behind one registry on the card: every
    dispatched micro-batch equals a solo engine's bits, and the path ran
    through the lane-MLP forward and int8 kernels."""
    dev = _card()
    from repro_torch.serve import runtime as rt
    bundle = _serving_bundle()
    reg = rt.TenantRegistry(device=dev)
    for name, q in (("fp32", None), ("int8", "int8")):
        reg.register(name, bundle, quantize=q)
    reg.warmup()
    rng = np.random.RandomState(1)
    x_pool = rng.randn(600, 5).astype(np.float32)
    ids_pool = np.arange(600, dtype=np.int64)      # half of them cached
    stream = rt.merge_streams(*(
        rt.make_timed_stream(x_pool, ids_pool, 300, tenant=name, seed=k,
                             rate_rps=400.0, max_rows=64)
        for k, name in enumerate(("fp32", "int8"))))
    runtime = rt.ServingRuntime(reg, rt.RuntimeConfig(slo_ms=100.0))
    ops.reset_launches()
    report = runtime.run(stream)
    counts = dict(ops.LAUNCHES)
    assert report["served"] + report["shed_requests"] == 600
    assert counts["lane_mlp_fwd"] > 0 and counts["int8_matmul"] > 0
    parity = rt.verify_dispatch_parity(runtime, {"fp32": bundle,
                                                 "int8": bundle})
    for name, p in parity.items():
        assert p["batches"] > 0 and p["bit_identical"], (name, p)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-2.7b",
                                  "qwen3-moe-30b-a3b"])
def test_smoke_train_step_card_against_cpu(arch):
    """One AdamW step of the smoke config on the card against the CPU from
    the same weights: loss and grad norm within 1e-5 relative, each param
    leaf within 1e-4 in relative L2; no kernel launches inside the step
    (the training route), and the no-grad eval launches the kernels."""
    dev = _card()
    from repro_torch.configs import get_smoke
    from repro_torch.optim.adam import AdamW
    from repro_torch.sharding.policy import leaves
    from repro_torch.train.loop import make_train_step, task_loss
    from repro_torch.tree import tree_map
    cfg = get_smoke(arch)
    fns = make_train_step(cfg, AdamW())
    params, state = fns.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (4, 64)).astype(np.int32))
    out = {}
    for d in ("cpu", dev):
        p = tree_map(lambda t: t.to(d), params)
        s = type(state)(**tree_map(lambda t: t.to(d), state._asdict()))
        ops.reset_launches()
        p, s, m = fns.step(p, s, {"tokens": toks.to(d)})
        assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
        with torch.no_grad():
            ev = float(task_loss(p, cfg, {"tokens": toks.to(d)})[0])
        out[str(d)] = (m, p, ev, dict(ops.LAUNCHES))
    (mc, pc, ec, _), (mg, pg, eg, lg) = out["cpu"], out[str(dev)]
    for key in ("loss", "grad_norm"):
        assert abs(float(mg[key]) - float(mc[key])) <= 1e-5 * abs(
            float(mc[key])), key
    for a, b in zip(leaves(pg), leaves(pc)):
        assert float((a.cpu().double() - b.double()).norm()
                     / b.double().norm()) <= 1e-4
    assert abs(eg - ec) <= 1e-5 * abs(ec)
    assert lg["flash_attention"] > 0
    assert (lg["ssd_intra_chunk"] > 0) == (cfg.family == "hybrid")


def _moe_case(seed, B, S, dtype=torch.float32, cf=1.25):
    """The qwen3 smoke's MoE block: params and x from a numpy seed."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import ffn
    cfg = get_smoke("qwen3-moe-30b-a3b").with_(capacity_factor=cf)
    rng = np.random.RandomState(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": _randn(rng, d, E, scale=d ** -0.5),
         "w_gate": _randn(rng, E, d, f, scale=d ** -0.5).to(dtype),
         "w_up": _randn(rng, E, d, f, scale=d ** -0.5).to(dtype),
         "w_down": _randn(rng, E, f, d, scale=f ** -0.5).to(dtype)}
    return ffn, cfg, p, _randn(rng, B, S, d).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
def test_moe_card_against_cpu(cf):
    """The MoE at the qwen3 smoke's widths (E 4, k 2), card against CPU:
    the same experts, slots and dropped set, y within 1e-5 x max|y|, aux
    within 1e-6, and the gradients within 1e-5 of each one's max."""
    dev = _card()
    ffn, cfg, p, x = _moe_case(20, 4, 33, cf=cf)
    out = {}
    for d in ("cpu", dev):
        pd = {k: v.to(d).clone().requires_grad_() for k, v in p.items()}
        xd = x.to(d).clone().requires_grad_()
        r = ffn.route(pd["router"], cfg, xd.reshape(-1, cfg.d_model))
        y, aux = ffn.moe(pd, cfg, xd)
        (y.square().sum() + aux).backward()
        out[str(d)] = (r, y, aux, [xd.grad] + [pd[k].grad for k in
                                                sorted(pd)])
    (rc, yc, ac, gc), (rg, yg, ag, gg) = out["cpu"], out[str(dev)]
    assert torch.equal(rg.topi.cpu(), rc.topi)
    assert torch.equal(rg.slot.cpu(), rc.slot)
    yc = yc.detach()
    assert _maxerr(yg.detach().cpu(), yc) <= 1e-5 * float(yc.abs().max())
    assert abs(float(ag.detach()) - float(ac.detach())) <= 1e-6
    for a, b in zip(gg, gc):
        assert _maxerr(a.cpu(), b) <= 1e-5 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_repeats_bit_for_bit_on_card(dtype):
    """The dispatch and the combine are gathers and ordered adds: two calls
    (and two backward passes) give the same bits, dropped entries too."""
    dev = _card()
    ffn, cfg, p, x = _moe_case(21, 8, 64, dtype, cf=1.0)
    runs = []
    for _ in range(2):
        pd = {k: v.to(dev).clone().requires_grad_() for k, v in p.items()}
        xd = x.to(dev).clone().requires_grad_()
        y, aux = ffn.moe(pd, cfg, xd)
        (y.float().square().sum() + aux).backward()
        runs.append([y, aux, xd.grad] + [pd[k].grad for k in sorted(pd)])
    r = ffn.route(p["router"].to(dev), cfg, x.to(dev).reshape(-1,
                                                                cfg.d_model))
    assert bool((r.slot == cfg.n_experts * r.capacity).any())
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_hubert_forward_card_against_cpu():
    """hubert's smoke encoder (bidirectional attention) on the card against
    the CPU from the same weights: logits within 1e-4 x max|logit|, one
    non-causal flash launch a layer."""
    dev = _card()
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    from repro_torch.sharding.policy import init_params
    from repro_torch.tree import tree_map
    cfg = get_smoke("hubert-xlarge")
    params = init_params(M.schema(cfg), torch.Generator().manual_seed(0),
                         torch.float32, device="cpu")
    frames = _randn(np.random.RandomState(22), 2, 150, cfg.d_model)
    with torch.no_grad():
        want, _ = M.logits(params, cfg, {"frames": frames})
        ops.reset_launches()
        got, aux = M.logits(tree_map(lambda t: t.to(dev), params), cfg,
                            {"frames": frames.to(dev)})
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert float(aux) == 0.0
    assert _maxerr(got.cpu(), want) <= 1e-4 * float(want.abs().max())


# ---------------------------------------------------------------------------
# the VLM: flash at a key length of its own, decode over the image cache
# ---------------------------------------------------------------------------

# (B, S, T, H, K, hd): S text rows against T image tokens at
# llama-3.2-vision-11b's heads (one prompt, and one decode row), and ragged
# small heads
FLASH_CROSS = ((1, 256, 1600, 32, 8, 128), (2, 1, 1600, 32, 8, 128),
               (2, 100, 37, 4, 2, 64), (1, 64, 200, 4, 4, 32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_key_length_of_its_own_on_card(dtype):
    """k/v of T rows for S queries, non-causal, against the plain version
    on the same card tensors within the reference's bounds, and bf16 also
    against the plain version in fp32; a causal or windowed call at T != S
    raises before any launch."""
    dev = _card()
    rng = np.random.RandomState(23)
    ops.reset_launches()
    for B, S, T, H, K, hd in FLASH_CROSS:
        q, k, v = _attn_inputs(rng, dev, dtype, (B, S, H, hd),
                               (B, T, K, hd), (B, T, K, hd))
        got = ops.flash_attention(q, k, v, causal=False)
        want = ref.flash_attention_model(q, k, v, causal=False)
        assert got.shape == (B, S, H, hd) and got.dtype == dtype
        assert _allclose(got, want, ATTN_TOL[dtype]), (B, S, T, H, K, hd)
        if dtype == torch.bfloat16:
            want = ref.flash_attention_model(q.float(), k.float(), v.float(),
                                             causal=False)
            atol, rtol = FLASH_BF16_F32_TOL
            err = (got.float() - want).abs()
            assert bool((err <= atol + rtol * want.abs()).all()), \
                (B, S, T, float(err.max()))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == len(FLASH_CROSS)
    for causal, window in ((True, 0), (False, 16)):
        with pytest.raises(ValueError, match="keys for"):
            ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == len(FLASH_CROSS)


def _flash_before(lib, q, k, v, causal, window):
    """The flash kernel before its key length of its own, through its C
    interface (``flash_attention(q, k, v, out, B, S, H, K, hd, causal,
    window, scale, dtype, stream)``)."""
    import ctypes
    import math
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention.argtypes = [P] * 4 + [I] * 7 + [F, I, P]
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        k.shape[2], hd, int(causal), int(window), 1.0 / math.sqrt(hd),
        {torch.float32: 0, torch.bfloat16: 1}[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_equals_kernel_before_key_length_on_card(dtype):
    """At T = S the kernel keeps the bits of the kernel before it took a
    key length of its own, on both routes, every mask, GQA and MHA, ragged
    S and the VLM's self-attention (H 32 on K 8)."""
    dev = _card()
    before = _library_before("flash_attention")
    rng = np.random.RandomState(24)
    for B, S, H, K, hd in ((1, 128, 16, 8, 128), (2, 77, 4, 4, 32),
                           (1, 300, 8, 2, 80), (2, 512, 32, 8, 128)):
        q, k, v = _attn_inputs(rng, dev, dtype, (B, S, H, hd),
                               (B, S, K, hd), (B, S, K, hd))
        for causal, window in ((True, 0), (True, 100), (False, 0)):
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            want = _flash_before(before, q, k, v, causal, window)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (B, S, H, K, hd, causal, window)


# flash against its route before wgmma and TMA: chip_smoke.py's phase-2
# sets ((B, S, T, H, K, hd), causal, window), then S 1, ragged S and every
# other head dim the bf16 route takes (16, 48, 96, 112: each chunk class)
_FLASH_SETS = (
    [((B, S, S, H, K, hd), causal, window)
     for B, S, H, K, hd in chip_smoke.FLASH_SHAPES + (
         (1, 1, 16, 8, 128), (1, 70, 2, 1, 16), (1, 130, 4, 2, 48),
         (2, 96, 4, 4, 96), (1, 257, 2, 2, 112))
     for causal, window in chip_smoke.FLASH_MASKS]
    + [(shape, False, 0) for shape in chip_smoke.FLASH_CROSS])


def _flash_lib(lib, q, k, v, causal, window):
    """One launch of a library built from a ``csrc/flash_attention.cu``
    with the current C interface."""
    from repro_torch.kernels import flash_attention as fa
    real = fa._lib
    fa._lib = lambda: lib
    try:
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    finally:
        fa._lib = real


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window", _FLASH_SETS)
def test_flash_attention_equals_kernel_before_wgmma_on_card(shape, causal,
                                                            window, dtype):
    """The bf16 route on wgmma and TMA keeps the bits of its mma.sync route
    (every kv tile walked in the same order, the same online softmax, P
    rounded alike, and wgmma sums a k16 step as mma.sync does); the fp32
    route is unchanged."""
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    before = fa.bind(_library_before("flash_attention@9f296b7"))
    B, S, T, H, K, hd = shape
    rng = np.random.RandomState(S * 131 + T + hd)
    q, k, v = _attn_inputs(rng, dev, dtype, (B, S, H, hd), (B, T, K, hd),
                           (B, T, K, hd))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = _flash_lib(before, q, k, v, causal, window)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got.float() - want.float()).abs()
                                         .max())


@pytest.mark.gpu
def test_flash_attention_back_to_back_launches_on_card():
    """Launches on other tensors, shapes and head dims follow each other
    with no synchronisation between them: each output equals its own
    launch alone (a tensor map reused or read stale would show)."""
    dev = _card()
    rng = np.random.RandomState(27)
    cases = [((2, 300, 8, 2, 128), True, 0), ((2, 300, 8, 2, 128), True, 0),
             ((1, 200, 4, 4, 80), False, 0), ((2, 300, 8, 2, 128), True, 100),
             ((1, 64, 2, 2, 64), True, 0)]
    inputs = [_attn_inputs(rng, dev, torch.bfloat16, (B, S, H, hd),
                           (B, S, K, hd), (B, S, K, hd))
              for (B, S, H, K, hd), _, _ in cases]
    together = [ops.flash_attention(*a, causal=c, window=w)
                for a, (_, c, w) in zip(inputs, cases)]
    torch.cuda.synchronize()
    for a, (_, c, w), got in zip(inputs, cases, together):
        alone = ops.flash_attention(*a, causal=c, window=w)
        torch.cuda.synchronize()
        assert torch.equal(got, alone)
    assert not torch.equal(together[0], together[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_over_the_image_cache_on_card(dtype):
    """One decode row against the VLM's 1600 image tokens read as a slot
    cache with every slot valid (G 4: 32 q heads on 8 kv heads), as
    ``decode_cross_attention`` calls it, against the plain version."""
    dev = _card()
    rng = np.random.RandomState(25)
    W = 1600
    q, kc, vc = _attn_inputs(rng, dev, dtype, (8, 32, 128), (8, W, 8, 128),
                             (8, W, 8, 128))
    sp = torch.arange(W, dtype=torch.int32)
    _decode_check(dev, dtype, q, kc, vc, sp, W - 1, 0, "image cache")


@pytest.mark.gpu
def test_vlm_smoke_card_matches_cpu():
    """The VLM smoke (fp32) with nonzero gates and seeded images on the
    card against the CPU: logits within 1e-4 x max|logit| (one flash
    launch a block, self and cross), then 8 greedy decode steps from
    ``init_cache(image_embeds=)`` with identical tokens (one decode launch
    a block a step)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import build_params
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    dev = _card()
    cfg = get_smoke("llama-3.2-vision-11b")
    params = build_params(cfg, seed=3, device="cpu")
    rng = np.random.RandomState(26)
    gate = params["groups"]["cross"]["gate"]
    params["groups"]["cross"]["gate"] = torch.from_numpy(rng.uniform(
        0.3, 1.2, tuple(gate.shape)).astype(np.float32))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 48)).astype(
        np.int32))
    img = _randn(rng, 2, cfg.n_image_tokens, cfg.d_model)
    runs = []
    for d in (dev, "cpu"):
        p = tree_map(lambda t: t.to(d), params)
        ops.reset_launches()
        with torch.no_grad():
            full, _ = M.logits(p, cfg, {"tokens": toks.to(d),
                                        "image_embeds": img.to(d)})
            cache = M.init_cache(p, cfg, 2, 16, image_embeds=img.to(d))
            tok, lgs = toks[:, 0].to(d), []
            for t in range(8):
                lg, cache = M.decode(p, cfg, tok, cache, t)
                lgs.append(lg.cpu())
                tok = torch.argmax(lg, -1)
        runs.append((full.cpu(), torch.stack(lgs), dict(ops.LAUNCHES)))
    (fg, dg, lg), (fc, dc, lc) = runs
    assert lg["flash_attention"] == cfg.n_layers
    assert lg["decode_attention"] == 8 * cfg.n_layers
    assert lc["flash_attention"] == lc["decode_attention"] == 0
    for a, b in ((fg, fc), (dg, dc)):
        assert _maxerr(a, b) <= 1e-4 * float(b.abs().max())
    assert torch.equal(dg.argmax(-1), dc.argmax(-1))
