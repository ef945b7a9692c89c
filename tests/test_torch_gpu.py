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
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import lane_mlp, ops, ref
from repro_torch.serve import quant

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
    for a, b in zip(got, want):
        assert _relerr(a.cpu(), b) <= 1e-5
        assert not bool(a[1].any())


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
# ignored build directory: the redesign kept every sum order, so the bits
# must not move
BEFORE_REDESIGN = "ba1cb40fc083caff77ebf5316ec6d49afb092394"


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
             f"{BEFORE_REDESIGN}:src/repro_torch/kernels/csrc/{name}.cu"],
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


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mse", "mae"])
def test_distill_rows_match_plain_on_card(kind):
    from repro_torch.kernels import distill_loss
    dev = _card()
    rng = np.random.RandomState(5)
    for B, D, M in ((128, 5, 256), (77, 384, 256), (1, 5, 256)):
        x, xh = _randn(rng, B, D).to(dev), _randn(rng, B, D).to(dev)
        z, zt = _randn(rng, B, M).to(dev), _randn(rng, B, M).to(dev)
        zt[::3, ::4] = z[::3, ::4]                  # sign(0) = 0
        mask = torch.from_numpy((rng.rand(B) > 0.5).astype(np.float32)
                                ).to(dev)
        g = _randn(rng, B).to(dev)
        got = distill_loss.launch_fwd(x, xh, z, zt, mask, lam=0.3, kind=kind)
        want = ref.distill_rows_ref(x, xh, z, zt, mask, lam=0.3, kind=kind)
        assert _maxerr(got, want) <= 1e-5
        got = distill_loss.launch_bwd(g, x, xh, z, zt, mask, lam=0.3,
                                      kind=kind)
        want = ref.distill_rows_bwd_ref(g, x, xh, z, zt, mask, lam=0.3,
                                        kind=kind)
        for a, b in zip(got, want):
            assert _maxerr(a, b) <= 1e-5


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
    """The bf16 route runs on m16n8k16 tensor-core tiles: hd 72 raises,
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
# (internlm2-20b, nemotron-4-15b), 8 (yi-6b), and the smokes' hd 64
DECODE_HEADS = ((16, 8, 128), (32, 32, 80), (48, 8, 128), (32, 4, 128),
                (4, 2, 64))


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
    dev = _card()
    rng = np.random.RandomState(8)
    B = 2
    for (H, K, hd), (W, pos) in itertools.product(
            DECODE_HEADS, ((64, 40), (77, 76), (1000, 0), (1024, 700))):
        q, kc, vc = _attn_inputs(rng, dev, dtype, (B, H, hd),
                                 (B, W, K, hd), (B, W, K, hd))
        for window in (0, 48):
            _decode_check(dev, dtype, q, kc, vc, _prefix_slots(W, pos), pos,
                          window, (H, K, hd, W, pos, window))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_wrapped_ring_on_card(dtype):
    """A windowed ring that has wrapped (slot positions not monotone in
    the slot index), with windows inside and equal to the ring, at the
    engine's batch of 8 (clusters of 8 blocks) and at 64 (clusters of 1)."""
    dev = _card()
    rng = np.random.RandomState(11)
    for B, (H, K, hd) in ((8, (16, 8, 128)), (64, (32, 32, 80))):
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
    and a cache with every slot empty, which gives exact zeros."""
    dev = _card()
    rng = np.random.RandomState(12)
    B, H, K, hd, W = 8, 16, 8, 128, 1024
    q, kc, vc = _attn_inputs(rng, dev, dtype, (B, H, hd), (B, W, K, hd),
                             (B, W, K, hd))
    back = np.full(W, -1, np.int32)
    back[1000:1010] = np.arange(10)
    for sp, pos in ((_prefix_slots(3, 2), 2), (torch.from_numpy(back), 9)):
        sp = torch.cat([sp, torch.full((W - len(sp),), -1,
                                       dtype=torch.int32)])
        _decode_check(dev, dtype, q, kc, vc, sp, pos, 0, (pos,))
    empty = torch.full((W,), -1, dtype=torch.int32)
    got = _decode_check(dev, dtype, q, kc, vc, empty, 10, 0, "empty")
    assert not bool((got != 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_repeats_bit_for_bit_on_card(dtype):
    """No atomics and a fixed merge order: two launches give the same
    bits, split over clusters of 8 blocks (B 8, K 8) and of 1 (B 64, K
    32)."""
    dev = _card()
    rng = np.random.RandomState(13)
    for B, H, K, hd in ((8, 16, 8, 128), (64, 32, 32, 80)):
        q, kc, vc = _attn_inputs(rng, dev, dtype, (B, H, hd),
                                 (B, 1024, K, hd), (B, 1024, K, hd))
        sp = _prefix_slots(1024, 511).to(dev)
        runs = [ops.decode_attention(q, kc, vc, sp, 511) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(*runs), (B, K)


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
# per-step log-decays down to -16
SSD_CASES = {"zamba2": (2, 512, 80, 1, 64, 64, 256, False),
             "zamba2 prefill": (2, 2048, 80, 1, 64, 64, 256, False),
             "ragged grouped": (1, 100, 6, 2, 16, 32, 100, False),
             "steep decay": (2, 512, 8, 1, 64, 64, 256, True)}


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_intra_chunk_matches_plain_on_card(case):
    dev = _card()
    B, S, H, G, N, P, Lc, steep = SSD_CASES[case]
    args = [t.to(dev) for t in _ssd_inputs(np.random.RandomState(11), B, S,
                                            H, G, N, P, steep)]
    ops.reset_launches()
    y, st = ops.ssd_intra_chunk(*args, Lc)
    assert ops.LAUNCHES["ssd_intra_chunk"] == 1
    y_want, st_want = ref.ssd_intra_chunk_ref(*args, Lc)
    assert y.shape == (B, S, H, P) and st.shape == (B, S // Lc, H, N, P)
    assert _allclose(y, y_want, TOL_SSD) and _allclose(st, st_want, TOL_SSD)
    y_cpu, st_cpu = ops.ssd_intra_chunk(*(t.cpu() for t in args), Lc)
    assert _allclose(y, y_cpu, TOL_SSD) and _allclose(st, st_cpu, TOL_SSD)


@pytest.mark.gpu
def test_ssd_bf16_raises_on_card():
    dev = _card()
    args = [t.to(dev) for t in _ssd_inputs(np.random.RandomState(12), 1, 64,
                                            4, 1, 16, 16, False)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.ssd_intra_chunk(*args, 32, bf16=True)


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
