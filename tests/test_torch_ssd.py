"""The port's Mamba2 SSD against the live JAX package on the CPU: the plain
intra-chunk block (``ref.ssd_intra_chunk_ref``, what ``ops.ssd_intra_chunk``
runs for a CPU tensor) against the Pallas kernel in interpret mode (2e-4,
the reference's bound), ``ssd_chunked`` against the reference's (1e-5
relative to max|y|) and both against the sequential oracle (1e-3, the
reference's), and the ``ssd_bf16`` route against the reference's.  Inputs
come from a numpy seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels.ref import ssd_chunk_ref as jssd_chunk_ref
from repro.kernels.ssd_chunk import ssd_intra_chunk as jssd_intra_chunk
from repro.models import mamba2 as jmamba2
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba2

TOL_KERNEL = 2e-4        # tests/test_kernels.py::test_ssd_intra_chunk_kernel
TOL_CHUNKED = 1e-5       # port vs reference ssd_chunked, relative to max|y|
TOL_ORACLE = 1e-3        # tests/test_kernels.py::test_ssd_chunked_matches_ref
# bf16 intra-chunk operands, relative to max|y|: XLA's CPU einsums and
# PyTorch's round the bf16 products at other places (measured 1.3e-3 for y
# and 1.9e-3 for the final state; one bf16 ulp is 3.9e-3)
TOL_BF16 = 5e-3


def _inputs(seed, B, S, H, P, G, N, steep=False):
    """x, dt, A, Bm, Cm as the model hands them to ``ssd_chunked``: dt a
    softplus, A negative (``steep``: per-step log-decays down to -16)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    x = f(B, S, H, P)
    dt = np.logaddexp(f(B, S, H), 0).astype(np.float32)
    A = (-np.exp(f(H) * 0.5)).astype(np.float32)
    if steep:
        dt = rng.rand(B, S, H).astype(np.float32)
        A = -np.exp(rng.rand(H) * np.log(16.0)).astype(np.float32)
    return x, dt, A, f(B, S, G, N), f(B, S, G, N)


def _pallas_intra(x, dt, A, Bm, Cm, Lc):
    """The Pallas kernel in interpret mode on the model's layout, through
    the layout transform of ``tests/test_kernels.py``
    (``test_ssd_kernel_composes_full_scan``)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    Nc = S // Lc
    ch = lambda t: t.reshape((B, Nc, Lc) + t.shape[2:])
    a = ch(dt * A)                                    # (B,Nc,Lc,H)
    xdt = ch(x * dt[..., None])
    Bh = np.repeat(ch(Bm), H // G, axis=3)
    Chh = np.repeat(ch(Cm), H // G, axis=3)
    g5 = lambda t: np.moveaxis(t, 3, 2).reshape((B * Nc * H, Lc)
                                                + t.shape[4:])
    y, st = jssd_intra_chunk(
        jnp.asarray(np.moveaxis(a, 3, 2).reshape(B * Nc * H, Lc)),
        *(jnp.asarray(g5(t)) for t in (Bh, Chh, xdt)), interpret=True)
    y = np.moveaxis(np.asarray(y).reshape(B, Nc, H, Lc, P), 2, 3)
    return y.reshape(B, S, H, P), np.asarray(st).reshape(B, Nc, H, N, P)


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("Lc,N,P,H,G", [(32, 8, 16, 4, 1), (64, 16, 32, 4, 1),
                                        (128, 16, 64, 4, 1),
                                        (32, 16, 32, 6, 2)])
def test_plain_intra_chunk_matches_pallas_kernel(Lc, N, P, H, G):
    args = _inputs(Lc + N, 2, 2 * Lc, H, P, G, N)
    y_want, st_want = _pallas_intra(*args, Lc)
    y, st = ops.ssd_intra_chunk(*_t(*args), Lc)
    assert y.shape == (2, 2 * Lc, H, P) and st.shape == (2, 2, H, N, P)
    assert y.dtype == st.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_want, atol=TOL_KERNEL,
                               rtol=TOL_KERNEL)
    np.testing.assert_allclose(st.numpy(), st_want, atol=TOL_KERNEL,
                               rtol=TOL_KERNEL)
    assert ops.LAUNCHES["ssd_intra_chunk"] == 0


def test_plain_intra_chunk_ragged_and_steep_cases():
    """The two other cases ``chip_smoke.py`` holds the kernel to: a ragged
    grouped chunk (S 100, so Lc 100) and per-step log-decays down to -16,
    where far pairs underflow to 0, against the Pallas kernel."""
    for args, Lc in ((_inputs(5, 1, 100, 6, 32, 2, 16), 100),
                     (_inputs(6, 1, 256, 4, 32, 1, 16, steep=True), 128)):
        y_want, st_want = _pallas_intra(*args, Lc)
        y, st = ops.ssd_intra_chunk(*_t(*args), Lc)
        np.testing.assert_allclose(y.numpy(), y_want, atol=TOL_KERNEL,
                                   rtol=TOL_KERNEL)
        np.testing.assert_allclose(st.numpy(), st_want, atol=TOL_KERNEL,
                                   rtol=TOL_KERNEL)
    x, dt, A, _, _ = _inputs(6, 1, 256, 4, 32, 1, 16, steep=True)
    assert float((dt * A).min()) < -14.0


def test_prefix_sum_is_torch_cumsum_on_cpu():
    """The float64-accumulated prefix sums are ``torch.cumsum``'s on the
    CPU bit for bit."""
    a = torch.from_numpy(-np.random.RandomState(0).rand(3, 256).astype(
        np.float32) * 16)
    assert torch.equal(ref.prefix_sum(a, 1), torch.cumsum(a, 1))


def _cfgs():
    jc, tc = jget_smoke("zamba2-2.7b"), get_smoke("zamba2-2.7b")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    return jc, tc


def _jchunked(jc):
    """The reference's ``ssd_chunked`` under ``jax.jit``."""
    return jax.jit(lambda x, dt, A, Bm, Cm, h0=None: jmamba2.ssd_chunked(
        jc, x, dt, A, Bm, Cm, init_state=h0))


def _relerr(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference_and_oracle(with_state):
    jc, tc = _cfgs()
    H, P, G, N = tc.ssm_heads, tc.ssm_head_dim, tc.ssm_groups, tc.ssm_state
    args = _inputs(11, 2, 64, H, P, G, N)       # Lc 32: two chunks
    h0 = (np.random.RandomState(12).randn(2, H, N, P).astype(np.float32)
          if with_state else None)
    y_want, hT_want = _jchunked(jc)(
        *map(jnp.asarray, args),
        None if h0 is None else jnp.asarray(h0))
    y, hT = mamba2.ssd_chunked(
        tc, *_t(*args), init_state=None if h0 is None else torch.from_numpy(
            h0))
    assert _relerr(y.numpy(), y_want) <= TOL_CHUNKED
    assert _relerr(hT.numpy(), hT_want) <= TOL_CHUNKED
    if not with_state:
        oracle = jax.jit(jssd_chunk_ref)(*map(jnp.asarray, args))
        np.testing.assert_allclose(y.numpy(), np.asarray(oracle),
                                   atol=TOL_ORACLE, rtol=TOL_ORACLE)
        np.testing.assert_allclose(
            ref.ssd_chunk_ref(*_t(*args)).numpy(), np.asarray(oracle),
            atol=TOL_ORACLE, rtol=TOL_ORACLE)


def test_ssd_chunked_single_short_chunk_and_bad_chunk():
    """Lc = min(ssm_chunk, S): a 20-token prompt is one chunk of 20; a
    sequence the chunk does not divide raises (the reference asserts)."""
    jc, tc = _cfgs()
    H, P, G, N = tc.ssm_heads, tc.ssm_head_dim, tc.ssm_groups, tc.ssm_state
    args = _inputs(13, 1, 20, H, P, G, N)
    y_want, _ = _jchunked(jc)(*map(jnp.asarray, args))
    y, _ = mamba2.ssd_chunked(tc, *_t(*args))
    assert _relerr(y.numpy(), y_want) <= TOL_CHUNKED
    with pytest.raises(ValueError, match="does not divide"):
        mamba2.ssd_chunked(tc, *_t(*_inputs(13, 1, 40, H, P, G, N)))


def test_ssd_bf16_route_matches_reference():
    jc, tc = _cfgs()
    jc, tc = jc.with_(ssd_bf16=True), tc.with_(ssd_bf16=True)
    H, P, G, N = tc.ssm_heads, tc.ssm_head_dim, tc.ssm_groups, tc.ssm_state
    args = _inputs(14, 2, 64, H, P, G, N)
    y_want, hT_want = _jchunked(jc)(*map(jnp.asarray, args))
    y, hT = mamba2.ssd_chunked(tc, *_t(*args))
    assert y.dtype == hT.dtype == torch.float32
    assert _relerr(y.numpy(), y_want) <= TOL_BF16
    assert _relerr(hT.numpy(), hT_want) <= TOL_BF16
    # and it is a different route from fp32's
    y32, _ = mamba2.ssd_chunked(tc.with_(ssd_bf16=False), *_t(*args))
    assert _relerr(y.numpy(), y32.numpy()) > 1e-4


def test_softplus_is_the_reference_form():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` switches
    to x above 20."""
    x = np.linspace(-40, 40, 4001).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = mamba2.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_kernel_launcher_refuses_cpu_tensors():
    from repro_torch.kernels import ssd_chunk
    args = _t(*_inputs(15, 1, 32, 4, 16, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk.launch(*args, 32)
