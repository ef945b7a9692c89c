"""The port's training kernels (lane-MLP backward, Eq. 5 row loss forward
and backward, probe step) against the JAX package, on the same
numpy-seeded inputs.

On the CPU the wrappers in ``repro_torch.kernels.ops`` take the plain
closed-form versions in ``repro_torch.kernels.ref``, and the autograd
Functions (``LaneMLP2``, ``DistillRows``) route through them, so these
tests pin both the arithmetic the CUDA kernels are held to on the card
(``tests/test_torch_gpu.py``) and the Functions' wiring.  The JAX side is
the reference's Pallas kernels in interpret mode (``jax.vjp`` of their
custom VJPs) and its ``kernels/ref.py`` oracles.

Bounds are the reference's (``benchmarks/kernelbench.py``): lane-MLP
gradients 1e-5 relative (max error over max(max|ref|, 1)), the Eq. 5 rows
1e-5, the probe 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.distill_loss import fused_distill_rows as jax_rows
from repro.kernels.lane_mlp import fused_lane_mlp2 as jax_lane_mlp2
from repro.kernels.lane_mlp import fused_mlp2 as jax_fused_mlp2
from repro.kernels.probe import probe_grad_step as jax_probe_step
from repro_torch.kernels import ops, ref

REL = 1e-5
# the eight Table-3 autoencoder MLPs at mimic3 widths, (din, h, dz), with
# the hidden and latent widths narrowed 4x for the interpret-mode kernels
AE_SHAPES = {
    "g1_active.enc": (5, 64, 128), "g1_active.dec": (128, 64, 5),
    "g1_passive.enc": (10, 128, 256), "g1_passive.dec": (256, 128, 10),
    "g2.enc": (384, 256, 256), "g2.dec": (256, 256, 384),
    "g3.enc": (5, 256, 256), "g3.dec": (256, 256, 5)}
NARROW = {k: tuple(max(w // 4, 5) for w in v) for k, v in AE_SHAPES.items()}


def _relerr(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1.0))


def _mlp_arrays(seed, B, din, h, dz, lanes=()):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.randn(*lanes, *s) * scale).astype(
        np.float32)
    return (f(B, din), f(din, h, scale=din ** -0.5), f(h, scale=0.1),
            f(h, dz, scale=h ** -0.5), f(dz, scale=0.1), f(B, dz))


def _torch_grads(arrs, final_act, lanes=False, live=None):
    """Gradients of sum(out * g) through the port's differentiable
    wrapper (the ``LaneMLP2`` Function on the CPU)."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:5]]
    if lanes:
        out = ops.fused_lane_mlp2(*ts, torch.from_numpy(live),
                                  final_act=final_act)
    else:
        out = ops.fused_mlp2(*ts, final_act=final_act)
    torch.sum(out * torch.from_numpy(arrs[5])).backward()
    return [t.grad.numpy() for t in ts], out.detach().numpy()


@pytest.mark.parametrize("B,final_act", [(1, False), (77, False),
                                         (77, True)])
@pytest.mark.parametrize("name", list(NARROW))
def test_mlp2_bwd_matches_jax_vjp(name, B, final_act):
    arrs = _mlp_arrays(list(NARROW).index(name) * 100 + B, B, *NARROW[name])
    x, w0, b0, w1, b1, g = arrs
    out, vjp = jax.vjp(lambda *a: jax_fused_mlp2(
        *a, final_act=final_act, interpret=True),
        *map(jnp.asarray, (x, w0, b0, w1, b1)))
    want = vjp(jnp.asarray(g))
    # the closed-form plain backward from the saved pre-activations
    t = [torch.from_numpy(a) for a in arrs]
    _, a1, a2 = ref.mlp2_fwd_ref(*t[:5], final_act=final_act)
    got = ref.mlp2_bwd_ref(t[5], t[0], a1, a2, t[1], t[3], final_act)
    for a, b in zip(got, want):
        assert _relerr(a.numpy(), b) <= REL, name
    # the same through the autograd Function, and vs torch autograd of
    # the plain forward
    fn_grads, fn_out = _torch_grads(arrs, final_act)
    assert _relerr(fn_out, out) <= REL
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:5]]
    torch.sum(ref.mlp2_ref(*ts, final_act=final_act) * t[5]).backward()
    for a, b, c in zip(fn_grads, want, ts):
        assert _relerr(a, b) <= REL, name
        assert _relerr(a, c.grad.numpy()) <= REL, name


def test_lane_mlp2_with_dead_lane_matches_jax():
    arrs = _mlp_arrays(7, 40, 12, 16, 9, lanes=(3,))
    live = np.array([1.0, 0.0, 1.0], np.float32)
    got, out = _torch_grads(arrs, False, lanes=True, live=live)
    want_out, vjp = jax.vjp(
        lambda *a: jax_lane_mlp2(*a, jnp.asarray(live), interpret=True),
        *map(jnp.asarray, arrs[:5]))
    assert _relerr(out, want_out) <= REL
    for a, b in zip(got, vjp(jnp.asarray(arrs[5]))):
        assert _relerr(a, b) <= REL
        assert not np.any(a[1])          # the dead lane: exact zeros
    assert not np.any(out[1])


def _distill_arrays(seed, B=50, D=7, M=24):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    z, zt = f(B, M), f(B, M)
    zt[::5, ::3] = z[::5, ::3]                 # exact ties: sign(0) = 0
    mask = (rng.rand(B) > 0.4).astype(np.float32)
    return f(B, D), f(B, D), z, zt, mask, f(B)


@pytest.mark.parametrize("kind", ["mse", "mae"])
def test_distill_rows_fwd_bwd_match_jax_kernel(kind):
    x, xh, z, zt, mask, g = _distill_arrays(1)
    lam = 0.3
    want, vjp = jax.vjp(lambda *a: jax_rows(*a, lam=lam, kind=kind,
                                            interpret=True),
                        *map(jnp.asarray, (x, xh, z, zt, mask)))
    want_grads = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a) for a in (x, xh, z, zt, mask, g)]
    rows = ref.distill_rows_ref(*t[:5], lam=lam, kind=kind)
    np.testing.assert_allclose(rows.numpy(), want, atol=1e-5, rtol=0)
    dx, dz, dm = ref.distill_rows_bwd_ref(t[5], *t[:5], lam=lam, kind=kind)
    for a, b in zip((dx, -dx, dz, -dz, dm), want_grads):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0)
    # the autograd Function, with a lane axis folded into the rows
    ts = [torch.from_numpy(a.reshape(2, 25, *a.shape[1:]))
          .requires_grad_(True) for a in (x, xh, z, zt, mask)]
    out = ops.fused_distill_rows(*ts, lam=lam, kind=kind)
    assert out.shape == (2, 25)
    torch.sum(out * torch.from_numpy(g.reshape(2, 25))).backward()
    np.testing.assert_allclose(out.detach().numpy().reshape(-1), want,
                               atol=1e-5, rtol=0)
    for a, b in zip(ts, want_grads):
        np.testing.assert_allclose(a.grad.numpy().reshape(b.shape), b,
                                   atol=1e-5, rtol=0)


def test_distill_loss_is_the_mean_of_the_rows():
    x, xh, z, zt, mask, _ = _distill_arrays(2)
    t = [torch.from_numpy(a) for a in (x, xh, z, zt, mask)]
    got = float(ops.fused_distill_loss(*t, lam=0.01))
    want = float(jref.fused_distill_loss_ref(*map(jnp.asarray,
                                                  (x, xh, z, zt, mask))))
    assert abs(got - want) <= 1e-6


def _probe_arrays(seed, n=150, d=24, C=4, k=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randint(0, C, n).astype(np.int32)
    w = (rng.randn(k, d, C) * 0.3).astype(np.float32)
    b = (rng.randn(k, C) * 0.1).astype(np.float32)
    rw = (rng.rand(k, n) > 0.3).astype(np.float32)   # rows at weight 0
    return w, b, x, y, rw


def test_probe_grad_step_matches_jax_kernel_and_oracle():
    w, b, x, y, rw = _probe_arrays(3)
    t = lambda a: torch.from_numpy(a)
    lanes = ops.probe_grad_step(t(w), t(b), t(x), t(y), t(rw))
    for i in range(w.shape[0]):
        kern = jax_probe_step(*map(jnp.asarray, (w[i], b[i], x, y, rw[i])),
                              interpret=True)
        oracle = jref.probe_grad_ref(*map(jnp.asarray,
                                          (w[i], b[i], x, y, rw[i])))
        single = ops.probe_grad_step(t(w[i]), t(b[i]), t(x), t(y), t(rw[i]))
        for got_lane, got_one, k_, o in zip(lanes, single, kern, oracle):
            np.testing.assert_allclose(got_lane[i].numpy(), k_, atol=1e-4)
            np.testing.assert_allclose(got_one.numpy(), o, atol=1e-4)


def test_probe_zero_weight_rows_are_inert():
    w, b, x, y, rw = _probe_arrays(4, k=1)
    t = lambda a: torch.from_numpy(a)
    keep = rw[0] > 0
    rwn = t(rw / rw.sum(-1, keepdims=True))
    full = ref.probe_grad_ref(t(w), t(b), t(x), t(y), rwn)
    x2, y2 = x.copy(), y.copy()
    x2[~keep] = 1e3 * np.random.RandomState(0).randn(int((~keep).sum()),
                                                     x.shape[1])
    y2[~keep] = 0
    moved = ref.probe_grad_ref(t(w), t(b), t(x2), t(y2), rwn)
    for a, c in zip(full, moved):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_probe_step_is_the_gradient_of_the_weighted_loss():
    """The probe step (kernel semantics) against autograd of the port's
    ``_weighted_logreg_loss`` and the reference's loss value."""
    from repro.core import classifier as jclf
    from repro_torch.core import classifier as tclf
    w, b, x, y, rw = _probe_arrays(5, k=1)
    w, b, rw = w[0], b[0], rw[0]
    t = lambda a: torch.from_numpy(a)
    wt, bt = t(w).requires_grad_(True), t(b).requires_grad_(True)
    loss = tclf._weighted_logreg_loss({"w": wt, "b": bt}, t(x), t(y), t(rw))
    dw, db = torch.autograd.grad(loss, (wt, bt))
    got = ops.probe_grad_step(t(w), t(b), t(x), t(y), t(rw))
    want = float(jclf._weighted_logreg_loss(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        *map(jnp.asarray, (x, y, rw))))
    assert abs(float(loss.detach()) - want) <= 1e-5
    assert abs(float(got[0]) - want) <= 1e-5
    np.testing.assert_allclose(got[1].numpy(), dw.numpy(), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), db.numpy(), atol=1e-6)
