"""The port's optimizer, losses and training engine against the live JAX
package on the CPU.

Randomness crosses as arrays: the JAX side's initial params are converted
to tensors, and the port's ``perm_fn`` hands it the reference's epoch
permutations, ``jax.random.permutation(fold_in(PRNGKey(seed), epoch),
n)``.  The host splits (``np.random.RandomState``) are the port's own and
must agree exactly.  Epoch and step counts must be equal; losses and
params agree to 1e-5 relative (float reassociation between the two
CPU backends).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autoencoder as jae
from repro.core import distill as jdistill
from repro.core import training as jtraining
from repro.optim import adam as jadam
from repro_torch import convert
from repro_torch.core import autoencoder as tae
from repro_torch.core import distill as tdistill
from repro_torch.core import training as ttraining
from repro_torch.optim import adam as tadam
from repro_torch.tree import tree_leaves

REL = 1e-5


def jax_perm(seed, epoch, n):
    """The reference engine's epoch permutation, as an array."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return np.asarray(jax.random.permutation(key, n))


def _t(tree):
    return convert.to_torch(jax.tree.map(np.asarray, tree), device="cpu")


def _relerr(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1.0))


def _assert_params_close(got, want):
    got = [t.detach().numpy() for t in tree_leaves(got)]
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert _relerr(g, w) <= REL


def _assert_fit_equal(got, want):
    assert (got.epochs_run, got.steps_run) == (want.epochs_run,
                                               want.steps_run)
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=REL)
    np.testing.assert_allclose(got.val_loss, want.val_loss, rtol=REL)
    _assert_params_close(got.params, want.params)


def test_paper_adam_matches_reference_on_identical_gradients():
    rng = np.random.RandomState(0)
    shapes = {"w": (6, 4), "b": (4,)}
    p_j = {k: jnp.asarray(rng.randn(*s).astype(np.float32))
           for k, s in shapes.items()}
    p_t = _t(p_j)
    opt_j, opt_t = jadam.paper_adam(3e-3), tadam.paper_adam(3e-3)
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    for _ in range(25):
        g = {k: rng.randn(*s).astype(np.float32) * 10 ** rng.uniform(-4, 1)
             for k, s in shapes.items()}
        p_j, s_j, _ = opt_j.update(jax.tree.map(jnp.asarray, g), s_j, p_j)
        p_t, s_t = opt_t.update(_t(g), s_t, p_t)
    assert int(s_t.step) == int(s_j.step) == 25
    for k in shapes:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(s_t.v[k].numpy(), np.asarray(s_j.v[k]),
                                   rtol=1e-6)


def _trace_runs():
    """The two oracle workloads of tests/test_training_engine.py."""
    def toy(n=256, d=12, seed=0):
        x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
        return jae.init_autoencoder(jax.random.PRNGKey(seed),
                                    [d, 16, 8]), {"x": x}
    p, d = toy()
    yield "full_batch", p, d, dict(batch_size=10_000, max_epochs=8,
                                   patience=8, seed=3)
    p, d = toy(n=200, d=8, seed=1)
    yield "minibatch", p, d, dict(batch_size=36, max_epochs=12,
                                  patience=12, seed=1)


@pytest.mark.parametrize("name", ["full_batch", "minibatch"])
def test_train_matches_reference_engine(name):
    (p, data, kw), = [(p, d, kw) for n, p, d, kw in _trace_runs()
                      if n == name]
    want = jtraining.train(p, data, jae.recon_loss, **kw)
    got = ttraining.train(_t(p), data, tae.recon_loss, perm_fn=jax_perm,
                          **kw)
    _assert_fit_equal(got, want)


def test_train_early_stops_and_returns_best_params():
    x = np.random.RandomState(5).randn(90, 5).astype(np.float32)
    p = jae.init_autoencoder(jax.random.PRNGKey(5), [5, 8, 4])
    kw = dict(batch_size=16, max_epochs=40, patience=2, lr=3e-2, seed=5)
    want = jtraining.train(p, {"x": x}, jae.recon_loss, **kw)
    got = ttraining.train(_t(p), {"x": x}, tae.recon_loss, perm_fn=jax_perm,
                          **kw)
    assert got.epochs_run < 40
    _assert_fit_equal(got, want)


def _lane(n, d, seed, widths, x=None):
    if x is None:
        x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return (jae.init_autoencoder(jax.random.PRNGKey(seed), widths),
            {"x": x}, seed)


def _mixed_lanes():
    """Three lanes that differ in rows, feature width and architecture;
    the near-constant one stops early (tests/test_train_many.py)."""
    rng = np.random.RandomState(0)
    easy = (np.full((125, 4), 0.5, np.float32)
            + 1e-3 * rng.randn(125, 4).astype(np.float32))
    return [_lane(150, 6, 0, [6, 8, 16]), _lane(260, 11, 1, [11, 16, 32]),
            _lane(125, 4, 2, [4, 8, 4], x=easy)]


def test_train_lanes_matches_reference_on_mixed_shapes():
    lanes = _mixed_lanes()
    kw = dict(batch_size=32, max_epochs=10, patience=2, lr=1e-2)
    want = jtraining.train_lanes(
        [jtraining.LaneSpec(p, d, s) for p, d, s in lanes],
        jae.masked_recon_loss, **kw)
    got = ttraining.train_lanes(
        [ttraining.LaneSpec(_t(p), d, s) for p, d, s in lanes],
        tae.masked_recon_loss, perm_fn=jax_perm, **kw)
    assert len({r.epochs_run for r in got}) > 1     # stops differ
    for g, w in zip(got, want):
        _assert_fit_equal(g, w)


def test_padded_lane_group_matches_reference():
    """One padded stack of all three lanes (the grouping bypassed): zero-
    padded params and features, per-lane step budgets (rows differ) and
    the stable partition of real rows, against the reference's lane
    engine on the same stack."""
    lanes = _mixed_lanes()
    kw = dict(batch_size=32, max_epochs=10, patience=2, lr=1e-2,
              val_frac=0.1)
    want = jtraining._train_lanes_epochwise_group(
        [jtraining.LaneSpec(p, d, s) for p, d, s in lanes],
        jae.masked_recon_loss, **kw)
    got = ttraining._fit_group(
        [ttraining.LaneSpec(_t(p), d, s) for p, d, s in lanes],
        tae.make_masked_recon_loss(True), perm_fn=jax_perm, **kw)
    assert len({r.steps_run // r.epochs_run for r in got}) == 3
    assert len({r.epochs_run for r in got}) > 1     # stops differ
    for g, w in zip(got, want):
        _assert_fit_equal(g, w)


def _distill_batch(seed, B=40, d=8, m=4, lanes=False):
    rng = np.random.RandomState(seed)
    batch = {"x": rng.randn(B, d).astype(np.float32),
             "z_teacher": rng.randn(B, m).astype(np.float32),
             "aligned": (rng.rand(B) > 0.5).astype(np.float32)}
    if lanes:
        fm = np.ones(d, np.float32)
        fm[-2:] = 0.0                                # padded features
        batch["x"][:, -2:] = 0.0
        batch["mask"] = fm
        batch["row_w"] = (rng.rand(B) > 0.2).astype(np.float32)
    return batch


def _value_and_grads(loss, params, batch):
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    v = loss(params, {k: torch.from_numpy(a) for k, a in batch.items()})
    grads = torch.autograd.grad(v, leaves)
    return float(v.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("kind", ["mse", "mae"])
def test_distill_losses_match_reference(kind, lanes, use_kernel):
    p = jae.init_autoencoder(jax.random.PRNGKey(2), [8, 16, 4])
    batch = _distill_batch(3, lanes=lanes)
    make_j = jdistill.make_lanes_loss if lanes else jdistill.make_loss
    make_t = tdistill.make_lanes_loss if lanes else tdistill.make_loss
    lj = make_j(lam=0.3, kind=kind, use_kernel=use_kernel)
    lt = make_t(lam=0.3, kind=kind, use_kernel=use_kernel)
    assert lt.cache_key == lj.cache_key
    vj, gj = jax.value_and_grad(lj)(p, jax.tree.map(jnp.asarray, batch))
    vt, gt = _value_and_grads(lt, _t(p), batch)
    assert abs(vt - float(vj)) <= 1e-6
    for a, b in zip(gt, jax.tree.leaves(gj)):
        assert _relerr(a, b) <= REL


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lanes_loss_stacks_lanes(use_kernel):
    """Two lanes through one call of the lane loss (one launch per kernel
    on the card) give each lane's own loss and gradients."""
    ps = [jae.init_autoencoder(jax.random.PRNGKey(s), [8, 16, 4])
          for s in (4, 5)]
    batches = [_distill_batch(s, lanes=True) for s in (6, 7)]
    stack = lambda trees: jax.tree.map(lambda *a: np.stack(a), *trees)
    lt = tdistill.make_lanes_loss(lam=0.1, use_kernel=use_kernel)
    params = _t(stack(ps))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    v = lt(params, {k: torch.from_numpy(a)
                    for k, a in stack(batches).items()})
    assert v.shape == (2,)
    grads = torch.autograd.grad(v.sum(), leaves)
    lj = jdistill.make_lanes_loss(lam=0.1, use_kernel=use_kernel)
    for i, (p, b) in enumerate(zip(ps, batches)):
        vj, gj = jax.value_and_grad(lj)(p, jax.tree.map(jnp.asarray, b))
        assert abs(float(v[i]) - float(vj)) <= 1e-6
        for a, w in zip(grads, jax.tree.leaves(gj)):
            assert _relerr(a[i].numpy(), w) <= REL


def test_recon_loss_makers_match_reference():
    p = jae.init_autoencoder(jax.random.PRNGKey(8), [8, 16, 4])
    batch = _distill_batch(9, lanes=True)
    for use_kernel in (False, True):
        for mj, mt in ((jae.make_recon_loss, tae.make_recon_loss),
                       (jae.make_masked_recon_loss,
                        tae.make_masked_recon_loss)):
            lj, lt = mj(use_kernel), mt(use_kernel)
            assert getattr(lt, "cache_key", None) == getattr(
                lj, "cache_key", None)
            vj, gj = jax.value_and_grad(lj)(p, jax.tree.map(jnp.asarray,
                                                            batch))
            vt, gt = _value_and_grads(lt, _t(p), batch)
            assert abs(vt - float(vj)) <= 1e-6
            for a, b in zip(gt, jax.tree.leaves(gj)):
                assert _relerr(a, b) <= REL


def test_train_lanes_refuses_a_mesh():
    p, d, s = _lane(40, 3, 0, [3, 4, 2])
    with pytest.raises(NotImplementedError, match="mesh"):
        ttraining.train_lanes([ttraining.LaneSpec(_t(p), d, s)],
                              tae.masked_recon_loss, mesh=object())
