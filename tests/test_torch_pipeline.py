"""The port's protocol (``run_apcvfl`` and friends), probe and bundle
export against the live JAX package on the CPU.

Parity mode: the reference's initial params (``jax.random.split`` of the
seed's key and ``init_autoencoder``, as its pipeline draws them) and its
epoch permutations cross as arrays (``init_params=``, ``perm_fn=``).  The
communication summary and per-stage epoch counts must be equal; metrics
agree within the 0.03 band of ``tests/test_replicas.py`` (the probe
amplifies float-level differences into flipped predictions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autoencoder as jae
from repro.core import classifier as jclf
from repro.core import pipeline as jpipe
from repro.data.synthetic import make_dataset
from repro.data.vertical import make_scenario
from repro.experiments.results import RunResult as JRunResult
from repro.serve import vfl as jsv
from repro_torch import convert
from repro_torch.core import classifier as tclf
from repro_torch.core import pipeline as tpipe
from repro_torch.serve import vfl as tsv
from repro_torch.tree import tree_leaves

METRIC_TOL = 0.03
EPOCHS = 3


def jax_perm(seed, epoch, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return np.asarray(jax.random.permutation(key, n))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _relerr(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1.0))


def reference_inits(sc, seed, roles=tpipe.ROLES):
    """The inits the reference pipeline draws for ``seed``, as arrays."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(roles))
    d_a, d_p = sc.active.x.shape[1], sc.passive.x.shape[1]
    widths = {"g1_active": jae.table3_encoder("g1_active", d_a),
              "g1_passive": jae.table3_encoder("g1_passive", d_p),
              "g2": jae.table3_encoder("g2", 128 + 256),
              "g3": jae.table3_encoder("g3", d_a)}
    return {r: _np(jae.init_autoencoder(k, widths[r]))
            for r, k in zip(roles, keys)}


@pytest.fixture(scope="module")
def scenario():
    return make_scenario(make_dataset("bcw", seed=0), n_active_features=5,
                         n_aligned=150, seed=0)


@pytest.fixture(scope="module")
def reference_run(scenario):
    return jpipe.run_apcvfl(scenario, seed=0, max_epochs=EPOCHS)


@pytest.fixture(scope="module")
def port_runs(scenario):
    inits = reference_inits(scenario, 0)
    return {uk: tpipe.run_apcvfl(scenario, seed=0, max_epochs=EPOCHS,
                                 use_kernel=uk, init_params=inits,
                                 perm_fn=jax_perm, device="cpu")
            for uk in (False, True)}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_run_apcvfl_matches_reference(reference_run, port_runs, use_kernel):
    got, want = port_runs[use_kernel], reference_run
    assert got.comm == want.comm
    assert got.epochs == want.epochs
    assert (got.rounds, got.z_dim, got.method) == (want.rounds, want.z_dim,
                                                   want.method)
    assert set(got.train_loss) == set(got.epochs) == set(got.steps)
    assert all(got.steps[r] >= got.epochs[r] > 0 for r in got.epochs)
    assert set(got.seconds) == {"g1", "g2", "g3"}
    assert all(s > 0 for s in got.seconds.values())
    for role in ("g1_active", "g2", "g3"):
        for a, b in zip(tree_leaves(got.params[role]),
                        jax.tree.leaves(want.params[role])):
            assert _relerr(a.numpy(), b) <= 1e-4, role
    np.testing.assert_array_equal(got.artifacts["aligned_ids"],
                                  want.artifacts["aligned_ids"])
    for k in want.metrics:
        assert abs(got.metrics[k] - want.metrics[k]) < METRIC_TOL, k
    assert got.to_record().keys() == want.to_record().keys()


def test_export_bundle_matches_reference(scenario, port_runs):
    res = port_runs[True]
    got = tsv.export_bundle(res, scenario)
    # the reference's export of the same trained params
    jres = JRunResult(
        method=res.method, metrics=res.metrics, rounds=res.rounds,
        epochs=res.epochs, comm=res.comm, seed=res.seed, z_dim=res.z_dim,
        params={k: jax.tree.map(jnp.asarray, convert.to_numpy(v))
                for k, v in res.params.items()},
        artifacts={"aligned_ids": res.artifacts["aligned_ids"],
                   "z_passive_aligned": jnp.asarray(convert.to_numpy(
                       res.artifacts["z_passive_aligned"]))})
    want = jsv.export_bundle(jres, scenario)
    assert got.meta == want.meta
    np.testing.assert_array_equal(got.cache_ids, want.cache_ids)
    np.testing.assert_array_equal(got.cache_z, want.cache_z)
    # the port's bundle served by the JAX engine and by the port's engine
    x = np.asarray(scenario.active.x, np.float32)
    ids = scenario.active.ids
    jeng = jsv.VFLServingEngine(jsv.ModelBundle(**vars(got)))
    teng = tsv.VFLServingEngine(got, device="cpu")
    np.testing.assert_allclose(teng.predict(x, ids), jeng.predict(x, ids),
                               atol=1e-4)
    # the heads: Adam at lr 0.1 turns float-level gradient noise into
    # whole steps on near-zero coordinates, so the fitted heads agree as
    # classifiers (the metric band), not weight for weight
    want_eng = jsv.VFLServingEngine(want)
    y = scenario.active.y
    for path in ("predict_active", "predict"):
        args = (x,) if path == "predict_active" else (x, ids)
        acc = [np.mean(np.argmax(getattr(e, path)(*args), -1) == y)
               for e in (teng, want_eng)]
        assert abs(acc[0] - acc[1]) < METRIC_TOL, (path, acc)


def test_run_apcvfl_refuses_exchange_transforms(scenario):
    """Transforms are ported (``tests/test_torch_robustness.py``); what is
    refused, before any training, is an exchange that is not one."""
    with pytest.raises(TypeError, match="exchange"):
        tpipe.run_apcvfl(scenario, exchange=object(), device="cpu")


def test_aligned_only_and_local_baseline_match_reference(scenario):
    inits = reference_inits(scenario, 0, roles=tpipe.ROLES[:3])
    want = jpipe.run_apcvfl_aligned_only(scenario, seed=0, max_epochs=2,
                                         test_size=50)
    got = tpipe.run_apcvfl_aligned_only(
        scenario, seed=0, max_epochs=2, test_size=50, init_params=inits,
        perm_fn=jax_perm, device="cpu")
    assert got.comm == want.comm and got.epochs == want.epochs
    for k in want.metrics:
        assert abs(got.metrics[k] - want.metrics[k]) < METRIC_TOL, k
    base_t = tpipe.run_local_baseline(scenario, device="cpu")
    base_j = jpipe.run_local_baseline(scenario)
    for k in base_j:
        assert abs(base_t[k] - base_j[k]) < METRIC_TOL, k


def test_fold_arrays_identical():
    for n, k, seed in ((103, 10, 0), (40, 4, 7)):
        for a, b in zip(tclf._fold_arrays(n, k, seed),
                        jclf._fold_arrays(n, k, seed)):
            if isinstance(a, list):
                assert all(np.array_equal(u, v) for u, v in zip(a, b))
            else:
                np.testing.assert_array_equal(a, b)


def _probe_data(seed=0, n=180, d=16, C=3):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, C, n)
    x = (rng.randn(n, d) + 1.5 * np.eye(C, d)[y]).astype(np.float32)
    return x, y, C


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kfold_cv_and_many_match_reference(use_kernel):
    x, y, C = _probe_data()
    want = jclf.kfold_cv(x, y, C, k=4, seed=3)
    got = tclf.kfold_cv(x, y, C, k=4, seed=3, use_kernel=use_kernel,
                        device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) < METRIC_TOL, k
    x2, y2, _ = _probe_data(1)
    many_j = jclf.kfold_cv_many([x, x2], [y, y2], C, k=4, seeds=[3, 5])
    many_t = tclf.kfold_cv_many([x, x2], [y, y2], C, k=4, seeds=[3, 5],
                                use_kernel=use_kernel, device="cpu")
    for a, b in zip(many_t, many_j):
        for k in b:
            assert abs(a[k] - b[k]) < METRIC_TOL, k


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fit_logreg_matches_reference(use_kernel):
    x, y, C = _probe_data(2)
    want = jclf.fit_logreg(jnp.asarray(x), jnp.asarray(y), C, steps=100)
    got = tclf.fit_logreg(torch.from_numpy(x), y, C, steps=100,
                          use_kernel=use_kernel)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4)
