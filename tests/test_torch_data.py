"""The port's own copies of the JAX package's numpy-only modules (datasets,
vertical split, PSI, serving metrics, F1) give identical results."""
import numpy as np
import pytest

from repro.core import classifier as jclf
from repro.core import psi as jpsi
from repro.data import synthetic as jsyn
from repro.data import vertical as jvert
from repro.serve import metrics as jmet
from repro_torch.core import classifier as tclf
from repro_torch.core import psi as tpsi
from repro_torch.data import synthetic as tsyn
from repro_torch.data import vertical as tvert
from repro_torch.serve import metrics as tmet


@pytest.mark.parametrize("name", ["bcw", "mimic3"])
def test_dataset_and_scenario_identical(name):
    jd, td = jsyn.make_dataset(name, seed=1), tsyn.make_dataset(name, seed=1)
    for k in ("x", "y", "ids"):
        assert np.array_equal(getattr(jd, k), getattr(td, k))
    aligned = jsyn.ALIGNED_SCENARIOS[name][0]
    js = jvert.make_scenario(jd, n_active_features=5, n_aligned=aligned,
                             seed=1)
    ts = tvert.make_scenario(td, n_active_features=5, n_aligned=aligned,
                             seed=1)
    assert np.array_equal(js.active.x, ts.active.x)
    assert np.array_equal(js.active.ids, ts.active.ids)
    assert np.array_equal(js.passive.ids, ts.passive.ids)
    assert np.array_equal(js.active_feature_idx, ts.active_feature_idx)
    assert tsyn.ALIGNED_SCENARIOS == jsyn.ALIGNED_SCENARIOS


def test_psi_identical():
    rng = np.random.RandomState(0)
    a = rng.permutation(500)[:300].astype(np.int64)
    b = rng.permutation(500)[:250].astype(np.int64)
    for x, y in zip(jpsi.psi(a, b), tpsi.psi(a, b)):
        assert np.array_equal(x, y)
    assert tpsi.id_positions(a) == jpsi.id_positions(a)
    with pytest.raises(ValueError, match="unique"):
        tpsi.psi(np.asarray([1, 1]), b)


def test_serve_metrics_identical():
    rng = np.random.RandomState(0)
    vals = list(rng.rand(101) * 10)
    assert tmet.series_summary(vals) == jmet.series_summary(vals)
    assert tmet.series_summary([]) == jmet.series_summary([])
    js, ts = jmet.ServeStats(), tmet.ServeStats()
    for q, s in zip(vals, vals[::-1]):
        js.record(q, s)
        ts.record(q, s)
    assert ts.latency_summary() == js.latency_summary()
    assert ts.percentile_ms(99) == js.percentile_ms(99)


def test_f1_scores_identical():
    rng = np.random.RandomState(0)
    for c in (2, 4):
        y, p = rng.randint(0, c, 300), rng.randint(0, c, 300)
        assert tclf.f1_scores(y, p, c) == jclf.f1_scores(y, p, c)


def test_predict_and_logits_match_jax_head():
    import jax.numpy as jnp
    import torch
    rng = np.random.RandomState(1)
    head = {"w": rng.randn(16, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}
    x = rng.randn(50, 16).astype(np.float32)
    th = {k: torch.from_numpy(v) for k, v in head.items()}
    np.testing.assert_allclose(
        tclf.logreg_logits(th, torch.from_numpy(x)).numpy(),
        np.asarray(jclf.logreg_logits(head, jnp.asarray(x))), atol=1e-5)
    assert np.array_equal(tclf.predict(th, x), jclf.predict(head, x))
