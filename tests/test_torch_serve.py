"""The port's serving path (``repro_torch.serve``, ``repro_torch.launch``)
against the live JAX package, on the CPU.

One untrained bundle is built per module from ``ae.init_autoencoder`` plus
numpy heads (serving correctness does not depend on training), saved with
the JAX package's checkpoint layer, and served by both engines.  Bounds:
1e-5 on the active and int8 paths, 1e-4 on the collaborative path (its
g2 input is 384 wide), as ``tests/test_serve_vfl.py`` pins the JAX engine.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import autoencoder as jae
from repro.core.psi import psi
from repro.data.synthetic import make_dataset
from repro.data.vertical import make_scenario
from repro.serve import quant as jquant
from repro.serve import vfl as jsv
from repro_torch.launch import serve_vfl as tlaunch
from repro_torch.serve import quant as tquant
from repro_torch.serve import vfl as tsv

ACTIVE_TOL = 1e-5
COLLAB_TOL = 1e-4


def _jax_bundle(sc, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    init = lambda k, w: jax.tree.map(np.asarray, jae.init_autoencoder(k, w))
    rng = np.random.RandomState(seed)
    head = lambda c: {"w": (rng.randn(256, c) / 16).astype(np.float32),
                      "b": (rng.randn(c) * 0.1).astype(np.float32)}
    d = sc.active.x.shape[1]
    aligned, _, _ = psi(sc.active.ids, sc.passive.ids)
    return jsv.ModelBundle(
        meta={"method": "apcvfl", "dataset": sc.name,
              "n_classes": int(sc.n_classes), "z_dim": 256,
              "n_features_active": d, "seed": seed,
              "n_cached": int(len(aligned))},
        g3=init(ks[0], jae.table3_encoder("g3", d)),
        head_active=head(sc.n_classes),
        x_mean=(rng.randn(d) * 0.1).astype(np.float32),
        x_scale=(1.0 + rng.rand(d)).astype(np.float32),
        g1_active=init(ks[1], jae.table3_encoder("g1_active", d)),
        g2=init(ks[2], jae.table3_encoder("g2", 128 + 256)),
        head_joint=head(sc.n_classes),
        cache_ids=aligned.astype(np.int64),
        cache_z=rng.randn(len(aligned), 256).astype(np.float32))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    ds = make_dataset("bcw", seed=0)
    sc = make_scenario(ds, n_active_features=5, n_aligned=120, seed=0)
    jb = _jax_bundle(sc)
    path = str(tmp_path_factory.mktemp("bundle") / "jax_bundle")
    jb.save(path)
    return sc, jb, tsv.ModelBundle.load(path), path


def _engines(served, **kw):
    _, jb, tb, _ = served
    return jsv.VFLServingEngine(jb, **kw), \
        tsv.VFLServingEngine(tb, device="cpu", **kw)


def _mixed(sc, bundle, n, seed):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, len(sc.active.x), n)
    ids = sc.active.ids[rows].copy()
    ids[rng.rand(n) < 0.3] = -11               # forced misses
    return sc.active.x[rows], ids


def test_jax_bundle_loads_into_port(served):
    _, jb, tb, _ = served
    assert tb.supports_collaborative
    assert tb.cache_ids.dtype == np.int64
    assert np.array_equal(tb.cache_ids, jb.cache_ids)
    assert np.array_equal(tb.cache_z, jb.cache_z)
    for part in ("g3", "g1_active", "g2"):
        for half in ("enc", "dec"):
            for k, v in getattr(jb, part)[half].items():
                assert np.array_equal(getattr(tb, part)[half][k], v)
    assert tb.meta == jb.meta


@pytest.mark.parametrize("n", [1, 77, 300])
def test_active_logits_match_jax_engine(served, n):
    sc = served[0]
    je, te = _engines(served)
    x = sc.active.x[:n]
    np.testing.assert_allclose(te.predict_active(x), je.predict_active(x),
                               atol=ACTIVE_TOL, rtol=0)
    assert te.stats.dispatches == je.stats.dispatches
    assert te.stats.padded_rows == je.stats.padded_rows


def test_collab_logits_match_jax_engine(served):
    sc, jb, _, _ = served
    je, te = _engines(served)
    pos = {int(v): i for i, v in enumerate(sc.active.ids)}
    ids = jb.cache_ids[:45]
    x = sc.active.x[[pos[int(i)] for i in ids]]
    np.testing.assert_allclose(te.predict(x, ids), je.predict(x, ids),
                               atol=COLLAB_TOL, rtol=0)
    assert te.cache.hits == je.cache.hits == 45
    assert te.cache.misses == je.cache.misses == 0
    assert te.stats.dispatches == je.stats.dispatches == {"collab": 1}


@pytest.mark.parametrize("n,seed", [(150, 1), (333, 2)])
def test_mixed_batches_route_and_count_like_jax(served, n, seed):
    sc, jb, _, _ = served
    je, te = _engines(served)
    x, ids = _mixed(sc, jb, n, seed)
    np.testing.assert_allclose(te.predict(x, ids), je.predict(x, ids),
                               atol=COLLAB_TOL, rtol=0)
    assert (te.cache.hits, te.cache.misses) == \
        (je.cache.hits, je.cache.misses)
    assert te.cache.hits > 0 and te.cache.misses > 0
    assert te.stats.dispatches == je.stats.dispatches
    assert te.stats.padded_rows == je.stats.padded_rows
    assert te.stats.rows == je.stats.rows
    assert te.compiled_shapes() == je.compiled_shapes()


def test_request_stream_and_serve_stream_match_jax(served):
    sc = served[0]
    kw = dict(seed=3, max_rows=48, p_known=0.5)
    jreq = jsv.make_request_stream(sc.active.x, sc.active.ids, 60, **kw)
    treq = tsv.make_request_stream(sc.active.x, sc.active.ids, 60, **kw)
    for a, b in zip(jreq, treq):
        assert np.array_equal(a.x, b.x) and np.array_equal(a.ids, b.ids)
    je, te = _engines(served, buckets=(16, 64, 128))
    js = jsv.serve_stream(je, jreq)
    ts = tsv.serve_stream(te, treq)
    for a, b in zip(jreq, treq):
        np.testing.assert_allclose(b.logits, a.logits, atol=COLLAB_TOL,
                                   rtol=0)
    assert set(ts) == set(js)
    for k in ("requests", "rows", "cache_hit_rate", "dispatches",
              "padded_rows", "compiled"):
        assert ts[k] == js[k], k
    assert set(ts["latency_ms"]) == set(js["latency_ms"])
    assert ts["jit_cache_sizes"] == {}


def test_quantized_weights_bit_identical_to_jax(served):
    _, jb, tb, _ = served
    jq = jquant.quantize_active_path(jb)
    tq = tquant.quantize_active_path(tb, device="cpu")
    assert set(tq) == set(jq)
    for k, v in jq.items():
        if k == "meta":
            assert tq[k] == v
            continue
        got = tq[k].numpy()
        assert got.dtype == np.asarray(v).dtype, k
        assert np.array_equal(got, np.asarray(v)), k


def test_int8_engine_matches_jax_int8_engine(served):
    sc, jb, _, _ = served
    je, te = _engines(served, quantize="int8")
    x = sc.active.x[:200]
    np.testing.assert_allclose(te.predict_active(x), je.predict_active(x),
                               atol=ACTIVE_TOL, rtol=0)
    x, ids = _mixed(sc, jb, 120, 5)
    np.testing.assert_allclose(te.predict(x, ids), je.predict(x, ids),
                               atol=COLLAB_TOL, rtol=0)
    # the kernel path's function, through the plain wrapper on the CPU
    tx = torch.from_numpy(np.ascontiguousarray(sc.active.x[:50]))
    np.testing.assert_allclose(
        tquant.int8_active_apply(te.quant_params, tx).numpy(),
        je.predict_active(sc.active.x[:50]), atol=ACTIVE_TOL, rtol=0)


def test_parity_report_matches_jax(served):
    sc, jb, tb, _ = served
    x = sc.active.x[:256]
    y = sc.active.y[:256]
    jr = jquant.parity_report(jb, x, y, n_classes=sc.n_classes)
    tr = tquant.parity_report(tb, x, y, n_classes=sc.n_classes,
                              device="cpu")
    assert set(tr) == set(jr)
    for k in ("max_abs_logit_delta", "mean_abs_logit_delta"):
        assert abs(tr[k] - jr[k]) <= ACTIVE_TOL
    assert tr["compression"] == jr["compression"]
    assert tr["max_abs_logit_delta"] <= tquant.MAX_LOGIT_DELTA


def test_port_saved_bundle_serves_in_jax_engine(served, tmp_path):
    sc, _, tb, _ = served
    path = str(tmp_path / "port_bundle")
    tb.save(path)
    back = jsv.ModelBundle.load(path)
    assert back.cache_ids.dtype == np.int64
    x, ids = _mixed(sc, tb, 90, 6)
    np.testing.assert_allclose(
        jsv.VFLServingEngine(back).predict(x, ids),
        tsv.VFLServingEngine(tb, device="cpu").predict(x, ids),
        atol=COLLAB_TOL, rtol=0)
    with open(path + ".json") as fh:
        side = json.load(fh)
    assert side["dtypes"]["cache/ids"] == "int64"


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_cli_serves_a_jax_bundle(served, tmp_path, quantize, capsys):
    _, _, _, path = served
    out = str(tmp_path / "stats.json")
    rc = tlaunch.main(["--load", path, "--dataset", "bcw", "--aligned",
                       "120", "--requests", "40", "--device", "cpu",
                       "--quantize", quantize, "--out", out])
    assert rc == 0
    with open(out) as fh:
        stats = json.load(fh)
    assert stats["requests"] == 40 and stats["rows"] > 0
    assert stats["device"] == {"type": "cpu", "name": "cpu"}
    assert 0 < stats["cache_hit_rate"] < 1
    assert ("quant" in stats) == (quantize == "int8")
    assert "served 40 requests" in capsys.readouterr().out


@pytest.mark.parametrize("argv,msg", [
    (["--n-parties", "3"], "later slice"),
    (["--load", "B", "--arrival", "poisson"], "runtime"),
    (["--load", "B", "--fault", "plan.json"], "runtime"),
    (["--load", "B", "--dataset", "credit"], "trained on dataset"),
    (["--load", "B", "--active-features", "4"], "active features"),
])
def test_cli_refuses(served, argv, msg, capsys):
    argv = [served[3] if a == "B" else a for a in argv]
    with pytest.raises(SystemExit) as ei:
        tlaunch.main(argv + ["--device", "cpu", "--aligned", "120"])
    assert ei.value.code == 2
    assert msg in capsys.readouterr().err
