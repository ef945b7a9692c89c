"""The port's live multi-tenant serving runtime (``repro_torch.serve.runtime``,
the versioned cache of ``serve.vfl``, the serving half of
``robustness.faults`` and ``launch.serve_vfl --arrival/--fault``) against
the live JAX package on the CPU.

Mirrors ``tests/test_serve_runtime.py`` and the serving cases of
``tests/test_robustness.py``.  One untrained bundle (Table-3 widths, random
heads and latents: the runtime's decisions do not depend on the weights)
is saved with the JAX package's checkpoint layer and registered in both
packages' registries as two tenants, ``fp32`` and ``int8``.  Under a fixed
``service_model`` the scheduler is deterministic, so the port must give the
reference's dispatch log (tenant, dispatch time, service time, members),
shed set and report, key for key (``measured_wall_s`` is the host clock;
``jit_cache_sizes`` counts XLA executables, which the eager port does not
have).  Logits: 1e-5 on the active and int8 rows, 1e-4 on the
collaborative rows (their g2 input is 384 wide), as
``tests/test_torch_serve.py`` holds the engines.
"""
import json
import os

import jax
import numpy as np
import pytest

from repro.core import autoencoder as jae
from repro.core.psi import psi
from repro.data.synthetic import make_dataset
from repro.data.vertical import make_scenario
from repro.robustness import faults as jfaults
from repro.serve import runtime as jrt
from repro.serve import vfl as jsv
from repro_torch.launch import serve_vfl as tlaunch
from repro_torch.robustness import faults as tfaults
from repro_torch.serve import runtime as trt
from repro_torch.serve import vfl as tsv

ACTIVE_TOL = 1e-5
COLLAB_TOL = 1e-4
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TENANTS = {"fp32": None, "int8": "int8"}


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


@pytest.fixture(scope="module")
def registries(served):
    """Warmed two-tenant registries of both packages (shared per module;
    each test resets their stats)."""
    _, jb, tb, _ = served
    jreg, treg = jrt.TenantRegistry(), trt.TenantRegistry(device="cpu")
    for name, q in TENANTS.items():
        jreg.register(name, jb, quantize=q)
        treg.register(name, tb, quantize=q)
    jreg.warmup()
    treg.warmup()
    return jreg, treg


def _fresh(registries):
    for reg in registries:
        reg.reset_stats()
    return registries


def _streams(sc, mod, kind):
    """The same timed stream built by each package's generator."""
    if kind == "poisson":
        return mod.merge_streams(
            mod.make_timed_stream(sc.active.x, sc.active.ids, 60,
                                  tenant="fp32", seed=11, rate_rps=300.0,
                                  max_rows=64),
            mod.make_timed_stream(sc.active.x, sc.active.ids, 60,
                                  tenant="int8", seed=12, rate_rps=300.0,
                                  max_rows=64))
    if kind == "bursty":
        return mod.merge_streams(
            mod.make_timed_stream(sc.active.x, sc.active.ids, 80,
                                  tenant="fp32", seed=13, arrivals="bursty",
                                  rate_rps=400.0, max_rows=64),
            mod.make_timed_stream(sc.active.x, sc.active.ids, 40,
                                  tenant="int8", seed=14, rate_rps=200.0,
                                  max_rows=32))
    # backlog: everything at t = 0, anonymous rows among id-carrying ones
    x8 = np.asarray(sc.active.x[:8], np.float32)
    ids = np.asarray(sc.active.ids[:8], np.int64)
    sv = tsv if mod is trt else jsv
    return [mod.TimedRequest(sv.ServeRequest(i, x8, ids if i % 3 else None),
                             "fp32" if i % 2 else "int8", 0.0)
            for i in range(120)]


RUNS = {"poisson": (dict(slo_ms=50.0), lambda rows: 0.5 + 0.01 * rows),
        "bursty": (dict(slo_ms=40.0, max_queue_rows=200),
                   lambda rows: 2.0 + 0.05 * rows),
        "backlog": (dict(slo_ms=100.0, max_queue_rows=300),
                    lambda rows: 1.0)}


def _log(runtime):
    return [(d.tenant, d.t_dispatch_ms, d.service_ms,
             [tr.req.rid for tr in d.group]) for d in runtime.dispatch_log]


def _hits(bundle, ids):
    return np.zeros(0, bool) if ids is None else np.isin(ids,
                                                         bundle.cache_ids)


def _without_host_clock(report):
    return {k: v for k, v in report.items()
            if k not in ("measured_wall_s", "jit_cache_sizes")}


# ---------------------------------------------------------------------------
# arrivals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [
    ("poisson", dict(n=500, rate_rps=200.0, seed=3, t0_ms=0.0)),
    ("poisson", dict(n=50, rate_rps=37.5, seed=4, t0_ms=1000.0)),
    ("bursty", dict(n=800, rate_on_rps=1000.0, rate_off_rps=10.0,
                    on_ms=100.0, off_ms=100.0, seed=5)),
    ("bursty", dict(n=300, rate_on_rps=1000.0, rate_off_rps=0.0,
                    on_ms=50.0, off_ms=50.0, seed=6, t0_ms=7.0)),
])
def test_arrival_timestamps_are_the_reference_bits(kind, kw):
    fn = f"{kind}_arrivals"
    kw = dict(kw)
    if kind == "poisson":
        n, rate = kw.pop("n"), kw.pop("rate_rps")
        want = getattr(jrt, fn)(n, rate, **kw)
        got = getattr(trt, fn)(n, rate, **kw)
    else:
        n = kw.pop("n")
        want = getattr(jrt, fn)(n, **kw)
        got = getattr(trt, fn)(n, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("call,msg", [
    (lambda m: m.poisson_arrivals(5, 0.0), "rate must be positive"),
    (lambda m: m.poisson_arrivals(-1, 10.0), "negative n"),
    (lambda m: m.bursty_arrivals(5, rate_on_rps=10.0, rate_off_rps=1.0,
                                 on_ms=0.0, off_ms=10.0), "window lengths"),
    (lambda m: m.bursty_arrivals(5, rate_on_rps=0.0, rate_off_rps=1.0,
                                 on_ms=1.0, off_ms=1.0), "rate_on"),
])
def test_arrival_validation_matches_reference(call, msg):
    for mod in (jrt, trt):
        with pytest.raises(ValueError, match=msg):
            call(mod)


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_timed_streams_and_merge_match_reference(served, kind):
    sc = served[0]
    want, got = _streams(sc, jrt, kind), _streams(sc, trt, kind)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.tenant, g.req.rid, g.t_arrival_ms, g.shed) == \
            (w.tenant, w.req.rid, w.t_arrival_ms, w.shed)
        assert np.array_equal(g.req.x, w.req.x)
        assert np.array_equal(g.req.ids, w.req.ids)
    with pytest.raises(ValueError, match="unknown arrival"):
        trt.make_timed_stream(sc.active.x, sc.active.ids, 5,
                              arrivals="uniform")


# ---------------------------------------------------------------------------
# the scheduler against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(RUNS))
def test_runtime_matches_reference(served, registries, kind):
    sc, jb, tb, _ = served
    jreg, treg = _fresh(registries)
    cfg, model = RUNS[kind]
    streams = {}
    reports = {}
    runtimes = {}
    for name, mod, reg in (("jax", jrt, jreg), ("port", trt, treg)):
        streams[name] = _streams(sc, mod, kind)
        runtimes[name] = mod.ServingRuntime(reg, mod.RuntimeConfig(**cfg),
                                            service_model=model)
        reports[name] = runtimes[name].run(streams[name])
    assert _log(runtimes["port"]) == _log(runtimes["jax"])
    shed = lambda s: [(tr.tenant, tr.req.rid) for tr in s if tr.shed]
    assert shed(streams["port"]) == shed(streams["jax"])
    if kind != "poisson":
        assert shed(streams["port"])            # admission shed some
    assert _without_host_clock(reports["port"]) == \
        _without_host_clock(reports["jax"])
    assert set(reports["port"]) == set(reports["jax"])
    assert reports["port"]["jit_cache_sizes"] == {}
    for name in TENANTS:
        assert treg[name].stats.summary() == jreg[name].stats.summary()
        assert treg[name].cache.hits == jreg[name].cache.hits
    for g, w in zip(streams["port"], streams["jax"]):
        if w.shed:
            assert g.req.logits is None
            continue
        hit = _hits(jb, w.req.ids)
        d = np.abs(g.req.logits - w.req.logits)
        if hit.any():
            assert d[hit].max() <= COLLAB_TOL
        if (~hit).any() or not len(hit):
            rows = ~hit if len(hit) else slice(None)
            assert d[rows].max() <= ACTIVE_TOL


def test_registry_shares_one_bucketer_and_refuses_duplicates(served,
                                                             registries):
    _, _, tb, _ = served
    _, treg = registries
    assert treg["fp32"].bucketer is treg["int8"].bucketer is treg.bucketer
    assert treg["int8"].quantize == "int8" and treg["fp32"].quantize is None
    assert treg.names() == list(TENANTS) and len(treg) == 2
    assert "int8" in treg and "nobody" not in treg
    assert treg.jit_cache_sizes() == {}
    with pytest.raises(ValueError, match="already registered"):
        treg.register("fp32", tb)
    runtime = trt.ServingRuntime(treg, service_model=lambda rows: 1.0)
    ghost = [trt.TimedRequest(tsv.ServeRequest(0, tb.x_mean[None], None),
                              "nobody", 0.0)]
    with pytest.raises(ValueError, match="unregistered tenants"):
        runtime.run(ghost)


@pytest.mark.parametrize("model", ["measured", "fixed"])
def test_verify_dispatch_parity_is_bit_identical(served, registries, model):
    sc, jb, tb, _ = served
    jreg, treg = _fresh(registries)
    runtime = trt.ServingRuntime(
        treg, trt.RuntimeConfig(slo_ms=200.0),
        service_model=None if model == "measured" else (lambda rows: 1.0))
    report = runtime.run(_streams(sc, trt, "poisson"))
    assert report["served"] == 120
    parity = trt.verify_dispatch_parity(runtime, {n: tb for n in TENANTS})
    for name, p in parity.items():
        assert p["batches"] > 0, name
        assert p["bit_identical"] and p["max_abs_diff"] == 0.0, (name, p)
    assert sum(t["rows"] for t in report["tenants"].values()) \
        == report["rows"]
    if model == "fixed":
        jrun = jrt.ServingRuntime(jreg, jrt.RuntimeConfig(slo_ms=200.0),
                                  service_model=lambda rows: 1.0)
        jrun.run(_streams(sc, jrt, "poisson"))
        want = jrt.verify_dispatch_parity(jrun, {n: jb for n in TENANTS})
        assert {n: p["batches"] for n, p in parity.items()} == \
            {n: p["batches"] for n, p in want.items()}


# ---------------------------------------------------------------------------
# representation-cache lifecycle
# ---------------------------------------------------------------------------

def test_cache_lifecycle_matches_reference(served):
    sc, jb, tb, _ = served
    je = jsv.VFLServingEngine(jb)
    te = tsv.VFLServingEngine(tb, device="cpu")
    ids = np.asarray(tb.cache_ids[:8])
    pos = {int(v): k for k, v in enumerate(np.asarray(sc.active.ids))}
    x = np.asarray(sc.active.x[[pos[int(i)] for i in ids]], np.float32)
    assert len(te.cache) == len(je.cache) == len(tb.cache_ids)
    before = te.predict(x, ids)
    np.testing.assert_allclose(before, je.predict(x, ids), atol=COLLAB_TOL,
                               rtol=0)
    assert te.cache_version == je.cache_version == 1
    for e in (je, te):
        e.invalidate_cache()
    assert te.cache.stale and te.cache_version == 1
    stale = te.predict(x, ids)
    np.testing.assert_allclose(stale, je.predict(x, ids), atol=ACTIVE_TOL,
                               rtol=0)
    assert te.stats.dispatches == je.stats.dispatches
    np.testing.assert_array_equal(stale, te.predict_active(x))
    assert (te.cache.hits, te.cache.misses) == (je.cache.hits,
                                                je.cache.misses) == (8, 8)
    for e, b in ((je, jb), (te, tb)):
        assert e.refresh_cache(b.cache_ids, b.cache_z) == 2
    assert not te.cache.stale
    np.testing.assert_array_equal(te.predict(x, ids), before)   # same bits
    je.predict(x, ids)
    assert (te.cache.hits, te.cache.misses) == (je.cache.hits,
                                                je.cache.misses) == (16, 8)
    with pytest.raises(ValueError, match="no collaborative path"):
        tsv.VFLServingEngine(tsv.ModelBundle(
            meta={}, g3=tb.g3, head_active=tb.head_active, x_mean=tb.x_mean,
            x_scale=tb.x_scale), device="cpu").refresh_cache(ids, None)


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

def _known(sc, mod, n, tenant, t0_ms=0.0, gap_ms=10.0):
    """n single-row requests with REAL ids on a fixed grid."""
    sv = tsv if mod is trt else jsv
    ids = np.asarray(sc.active.ids[:n], np.int64)
    x = np.asarray(sc.active.x[:n], np.float32)
    return [mod.TimedRequest(sv.ServeRequest(i, x[i:i + 1], ids[i:i + 1]),
                             tenant, t0_ms + gap_ms * i) for i in range(n)]


PLANS = {
    "degrade_then_recover": (40, "fp32", (("dropout", 150.0, "fp32"),
                                          ("recover", 250.0, "fp32"))),
    "no_recover_stays_stale": (20, "int8", (("stale", 95.0, "int8"),)),
    "events_past_the_stream": (5, "fp32", (("drift", 30.0, "fp32"),
                                           ("dropout", 500.0, "int8"),
                                           ("recover", 900.0, "fp32"))),
    "unknown_tenant": (3, "fp32", (("dropout", 1.0, "nobody"),)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_fault_plans_match_reference(served, registries, case):
    sc, jb, tb, _ = served
    n, tenant, events = PLANS[case]
    reports = {}
    for name, mod, fmod, reg, bundle in (
            ("jax", jrt, jfaults, registries[0], jb),
            ("port", trt, tfaults, registries[1], tb)):
        reg.reset_stats()
        plan = fmod.FaultPlan(case, events=tuple(
            fmod.FaultEvent(kind=k, t_ms=t, tenant=who)
            for k, t, who in events))
        runtime = mod.ServingRuntime(reg, mod.RuntimeConfig(slo_ms=50.0),
                                     service_model=lambda rows: 1.0)
        if case == "unknown_tenant":
            with pytest.raises(ValueError, match="unregistered tenants"):
                runtime.run(_known(sc, mod, n, tenant), faults=plan)
            continue
        reports[name] = runtime.run(_known(sc, mod, n, tenant), faults=plan)
        reports[name]["stats"] = {t: reg[t].stats.summary() for t in TENANTS}
        # restore the shared registries' caches for the other tests
        for t in TENANTS:
            if reg[t].cache.stale:
                reg[t].refresh_cache(bundle.cache_ids, bundle.cache_z)
            reg[t].cache.version = 1
    if case == "unknown_tenant":
        return
    got, want = reports["port"], reports["jax"]
    assert got["faults"] == want["faults"]
    assert got["stats"] == want["stats"]
    assert _without_host_clock(got) == _without_host_clock(want)
    fb = got["faults"]["tenants"][tenant]
    assert fb["collab_dispatches_while_faulted"] == 0
    if case == "degrade_then_recover":
        assert got["faults"]["events_applied"] == 2
        assert fb["cache_version"] == 2 and not fb["cache_stale"]
        assert got["stats"]["fp32"]["dispatches"]["collab"] > 0
        assert got["stats"]["fp32"]["dispatches"]["active"] > 0
    elif case == "no_recover_stays_stale":
        assert fb["faulted"] and fb["cache_stale"]
        assert got["served"] == n
    else:
        assert got["faults"]["events_applied"] == 3
        assert got["faults"]["tenants"]["int8"]["cache_stale"]
        assert fb["cache_version"] == 2 and fb["recovered_at_ms"] == 900.0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arrival,fault", [("poisson", True),
                                           ("bursty", False)])
def test_serve_vfl_live_runtime_on_cpu(served, tmp_path, capsys, arrival,
                                       fault):
    _, _, _, path = served
    out = str(tmp_path / "stats.json")
    argv = ["--load", path, "--dataset", "bcw", "--aligned", "120",
            "--requests", "200", "--device", "cpu", "--arrival", arrival,
            "--rate-rps", "300", "--slo-ms", "100", "--out", out]
    if fault:
        argv += ["--fault", os.path.join(ROOT, "examples", "faults",
                                         "passive_dropout.json")]
    assert tlaunch.main(argv) == 0
    with open(out) as fh:
        stats = json.load(fh)
    text = capsys.readouterr().out
    assert stats["served"] + stats["shed_requests"] == 200
    assert stats["device"] == {"type": "cpu", "name": "cpu"}
    assert set(stats["latency_ms"]) == {"queue", "service", "end_to_end"}
    assert f"{arrival} arrivals at 300.0 req/s on cpu" in text
    assert "queueing  p50/p99" in text and "SLO 100.0 ms" in text
    if fault:
        fb = stats["faults"]["tenants"]["default"]
        assert stats["faults"]["events_applied"] == 2
        assert fb["collab_dispatches_while_faulted"] == 0
        assert fb["cache_version"] == 2 and not fb["cache_stale"]
        assert "faults: applied 2 events" in text
    else:
        assert "faults" not in stats
