"""The port's experiment driver (``repro_torch.experiments``, the
``launch.experiment`` CLI) and Appendix F's ``train_encoder_with_probe``
against the live JAX package on the CPU.

Specs are pure data: ``to_dict()`` of every ``examples/specs/*.json`` and
the errors for unknown keys equal the reference's.  The registry lists the
reference's methods with the same accepted params, and ``_validate``
refuses what the reference refuses (and a non-empty ``devices``), before
any scenario is built.

Sweep parity: a sweep draws its inits inside each runner, so the test
replaces the port's registry entries (``monkeypatch``) with adapters that
pass the reference's inits and epoch permutations as arrays
(``init_params=``, ``perm_fn=``).  Records then agree with the reference's
sweep: comm, rounds and epochs equal, metrics within the 0.03 band of
``tests/test_replicas.py`` (the probe amplifies float-level differences
into flipped predictions).  ``train_encoder_with_probe``: train losses
within 1e-5 relative (``tests/test_torch_train.py``'s engine band),
probe metrics within 0.03.
"""
import dataclasses
import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core import autoencoder as jae
from repro.core import pipeline as jpipe
from repro.experiments import registry as jregistry
from repro.experiments import specs as jspecs
from repro.experiments import sweeps as jsweeps
from repro.launch import experiment as jexperiment
from repro_torch.core import multiparty as tmp
from repro_torch.core import pipeline as tpipe
from repro_torch.core import splitnn as tsplitnn
from repro_torch.core import vfedtrans as tvfedtrans
from repro_torch.experiments import registry as tregistry
from repro_torch.experiments import specs as tspecs
from repro_torch.experiments import sweeps as tsweeps
from repro_torch.launch import experiment as texperiment
from test_torch_baselines import _splitnn_init
from test_torch_multiparty import (  # noqa: F401 (autouse fixture)
    one_torch_thread, reference_inits_k)
from test_torch_pipeline import jax_perm, reference_inits

METRIC_TOL = 0.03
LOSS_REL = 1e-5
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SPEC_FILES = sorted(glob.glob(os.path.join(ROOT, "examples", "specs",
                                           "*.json")))
ROLES3 = ("g1_active", "g1_passive", "g2")


# ---------------------------------------------------------------------------
# specs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", SPEC_FILES,
                         ids=[os.path.basename(p) for p in SPEC_FILES])
def test_spec_files_parse_to_the_reference_dict(path):
    with open(path) as fh:
        text = fh.read()
    got = tspecs.ExperimentSpec.from_json(text)
    want = jspecs.ExperimentSpec.from_json(text)
    assert got.to_dict() == want.to_dict()
    assert tspecs.ExperimentSpec.from_json(got.to_json()) == got
    assert [dataclasses.asdict(s) for s in got.scenarios()] == \
        [dataclasses.asdict(s) for s in want.scenarios()]


@pytest.mark.parametrize("cls,bad", [
    ("ExperimentSpec", {"name": "x", "bogus": 1}),
    ("MethodSpec", {"method": "apcvfl", "nope": 2}),
    ("ScenarioSpec", {"dataset": "bcw", "n_aligned": 10, "k": 3}),
])
def test_unknown_spec_keys_raise_the_reference_errors(cls, bad):
    errs = []
    for mod in (tspecs, jspecs):
        with pytest.raises(ValueError) as ei:
            getattr(mod, cls).from_dict(bad)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]
    assert "unknown keys" in errs[0]


def test_registry_lists_the_reference_methods_and_params():
    names = tregistry.available_methods()
    assert names == jregistry.available_methods()
    assert len(names) == 11
    for name in names:
        got, want = tregistry.get_method(name), jregistry.get_method(name)
        assert got.accepts == want.accepts, name
        assert got.supports_multiparty == want.supports_multiparty, name
        assert got.supports_replicas == want.supports_replicas, name
    with pytest.raises(KeyError, match="unknown method"):
        tregistry.get_method("fedavg")


def _spec(**kw):
    base = dict(name="v", dataset="bcw", aligned=(120,),
                methods=(jspecs.MethodSpec("apcvfl"),))
    base.update(kw)
    return base


def _both(d):
    """The same spec in both packages' classes."""
    to = lambda mod: mod.ExperimentSpec.from_dict(
        {**d, "methods": [dataclasses.asdict(m) for m in d["methods"]]})
    return to(tspecs), to(jspecs)


REFUSED = {
    "no methods": _spec(methods=()),
    "unknown method": _spec(methods=(jspecs.MethodSpec("fedavg"),)),
    "2-party method on K=3": _spec(n_parties=(2, 3),
                                   methods=(jspecs.MethodSpec("splitnn"),)),
    "duplicate label": _spec(methods=(jspecs.MethodSpec("apcvfl"),
                                      jspecs.MethodSpec("apcvfl"))),
    "unknown params": _spec(methods=(jspecs.MethodSpec(
        "apcvfl", params={"sigma": 1.0}),)),
    "unknown override": _spec(overrides={"test_size": 40}),
    "n_parties < 2": _spec(n_parties=(1,)),
    "unknown mesh axis": _spec(devices={"model": 2}),
    "mesh axis size": _spec(devices={"lane": 0}),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_validate_refuses_what_the_reference_refuses(monkeypatch, case):
    got_spec, want_spec = _both(REFUSED[case])
    errs = []
    for validate, spec in ((tsweeps._validate, got_spec),
                           (jsweeps._validate, want_spec)):
        with pytest.raises((ValueError, KeyError)) as ei:
            validate(spec)
        errs.append((type(ei.value), str(ei.value)))
    assert errs[0] == errs[1]
    # before any scenario is built
    monkeypatch.setattr(tsweeps, "build_scenario", _no_build)
    with pytest.raises(errs[0][0]):
        tsweeps.sweep(got_spec, device="cpu")


def _no_build(*a, **kw):
    raise AssertionError("a scenario was built before validation failed")


def test_validate_refuses_devices_naming_the_multi_device_item(monkeypatch):
    """Both packages validate ``devices`` alike; a lane mesh wider than
    the world (one process, no process group) then raises before any
    scenario is built, naming the launcher that gives the ranks."""
    import torch.distributed as dist
    got_spec, want_spec = _both(_spec(devices={"lane": 2}))
    jsweeps._validate(want_spec)           # the reference takes a mesh
    tsweeps._validate(got_spec)            # and so does the port
    monkeypatch.setattr(tsweeps, "build_scenario", _no_build)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tsweeps.sweep(got_spec, device="cpu")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# sweep parity with the reference (registry entries in parity mode)
# ---------------------------------------------------------------------------

def _vfedtrans_init(sc, seed):
    d_a, d_p = sc.active.x.shape[1], sc.passive.x.shape[1]
    return jax.tree.map(np.asarray, jae.init_autoencoder(
        jax.random.PRNGKey(seed), [d_a, 256, d_a + d_p]))


def _apcvfl_init(sc, seed):
    return (reference_inits_k(sc, seed) if isinstance(sc, tmp.VFLScenarioK)
            else reference_inits(sc, seed))


# each method's parity adapter: (sequential runner, replicated runner)
PARITY = {
    "apcvfl": (
        lambda sc, spec, *, seed, device: (
            tmp.run_apcvfl_k if isinstance(sc, tmp.VFLScenarioK)
            else tpipe.run_apcvfl)(
            sc, seed=seed, init_params=_apcvfl_init(sc, seed),
            perm_fn=jax_perm, device=device, **spec.params),
        lambda scs, spec, *, seeds, device: (
            tmp.run_apcvfl_k_replicated
            if isinstance(scs[0], tmp.VFLScenarioK)
            else tpipe.run_apcvfl_replicated)(
            scs, seeds=seeds, perm_fn=jax_perm, device=device,
            init_params=[_apcvfl_init(sc, s) for sc, s in zip(scs, seeds)],
            **spec.params)),
    "apcvfl_aligned_only": (
        lambda sc, spec, *, seed, device: tpipe.run_apcvfl_aligned_only(
            sc, seed=seed, init_params=reference_inits(sc, seed, ROLES3),
            perm_fn=jax_perm, device=device, **spec.params),
        lambda scs, spec, *, seeds, device:
        tpipe.run_apcvfl_aligned_only_replicated(
            scs, seeds=seeds, perm_fn=jax_perm, device=device,
            init_params=[reference_inits(sc, s, ROLES3)
                         for sc, s in zip(scs, seeds)], **spec.params)),
    "splitnn": (
        lambda sc, spec, *, seed, device: tsplitnn.run_splitnn(
            sc, seed=seed, init_params=_splitnn_init(sc, seed),
            perm_fn=jax_perm, device=device, **spec.params), None),
    "vfedtrans": (
        lambda sc, spec, *, seed, device: tvfedtrans.run_vfedtrans(
            sc, seed=seed, init_params=_vfedtrans_init(sc, seed),
            perm_fn=jax_perm, device=device, **spec.params), None),
}


@pytest.fixture()
def parity_registry(monkeypatch):
    """The port's registry with each method's entry running in parity
    mode; names, accepted params and flags unchanged."""
    tregistry.available_methods()          # load the built-ins
    for name, (fn, rep) in PARITY.items():
        entry = tregistry._REGISTRY[name]
        monkeypatch.setitem(tregistry._REGISTRY, name, dataclasses.replace(
            entry, fn=fn, replicated_fn=rep or entry.replicated_fn))


def _assert_records_agree(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k in ("comm_mb",):
                assert g[k] == pytest.approx(v, rel=1e-12), k
            elif isinstance(v, float):
                assert abs(g[k] - v) < METRIC_TOL, (w["method"], k, g[k], v)
            else:
                assert g[k] == v, (w["method"], k)


def _smoke_spec_dict():
    return jexperiment.smoke_spec().to_dict()


@pytest.fixture(scope="module")
def reference_smoke():
    return jsweeps.tidy(jsweeps.sweep(jexperiment.smoke_spec()))


def test_smoke_spec_is_the_reference_smoke_spec():
    assert texperiment.smoke_spec().to_dict() == _smoke_spec_dict()
    assert texperiment.smoke_spec().overrides == {"max_epochs": 2}


def test_smoke_sweep_matches_reference(parity_registry, reference_smoke):
    got = tsweeps.tidy(tsweeps.sweep(texperiment.smoke_spec(),
                                     device="cpu"))
    _assert_records_agree(got, reference_smoke)
    assert [r["method"] for r in got] == ["local", "apcvfl", "ablation",
                                          "splitnn", "vfedtrans",
                                          "apcvfl_aligned_only"]


KPARTY = dict(name="kparty-cut", dataset="bcw", aligned=[150],
              n_parties=[2, 3], n_active_features=5, seeds=[0, 1],
              methods=["local", "apcvfl"], overrides={"max_epochs": 2})


def test_kparty_seed_groups_match_reference_and_sequential(parity_registry):
    """``kparty_fig7.json`` cut to K in (2, 3), one aligned value, 2 seeds
    and 2 epochs: seed groups through the replicated runners against the
    reference's sweep and against the port's ``replicate=False``."""
    with open(os.path.join(ROOT, "examples", "specs",
                           "kparty_fig7.json")) as fh:
        full = json.load(fh)
    assert full["aligned"] == KPARTY["aligned"]
    assert full["methods"] == KPARTY["methods"]
    spec = tspecs.ExperimentSpec.from_dict(KPARTY)
    grouped = tsweeps.tidy(tsweeps.sweep(spec, device="cpu"))
    want = jsweeps.tidy(jsweeps.sweep(
        jspecs.ExperimentSpec.from_dict(KPARTY)))
    _assert_records_agree(grouped, want)
    seq = tsweeps.tidy(tsweeps.sweep(
        dataclasses.replace(spec, replicate=False), device="cpu"))
    _assert_records_agree(seq, grouped)
    assert [(r["n_parties"], r["seed"], r["method"]) for r in grouped] == [
        (k, s, m) for k in (2, 3) for s in (0, 1)
        for m in ("local", "apcvfl")]


def test_experiment_cli_smoke_writes_reference_records(tmp_path,
                                                       reference_smoke):
    out = tmp_path / "results.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.launch.experiment", "--smoke",
                        "--device", "cpu", "--quiet", "--out", str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "device: cpu" in r.stdout.splitlines()
    payload = json.loads(out.read_text())
    assert set(payload) == {"spec", "records", "elapsed_s"}
    assert payload["spec"] == json.loads(json.dumps(_smoke_spec_dict()))
    assert [rec.keys() for rec in payload["records"]] == \
        [rec.keys() for rec in reference_smoke]
    for rec in payload["records"]:
        assert 0.0 <= rec["accuracy"] <= 1.0


# ---------------------------------------------------------------------------
# Appendix F: train_encoder_with_probe
# ---------------------------------------------------------------------------

def test_train_encoder_with_probe_matches_reference():
    """As ``tests/test_system.py:57`` runs it: 3 epochs, k 3."""
    from repro.data.synthetic import make_dataset
    from repro.data.vertical import make_scenario
    sc = make_scenario(make_dataset("bcw", seed=3), n_active_features=3,
                       n_aligned=200, seed=3)
    x, y = sc.active.x, sc.active.y
    widths = [x.shape[1], 32, 64]
    kw = dict(max_epochs=3, k=3, seed=0)
    want = jpipe.train_encoder_with_probe(x, y, sc.n_classes, widths, **kw)
    init = jax.tree.map(np.asarray, jae.init_autoencoder(
        jax.random.PRNGKey(0), widths))
    got = tpipe.train_encoder_with_probe(x, y, sc.n_classes, widths,
                                         init_params=init, perm_fn=jax_perm,
                                         device="cpu", **kw)
    assert len(got["history"]["probe"]) == len(got["history"]["loss"]) == 3
    np.testing.assert_allclose(got["history"]["loss"],
                               want["history"]["loss"], rtol=LOSS_REL)
    for g, w in zip(got["history"]["probe"], want["history"]["probe"]):
        assert abs(g - w) < METRIC_TOL
    assert abs(got["metric_raw_x"] - want["metric_raw_x"]) < METRIC_TOL
    assert np.isfinite(got["gap"])
    # without init_params the port draws its own init, on the device asked
    own = tpipe.train_encoder_with_probe(x, y, sc.n_classes, widths,
                                         device="cpu", max_epochs=2, k=3)
    assert len(own["history"]["probe"]) == 2
