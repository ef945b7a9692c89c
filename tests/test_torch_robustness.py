"""The port's hardened exchange, privacy probe, attacks and training-time
faults (``repro_torch.robustness``, ``core.privacy``) against the live JAX
package on the CPU.

Parity mode: the reference's inits and epoch permutations cross as arrays
(``init_params=``, ``perm_fn=``), and so does its noise: ``draw=`` hands
the port ``jax.random``'s unit noise for the port's key tuple
``(seed, salt, link, *stages)``, which is the reference's ``fold_in``
chain written as integers.  Tolerances:

* a transform on the same latents: received latents within 1e-6
  absolute, wire accounting (bytes, dtypes, stages) equal;
* a whole run: comm, rounds and epochs equal, the received latents within
  1e-4 absolute (the g1 fits agree to 1e-5 relative,
  ``tests/test_torch_train.py``), metrics and leakage within the 0.03
  band of ``tests/test_replicas.py``;
* the port against itself (sigma 0 against ``run_apcvfl``, the dropout
  fault against the ablation, a frontier lane against its sequential run,
  one torch intra-op thread): the same bits.
"""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autoencoder as jae
from repro.core import comm as jcomm
from repro.core import multiparty as jmp
from repro.core import privacy as jprivacy
from repro.data.synthetic import make_dataset
from repro.data.vertical import make_scenario
from repro.robustness import attacks as jattacks
from repro.robustness import defense as jdefense
from repro.robustness import faults as jfaults
from repro_torch.core import comm as tcomm
from repro_torch.core import pipeline as tpipe
from repro_torch.core import privacy as tprivacy
from repro_torch.robustness import attacks as tattacks
from repro_torch.robustness import defense as tdefense
from repro_torch.robustness import faults as tfaults
from repro_torch.tree import tree_leaves
from test_torch_multiparty import (  # noqa: F401 (autouse fixture)
    one_torch_thread, reference_inits_k)
from test_torch_pipeline import jax_perm, reference_inits

EPOCHS = 2
TRANSFORM_ATOL = 1e-6
Z_ATOL = 1e-4
METRIC_TOL = 0.03
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def jax_key(key):
    k = jax.random.PRNGKey(key[0])
    for v in key[1:]:
        k = jax.random.fold_in(k, v)
    return k


def jax_draw(mechanism="gaussian"):
    """The reference's unit noise for the port's key tuple."""
    fn = jax.random.normal if mechanism == "gaussian" else jax.random.laplace
    return lambda key, shape: np.asarray(fn(jax_key(key), shape,
                                            jnp.float32))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _init(key, widths):
    return jax.tree.map(np.asarray, jae.init_autoencoder(key, widths))


@pytest.fixture(scope="module")
def sc():
    return make_scenario(make_dataset("bcw", seed=0), n_active_features=5,
                         n_aligned=120, seed=0)


@pytest.fixture(scope="module")
def inits(sc):
    return reference_inits(sc, 0)


def _kw(**kw):
    return dict(seed=0, max_epochs=EPOCHS, perm_fn=jax_perm, device="cpu",
                **kw)


# ---------------------------------------------------------------------------
# transforms on the same latents
# ---------------------------------------------------------------------------

def test_make_transform_identity_and_errors_match_reference():
    assert tdefense.make_transform() is None
    assert tdefense.make_transform(sigma=0.0, clip=None,
                                   quantize=None) is None
    t = tdefense.make_transform(sigma=1.0, quantize="int8")
    assert isinstance(t, tdefense.Chain) and len(t.stages) == 2
    assert isinstance(tdefense.make_transform(sigma=1.0),
                      tdefense.ClippedNoise)
    assert isinstance(tdefense.make_transform(quantize="sign"),
                      tdefense.Quantize)
    for bad in (dict(sigma=1.0, mechanism="uniform"), dict(quantize="int4"),
                dict(clip=-1.0), dict(mechanism="uniform")):
        errs = []
        for mod in (tdefense, jdefense):
            with pytest.raises(ValueError) as ei:
                mod.make_transform(**bad)
            errs.append(str(ei.value))
        assert errs[0] == errs[1], bad


def _exchange_both(make, z, **kw):
    """One exchange of ``z`` through the port's and the reference's
    transform: (received, channel summary) of each."""
    out = []
    for mod, arr in ((tdefense, torch.as_tensor(z)), (jdefense,
                                                      jnp.asarray(z))):
        ch = (tcomm if mod is tdefense else jcomm).Channel()
        recv = make(mod).exchange(ch, "step1/Z", arr, **kw)
        out.append((_np(recv), ch.summary()))
    return out


TRANSFORMS = {
    "gaussian": dict(sigma=1.0),
    "gaussian clipped": dict(sigma=0.7, clip=1.0),
    "laplace clipped": dict(sigma=0.5, mechanism="laplace", clip=2.0),
    "clip only": dict(clip=1.0),
    "int8": dict(quantize="int8"),
    "sign": dict(quantize="sign"),
    "gaussian then int8": dict(sigma=0.5, clip=1.0, quantize="int8"),
    "laplace then sign": dict(sigma=0.5, mechanism="laplace",
                              quantize="sign"),
}


@pytest.mark.parametrize("case", list(TRANSFORMS))
@pytest.mark.parametrize("link", [0, 1])
def test_transform_matches_reference_on_the_same_latents(case, link):
    kw = TRANSFORMS[case]
    z = (np.random.RandomState(0).randn(40, 12) * 3.0).astype(np.float32)
    draw = jax_draw(kw.get("mechanism", "gaussian"))
    (got, got_ch), (want, want_ch) = _exchange_both(
        lambda mod: mod.make_transform(
            **kw, **({"draw": draw} if mod is tdefense else {})),
        z, seed=3, link=link)
    assert got.dtype == np.float32 and got.shape == z.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TRANSFORM_ATOL)
    assert got_ch == want_ch


def test_quantize_wire_bytes_match_reference():
    z = np.random.RandomState(1).randn(10, 4).astype(np.float32)
    for mode, by_dtype in (("int8", {"int8": 40, "float32": 16}),
                           ("sign", {"sign1": 5, "float32": 16})):
        (got, got_ch), (want, want_ch) = _exchange_both(
            lambda mod: mod.Quantize(mode), z, seed=0)
        assert got_ch["by_dtype"] == want_ch["by_dtype"] == by_dtype
        assert got_ch == want_ch
        np.testing.assert_allclose(got, want, rtol=0, atol=TRANSFORM_ATOL)


def test_own_noise_is_keyed_by_seed_and_link_only():
    """Without ``draw=`` the noise is the port's host draw: the same for a
    key on every call, different across seeds and links, Laplace of unit
    scale by inverse CDF."""
    z = torch.zeros((2000, 16))
    t = tdefense.ClippedNoise(sigma=1.0)
    a = t.exchange(tcomm.Channel(), "step1/Z", z, seed=3)
    assert torch.equal(a, t.exchange(tcomm.Channel(), "step1/Z", z, seed=3))
    assert not torch.equal(a, t.exchange(tcomm.Channel(), "step1/Z", z,
                                         seed=4))
    assert not torch.equal(a, t.exchange(tcomm.Channel(), "step1/Z", z,
                                         seed=3, link=1))
    lap = tdefense.laplace_noise((0, tdefense.EXCHANGE_SALT, 0),
                                 (2000, 16)).numpy()
    assert lap.dtype == np.float32 and np.all(np.isfinite(lap))
    # unit Laplace: mean |x| is 1, variance 2 (32,000 draws)
    assert abs(np.abs(lap).mean() - 1.0) < 0.03
    assert abs(lap.var() - 2.0) < 0.1


def test_exchange_array_and_normalize_contract():
    ch = tcomm.Channel()
    z = torch.ones((6, 2))
    assert tcomm.exchange_array(ch, "step1/Z", z) is z
    assert ch.summary()["by_dtype"] == {"float32": 48}
    t = tdefense.Quantize("int8")
    assert tcomm.normalize_exchange(None, 3) == [None, None, None]
    assert tcomm.normalize_exchange(t, 2) == [t, t]
    assert tcomm.normalize_exchange([None, t], 2) == [None, t]
    with pytest.raises(ValueError, match="exchange"):
        tcomm.normalize_exchange([t], 2)
    with pytest.raises(TypeError, match="exchange"):
        tcomm.normalize_exchange(object(), 2)
    with pytest.raises(TypeError, match="exchange"):
        tcomm.normalize_exchange([t, 3], 2)


# ---------------------------------------------------------------------------
# the defended protocol
# ---------------------------------------------------------------------------

def test_apcvfl_dp_sigma0_is_run_apcvfl_bit_for_bit(sc, inits):
    base = tpipe.run_apcvfl(sc, init_params=inits, **_kw())
    dp = tdefense.run_apcvfl_dp(sc, sigma=0.0, init_params=inits, **_kw())
    assert dp.method == "apcvfl_dp"
    for role in base.params:
        for a, b in zip(tree_leaves(dp.params[role]),
                        tree_leaves(base.params[role])):
            assert torch.equal(a, b), role
    assert {k: dp.metrics[k] for k in base.metrics} == base.metrics
    assert dp.comm == base.comm
    assert dp.metrics["dp_sigma"] == 0.0
    assert dp.metrics["exchange_bytes"] == base.comm["by_stage"]["step1"]


@pytest.mark.parametrize("knobs", [dict(sigma=0.5), dict(sigma=2.0, clip=1.0),
                                   dict(quantize="int8")],
                         ids=["sigma0.5", "sigma2-clip1", "int8"])
def test_run_apcvfl_dp_matches_reference(sc, inits, knobs):
    want = jdefense.run_apcvfl_dp(sc, seed=0, max_epochs=EPOCHS, **knobs)
    got = tdefense.run_apcvfl_dp(sc, init_params=inits, draw=jax_draw(),
                                 **knobs, **_kw())
    assert (got.method, got.rounds, got.epochs, got.comm, got.z_dim) == (
        want.method, want.rounds, want.epochs, want.comm, want.z_dim)
    np.testing.assert_allclose(
        _np(got.artifacts["z_passive_aligned"]),
        np.asarray(want.artifacts["z_passive_aligned"]), rtol=0, atol=Z_ATOL)
    for k, v in want.metrics.items():
        assert abs(got.metrics[k] - v) < METRIC_TOL, k
    if knobs.get("quantize") == "int8":        # 1 byte an element
        n, m = got.artifacts["z_passive_aligned"].shape
        assert got.comm["by_dtype"]["int8"] == n * m


def test_dp_frontier_lanes_are_the_sequential_runs(sc, inits):
    """A shared transform, per-seed keys: each lane receives its
    sequential run's latents, bit for bit, and trains to its result."""
    sigmas = [0.0, 2.0]
    lanes = tdefense.dp_frontier(sc, sigmas, clip=1.0, init_params=inits,
                                 **_kw())
    assert [r.metrics["dp_sigma"] for r in lanes] == sigmas
    for s, lane in zip(sigmas, lanes):
        seq = tdefense.run_apcvfl_dp(sc, sigma=s, clip=1.0,
                                     init_params=inits, **_kw())
        assert lane.method == seq.method == "apcvfl_dp"
        assert lane.comm == seq.comm and lane.epochs == seq.epochs
        assert torch.equal(lane.artifacts["z_passive_aligned"],
                           seq.artifacts["z_passive_aligned"])
        for role in seq.params:
            for a, b in zip(tree_leaves(lane.params[role]),
                            tree_leaves(seq.params[role])):
                assert torch.equal(a, b), (s, role)
        for k, v in seq.metrics.items():
            assert abs(lane.metrics[k] - v) < METRIC_TOL, k


def test_apcvfl_dp_replicated_matches_sequential_received_latents(sc):
    """Two seeds of one defended cell through the lane engine: each seed's
    received latents are its sequential run's (its own noise key)."""
    seeds = [0, 1]
    ini = [reference_inits(sc, s) for s in seeds]
    kw = dict(max_epochs=EPOCHS, perm_fn=jax_perm, device="cpu")
    rep = tdefense.run_apcvfl_dp_replicated(sc, seeds=seeds, sigma=0.5,
                                            init_params=ini, **kw)
    for s, i, r in zip(seeds, ini, rep):
        seq = tdefense.run_apcvfl_dp(sc, seed=s, sigma=0.5, init_params=i,
                                     **kw)
        assert r.seed == s and r.comm == seq.comm
        assert torch.equal(r.artifacts["z_passive_aligned"],
                           seq.artifacts["z_passive_aligned"])
    assert not torch.equal(rep[0].artifacts["z_passive_aligned"],
                           rep[1].artifacts["z_passive_aligned"])


def test_apcvfl_dp_quantized_kparty_accounts_every_link():
    ds = make_dataset("bcw", seed=0)
    sck = jmp.make_scenario_k(ds, n_parties=3, n_active_features=5,
                              n_aligned=100, seed=0)
    want = jdefense.run_apcvfl_dp(sck, quantize="int8", seed=0,
                                  max_epochs=1)
    got = tdefense.run_apcvfl_dp(sck, quantize="int8", seed=0, max_epochs=1,
                                 init_params=reference_inits_k(sck, 0),
                                 perm_fn=jax_perm, device="cpu")
    assert len(got.channels) == 2
    for ch in got.channels:                   # each passive link quantized
        assert ch.bytes_by_dtype()["int8"] == 100 * 256
    assert [c.summary() for c in got.channels] == \
        [c.summary() for c in want.channels]
    assert got.comm == want.comm


# ---------------------------------------------------------------------------
# the inversion probe
# ---------------------------------------------------------------------------

def _inverter_init(seed, z_dim, d_x, hidden=128):
    return jax.tree.map(np.asarray, jae.init_mlp(
        jax.random.PRNGKey(seed), [z_dim, hidden, d_x]))


def test_run_inversion_matches_reference(sc, inits):
    d_p = sc.passive.x.shape[1]
    want = jprivacy.run_inversion(sc, n_aux=48, seed=0, max_epochs=EPOCHS)
    got = tprivacy.run_inversion(
        sc, n_aux=48, init_params={"g1_passive": inits["g1_passive"],
                                   "inverter": _inverter_init(0, 256, d_p)},
        **_kw())
    assert (got.method, got.rounds, got.epochs, got.comm, got.z_dim) == (
        want.method, want.rounds, want.epochs, want.comm, want.z_dim)
    assert got.to_record().keys() == want.to_record().keys()
    for k, v in want.metrics.items():
        assert abs(got.metrics[k] - v) < METRIC_TOL, k


def test_effective_n_aux_warns_and_records(sc):
    with pytest.warns(RuntimeWarning, match="clamped"):
        assert tprivacy.effective_n_aux(10_000, 120) == 100
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tprivacy.effective_n_aux(64, 120) == 64
    with pytest.warns(RuntimeWarning, match="n_aux=1 clamped to 2"):
        tprivacy.effective_n_aux(1, 120)
    with pytest.warns(RuntimeWarning, match="clamped"):
        r = tprivacy.run_inversion(sc, n_aux=10_000, max_epochs=1, seed=0,
                                   device="cpu")
    assert r.metrics["n_aux"] == 100.0
    assert r.metrics["n_aux_requested"] == 10_000.0
    assert r.metrics["n_aux_clamped"] == 1.0


# ---------------------------------------------------------------------------
# attacks
# ---------------------------------------------------------------------------

def test_attack_registry_schema_and_errors():
    assert tattacks.available_attacks() == jattacks.available_attacks() \
        == ("inversion", "label_leak", "membership")
    with pytest.raises(KeyError, match="unknown attack"):
        tattacks.get_attack("gradient_leak")
    with pytest.raises(ValueError, match="already registered"):
        tattacks.register_attack("inversion")(lambda s: None)


@pytest.fixture(scope="module")
def surfaces(sc, inits):
    """The clean and a sigma-8 surface in both packages, the port's on the
    reference's inits and noise."""
    want = jattacks.build_surfaces(
        sc, [None, jdefense.make_transform(sigma=8.0)], seed=0,
        max_epochs=EPOCHS)
    k3 = jax.random.split(jax.random.PRNGKey(0), 4)[2]
    g2 = [_init(jax.random.fold_in(k3, j), jae.table3_encoder("g2", 384))
          for j in range(2)]
    got = tattacks.build_surfaces(
        sc, [None, tdefense.make_transform(sigma=8.0, draw=jax_draw())],
        init_params={"g1_active": inits["g1_active"],
                     "g1_passive": inits["g1_passive"], "g2": g2},
        **_kw())
    return got, want


def test_build_surfaces_matches_reference(surfaces):
    got, want = surfaces
    for g, w in zip(got, want):
        assert g.channel.summary() == w.channel.summary()
        for f in ("z_exch", "z_pool", "z_teacher"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=0,
                                       atol=Z_ATOL, err_msg=f)
        for f in ("x_priv", "y", "member_mask"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.n_classes == w.n_classes and g.device == "cpu"


@pytest.mark.parametrize("attack", ["inversion", "label_leak", "membership"])
def test_attacks_match_reference_on_their_surfaces(surfaces, attack):
    got, want = surfaces
    for g, w in zip(got, want):
        kw = {}
        if attack == "inversion":
            kw = dict(init_params=_inverter_init(0, 256, g.x_priv.shape[1]),
                      perm_fn=jax_perm, max_epochs=EPOCHS)
        rep_g = tattacks.run_attack(attack, g, seed=0, **kw)
        kw.pop("init_params", None), kw.pop("perm_fn", None)
        rep_w = jattacks.run_attack(attack, w, seed=0, **kw)
        mg, mw = rep_g.metrics(), rep_w.metrics()
        assert mg.keys() == mw.keys()
        assert 0.0 <= mg["leakage"] <= 1.0
        for k, v in mw.items():
            assert abs(mg[k] - v) < METRIC_TOL * max(1.0, abs(v)), (attack, k)
    # undefended membership is ~total; the defense closes it
    if attack == "membership":
        assert tattacks.run_attack(attack, got[0]).leakage >= 0.9
        assert tattacks.run_attack(attack, got[1]).leakage < 0.9


@pytest.mark.parametrize("name", ["attack_inversion", "attack_label_leak",
                                  "attack_membership"])
def test_attack_run_wrappers_match_reference(sc, inits, name):
    want = getattr(jattacks, "run_" + name)(sc, sigma=0.0, seed=0,
                                            max_epochs=1)
    ini = {"g1_active": inits["g1_active"],
           "g1_passive": inits["g1_passive"],
           "g2": [_init(jax.random.fold_in(
               jax.random.split(jax.random.PRNGKey(0), 4)[2], 0),
               jae.table3_encoder("g2", 384))],
           "inverter": _inverter_init(0, 256, sc.passive.x.shape[1])}
    got = getattr(tattacks, "run_" + name)(sc, sigma=0.0, init_params=ini,
                                           seed=0, max_epochs=1,
                                           perm_fn=jax_perm, device="cpu")
    assert (got.method, got.rounds, got.comm, got.z_dim) == (
        want.method, want.rounds, want.comm, want.z_dim)
    assert got.to_record().keys() == want.to_record().keys()
    for k, v in want.metrics.items():
        assert abs(got.metrics[k] - v) < METRIC_TOL * max(1.0, abs(v)), k


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

def test_fault_plan_json_round_trip_and_validation(tmp_path):
    plan = tfaults.FaultPlan(name="p", seed=7, events=(
        tfaults.FaultEvent(kind="dropout", t_ms=100.0, tenant="a"),
        tfaults.FaultEvent(kind="stale", stage="exchange", epochs=2),
        tfaults.FaultEvent(kind="recover", t_ms=50.0, tenant="a"),
    ))
    assert tfaults.FaultPlan.from_json(plan.to_json()) == plan
    path = tmp_path / "plan.json"
    plan.save(str(path))
    assert tfaults.FaultPlan.load(str(path)) == plan
    assert plan.to_json() == jfaults.FaultPlan.from_json(
        plan.to_json()).to_json()
    assert [e.t_ms for e in plan.serving_events()] == [50.0, 100.0]
    assert len(plan.training_events()) == 1
    example = os.path.join(ROOT, "examples", "faults",
                           "passive_dropout.json")
    assert tfaults.FaultPlan.load(example).to_dict() == \
        jfaults.FaultPlan.load(example).to_dict()
    bad = [lambda m: m.FaultEvent(kind="meteor", t_ms=1.0),
           lambda m: m.FaultEvent(kind="dropout"),
           lambda m: m.FaultEvent(kind="dropout", t_ms=1.0,
                                  stage="exchange"),
           lambda m: m.FaultEvent(kind="dropout", stage="serve"),
           lambda m: m.FaultEvent(kind="recover", stage="exchange"),
           lambda m: m.FaultEvent.from_dict({"kind": "dropout",
                                             "t_ms": 1.0, "speed": 9}),
           lambda m: m.FaultEvent.from_dict({"t_ms": 1.0}),
           lambda m: m.FaultPlan.from_dict({"name": "x", "when": 1})]
    for make in bad:
        errs = []
        for mod in (tfaults, jfaults):
            with pytest.raises(ValueError) as ei:
                make(mod)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


def _plan(mod, **event):
    return mod.FaultPlan("f", events=(mod.FaultEvent(stage="exchange",
                                                     **event),))


def test_training_fault_dropout_is_the_ablation(sc, inits):
    r = tfaults.run_faulted_apcvfl(sc, _plan(tfaults, kind="dropout"),
                                   init_params=inits, **_kw())
    abl = tpipe.run_apcvfl(sc, ablation=True, init_params=inits, **_kw())
    assert r.method == "apcvfl_faulted"
    assert r.metrics["fault_dropout"] == 1.0 and r.rounds == 0
    assert set(r.params) == set(abl.params) == {"g3"}
    for a, b in zip(tree_leaves(r.params), tree_leaves(abl.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("event", [dict(kind="stale", epochs=1),
                                   dict(kind="drift", drift=0.5)],
                         ids=["stale", "drift"])
def test_training_faults_match_reference(sc, inits, event):
    want = jfaults.run_faulted_apcvfl(sc, _plan(jfaults, **event), seed=0,
                                      max_epochs=EPOCHS)
    got = tfaults.run_faulted_apcvfl(sc, _plan(tfaults, **event),
                                     init_params=inits, draw=jax_draw(),
                                     **_kw())
    flag = "fault_" + event["kind"]
    assert got.metrics[flag] == want.metrics[flag] == 1.0
    assert (got.method, got.rounds, got.epochs, got.comm) == (
        want.method, want.rounds, want.epochs, want.comm)
    np.testing.assert_allclose(
        _np(got.artifacts["z_passive_aligned"]),
        np.asarray(want.artifacts["z_passive_aligned"]), rtol=0, atol=Z_ATOL)
    for k, v in want.metrics.items():
        assert abs(got.metrics[k] - v) < METRIC_TOL, k


def test_stale_exchange_refuses_a_shape_mismatch():
    t = tfaults.StaleExchange(np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="do not match"):
        t.exchange(tcomm.Channel(), "step1/Z", torch.zeros((5, 4)))
    with pytest.raises(ValueError, match="magnitude"):
        tfaults.DriftExchange(-1.0)


def test_privacy_frontier_spec_methods_are_registered():
    from repro_torch.experiments import registry, specs
    with open(os.path.join(ROOT, "examples", "specs",
                           "privacy_frontier.json")) as fh:
        spec = specs.ExperimentSpec.from_dict(json.load(fh))
    for m in spec.methods:
        entry = registry.get_method(m.method)
        assert set(m.params) <= entry.accepts
