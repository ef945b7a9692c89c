"""The port's K-party protocol (``core.multiparty``) and the serving CLI's
``--n-parties`` against the live JAX package on the CPU.

``make_scenario_k`` and ``align_k`` are host numpy in both packages and
must give identical arrays and bytes.  ``run_apcvfl_k`` runs in parity
mode (the reference's ``split(PRNGKey(seed), K + 2)`` inits and its
epoch permutations cross as arrays): epochs, rounds, comm and ``z_dim``
equal, params within 1e-4 relative, metrics within the 0.03 band.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import autoencoder as jae
from repro.core import multiparty as jmp
from repro.data.synthetic import make_dataset as jmake_dataset
from repro.serve import vfl as jsv
from repro_torch import convert
from repro_torch.core import multiparty as tmp
from repro_torch.data.synthetic import make_dataset
from repro_torch.launch import serve_vfl
from repro_torch.serve import vfl as tsv
from test_torch_pipeline import jax_perm

METRIC_TOL = 0.03
PARAM_REL = 1e-4
EPOCHS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread for this module's small CPU fits: the
    suite runs on several xdist workers sharing a few cores, where an
    oversubscribed thread pool slowed a 0.3 s fit a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_inits_k(sc, seed):
    """The inits ``run_apcvfl_k`` draws for ``seed``, as arrays keyed by
    role: keys[0] the active party's, keys[1..K-1] the passives',
    keys[-2] g2's and keys[-1] g3's (keys[K] is never used)."""
    K = len(sc.passives) + 1
    keys = jax.random.split(jax.random.PRNGKey(seed), K + 2)
    init = lambda k, w: jax.tree.map(np.asarray, jae.init_autoencoder(k, w))
    d_a = sc.active.x.shape[1]
    out = {"g1_active": init(keys[0], jae.table3_encoder("g1_active", d_a)),
           "g2": init(keys[-2], jae.table3_encoder("g2", 128 + 256 * (K - 1))),
           "g3": init(keys[-1], jae.table3_encoder("g3", d_a))}
    for i, p in enumerate(sc.passives):
        out[f"g1_passive{i}"] = init(
            keys[i + 1], jae.table3_encoder("g1_passive", p.x.shape[1]))
    return out


def _host_leaves(tree):
    """Leaves by sorted key path, as host arrays, of a tree of either
    package's arrays."""
    return jax.tree.leaves(jax.tree.map(np.asarray, convert.to_numpy(tree)))


def assert_params_close(got, want):
    got, want = _host_leaves(got), _host_leaves(want)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        rel = np.max(np.abs(g - w)) / max(float(np.max(np.abs(w))), 1.0)
        assert rel <= PARAM_REL


def assert_run_matches(got, want, roles=("g1_active", "g2", "g3")):
    assert (got.method, got.rounds, got.epochs, got.comm, got.z_dim) == (
        want.method, want.rounds, want.epochs, want.comm, want.z_dim)
    assert set(got.params) == set(want.params)
    for role in roles:
        if role in want.params:
            assert_params_close(got.params[role], want.params[role])
    for k in want.metrics:
        assert abs(got.metrics[k] - want.metrics[k]) < METRIC_TOL, k
    assert [c.summary() for c in got.channels] == \
        [c.summary() for c in want.channels]


@pytest.fixture(scope="module")
def scenario_k3():
    return jmp.make_scenario_k(jmake_dataset("bcw", seed=0), n_parties=3,
                               n_active_features=5, n_aligned=150, seed=0)


@pytest.mark.parametrize("K", [3, 4])
def test_make_scenario_k_identical(K):
    got = tmp.make_scenario_k(make_dataset("bcw", seed=1), n_parties=K,
                              n_active_features=5, n_aligned=120, seed=1)
    want = jmp.make_scenario_k(jmake_dataset("bcw", seed=1), n_parties=K,
                               n_active_features=5, n_aligned=120, seed=1)
    assert (got.name, got.n_aligned, got.n_classes) == (
        want.name, want.n_aligned, want.n_classes)
    assert len(got.passives) == len(want.passives) == K - 1
    for a, b in zip([got.active, *got.passives],
                    [want.active, *want.passives]):
        for field in ("x", "ids", "y"):
            u, v = getattr(a, field), getattr(b, field)
            assert (u is None) == (v is None)
            if u is not None:
                assert np.array_equal(u, v) and u.dtype == v.dtype, field


@pytest.mark.parametrize("case", ["K=3", "K=4", "no passive"])
def test_align_k_identical(case):
    rng = np.random.RandomState(3)
    active = rng.permutation(500)[:200]
    n_p = {"K=3": 2, "K=4": 3, "no passive": 0}[case]
    passives = [np.concatenate([active[:120], rng.permutation(500)[:40]
                                + 1000 * (i + 1)]) for i in range(n_p)]
    passives = [rng.permutation(p) for p in passives]
    got_c, got_ch = tmp.align_k(active, passives)
    want_c, want_ch = jmp.align_k(active, passives)
    assert np.array_equal(got_c, want_c) and got_c.dtype == want_c.dtype
    assert [c.summary() for c in got_ch] == [c.summary() for c in want_ch]
    assert len(got_ch) == n_p
    if n_p:
        # each link pays for the active party's FULL hashed-ID upload
        assert all(c.bytes_by_stage()["psi"] == 32 * (200 + len(p))
                   for c, p in zip(got_ch, passives))
    with pytest.raises(ValueError, match="unique"):
        tmp.align_k(np.array([1, 2, 2]), [])


@pytest.fixture(scope="module")
def reference_k3(scenario_k3):
    return {abl: jmp.run_apcvfl_k(scenario_k3, seed=0, max_epochs=EPOCHS,
                                  ablation=abl)
            for abl in (False, True)}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("ablation", [False, True])
def test_run_apcvfl_k_matches_reference(scenario_k3, reference_k3,
                                        use_kernel, ablation):
    want = reference_k3[ablation]
    got = tmp.run_apcvfl_k(scenario_k3, seed=0, max_epochs=EPOCHS,
                           use_kernel=use_kernel, ablation=ablation,
                           init_params=reference_inits_k(scenario_k3, 0),
                           perm_fn=jax_perm, device="cpu")
    assert_run_matches(got, want)
    if ablation:
        assert got.rounds == 0 and set(got.params) == {"g3"}
        assert got.artifacts is None and set(got.epochs) == {"g3"}
    else:
        assert set(got.epochs) == {"g1_active", "g1_passive0",
                                   "g1_passive1", "g2", "g3"}
        assert len(got.channels) == 2
        np.testing.assert_array_equal(got.artifacts["aligned_ids"],
                                      want.artifacts["aligned_ids"])
        z = got.artifacts["z_passive_aligned"]
        assert tuple(z.shape) == (150, 512)
        np.testing.assert_allclose(
            z.numpy(), np.asarray(want.artifacts["z_passive_aligned"]),
            atol=1e-4)


def test_run_apcvfl_k_refuses_exchange(scenario_k3):
    """Transforms are ported (``tests/test_torch_robustness.py``); what is
    refused, before any training, is an exchange that is not one."""
    with pytest.raises(TypeError, match="exchange"):
        tmp.run_apcvfl_k(scenario_k3, exchange=object(), device="cpu")


def test_serve_vfl_cli_n_parties_round_trip(tmp_path, capsys):
    """``--n-parties 3`` trains ``run_apcvfl_k``, exports, saves and
    reloads the bundle (the CLI asserts identical predictions), serves it,
    and ``--load`` serves the saved bundle again; the JAX engine serves
    the port's bundle to the same logits."""
    path = str(tmp_path / "k3")
    out = str(tmp_path / "stats.json")
    common = ["--smoke", "--device", "cpu", "--n-parties", "3",
              "--requests", "40", "--out", out]
    assert serve_vfl.main(common + ["--bundle", path]) == 0
    assert "round-trip verified" in capsys.readouterr().out
    assert os.path.exists(path + ".npz")
    assert serve_vfl.main(common + ["--load", path]) == 0
    bundle = tsv.ModelBundle.load(path)
    assert bundle.cache_z.shape == (150, 512)
    sc = tmp.make_scenario_k(make_dataset("bcw", seed=0), n_parties=3,
                             n_active_features=5, n_aligned=150, seed=0)
    x = np.asarray(sc.active.x[:64], np.float32)
    ids = sc.active.ids[:64]
    got = tsv.VFLServingEngine(bundle, device="cpu").predict(x, ids)
    want = jsv.VFLServingEngine(jsv.ModelBundle(**vars(bundle))).predict(
        x, ids)
    np.testing.assert_allclose(got, want, atol=1e-4)
