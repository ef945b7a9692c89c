"""The paper's baselines and the ablation in the port (SplitNN, FedSVD and
VFedTrans, ``run_apcvfl(ablation=True)``) against the live JAX package on
the CPU.

Parity mode, as in ``tests/test_torch_pipeline.py``: the reference's
``jax.random`` inits and epoch permutations cross as arrays.  FedSVD is
host numpy in both packages and must give the same bits; epochs, rounds,
comm bytes and ``z_dim`` are equal; params agree within 1e-4 relative
(``test_torch_multiparty.assert_params_close``) and metrics within the
0.03 band.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autoencoder as jae
from repro.core import comm as jcomm
from repro.core import fedsvd as jfedsvd
from repro.core import pipeline as jpipe
from repro.core import splitnn as jsplitnn
from repro.core import training as jtraining
from repro.core import vfedtrans as jvfedtrans
from repro.data.synthetic import make_dataset
from repro.data.vertical import make_scenario
from repro_torch import convert
from repro_torch.core import comm as tcomm
from repro_torch.core import fedsvd as tfedsvd
from repro_torch.core import protocol as tprotocol
from repro_torch.core import pipeline as tpipe
from repro_torch.core import splitnn as tsplitnn
from repro_torch.core import training as ttraining
from repro_torch.core import vfedtrans as tvfedtrans
from repro_torch.core.psi import psi
from repro_torch.tree import tree_leaves
from test_torch_multiparty import (  # noqa: F401 (autouse fixture)
    assert_params_close, one_torch_thread)
from test_torch_pipeline import jax_perm, reference_inits

METRIC_TOL = 0.03
EPOCHS = 2
TEST_SIZE = 50


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_metrics_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) < METRIC_TOL, k


@pytest.fixture(scope="module")
def scenario():
    return make_scenario(make_dataset("bcw", seed=0), n_active_features=5,
                         n_aligned=150, seed=0)


def _aligned(sc):
    """The aligned rows of both parties and their labels."""
    _, idx_a, idx_p = psi(sc.active.ids, sc.passive.ids)
    return sc.active.x[idx_a], sc.passive.x[idx_p], sc.active.y[idx_a]


# ---------------------------------------------------------------------------
# FedSVD: host numpy in both packages, so the same bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["bcw aligned rows", "random 40x(3,7)"])
def test_fedsvd_matches_reference_bits(scenario, case):
    if case == "bcw aligned rows":
        xa, xp, _ = _aligned(scenario)
        seed = 0
    else:
        rng = np.random.RandomState(5)
        xa, xp, seed = rng.randn(40, 3), rng.randn(40, 7), 3
    got = tfedsvd.fedsvd(xa, xp, seed=seed)
    want = jfedsvd.fedsvd(xa, xp, seed=seed)
    assert np.array_equal(got.U, want.U) and got.U.dtype == want.U.dtype
    assert np.array_equal(got.S, want.S) and got.S.dtype == want.S.dtype
    assert got.channel.summary() == want.channel.summary()
    assert got.rounds == want.rounds == tcomm.VFEDTRANS_ROUNDS
    n, x_t, x_d = len(xa), xa.shape[1], xp.shape[1]
    assert got.channel.total_bytes == tcomm.vfedtrans_footprint_bytes(
        n, x_t, x_d)


def test_comm_summarize_matches_reference():
    def links(mod):
        chans = [mod.Channel(), mod.Channel()]
        chans[0].send("psi/hashes_a", 320, direction="downlink")
        chans[0].send("step1/Z", 1024)
        chans[1].send("psi/hashes_a", 320, direction="downlink")
        chans[1].send("step1/Z", 4096, dtype="int8")
        return chans
    assert tcomm.summarize(links(tcomm)) == jcomm.summarize(links(jcomm))
    assert tcomm.summarize([]) == jcomm.summarize([])


# ---------------------------------------------------------------------------
# SplitNN
# ---------------------------------------------------------------------------

def _splitnn_init(sc, seed=0):
    xa, xp, _ = _aligned(sc)
    return _np(jsplitnn.init_splitnn(jax.random.PRNGKey(seed), xa.shape[1],
                                     xp.shape[1], sc.n_classes))


def test_splitnn_loss_and_gradients_match_reference(scenario):
    params = _splitnn_init(scenario)
    xa, xp, y = _aligned(scenario)
    batch = {"xa": xa[:64], "xp": xp[:64], "y": y[:64]}
    want, want_g = jax.value_and_grad(jsplitnn.splitnn_loss)(
        jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, batch))
    tp = convert.to_torch(params, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    got = tsplitnn.splitnn_loss(tp, {k: torch.as_tensor(v)
                                     for k, v in batch.items()})
    got_g = torch.autograd.grad(got, leaves)
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    for g, w in zip(got_g, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_splitnn_training_matches_reference_engine(scenario):
    """``run_splitnn``'s fit (the reference's returns no params): the
    same loss through both engines on the same rows, inits and
    permutations."""
    params = _splitnn_init(scenario)
    xa, xp, y = _aligned(scenario)
    data = {"xa": xa, "xp": xp, "y": y}
    kw = dict(batch_size=32, max_epochs=EPOCHS, patience=10, lr=1e-3,
              seed=0)
    want = jtraining.train(jax.tree.map(jnp.asarray, params), data,
                           jsplitnn.splitnn_loss, **kw)
    got = ttraining.train(convert.to_torch(params, device="cpu"),
                          {k: torch.as_tensor(np.asarray(v))
                           for k, v in data.items()},
                          tsplitnn.splitnn_loss, perm_fn=jax_perm, **kw)
    assert (got.epochs_run, got.steps_run) == (want.epochs_run,
                                               want.steps_run)
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-5)
    assert_params_close(got.params, want.params)


def test_run_splitnn_matches_reference(scenario):
    want = jsplitnn.run_splitnn(scenario, seed=0, max_epochs=EPOCHS,
                                test_size=TEST_SIZE)
    got = tsplitnn.run_splitnn(scenario, seed=0, max_epochs=EPOCHS,
                               test_size=TEST_SIZE,
                               init_params=_splitnn_init(scenario),
                               perm_fn=jax_perm, device="cpu")
    assert (got.method, got.rounds, got.epochs, got.comm, got.z_dim) == (
        want.method, want.rounds, want.epochs, want.comm, want.z_dim)
    _assert_metrics_close(got.metrics, want.metrics)
    n_tr = scenario.n_aligned - TEST_SIZE
    e = got.epochs["splitnn"]
    assert got.comm["by_stage"]["train"] == \
        tcomm.splitnn_footprint_bytes(e, n_tr, 128) == \
        jcomm.splitnn_footprint_bytes(e, n_tr, 128)
    assert got.rounds == tcomm.splitnn_rounds(e, n_tr, 128)
    assert len(got.train_loss["splitnn"]) == e
    assert got.to_record().keys() == want.to_record().keys()


# ---------------------------------------------------------------------------
# VFedTrans
# ---------------------------------------------------------------------------

def test_run_vfedtrans_matches_reference(scenario):
    want = jvfedtrans.run_vfedtrans(scenario, seed=0, max_epochs=EPOCHS)
    widths = [scenario.active.x.shape[1], 256, want.z_dim]
    init = _np(jae.init_autoencoder(jax.random.PRNGKey(0), widths))
    got = tvfedtrans.run_vfedtrans(scenario, seed=0, max_epochs=EPOCHS,
                                   init_params=init, perm_fn=jax_perm,
                                   device="cpu")
    assert (got.method, got.rounds, got.epochs, got.comm, got.z_dim) == (
        want.method, want.rounds, want.epochs, want.comm, want.z_dim)
    assert_params_close(got.params["extractor"],
                         want.params["extractor"])
    _assert_metrics_close(got.metrics, want.metrics)
    xa, xp, _ = _aligned(scenario)
    fs = jfedsvd.fedsvd(xa, xp, seed=0)
    assert np.array_equal(got.artifacts["U"], fs.U)
    assert np.array_equal(got.artifacts["S"], fs.S)
    assert got.comm["by_stage"]["fedsvd"] == \
        tcomm.vfedtrans_footprint_bytes(len(xa), xa.shape[1], xp.shape[1])
    assert got.z_dim == xa.shape[1] + xp.shape[1]


# ---------------------------------------------------------------------------
# the ablation: g3 without the distillation term
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_ablation(scenario):
    return jpipe.run_apcvfl(scenario, seed=0, max_epochs=EPOCHS,
                            ablation=True)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ablation_matches_reference(scenario, reference_ablation,
                                    use_kernel):
    want = reference_ablation
    got = tpipe.run_apcvfl(scenario, seed=0, max_epochs=EPOCHS,
                           ablation=True, use_kernel=use_kernel,
                           init_params=reference_inits(scenario, 0),
                           perm_fn=jax_perm, device="cpu")
    assert got.rounds == want.rounds == 0
    assert set(got.params) == set(want.params) == {"g3"}
    assert got.artifacts is None and want.artifacts is None
    assert (got.epochs, got.comm, got.z_dim) == (want.epochs, want.comm,
                                                  want.z_dim)
    assert set(got.seconds) == {"g3"} and set(got.steps) == {"g3"}
    assert_params_close(got.params["g3"], want.params["g3"])
    _assert_metrics_close(got.metrics, want.metrics)


def test_ablation_g3_starts_where_the_full_run_g3_starts(scenario):
    """The port's own inits: the ablation draws every role from the
    generator and keeps g3's, so its g3 starts where the full run's g3
    starts (as the reference's k4 is the fourth key either way)."""
    roles = ["g1_active", "g1_passive", "g2", "g3"]
    full = tprotocol.inits(scenario, 7, None, roles, roles[1:2], "cpu")
    abl = tprotocol.inits(scenario, 7, None, ["g3"], roles[1:2], "cpu")
    assert set(abl) == {"g3"}
    for a, b in zip(tree_leaves(abl["g3"]), tree_leaves(full["g3"])):
        assert torch.equal(a, b)
