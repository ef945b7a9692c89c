"""The port's seed-replica forms (``run_apcvfl_replicated``,
``run_apcvfl_aligned_only_replicated``, ``run_apcvfl_k_replicated``)
against the live JAX package's and against the port's own sequential runs
on the CPU.

Parity mode: each seed's reference inits and the reference's epoch
permutations cross as arrays.  Against the reference and against the
sequential run at the same seed: epochs, rounds, comm and ``z_dim``
equal, params within 1e-4 relative (one hidden unit of the aligned-only
g2's decoder against the reference excepted, see its test), metrics within
the 0.03 band
(``tests/test_replicas.py``'s tolerances for the same comparison inside
the reference).
"""
import jax
import numpy as np
import pytest

from repro.core import multiparty as jmp
from repro.core import pipeline as jpipe
from repro.data.synthetic import make_dataset
from repro.data.vertical import make_scenario
from repro_torch import convert
from repro_torch.core import multiparty as tmp
from repro_torch.core import pipeline as tpipe
from test_torch_multiparty import (  # noqa: F401 (autouse fixture)
    assert_params_close, assert_run_matches, one_torch_thread,
    reference_inits_k)
from test_torch_pipeline import jax_perm, reference_inits

EPOCHS = 2
SEEDS = [0, 1]


@pytest.fixture(scope="module")
def cells():
    ds = make_dataset("bcw", seed=0)
    return [make_scenario(ds, n_active_features=5, n_aligned=150, seed=s)
            for s in SEEDS]


@pytest.fixture(scope="module")
def cells_k3():
    return jmp.make_scenario_k(make_dataset("bcw", seed=0), n_parties=3,
                               n_active_features=5, n_aligned=120, seed=0)


def _kw(**kw):
    return dict(max_epochs=EPOCHS, perm_fn=jax_perm, device="cpu", **kw)


# ---------------------------------------------------------------------------
# 2-party: run_apcvfl_replicated
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_replicated(cells):
    return {abl: jpipe.run_apcvfl_replicated(cells, seeds=SEEDS,
                                             max_epochs=EPOCHS,
                                             ablation=abl)
            for abl in (False, True)}


@pytest.fixture(scope="module")
def port_replicated(cells):
    inits = [reference_inits(sc, s) for sc, s in zip(cells, SEEDS)]
    return {(uk, abl): tpipe.run_apcvfl_replicated(
        cells, seeds=SEEDS, use_kernel=uk, ablation=abl, init_params=inits,
        **_kw())
        for uk in (False, True) for abl in (False, True)}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("ablation", [False, True])
def test_run_apcvfl_replicated_matches_reference(
        reference_replicated, port_replicated, use_kernel, ablation):
    got = port_replicated[use_kernel, ablation]
    want = reference_replicated[ablation]
    assert [r.seed for r in got] == SEEDS
    for g, w in zip(got, want):
        assert_run_matches(g, w)
        if ablation:
            assert g.rounds == 0 and set(g.params) == {"g3"}
            assert g.artifacts is None
        else:
            np.testing.assert_array_equal(g.artifacts["aligned_ids"],
                                          w.artifacts["aligned_ids"])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("ablation", [False, True])
def test_run_apcvfl_replicated_matches_sequential(cells, port_replicated,
                                                  use_kernel, ablation):
    """Each lane is the sequential run at its seed: the same stages, lane
    seeds and inits."""
    for i, (sc, s) in enumerate(zip(cells, SEEDS)):
        seq = tpipe.run_apcvfl(sc, seed=s, use_kernel=use_kernel,
                               ablation=ablation,
                               init_params=reference_inits(sc, s), **_kw())
        rep = port_replicated[use_kernel, ablation][i]
        assert_run_matches(rep, seq)
        assert set(rep.train_loss) == set(seq.train_loss)
        for role, hist in seq.train_loss.items():
            np.testing.assert_allclose(rep.train_loss[role], hist, rtol=1e-5)


def test_run_apcvfl_replicated_draws_the_sequential_inits(cells):
    """Without ``init_params`` each lane draws the sequential run's inits
    from the port's own generator; one scenario may serve every seed."""
    rep = tpipe.run_apcvfl_replicated(cells[0], seeds=SEEDS, **_kw())
    assert [r.seed for r in rep] == SEEDS
    for s, r in zip(SEEDS, rep):
        assert_run_matches(r, tpipe.run_apcvfl(cells[0], seed=s, **_kw()))
    assert rep[0].train_loss != rep[1].train_loss
    assert tpipe.run_apcvfl_replicated(cells[0], seeds=[], **_kw()) == []


# ---------------------------------------------------------------------------
# 2-party: the aligned-only adaptation
# ---------------------------------------------------------------------------

# the aligned-only g2's decoder hidden unit on SELU's flat side, by seed
# (see the test below)
FLAT_DEC_UNIT = {0: 187}


def _without_unit(dec, unit):
    """``dec``'s leaves as host arrays, hidden unit ``unit``'s incoming
    weights (its column of ``w0``) taken out."""
    dec = jax.tree.map(np.asarray, convert.to_numpy(dec))
    if unit is None:
        return dec
    return {**dec, "w0": np.delete(dec["w0"], unit, axis=-1)}


def test_aligned_only_replicated_matches_reference_and_sequential(cells):
    """Against the reference: the whole g2 within 1e-4, but for one
    decoder hidden unit on seed 0 (``FLAT_DEC_UNIT``): it sits where SELU
    is flat, its gradients are eps-sized, and Adam's two steps there
    follow float noise (its incoming weights 1.47e-4 from the reference
    at one intra-op thread, 1.4e-5 at eight; ROADMAP Queue 3).  Seed 1's
    decoder is held whole.  Against the port's own sequential run, the
    whole g2 on every seed."""
    want = jpipe.run_apcvfl_aligned_only_replicated(
        cells, seeds=SEEDS, max_epochs=EPOCHS, test_size=30)
    inits = [reference_inits(sc, s, roles=tpipe.ROLES[:3])
             for sc, s in zip(cells, SEEDS)]
    got = tpipe.run_apcvfl_aligned_only_replicated(
        cells, seeds=SEEDS, test_size=30, init_params=inits, **_kw())
    for sc, s, ini, g, w in zip(cells, SEEDS, inits, got, want):
        assert_run_matches(g, w, roles=())
        assert_params_close(g.params["g2"]["enc"], w.params["g2"]["enc"])
        unit = FLAT_DEC_UNIT.get(s)
        assert_params_close(_without_unit(g.params["g2"]["dec"], unit),
                            _without_unit(w.params["g2"]["dec"], unit))
        seq = tpipe.run_apcvfl_aligned_only(sc, seed=s, test_size=30,
                                            init_params=ini, **_kw())
        assert_run_matches(g, seq, roles=("g2",))


# ---------------------------------------------------------------------------
# K parties: run_apcvfl_k_replicated
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_k_replicated(cells_k3):
    return {abl: jmp.run_apcvfl_k_replicated(cells_k3, seeds=SEEDS,
                                             max_epochs=EPOCHS,
                                             ablation=abl)
            for abl in (False, True)}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("ablation", [False, True])
def test_run_apcvfl_k_replicated_matches_reference_and_sequential(
        cells_k3, reference_k_replicated, use_kernel, ablation):
    inits = [reference_inits_k(cells_k3, s) for s in SEEDS]
    got = tmp.run_apcvfl_k_replicated(cells_k3, seeds=SEEDS,
                                      use_kernel=use_kernel,
                                      ablation=ablation, init_params=inits,
                                      **_kw())
    for s, ini, g, w in zip(SEEDS, inits, got,
                            reference_k_replicated[ablation]):
        assert g.seed == s
        assert_run_matches(g, w)
        seq = tmp.run_apcvfl_k(cells_k3, seed=s, use_kernel=use_kernel,
                               ablation=ablation, init_params=ini, **_kw())
        assert_run_matches(g, seq)
        if not ablation:
            assert len(g.channels) == 2     # one per passive link


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

ENTRY_POINTS = {
    "run_apcvfl_replicated": (tpipe.run_apcvfl_replicated, "cells"),
    "run_apcvfl_aligned_only_replicated": (
        tpipe.run_apcvfl_aligned_only_replicated, "cells"),
    "run_apcvfl_k_replicated": (tmp.run_apcvfl_k_replicated, "cells_k3"),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
@pytest.mark.parametrize("bad", ["mesh", "exchange", "scenario count"])
def test_replicated_entry_points_refuse(request, name, bad):
    fn, fixture = ENTRY_POINTS[name]
    scs = request.getfixturevalue(fixture)
    if bad == "scenario count":
        many = scs if isinstance(scs, list) else [scs, scs]
        with pytest.raises(ValueError, match="2 scenarios for 1 seeds"):
            fn(many, seeds=[0], device="cpu")
    elif bad == "mesh":
        # a mesh without the lane axis: the reference's error, before
        # any training
        with pytest.raises(ValueError, match="lack the 'lane' axis"):
            fn(scs, seeds=SEEDS, mesh=object(), device="cpu")
    else:
        # the aligned-only runner takes no exchange, as the reference's;
        # the others refuse one that is not a transform before training
        with pytest.raises(TypeError, match="exchange"):
            fn(scs, seeds=SEEDS, exchange=object(), device="cpu")
