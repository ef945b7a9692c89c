"""The port's lane meshes (``repro_torch.launch.mesh``) and the lane
engine over them (``train_lanes(mesh=, shard_rows=)``, the replicated
protocol, ``ExperimentSpec.devices``) against the live JAX package on
the CPU.

Mesh checks mirror ``tests/test_mesh_lanes.py``.  One gloo world of 4
ranks (``launch.mesh.run_ranks``, spawned once for the file, joined
through a file store under ``tmp_path``) runs every sharded case; the
reference's single-device runs are the oracle, since the reference
asserts that its sharded runs equal its unsharded ones (its
``needs_devices`` tests skip on one CPU device).  Bounds: against the
reference, the port's training bounds (epochs and steps equal, losses
and params 1e-5 relative; the protocol's ``test_mesh_lanes.py:146``
bounds: params 1e-4, metrics 0.03); against the port's own unsharded
run, the same bits where only lanes split or the rows fall back to
replicated (``torch.equal``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import autoencoder as jae
from repro.core import pipeline as jpipe
from repro.core import training as jtraining
from repro.data.synthetic import make_dataset as jmake_dataset
from repro.data.vertical import make_scenario as jmake_scenario
from repro_torch import convert
from repro_torch.core import autoencoder as tae
from repro_torch.core import pipeline as tpipe
from repro_torch.core import training as ttraining
from repro_torch.data import scale as tscale
from repro_torch.experiments import ExperimentSpec, MethodSpec, sweep
from repro_torch.experiments import sweeps as tsweeps
from repro_torch.launch import mesh as meshlib
from repro_torch.tree import tree_leaves
from test_torch_multiparty import (  # noqa: F401 (autouse fixture)
    METRIC_TOL, one_torch_thread)
from test_torch_pipeline import jax_perm, reference_inits
from torch_mesh_ranks import run_cases

REL = 1e-5


@pytest.fixture
def no_world():
    """Whatever a test starts, no process group outlives it."""
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# mesh construction + validation
# ---------------------------------------------------------------------------

def test_make_lane_mesh_axis_names_and_world_of_one(no_world):
    m = meshlib.make_lane_mesh(lane=1, data=1)
    assert m.mesh_dim_names == ("lane", "data")
    assert tuple(m.shape) == (1, 1) and dist.get_world_size() == 1
    assert m.device_type == "cpu"


def test_make_lane_mesh_too_many_ranks_names_the_fix(no_world):
    with pytest.raises(ValueError) as ei:
        meshlib.make_lane_mesh(lane=2)
    msg = str(ei.value)
    assert "needs 2 ranks" in msg and "{'lane': 2, 'data': 1}" in msg
    assert "torchrun --nproc-per-node 2" in msg and "gloo" in msg
    assert not dist.is_initialized()


def test_make_local_mesh_too_many_ranks(no_world):
    with pytest.raises(ValueError, match="needs"):
        meshlib.make_local_mesh(data=2)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        meshlib.make_production_mesh()


@pytest.mark.parametrize("bad", [0, -1, 1.5, "2", None])
def test_make_lane_mesh_rejects_non_positive_axes(no_world, bad):
    with pytest.raises(ValueError, match="positive int"):
        meshlib.make_lane_mesh(lane=bad)
    assert not dist.is_initialized()


def test_mesh_module_import_starts_no_world():
    import subprocess
    import sys
    code = ("import torch.distributed as d; "
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.data.scale; print(d.is_initialized())")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**__import__("os").environ,
                            "PYTHONPATH": "src"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "False"


def test_spec_devices_too_many_raises_before_any_run(no_world,
                                                     monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a scenario was built before the mesh")
    monkeypatch.setattr(tsweeps, "build_scenario", no_build)
    spec = ExperimentSpec(name="big", methods=(MethodSpec("apcvfl"),),
                          devices={"lane": 2})
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        sweep(spec, device="cpu")


def test_sweep_threads_mesh_into_replicated_runner(no_world, monkeypatch):
    """``devices={}`` keeps runners without a mesh keyword working; a
    non-empty ``devices`` delivers the built mesh as ``mesh=``
    (``tests/test_mesh_lanes.py:201``)."""
    import repro_torch.experiments.registry as reg
    from repro_torch.experiments.registry import get_method
    from repro_torch.experiments.results import RunResult

    get_method("apcvfl")
    seen = {}

    def spy(scenarios, mspec, *, seeds, device, mesh=None):
        seen["mesh"] = mesh
        return [RunResult(method="apcvfl", metrics={}, rounds=0, seed=s)
                for s in seeds]

    entry = reg._REGISTRY["apcvfl"]
    monkeypatch.setitem(reg._REGISTRY, "apcvfl",
                        dataclasses.replace(entry, replicated_fn=spy))
    spec = ExperimentSpec(name="spy", dataset="bcw", aligned=(100,),
                          seeds=(0, 1), methods=(MethodSpec("apcvfl"),),
                          devices={"lane": 1})
    sweep(spec, device="cpu")
    assert seen["mesh"] is not None
    assert seen["mesh"].mesh_dim_names == ("lane", "data")

    def legacy(scenarios, mspec, *, seeds, device):   # no mesh keyword
        seen["legacy"] = True
        return [RunResult(method="apcvfl", metrics={}, rounds=0, seed=s)
                for s in seeds]

    monkeypatch.setitem(reg._REGISTRY, "apcvfl",
                        dataclasses.replace(entry, replicated_fn=legacy))
    sweep(dataclasses.replace(spec, devices={}), device="cpu")
    assert seen.get("legacy")


# ---------------------------------------------------------------------------
# one gloo world of 4 for every sharded case
# ---------------------------------------------------------------------------

class Recording:
    """``perm_fn`` that records what it hands out, for the ranks."""

    def __init__(self, fn):
        self.fn, self.table = fn, {}

    def __call__(self, seed, epoch, n):
        p = np.asarray(self.fn(seed, epoch, n))
        self.table[(int(seed), int(epoch), int(n))] = p
        return p


def _uneven_lanes():
    """``tests/test_mesh_lanes.py``'s lanes: three shapes, so three shape
    groups of one lane each on a 4-rank lane axis."""
    rng = np.random.RandomState(0)
    out = []
    for i, (n, d) in enumerate([(120, 6), (90, 4), (150, 5)]):
        x = rng.randn(n, d).astype(np.float32)
        p = jax.tree.map(np.asarray, jae.init_autoencoder(
            jax.random.PRNGKey(10 + i), [d, 8, 4]))
        out.append((p, x, i))
    return out


def _row_lanes(rows):
    rng = np.random.RandomState(1)
    return [(jax.tree.map(np.asarray, jae.init_autoencoder(
        jax.random.PRNGKey(20 + i), [6, 8, 4])),
        rng.randn(rows, 6).astype(np.float32), i) for i in range(2)]


UNEVEN_KW = dict(batch_size=16, max_epochs=6, patience=4, lr=1e-3)
ROWS_KW = dict(batch_size=16, max_epochs=4, patience=3, lr=1e-3)
APC_SEEDS, APC_ALIGNED, APC_KW = [0, 1], 120, dict(max_epochs=3)
SCALE_KW = dict(n_rows=1000, n_parties=2, n_features=6, widths=[6, 8, 4],
                seeds=(3,), block_rows=256)


def _port_lanes(lanes):
    return [ttraining.LaneSpec(convert.to_torch(p, device="cpu"),
                               {"x": torch.as_tensor(x)}, s)
            for p, x, s in lanes]


def _ref_lanes(lanes):
    return [jtraining.LaneSpec(p, {"x": x}, s) for p, x, s in lanes]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cases and their port-unsharded runs in this process (which
    record the reference's permutations the ranks are handed), the 4-rank
    world's outputs (rank by rank), and the reference's runs, made while
    the world runs."""
    import threading
    cases, local, ref = {}, {}, {}
    for use_kernel in (False, True):
        name = f"uneven_kernel{int(use_kernel)}"
        rec = Recording(jax_perm)
        local[name] = ttraining.train_lanes(
            _port_lanes(_uneven_lanes()),
            tae.make_masked_recon_loss(use_kernel), perm_fn=rec,
            **UNEVEN_KW)
        cases[name] = dict(kind="lanes", mesh=dict(lane=4),
                           lanes=_uneven_lanes(), use_kernel=use_kernel,
                           kw=UNEVEN_KW, perms=rec.table)
    for rows in (128, 130):
        name = f"rows{rows}"
        rec = Recording(jax_perm)
        local[name] = ttraining.train_lanes(
            _port_lanes(_row_lanes(rows)), tae.masked_recon_loss,
            perm_fn=rec, **ROWS_KW)
        cases[name] = dict(kind="lanes", mesh=dict(lane=2, data=2),
                           lanes=_row_lanes(rows), use_kernel=False,
                           shard_rows=True, kw=ROWS_KW, perms=rec.table)
    jds = jmake_dataset("bcw", seed=0)
    jscs = [jmake_scenario(jds, n_active_features=5, n_aligned=APC_ALIGNED,
                           seed=s) for s in APC_SEEDS]
    inits = [reference_inits(sc, s) for sc, s in zip(jscs, APC_SEEDS)]
    rec = Recording(jax_perm)
    local["apcvfl"] = tpipe.run_apcvfl_replicated(
        jscs, seeds=APC_SEEDS, init_params=inits, perm_fn=rec,
        device="cpu", **APC_KW)
    cases["apcvfl"] = dict(kind="apcvfl", mesh=dict(lane=4),
                           seeds=APC_SEEDS, aligned=APC_ALIGNED, inits=inits,
                           perms=rec.table, kw=APC_KW)
    cases["scale"] = dict(kind="scale", mesh=dict(lane=2, data=2),
                          kw=SCALE_KW)

    outs, errs = [], []

    def ranks():
        try:
            outs.extend(meshlib.run_ranks(
                run_cases, 4, cases,
                init_dir=str(tmp_path_factory.mktemp("gloo"))))
        except BaseException as e:     # re-raised below
            errs.append(e)
    th = threading.Thread(target=ranks)
    th.start()
    try:
        ref["uneven"] = jtraining.train_lanes(
            _ref_lanes(_uneven_lanes()), jae.masked_recon_loss, **UNEVEN_KW)
        for rows in (128, 130):
            ref[f"rows{rows}"] = jtraining.train_lanes(
                _ref_lanes(_row_lanes(rows)), jae.masked_recon_loss,
                **ROWS_KW)
        ref["apcvfl"] = jpipe.run_apcvfl_replicated(jscs, seeds=APC_SEEDS,
                                                    **APC_KW)
    finally:
        th.join()
    if errs:
        raise errs[0]
    return dict(local=local, ref=ref, outs=outs)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1.0))


def _match_reference(fits, want):
    assert len(fits) == len(want)
    for g, w in zip(fits, want):
        assert (g["epochs"], g["steps"]) == (w.epochs_run, w.steps_run)
        np.testing.assert_allclose(g["train"], w.train_loss, rtol=REL)
        np.testing.assert_allclose(g["val"], w.val_loss, rtol=REL)
        got = tree_leaves(g["params"])
        exp = [np.asarray(x) for x in jax.tree.leaves(w.params)]
        assert [a.shape for a in got] == [b.shape for b in exp]
        assert max(_rel(a, b) for a, b in zip(got, exp)) <= REL


def _match_bits(fits, want):
    for g, w in zip(fits, want):
        assert (g["epochs"], g["steps"]) == (w.epochs_run, w.steps_run)
        assert g["train"] == w.train_loss and g["val"] == w.val_loss
        for a, b in zip(tree_leaves(g["params"]), tree_leaves(w.params)):
            assert torch.equal(torch.as_tensor(a), b)


def test_every_rank_returns_every_result(world):
    for name in world["outs"][0]:
        if name == "scale":
            continue
        first = world["outs"][0][name]
        for other in world["outs"][1:]:
            got = other[name]
            pairs = zip(first["fits"], got["fits"]) if isinstance(
                first, dict) else zip(first, got)
            for a, b in pairs:
                for x, y in zip(tree_leaves(a["params"]),
                                tree_leaves(b["params"])):
                    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lane_split_matches_reference_and_unsharded_bits(world, use_kernel):
    """3 lanes on a 4-rank lane axis (one rank trains nothing), plain and
    kernel loss (the kernels' plain route on the CPU)."""
    name = f"uneven_kernel{int(use_kernel)}"
    fits = world["outs"][0][name]["fits"]
    _match_reference(fits, world["ref"]["uneven"])
    _match_bits(fits, world["local"][name])


@pytest.mark.parametrize("rows", [128, 130])
def test_row_sharded_matches_reference(world, rows):
    """lane 2 x data 2 with ``shard_rows``: 128 rows split (the data axis
    divides 116 train and 12 validation rows), 130 do not (117 and 13) and
    fall back to replicated rows, giving the unsharded bits."""
    name = f"rows{rows}"
    for out in world["outs"]:
        _match_reference(out[name]["fits"], world["ref"][name])
    held = [out[name]["held"] for out in world["outs"]]
    if rows == 128:
        # each rank keeps 64 of a lane's 128 rows, never the whole set
        assert held == [[64]] * 4
    else:
        assert held == [[]] * 4
        _match_bits(world["outs"][0][name]["fits"], world["local"][name])


def test_replicated_protocol_over_a_lane_mesh(world):
    got = world["outs"][0]["apcvfl"]
    want = world["ref"]["apcvfl"]
    local = world["local"]["apcvfl"]
    for g, w, lo in zip(got, want, local):
        assert (g["method"], g["rounds"], g["epochs"], g["comm"],
                g["z_dim"]) == (w.method, w.rounds, w.epochs, w.comm,
                                w.z_dim)
        for role in ("g1_active", "g2", "g3"):
            exp = [np.asarray(x) for x in jax.tree.leaves(w.params[role])]
            assert max(_rel(a, b) for a, b in zip(
                tree_leaves(g["params"][role]), exp)) <= 1e-4
            for a, b in zip(tree_leaves(g["params"][role]),
                            tree_leaves(lo.params[role])):
                assert torch.equal(torch.as_tensor(a), b)
        for k in w.metrics:
            assert abs(g["metrics"][k] - w.metrics[k]) < METRIC_TOL, k
        assert g["metrics"] == lo.metrics
        assert g["channels"] == [c.summary() for c in w.channels]


def test_scale_slabs_concatenate_to_the_unsharded_generation(world):
    """lane 2 x data 2: rank (l, r) generates lane l's rows [500 r,
    500 (r + 1)) only and holds the other lane as meta."""
    full = tscale.make_scale_lanes(device="cpu", **SCALE_KW)
    outs = world["outs"]
    for lane in range(2):
        ranks = [2 * lane, 2 * lane + 1]           # (lane, data) row-major
        slabs = [outs[r]["scale"][lane] for r in ranks]
        assert [s[0] for s in slabs] == [0, 500]
        np.testing.assert_array_equal(
            np.concatenate([s[1] for s in slabs]),
            full[lane].data["x"].numpy())
        for r in range(4):
            if r not in ranks:
                assert outs[r]["scale"][lane] == (0, None)
