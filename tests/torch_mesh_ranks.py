"""The rank side of ``tests/test_torch_mesh.py``: what each of the gloo
world's processes runs (``repro_torch.launch.mesh.run_ranks``).  It
imports the port only, so the spawned ranks start without JAX; the test
hands it the reference's inits and epoch permutations as arrays."""
import torch

from repro_torch import convert
from repro_torch.core import autoencoder as ae
from repro_torch.core import pipeline, training
from repro_torch.data import scale
from repro_torch.data.synthetic import make_dataset
from repro_torch.data.vertical import make_scenario
from repro_torch.launch import mesh as meshlib
from repro_torch.tree import tree_map


class TablePerm:
    """``perm_fn`` from a table of recorded permutations: a missing key
    raises, so a sharded run cannot ask for what the unsharded one did
    not."""

    def __init__(self, table: dict):
        self.table = table

    def __call__(self, seed, epoch, n):
        return self.table[(int(seed), int(epoch), int(n))]


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def fit_summary(results) -> list:
    return [dict(params=_np(r.params), epochs=r.epochs_run,
                 steps=r.steps_run, train=list(r.train_loss),
                 val=list(r.val_loss)) for r in results]


def run_summary(r) -> dict:
    return dict(method=r.method, rounds=r.rounds, epochs=r.epochs,
                comm=r.comm, z_dim=r.z_dim, metrics=r.metrics,
                params={k: _np(v) for k, v in r.params.items()},
                channels=[c.summary() for c in r.channels])


def _lanes(case):
    return [training.LaneSpec(convert.to_torch(p, device="cpu"),
                              {"x": torch.as_tensor(x)}, s)
            for p, x, s in case["lanes"]]


def _held_rows(record):
    """Wrap ``training._split_slab`` to record the rows each lane keeps
    on this rank (train plus validation)."""
    inner = training._split_slab

    def split(data, seed, val_frac, dev, rows):
        tr, val, n_tr, loc = inner(data, seed, val_frac, dev, rows)
        record.append(len(tr["x"]) + len(val["x"]))
        return tr, val, n_tr, loc
    training._split_slab = split
    return inner


def run_cases(cases: dict) -> dict:
    """Every case on this rank; the outputs by case name."""
    out = {}
    for name, case in cases.items():
        mesh = meshlib.make_lane_mesh(**case["mesh"])
        if case["kind"] == "lanes":
            loss = ae.make_masked_recon_loss(case["use_kernel"])
            held = []
            inner = _held_rows(held)
            try:
                rs = training.train_lanes(
                    _lanes(case), loss, mesh=mesh,
                    shard_rows=case.get("shard_rows", False),
                    perm_fn=TablePerm(case["perms"]), **case["kw"])
            finally:
                training._split_slab = inner
            out[name] = dict(fits=fit_summary(rs), held=held)
        elif case["kind"] == "apcvfl":
            ds = make_dataset("bcw", seed=0)
            scs = [make_scenario(ds, n_active_features=5,
                                 n_aligned=case["aligned"], seed=s)
                   for s in case["seeds"]]
            rs = pipeline.run_apcvfl_replicated(
                scs, seeds=case["seeds"], init_params=case["inits"],
                perm_fn=TablePerm(case["perms"]), mesh=mesh, device="cpu",
                **case["kw"])
            out[name] = [run_summary(r) for r in rs]
        elif case["kind"] == "scale":
            kw = case["kw"]
            lanes = scale.make_scale_lanes(mesh=mesh, device="cpu", **kw)
            out[name] = {i: (sp.data["x"].start, sp.data["x"].local.numpy())
                         if isinstance(sp.data["x"], training.RowSlab)
                         else (0, None if sp.data["x"].is_meta
                               else sp.data["x"].numpy())
                         for i, sp in enumerate(lanes)}
        else:
            raise ValueError(case["kind"])
    return out

