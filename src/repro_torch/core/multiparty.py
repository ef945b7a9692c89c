"""K-participant APC-VFL (paper Sec. 3 formalizes K parties; the
experiments use K=2): the port of ``repro.core.multiparty``.

One active participant (holds labels), K-1 passive participants.  Step 1
runs at every party; each passive sends its aligned-row latents to the
active party (K-1 single exchanges, still ONE round per link, the paper's
claim is per pair); steps 2-4 run at the active party on the concat of
all K latent blocks.  Alignment is ``protocol.align_k``: K-1 genuine
pairwise PSIs intersected at the active party.

The four steps are ``core.protocol.run_protocol``; this module holds the
K-party scenario and the K-party entry points.  As in the reference, the
K-party g1s and g2 train on ``masked_recon_loss`` whatever ``use_kernel``
says (on the card it reconstructs through the lane-MLP kernels either
way); passive i's lane seed is ``seed + i + 1``, g2's ``seed + 100`` and
g3's ``seed + 200``.  ``exchange`` hardens every passive link's send,
each link keyed by its index.

Initial params come from one ``torch.Generator`` seeded with the run's
seed, or from ``init_params`` as arrays keyed by role (``g1_passive0``,
``g1_passive1``, ... for the passives); ``perm_fn`` replaces the epoch
permutations.  Results carry one ``comm.Channel`` per passive link and
their sum (``comm.summarize``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.apcvfl_paper import TABULAR as HP
from repro_torch.core import protocol
from repro_torch.core.protocol import align_k  # noqa: F401 (public name)
from repro_torch.data.synthetic import TabularDataset
from repro_torch.data.vertical import ParticipantData
from repro_torch.experiments.results import RunResult


@dataclass
class VFLScenarioK:
    name: str
    active: ParticipantData
    passives: List[ParticipantData]
    n_aligned: int
    n_classes: int


def make_scenario_k(ds: TabularDataset, *, n_parties: int,
                    n_active_features: int, n_aligned: int,
                    seed: int = 0) -> VFLScenarioK:
    """Split columns among K parties (active gets ``n_active_features``,
    passives share the rest round-robin); rows: ``n_aligned`` common to all,
    remainder split disjointly.  The reference's numpy stream, so the same
    arrays."""
    assert n_parties >= 2
    rng = np.random.RandomState(seed + 2000)
    d = ds.x.shape[1]
    cols = rng.permutation(d)
    a_cols = np.sort(cols[:n_active_features])
    rest = cols[n_active_features:]
    p_cols = [np.sort(rest[i::n_parties - 1]) for i in range(n_parties - 1)]
    assert all(len(c) for c in p_cols), "not enough features for K parties"

    n = len(ds.x)
    perm = rng.permutation(n)
    aligned = perm[:n_aligned]
    rest_rows = np.array_split(perm[n_aligned:], n_parties)
    rows = [np.concatenate([aligned, rr]) for rr in rest_rows]

    active = ParticipantData(x=ds.x[rows[0]][:, a_cols], ids=ds.ids[rows[0]],
                             y=ds.y[rows[0]])
    passives = [ParticipantData(x=ds.x[rows[i + 1]][:, p_cols[i]],
                                ids=ds.ids[rows[i + 1]])
                for i in range(n_parties - 1)]
    return VFLScenarioK(ds.name, active, passives, n_aligned, ds.n_classes)


def run_apcvfl_k(sc: VFLScenarioK, *, lam: float = HP.lam,
                 kind: str = HP.kind, seed: int = 0,
                 batch_size: int = HP.batch_size,
                 max_epochs: int = HP.max_epochs,
                 patience: int = HP.patience, lr: float = HP.lr,
                 use_kernel: bool = False, ablation: bool = False,
                 exchange=None, init_params: Optional[dict] = None,
                 perm_fn: Optional[Callable] = None,
                 device="cuda") -> RunResult:
    """K-party protocol on ``device``; the same features as the 2-party
    ``pipeline.run_apcvfl`` (``ablation=True`` trains g3 without the
    distillation term; ``exchange`` hardens every passive link's one-shot
    latent send, each link keyed by its index)."""
    (res,) = protocol.run_protocol(
        [sc], [int(seed)], k_party=True, lanes_g3=False, lam=lam, kind=kind,
        use_kernel=use_kernel, ablation=ablation,
        init_params=None if init_params is None else [init_params],
        train_kw=dict(batch_size=batch_size, max_epochs=max_epochs,
                      patience=patience, lr=lr, perm_fn=perm_fn),
        dev=resolve_device(device), exchange=exchange)
    return res


def run_apcvfl_k_replicated(scenarios, *, seeds, lam: float = HP.lam,
                            kind: str = HP.kind,
                            batch_size: int = HP.batch_size,
                            max_epochs: int = HP.max_epochs,
                            patience: int = HP.patience, lr: float = HP.lr,
                            use_kernel: bool = False, ablation: bool = False,
                            exchange=None, mesh=None,
                            init_params: Optional[Sequence[dict]] = None,
                            perm_fn: Optional[Callable] = None,
                            device="cuda") -> List[RunResult]:
    """K-party protocol for S seed replicates: all parties of all seeds
    train their g1 as S*K lanes of one ``train_lanes`` call, then S g2
    lanes, then S g3 lanes.  One scenario shared by every seed or one
    equal-shape scenario per seed; one ``RunResult`` per seed matching
    ``run_apcvfl_k(scenarios[i], seed=seeds[i], ...)`` within float
    tolerance.  ``exchange`` is one transform shared by every seed (each
    seed's noise keyed by that seed) or one per seed; ``mesh``
    (``launch.mesh.make_lane_mesh``) splits every stage's lanes over its
    ranks."""
    scs, seeds = protocol.normalize_replicas("run_apcvfl_k_replicated",
                                             scenarios, seeds)
    if not seeds:
        return []
    return protocol.run_protocol(
        scs, seeds, k_party=True, lanes_g3=True, lam=lam, kind=kind,
        use_kernel=use_kernel, ablation=ablation, init_params=init_params,
        train_kw=dict(batch_size=batch_size, max_epochs=max_epochs,
                      patience=patience, lr=lr, perm_fn=perm_fn),
        dev=resolve_device(device), exchange=exchange, mesh=mesh)
