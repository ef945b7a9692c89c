"""K-participant APC-VFL (paper Sec. 3 formalizes K parties; the
experiments use K=2): the port of ``repro.core.multiparty``, and the one
implementation of the protocol's four steps in the port
(``run_protocol``), whose 2-party case ``pipeline.run_apcvfl`` and
``pipeline.run_apcvfl_replicated`` are.

One active participant (holds labels), K-1 passive participants.  Step 1
runs at every party; each passive sends its aligned-row latents to the
active party (K-1 single exchanges, still ONE round per link, the paper's
claim is per pair); steps 2-4 run at the active party on the concat of
all K latent blocks.

Alignment is the row intersection across ALL parties, computed as K-1
genuine pairwise PSIs (active vs each passive) whose results are
intersected locally at the active party.  Each link is charged for the
active party's FULL hashed-ID upload, so total PSI traffic is monotone
in K.

Every stage is lanes of ``training.train_lanes``: the K g1s of a run
(the passives of equal shape in one group), g2 a singleton lane, and g3
through ``training.train``; the replicated forms run S seeds' g1s as S*K
lanes, g2 and g3 as S lanes each, g3 on ``distill.make_lanes_loss`` (on
the card with ``use_kernel``, the Eq. 5 rows kernel under autograd).  As
in the reference, the K-party g1s and g2 train on ``masked_recon_loss``
whatever ``use_kernel`` says (on the card it reconstructs through the
lane-MLP kernels either way); passive i's lane seed is ``seed + i + 1``,
g2's ``seed + 100`` and g3's ``seed + 200``.

Initial params come from one ``torch.Generator`` seeded with the run's
seed, drawn for g1_active, each passive's g1, g2 and g3 in that order
(whichever roles a run trains), or from ``init_params`` as arrays keyed
by role (``g1_passive0``, ``g1_passive1``, ... for the passives);
``perm_fn`` replaces the epoch permutations.  Results carry one
``comm.Channel`` per passive link and their sum (``comm.summarize``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.configs.apcvfl_paper import TABULAR as HP
from repro_torch.core import autoencoder as ae
from repro_torch.core import classifier as clf
from repro_torch.core import comm
from repro_torch.core import distill
from repro_torch.core import training
from repro_torch.core.psi import id_positions, psi
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


def align_k(active_ids: np.ndarray, passive_ids: List[np.ndarray]):
    """Multi-party alignment as K-1 genuine pairwise PSIs (active vs each
    passive), intersected locally at the active party.  Each link is
    charged for the active party's FULL hashed-ID upload.  Returns
    (common_ids sorted, per-link channels)."""
    if not passive_ids:          # degenerate: nothing to align against
        common = np.unique(np.asarray(active_ids))   # sorted, per contract
        if len(common) != len(active_ids):           # same policy as psi()
            raise ValueError("PSI requires unique IDs: got "
                             f"{len(active_ids)} ids, {len(common)} distinct")
        return common, []
    channels = [comm.Channel() for _ in passive_ids]
    pair_commons = []
    for ids, ch in zip(passive_ids, channels):
        c, _, _ = psi(active_ids, ids, channel=ch)
        pair_commons.append(c)
    common = pair_commons[0]
    for c in pair_commons[1:]:
        common = np.intersect1d(common, c)
    return common, channels


def _index_of(ids: np.ndarray, subset: np.ndarray) -> np.ndarray:
    pos = id_positions(ids)
    return np.asarray([pos[int(s)] for s in subset], dtype=np.int64)


# ---------------------------------------------------------------------------
# the protocol's four steps, for any K and any number of seed replicas
# ---------------------------------------------------------------------------

def refuse_unported(fn_name: str, *, exchange=None, mesh=None) -> None:
    """Raise for the arguments whose machinery the port does not have
    yet."""
    if exchange is not None:
        raise NotImplementedError(
            f"{fn_name}(exchange=...): exchange transforms are not ported "
            f"yet (ROADMAP.md Queue 1 item 6, the robustness slice)")
    if mesh is not None:
        raise NotImplementedError(
            f"{fn_name}(mesh=...): lane sharding across devices is not "
            f"ported yet (ROADMAP.md Queue 1 item 10, the multi-device "
            f"slice)")


def normalize_replicas(fn_name: str, scenarios, seeds):
    """Shared contract of the ``*_replicated`` entry points: int seeds,
    one scenario (anything with an ``active`` party) broadcast to every
    seed or exactly one per seed."""
    seeds = [int(s) for s in seeds]
    S = len(seeds)
    scs = [scenarios] * S if hasattr(scenarios, "active") \
        else list(scenarios)
    if len(scs) != S:
        raise ValueError(f"{fn_name}: {len(scs)} scenarios for {S} seeds")
    return scs, seeds


def passives(sc) -> list:
    """The passive parties of a K-party or a 2-party scenario."""
    return list(sc.passives) if hasattr(sc, "passives") else [sc.passive]


def rows(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def inits(sc, seed: int, init_params, roles: Sequence[str],
          passive_roles: Sequence[str], dev) -> dict:
    """Each of ``roles``' autoencoder inits: the given arrays, or that
    role's draw from one generator that draws g1_active, the passives'
    g1s (named ``passive_roles``), g2 and g3 in order, whichever roles a
    run trains."""
    if init_params is not None:
        return {r: convert.to_torch(init_params[r], device=dev)
                for r in roles}
    d_a = sc.active.x.shape[1]
    widths = {"g1_active": ae.table3_encoder("g1_active", d_a)}
    for r, p in zip(passive_roles, passives(sc)):
        widths[r] = ae.table3_encoder("g1_passive", p.x.shape[1])
    d_j = sum(w[-1] for w in widths.values())
    widths["g2"] = ae.table3_encoder("g2", d_j)
    widths["g3"] = ae.table3_encoder("g3", d_a)
    gen = torch.Generator().manual_seed(seed)
    drawn = {r: ae.init_autoencoder(gen, w, device=dev)
             for r, w in widths.items()}
    return {r: drawn[r] for r in roles}


def g3_data(xa: torch.Tensor, idx_a, z_teacher_al) -> dict:
    """Step 3's rows: every active row, with the teacher's joint latent
    and a 1 in ``aligned`` on the aligned rows; with no teacher (the
    ablation) an all-zero teacher and mask of the g3 latent width."""
    m2 = ae.table3_encoder("g2", 1)[-1]
    z_teacher = torch.zeros((len(xa), m2), device=xa.device)
    mask = torch.zeros((len(xa),), device=xa.device)
    if z_teacher_al is not None:
        assert z_teacher_al.shape[1] == m2, \
            "M3 == M2: dimensional consistency (Sec. 4.3)"
        idx = torch.as_tensor(idx_a, device=xa.device)
        z_teacher[idx] = z_teacher_al
        mask[idx] = 1.0
    return {"x": xa, "z_teacher": z_teacher, "aligned": mask}


class StageLog:
    """Per-role epochs, train losses and Adam steps and per-stage wall
    times of one run, as ``RunResult`` carries them."""

    def __init__(self):
        self.epochs, self.losses, self.steps, self.seconds = {}, {}, {}, {}

    def record(self, stage: str, seconds: float, runs: dict) -> None:
        self.seconds[stage] = seconds
        for role, r in runs.items():
            self.epochs[role], self.losses[role] = r.epochs_run, r.train_loss
            self.steps[role] = r.steps_run


def _timed(fn, *args, **kw):
    # the training loop syncs the host at every epoch's end, so timing a
    # stage needs no extra sync
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def run_protocol(scs: Sequence, seeds: Sequence[int], *, k_party: bool,
                 lanes_g3: bool, lam: float, kind: str, use_kernel: bool,
                 ablation: bool, init_params: Optional[Sequence[dict]],
                 train_kw: dict, dev: torch.device) -> List[RunResult]:
    """Steps 1-4 for S seed replicas of equal-shape scenarios, every stage
    one ``train_lanes`` call over all seeds; with ``lanes_g3=False`` (one
    seed) g3 trains through ``training.train`` on ``distill.make_loss``,
    as the sequential entry points do.  ``k_party`` picks the K-party
    names and lane seeds (module docstring) over the 2-party ones
    (``g1_passive``, g2 at ``seed + 2``, g3 at ``seed + 3``, g1 and g2 on
    ``make_masked_recon_loss(use_kernel)``).  ``ablation`` skips steps
    1-2 and trains g3 on an all-zero teacher and mask."""
    S = len(seeds)
    n_p = len(passives(scs[0]))
    if k_party:
        p_roles = [f"g1_passive{j}" for j in range(n_p)]
        what = "step1/Z_passive{}_aligned".format
        g2_seed, g3_seed = 100, 200
        recon = ae.masked_recon_loss
    else:
        p_roles, what = ["g1_passive"], lambda j: "step1/Z_passive_aligned"
        g2_seed, g3_seed = 2, 3
        recon = ae.make_masked_recon_loss(use_kernel)
    roles = ["g3"] if ablation else ["g1_active", *p_roles, "g2", "g3"]
    ini = [inits(sc, s, None if init_params is None else init_params[i],
                 roles, p_roles, dev)
           for i, (sc, s) in enumerate(zip(scs, seeds))]
    aligns = [align_k(sc.active.ids, [p.ids for p in passives(sc)])
              for sc in scs]
    idx_as = [_index_of(sc.active.ids, common)
              for sc, (common, _) in zip(scs, aligns)]
    logs = [StageLog() for _ in range(S)]
    xas = [rows(sc.active.x, dev) for sc in scs]

    with torch.no_grad():
        zts, zps, g1, g2 = [None] * S, [None] * S, None, None
        if not ablation:
            # --- Step 1: S * K g1 lanes (every party of every seed) --------
            xps = [[rows(p.x, dev) for p in passives(sc)] for sc in scs]
            lanes = []
            for xa, xp, s, ii in zip(xas, xps, seeds, ini):
                lanes.append(training.LaneSpec(ii["g1_active"], {"x": xa},
                                               s))
                lanes += [training.LaneSpec(ii[r], {"x": x}, s + j + 1)
                          for j, (r, x) in enumerate(zip(p_roles, xp))]
            g1, sec = _timed(training.train_lanes, lanes, recon, **train_kw)
            K = n_p + 1

            # --- THE exchange per link, then S g2 lanes --------------------
            zjs = []
            for i, (sc, (common, channels)) in enumerate(zip(scs, aligns)):
                ra, r_ps = g1[K * i], g1[K * i + 1:K * (i + 1)]
                logs[i].record("g1", sec, {"g1_active": ra,
                                           **dict(zip(p_roles, r_ps))})
                blocks = [ae.fused_encode(ra.params, xas[i][idx_as[i]])]
                for j, (p, rp, xp, ch) in enumerate(zip(
                        passives(sc), r_ps, xps[i], channels)):
                    zp = ae.fused_encode(rp.params,
                                         xp[_index_of(p.ids, common)])
                    blocks.append(comm.exchange_array(
                        ch, what(j), zp, seed=seeds[i], link=j))
                zps[i] = torch.cat(blocks[1:], dim=1)
                zjs.append(torch.cat(blocks, dim=1))
            g2, sec = _timed(training.train_lanes, [
                training.LaneSpec(ii["g2"], {"x": zj}, s + g2_seed)
                for zj, s, ii in zip(zjs, seeds, ini)], recon, **train_kw)
            for log, r2 in zip(logs, g2):
                log.record("g2", sec, {"g2": r2})
            zts = [ae.fused_encode(r2.params, zj) for r2, zj in zip(g2, zjs)]

        # --- Step 3: g3 distillation ----------------------------------------
        specs = [training.LaneSpec(ii["g3"], g3_data(xa, idx_a, zt),
                                   s + g3_seed)
                 for xa, idx_a, zt, s, ii in zip(xas, idx_as, zts, seeds,
                                                 ini)]
        if lanes_g3:
            g3, sec = _timed(training.train_lanes, specs,
                             distill.make_lanes_loss(lam, kind, use_kernel),
                             **train_kw)
        else:
            (sp,) = specs
            r3, sec = _timed(training.train, sp.params, sp.data,
                             distill.make_loss(lam, kind, use_kernel),
                             seed=sp.seed, **train_kw)
            g3 = [r3]
        z_alls = []
        for log, xa, r3 in zip(logs, xas, g3):
            log.record("g3", sec, {"g3": r3})
            z_alls.append(ae.fused_encode(r3.params, xa))

    # --- Step 4: the k-fold probe of each seed ------------------------------
    metrics = clf.kfold_cv_many(z_alls, [sc.active.y for sc in scs],
                                scs[0].n_classes, seeds=seeds, device=dev)
    results = []
    for i, (s, (common, channels), r3, log) in enumerate(zip(
            seeds, aligns, g3, logs)):
        params, artifacts = {"g3": r3.params}, None
        if not ablation:
            # what the active party holds after training, for serving
            # export: its own encoders plus the passive latents it RECEIVED
            params.update(g1_active=g1[(n_p + 1) * i].params,
                          g2=g2[i].params)
            artifacts = {"aligned_ids": np.asarray(common),
                         "z_passive_aligned": zps[i]}
        results.append(RunResult(
            method="apcvfl", metrics=metrics[i],
            rounds=0 if ablation else comm.APCVFL_ROUNDS, epochs=log.epochs,
            comm=comm.summarize(channels), seed=s,
            z_dim=ae.table3_encoder("g2", 1)[-1], train_loss=log.losses,
            steps=log.steps, seconds=log.seconds, params=params,
            channels=tuple(channels), artifacts=artifacts))
    return results


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
    distillation term).  ``exchange`` transforms are not ported yet and
    raise."""
    refuse_unported("run_apcvfl_k", exchange=exchange)
    (res,) = run_protocol(
        [sc], [int(seed)], k_party=True, lanes_g3=False, lam=lam, kind=kind,
        use_kernel=use_kernel, ablation=ablation,
        init_params=None if init_params is None else [init_params],
        train_kw=dict(batch_size=batch_size, max_epochs=max_epochs,
                      patience=patience, lr=lr, perm_fn=perm_fn),
        dev=resolve_device(device))
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
    tolerance.  ``mesh`` and ``exchange`` are not ported yet and raise."""
    refuse_unported("run_apcvfl_k_replicated", exchange=exchange, mesh=mesh)
    scs, seeds = normalize_replicas("run_apcvfl_k_replicated", scenarios,
                                    seeds)
    if not seeds:
        return []
    return run_protocol(
        scs, seeds, k_party=True, lanes_g3=True, lam=lam, kind=kind,
        use_kernel=use_kernel, ablation=ablation, init_params=init_params,
        train_kw=dict(batch_size=batch_size, max_epochs=max_epochs,
                      patience=patience, lr=lr, perm_fn=perm_fn),
        dev=resolve_device(device))
