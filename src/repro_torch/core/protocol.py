"""The APC-VFL protocol's four steps, for any number of passive parties and
any number of seed replicas: the one implementation in the port, of which
``core.pipeline`` (one passive party) and ``core.multiparty`` (K - 1
passives) are thin entry points.

Step 1  local representation learning   (every participant, autoencoder)
        -> each passive sends Z_p[aligned] to the active party: THE single
        exchange, one round per link.
Step 2  aligned representation learning (active, g2 on the concat of the
        K latent blocks of the aligned rows)
Step 3  knowledge distillation          (active, g3 on the FULL active
        dataset, Eq. 5 masked loss)
Step 4  the k-fold logistic probe on Z = g3(X_active).

Alignment is the row intersection across ALL parties as K - 1 genuine
pairwise PSIs (``align_k``), each link charged for the active party's
FULL hashed-ID upload.  Every stage is lanes of ``training.train_lanes``:
S seeds' g1s as S * K lanes (the passives of equal shape in one group),
g2 as S lanes, and g3 as S lanes on ``distill.make_lanes_loss`` or, for
one sequential run, through ``training.train`` on ``distill.make_loss``.

The exchange takes an optional transform per seed (``comm.exchange_array``:
DP noise, quantization, a training-time fault): everything downstream of
it (g2, g3, the serving artifacts) consumes the RECEIVED latents, and the
channel accounts the transformed wire bytes.  The transform's randomness
is keyed by the run's seed and the passive link, never by lane position,
so a replicated lane receives its sequential run's latents.

Initial params come from one ``torch.Generator`` seeded with the run's
seed, drawn for g1_active, each passive's g1, g2 and g3 in that order
(whichever roles a run trains), or from ``init_params`` as arrays keyed by
role (``inits``).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import autoencoder as ae
from repro_torch.core import classifier as clf
from repro_torch.core import comm
from repro_torch.core import distill
from repro_torch.core import training
from repro_torch.core.psi import id_positions, psi
from repro_torch.experiments.results import RunResult


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


def index_of(ids: np.ndarray, subset: np.ndarray) -> np.ndarray:
    pos = id_positions(ids)
    return np.asarray([pos[int(s)] for s in subset], dtype=np.int64)


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
                 train_kw: dict, dev: torch.device,
                 exchange=None, mesh=None) -> List[RunResult]:
    """Steps 1-4 for S seed replicas of equal-shape scenarios, every stage
    one ``train_lanes`` call over all seeds; with ``lanes_g3=False`` (one
    seed) g3 trains through ``training.train`` on ``distill.make_loss``,
    as the sequential entry points do.  ``k_party`` picks the K-party
    names and lane seeds (``g1_passive{j}``, passive j at ``seed + j + 1``,
    g2 at ``seed + 100``, g3 at ``seed + 200``, g1 and g2 on
    ``masked_recon_loss``) over the 2-party ones (``g1_passive``, g2 at
    ``seed + 2``, g3 at ``seed + 3``, g1 and g2 on
    ``make_masked_recon_loss(use_kernel)``).  ``exchange`` is one
    transform shared by every seed or one per seed
    (``comm.normalize_exchange``); each passive link j of seed s exchanges
    under ``(seed=s, link=j)``.  ``ablation`` skips steps 1-2 and trains
    g3 on an all-zero teacher and mask."""
    S = len(seeds)
    if mesh is not None:
        training.check_lane_mesh(mesh)
    lanes_kw = dict(train_kw, mesh=mesh)
    exchanges = comm.normalize_exchange(exchange, S)
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
    idx_as = [index_of(sc.active.ids, common)
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
            g1, sec = _timed(training.train_lanes, lanes, recon, **lanes_kw)
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
                                         xp[index_of(p.ids, common)])
                    blocks.append(comm.exchange_array(
                        ch, what(j), zp, transform=exchanges[i],
                        seed=seeds[i], link=j))
                zps[i] = torch.cat(blocks[1:], dim=1)
                zjs.append(torch.cat(blocks, dim=1))
            g2, sec = _timed(training.train_lanes, [
                training.LaneSpec(ii["g2"], {"x": zj}, s + g2_seed)
                for zj, s, ii in zip(zjs, seeds, ini)], recon, **lanes_kw)
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
                             **lanes_kw)
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
