"""APC-VFL: the four-step protocol (paper Fig. 3) and the aligned-only
adaptation (paper Fig. 4): the port of ``repro.core.pipeline``.

Step 1  local representation learning   (every participant, autoencoder)
        -> passive sends Z_p[aligned] to active: THE single exchange.
Step 2  aligned representation learning (active, autoencoder g2 on
        concat(Z_a, Z_p) of aligned rows)
Step 3  knowledge distillation          (active, student AE g3 on the FULL
        active dataset, Eq. 5 masked loss)
Step 4  classifier on Z = g3(X_active), labels from the active party.

Every stage trains on ``core.training``: the two g1 autoencoders as two
lanes of one ``train_lanes`` call (two shape groups), g2 as a singleton
lane, g3 through ``train``.  ``use_kernel=True`` trains every
autoencoder through the lane-MLP kernels and g3's Eq. 5 loss through the
distill kernels; on a CUDA device the autoencoders run through the
lane-MLP kernels either way.  Stage handoffs stay on the device; the
channel accounting reads only shapes and dtypes.

Initial params come from one ``torch.Generator`` seeded with ``seed``
(g1_active, g1_passive, g2, g3, in that order), or, for parity with the
reference, from ``init_params`` as arrays; ``perm_fn`` likewise replaces
the epoch permutations (``training.default_perm``).

Hyperparameter defaults come from ``configs.apcvfl_paper.TABULAR``.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.configs.apcvfl_paper import TABULAR as HP
from repro_torch.core import autoencoder as ae
from repro_torch.core import classifier as clf
from repro_torch.core import comm
from repro_torch.core import distill
from repro_torch.core import training
from repro_torch.core.psi import psi
from repro_torch.data.vertical import VFLScenario
from repro_torch.experiments.results import RunResult

ROLES = ("g1_active", "g1_passive", "g2", "g3")


def _inits(sc: VFLScenario, roles, seed: int, init_params, dev) -> dict:
    """Each role's autoencoder init: the given arrays, or draws from one
    generator in the order of ``roles``."""
    if init_params is not None:
        return {r: convert.to_torch(init_params[r], device=dev)
                for r in roles}
    d_a, d_p = sc.active.x.shape[1], sc.passive.x.shape[1]
    d_j = (ae.table3_encoder("g1_active", d_a)[-1]
           + ae.table3_encoder("g1_passive", d_p)[-1])
    widths = {"g1_active": ae.table3_encoder("g1_active", d_a),
              "g1_passive": ae.table3_encoder("g1_passive", d_p),
              "g2": ae.table3_encoder("g2", d_j),
              "g3": ae.table3_encoder("g3", d_a)}
    gen = torch.Generator().manual_seed(seed)
    return {r: ae.init_autoencoder(gen, widths[r], device=dev)
            for r in roles}


def _rows(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def run_apcvfl(sc: VFLScenario, *, lam: float = HP.lam, kind: str = HP.kind,
               seed: int = 0, batch_size: int = HP.batch_size,
               max_epochs: int = HP.max_epochs, patience: int = HP.patience,
               lr: float = HP.lr, use_kernel: bool = False, exchange=None,
               init_params: Optional[dict] = None,
               perm_fn: Optional[Callable] = None,
               device="cuda") -> RunResult:
    """Full protocol on ``device``.  ``exchange`` transforms (DP noise,
    quantization) are not ported yet and raise.  The result's ``steps``
    holds each role's Adam steps and ``seconds`` each stage's wall time
    (the training loop syncs the host at every epoch's end, so timing a
    stage needs no extra sync)."""
    if exchange is not None:
        raise NotImplementedError(
            "run_apcvfl(exchange=...): exchange transforms are not ported "
            "yet (they land with the port's robustness slice)")
    dev = resolve_device(device)
    inits = _inits(sc, ROLES, seed, init_params, dev)
    channel = comm.Channel()
    epochs, losses, steps, seconds = {}, {}, {}, {}
    train_kw = dict(batch_size=batch_size, max_epochs=max_epochs,
                    patience=patience, lr=lr, perm_fn=perm_fn)

    def record(stage, t0, **runs):
        seconds[stage] = time.perf_counter() - t0
        for role, r in runs.items():
            epochs[role], losses[role] = r.epochs_run, r.train_loss
            steps[role] = r.steps_run

    # --- PSI on IDs (assumed precondition in the paper; bytes logged) ------
    aligned_ids, idx_a, idx_p = psi(sc.active.ids, sc.passive.ids,
                                    channel=channel)
    xa, xp = _rows(sc.active.x, dev), _rows(sc.passive.x, dev)
    recon = ae.make_masked_recon_loss(use_kernel)

    with torch.no_grad():
        # --- Step 1: local representation learning -------------------------
        t0 = time.perf_counter()
        ra, rp = training.train_lanes(
            [training.LaneSpec(inits["g1_active"], {"x": xa}, seed),
             training.LaneSpec(inits["g1_passive"], {"x": xp}, seed + 1)],
            recon, **train_kw)
        record("g1", t0, g1_active=ra, g1_passive=rp)
        za_al = ae.fused_encode(ra.params, xa[idx_a])
        zp_al = ae.fused_encode(rp.params, xp[idx_p])
        # THE single information exchange: passive -> active, aligned
        # latents (byte accounting reads only shape/dtype)
        zp_al = comm.exchange_array(channel, "step1/Z_passive_aligned",
                                    zp_al, seed=seed)

        # --- Step 2: aligned (joint) representation learning ---------------
        zj = torch.cat([za_al, zp_al], dim=1)
        t0 = time.perf_counter()
        (r2,) = training.train_lanes(
            [training.LaneSpec(inits["g2"], {"x": zj}, seed + 2)], recon,
            **train_kw)
        record("g2", t0, g2=r2)
        z_teacher_al = ae.fused_encode(r2.params, zj)
        m2 = z_teacher_al.shape[1]

        # --- Step 3: knowledge distillation into g3 --------------------------
        n_a = len(xa)
        rows = torch.as_tensor(idx_a, device=dev)
        z_teacher = torch.zeros((n_a, m2), device=dev)
        z_teacher[rows] = z_teacher_al
        mask = torch.zeros((n_a,), device=dev)
        mask[rows] = 1.0
        assert ae.table3_encoder("g3", xa.shape[1])[-1] == m2, \
            "M3 == M2: dimensional consistency (Sec. 4.3)"
        loss3 = distill.make_loss(lam=lam, kind=kind, use_kernel=use_kernel)
        t0 = time.perf_counter()
        r3 = training.train(inits["g3"], {"x": xa, "z_teacher": z_teacher,
                                          "aligned": mask}, loss3,
                            seed=seed + 3, **train_kw)
        record("g3", t0, g3=r3)

        # --- Step 4: classifier on the enhanced dataset ----------------------
        z_all = ae.fused_encode(r3.params, xa)
    metrics = clf.kfold_cv(z_all, sc.active.y, sc.n_classes, seed=seed,
                           device=dev)

    # what the active party holds after training, for serving export: its
    # own encoders plus the passive latents it RECEIVED
    return RunResult(method="apcvfl", metrics=metrics,
                     rounds=comm.APCVFL_ROUNDS, epochs=epochs,
                     comm=channel.summary(), seed=seed, z_dim=m2,
                     train_loss=losses, steps=steps, seconds=seconds,
                     params={"g3": r3.params, "g1_active": ra.params,
                             "g2": r2.params},
                     channels=(channel,),
                     artifacts={"aligned_ids": np.asarray(aligned_ids),
                                "z_passive_aligned": zp_al})


def run_local_baseline(sc, seed: int = 0, *, device="cuda") -> dict:
    """Paper 'Local': probe on raw active features; the bare metrics
    dict."""
    return clf.kfold_cv(sc.active.x, sc.active.y, sc.n_classes, seed=seed,
                        device=device)


def run_apcvfl_aligned_only(sc: VFLScenario, *, seed: int = 0,
                            batch_size: int = HP.batch_size,
                            max_epochs: int = HP.max_epochs,
                            patience: int = HP.patience, lr: float = HP.lr,
                            test_size: int = HP.test_size,
                            init_params: Optional[dict] = None,
                            perm_fn: Optional[Callable] = None,
                            device="cuda") -> RunResult:
    """Classical fully-aligned setting: the classifier trains directly on
    the joint latents g2(concat(Z_a, Z_p)) of the aligned rows; no
    distillation (no unaligned rows exist to distill into)."""
    dev = resolve_device(device)
    inits = _inits(sc, ROLES[:3], seed, init_params, dev)
    channel = comm.Channel()
    train_kw = dict(batch_size=batch_size, max_epochs=max_epochs,
                    patience=patience, lr=lr, perm_fn=perm_fn)
    _, idx_a, idx_p = psi(sc.active.ids, sc.passive.ids, channel=channel)
    xa, xp = _rows(sc.active.x[idx_a], dev), _rows(sc.passive.x[idx_p], dev)
    y = np.asarray(sc.active.y[idx_a])

    with torch.no_grad():
        ra, rp = training.train_lanes(
            [training.LaneSpec(inits["g1_active"], {"x": xa}, seed),
             training.LaneSpec(inits["g1_passive"], {"x": xp}, seed + 1)],
            ae.masked_recon_loss, **train_kw)
        za, zp = ae.fused_encode(ra.params, xa), ae.fused_encode(rp.params,
                                                                 xp)
        channel.send_array("step1/Z_passive_aligned", zp, direction="uplink")
        zj = torch.cat([za, zp], dim=1)
        (r2,) = training.train_lanes(
            [training.LaneSpec(inits["g2"], {"x": zj}, seed + 2)],
            ae.masked_recon_loss, **train_kw)
        z = ae.fused_encode(r2.params, zj)

    # train/test split as in the SplitNN comparison (test_size held out)
    perm = np.random.RandomState(seed).permutation(len(z))
    te, tr = perm[:test_size], perm[test_size:]
    head = clf.fit_logreg(z[torch.as_tensor(tr, device=dev)], y[tr],
                          sc.n_classes)
    pred = clf.predict(head, z[torch.as_tensor(te, device=dev)].cpu())
    metrics = clf.f1_scores(y[te], pred, sc.n_classes)
    return RunResult(method="apcvfl_aligned_only", metrics=metrics, rounds=1,
                     epochs={"g1_active": ra.epochs_run,
                             "g1_passive": rp.epochs_run,
                             "g2": r2.epochs_run},
                     comm=channel.summary(), seed=seed, z_dim=z.shape[1],
                     train_loss={"g1_active": ra.train_loss,
                                 "g1_passive": rp.train_loss,
                                 "g2": r2.train_loss},
                     params={"g2": r2.params}, channels=(channel,))
