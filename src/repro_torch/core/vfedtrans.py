"""VFedTrans baseline (Huang et al., WWW'23): FedSVD federated
representations of the aligned rows + representation distillation into a
local feature extractor, then classification on the enriched dataset.
The port of ``repro.core.vfedtrans``.

Key structural contrast with APC-VFL (paper Sec. 6.1): the federated
representation dimension is FIXED at x_total by FedSVD (the "embedding
dimension constraint"); communication includes the dense n x n mask A
(footprint grows ~ |D_A|^2, Eq. 10) and a third-party server is required.

FedSVD runs on the host (``core.fedsvd``, the reference's numpy stream);
the extractor ``[d_a, 256, x_total]`` trains on ``device``.  On a CUDA
batch its encoder and decoder run through the lane-MLP kernels, as the
autoencoder losses do; the loss terms stay plain PyTorch, as the
reference computes them.  Initial params come from a ``torch.Generator``
seeded with ``seed`` or from ``init_params`` as arrays; ``perm_fn``
replaces the epoch permutations.  The result's ``artifacts`` holds the
active party's copy of the federated factors (``U``, ``S``).
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
from repro_torch.core import fedsvd
from repro_torch.core import training
from repro_torch.core.psi import psi
from repro_torch.data.vertical import VFLScenario
from repro_torch.experiments.results import RunResult


def _distill_loss(params: dict, batch: dict) -> torch.Tensor:
    """Huang et al. representation distillation: recon + MAE to the
    federated representation on aligned rows."""
    x, z_t, mask = batch["x"], batch["z_teacher"], batch["aligned"]
    # the card has no path but the kernels for the extractor's two MLPs
    mlp = ae.fused_mlp_apply if x.is_cuda else ae.mlp_apply
    z = mlp(params["enc"], x)
    x_hat = mlp(params["dec"], z)
    rec = torch.mean(torch.square(x - x_hat), dim=-1)
    dis = torch.mean(torch.abs(z - z_t), dim=-1)
    return torch.mean(rec + dis * mask)


def run_vfedtrans(sc: VFLScenario, *, seed: int = 0,
                  batch_size: int = HP.batch_size,
                  max_epochs: int = HP.max_epochs,
                  patience: int = HP.patience, lr: float = HP.lr,
                  init_params: Optional[dict] = None,
                  perm_fn: Optional[Callable] = None,
                  device="cuda") -> RunResult:
    """FedSVD, the distilled extractor on ``device``, then the k-fold
    probe on ``[X_local, g(X_local)]``.  ``train_loss``, ``steps`` and
    ``seconds`` carry the one training stage, ``distill``."""
    dev = resolve_device(device)
    channel = comm.Channel()
    _, idx_a, idx_p = psi(sc.active.ids, sc.passive.ids, channel=channel)
    xa_al = sc.active.x[idx_a]
    xp_al = sc.passive.x[idx_p]

    # --- federated representation learning (FedSVD, 5 exchanges) ----------
    fs = fedsvd.fedsvd(xa_al, xp_al, seed=seed, channel=channel)
    rep = fs.U * fs.S[None, :]               # U Sigma: the federated data
    rep_dim = rep.shape[1]                   # = x_total (the constraint)

    # --- knowledge transfer: local extractor distilled to the fed reps ----
    n_a = len(sc.active.x)
    z_teacher = np.zeros((n_a, rep_dim), np.float32)
    mask = np.zeros((n_a,), np.float32)
    z_teacher[idx_a] = rep
    mask[idx_a] = 1.0
    if init_params is not None:
        params = convert.to_torch(init_params, device=dev)
    else:
        params = ae.init_autoencoder(
            torch.Generator().manual_seed(seed),
            [sc.active.x.shape[1], 256, rep_dim], device=dev)
    x = torch.as_tensor(np.asarray(sc.active.x, np.float32), device=dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        res = training.train(params, {"x": x, "z_teacher": z_teacher,
                                      "aligned": mask}, _distill_loss,
                             batch_size=batch_size, max_epochs=max_epochs,
                             patience=patience, lr=lr, seed=seed,
                             perm_fn=perm_fn)
        seconds = time.perf_counter() - t0
        # --- enriched dataset: [X_local, transferred reps] -----------------
        enriched = torch.cat([x, ae.fused_encode(res.params, x)], dim=1)
    metrics = clf.kfold_cv(enriched, sc.active.y, sc.n_classes, seed=seed,
                           device=dev)
    return RunResult(method="vfedtrans", metrics=metrics, rounds=fs.rounds,
                     epochs={"distill": res.epochs_run},
                     comm=channel.summary(), seed=seed, z_dim=rep_dim,
                     train_loss={"distill": res.train_loss},
                     steps={"distill": res.steps_run},
                     seconds={"distill": seconds},
                     params={"extractor": res.params}, channels=(channel,),
                     artifacts={"U": fs.U, "S": fs.S})
