"""Representation-inversion attack: an empirical check of the paper's
privacy argument (Sec. 4.5); the port of ``repro.core.privacy``.

The paper argues sharing Z = g(X) is safe because g stays local.  That
holds against a blind attacker, but an honest-but-curious active party
with AUXILIARY (x, z) pairs can train an inversion network z -> x_hat.
This module measures that leakage: inversion R^2 on held-out aligned
rows as a function of the auxiliary-pair budget.

The inverter is the 2-layer MLP ``[z_dim, hidden, d_x]`` with no final
activation, trained through ``training.train``; its forward is
``autoencoder.fused_mlp_apply``, so on the card every step runs the
lane-MLP kernels (forward and closed-form backward).  Its init is drawn
from a generator seeded with ``seed`` or taken from ``init_params`` as
arrays; ``perm_fn`` replaces the epoch permutations.  Splits and R^2 are
host numpy, as in the reference.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.configs.apcvfl_paper import TABULAR as HP
from repro_torch.core import autoencoder as ae
from repro_torch.core import comm, protocol, training
from repro_torch.core.psi import psi
from repro_torch.experiments.results import RunResult


@dataclass
class InversionReport:
    n_aux: int
    r2_per_feature: np.ndarray
    r2_mean: float
    baseline_mse: float       # variance of the target (predict-the-mean)
    attack_mse: float


def _inv_loss(params, batch):
    x_hat = ae.fused_mlp_apply(params, batch["z"], final_act=False)
    return torch.mean(torch.square(batch["x"] - x_hat))


def inversion_attack(z, x, *, n_aux: int, hidden: int = 128,
                     max_epochs: int = 120, seed: int = 0,
                     init_params: Optional[dict] = None,
                     perm_fn: Optional[Callable] = None,
                     device="cuda") -> InversionReport:
    """z: (n, M) shared representations (array or tensor); x: (n, D)
    private features the attacker wants back (host array).  ``n_aux`` rows
    are the attacker's paired auxiliary data; the rest measure leakage.
    Trains on ``device``."""
    dev = resolve_device(device)
    z = protocol.rows(z, dev) if not isinstance(z, torch.Tensor) \
        else z.to(dev, torch.float32)
    x = np.asarray(x, np.float32)
    perm = np.random.RandomState(seed).permutation(len(z))
    aux, test = perm[:n_aux], perm[n_aux:]
    widths = [int(z.shape[1]), hidden, x.shape[1]]
    inv = (ae.init_mlp(torch.Generator().manual_seed(seed), widths,
                       device=dev)
           if init_params is None
           else convert.to_torch(init_params, device=dev))
    take = lambda idx: torch.as_tensor(idx, device=dev)
    res = training.train(inv, {"z": z[take(aux)],
                               "x": protocol.rows(x[aux], dev)},
                         _inv_loss, batch_size=min(64, max(n_aux // 4, 2)),
                         max_epochs=max_epochs, seed=seed, perm_fn=perm_fn)
    with torch.no_grad():
        x_hat = ae.fused_mlp_apply(res.params, z[take(test)],
                                   final_act=False).cpu().numpy()
    err = x[test] - x_hat
    var = x[test].var(axis=0) + 1e-12
    r2 = 1.0 - err.var(axis=0) / var
    return InversionReport(
        n_aux=n_aux, r2_per_feature=r2, r2_mean=float(r2.mean()),
        baseline_mse=float(var.mean()), attack_mse=float((err ** 2).mean()))


def effective_n_aux(n_aux: int, n_rows: int) -> int:
    """The auxiliary budget an attack can actually use on ``n_rows``
    shared latents: at least 2 training pairs must exist and at least 20
    held-out rows must remain to measure leakage on.  A clamp warns, and
    callers record both requested and effective values."""
    eff = max(min(int(n_aux), n_rows - 20), 2)
    if eff != n_aux:
        warnings.warn(
            f"inversion n_aux={n_aux} clamped to {eff}: only {n_rows} "
            f"aligned latents are shared and 20 held-out rows are "
            f"reserved for measurement (records carry n_aux_requested "
            f"alongside the effective n_aux)", RuntimeWarning,
            stacklevel=3)
    return eff


def leakage_curve(z, x, budgets=(10, 50, 200, 1000), seed: int = 0,
                  device="cuda") -> list:
    out = []
    for n_aux in budgets:
        if n_aux >= len(z) - 20:
            continue
        out.append(inversion_attack(z, x, n_aux=n_aux, seed=seed,
                                    device=device))
    return out


def run_inversion(sc, *, n_aux: int = 64, hidden: int = 128,
                  batch_size: int = HP.batch_size,
                  max_epochs: int = HP.max_epochs,
                  patience: int = HP.patience, lr: float = HP.lr,
                  seed: int = 0, init_params: Optional[dict] = None,
                  perm_fn: Optional[Callable] = None,
                  device="cuda") -> RunResult:
    """The attack as a spec-runnable method, on the protocol's attack
    surface: the passive party trains g1 on its FULL dataset (step 1) but
    shares only the ALIGNED rows' latents (the PSI + ``Z_passive_aligned``
    exchange ``run_apcvfl`` accounts); the active party inverts them with
    an ``n_aux``-pair budget.  ``metrics`` carries the leakage numbers
    (``r2_mean``: 0 = the paper's safe regime, 1 = full reconstruction);
    an infeasible ``n_aux`` is clamped by ``effective_n_aux``, which warns.
    g1_passive draws ``run_apcvfl``'s init at ``seed`` (or takes
    ``init_params["g1_passive"]``); the inverter takes
    ``init_params["inverter"]`` when given."""
    dev = resolve_device(device)
    xp = np.asarray(sc.passive.x)
    channel = comm.Channel()
    _, _, idx_p = psi(sc.active.ids, sc.passive.ids, channel=channel)
    init = protocol.inits(sc, seed, init_params, ["g1_passive"],
                          ["g1_passive"], dev)["g1_passive"]
    with torch.no_grad():
        r1 = training.train(init, {"x": protocol.rows(xp, dev)},
                            ae.recon_loss, batch_size=batch_size,
                            max_epochs=max_epochs, patience=patience, lr=lr,
                            seed=seed + 1, perm_fn=perm_fn)
    x_al = xp[idx_p]
    if len(x_al) < 22:        # >= 2 aux pairs AND >= 20 held-out rows
        raise ValueError(
            f"run_inversion: {len(x_al)} aligned rows is too few to "
            f"measure leakage (need >= 22: 2 auxiliary pairs + 20 "
            f"held-out rows)")
    with torch.no_grad():
        z = ae.fused_encode(r1.params, protocol.rows(x_al, dev))
    channel.send_array("step1/Z_passive_aligned", z, direction="uplink")
    eff_n_aux = effective_n_aux(n_aux, len(z))
    rep = inversion_attack(
        z, x_al, n_aux=eff_n_aux, hidden=hidden, max_epochs=max_epochs,
        seed=seed, perm_fn=perm_fn, device=dev,
        init_params=None if init_params is None
        else init_params.get("inverter"))
    metrics = {"r2_mean": rep.r2_mean, "attack_mse": rep.attack_mse,
               "baseline_mse": rep.baseline_mse,
               "n_aux": float(rep.n_aux),
               "n_aux_requested": float(n_aux),
               "n_aux_clamped": float(rep.n_aux != n_aux)}
    return RunResult(method="inversion", metrics=metrics, rounds=1,
                     epochs={"g1_passive": r1.epochs_run},
                     comm=channel.summary(), seed=seed,
                     z_dim=int(z.shape[1]), channels=(channel,),
                     train_loss={"g1_passive": r1.train_loss})
