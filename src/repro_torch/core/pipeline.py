"""APC-VFL: the four-step protocol (paper Fig. 3) and the aligned-only
adaptation (paper Fig. 4): the port of ``repro.core.pipeline``.

Step 1  local representation learning   (every participant, autoencoder)
        -> passive sends Z_p[aligned] to active: THE single exchange.
Step 2  aligned representation learning (active, autoencoder g2 on
        concat(Z_a, Z_p) of aligned rows)
Step 3  knowledge distillation          (active, student AE g3 on the FULL
        active dataset, Eq. 5 masked loss)
Step 4  classifier on Z = g3(X_active), labels from the active party.

The four steps are ``core.protocol.run_protocol``, of which the
2-party protocol is the case of one passive party.  Every stage trains on
``core.training``: the two g1 autoencoders as two lanes of one
``train_lanes`` call (two shape groups), g2 as a singleton lane, g3
through ``train``.  ``use_kernel=True`` trains every
autoencoder through the lane-MLP kernels and g3's Eq. 5 loss through the
distill kernels; on a CUDA device the autoencoders run through the
lane-MLP kernels either way.  Stage handoffs stay on the device; the
channel accounting reads only shapes and dtypes.  ``ablation=True``
skips steps 1-2 and trains g3 without the distillation term (the paper's
"Ablation" curves).  ``exchange`` hardens the single latent exchange
(``repro_torch.robustness.defense``: DP noise, quantization): g2, g3 and
the serving artifacts consume the RECEIVED latents.

``run_apcvfl_replicated`` runs S seed replicates through every stage
together: the g1s of all seeds as 2S lanes of one ``train_lanes`` call
(two shape groups of S), g2 and g3 as S lanes each, g3 on
``distill.make_lanes_loss`` (on the card with ``use_kernel``, the Eq. 5
rows kernel under autograd); each lane draws the inits and the lane
seeds of ``run_apcvfl`` at its seed, so it matches the sequential run.
``run_apcvfl_aligned_only_replicated`` does the same for the aligned-only
adaptation.  ``train_encoder_with_probe`` is Appendix F's Algorithm 1:
an encoder's per-epoch k-fold probe.

Initial params come from one ``torch.Generator`` seeded with ``seed``
(g1_active, g1_passive, g2, g3, in that order, all four drawn whichever
roles a run trains), or, for parity with the reference, from
``init_params`` as arrays; ``perm_fn`` likewise replaces the epoch
permutations (``training.default_perm``).

Hyperparameter defaults come from ``configs.apcvfl_paper.TABULAR``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.configs.apcvfl_paper import TABULAR as HP
from repro_torch.core import autoencoder as ae
from repro_torch.core import classifier as clf
from repro_torch.core import comm
from repro_torch.core import protocol
from repro_torch.core import training
from repro_torch.core.psi import psi
from repro_torch.data.vertical import VFLScenario
from repro_torch.experiments.results import RunResult

ROLES = ("g1_active", "g1_passive", "g2", "g3")


def run_apcvfl(sc: VFLScenario, *, lam: float = HP.lam, kind: str = HP.kind,
               seed: int = 0, batch_size: int = HP.batch_size,
               max_epochs: int = HP.max_epochs, patience: int = HP.patience,
               lr: float = HP.lr, use_kernel: bool = False,
               ablation: bool = False, exchange=None,
               init_params: Optional[dict] = None,
               perm_fn: Optional[Callable] = None,
               device="cuda") -> RunResult:
    """Full protocol on ``device``.  ``ablation=True`` trains g3 WITHOUT
    the distillation term (the paper's 'Ablation' curves: an all-zero
    teacher and mask, no exchange, ``rounds == 0``, params of g3 only, no
    artifacts).  ``exchange`` is an ``ExchangeTransform``
    (``repro_torch.robustness.defense``) applied at the sender; ``None`` is
    the paper's plain fp32 exchange.  The result's ``steps`` holds each
    role's Adam steps and ``seconds`` each stage's wall time."""
    (res,) = protocol.run_protocol(
        [sc], [int(seed)], k_party=False, lanes_g3=False, lam=lam,
        kind=kind, use_kernel=use_kernel, ablation=ablation,
        init_params=None if init_params is None else [init_params],
        train_kw=dict(batch_size=batch_size, max_epochs=max_epochs,
                      patience=patience, lr=lr, perm_fn=perm_fn),
        dev=resolve_device(device), exchange=exchange)
    return res


def run_apcvfl_replicated(scenarios, *, seeds, lam: float = HP.lam,
                          kind: str = HP.kind,
                          batch_size: int = HP.batch_size,
                          max_epochs: int = HP.max_epochs,
                          patience: int = HP.patience, lr: float = HP.lr,
                          use_kernel: bool = False, ablation: bool = False,
                          exchange=None, mesh=None,
                          init_params: Optional[Sequence[dict]] = None,
                          perm_fn: Optional[Callable] = None,
                          device="cuda") -> list:
    """Full protocol for S seed replicates, every stage one
    ``training.train_lanes`` call: the two g1s of all seeds as 2S lanes,
    g2 as S lanes, g3 as S lanes on ``distill.make_lanes_loss``.

    ``scenarios`` is one ``VFLScenario`` shared by every seed or one
    equal-shape scenario per seed.  Returns one ``RunResult`` per seed,
    each matching ``run_apcvfl(scenarios[i], seed=seeds[i], ...)`` within
    float tolerance: each lane draws that run's inits (or takes
    ``init_params[i]``) and its lane seeds.  ``exchange`` is one transform
    shared by every replica (each replica's noise keyed by its seed, so a
    lane receives its sequential run's latents) or one per replica,
    entries may be None (a defense grid as lanes, ``defense.dp_frontier``).
    ``mesh`` (``launch.mesh.make_lane_mesh``) splits every stage's lanes
    over its ranks (``training.train_lanes``)."""
    scs, seeds = protocol.normalize_replicas("run_apcvfl_replicated",
                                             scenarios, seeds)
    if not seeds:
        return []
    return protocol.run_protocol(
        scs, seeds, k_party=False, lanes_g3=True, lam=lam, kind=kind,
        use_kernel=use_kernel, ablation=ablation, init_params=init_params,
        train_kw=dict(batch_size=batch_size, max_epochs=max_epochs,
                      patience=patience, lr=lr, perm_fn=perm_fn),
        dev=resolve_device(device), exchange=exchange, mesh=mesh)


def run_local_baseline(sc, seed: int = 0, *, device="cuda") -> dict:
    """Paper 'Local': probe on raw active features; the bare metrics
    dict."""
    return clf.kfold_cv(sc.active.x, sc.active.y, sc.n_classes, seed=seed,
                        device=device)


def _aligned_only_metrics(z: torch.Tensor, y: np.ndarray, n_classes: int,
                          seed: int, test_size: int) -> dict:
    """The aligned-only probe: a ``test_size`` hold-out split as in the
    SplitNN comparison, one logistic head on the rest."""
    perm = np.random.RandomState(seed).permutation(len(z))
    te, tr = perm[:test_size], perm[test_size:]
    head = clf.fit_logreg(z[torch.as_tensor(tr, device=z.device)], y[tr],
                          n_classes)
    pred = clf.predict(head, z[torch.as_tensor(te, device=z.device)].cpu())
    return clf.f1_scores(y[te], pred, n_classes)


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
    (res,) = run_apcvfl_aligned_only_replicated(
        sc, seeds=[seed], batch_size=batch_size, max_epochs=max_epochs,
        patience=patience, lr=lr, test_size=test_size,
        init_params=None if init_params is None else [init_params],
        perm_fn=perm_fn, device=device)
    return res


def run_apcvfl_aligned_only_replicated(
        scenarios, *, seeds, batch_size: int = HP.batch_size,
        max_epochs: int = HP.max_epochs, patience: int = HP.patience,
        lr: float = HP.lr, test_size: int = HP.test_size, mesh=None,
        init_params: Optional[Sequence[dict]] = None,
        perm_fn: Optional[Callable] = None, device="cuda") -> list:
    """S seed replicates of the aligned-only adaptation, every stage one
    ``train_lanes`` call (2S g1 lanes, S g2 lanes); the same contract as
    ``run_apcvfl_replicated``.  With one seed this is
    ``run_apcvfl_aligned_only``: the reference runs its g1s and its g2 as
    lanes there too.  ``mesh`` splits every stage's lanes over its
    ranks."""
    if mesh is not None:
        training.check_lane_mesh(mesh)
    scs, seeds = protocol.normalize_replicas(
        "run_apcvfl_aligned_only_replicated", scenarios, seeds)
    if not seeds:
        return []
    dev = resolve_device(device)
    inits = [protocol.inits(sc, s, None if init_params is None
                      else init_params[i], ROLES[:3], ROLES[1:2], dev)
             for i, (sc, s) in enumerate(zip(scs, seeds))]
    train_kw = dict(batch_size=batch_size, max_epochs=max_epochs,
                    patience=patience, lr=lr, perm_fn=perm_fn, mesh=mesh)
    channels = [comm.Channel() for _ in seeds]
    cells = []                        # (xa, xp, y) aligned rows per seed
    for sc, ch in zip(scs, channels):
        _, idx_a, idx_p = psi(sc.active.ids, sc.passive.ids, channel=ch)
        cells.append((protocol.rows(sc.active.x[idx_a], dev),
                      protocol.rows(sc.passive.x[idx_p], dev),
                      np.asarray(sc.active.y[idx_a])))

    with torch.no_grad():
        lanes = []
        for (xa, xp, _), s, ini in zip(cells, seeds, inits):
            lanes += [training.LaneSpec(ini["g1_active"], {"x": xa}, s),
                      training.LaneSpec(ini["g1_passive"], {"x": xp}, s + 1)]
        g1 = training.train_lanes(lanes, ae.masked_recon_loss, **train_kw)
        zjs = []
        for i, ((xa, xp, _), ch) in enumerate(zip(cells, channels)):
            za = ae.fused_encode(g1[2 * i].params, xa)
            zp = ae.fused_encode(g1[2 * i + 1].params, xp)
            ch.send_array("step1/Z_passive_aligned", zp, direction="uplink")
            zjs.append(torch.cat([za, zp], dim=1))
        g2 = training.train_lanes(
            [training.LaneSpec(ini["g2"], {"x": zj}, s + 2)
             for zj, s, ini in zip(zjs, seeds, inits)],
            ae.masked_recon_loss, **train_kw)
        zs = [ae.fused_encode(r2.params, zj) for r2, zj in zip(g2, zjs)]

    results = []
    for i, (sc, s, ch, z, (_, _, y)) in enumerate(zip(scs, seeds, channels,
                                                      zs, cells)):
        ra, rp, r2 = g1[2 * i], g1[2 * i + 1], g2[i]
        results.append(RunResult(
            method="apcvfl_aligned_only",
            metrics=_aligned_only_metrics(z, y, sc.n_classes, s, test_size),
            rounds=1, epochs={"g1_active": ra.epochs_run,
                              "g1_passive": rp.epochs_run,
                              "g2": r2.epochs_run},
            comm=ch.summary(), seed=s, z_dim=int(z.shape[1]),
            train_loss={"g1_active": ra.train_loss,
                        "g1_passive": rp.train_loss, "g2": r2.train_loss},
            params={"g2": r2.params}, channels=(ch,)))
    return results


# ---------------------------------------------------------------------------
# Appendix F, Algorithm 1: encoder training with representation-quality probe
# ---------------------------------------------------------------------------

def train_encoder_with_probe(x: np.ndarray, y: np.ndarray, n_classes: int,
                             widths: list, *, metric: str = "accuracy",
                             k: int = 5, max_epochs: int = 30,
                             seed: int = 0,
                             init_params: Optional[dict] = None,
                             perm_fn: Optional[Callable] = None,
                             device="cuda") -> dict:
    """Runs Algorithm 1 on ``device``: per epoch, the k-fold CV probe on
    Z = g(X).  Returns the loss curve, per-epoch metric sets M~, the raw-X
    metric set M, and the equivalence gap (Eq. 12).  The autoencoder's
    init is drawn from a generator seeded with ``seed`` or taken from
    ``init_params`` as arrays; ``perm_fn`` replaces the epoch
    permutations."""
    dev = resolve_device(device)
    params = (ae.init_autoencoder(torch.Generator().manual_seed(seed),
                                  widths, device=dev)
              if init_params is None
              else convert.to_torch(init_params, device=dev))
    xt = protocol.rows(x, dev)
    history = {"loss": [], "probe": []}

    def cb(epoch, p, tl, vl):
        with torch.no_grad():
            z = ae.fused_encode(p, xt)
        m = clf.kfold_cv(z, y, n_classes, k=k, seed=seed, device=dev)
        history["probe"].append(m[metric])
        history["loss"].append(tl)

    training.train(params, {"x": xt}, ae.recon_loss, max_epochs=max_epochs,
                   patience=max_epochs, seed=seed, perm_fn=perm_fn,
                   epoch_callback=cb)
    base = clf.kfold_cv(xt, y, n_classes, k=k, seed=seed,
                        device=dev)[metric]
    gap = base - (history["probe"][-1] if history["probe"] else 0.0)
    return {"history": history, "metric_raw_x": base, "gap": gap}
