"""Attack registry: the adversarial side of the utility-vs-leakage
frontier; the port of ``repro.robustness.attacks``.

Every attack consumes the same ``AttackSurface`` (everything the active
party, or an eavesdropper on the one exchange, observes) and emits the
same ``AttackReport`` schema with a normalized ``leakage`` in [0, 1]
(0 = chance level, 1 = total disclosure):

* ``inversion``: invert the exchanged latents back to private features
  with an n_aux-pair budget (``core.privacy``; the inverter trains on the
  surface's device, through the lane-MLP kernels on the card); leakage =
  clamped mean R^2.
* ``label_leak``: a logistic probe z -> y on n_aux labeled rows of the
  teacher latents (or the raw exchange), fit on the surface's device;
  leakage = (acc - majority) / (1 - majority).
* ``membership``: distinguish aligned from non-aligned passive rows by
  distance to the exchanged latent table (host numpy, as the reference);
  leakage = 2 AUC - 1.

``build_surfaces`` builds one surface per defense the lane way: the g1
encoders train once as 2 lanes, then every defense's g2 teacher trains as
one lane of a single ``train_lanes`` call over the grid.  Inits: one
generator seeded with ``seed`` draws g1_active and g1_passive (the
pipeline's first two draws) and then one g2 per transform, or
``init_params`` gives them as arrays (``{"g1_active", "g1_passive",
"g2": [one per transform]}``); ``perm_fn`` replaces the epoch
permutations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.configs.apcvfl_paper import TABULAR as HP
from repro_torch.core import autoencoder as ae
from repro_torch.core import classifier as clf
from repro_torch.core import comm, privacy, protocol, training
from repro_torch.core.psi import psi
from repro_torch.experiments.results import RunResult
from repro_torch.robustness import defense


# ---------------------------------------------------------------------------
# shared schema
# ---------------------------------------------------------------------------

@dataclass
class AttackReport:
    """One attack's outcome in the shared leakage-metric schema."""
    attack: str
    leakage: float       # normalized [0,1]: 0 = chance / safe, 1 = total
    success: float       # the attack's raw statistic (R^2, accuracy, AUC)
    baseline: float      # that statistic's chance level
    n_aux: int           # attacker's auxiliary budget actually used
    extras: Dict[str, float] = field(default_factory=dict)

    def metrics(self) -> Dict[str, float]:
        out = {"leakage": float(self.leakage),
               "success": float(self.success),
               "baseline": float(self.baseline),
               "n_aux": float(self.n_aux)}
        for k, v in self.extras.items():
            out[k] = float(v)
        return out


@dataclass
class AttackSurface:
    """What the adversary sees after one (possibly defended) run: the
    exchanged latents, the teacher latents distilled from them, the
    passive party's full local latent pool (for membership ground truth),
    and the private targets the attacks try to recover; host arrays.
    ``device`` is where the attacks that train (inversion, label leak)
    run."""
    z_exch: np.ndarray            # (n_al, M) latents as RECEIVED
    x_priv: np.ndarray            # (n_al, D_p) private passive features
    y: np.ndarray                 # (n_al,) active-party labels
    z_pool: np.ndarray            # (n_p, M) clean passive latents, all rows
    member_mask: np.ndarray       # (n_p,) bool: row aligned (exchanged)?
    n_classes: int
    z_teacher: Optional[np.ndarray] = None   # (n_al, M2) g2 latents
    channel: Optional[comm.Channel] = None   # byte-parity with run_apcvfl
    seed: int = 0
    device: str = "cuda"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_ATTACKS: Dict[str, Callable[..., AttackReport]] = {}


def register_attack(name: str):
    def deco(fn):
        if name in _ATTACKS:
            raise ValueError(f"attack {name!r} already registered")
        _ATTACKS[name] = fn
        return fn
    return deco


def available_attacks() -> tuple:
    return tuple(sorted(_ATTACKS))


def get_attack(name: str) -> Callable[..., AttackReport]:
    if name not in _ATTACKS:
        raise KeyError(f"unknown attack {name!r}; available: "
                       f"{', '.join(available_attacks())}")
    return _ATTACKS[name]


def run_attack(name: str, surface: AttackSurface, **kw) -> AttackReport:
    return get_attack(name)(surface, **kw)


# ---------------------------------------------------------------------------
# surface construction (lane-batched across defenses)
# ---------------------------------------------------------------------------

def _surface_inits(sc, n_lanes: int, seed: int, init_params, dev) -> dict:
    if init_params is not None:
        up = lambda t: convert.to_torch(t, device=dev)
        return {"g1_active": up(init_params["g1_active"]),
                "g1_passive": up(init_params["g1_passive"]),
                "g2": [up(t) for t in init_params["g2"]]}
    gen = torch.Generator().manual_seed(seed)
    w = lambda role, d: ae.table3_encoder(role, d)
    out = {"g1_active": ae.init_autoencoder(
               gen, w("g1_active", sc.active.x.shape[1]), device=dev),
           "g1_passive": ae.init_autoencoder(
               gen, w("g1_passive", sc.passive.x.shape[1]), device=dev)}
    d_j = w("g1_active", 1)[-1] + w("g1_passive", 1)[-1]
    out["g2"] = [ae.init_autoencoder(gen, w("g2", d_j), device=dev)
                 for _ in range(n_lanes)]
    return out


def build_surfaces(sc, transforms: Sequence, *, seed: int = 0,
                   include_teacher: bool = True,
                   batch_size: int = HP.batch_size,
                   max_epochs: int = HP.max_epochs,
                   patience: int = HP.patience, lr: float = HP.lr,
                   init_params: Optional[dict] = None,
                   perm_fn: Optional[Callable] = None,
                   device="cuda") -> List[AttackSurface]:
    """One ``AttackSurface`` per exchange transform (``None`` = the
    undefended paper protocol).  The g1 encoders, identical across
    defenses, train once as 2 lanes; each defense then gets its own
    channel (PSI + transformed exchange, byte-parity with ``run_apcvfl``)
    and, with ``include_teacher``, its g2 teacher trains as one lane of a
    single ``train_lanes`` call over the whole defense grid."""
    dev = resolve_device(device)
    xa, xp = np.asarray(sc.active.x), np.asarray(sc.passive.x)
    ini = _surface_inits(sc, len(transforms), seed, init_params, dev)
    train_kw = dict(batch_size=batch_size, max_epochs=max_epochs,
                    patience=patience, lr=lr, perm_fn=perm_fn)
    xa_t, xp_t = protocol.rows(xa, dev), protocol.rows(xp, dev)

    with torch.no_grad():
        ra, rp = training.train_lanes(
            [training.LaneSpec(ini["g1_active"], {"x": xa_t}, seed),
             training.LaneSpec(ini["g1_passive"], {"x": xp_t}, seed + 1)],
            ae.masked_recon_loss, **train_kw)
        z_pool_t = ae.fused_encode(rp.params, xp_t)

        cells = []                   # (channel, idx_a, idx_p, z_received)
        for t in transforms:
            ch = comm.Channel()
            _, idx_a, idx_p = psi(sc.active.ids, sc.passive.ids, channel=ch)
            z_clean = z_pool_t[torch.as_tensor(idx_p, device=dev)]
            z_recv = comm.exchange_array(ch, "step1/Z_passive_aligned",
                                         z_clean, transform=t, seed=seed)
            cells.append((ch, idx_a, idx_p, z_recv))

        teachers: List[Optional[np.ndarray]] = [None] * len(cells)
        if include_teacher and cells:
            zj_lanes = []
            for (_, idx_a, _, z_recv) in cells:
                za_al = ae.fused_encode(
                    ra.params, xa_t[torch.as_tensor(idx_a, device=dev)])
                zj_lanes.append(torch.cat([za_al, z_recv], dim=1))
            g2 = training.train_lanes(
                [training.LaneSpec(g2_init, {"x": zj}, seed + 2)
                 for g2_init, zj in zip(ini["g2"], zj_lanes)],
                ae.masked_recon_loss, **train_kw)
            teachers = [ae.fused_encode(r2.params, zj).cpu().numpy()
                        for r2, zj in zip(g2, zj_lanes)]

    z_pool = z_pool_t.cpu().numpy()
    surfaces = []
    for (ch, idx_a, idx_p, z_recv), z_t in zip(cells, teachers):
        member_mask = np.zeros(len(xp), dtype=bool)
        member_mask[idx_p] = True
        surfaces.append(AttackSurface(
            z_exch=z_recv.cpu().numpy(), x_priv=xp[idx_p],
            y=np.asarray(sc.active.y)[idx_a], z_pool=z_pool,
            member_mask=member_mask, n_classes=sc.n_classes, z_teacher=z_t,
            channel=ch, seed=seed, device=str(dev)))
    return surfaces


def build_surface(sc, transform=None, **kw) -> AttackSurface:
    if kw.get("init_params") is not None:
        kw["init_params"] = {**kw["init_params"],
                             "g2": kw["init_params"]["g2"][:1]}
    (surface,) = build_surfaces(sc, [transform], **kw)
    return surface


# ---------------------------------------------------------------------------
# the attacks
# ---------------------------------------------------------------------------

@register_attack("inversion")
def attack_inversion(surface: AttackSurface, *, n_aux: int = 64,
                     hidden: int = 128, max_epochs: int = 120,
                     seed: int = 0, init_params: Optional[dict] = None,
                     perm_fn: Optional[Callable] = None) -> AttackReport:
    """Representation inversion in the shared schema: train z -> x_hat on
    n_aux paired rows, measure held-out mean R^2.  leakage = R^2 clamped
    to [0, 1].  ``init_params`` is the inverter's init as arrays."""
    eff = privacy.effective_n_aux(n_aux, len(surface.z_exch))
    rep = privacy.inversion_attack(surface.z_exch, surface.x_priv,
                                   n_aux=eff, hidden=hidden,
                                   max_epochs=max_epochs, seed=seed,
                                   init_params=init_params, perm_fn=perm_fn,
                                   device=surface.device)
    leak = float(np.clip(rep.r2_mean, 0.0, 1.0))
    return AttackReport(
        attack="inversion", leakage=leak, success=float(rep.r2_mean),
        baseline=0.0, n_aux=eff,
        extras={"r2_mean": rep.r2_mean, "attack_mse": rep.attack_mse,
                "baseline_mse": rep.baseline_mse,
                "n_aux_requested": float(n_aux)})


@register_attack("label_leak")
def attack_label_leak(surface: AttackSurface, *, n_aux: int = 64,
                      target: str = "teacher", steps: int = 300,
                      seed: int = 0) -> AttackReport:
    """Label leakage against the distillation targets: an adversary who
    observes the teacher latents (``target="teacher"``) or the raw
    exchange (``target="exchange"``) and holds n_aux labeled rows fits a
    logistic probe z -> y; its normalized advantage over the majority
    class on held-out rows is the leakage."""
    if target not in ("teacher", "exchange"):
        raise ValueError(f"label_leak target must be 'teacher' or "
                         f"'exchange', got {target!r}")
    z = (surface.z_teacher if target == "teacher"
         and surface.z_teacher is not None else surface.z_exch)
    y = surface.y
    eff = privacy.effective_n_aux(n_aux, len(z))
    perm = np.random.RandomState(seed).permutation(len(z))
    aux, ev = perm[:eff], perm[eff:]
    dev = resolve_device(surface.device)
    params = clf.fit_logreg(protocol.rows(z[aux], dev), y[aux],
                            surface.n_classes, steps=steps)
    pred = clf.predict(params, z[ev])
    acc = float((pred == y[ev]).mean())
    majority = float(np.bincount(y[ev],
                                 minlength=surface.n_classes).max()
                     / len(ev))
    adv = (acc - majority) / max(1.0 - majority, 1e-9)
    leak = float(np.clip(adv, 0.0, 1.0))
    return AttackReport(
        attack="label_leak", leakage=leak, success=acc, baseline=majority,
        n_aux=eff, extras={"accuracy": acc, "majority": majority,
                           "n_aux_requested": float(n_aux)})


@register_attack("membership")
def attack_membership(surface: AttackSurface, *, sample: int = 256,
                      seed: int = 0) -> AttackReport:
    """Alignment-membership inference: which passive rows are in the
    aligned (exchanged) set?  A candidate row scores the negative distance
    from its clean latent to the nearest exchanged latent; aligned rows
    sit at distance ~0 when the exchange is undefended.  leakage =
    2 AUC - 1 (rank AUC over balanced member/non-member samples)."""
    rng = np.random.RandomState(seed)
    mem_idx = np.nonzero(surface.member_mask)[0]
    non_idx = np.nonzero(~surface.member_mask)[0]
    if len(mem_idx) == 0 or len(non_idx) == 0:
        raise ValueError(
            f"attack_membership needs both aligned and non-aligned "
            f"passive rows (got {len(mem_idx)} aligned, {len(non_idx)} "
            f"non-aligned)")
    k = min(int(sample), len(mem_idx), len(non_idx))
    mem = surface.z_pool[rng.choice(mem_idx, k, replace=False)]
    non = surface.z_pool[rng.choice(non_idx, k, replace=False)]

    def scores(c):
        d = ((c[:, None, :] - surface.z_exch[None, :, :]) ** 2).sum(-1)
        return -np.sqrt(d.min(axis=1))

    s_mem, s_non = scores(mem), scores(non)
    diff = s_mem[:, None] - s_non[None, :]
    auc = float((diff > 0).mean() + 0.5 * (diff == 0).mean())
    leak = float(np.clip(2.0 * auc - 1.0, 0.0, 1.0))
    return AttackReport(
        attack="membership", leakage=leak, success=auc, baseline=0.5,
        n_aux=k, extras={"auc": auc, "n_members": float(len(mem_idx))})


# ---------------------------------------------------------------------------
# spec-runnable wrappers (registered in repro_torch.experiments.methods)
# ---------------------------------------------------------------------------

def _attacked_surface(sc, *, sigma, mechanism, clip, quantize, seed,
                      include_teacher, batch_size, max_epochs, patience,
                      lr, init_params, perm_fn, device) -> AttackSurface:
    t = defense.make_transform(sigma=sigma, mechanism=mechanism, clip=clip,
                               quantize=quantize)
    return build_surface(sc, t, seed=seed, include_teacher=include_teacher,
                         batch_size=batch_size, max_epochs=max_epochs,
                         patience=patience, lr=lr, init_params=init_params,
                         perm_fn=perm_fn, device=device)


def _attack_result(name: str, surface: AttackSurface, rep: AttackReport,
                   *, sigma: float, seed: int) -> RunResult:
    metrics = rep.metrics()
    metrics["dp_sigma"] = float(sigma)
    ch = surface.channel
    return RunResult(method=name, metrics=metrics, rounds=1, epochs={},
                     comm=ch.summary(), seed=seed,
                     z_dim=surface.z_exch.shape[1], channels=(ch,))


def run_attack_inversion(sc, *, sigma: float = 0.0,
                         mechanism: str = "gaussian",
                         clip: Optional[float] = None,
                         quantize: Optional[str] = None, n_aux: int = 64,
                         hidden: int = 128,
                         batch_size: int = HP.batch_size,
                         max_epochs: int = HP.max_epochs,
                         patience: int = HP.patience, lr: float = HP.lr,
                         seed: int = 0, init_params: Optional[dict] = None,
                         perm_fn: Optional[Callable] = None,
                         device="cuda") -> RunResult:
    """``init_params``: the surface's inits plus ``"inverter"``."""
    s = _attacked_surface(sc, sigma=sigma, mechanism=mechanism, clip=clip,
                          quantize=quantize, seed=seed,
                          include_teacher=False, batch_size=batch_size,
                          max_epochs=max_epochs, patience=patience, lr=lr,
                          init_params=init_params, perm_fn=perm_fn,
                          device=device)
    rep = attack_inversion(s, n_aux=n_aux, hidden=hidden,
                           max_epochs=max_epochs, seed=seed,
                           init_params=None if init_params is None
                           else init_params.get("inverter"),
                           perm_fn=perm_fn)
    return _attack_result("attack_inversion", s, rep, sigma=sigma, seed=seed)


def run_attack_label_leak(sc, *, sigma: float = 0.0,
                          mechanism: str = "gaussian",
                          clip: Optional[float] = None,
                          quantize: Optional[str] = None, n_aux: int = 64,
                          target: str = "teacher", steps: int = 300,
                          batch_size: int = HP.batch_size,
                          max_epochs: int = HP.max_epochs,
                          patience: int = HP.patience, lr: float = HP.lr,
                          seed: int = 0, init_params: Optional[dict] = None,
                          perm_fn: Optional[Callable] = None,
                          device="cuda") -> RunResult:
    s = _attacked_surface(sc, sigma=sigma, mechanism=mechanism, clip=clip,
                          quantize=quantize, seed=seed,
                          include_teacher=(target == "teacher"),
                          batch_size=batch_size, max_epochs=max_epochs,
                          patience=patience, lr=lr,
                          init_params=init_params, perm_fn=perm_fn,
                          device=device)
    rep = attack_label_leak(s, n_aux=n_aux, target=target, steps=steps,
                            seed=seed)
    return _attack_result("attack_label_leak", s, rep, sigma=sigma,
                          seed=seed)


def run_attack_membership(sc, *, sigma: float = 0.0,
                          mechanism: str = "gaussian",
                          clip: Optional[float] = None,
                          quantize: Optional[str] = None,
                          sample: int = 256,
                          batch_size: int = HP.batch_size,
                          max_epochs: int = HP.max_epochs,
                          patience: int = HP.patience, lr: float = HP.lr,
                          seed: int = 0, init_params: Optional[dict] = None,
                          perm_fn: Optional[Callable] = None,
                          device="cuda") -> RunResult:
    s = _attacked_surface(sc, sigma=sigma, mechanism=mechanism, clip=clip,
                          quantize=quantize, seed=seed,
                          include_teacher=False, batch_size=batch_size,
                          max_epochs=max_epochs, patience=patience, lr=lr,
                          init_params=init_params, perm_fn=perm_fn,
                          device=device)
    rep = attack_membership(s, sample=sample, seed=seed)
    return _attack_result("attack_membership", s, rep, sigma=sigma,
                          seed=seed)


def leakage_profile(sc, transforms: Sequence, *, seed: int = 0,
                    n_aux: int = 64,
                    batch_size: int = HP.batch_size,
                    max_epochs: int = HP.max_epochs,
                    patience: int = HP.patience, lr: float = HP.lr,
                    device="cuda") -> List[Dict[str, AttackReport]]:
    """Every registered attack against every defense: one dict of
    ``AttackReport`` per transform, surfaces built lane-batched."""
    surfaces = build_surfaces(sc, transforms, seed=seed,
                              include_teacher=True, batch_size=batch_size,
                              max_epochs=max_epochs, patience=patience,
                              lr=lr, device=device)
    return [{"inversion": attack_inversion(s, n_aux=n_aux, seed=seed),
             "label_leak": attack_label_leak(s, n_aux=n_aux, seed=seed),
             "membership": attack_membership(s, seed=seed)}
            for s in surfaces]
