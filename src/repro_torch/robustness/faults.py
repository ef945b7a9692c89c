"""Seeded fault plans: operational failures of the passive party; the
port of ``repro.robustness.faults``.

APC-VFL's one-shot exchange makes the passive party a single point of
failure.  At training time the exchange itself degrades: the passive
party drops out before sending (``dropout``: the protocol's active-only
ablation), sends latents from an OLD checkpoint (``stale``: ``epochs``
deep into training instead of converged), or its features have drifted
since alignment (``drift``: latent-space noise scaled to the latents'
RMS).  ``run_faulted_apcvfl`` maps a plan's ``stage="exchange"`` events
onto the pipeline's ``exchange=`` hook (or ``ablation=True``), so a
faulted run IS a normal run with a different transform: the same engine,
the same accounting.

A ``FaultPlan`` is a seeded, JSON-round-trippable value
(``examples/faults/*.json``) and carries serving-time events too
(``t_ms``, a tenant): ``serve.runtime.ServingRuntime.run(faults=)``
applies them at dispatch boundaries (``dropout``/``stale``/``drift``
invalidate the tenant's representation cache, ``recover`` refreshes it
with a version bump), and ``launch.serve_vfl --arrival poisson|bursty
--fault PLAN.json`` runs a plan from the command line.

Drift noise is drawn as ``robustness.defense`` draws its noise: on the
host from a CPU generator keyed by ``(seed, DRIFT_SALT, link)``, then
moved to the latents' device; ``draw=`` takes the reference's noise for
parity.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.apcvfl_paper import TABULAR as HP
from repro_torch.core import autoencoder as ae
from repro_torch.core import comm, pipeline, protocol, training
from repro_torch.core.psi import psi
from repro_torch.experiments.results import RunResult
from repro_torch.robustness import defense

FAULT_KINDS = ("dropout", "stale", "drift", "recover")
TRAIN_STAGES = ("exchange",)

# domain separator for drift noise (distinct from defense.EXCHANGE_SALT:
# a drifted AND defended exchange must not reuse noise)
DRIFT_SALT = 0xD217


@dataclass(frozen=True)
class FaultEvent:
    """One failure: serving-time when ``t_ms`` is set (virtual clock),
    training-time when ``stage`` is set.  ``tenant`` routes serving
    events; ``epochs`` parameterizes ``stale`` (how far the stale
    checkpoint got); ``drift`` the drift magnitude (fraction of latent
    RMS)."""
    kind: str
    t_ms: Optional[float] = None
    stage: Optional[str] = None
    tenant: Optional[str] = None
    epochs: Optional[int] = None
    drift: Optional[float] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if (self.t_ms is None) == (self.stage is None):
            raise ValueError(
                f"FaultEvent({self.kind!r}) needs exactly one trigger: "
                f"t_ms (serving) or stage (training)")
        if self.stage is not None and self.stage not in TRAIN_STAGES:
            raise ValueError(f"fault stage must be one of {TRAIN_STAGES}, "
                             f"got {self.stage!r}")
        if self.stage is not None and self.kind == "recover":
            raise ValueError("recover is a serving-time event (t_ms); the "
                             "one-shot exchange has nothing to recover to")

    def to_dict(self) -> dict:
        out = {"kind": self.kind}
        for k in ("t_ms", "stage", "tenant", "epochs", "drift"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        allowed = {"kind", "t_ms", "stage", "tenant", "epochs", "drift"}
        unknown = set(d) - allowed
        if unknown:
            raise ValueError(f"FaultEvent: unknown keys {sorted(unknown)}")
        if "kind" not in d:
            raise ValueError("FaultEvent: missing 'kind'")
        return cls(**d)


@dataclass(frozen=True)
class FaultPlan:
    """A named, seeded sequence of fault events (JSON round-trippable)."""
    name: str
    seed: int = 0
    events: Tuple[FaultEvent, ...] = ()

    def serving_events(self) -> List[FaultEvent]:
        return sorted((e for e in self.events if e.t_ms is not None),
                      key=lambda e: e.t_ms)

    def training_events(self) -> List[FaultEvent]:
        return [e for e in self.events if e.stage is not None]

    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        unknown = set(d) - {"name", "seed", "events"}
        if unknown:
            raise ValueError(f"FaultPlan: unknown keys {sorted(unknown)}")
        return cls(name=d.get("name", "plan"), seed=int(d.get("seed", 0)),
                   events=tuple(FaultEvent.from_dict(e)
                                for e in d.get("events", [])))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# training-time injection: faults as exchange transforms
# ---------------------------------------------------------------------------

class StaleExchange:
    """The passive party sends latents from an OLD checkpoint: the wire
    carries ``z_stale`` (same shape, same fp32 bytes) instead of the
    converged latents the protocol expects."""

    def __init__(self, z_stale):
        self.z_stale = defense.as_f32(z_stale)

    def exchange(self, channel: comm.Channel, what: str, z, *,
                 seed: int = 0, link: int = 0,
                 direction: str = comm.UPLINK):
        if tuple(self.z_stale.shape) != tuple(z.shape):
            raise ValueError(
                f"StaleExchange: stale latents {tuple(self.z_stale.shape)} "
                f"do not match the live exchange {tuple(z.shape)}")
        z_stale = self.z_stale.to(z.device)
        channel.send_array(what, z_stale, direction=direction)
        return z_stale


class DriftExchange:
    """Feature drift since alignment, modeled in latent space: the sent
    latents are perturbed by seeded Gaussian noise at ``magnitude`` times
    their RMS (deterministic per run seed and passive link).
    ``draw(key, shape)`` replaces the host draw of unit noise."""

    def __init__(self, magnitude: float = 0.5,
                 draw: Optional[Callable] = None):
        if magnitude < 0:
            raise ValueError(f"drift magnitude must be >= 0, "
                             f"got {magnitude}")
        self.magnitude = float(magnitude)
        self.draw = draw or defense.normal_noise

    def exchange(self, channel: comm.Channel, what: str, z, *,
                 seed: int = 0, link: int = 0,
                 direction: str = comm.UPLINK):
        z = z.to(torch.float32)
        noise = defense.as_f32(self.draw((int(seed), DRIFT_SALT, int(link)),
                                         tuple(z.shape)))
        rms = torch.sqrt(torch.mean(torch.square(z)) + 1e-12)
        zd = z + self.magnitude * rms * noise.to(z.device)
        channel.send_array(what, zd, direction=direction)
        return zd


def _stale_passive_latents(sc, *, epochs: int, seed: int,
                           batch_size: int, lr: float,
                           init_params: Optional[dict] = None,
                           perm_fn: Optional[Callable] = None,
                           device="cuda") -> torch.Tensor:
    """Latents of the aligned rows from a short-run (``epochs``) twin of
    the passive g1: the same init and lane seed as the pipeline's
    g1_passive (its draw at ``seed``, or ``init_params["g1_passive"]``),
    stopped early: an honest 'old checkpoint'."""
    dev = resolve_device(device)
    init = protocol.inits(sc, seed, init_params, ["g1_passive"],
                          ["g1_passive"], dev)["g1_passive"]
    xp = protocol.rows(sc.passive.x, dev)
    with torch.no_grad():
        r = training.train(init, {"x": xp}, ae.recon_loss,
                           batch_size=batch_size, max_epochs=epochs,
                           patience=epochs, lr=lr, seed=seed + 1,
                           perm_fn=perm_fn)
        _, _, idx_p = psi(sc.active.ids, sc.passive.ids)
        return ae.fused_encode(r.params,
                               xp[torch.as_tensor(idx_p, device=dev)])


def run_faulted_apcvfl(sc, plan: FaultPlan, *, lam: float = HP.lam,
                       kind: str = HP.kind, seed: int = 0,
                       batch_size: int = HP.batch_size,
                       max_epochs: int = HP.max_epochs,
                       patience: int = HP.patience, lr: float = HP.lr,
                       use_kernel: bool = False,
                       init_params: Optional[dict] = None,
                       perm_fn: Optional[Callable] = None,
                       draw: Optional[Callable] = None,
                       device="cuda") -> RunResult:
    """The full protocol under the plan's training-time (``stage=
    "exchange"``) events.  Severity order when a plan stacks kinds:
    ``dropout`` (no exchange happens: the run IS the active-only
    ablation) > ``stale`` > ``drift``.  Metrics carry ``fault_*`` flags.
    ``init_params`` is ``run_apcvfl``'s (the stale twin takes its
    g1_passive); ``draw`` goes to ``DriftExchange``."""
    events = plan.training_events()
    flags = {"fault_dropout": 0.0, "fault_stale": 0.0, "fault_drift": 0.0}
    kw = dict(seed=seed, lam=lam, kind=kind, batch_size=batch_size,
              max_epochs=max_epochs, patience=patience, lr=lr,
              use_kernel=use_kernel, init_params=init_params,
              perm_fn=perm_fn, device=device)
    transform = None
    if any(e.kind == "dropout" for e in events):
        flags["fault_dropout"] = 1.0
        res = pipeline.run_apcvfl(sc, ablation=True, **kw)
    else:
        stale = [e for e in events if e.kind == "stale"]
        drift = [e for e in events if e.kind == "drift"]
        if stale:
            flags["fault_stale"] = 1.0
            transform = StaleExchange(_stale_passive_latents(
                sc, epochs=int(stale[0].epochs or 1), seed=seed,
                batch_size=batch_size, lr=lr, init_params=init_params,
                perm_fn=perm_fn, device=device))
        elif drift:
            flags["fault_drift"] = 1.0
            transform = DriftExchange(float(drift[0].drift
                                            if drift[0].drift is not None
                                            else 0.5), draw=draw)
        res = pipeline.run_apcvfl(sc, exchange=transform, **kw)
    res.method = "apcvfl_faulted"
    res.metrics = dict(res.metrics)
    res.metrics.update(flags)
    return res
