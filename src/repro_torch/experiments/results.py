"""The unified experiment result type: the port of
``repro.experiments.results``.

Every method returns one ``RunResult``: metrics from the shared
evaluation, the measured communication summary (``comm.Channel.summary()``
shape), per-stage epoch counts and train-loss histories, and (optionally)
trained params and the live per-link channels for in-process inspection.
``to_record()`` flattens a result into one tidy row, key for key the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core import comm


@dataclass
class RunResult:
    """Uniform outcome of one (method, scenario, seed) run.

    ``comm`` is a JSON-ready dict in the ``Channel.summary()`` shape;
    ``rounds`` is the protocol's round count.  ``train_loss`` holds each
    stage's per-epoch train losses (the reference keeps them only inside
    its ``TrainResult``s); ``steps`` holds each role's Adam steps and
    ``seconds`` each stage's wall time, where the runner records them
    (``run_apcvfl``: stages ``g1``, ``g2``, ``g3``).  ``channels``,
    ``params`` and ``artifacts`` are live objects for in-process use and are excluded from ``to_record()``;
    ``artifacts`` carries what the active party holds after training and
    needs for online serving (aligned row ids, the received passive
    latents), consumed by ``repro_torch.serve.vfl.export_bundle``."""
    method: str
    metrics: Dict[str, float]
    rounds: int
    epochs: Dict[str, int] = field(default_factory=dict)
    comm: Dict = field(default_factory=dict)
    seed: int = 0
    scenario: Dict = field(default_factory=dict)
    z_dim: Optional[int] = None
    train_loss: Dict[str, list] = field(default_factory=dict, repr=False)
    steps: Dict[str, int] = field(default_factory=dict, repr=False)
    seconds: Dict[str, float] = field(default_factory=dict, repr=False)
    params: Optional[dict] = field(default=None, repr=False)
    channels: Tuple[comm.Channel, ...] = field(default=(), repr=False)
    artifacts: Optional[dict] = field(default=None, repr=False)

    @property
    def channel(self) -> Optional[comm.Channel]:
        """The single link of a 2-party run (None for local baselines)."""
        return self.channels[0] if self.channels else None

    def to_record(self) -> dict:
        """One flat, JSON-ready row: scenario coordinates, metrics, and
        communication totals (per-stage detail stays in ``self.comm``)."""
        rec = {"method": self.method, "seed": self.seed}
        rec.update(self.scenario)
        rec.update(self.metrics)
        rec.update({
            "rounds": self.rounds,
            "comm_total_bytes": self.comm.get("total_bytes", 0),
            "comm_uplink_bytes": self.comm.get("uplink_bytes", 0),
            "comm_downlink_bytes": self.comm.get("downlink_bytes", 0),
            "comm_mb": self.comm.get("total_mb", 0.0),
            "epochs_total": int(sum(self.epochs.values())),
            "z_dim": self.z_dim,
        })
        return rec
