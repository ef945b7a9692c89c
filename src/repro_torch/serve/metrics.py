"""Serving-statistics schema for the port's VFL inference subsystem.

A copy of ``repro.serve.metrics`` (the port imports nothing of the JAX
package), key for key, so the port's stream stats and the reference's are
comparable field by field.  Latency is reported as two per-request series:

* **queueing latency** — how long a request sat in a queue (or backlog)
  before its micro-batch began executing, and
* **service latency** — the wall-clock of the micro-batch dispatch that
  completed it.

``series_summary`` is the percentile block every JSON artifact embeds;
``ServeStats`` is the per-engine accumulator.  (``slo_report`` and the
per-tenant summary come with the live runtime.)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

#: percentiles every latency block reports
SERIES_PERCENTILES = (50, 90, 99)


def series_summary(values_ms: List[float]) -> dict:
    """The shared percentile block: count, mean, max and p50/p90/p99 of a
    latency series in milliseconds (all zeros for an empty series)."""
    if not values_ms:
        return {"count": 0, "mean": 0.0, "max": 0.0,
                **{f"p{q}": 0.0 for q in SERIES_PERCENTILES}}
    arr = np.asarray(values_ms, dtype=np.float32)
    out = {"count": int(arr.size),
           "mean": round(float(arr.mean()), 3),
           "max": round(float(arr.max()), 3)}
    for q in SERIES_PERCENTILES:
        out[f"p{q}"] = round(float(np.percentile(arr, q)), 3)
    return out


@dataclass
class ServeStats:
    """Per-engine accumulator.  ``queue_ms``/``service_ms`` are parallel
    per-request series appended together by ``serve_stream``."""
    requests: int = 0
    rows: int = 0
    dispatches: Dict[str, int] = field(default_factory=dict)
    padded_rows: int = 0                 # rows of bucket padding dispatched
    queue_ms: List[float] = field(default_factory=list)
    service_ms: List[float] = field(default_factory=list)

    def record(self, queue_ms: float, service_ms: float) -> None:
        self.queue_ms.append(float(queue_ms))
        self.service_ms.append(float(service_ms))

    def e2e_ms(self) -> List[float]:
        """Per-request end-to-end latency (queue + service); requires the
        two series to be appended pairwise, as ``serve_stream`` does."""
        if len(self.queue_ms) != len(self.service_ms):
            raise ValueError(
                f"queue/service series diverged "
                f"({len(self.queue_ms)} vs {len(self.service_ms)}) — "
                f"record() them pairwise")
        return [q + s for q, s in zip(self.queue_ms, self.service_ms)]

    def percentile_ms(self, q: float) -> float:
        """Service-latency percentile."""
        return float(np.percentile(self.service_ms, q)) \
            if self.service_ms else 0.0

    def latency_summary(self) -> dict:
        """The shared latency block: queueing and service as SEPARATE
        percentile series plus their pairwise sum."""
        return {"queue": series_summary(self.queue_ms),
                "service": series_summary(self.service_ms),
                "end_to_end": series_summary(self.e2e_ms())}
