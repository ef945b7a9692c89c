"""Communication accounting: a simulated peer-to-peer channel that records
every transfer, plus the paper's analytic footprint formulas (Appendix E).
The port of ``repro.core.comm``.

Every transfer carries a *direction* and a *stage* so a channel can report
per-direction (uplink/downlink) and per-stage byte totals.  ``uplink``
flows toward the aggregating side (the active participant), ``downlink``
away from it.  ``Channel.summary()`` returns a JSON-ready dict of the
measured totals, key for key the reference's; ``summarize`` merges the
links of a K-party run into one summary.

All analytic formulas assume 4-byte floats, as in the paper.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from math import ceil
from typing import Iterable, List, NamedTuple

import numpy as np
import torch

UPLINK = "uplink"        # toward the active participant / server
DOWNLINK = "downlink"    # away from the active participant / server


class Transfer(NamedTuple):
    what: str
    nbytes: int
    direction: str
    stage: str
    dtype: str = "float32"


@dataclass
class Channel:
    """Byte- and round-accounting for a logical link between two parties."""
    log: List[Transfer] = field(default_factory=list)

    def send(self, what: str, nbytes: int, *, direction: str = UPLINK,
             stage: str | None = None, dtype: str = "float32"):
        """Record one transfer.  ``stage`` defaults to the prefix of
        ``what`` before the first ``/`` (e.g. ``"step1/Z"`` -> ``step1``);
        ``dtype`` labels the wire element type (``"sign1"`` for 1-bit sign
        payloads) so quantized exchanges stay auditable per dtype."""
        if stage is None:
            stage = what.split("/", 1)[0]
        self.log.append(Transfer(what, int(nbytes), direction, stage, dtype))

    def send_array(self, what: str, arr, *, direction: str = UPLINK,
                   stage: str | None = None):
        # the wire size AND dtype of the array, read from its shape and
        # dtype only (a tensor on the card is not synchronized for this)
        if isinstance(arr, torch.Tensor):
            nbytes = arr.numel() * arr.element_size()
            dtype = str(arr.dtype).removeprefix("torch.")
        else:
            arr = np.asarray(arr)
            nbytes, dtype = arr.size * arr.dtype.itemsize, str(arr.dtype)
        self.send(what, nbytes, direction=direction, stage=stage,
                  dtype=dtype)

    @property
    def total_bytes(self) -> int:
        return sum(t.nbytes for t in self.log)

    @property
    def rounds(self) -> int:
        return len(self.log)

    def total_mb(self) -> float:
        return self.total_bytes / 1e6

    def bytes_by_direction(self) -> dict:
        out = {UPLINK: 0, DOWNLINK: 0}
        for t in self.log:
            out[t.direction] = out.get(t.direction, 0) + t.nbytes
        return out

    def bytes_by_stage(self) -> dict:
        out: dict = {}
        for t in self.log:
            out[t.stage] = out.get(t.stage, 0) + t.nbytes
        return out

    def bytes_by_dtype(self) -> dict:
        out: dict = {}
        for t in self.log:
            out[t.dtype] = out.get(t.dtype, 0) + t.nbytes
        return out

    def summary(self) -> dict:
        """JSON-ready measured totals for this link."""
        by_dir = self.bytes_by_direction()
        return {
            "total_bytes": self.total_bytes,
            "total_mb": self.total_mb(),
            "transfers": self.rounds,
            "uplink_bytes": by_dir.get(UPLINK, 0),
            "downlink_bytes": by_dir.get(DOWNLINK, 0),
            "by_stage": self.bytes_by_stage(),
            "by_dtype": self.bytes_by_dtype(),
        }


def exchange_array(channel: Channel, what: str, z, *, transform=None,
                   seed: int = 0, link: int = 0, direction: str = UPLINK):
    """THE one-shot latent exchange, with an optional hardening hook.

    ``transform=None`` is the paper's plain fp32 send: the array is
    byte-accounted as-is and the receiver gets exactly what the sender
    encoded.  A ``transform`` (an ``ExchangeTransform`` from
    ``repro_torch.robustness.defense`` or a training-time fault from
    ``robustness.faults``: anything with an ``exchange`` method) instead
    perturbs or quantizes the payload at the sender, accounts the
    TRANSFORMED wire bytes (per dtype), and returns the fp32 array the
    receiver reconstructs, on ``z``'s device; the active party must only
    ever consume this return value.  ``seed``/``link`` key the
    transform's randomness per run and per passive link."""
    if transform is None:
        channel.send_array(what, z, direction=direction)
        return z
    return transform.exchange(channel, what, z, seed=seed, link=link,
                              direction=direction)


def normalize_exchange(transform, n: int) -> list:
    """Replica contract for the ``*_replicated`` entry points: one
    transform shared by every replica, or exactly one per replica
    (entries may be ``None``: a mixed-defense lane grid).  Anything else
    is refused here, before any training runs."""
    if transform is None or hasattr(transform, "exchange"):
        return [transform] * n
    try:
        out = list(transform)
    except TypeError:
        raise TypeError(f"exchange: {transform!r} is neither a transform "
                        f"(an object with an 'exchange' method) nor a "
                        f"sequence of them") from None
    if len(out) != n:
        raise ValueError(f"normalize_exchange: {len(out)} exchange "
                         f"transforms for {n} replicas")
    bad = [t for t in out if t is not None and not hasattr(t, "exchange")]
    if bad:
        raise TypeError(f"exchange: {bad[0]!r} is not a transform (an "
                        f"object with an 'exchange' method)")
    return out


def summarize(channels: Iterable[Channel]) -> dict:
    """Aggregate several per-link channels into one ``summary()``-shaped
    dict (bytes and transfer counts sum; stages merge)."""
    total = Channel()
    for ch in channels:
        total.log.extend(ch.log)
    return total.summary()


# --- Appendix E.1: APC-VFL -------------------------------------------------

def apcvfl_footprint_bytes(n_aligned: int, z_p: int = 256) -> int:
    """Eq. 6: one exchange of Z_A in R^{|D_A| x z_p}."""
    return n_aligned * z_p * 4


# --- Appendix E.2: SplitNN -------------------------------------------------

def splitnn_forward_bytes(epochs: int, n_aligned: int, z_p: int = 256) -> int:
    """Eq. 7."""
    return epochs * n_aligned * z_p * 4


def splitnn_backprop_bytes(epochs: int, n_aligned: int, batch_size: int,
                           p_params: int = 128 * 256 + 256) -> int:
    """Eq. 8: gradients w.r.t. the final passive-encoder layer, per batch."""
    return epochs * ceil(n_aligned / batch_size) * p_params * 4


def splitnn_footprint_bytes(epochs: int, n_aligned: int, batch_size: int,
                            z_p: int = 256,
                            p_params: int = 128 * 256 + 256) -> int:
    """Eq. 9."""
    return (splitnn_forward_bytes(epochs, n_aligned, z_p)
            + splitnn_backprop_bytes(epochs, n_aligned, batch_size, p_params))


def splitnn_rounds(epochs: int, n_aligned: int, batch_size: int) -> int:
    """Table 2: 2x the number of backprop events (one up, one down)."""
    return 2 * epochs * ceil(n_aligned / batch_size)


# --- Appendix E: VFedTrans (FedSVD) ----------------------------------------

def vfedtrans_footprint_bytes(n_aligned: int, x_t: int, x_d: int) -> int:
    """Eq. 10: 2|D_A|^2 + x_t*x_tot + x_d*x_tot + |D_A|x_t + |D_A|x_d +
    |D_A|x_tot elements, 5 exchanges, 4 bytes each."""
    x_tot = x_t + x_d
    elems = (2 * n_aligned ** 2 + x_t * x_tot + x_d * x_tot
             + n_aligned * x_t + n_aligned * x_d + n_aligned * x_tot)
    return elems * 4


VFEDTRANS_ROUNDS = 5   # trusted keygen (x2), uploads (x2), U download
APCVFL_ROUNDS = 1
