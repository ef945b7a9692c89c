"""Private set intersection (simulated): salted-hash PSI over ID spaces.

The paper assumes participants run PSI on IDs before training (Sec. 3).
We simulate the ECDH/salted-hash protocol faithfully at the *interface*
level: each party only learns the intersection, and the channel accounting
charges one hashed-ID exchange per party.  A copy of ``repro.core.psi``."""
from __future__ import annotations

import hashlib

import numpy as np


def _hash_ids(ids: np.ndarray, salt: bytes) -> dict:
    hashed = {hashlib.sha256(salt + int(i).to_bytes(8, "little")).digest():
              int(i) for i in ids}
    if len(hashed) != len(ids):
        # a dict would silently keep one entry per duplicate, corrupting the
        # idx_a/idx_b alignment downstream — fail loudly instead
        raise ValueError(f"PSI requires unique IDs: got {len(ids)} ids, "
                         f"{len(hashed)} distinct")
    return hashed


def id_positions(ids: np.ndarray) -> dict:
    """Position map ``{id: row}`` for an id vector — the one id -> row
    lookup every alignment/cache consumer shares (ids are unique per
    party; ``_hash_ids`` enforces that at alignment time)."""
    return {int(v): i for i, v in enumerate(np.asarray(ids))}


def psi(ids_a: np.ndarray, ids_b: np.ndarray, *, salt: bytes = b"psi",
        channel=None):
    """Returns (aligned_ids sorted, idx_a, idx_b) such that
    ids_a[idx_a] == ids_b[idx_b] == aligned_ids."""
    ha = _hash_ids(ids_a, salt)
    hb = _hash_ids(ids_b, salt)
    if channel is not None:
        # a = active party by convention: its hashes flow OUT (downlink),
        # the peer's reply flows back toward it (uplink)
        channel.send("psi/hashes_a", len(ids_a) * 32, direction="downlink")
        channel.send("psi/hashes_b", len(ids_b) * 32, direction="uplink")
    common = sorted(ha[h] for h in (set(ha) & set(hb)))
    common = np.asarray(common, dtype=np.int64)
    pos_a = id_positions(ids_a)
    pos_b = id_positions(ids_b)
    idx_a = np.asarray([pos_a[int(c)] for c in common], dtype=np.int64)
    idx_b = np.asarray([pos_b[int(c)] for c in common], dtype=np.int64)
    return common, idx_a, idx_b
