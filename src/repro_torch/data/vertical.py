"""Vertical partitioner: split a tabular dataset between an active and a
passive participant, with a controlled number of aligned samples
(paper Sec. 5 "Data partitions").  A copy of ``repro.data.vertical``:
the same numpy RNG stream, so the split is identical to the reference's."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.synthetic import TabularDataset


@dataclass
class ParticipantData:
    x: np.ndarray
    ids: np.ndarray
    y: np.ndarray | None = None      # only the active party holds labels


@dataclass
class VFLScenario:
    name: str
    active: ParticipantData
    passive: ParticipantData
    n_aligned: int
    n_classes: int
    active_feature_idx: np.ndarray
    passive_feature_idx: np.ndarray


def make_scenario(ds: TabularDataset, *, n_active_features: int,
                  n_aligned: int, seed: int = 0,
                  active_rows: int | None = None) -> VFLScenario:
    """Active gets ``n_active_features`` columns and all labels; passive the
    remaining columns. Exactly ``n_aligned`` row IDs are common to both;
    remaining rows are split disjointly (realistic partial overlap)."""
    rng = np.random.RandomState(seed + 1000)
    d = ds.x.shape[1]
    cols = rng.permutation(d)
    a_cols = np.sort(cols[:n_active_features])
    p_cols = np.sort(cols[n_active_features:])

    n = len(ds.x)
    perm = rng.permutation(n)
    aligned = perm[:n_aligned]
    rest = perm[n_aligned:]
    # split the rest between the two parties (unaligned rows each side)
    half = len(rest) // 2
    a_only, p_only = rest[:half], rest[half:]
    if active_rows is not None:        # e.g. BCW: active holds 500 rows
        extra = max(active_rows - n_aligned - len(a_only), 0)
        a_rows = np.concatenate([aligned, a_only])[:active_rows + extra]
    else:
        a_rows = np.concatenate([aligned, a_only])
    p_rows = np.concatenate([aligned, p_only])

    active = ParticipantData(x=ds.x[a_rows][:, a_cols], ids=ds.ids[a_rows],
                             y=ds.y[a_rows])
    passive = ParticipantData(x=ds.x[p_rows][:, p_cols], ids=ds.ids[p_rows])
    return VFLScenario(ds.name, active, passive, n_aligned, ds.n_classes,
                       a_cols, p_cols)
