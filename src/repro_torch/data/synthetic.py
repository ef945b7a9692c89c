"""Synthetic stand-ins for the paper's three datasets (MIMIC-III is
access-gated).  A copy of ``repro.data.synthetic``: the same numpy RNG
stream, so the port's datasets and request pools are identical to the
reference's.

A shared latent factor model generates features so that (a) both parties'
features carry label signal, (b) cross-party features are correlated (the
federation has something to transfer), (c) shapes/class counts match the
paper exactly:

  mimic3: 20000 rows x 15 features, 4 classes (paper reduces 58976 -> 20000)
  bcw:      569 rows x 30 features, 2 classes
  credit: 20000 rows x 23 features, 2 classes (paper reduces 30000 -> 20000)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TabularDataset:
    name: str
    x: np.ndarray          # (n, d) float32, standardized
    y: np.ndarray          # (n,) int64
    n_classes: int
    ids: np.ndarray        # (n,) int64 record IDs


SPECS = {
    "mimic3": dict(n=20000, d=15, n_classes=4, latent=6, noise=0.7),
    "bcw": dict(n=569, d=30, n_classes=2, latent=5, noise=0.4),
    "credit": dict(n=20000, d=23, n_classes=2, latent=6, noise=0.9),
}


def make_dataset(name: str, seed: int = 0) -> TabularDataset:
    spec = SPECS[name]
    rng = np.random.RandomState(seed)
    n, d, C, r = spec["n"], spec["d"], spec["n_classes"], spec["latent"]
    z = rng.randn(n, r)
    # class logits: linear + QUADRATIC latent terms.  The quadratic part is
    # invisible to a linear probe on (monotone) raw features but recoverable
    # by a nonlinear encoder — the regime where representation learning (and
    # the paper's distillation toward the joint representation) pays off.
    wy = rng.randn(r, C) * 1.0
    wy2 = rng.randn(r, C) * 1.2
    wyx = rng.randn(r, C) * 0.8
    zsq = z * z - 1.0
    zint = z * np.roll(z, 1, axis=1)
    logits = z @ wy + zsq @ wy2 + zint @ wyx + rng.randn(n, C) * 0.5
    y = np.argmax(logits, axis=1)
    # features: each column is a saturating NONLINEAR view of (mostly) ONE
    # latent factor + noise.  Few features => few observed latents => a
    # party with fewer columns genuinely has less label information (the
    # paper's "limited features" setting), and a linear probe on raw
    # features is suboptimal; an encoder distilled toward the feature-rich
    # joint representation can denoise/invert the nonlinearity (Sec. 4.3).
    x = np.empty((n, d))
    for j in range(d):
        lj = j % r
        lo = (j * 5 + 1) % r
        v = 1.3 * z[:, lj] + 0.25 * z[:, lo]
        x[:, j] = np.tanh(v + 0.3 * rng.randn())   # monotone nonlinear view
    x = x + rng.randn(n, d) * spec["noise"] * 0.6
    x = (x - x.mean(0)) / (x.std(0) + 1e-8)
    ids = rng.permutation(10 * n)[:n].astype(np.int64)
    return TabularDataset(name, x.astype(np.float32), y.astype(np.int64),
                          C, ids)


# paper metric per dataset (Fig. 5 / Table 2)
PAPER_METRIC = {"mimic3": "f1_micro", "bcw": "accuracy", "credit": "f1_binary"}

# paper alignment scenarios (Appendix A) incl. the reduced MIMIC set (Fig. 8)
ALIGNED_SCENARIOS = {
    "mimic3": [10000, 7500, 5000, 2500],
    "bcw": [250, 200, 150, 100],
    "credit": [10000, 7500, 5000, 2500],
}
REDUCED_SCENARIOS = [750, 500, 250, 100]

# active-party feature counts a in {2,3,4,5} (Appendix A/B)
ACTIVE_FEATURES = [5, 4, 3, 2]
