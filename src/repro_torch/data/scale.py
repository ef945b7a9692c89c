"""Streaming synthetic vertical partitions at scale, the million-row
workload of the lane engine: the port of ``repro.data.scale``.

``make_scale_lanes`` builds an n-row x K-party vertical partition where
every party holds a correlated nonlinear view of the SAME rows (a shared
latent ``z`` per row through a per-party mixing matrix and ``tanh``),
sized so a host copy is out of the question:

* rows are generated on the device, block by block (``block_rows``),
  and no ``(n, d)`` host buffer ever exists.  Block b's latents come from
  a ``torch.Generator`` on that device seeded from ``(seed, b)`` only, and
  its noise from one seeded from ``(seed, b, party + 1)``; the seeds are
  derived on the host with ``np.random.SeedSequence``.  So every party of
  a seed sees the same latents row by row, and a block is the same bits
  wherever it is generated on one device type.  The streams are the
  port's own: ``jax.random`` draws cannot be reproduced in torch, and a
  CUDA generator's stream differs from the CPU's.  ``_party_block`` is a
  function of the draws ``z`` and ``e``, so a test can feed it the
  reference's own;
* the result is a list of ``training.LaneSpec``, one a (party, seed)
  replicate in seed-major order, each with its own encoder init and seed:
  what ``training.train_lanes(lanes, ae.make_masked_recon_loss(...))``
  consumes.  Parties ARE lanes.

Labels are not generated: the workload measures the g1
representation-learning stage.  Features are approximately standardized
by construction (unit-variance latents through ``tanh`` of an O(1) mix
plus scaled noise, then a fixed analytic rescale).

With a lane ``mesh`` (``launch.mesh.make_lane_mesh``) each rank generates
only what it trains.  The lanes split over the ``lane`` ranks as
``train_lanes`` splits their one shape group: contiguous chunks of
ceil(L / n) lanes in lane order.  A lane this rank does not hold stands
as ``meta`` tensors of its global shapes (its ``x`` and its encoder
params): its shape groups it with the others, and nothing touches it.
Where the mesh's ``data`` axis (D ranks) divides ``n_rows``, a held
lane's ``x`` is a ``training.RowSlab``: only the rows [r n / D,
(r + 1) n / D) of data rank r, generated from the blocks over that slab,
which ``train_lanes(shard_rows=True)`` trains (it needs D to divide the
train and validation rows too, and raises otherwise).  The data ranks'
slabs concatenated are the unsharded generation, bit for bit, on one
device type.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.core import autoencoder as ae
from repro_torch.core.training import LaneSpec, RowSlab, check_lane_mesh


def _party_mix(n_latent: int, n_features: int, party: int = 0) -> np.ndarray:
    """Party mixing matrix: each feature reads (mostly) one latent factor
    plus a weak second; the party index rotates which latents a party
    observes, so parties hold different (but correlated) views."""
    mix = np.zeros((n_latent, n_features), np.float32)
    for j in range(n_features):
        mix[(j + party) % n_latent, j] = 1.3
        mix[(j * 5 + 1 + party) % n_latent, j] += 0.25
    return mix


def _seed(*words: int) -> int:
    """A generator seed from integer words (host, fixed rule)."""
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0])


def _party_block(z: torch.Tensor, e: torch.Tensor, mix: torch.Tensor,
                 noise: float) -> torch.Tensor:
    """One block of one party's rows from its draws: shared latents ``z``
    (rows, n_latent) through the mixing matrix, saturating tanh, the
    party's noise ``e`` (rows, n_features), a fixed rescale to ~unit
    variance."""
    v = torch.tanh(z @ mix)                   # var(tanh(N(0,~1))) ~ 0.4
    x = v + noise * e
    return (x / np.float32(np.sqrt(0.4 + noise * noise))).to(torch.float32)


def _block(b: int, rows: int, mix: torch.Tensor, *, seed: int, party: int,
           noise: float, dev: torch.device) -> torch.Tensor:
    n_latent, n_features = mix.shape
    gz = torch.Generator(device=dev).manual_seed(_seed(seed, b))
    ge = torch.Generator(device=dev).manual_seed(_seed(seed, b, party + 1))
    z = torch.randn((rows, n_latent), generator=gz, device=dev)
    e = torch.randn((rows, n_features), generator=ge, device=dev)
    return _party_block(z, e, mix, noise)


def make_scale_party(n_rows: int, *, n_features: int, n_latent: int = 8,
                     party: int = 0, seed: int = 0, noise: float = 0.5,
                     block_rows: int = 1 << 17, rows: Optional[tuple] = None,
                     device="cuda") -> torch.Tensor:
    """One party's ``(n_rows, n_features)`` features, generated on
    ``device`` in ``block_rows`` blocks (module docstring).  ``rows=(lo,
    hi)`` generates only the blocks over rows [lo, hi) and returns those
    rows: a data rank's slab."""
    dev = resolve_device(device)
    lo, hi = (0, n_rows) if rows is None else rows
    mix = torch.as_tensor(_party_mix(n_latent, n_features, party),
                          device=dev)
    parts = []
    for b in range(lo // block_rows, math.ceil(hi / block_rows)):
        start = b * block_rows
        n = min(block_rows, n_rows - start)
        x = _block(b, n, mix, seed=seed, party=party, noise=noise, dev=dev)
        parts.append(x[max(lo - start, 0):min(hi - start, n)])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def make_scale_lanes(n_rows: int, n_parties: int, *, n_features: int = 16,
                     n_latent: int = 8, widths: Optional[list] = None,
                     seeds=(0,), noise: float = 0.5,
                     block_rows: int = 1 << 17, mesh=None,
                     init_params: Optional[Sequence[dict]] = None,
                     device="cuda") -> List[LaneSpec]:
    """The workload: ``n_parties * len(seeds)`` equal-shape lanes, one a
    (seed, party), seed-major.  Each seed re-draws the scenario (fresh
    latents, encoders, its own split and epoch permutations through
    ``LaneSpec.seed = seed * 100 + party``); within one seed all parties
    share latents row by row.  Lane (s, party)'s encoder is drawn from a
    generator seeded from ``(s + 7001, party)``, as the reference folds
    ``party`` into ``PRNGKey(s + 7001)``, or taken from ``init_params``
    (one tree of arrays a lane, in lane order).  ``mesh``: module
    docstring."""
    widths = list(widths) if widths is not None else [n_features, 32, 64]
    if widths[0] != n_features:
        raise ValueError(f"widths[0] ({widths[0]}) must equal n_features "
                         f"({n_features})")
    dev = resolve_device(device)
    L = len(seeds) * n_parties
    held, rows = range(L), None
    if mesh is not None:
        sizes, coord = check_lane_mesh(mesh)
        c = -(-L // sizes["lane"])
        held = range(coord["lane"] * c, min((coord["lane"] + 1) * c, L))
        D = sizes.get("data", 1)
        if D > 1 and n_rows % D == 0:
            r = coord["data"]
            rows = (r * n_rows // D, (r + 1) * n_rows // D)
    lanes = []
    for si, s in enumerate(seeds):
        for party in range(n_parties):
            i = si * n_parties + party
            lane_seed = int(s) * 100 + party
            if i not in held:
                lanes.append(LaneSpec(
                    ae.init_autoencoder(torch.Generator(), widths,
                                        device="meta"),
                    {"x": torch.empty((n_rows, n_features), device="meta")},
                    seed=lane_seed))
                continue
            x = make_scale_party(n_rows, n_features=n_features,
                                 n_latent=n_latent, party=party,
                                 seed=int(s), noise=noise,
                                 block_rows=block_rows, rows=rows,
                                 device=dev)
            if rows is not None:
                x = RowSlab(x, rows[0], n_rows)
            if init_params is not None:
                params = convert.to_torch(init_params[i], device=dev)
            else:
                gen = torch.Generator().manual_seed(_seed(int(s) + 7001,
                                                          party))
                params = ae.init_autoencoder(gen, widths, device=dev)
            lanes.append(LaneSpec(params, {"x": x}, seed=lane_seed))
    return lanes


def lane_bytes(lanes: Sequence[LaneSpec]) -> int:
    """Bytes of the features this rank holds (meta lanes hold none)."""
    total = 0
    for sp in lanes:
        x = sp.data["x"]
        x = x.local if isinstance(x, RowSlab) else x
        if not x.is_meta:
            total += x.numel() * x.element_size()
    return total
