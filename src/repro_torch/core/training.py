"""Training engine for the tabular APC-VFL stack: the port of
``repro.core.training`` (``train`` and ``train_lanes``).

Optimization is the paper's Adam (Appendix B) via
``repro_torch.optim.adam``, at most ``max_epochs`` epochs, early stopping
on a validation split with ``patience``.  The contract is the
reference's:

1. rows split into train/val ONCE on the host
   (``np.random.RandomState(seed)``, ``n_val = max(int(n * val_frac), 1)``)
   and both sides moved to the params' device once;
2. ``bs = max(min(batch_size, n_tr), 1)``; each epoch draws a row
   permutation and DROPS the remainder (``n_tr // bs`` full batches);
3. after each epoch the val loss is compared in float32,
   ``vl < best_v - 1e-6``; the best-val params are returned, and the fit
   stops after ``patience`` epochs without improvement.

Permutations.  Each epoch's permutation comes from a ``torch.Generator``
seeded from ``(seed, epoch)`` on the host (``default_perm``), so a fit on
the CPU and on the card draws the same batches.  ``perm_fn(seed, epoch,
n)`` replaces it; a parity test passes the reference's
``jax.random.permutation(fold_in(PRNGKey(seed), epoch), n)`` as arrays
through it, since the two packages' generators differ.

Host syncs.  The reference runs a whole fit as one device scan and syncs
the host once per fit.  This loop syncs once per EPOCH: the early-stop
decision (and the epoch's losses for the histories) come to the host in
one copy, and the next epoch is dispatched from there.

Lanes (``train_lanes``).  Independent fits (two parties' g1, a seed
replicate, a fold) group by shape (``_lane_groups``); each group is ONE
stack with a leading lane axis, so every step of the group is one call of
the loss on stacked params: with the Table-3 losses (``autoencoder``,
``distill.make_lanes_loss``) that is one launch per kernel for all the
group's lanes.  A lane loss returns ``(L,)``; its gradient is the
gradient of the sum, which is exact because the lanes share nothing.
Within a group, params and data are zero-padded to common shapes
(``core.padding``); each lane keeps its own split, permutation, Adam
step and step budget ``n_tr_i // bs``, and a lane past its budget or
after its early stop keeps its params and Adam state frozen.  The batch
size is clamped to the smallest lane's train rows over ALL lanes before
grouping, as the reference does, and real rows are stable-partitioned to
the front of each lane's permutation.

The engine runs on the device of the params it is given (tensors).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.guards import to_host
from repro_torch.core import padding
from repro_torch.optim.adam import paper_adam
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class TrainResult:
    params: dict
    epochs_run: int
    steps_run: int
    train_loss: list
    val_loss: list


@dataclass
class LaneSpec:
    """One lane's training problem for ``train_lanes``: unpadded init
    params, unpadded row-aligned data dict (with an ``"x"`` feature array)
    and the lane's seed (drives both its train/val split and its epoch
    permutations, exactly as the same seed would in ``train``)."""
    params: dict
    data: dict
    seed: int = 0


def default_perm(seed: int, epoch: int, n: int) -> np.ndarray:
    """The port's permutation of ``n`` rows for ``(seed, epoch)``, drawn
    on the host so every device trains on the same batches."""
    gen = torch.Generator().manual_seed((seed * 2 ** 32 + epoch) % 2 ** 63)
    return torch.randperm(n, generator=gen).numpy()


def _device(params) -> torch.device:
    leaves = tree_leaves(params)
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        raise TypeError("training: params must be a dict tree of tensors "
                        "(convert.to_torch), on the device to train on")
    return leaves[0].device


def _upload(v, dev: torch.device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(dev)


def _split(data: dict, seed: int, val_frac: float, dev: torch.device):
    """The reference's host split (``_prep_single``); the gather runs on
    the device."""
    n = len(next(iter(data.values())))
    split = np.random.RandomState(seed).permutation(n)
    n_val = max(int(n * val_frac), 1)
    vi = torch.as_tensor(split[:n_val], device=dev)
    ti = torch.as_tensor(split[n_val:], device=dev)
    on_dev = {k: _upload(v, dev) for k, v in data.items()}
    return ({k: v[ti] for k, v in on_dev.items()},
            {k: v[vi] for k, v in on_dev.items()}, n - n_val)


def _n_train(data: dict, val_frac: float) -> int:
    n = len(next(iter(data.values())))
    return n - max(int(n * val_frac), 1)


def _fit(params, tr, val, loss_fn, *, lanes: Optional[int], nb, bs: int,
         batch_idx: Callable, max_epochs: int, patience: int, lr: float,
         epoch_callback: Optional[Callable] = None):
    """The epoch loop shared by ``train`` (``lanes=None``: one unstacked
    instance) and each shape group of ``train_lanes`` (params, data and
    losses carry a lane axis of ``lanes``).  ``batch_idx(epoch)`` gives
    the epoch's row indices, (n_batches, bs) or (L, n_batches, bs).
    ``epoch_callback(epoch, params, tl, vl)`` (single fits only) gets the
    epoch's params and its two losses, already on the host.
    Returns the best-val params and, per lane, the epochs run and the
    loss histories."""
    dev = _device(params)
    L = 1 if lanes is None else lanes
    nb = np.asarray(nb).reshape(L)
    n_batches = int(nb.max())
    opt = paper_adam(lr)
    state = opt.init(params, lanes=lanes)
    best_p = params
    best_v = torch.full((L,), float("inf"), device=dev)
    since = np.zeros(L, np.int64)
    live = np.ones(L, bool)
    epochs = np.zeros(L, np.int64)
    tl_hist = [[] for _ in range(L)]
    vl_hist = [[] for _ in range(L)]
    rows = torch.arange(L, device=dev)[:, None]
    budget = torch.as_tensor(np.maximum(nb, 1), dtype=torch.float32,
                             device=dev)

    def take(idx):
        if lanes is None:
            return {k: v[idx] for k, v in tr.items()}
        batch = {k: v[rows, idx] for k, v in tr.items() if k != "mask"}
        batch["mask"] = tr["mask"]
        batch["row_w"] = torch.ones((L, bs), device=dev)
        return batch

    def freeze(on, new, old):
        # lanes past their budget or stopped keep params and Adam state
        if on.all():
            return new
        keep = torch.as_tensor(on, device=dev)
        return tree_map(lambda a, b: torch.where(
            keep.reshape((L,) + (1,) * (a.dim() - 1)), a, b), new, old)

    for epoch in range(max_epochs):
        idx = batch_idx(epoch)
        step_losses = []
        for i in range(n_batches):
            on = live & (i < nb)
            if not on.any():
                break
            batch = take(idx[i] if lanes is None else idx[:, i])
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True)
                          for t in tree_leaves(params)]
                loss = loss_fn(tree_unflatten(params, leaves), batch)
                grads = torch.autograd.grad(loss.sum(), leaves)
            with torch.no_grad():
                new_p, new_s = opt.update(tree_unflatten(params, grads),
                                          state, params)
                params = freeze(on, new_p, params)
                state = type(state)(*(freeze(on, a, b)
                                      for a, b in zip(new_s, state)))
                loss = loss.detach().reshape(L)
                step_losses.append(loss if on.all() else torch.where(
                    torch.as_tensor(on, device=dev), loss, 0.0))
        with torch.no_grad():
            tl = (torch.stack(step_losses).sum(0) if step_losses
                  else torch.zeros(L, device=dev)) / budget
            vl = loss_fn(params, val).reshape(L)
            improved_t = torch.as_tensor(live, device=dev) & (
                vl < best_v - 1e-6)
            # the one host sync of the epoch: its losses and the decision
            host = to_host(torch.stack([tl, vl, improved_t.to(tl.dtype)]))
            improved = host[2] > 0
            for j in np.flatnonzero(live):
                tl_hist[j].append(float(host[0, j]))
                vl_hist[j].append(float(host[1, j]))
            epochs += live
            if epoch_callback is not None:
                # each Adam step makes new tensors, so the callback's
                # params are never stepped onward under it
                epoch_callback(epoch, params, tl_hist[0][-1],
                               vl_hist[0][-1])
            if improved.any():
                best_v = torch.where(improved_t, vl, best_v)
                best_p = freeze(improved, params, best_p) if lanes \
                    else params
            since = np.where(improved, 0, since + 1)
            if lanes is None:       # the reference's single-fit rule
                live = improved | (since < patience)
            else:
                live = live & (since < patience)
        if not live.any():
            break
    return best_p, epochs, tl_hist, vl_hist


def train(params, data: dict, loss_fn: Callable, *, batch_size: int = 128,
          max_epochs: int = 200, patience: int = 10, lr: float = 1e-3,
          val_frac: float = 0.1, seed: int = 0,
          perm_fn: Optional[Callable] = None,
          epoch_callback: Optional[Callable] = None) -> TrainResult:
    """data: dict of equal-length, row-aligned arrays or tensors;
    ``loss_fn(params, batch)`` returns a scalar.  Trains on the device of
    ``params``; ``perm_fn(seed, epoch, n)`` overrides ``default_perm``.
    ``epoch_callback(epoch, params, tl, vl)`` runs after every epoch with
    that epoch's params and its train and val losses as floats
    (the reference routes such fits to its per-epoch loop; here every fit
    syncs once an epoch, so the losses are on the host already)."""
    dev = _device(params)
    tr, val, n_tr = _split(data, seed, val_frac, dev)
    bs = max(min(batch_size, n_tr), 1)
    n_batches = n_tr // bs
    perm_fn = perm_fn or default_perm

    def batch_idx(epoch):
        perm = np.asarray(perm_fn(seed, epoch, n_tr), np.int64)
        return torch.as_tensor(perm[:n_batches * bs].reshape(n_batches, bs),
                               device=dev)

    best, epochs, tls, vls = _fit(params, tr, val, loss_fn, lanes=None,
                                  nb=n_batches, bs=bs, batch_idx=batch_idx,
                                  max_epochs=max_epochs, patience=patience,
                                  lr=lr, epoch_callback=epoch_callback)
    e = int(epochs[0])
    return TrainResult(best, e, e * n_batches, tls[0], vls[0])


def _signature(tree, path=()):
    if isinstance(tree, dict):
        return tuple(s for k, v in tree.items()
                     for s in _signature(v, path + (k,)))
    return ((path, tuple(np.shape(tree))),)


def _lane_groups(specs: Sequence[LaneSpec]) -> list:
    """Partition lane indices by (data shapes, param shapes): lanes in one
    group stack with no padding, so a small party is never padded up to a
    large one."""
    groups: dict = {}
    for i, sp in enumerate(specs):
        key = (_signature(sp.data), _signature(sp.params))
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def _fit_group(specs: Sequence[LaneSpec], loss_fn: Callable, *,
               batch_size: int, max_epochs: int, patience: int, lr: float,
               val_frac: float, perm_fn: Callable) -> List[TrainResult]:
    """One padded stack of lanes through ``_fit`` (the reference's
    ``_prep_lanes`` plus its lane engine); ``batch_size`` is already the
    global clamp."""
    for sp in specs:
        if "x" not in sp.data:
            raise ValueError("train_lanes: every LaneSpec.data needs an "
                             "'x' feature array (sizes the rows and the "
                             "real-feature mask)")
    dev = _device(specs[0].params)
    tr_list, val_list, n_tr = [], [], []
    for sp in specs:
        tr, val, nt = _split(sp.data, sp.seed, val_frac, dev)
        tr["mask"] = torch.ones((tr["x"].shape[1],), device=dev)
        val["mask"] = tr["mask"]
        val["row_w"] = torch.ones((val["x"].shape[0],), device=dev)
        tr_list.append(tr)
        val_list.append(val)
        n_tr.append(nt)
    n_tr = np.asarray(n_tr)
    bs = max(min(batch_size, int(n_tr.min())), 1)
    nb = n_tr // bs
    n_batches = int(nb.max())
    tr, val = padding.pad_stack(tr_list), padding.pad_stack(val_list)
    n_max = int(tr["x"].shape[1])
    shapes = [[tuple(t.shape) for t in tree_leaves(sp.params)]
              for sp in specs]
    params = padding.pad_stack([tree_map(lambda t: t.to(dev), sp.params)
                                for sp in specs])

    def batch_idx(epoch):
        out = np.empty((len(specs), n_batches, bs), np.int64)
        for j, sp in enumerate(specs):
            perm = np.asarray(perm_fn(sp.seed, epoch, n_max), np.int64)
            # real rows (< n_tr) first, in permutation order: for an
            # unpadded lane this is exactly the permutation ``train`` uses
            order = perm[np.argsort(perm >= n_tr[j], kind="stable")]
            out[j] = order[:n_batches * bs].reshape(n_batches, bs)
        return torch.as_tensor(out, device=dev)

    best, epochs, tls, vls = _fit(params, tr, val, loss_fn,
                                  lanes=len(specs), nb=nb, bs=bs,
                                  batch_idx=batch_idx, max_epochs=max_epochs,
                                  patience=patience, lr=lr)
    out = []
    for j, sp in enumerate(specs):
        leaves = [leaf[j][tuple(slice(0, s) for s in shp)]
                  for leaf, shp in zip(tree_leaves(best), shapes[j])]
        e = int(epochs[j])
        out.append(TrainResult(tree_unflatten(sp.params, leaves), e,
                               e * int(nb[j]), tls[j], vls[j]))
    return out


def train_lanes(specs: Sequence[LaneSpec], loss_fn: Callable, *,
                batch_size: int = 128, max_epochs: int = 200,
                patience: int = 10, lr: float = 1e-3,
                val_frac: float = 0.1, mesh=None,
                perm_fn: Optional[Callable] = None) -> List[TrainResult]:
    """Train independent lanes, one padded stack per shape group (module
    docstring).  ``loss_fn(params, batch)`` receives params and batches
    with a leading lane axis, the batch carrying the engine's ``mask``
    (real-feature columns) and ``row_w`` (real-row weights), and returns
    one loss per lane: use ``autoencoder.masked_recon_loss`` /
    ``make_masked_recon_loss`` or ``distill.make_lanes_loss``.

    Returns one ``TrainResult`` per lane, in input order, with padding
    stripped from the best-val params and histories cut at that lane's
    stop."""
    if mesh is not None:
        raise NotImplementedError(
            "train_lanes(mesh=...): lane sharding across devices is not "
            "ported yet (it lands with the port's multi-device slice)")
    global_bs = max(min(batch_size, min(_n_train(sp.data, val_frac)
                                        for sp in specs)), 1)
    results: List[Optional[TrainResult]] = [None] * len(specs)
    for idxs in _lane_groups(specs):
        group = _fit_group([specs[i] for i in idxs], loss_fn,
                           batch_size=global_bs, max_epochs=max_epochs,
                           patience=patience, lr=lr, val_frac=val_frac,
                           perm_fn=perm_fn or default_perm)
        for i, r in zip(idxs, group):
            results[i] = r
    return results
