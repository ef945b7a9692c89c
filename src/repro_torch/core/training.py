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

Meshes (``train_lanes(mesh=, shard_rows=)``).  ``mesh`` is a
``launch.mesh.make_lane_mesh`` mesh, axes ``("lane", "data")``, one rank
a process.  Each shape group's lanes split into contiguous chunks over
the ``lane`` ranks in lane order, ceil(L / n) a rank (the last chunk may
be short, a rank may get none): the reference's padded lane layout
without its dead lanes.  A rank uploads and trains only its own lanes;
the batch-size clamp and the shape groups are computed over ALL specs, so
every lane draws the batches it would unsharded.  The results come back
to every rank in input order (``all_gather_object``).  Each rank keeps
its one host copy an epoch for its own lanes; the lane axis adds no
collective per epoch.  Lanes a rank does not hold may stand as ``meta``
tensors of their global shape (``data.scale`` builds them so): they are
never touched.

``shard_rows=True`` with a ``data`` axis of D ranks splits each lane's
rows: data rank r holds rows [r n / D, (r + 1) n / D) of the lane's data
(a tensor, of which it uploads only that slab, or a ``RowSlab`` holding
only it).  The train/val split and the epoch permutations stay global
(host numpy, as unsharded).  A step gathers, of each global batch, the
rows the rank holds; the loss's ``row_terms`` (the numerator and the row
weights' sum: ``autoencoder.masked_recon_loss`` and its fused variant
have them) are summed over those rows; the numerator's gradients and the
two sums of every rank are gathered over the data group and summed in
rank order, so every data rank applies the same Adam step.  Validation
sums the same way.  No rank holds a lane's whole row set.  The rows are
split only where D divides both the train and the validation rows (the
reference's ``policy._divisible`` on its split arrays); elsewhere every
data rank trains the whole lane, giving the unsharded bits.  Over gloo
(the CPU, or ranks sharing one card) the per-step sum goes through host
memory; this is a check of the mechanism, not a speed-up.

The engine runs on the device of the params it is given (tensors).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Sequence, Tuple

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


@dataclass
class RowSlab:
    """Rows [start, start + len(local)) of a lane's ``n``-row data array,
    all this rank holds of it: what ``data.scale`` builds under a mesh's
    ``data`` axis.  ``shape`` and ``len`` are the global array's, so shape
    groups and the batch clamp see the lane as it is."""
    local: torch.Tensor
    start: int
    n: int

    @property
    def shape(self) -> tuple:
        return (self.n,) + tuple(self.local.shape[1:])

    def __len__(self) -> int:
        return self.n


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
         epoch_callback: Optional[Callable] = None, rows=None):
    """The epoch loop shared by ``train`` (``lanes=None``: one unstacked
    instance) and each shape group of ``train_lanes`` (params, data and
    losses carry a lane axis of ``lanes``).  ``batch_idx(epoch)`` gives
    the epoch's row indices, (n_batches, bs) or (L, n_batches, bs), and
    their row weights (None: all 1).
    ``epoch_callback(epoch, params, tl, vl)`` (single fits only) gets the
    epoch's params and its two losses, already on the host.  ``rows`` (a
    ``_RowGroup``) sums the loss over a data group's row slabs.
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
    budget = torch.as_tensor(np.maximum(nb, 1), dtype=torch.float32,
                             device=dev)

    lane_ix = torch.arange(L, device=dev)[:, None]

    def take(idx, w):
        if lanes is None:
            return {k: v[idx] for k, v in tr.items()}
        batch = {k: v[lane_ix, idx] for k, v in tr.items() if k != "mask"}
        batch["mask"] = tr["mask"]
        batch["row_w"] = torch.ones((L, bs), device=dev) if w is None else w
        return batch

    def loss_and_grads(params, batch):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(params)]
            p = tree_unflatten(params, leaves)
            if rows is None:
                loss = loss_fn(p, batch)
                return loss.detach(), torch.autograd.grad(loss.sum(), leaves)
            num, den = loss_fn.row_terms(p, batch)
            grads = torch.autograd.grad(num.sum(), leaves)
        return rows.mean(num.detach(), den.detach(), grads)

    def val_loss(params):
        if rows is None:
            return loss_fn(params, val)
        num, den = loss_fn.row_terms(params, val)
        return rows.mean(num, den, ())[0]

    def freeze(on, new, old):
        # lanes past their budget or stopped keep params and Adam state
        if on.all():
            return new
        keep = torch.as_tensor(on, device=dev)
        return tree_map(lambda a, b: torch.where(
            keep.reshape((L,) + (1,) * (a.dim() - 1)), a, b), new, old)

    for epoch in range(max_epochs):
        idx, w = batch_idx(epoch)
        step_losses = []
        for i in range(n_batches):
            on = live & (i < nb)
            if not on.any():
                break
            batch = take(idx[i], None) if lanes is None else take(
                idx[:, i], None if w is None else w[:, i])
            loss, grads = loss_and_grads(params, batch)
            with torch.no_grad():
                new_p, new_s = opt.update(tree_unflatten(params, grads),
                                          state, params)
                params = freeze(on, new_p, params)
                state = type(state)(*(freeze(on, a, b)
                                      for a, b in zip(new_s, state)))
                loss = loss.reshape(L)
                step_losses.append(loss if on.all() else torch.where(
                    torch.as_tensor(on, device=dev), loss, 0.0))
        with torch.no_grad():
            tl = (torch.stack(step_losses).sum(0) if step_losses
                  else torch.zeros(L, device=dev)) / budget
            vl = val_loss(params).reshape(L)
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
                               device=dev), None

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


class _RowGroup:
    """A data group's share of a row-sharded lane stack (``train_lanes``'
    ``shard_rows``): this rank's position, the group's size and process
    group, and the sum of a step over it."""

    def __init__(self, rank: int, size: int, group):
        self.rank, self.size, self.group = rank, size, group

    def slab(self, n: int) -> Tuple[int, int]:
        return self.rank * n // self.size, (self.rank + 1) * n // self.size

    def mean(self, num, den, grads):
        """Every rank's loss numerators (L,), row-weight sums (L,) and
        numerator gradients, summed over the group in rank order: the loss
        and the gradients of the whole batch, the same bits on every
        rank."""
        L = num.shape[0]
        tot = _sum_over(torch.cat([num.reshape(-1), den.reshape(-1)]
                                  + [g.reshape(-1) for g in grads]),
                        self.group, self.size)
        d = torch.clamp(tot[L:2 * L], min=1.0)
        out, o = [], 2 * L
        for g in grads:
            out.append(tot[o:o + g.numel()].reshape(g.shape)
                       / d.reshape((L,) + (1,) * (g.dim() - 1)))
            o += g.numel()
        return tot[:L] / d, out


def _sum_over(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` in rank order (an
    all-gather, then the adds in that order), so every rank gets the same
    bits.  gloo carries a CUDA tensor through host memory."""
    import torch.distributed as dist
    dev = t.device
    if t.is_cuda and dist.get_backend(group) == "gloo":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.to(dev)


def _rows_divide(n: int, size: int, val_frac: float) -> bool:
    """The reference's ``policy._divisible`` on its split arrays: rows are
    sharded only where the data axis divides the train and the validation
    rows."""
    n_val = max(int(n * val_frac), 1)
    return (n - n_val) % size == 0 and n_val % size == 0


def _slab_of(v, lo: int, hi: int):
    if isinstance(v, RowSlab):
        if (v.start, v.start + len(v.local)) != (lo, hi):
            raise ValueError(f"train_lanes: a RowSlab holds rows "
                             f"[{v.start}, {v.start + len(v.local)}) but "
                             f"this data rank trains rows [{lo}, {hi})")
        return v.local
    return v[lo:hi]


def _split_slab(data: dict, seed: int, val_frac: float, dev: torch.device,
                rows: _RowGroup):
    """``_split`` of the rows this data rank holds: the global host split,
    restricted to the rank's slab.  Also returns, for each train row of
    the global split, its position among the rank's train rows (-1: held
    by another rank)."""
    n = len(next(iter(data.values())))
    split = np.random.RandomState(seed).permutation(n)
    n_val = max(int(n * val_frac), 1)
    vi, ti = split[:n_val], split[n_val:]
    lo, hi = rows.slab(n)
    slab = {k: _upload(_slab_of(v, lo, hi), dev) for k, v in data.items()}
    t_pos = np.flatnonzero((ti >= lo) & (ti < hi))
    v_rows = vi[(vi >= lo) & (vi < hi)] - lo
    loc = np.full(n - n_val, -1, np.int64)
    loc[t_pos] = np.arange(len(t_pos))
    t_rows = torch.as_tensor(ti[t_pos] - lo, device=dev)
    v_rows = torch.as_tensor(v_rows, device=dev)
    return ({k: v[t_rows] for k, v in slab.items()},
            {k: v[v_rows] for k, v in slab.items()}, n - n_val, loc)


def _fit_group(specs: Sequence[LaneSpec], loss_fn: Callable, *,
               batch_size: int, max_epochs: int, patience: int, lr: float,
               val_frac: float, perm_fn: Callable,
               rows: Optional[_RowGroup] = None) -> List[TrainResult]:
    """One padded stack of lanes through ``_fit`` (the reference's
    ``_prep_lanes`` plus its lane engine); ``batch_size`` is already the
    global clamp.  With ``rows`` each lane holds only this data rank's row
    slab."""
    for sp in specs:
        if "x" not in sp.data:
            raise ValueError("train_lanes: every LaneSpec.data needs an "
                             "'x' feature array (sizes the rows and the "
                             "real-feature mask)")
    if rows is not None and not hasattr(loss_fn, "row_terms"):
        raise ValueError("train_lanes(shard_rows=True): the loss has no "
                         "row_terms (its numerator and row-weight sum), "
                         "so its rows cannot be summed across ranks: use "
                         "autoencoder.masked_recon_loss or "
                         "make_masked_recon_loss")
    dev = _device(specs[0].params)
    tr_list, val_list, n_tr, held = [], [], [], []
    for sp in specs:
        if rows is None:
            tr, val, nt = _split(sp.data, sp.seed, val_frac, dev)
        else:
            tr, val, nt, loc = _split_slab(sp.data, sp.seed, val_frac, dev,
                                           rows)
            held.append(loc)
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
    n_max = int(n_tr.max())
    tr, val = padding.pad_stack(tr_list), padding.pad_stack(val_list)
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
        if rows is None:
            return torch.as_tensor(out, device=dev), None
        # each batch's rows that this rank holds, in batch order, padded
        # to one width with weight-0 rows
        loc = np.stack([h[o] for h, o in zip(held, out)])
        keep = loc >= 0
        first = np.argsort(~keep, axis=-1, kind="stable")
        m = max(int(keep.sum(-1).max()), 1)
        loc = np.take_along_axis(loc, first, -1)[..., :m]
        keep = np.take_along_axis(keep, first, -1)[..., :m]
        return (torch.as_tensor(np.where(keep, loc, 0), device=dev),
                torch.as_tensor(keep, dtype=torch.float32, device=dev))

    best, epochs, tls, vls = _fit(params, tr, val, loss_fn,
                                  lanes=len(specs), nb=nb, bs=bs,
                                  batch_idx=batch_idx, max_epochs=max_epochs,
                                  patience=patience, lr=lr, rows=rows)
    out = []
    for j, sp in enumerate(specs):
        leaves = [leaf[j][tuple(slice(0, s) for s in shp)]
                  for leaf, shp in zip(tree_leaves(best), shapes[j])]
        e = int(epochs[j])
        out.append(TrainResult(tree_unflatten(sp.params, leaves), e,
                               e * int(nb[j]), tls[j], vls[j]))
    return out


def check_lane_mesh(mesh) -> Tuple[dict, dict]:
    """A lane mesh's axis sizes and this rank's coordinate on it; a mesh
    without a ``lane`` axis raises the reference's error."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "lane" not in names:
        raise ValueError(
            f"train_lanes: mesh axes {names} lack the 'lane' axis — build "
            f"the mesh with repro_torch.launch.mesh.make_lane_mesh")
    return (dict(zip(names, tuple(mesh.shape))),
            dict(zip(names, mesh.get_coordinate())))


def _gather_results(done: dict, specs: Sequence[LaneSpec],
                    mesh) -> dict:
    """Every rank's results, on every rank: this rank's own as they are,
    the others' moved to this rank's device (that of the first real param
    among the specs, else the mesh's)."""
    import torch.distributed as dist
    mine = {i: replace(r, params=tree_map(lambda t: t.cpu(), r.params))
            for i, r in done.items()}
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, mine)
    real = [t for sp in specs for t in tree_leaves(sp.params)
            if isinstance(t, torch.Tensor) and not t.is_meta]
    dev = real[0].device if real else torch.device(mesh.device_type)
    out = dict(done)
    for part in parts:
        for i, r in part.items():
            if i not in out:
                out[i] = replace(r, params=tree_map(lambda t: t.to(dev),
                                                    r.params))
    return out


def train_lanes(specs: Sequence[LaneSpec], loss_fn: Callable, *,
                batch_size: int = 128, max_epochs: int = 200,
                patience: int = 10, lr: float = 1e-3,
                val_frac: float = 0.1, mesh=None, shard_rows: bool = False,
                perm_fn: Optional[Callable] = None) -> List[TrainResult]:
    """Train independent lanes, one padded stack per shape group (module
    docstring).  ``loss_fn(params, batch)`` receives params and batches
    with a leading lane axis, the batch carrying the engine's ``mask``
    (real-feature columns) and ``row_w`` (real-row weights), and returns
    one loss per lane: use ``autoencoder.masked_recon_loss`` /
    ``make_masked_recon_loss`` or ``distill.make_lanes_loss``.

    ``mesh`` (``launch.mesh.make_lane_mesh``, axes ``("lane", "data")``)
    splits each group's lanes over the ``lane`` ranks; ``shard_rows=True``
    also splits each lane's rows over the ``data`` ranks (module
    docstring).  Every rank calls this with the same specs.

    Returns one ``TrainResult`` per lane, in input order, with padding
    stripped from the best-val params and histories cut at that lane's
    stop."""
    lane_rank, n_lane, rows = 0, 1, None
    if mesh is not None:
        sizes, coord = check_lane_mesh(mesh)
        lane_rank, n_lane = coord["lane"], sizes["lane"]
        if shard_rows and sizes.get("data", 1) > 1:
            rows = _RowGroup(coord["data"], sizes["data"],
                             mesh.get_group("data"))
    global_bs = max(min(batch_size, min(_n_train(sp.data, val_frac)
                                        for sp in specs)), 1)
    done = {}
    for idxs in _lane_groups(specs):
        c = -(-len(idxs) // n_lane)
        mine = idxs[lane_rank * c:(lane_rank + 1) * c]
        if not mine:
            continue
        n = len(next(iter(specs[mine[0]].data.values())))
        split = rows if rows is not None and _rows_divide(
            n, rows.size, val_frac) else None
        if split is None and any(isinstance(v, RowSlab) for i in mine
                                 for v in specs[i].data.values()):
            raise ValueError(
                f"train_lanes: lane {mine[0]} holds only a slab of its "
                f"{n} rows, but its rows are not sharded here (shard_rows="
                f"{shard_rows}, the data axis must divide its train and "
                f"validation rows)")
        group = _fit_group([specs[i] for i in mine], loss_fn,
                           batch_size=global_bs, max_epochs=max_epochs,
                           patience=patience, lr=lr, val_frac=val_frac,
                           perm_fn=perm_fn or default_perm, rows=split)
        done.update(zip(mine, group))
    if mesh is not None:
        done = _gather_results(done, specs, mesh)
    return [done[i] for i in range(len(specs))]
