"""Meshes over ``torch.distributed``: the port of ``repro.launch.mesh``,
the single source of device meshes for the LM dry run and the VFL lane
engine.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` carrying the
reference's axis names: ``("lane", "data")`` for the lane engine
(``core.training.train_lanes(mesh=)``), ``("data", "model")`` or
``("pod", "data", "model")`` for the LM.  A rank is one process,
launched by ``torchrun`` or ``torch.multiprocessing``; the backend is
gloo on the CPU (and for ranks sharing one card) and NCCL across cards.
A gloo world's mesh is a ``cpu`` mesh whatever device its tensors live
on: the lane engine reduces through host memory there.

Functions, not module constants, so importing this module touches no
process group.  Every constructor checks the requested shape against the
world up front: a mesh larger than the world raises a ``ValueError``
that names the mesh and the fix.  With no process group at all, a mesh of
one starts a world of one itself (a ``HashStore``, gloo), so
``train_lanes(mesh=make_lane_mesh())`` runs without a launcher, as on the
card's machine, which drives one H100.

``run_ranks(fn, n, ...)`` runs a function on n gloo ranks in spawned
processes of this host, joined through a ``file://`` store: the tests'
worlds, and two ranks sharing one card in ``chip_smoke.py``.

``fake_world(n)`` is the one place with a fake world: torch's ``fake``
backend, which answers every collective without moving data.  It is to
the dry run (``launch/dryrun.py``) what XLA's
``--xla_force_host_platform_device_count`` is to the reference's.

Run a lane mesh of N ranks on the CPU:
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.experiment \\
        SPEC.json --device cpu          # SPEC.json with "devices": {"lane": N}
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist


def _fix(need: int) -> str:
    return (f"launch {need} ranks with `torchrun --nproc-per-node {need} "
            f"...` (on the CPU, `--device cpu` with the gloo backend)")


def _start_world_of_one() -> None:
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)


def _checked_mesh(shape: tuple, axes: tuple, device_type=None):
    for ax, n in zip(axes, shape):
        if not (isinstance(n, int) and n >= 1):
            raise ValueError(f"mesh axis {ax!r} must be a positive int, "
                             f"got {n!r}")
    need = math.prod(shape)
    if not dist.is_initialized():
        if need > 1:
            raise ValueError(
                f"mesh {dict(zip(axes, shape))} needs {need} ranks but no "
                f"process group exists (a world of 1): {_fix(need)}")
        _start_world_of_one()
    have = dist.get_world_size()
    if need != have:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} ranks but the "
            f"world has {have}: {_fix(need)}; a mesh covers the whole "
            f"world")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(need, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _checked_mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1):
    """A small LM mesh over the world's ranks."""
    return _checked_mesh((data, model), ("data", "model"))


def make_lane_mesh(lane: int = 1, data: int = 1):
    """Mesh for the replica-lane training engine
    (``core.training.train_lanes(..., mesh=...)``): the ``lane`` axis
    splits independent lanes across ranks, the ``data`` axis optionally
    splits rows within a lane (``shard_rows=True``).  Axis names line up
    with the logical-axis policy (``sharding.policy``: ``"lane"`` ->
    ``("lane",)``, ``"dp"`` -> ``("data",)``)."""
    return _checked_mesh((lane, data), ("lane", "data"))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks in this one process
    (this process is rank 0), destroyed on exit.  Collectives on it
    return at once and move nothing: meshes and ``DTensor`` programs run
    their sharding logic and their collectives are counted, which is all
    the dry run asks of them."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:          # pragma: no cover - torch build
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch build does not ship") from e
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group exists already in "
                           "this process; the dry run needs one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, fn, world_size: int, init_dir: str, args: tuple,
               threads: int) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(init_dir, "store"),
        rank=rank, world_size=world_size)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(init_dir, f"rank{rank}.pt"))


def run_ranks(fn, world_size: int, *args, init_dir: str,
              threads: int = 1) -> list:
    """``fn(*args)`` on ``world_size`` gloo ranks, one spawned process
    each, joined through a file store in the empty directory ``init_dir``
    (a fresh one a call).  Returns each rank's return value, in rank order
    (saved with ``torch.save`` under ``init_dir``).  A rank that raises or
    dies makes this raise (``torch.multiprocessing``'s
    ``ProcessRaisedException`` / ``ProcessExitedException``), after every
    process has ended.  ``fn`` must be importable by name (defined at a
    module's top level)."""
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(fn, world_size, init_dir, args,
                                         threads),
                       nprocs=world_size, join=True, start_method="spawn")
    return [torch.load(os.path.join(init_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world_size)]
