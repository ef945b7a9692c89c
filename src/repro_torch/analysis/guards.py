"""Runtime guards: prove the port's sync, dtype and compile contracts
against the budgets committed in ``ANALYSIS_budgets.json`` (the port's
own copy of ``repro.analysis.guards``).

``to_host``
    The one sanctioned device->host copy, the port's ``jax.device_get``:
    ``t.detach().cpu().numpy()``, counted by the innermost open
    ``no_host_sync`` block.  Each of the port's single copies goes through
    it: a VFL dispatch's logits, a fit's epoch losses, a decode step's
    tokens.

``no_host_sync(allowed, label=, device=)``
    Forbids device->host conversions inside the block except ``allowed``
    ``to_host`` calls.  An implicit conversion of a tensor on the block's
    device (``item``, ``tolist``, ``numpy``, ``cpu``, ``__float__``,
    ``__int__``, ``__bool__``, ``__index__``, ``__array__``, and
    ``np.asarray`` / ``np.array`` of a tensor) raises ``HostSyncError`` at
    its call site; the ``to_host`` count is checked on exit.  Tensors that
    never live on the device do not count: on a CUDA device, every CPU
    tensor; on the CPU, where the fit's own tensors are CPU tensors too,
    each tensor drawn from a host ``torch.Generator`` inside the block (the
    epoch permutations, ``core/training.default_perm``).

``cuda_sync_events()``
    On the card, the second check: ``torch.cuda.set_sync_debug_mode`` over
    the block, each synchronising operation attributed to the op that
    makes it and counted as a device->host copy, a blocking host->device
    copy or another sync.

``audit_dtypes``
    Every leaf of a tree (nested dicts, lists, tuples and NamedTuples of
    tensors or arrays) in an allowed dtype family.

``compile_counter``
    Graph compilations inside the block.  The port is eager, so the count
    is held at zero: it reads ``torch._dynamo``'s compiled frames when that
    module has been imported, and nothing compiles without it.

Not thread-safe and not reentrant (the interpositions are process-global
state): guards are test and measurement instrumentation, not production
wrappers.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import warnings
import weakref
from contextlib import contextmanager
from typing import Iterable, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode


class GuardError(AssertionError):
    """Base class: a runtime contract was violated."""


class CompileBudgetError(GuardError):
    pass


class HostSyncError(GuardError):
    pass


class DtypeAuditError(GuardError):
    pass


# ---------------------------------------------------------------------------
# compile counting
# ---------------------------------------------------------------------------

def _compiled_frames() -> int:
    dynamo = sys.modules.get("torch._dynamo.utils")
    if dynamo is None:
        return 0
    return int(dynamo.counters["frames"]["ok"])


class CompileTally:
    def __init__(self, start: int):
        self._start = start

    @property
    def count(self) -> int:
        return _compiled_frames() - self._start


@contextmanager
def compile_counter(budget: Optional[int] = None, *, label: str = ""):
    """Count graph compilations inside the block; with ``budget``, raise
    :class:`CompileBudgetError` on exit if the count exceeds it."""
    tally = CompileTally(_compiled_frames())
    yield tally
    if budget is not None and tally.count > budget:
        raise CompileBudgetError(
            f"{label or 'block'}: {tally.count} graph compilations, budget "
            f"is {budget}: the port runs eager")


# ---------------------------------------------------------------------------
# host-sync accounting
# ---------------------------------------------------------------------------

class SyncTally:
    def __init__(self):
        self.copies = 0


_SYNC_ATTRS = ("item", "tolist", "numpy", "cpu", "__float__", "__int__",
               "__bool__", "__index__", "__array__")
_NUMPY_FUNCS = ("asarray", "array", "ascontiguousarray", "asanyarray")
_state = threading.local()
_tallies: list = []


def to_host(t: torch.Tensor) -> np.ndarray:
    """The sanctioned device->host copy: ``t``'s values as a numpy array,
    counted by the innermost open ``no_host_sync`` block."""
    if _tallies:
        _tallies[-1].copies += 1
    _state.sanctioned = True
    try:
        return t.detach().cpu().numpy()
    finally:
        _state.sanctioned = False


class _HostDraws(TorchFunctionMode):
    """Record each tensor drawn from a host ``torch.Generator`` (by id,
    with a weak reference: a set of tensors would compare them with the
    elementwise ``==``)."""

    def __init__(self):
        super().__init__()
        self.seen: dict = {}

    def __contains__(self, t: torch.Tensor) -> bool:
        ref = self.seen.get(id(t))
        return ref is not None and ref() is t

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        gen = kwargs.get("generator")
        if isinstance(out, torch.Tensor) and isinstance(
                gen, torch.Generator) and gen.device.type == "cpu":
            self.seen[id(out)] = weakref.ref(out)
        return out


@contextmanager
def no_host_sync(allowed: int = 0, *, label: str = "", device="cuda"):
    """Forbid device->host conversions inside the block except ``allowed``
    ``to_host`` calls (module docstring).  Yields the tally, whose
    ``copies`` counts the ``to_host`` calls."""
    dev = torch.device(device)
    host_draws = _HostDraws() if dev.type == "cpu" else ()
    tally = SyncTally()

    def on_device(t) -> bool:
        if dev.type == "cpu":
            return t.device.type == "cpu" and t not in host_draws
        return t.device.type == dev.type

    def blocked(name, orig):
        def wrapper(self, *a, **k):
            if getattr(_state, "sanctioned", False) or not on_device(self):
                return orig(self, *a, **k)
            raise HostSyncError(
                f"{label or 'block'}: implicit device->host sync via "
                f"Tensor.{name}: route host reads through one counted "
                f"guards.to_host")
        return wrapper

    def np_guard(fname, orig_fn):
        def wrapper(a, *args, **kwargs):
            if isinstance(a, torch.Tensor) and on_device(a) and \
                    not getattr(_state, "sanctioned", False):
                raise HostSyncError(
                    f"{label or 'block'}: implicit device->host sync via "
                    f"np.{fname}(Tensor): route host reads through one "
                    f"counted guards.to_host")
            return orig_fn(a, *args, **kwargs)
        return wrapper

    own = {name for name in _SYNC_ATTRS if name in vars(torch.Tensor)}
    patched = {name: getattr(torch.Tensor, name) for name in _SYNC_ATTRS}
    np_patched = {f: getattr(np, f) for f in _NUMPY_FUNCS}
    for name, orig in patched.items():
        setattr(torch.Tensor, name, blocked(name, orig))
    for fname, orig_fn in np_patched.items():
        setattr(np, fname, np_guard(fname, orig_fn))
    _tallies.append(tally)
    try:
        if dev.type == "cpu":
            with host_draws:
                yield tally
        else:
            yield tally
    finally:
        _tallies.remove(tally)
        for name, orig in patched.items():
            if name in own:
                setattr(torch.Tensor, name, orig)
            else:        # inherited from the C base class
                delattr(torch.Tensor, name)
        for fname, orig_fn in np_patched.items():
            setattr(np, fname, orig_fn)
    if tally.copies > allowed:
        raise HostSyncError(
            f"{label or 'block'}: {tally.copies} to_host copies, budget is "
            f"{allowed}")


SYNC_ERROR = "synchronizing CUDA operation"


class SyncEvents:
    def __init__(self):
        self.d2h = 0          # device->host copies (.cpu(), .item(), ...)
        self.h2d = 0          # blocking host->device copies
        self.other = 0        # stream or device synchronisations
        self.ops: dict = {}   # "op (kind)" -> count

    def as_dict(self) -> dict:
        return {"d2h": self.d2h, "h2d": self.h2d, "other": self.other,
                "ops": dict(self.ops)}


def _direction(func, args, kwargs) -> str:
    """``d2h``, ``h2d`` or ``other`` for a synchronising op."""
    name = str(func)
    if "_local_scalar_dense" in name:
        return "d2h"
    if "_to_copy" in name:
        src = args[0].device.type
        dst = torch.device(kwargs.get("device") or args[0].device).type
    elif "copy_" in name:
        dst, src = args[0].device.type, args[1].device.type
    else:
        return "other"
    return {("cuda", "cpu"): "d2h", ("cpu", "cuda"): "h2d"}.get(
        (src, dst), "other")


class _SyncAttribution(TorchDispatchMode):
    """With the sync debug mode at "error", a synchronising op raises
    before it syncs or copies (``c10::cuda::warn_or_error_on_sync``): count
    it by direction, then run it once with the mode off."""

    def __init__(self, events: SyncEvents):
        super().__init__()
        self.events = events

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if SYNC_ERROR not in str(e):
                raise
        kind = _direction(func, args, kwargs)
        setattr(self.events, kind, getattr(self.events, kind) + 1)
        key = f"{func} ({kind})"
        self.events.ops[key] = self.events.ops.get(key, 0) + 1
        torch.cuda.set_sync_debug_mode("default")
        try:
            return func(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("error")


@contextmanager
def cuda_sync_events():
    """``torch.cuda.set_sync_debug_mode`` over the block, each
    synchronising op counted by kind (``SyncEvents``).  A sync that no
    dispatched op makes (``torch.cuda.synchronize()``) raises."""
    events = SyncEvents()
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():     # "a prototype feature", once
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("error")
    try:
        with _SyncAttribution(events):
            yield events
    finally:
        torch.cuda.set_sync_debug_mode(before)


# ---------------------------------------------------------------------------
# dtype audit
# ---------------------------------------------------------------------------

ENGINE_DTYPES = frozenset({"float32", "int32", "uint32", "bool"})


def _dtype_name(leaf) -> Optional[str]:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).rsplit(".", 1)[-1]
    dtype = getattr(leaf, "dtype", None)
    return None if dtype is None else np.dtype(dtype).name


def _leaves_with_path(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def audit_dtypes(tree, allowed: Iterable[str] = ENGINE_DTYPES, *,
                 label: str = "") -> None:
    """Raise :class:`DtypeAuditError` if a leaf of ``tree`` has a dtype
    outside ``allowed`` (by default the engine's float32/int32 family); a
    Python scalar leaf fails too."""
    allowed = frozenset(allowed)
    bad = []
    for path, leaf in _leaves_with_path(tree):
        name = _dtype_name(leaf)
        if name is None:
            bad.append((path, type(leaf).__name__ + " (python scalar)"))
        elif name not in allowed:
            bad.append((path, name))
    if bad:
        listing = ", ".join(f"{p or '<root>'}: {d}" for p, d in bad[:8])
        raise DtypeAuditError(
            f"{label or 'tree'}: {len(bad)} leaves outside "
            f"{sorted(allowed)}: {listing}")


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------

BUDGETS_FILENAME = "ANALYSIS_budgets.json"


def repo_root() -> str:
    """Nearest ancestor of this file holding ``ANALYSIS_budgets.json``."""
    d = os.path.dirname(os.path.abspath(__file__))
    while True:
        if os.path.exists(os.path.join(d, BUDGETS_FILENAME)):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            raise FileNotFoundError(
                f"{BUDGETS_FILENAME} not found above {__file__}")
        d = parent


def load_budgets() -> dict:
    with open(os.path.join(repo_root(), BUDGETS_FILENAME)) as fh:
        return json.load(fh)
