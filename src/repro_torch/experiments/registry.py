"""Method registry: one uniform signature for every VFL method; the
port's own instance of ``repro.experiments.registry``.

A registered runner has the signature::

    runner(scenario, spec: MethodSpec, *, seed: int, device) -> RunResult

where ``scenario`` is a built ``VFLScenario`` (2 parties) or
``VFLScenarioK`` (K > 2, only for runners registered with
``supports_multiparty=True``), ``spec.params`` carries the method's
hyperparameter overrides and ``device`` is where it runs.  The built-in
adapters in ``repro_torch.experiments.methods`` wrap the
``repro_torch.core`` and ``repro_torch.robustness`` entry points; they
are loaded lazily on first lookup so importing this module stays cheap
and cycle-free.
"""
from __future__ import annotations

import dataclasses
import inspect
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

# the port's own placement and parity keywords: never spec params, so a
# method's ``accepts`` is the reference's set
PORT_KEYWORDS = frozenset({"seed", "device", "init_params", "perm_fn",
                           "draw"})


@dataclass(frozen=True)
class MethodEntry:
    name: str
    fn: Callable
    supports_multiparty: bool = False
    accepts: Optional[frozenset] = None   # param names; None = accepts any
    # replica-lane runner: (scenarios, spec, *, seeds, device) ->
    # List[RunResult], one result per seed in order
    replicated_fn: Optional[Callable] = None

    @property
    def supports_replicas(self) -> bool:
        """True when the method can run a whole seed-replica group (grid
        cells identical up to seed) through one replica-lane dispatch."""
        return self.replicated_fn is not None


_REGISTRY: Dict[str, MethodEntry] = {}


def _kwarg_names(fn: Callable) -> frozenset:
    """Keyword parameter names of a ``run_*`` entry point, minus the
    scenario positional and ``PORT_KEYWORDS``."""
    params = list(inspect.signature(fn).parameters.values())
    return frozenset(p.name for p in params[1:]
                     if p.name not in PORT_KEYWORDS)


def register_method(name: str, *, supports_multiparty: bool = False,
                    params_from: Optional[Callable] = None):
    """Decorator: register ``fn`` as the runner for ``name``.

    ``params_from`` names the underlying ``run_*`` entry point whose
    keyword signature defines the spec params this method accepts;
    ``sweep`` validates specs against it before any training runs.  Omit
    it for runners that ignore params (``local``).  Re-registering a name
    raises."""
    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"method {name!r} is already registered")
        accepts = _kwarg_names(params_from) if params_from else None
        _REGISTRY[name] = MethodEntry(name, fn, supports_multiparty, accepts)
        return fn
    return deco


def register_replicas(name: str):
    """Decorator: attach a replica-lane runner to the already-registered
    method ``name``::

        fn(scenarios, spec: MethodSpec, *, seeds, device) -> List[RunResult]

    ``scenarios`` is one built scenario per seed (a sweep group: grid
    cells identical up to seed) and the return order matches ``seeds``;
    each per-seed result must match the sequential path within
    replica-parity tolerance."""
    def deco(fn: Callable) -> Callable:
        _ensure_builtins()     # a built-in name must resolve here too
        entry = _REGISTRY.get(name)
        if entry is None:
            raise KeyError(f"register_replicas: method {name!r} is not "
                           f"registered yet")
        if entry.replicated_fn is not None:
            raise ValueError(f"method {name!r} already has a replicated "
                             f"runner")
        _REGISTRY[name] = dataclasses.replace(entry, replicated_fn=fn)
        return fn
    return deco


def _ensure_builtins() -> None:
    # the import registers the built-in adapters as a side effect
    from repro_torch.experiments import methods  # noqa: F401


def available_methods() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def get_method(name: str) -> MethodEntry:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown method {name!r}; registered methods: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def run_method(name: str, scenario, spec, *, seed: int = 0,
               device="cuda"):
    """Dispatch one run through the registry (convenience wrapper)."""
    return get_method(name).fn(scenario, spec, seed=seed, device=device)
