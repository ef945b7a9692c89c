"""Declarative experiment API: specs, method registry, sweeps; the port
of ``repro.experiments``.

Public surface::

    from repro_torch.experiments import (ExperimentSpec, MethodSpec,
                                         ScenarioSpec, RunResult,
                                         register_method, register_replicas,
                                         get_method, available_methods,
                                         run_method, sweep, tidy,
                                         build_scenario)

Only the pure-data modules (``specs``, ``results``) load eagerly; the
registry, the built-in method adapters and the sweep engine, which pull
in the ``repro_torch.core`` stack, resolve lazily on first attribute
access (the core modules themselves import
``repro_torch.experiments.results``).
"""
from repro_torch.experiments.results import RunResult            # noqa: F401
from repro_torch.experiments.specs import (  # noqa: F401
    ExperimentSpec, MethodSpec, ScenarioSpec)

_LAZY = {
    "register_method": "registry",
    "register_replicas": "registry",
    "get_method": "registry",
    "available_methods": "registry",
    "run_method": "registry",
    "sweep": "sweeps",
    "tidy": "sweeps",
    "build_scenario": "sweeps",
}

__all__ = ["ExperimentSpec", "MethodSpec", "ScenarioSpec", "RunResult",
           *_LAZY]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value          # cache: next access skips __getattr__
    return value
