"""Scenario building and grid execution for declarative experiments; the
port of ``repro.experiments.sweeps``.

``sweep(spec, device=...)`` expands the spec's aligned x K x seed grid,
builds each scenario ONCE and runs every method on it (so per-cell PSI
inputs, data partitions and label vectors are identical across methods),
and returns a flat list of uniform ``RunResult`` records.
``tidy(results)`` flattens them into JSON-ready rows.

Replica-lane dispatch: grid cells identical up to seed (seeds are
innermost, so they are consecutive) form a *seed group*.  A method whose
registry entry carries a replicated runner runs the whole group as ONE
call, S seeds of every protocol stage as stacked lanes of one
``training.train_lanes`` call.  Methods without one, single-seed groups
and ``replicate=False`` specs take the sequential per-seed path.  Result
order and values are the same either way.

Validation is eager: unknown method names, K > 2 grids holding 2-party
methods, duplicate labels, unknown params and bad ``devices`` raise
BEFORE any scenario is built or any model trained.  A spec's ``devices``
builds one lane mesh up front (``launch.mesh.make_lane_mesh``), which
raises on a world too small before any run; it is threaded into the
replicated dispatches only, as ``mesh=``.  Every rank of a mesh runs the
whole sweep and returns every result.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Iterator, List, Optional

from repro_torch.data.synthetic import make_dataset
from repro_torch.data.vertical import make_scenario
from repro_torch.experiments.registry import get_method
from repro_torch.experiments.results import RunResult
from repro_torch.experiments.specs import ExperimentSpec, ScenarioSpec


def build_scenario(sspec: ScenarioSpec, *, _ds_cache: Optional[dict] = None):
    """Materialize one grid cell: a ``VFLScenario`` for 2 parties or a
    ``VFLScenarioK`` for K > 2 (host arrays; the runners move them to
    their device).  ``_ds_cache`` reuses generated datasets across cells
    of the same sweep."""
    cache_key = (sspec.dataset, sspec.seed)
    if _ds_cache is not None and cache_key in _ds_cache:
        ds = _ds_cache[cache_key]
    else:
        ds = make_dataset(sspec.dataset, seed=sspec.seed)
        if _ds_cache is not None:
            _ds_cache[cache_key] = ds
    n_aligned = sspec.resolve_aligned(len(ds.x))
    if sspec.n_parties == 2:
        return make_scenario(ds, n_active_features=sspec.n_active_features,
                             n_aligned=n_aligned, seed=sspec.seed)
    from repro_torch.core.multiparty import make_scenario_k
    return make_scenario_k(ds, n_parties=sspec.n_parties,
                           n_active_features=sspec.n_active_features,
                           n_aligned=n_aligned, seed=sspec.seed)


def _validate(spec: ExperimentSpec) -> None:
    if not spec.methods:
        raise ValueError(f"ExperimentSpec {spec.name!r} has no methods")
    if any(k < 2 for k in spec.n_parties):
        raise ValueError(f"n_parties must all be >= 2, got "
                         f"{list(spec.n_parties)}")
    unknown_axes = set(spec.devices) - {"lane", "data"}
    if unknown_axes:
        raise ValueError(f"devices: unknown mesh axes "
                         f"{sorted(unknown_axes)}; valid axes are "
                         f"['data', 'lane']")
    for ax, n in spec.devices.items():
        if not (isinstance(n, int) and n >= 1):
            raise ValueError(f"devices[{ax!r}] must be a positive int, "
                             f"got {n!r}")
    max_k = max(spec.n_parties, default=2)
    seen_labels = set()
    for m in spec.methods:
        entry = get_method(m.method)       # raises on unknown names
        if max_k > 2 and not entry.supports_multiparty:
            raise ValueError(
                f"method {m.method!r} supports only 2-party scenarios but "
                f"the grid includes n_parties={max_k}")
        if m.row_label in seen_labels:
            raise ValueError(
                f"duplicate method label {m.row_label!r}: give each "
                f"MethodSpec variant a distinct label= so result rows "
                f"stay distinguishable")
        seen_labels.add(m.row_label)
        if entry.accepts is not None:
            unknown = set(spec.overrides) | set(m.params)
            unknown -= entry.accepts
            if unknown:
                raise ValueError(
                    f"method {m.row_label!r} does not accept params "
                    f"{sorted(unknown)}; accepted: "
                    f"{sorted(entry.accepts)}")


def _seed_groups(spec: ExperimentSpec) -> Iterator[List[ScenarioSpec]]:
    """Yield runs of consecutive grid cells identical up to seed.  The
    grid expansion keeps seeds innermost, so each aligned x K cell's
    seeds arrive as one contiguous group."""
    group: List[ScenarioSpec] = []
    for sspec in spec.scenarios():
        if group and replace(sspec, seed=group[0].seed) != group[0]:
            yield group
            group = []
        group.append(sspec)
    if group:
        yield group


def sweep(spec: ExperimentSpec, *,
          progress: Optional[Callable[[str], None]] = None,
          device="cuda") -> List[RunResult]:
    """Run the whole experiment on ``device``; one ``RunResult`` per
    (cell, method).

    Every result's ``scenario`` dict carries the resolved grid
    coordinates and its ``method`` the spec's row label, so the output is
    self-describing.  Seed groups dispatch through replica-lane runners
    where available (module docstring); results keep the reference's
    order (cell-major, methods inside each cell) however they were
    computed.

    ``spec.devices`` builds a lane mesh up front (one mesh for the whole
    sweep; ``make_lane_mesh`` raises early on a rank shortfall) and
    threads it into every replicated dispatch as ``mesh=``; sequential
    dispatches ignore it."""
    _validate(spec)
    mesh = None
    if spec.devices:
        from repro_torch.launch.mesh import make_lane_mesh
        mesh = make_lane_mesh(**spec.devices)
    ds_cache: dict = {}
    results: List[RunResult] = []
    for group in _seed_groups(spec):
        scenarios = [build_scenario(s, _ds_cache=ds_cache) for s in group]
        seeds = [s.seed for s in group]
        coords = [{
            "dataset": s.dataset,
            "n_aligned": sc.n_aligned,
            "n_parties": s.n_parties,
            "n_active_features": s.n_active_features,
        } for s, sc in zip(group, scenarios)]
        per_method: List[List[RunResult]] = []
        for m in spec.methods:
            entry = get_method(m.method)
            mspec = replace(m, params={**spec.overrides, **m.params})
            if (spec.replicate and entry.supports_replicas
                    and len(group) > 1):
                # mesh only when requested: registered runners that
                # take none keep their signature working untouched
                extra = {} if mesh is None else {"mesh": mesh}
                rs = entry.replicated_fn(scenarios, mspec, seeds=seeds,
                                         device=device, **extra)
                if len(rs) != len(group):
                    raise RuntimeError(
                        f"replicated runner for {m.method!r} returned "
                        f"{len(rs)} results for {len(group)} seeds")
            else:
                rs = [entry.fn(sc, mspec, seed=s, device=device)
                      for sc, s in zip(scenarios, seeds)]
            per_method.append(rs)
        for j, sspec in enumerate(group):
            for m, rs in zip(spec.methods, per_method):
                r = rs[j]
                r.method = m.row_label
                r.seed = sspec.seed
                r.scenario = dict(coords[j])
                results.append(r)
                if progress is not None:
                    progress(
                        f"{spec.name}: {m.row_label} "
                        f"al={coords[j]['n_aligned']} "
                        f"K={coords[j]['n_parties']} "
                        f"seed={sspec.seed} -> "
                        + " ".join(f"{k}={v:.4f}"
                                   for k, v in r.metrics.items()))
    return results


def tidy(results: List[RunResult]) -> List[dict]:
    """Flatten results into tidy JSON-ready rows (one per run)."""
    return [r.to_record() for r in results]
