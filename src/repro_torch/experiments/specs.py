"""Declarative experiment specs: frozen, JSON-round-trippable dataclasses;
a copy of ``repro.experiments.specs`` (the port keeps its own).

An ``ExperimentSpec`` names a dataset, a scenario grid (aligned rows x
party counts x seeds), and the methods to run on every grid cell.  It is
pure data (building scenarios and running methods lives in
``repro_torch.experiments.sweeps``), so this module imports neither torch
nor the model code and a spec file can be validated without touching a
device.

Example (the whole public API)::

    spec = ExperimentSpec(
        name="bcw-alignment-sweep",
        dataset="bcw",
        aligned=(250, 150, 100),
        seeds=(0, 1, 2),
        methods=(MethodSpec("local"),
                 MethodSpec("apcvfl"),
                 MethodSpec("apcvfl", label="ablation",
                            params={"ablation": True}),
                 MethodSpec("vfedtrans")),
        overrides={"max_epochs": 60},
    )
    results = sweep(spec, device="cuda")   # uniform RunResult records

``aligned`` entries > 1 are absolute row counts; entries <= 1.0 are
fractions of the dataset's rows (resolved per dataset at build time).
``overrides`` are hyperparameter kwargs applied to EVERY method (a
method's own ``params`` win on conflict); they must be accepted by each
non-local method in the spec.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field, fields
from typing import Dict, Iterator, Tuple, Union


@dataclass(frozen=True)
class MethodSpec:
    """One method to run: a registry name plus its hyperparameter
    overrides.  ``label`` names the result rows (defaults to ``method``),
    letting one method appear twice with different params."""
    method: str
    params: Dict = field(default_factory=dict)
    label: str = ""

    @property
    def row_label(self) -> str:
        return self.label or self.method

    @classmethod
    def from_dict(cls, d: Union[str, dict]) -> "MethodSpec":
        if isinstance(d, str):              # "local" sugar
            return cls(method=d)
        _check_keys(cls, d)
        return cls(**d)


@dataclass(frozen=True)
class ScenarioSpec:
    """One fully-resolved grid cell: the arguments to build a vertical
    scenario (2-party ``VFLScenario`` or K-party ``VFLScenarioK``)."""
    dataset: str
    n_aligned: float                     # >1 absolute rows, <=1.0 fraction
    n_parties: int = 2
    n_active_features: int = 5
    seed: int = 0

    def resolve_aligned(self, n_rows: int) -> int:
        if self.n_aligned <= 1.0:
            return max(int(round(self.n_aligned * n_rows)), 1)
        return int(self.n_aligned)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclass(frozen=True)
class ExperimentSpec:
    """The declarative experiment: scenario grid x methods.

    ``replicate=True`` (the default) lets ``sweep()`` batch grid cells
    that are identical up to seed through a method's replica-lane runner
    (one lane-stacked dispatch for all seeds); methods without one, and
    ``replicate=False`` specs, run the sequential per-seed path.  Either
    way results arrive in the same order with the same values up to
    replica-parity tolerance.

    ``devices`` requests mesh-sharded replicated dispatch: a dict of mesh
    axis sizes, e.g. ``{"lane": 4}`` or ``{"lane": 2, "data": 2}``
    (``lane`` splits the replica-lane axis across ranks, ``data``
    reserves ranks for row sharding).  ``sweep()`` builds the mesh with
    ``repro_torch.launch.mesh.make_lane_mesh``, raising before any run
    when the world (``torchrun --nproc-per-node N``) has a different
    number of ranks.  Empty (the default) keeps every dispatch on one
    rank."""
    name: str
    dataset: str = "bcw"
    methods: Tuple[MethodSpec, ...] = ()
    aligned: Tuple[float, ...] = (250,)
    n_parties: Tuple[int, ...] = (2,)
    n_active_features: int = 5
    seeds: Tuple[int, ...] = (0,)
    overrides: Dict = field(default_factory=dict)
    replicate: bool = True
    devices: Dict = field(default_factory=dict)

    def scenarios(self) -> Iterator[ScenarioSpec]:
        """Expand the aligned x K x seed grid (methods loop inside each
        cell so built scenarios are reused across methods)."""
        for k in self.n_parties:
            for al in self.aligned:
                for seed in self.seeds:
                    yield ScenarioSpec(
                        dataset=self.dataset, n_aligned=al, n_parties=k,
                        n_active_features=self.n_active_features, seed=seed)

    # --- JSON round-trip ---------------------------------------------------

    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        _check_keys(cls, d)
        d = dict(d)
        for key in ("aligned", "n_parties", "seeds"):
            if key in d:
                d[key] = tuple(d[key])
        d["methods"] = tuple(MethodSpec.from_dict(m)
                             for m in d.get("methods", ()))
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))


def _check_keys(cls, d: dict) -> None:
    known = {f.name for f in fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown keys {sorted(unknown)}; "
                         f"valid keys are {sorted(known)}")
