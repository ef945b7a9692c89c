"""Robustness & privacy: hardened exchange defenses (``defense``), the
attack registry (``attacks``) and seeded fault plans (``faults``), all
keyed on APC-VFL's single latent exchange; the port of
``repro.robustness`` (the serving half of the fault plans runs in
``serve.runtime.ServingRuntime.run(faults=)``)."""
from repro_torch.robustness import attacks, defense, faults  # noqa: F401
from repro_torch.robustness.attacks import (  # noqa: F401
    AttackReport, AttackSurface, available_attacks, build_surface,
    build_surfaces, get_attack, leakage_profile, register_attack,
    run_attack)
from repro_torch.robustness.defense import (  # noqa: F401
    Chain, ClippedNoise, ExchangeTransform, Quantize, dp_frontier,
    make_transform, run_apcvfl_dp, run_apcvfl_dp_replicated)
from repro_torch.robustness.faults import (  # noqa: F401
    DriftExchange, FaultEvent, FaultPlan, StaleExchange,
    run_faulted_apcvfl)
