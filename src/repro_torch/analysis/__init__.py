"""The port's static analysis and runtime guards.

* :mod:`repro_torch.analysis.lint`: an AST lint pass over the package with
  the two rules that keep a meaning for an eager PyTorch package (R001 host
  calls in per-step code, R007 dtype hygiene), gated by a committed
  baseline (``analysis/baseline.json``).  Pure stdlib (``ast``): it
  reads the sources and never runs them.
* :mod:`repro_torch.analysis.guards`: runtime context managers that prove
  the sync, dtype and compile contracts against ``ANALYSIS_budgets.json``
  (imported on its own).

CLI: ``python -m repro_torch.launch.lint`` (``--json``, ``--diff``,
``--baseline-update``).
"""
from __future__ import annotations

from repro_torch.analysis.lint import (Finding, lint_paths, lint_source,
                                       load_baseline, write_baseline)

__all__ = ["Finding", "lint_paths", "lint_source", "load_baseline",
           "write_baseline"]
