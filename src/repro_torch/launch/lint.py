"""Lint CLI of the PyTorch port: static analysis of ``src/repro_torch``
against the committed baseline (rules R001 and R007,
``repro_torch/analysis/rules``).

    python -m repro_torch.launch.lint                    # table
    python -m repro_torch.launch.lint --json             # machine-readable
    python -m repro_torch.launch.lint --diff             # changed vs main
    python -m repro_torch.launch.lint --baseline-update  # freeze findings

Exit 0 when no finding lies outside the baseline; 1 otherwise.  The
linter reads the sources with ``ast`` and never runs them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional, Set

from repro_torch.analysis.lint import (apply_baseline, build_index,
                                       load_baseline, run_rules,
                                       write_baseline)
from repro_torch.analysis.rules import RULE_DOCS

DEFAULT_TARGET = "src/repro_torch"
DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"


def find_repo_root(start: Optional[str] = None) -> str:
    """The nearest ancestor holding ``src/repro_torch`` (a checkout may have
    no ``.git``), else ``start``."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(d, DEFAULT_TARGET)):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start or os.getcwd())
        d = parent


def changed_files(root: str, base: str = "main") -> Optional[Set[str]]:
    """Repo-relative .py files changed vs ``base`` (committed, staged and
    untracked).  None when git can't answer: lint all."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", base, "--", "*.py"],
            cwd=root, capture_output=True, text=True, check=True).stdout
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard", "*.py"],
            cwd=root, capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return {line.strip() for line in (diff + untracked).splitlines()
            if line.strip()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lint",
        description="AST lint of the PyTorch port's per-step contracts "
                    "(rules R001 and R007)")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_TARGET})")
    ap.add_argument("--root", default=None,
                    help="repo root for relative paths (default: the "
                         "nearest ancestor holding src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report everything, ignore the baseline")
    ap.add_argument("--baseline-update", action="store_true",
                    help="rewrite the baseline to the current findings "
                         "(keeps surviving justifications)")
    ap.add_argument("--diff", action="store_true",
                    help="report only findings in files changed vs "
                         "--diff-base (the whole tree is still indexed)")
    ap.add_argument("--diff-base", default="main",
                    help="git ref --diff compares against (default: main)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    args = ap.parse_args(argv)

    root = args.root or find_repo_root()
    paths = args.paths or [DEFAULT_TARGET]
    baseline_path = os.path.join(root, args.baseline or DEFAULT_BASELINE)

    report_files: Optional[Set[str]] = None
    if args.diff:
        report_files = changed_files(root, args.diff_base)
        if report_files is not None and not report_files:
            print(f"lint --diff: no .py files changed vs {args.diff_base}; "
                  f"nothing to do")
            return 0

    project = build_index(paths, root)
    raw = run_rules(project, report_files)

    if args.baseline_update:
        write_baseline(baseline_path, raw)
        print(f"baseline updated: {len(raw)} findings frozen in "
              f"{os.path.relpath(baseline_path, root)}; fill in any "
              f"'TODO: justify or fix' entries")
        return 0

    findings = raw if args.no_baseline else \
        apply_baseline(raw, load_baseline(baseline_path))

    if args.as_json:
        print(json.dumps({
            "target": paths, "total": len(findings),
            "baselined": len(raw) - len(findings),
            "findings": [f.to_dict() for f in findings]}, indent=1))
        return 1 if findings else 0

    if not findings:
        suppressed = len(raw) - len(findings)
        note = f" ({suppressed} baselined)" if suppressed else ""
        print(f"lint: clean{note}, {len(project.modules)} modules indexed")
        return 0

    by_rule: dict = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
        sym = f" [{f.symbol}]" if f.symbol else ""
        print(f"{f.file}:{f.line}: {f.rule}{sym} {f.message}")
        if f.code:
            print(f"    > {f.code}")
        if f.hint:
            print(f"    hint: {f.hint}")
    print()
    for rule in sorted(by_rule):
        title, _ = RULE_DOCS.get(rule, ("?", ""))
        print(f"  {rule}  {title}: {len(by_rule[rule])}")
    print(f"lint: {len(findings)} finding(s) not covered by the baseline "
          f"({os.path.relpath(baseline_path, root)}); fix them or justify "
          f"them with --baseline-update")
    return 1


if __name__ == "__main__":
    sys.exit(main())
