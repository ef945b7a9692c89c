"""Run a declarative ``ExperimentSpec`` end to end from the command line;
the port of ``repro.launch.experiment``.

Reads a spec JSON file (``repro_torch.experiments.specs``), expands the
aligned x K x seed grid, runs every registered method on every cell on
the chosen device, and writes ``--out`` with the spec echo, one tidy
record per run and the wall time.  The device's name is printed on a line
of its own.

Run:  PYTHONPATH=src python -m repro_torch.launch.experiment SPEC.json \\
          [--out results.json] [--quiet] [--device cuda]
      PYTHONPATH=src python -m repro_torch.launch.experiment --smoke \\
          --device cpu

``--smoke`` runs a tiny built-in spec (bcw, 120 aligned rows, 2 epochs,
the six core methods).

A spec with ``devices`` (e.g. ``{"lane": 2}``) needs that many ranks:
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.experiment \
        SPEC.json --device cpu
Under ``torchrun`` each rank joins the world (gloo on the CPU, NCCL with
one card a rank, ``cuda:LOCAL_RANK``), runs the whole sweep, and only
rank 0 prints records and writes ``--out``.  A spec with
``{"lane": 1}`` runs without a launcher (a world of one).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.experiments import ExperimentSpec, MethodSpec, sweep, tidy


def smoke_spec() -> ExperimentSpec:
    """Tiny spec proving every core method runs through one sweep()."""
    return ExperimentSpec(
        name="smoke",
        dataset="bcw",
        aligned=(120,),
        seeds=(0,),
        methods=(MethodSpec("local"),
                 MethodSpec("apcvfl"),
                 MethodSpec("apcvfl", label="ablation",
                            params={"ablation": True}),
                 MethodSpec("splitnn", params={"test_size": 40}),
                 MethodSpec("vfedtrans"),
                 MethodSpec("apcvfl_aligned_only",
                            params={"test_size": 40})),
        overrides={"max_epochs": 2},
    )


def _summary_table(records: list) -> str:
    cols = ["method", "dataset", "n_aligned", "n_parties", "seed",
            "accuracy", "f1_macro", "rounds", "comm_mb"]
    lines = [" ".join(f"{c:>12}" for c in cols)]
    for r in records:
        cells = []
        for c in cols:
            v = r.get(c)
            cells.append(f"{v:>12.4f}" if isinstance(v, float)
                         else f"{str(v):>12}")
        lines.append(" ".join(cells))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run a declarative ExperimentSpec end-to-end")
    ap.add_argument("spec", nargs="?", default=None,
                    help="path to an ExperimentSpec JSON file")
    ap.add_argument("--smoke", action="store_true",
                    help="run the tiny built-in smoke spec instead")
    ap.add_argument("--out", default="results.json",
                    help="output path (default: results.json)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-run progress lines")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    if args.smoke == (args.spec is not None):
        ap.error("give exactly one of SPEC.json or --smoke")
    if args.smoke:
        spec = smoke_spec()
    else:
        with open(args.spec) as fh:
            spec = ExperimentSpec.from_json(fh.read())
    device = resolve_device(args.device)
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if launched:                      # torchrun: join its world
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        return _run(args, spec, device,
                    lead=not launched or dist.get_rank() == 0)
    finally:
        if launched:
            dist.destroy_process_group()


def _run(args, spec: ExperimentSpec, device: torch.device,
         lead: bool) -> int:
    say = print if lead else (lambda *a, **k: None)
    say(f"device: {torch.cuda.get_device_name(device)}"
        if device.type == "cuda" else f"device: {device}")

    t0 = time.time()
    results = sweep(spec, progress=None if args.quiet else say,
                    device=device)
    if not lead:
        return 0
    records = tidy(results)
    payload = {"spec": spec.to_dict(), "records": records,
               "elapsed_s": round(time.time() - t0, 1)}
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(f"\n=== {spec.name}: {len(records)} runs in "
          f"{payload['elapsed_s']}s -> {args.out} ===")
    print(_summary_table(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
