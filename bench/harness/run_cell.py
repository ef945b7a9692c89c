"""One run of one cell: set up, warm up, measure, optionally trace, check,
print.

The order after the window: the end-to-end metrics; the device's peak
memory; with ``--trace 1`` a bounded stretch traced on the device alone,
read by the per-layer readers, and a second one traced with the host's
operations, which names the idle gaps of the breakdown; the program's
state freed; the reference over the sample (``check.gaps``).  ``emit``
then checks that no JAX module was loaded in the process and prints the
compared numbers on standard error and the result line, last on standard
output.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

import torch

from bench.harness import check, spec, trace
from bench.harness.drive import RUNNERS
from bench.harness.env import BENCH, SetupError, forbidden_loaded
from bench.harness.weights import draw


def _reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def _device_info(device, cell) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        device="cuda", smoke: bool = False, control: str = None,
        t_start: float = None) -> tuple:
    """Run the cell; returns (the result line's object, what the run
    reports besides on standard error), or raises ``SetupError`` /
    ``RuntimeError``.  ``emit`` prints them."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(workload, smoke=smoke)
    cfg = spec.model_config(cell)
    mode = cell.traffic["mode"]
    if mode not in RUNNERS:
        raise SetupError(f"traffic mode {mode!r} has no runner")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    weights = draw(cfg, seed, device)
    drv = RUNNERS[mode](cfg, weights, cell.traffic, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    drv.window(seconds)

    metrics = {}
    values = drv.end_to_end()
    values["setup_s"] = (setup_s, "s")
    wanted = cell.end_to_end if not traced else []
    for m in wanted:
        if m["name"] not in values:
            raise RuntimeError(f"{workload}: no reading of {m['name']}")
        metrics[m["name"]] = {"value": values[m["name"]][0],
                              "unit": m["unit"]}
    device_info = _device_info(device, cell)
    result = {"correct": False, "attempted": drv.attempted(),
              "failed": 0, "metrics": metrics, "device": device_info}

    if traced:
        on_card = torch.device(device).type == "cuda"
        calls, ops, host, span, kinds = trace.record(drv.stretch,
                                                     device_only=on_card)
        view = trace.View(cfg=cfg, calls=calls, ops=ops, host=host,
                          window_ns=span, window_calls=drv.window_calls(),
                          window_s=drv.window_s)
        named = None
        if on_card:     # a second stretch with the host's operations
            _, ops2, host2, span2, _ = trace.record(drv.stretch)
            named = trace.View(cfg=cfg, calls=[], ops=ops2, host=host2,
                               window_ns=span2)
        for m in cell.per_layer:
            v = _reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = view.busy_s()
        device_info["window_s"] = view.traced_s
        result["breakdown"] = trace.breakdown(view, named)
        if named is not None:
            kinds["host_traced_window_s"] = named.traced_s

    missing = drv.missing()
    items = drv.check_items()
    drv.release()
    got = check.gaps(weights, cell.model_fields, items, control=control)
    limits = cell.limits
    checks = {"gap_max": {"value": got["gap_max"],
                          "limit": limits["gap_max"]},
              "missing": {"value": missing, "limit": limits["missing"]}}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values()) and got["tokens_checked"] > 0
    result["correct"] = bool(ok)
    result["failed"] = missing
    info = {"tokens_checked": got["tokens_checked"],
            "reference_s": got["seconds"]}
    if traced:
        info["device_records"] = kinds
    if control:
        info["control"] = control
    result["checks"] = checks
    return result, info


def emit(result: dict, info: dict, out=None, err=None) -> None:
    """Print a run: ``info`` and then each compared number with its limit
    as the last lines of standard error, the result as the last line of
    standard output.  Raises, printing nothing, where a module of JAX or
    of the JAX package is loaded in this process."""
    out = out or sys.stdout
    err = err or sys.stderr
    bad = forbidden_loaded()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: "
                           f"{bad}")
    print(f"info {json.dumps(info)}", file=err)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
