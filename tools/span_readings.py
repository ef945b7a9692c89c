"""Readings of the program's own spans (``repro_torch.spans``) in the
benchmark's cells, taken the way a ``--trace 1`` run takes its trace.

    python3 tools/span_readings.py [--cells W ...] [--seed N] [--seconds S]
        [--stretches K] [--src DIR] [--out FILE]

For each cell: the weights and the traffic from ``--seed``, the runner's
set-up, a short untimed window, then ``--stretches`` pairs of traced
stretches (``bench.harness.trace.record``: one on the device alone, one
with the host's operations), each stretch's wall on the host clock.  It
prints one JSON line a cell (and writes them to ``--out``):

* ``profiler_enabled``: what ``torch.autograd._profiler_enabled()`` reads
  under the device-only profile and under the one with the host's
  operations;
* ``walls_s``: each stretch's wall, by kind (the tracing-on cost, to be
  compared between two trees in one call);
* ``per_layer``: every per-layer metric of the cell, read by its reader
  from the first pair, as a ``--trace 1`` run reads it;
* ``clock``: whether every span of each device-only stretch ended inside
  its window and none of the stretch with the host's operations did; the
  first call's start and the last call's end against the device's window
  (``window_edges_us``); how far each span's start in ``records()`` lies
  from the profiler's own record of it (median and largest, µs);
* ``untraced_ms_per_call`` (the window's median call wall, no profiler),
  ``device_ms_per_call``, ``spans_per_call``, ``span_cost_us`` (one span
  and one bare ``record_function`` under each profile, on this host),
  ``off_us_per_call`` (the spans of a call with no profiler running) and
  ``launch_us`` (one small kernel launch under each profile);
* ``idle_gaps``: the ten longest idle gaps of each first stretch, each
  with the innermost host operation at its middle (as the benchmark's
  breakdown names it; none on the device alone) and the innermost program
  span; ``idle_ms_per_call_by_span``: every gap of each first stretch,
  summed by that span;
* ``queued_ms_after_enqueue`` (prefill): for each call of the first
  device-only stretch, how long the card still ran that call's work after
  its ``serve.prefill_step`` span ended: near the card's whole time for
  about a thousand launches where the host waited on a full launch queue.

``--src`` runs another tree's program (a parent checkout's ``src``) under
this tree's benchmark; a program without spans reports walls and metrics
alone.  Needs a CUDA card; ``--device cpu --smoke`` rehearses it at the
configurations' smoke sizes with both stretches traced with the host.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("internlm2-1.8b.decode-32k", "internlm2-1.8b.prefill-conv-8k")


def _spans():
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans


def _profiles(on_card: bool) -> dict:
    """The profiles compared: none, the device-only one (on the card) and
    the one with the host's operations, by their activities."""
    from torch.profiler import ProfilerActivity
    if not on_card:
        return {"none": None, "cpu_and_cuda": [ProfilerActivity.CPU]}
    return {"none": None, "cuda_only": [ProfilerActivity.CUDA],
            "cpu_and_cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}


def _under(acts, fn):
    """``fn()`` under a profile of ``acts`` (None: no profiler)."""
    from torch.profiler import profile
    if acts is None:
        return fn()
    with profile(activities=acts):
        return fn()


def _enabled_under_profiles(on_card: bool) -> dict:
    import torch
    return {mode: _under(acts, torch.autograd._profiler_enabled)
            for mode, acts in _profiles(on_card).items()}


def _us_each(fn, n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n * 1e6


def _span_cost_us(spans, on_card: bool, n: int = 20_000) -> dict:
    """µs for one empty span, one bare ``record_function`` and one
    ``_RecordFunctionFast`` (where this PyTorch has it) under each
    profile, the loop included."""
    import torch
    from torch.profiler import record_function
    makers = {"span": spans.span, "record_function": record_function}
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is not None:
        makers["record_function_fast"] = fast

    def one(make):
        with make("cost"):
            pass
    out = {f"{what}.{mode}": _under(acts, lambda: _us_each(
        lambda: one(make), n))
        for mode, acts in _profiles(on_card).items()
        for what, make in makers.items()}
    spans.clear()
    return out


def _launch_us(on_card: bool, n: int = 20_000) -> dict:
    """µs for one small kernel launch (``add_`` on 16 floats) under each
    profile, the launches waited for: what a profile adds to every launch
    of a traced call."""
    import torch
    if not on_card:
        return {}
    x = torch.zeros(16, device="cuda")

    def launches():
        torch.cuda.synchronize()
        us = _us_each(lambda: x.add_(1.0), n)
        torch.cuda.synchronize()
        return us
    return {mode: _under(acts, launches)
            for mode, acts in _profiles(on_card).items()}


def _starts_vs_profiler(recs: list, host: list, clock: dict) -> list:
    """|start in records() - the profiler's start| (ns) for every span,
    paired by name in start order; a name the two count differently is
    counted in ``clock["unpaired_names"]`` and left out."""
    theirs: dict = {}
    for name, s, _ in host:
        theirs.setdefault(name, []).append(s)
    mine: dict = {}
    for r in recs:
        mine.setdefault(r.name, []).append(r.start_ns)
    out = []
    for name, starts in mine.items():
        other = sorted(theirs.get(name, []))
        if len(other) != len(starts):
            clock["unpaired_names"] = clock.get("unpaired_names", 0) + 1
            continue
        out += [abs(a - b) for a, b in zip(sorted(starts), other)]
    return out


def _innermost(recs: list, starts: list, t: int) -> str:
    """The latest-started span of ``recs`` (by start, ``starts`` theirs)
    open at ``t``."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if recs[i].end_ns >= t:
            return recs[i].name
    return "(no span)"


def _gap_list(view) -> list:
    """(ns, start, end) of every stretch of the window with no device
    operation running."""
    gaps, cur = [], view.window_ns[0]
    for _, s, e in sorted(view.ops, key=lambda o: o[1]):
        if s > cur:
            gaps.append((s - cur, cur, s))
        cur = max(cur, e)
    if view.window_ns[1] > cur:
        gaps.append((view.window_ns[1] - cur, cur, view.window_ns[1]))
    return gaps


def _gaps(view, recs: list, top: int = 10) -> list:
    starts = [h[1] for h in view.host]
    rec_starts = [r.start_ns for r in recs]
    out = []
    for length, s, e in sorted(_gap_list(view), reverse=True)[:top]:
        mid = (s + e) // 2
        op = "host (no op)"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if view.host[i][2] >= mid:
                op = view.host[i][0]
                break
        out.append({"ms": length / 1e6, "host_op": op[:80],
                    "span": _innermost(recs, rec_starts, mid)})
    return out


def _idle_by_span(view, recs: list) -> dict:
    """Every idle gap of the stretch, in ms a call, by the innermost
    program span at its middle."""
    out: dict = {}
    starts = [r.start_ns for r in recs]
    for length, s, e in _gap_list(view):
        name = _innermost(recs, starts, (s + e) // 2)
        out[name] = out.get(name, 0.0) + length / 1e6 / len(view.calls)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _queued_after_enqueue(recs: list, ops: list) -> list:
    calls = sorted((r for r in recs if r.name == "serve.prefill_step"),
                   key=lambda r: r.start_ns)
    out = []
    for i, r in enumerate(calls):
        nxt = calls[i + 1].start_ns if i + 1 < len(calls) else None
        ends = [e for _, s, e in ops if s >= r.start_ns
                and (nxt is None or s < nxt)]
        if ends:
            out.append(max(0, max(ends) - r.end_ns) / 1e6)
    return out


def reading(workload: str, seed: int, seconds: float, stretches: int,
            device: str, smoke: bool) -> dict:
    import torch
    from bench.harness import spec, trace
    from bench.harness.drive import RUNNERS
    from bench.harness.run_cell import _reader
    from bench.harness.weights import draw
    on_card = device == "cuda"
    spans = _spans()
    cell = spec.load_cell(workload, smoke=smoke)
    cfg = spec.model_config(cell)
    weights = draw(cfg, seed, device)
    drv = RUNNERS[cell.traffic["mode"]](cfg, weights, cell.traffic, seed,
                                        device)
    drv.setup()
    drv.window(seconds)
    walls_ms = [(t1 - t0) * 1e3 for t0, t1, *_ in
                getattr(drv, "steps", [])] or \
        [(c[3] - c[2]) * 1e3 for c in getattr(drv, "calls", [])]
    res = {"workload": workload, "seed": seed,
           "profiler_enabled": _enabled_under_profiles(on_card),
           "program_has_spans": spans is not None,
           "untraced_ms_per_call": statistics.median(walls_ms)}
    if on_card:
        res["card"] = torch.cuda.get_device_name(0)
    walls = {"device_only": [], "with_host": []}
    clock = {"device_only_spans": 0, "device_only_outside": 0,
             "with_host_spans": 0, "with_host_inside": 0}
    offsets, first = [], {}
    for k in range(stretches):
        for kind in ("device_only", "with_host"):
            def timed():
                t0 = time.perf_counter()
                calls = drv.stretch()
                walls[kind].append(time.perf_counter() - t0)
                return calls
            if spans is not None:
                spans.clear()
            calls, ops, host, span, _ = trace.record(
                timed, device_only=on_card and kind == "device_only")
            recs = spans.records() if spans is not None else []
            # the device-side ranges of the spans are no operation (the
            # harness keeps them where the profiler's events lack an
            # activity type)
            names = {r.name for r in recs}
            ops = [o for o in ops if o[0] not in names]
            view = trace.View(cfg=cfg, calls=calls, ops=ops, host=host,
                              window_ns=span,
                              window_calls=drv.window_calls(),
                              window_s=drv.window_s)
            if not calls:
                raise RuntimeError(f"{workload}: the stretch made no call")
            if k == 0:
                first[kind] = (view, recs)
                if kind == "device_only":
                    res["per_layer"] = {}
                    for m in cell.per_layer:
                        v = _reader(m["name"])(view)
                        if v is not None:
                            res["per_layer"][m["name"]] = v
                    res["device_ms_per_call"] = \
                        view.busy_s() * 1e3 / len(calls)
                    res["spans_per_call"] = len(recs) / len(calls)
            inside = [span[0] <= r.end_ns <= span[1] for r in recs]
            if kind == "device_only":
                dev_window = span
                clock["device_only_spans"] += len(recs)
                clock["device_only_outside"] += inside.count(False)
                clock.setdefault("outside_us", []).extend(
                    [r.name, (r.end_ns - span[0]) / 1e3]
                    for r, ok in zip(recs, inside) if not ok)
                roots = [r for r in recs if r.parent == -1]
                if roots:   # host-side edges against the device's window
                    clock.setdefault("window_edges_us", []).append(
                        [(roots[0].start_ns - span[0]) / 1e3,
                         (span[1] - roots[-1].end_ns) / 1e3])
            else:
                clock["with_host_spans"] += len(recs)
                offsets += _starts_vs_profiler(recs, host, clock)
                if on_card:     # against the device-only stretch before it
                    clock["with_host_inside"] += sum(
                        dev_window[0] <= r.end_ns <= dev_window[1]
                        for r in recs)
    res["walls_s"] = walls
    if spans is not None:
        if offsets:
            clock["start_offset_us_median"] = statistics.median(offsets) / 1e3
            clock["start_offset_us_max"] = max(offsets) / 1e3
            clock["start_offsets_over_50us"] = sum(o > 50_000
                                                   for o in offsets)
        res["clock"] = clock
        res["span_cost_us"] = _span_cost_us(spans, on_card)
        res["off_us_per_call"] = (res["span_cost_us"]["span.none"]
                                  * res["spans_per_call"])
        res["idle_gaps"] = {kind: _gaps(v, r)
                            for kind, (v, r) in first.items()}
        res["idle_ms_per_call_by_span"] = {
            kind: _idle_by_span(v, r)
            for kind, (v, r) in first.items()}
        if cell.traffic["mode"] == "prefill":
            view, recs = first["device_only"]
            res["queued_ms_after_enqueue"] = _queued_after_enqueue(
                recs, view.ops)
    res["launch_us"] = _launch_us(on_card)
    drv.release()
    del weights, drv
    if on_card:
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=2**31 + 4051)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--stretches", type=int, default=3)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("span_readings: no CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(2)
    lines = []
    for w in args.cells:
        res = reading(w, args.seed, args.seconds, args.stretches,
                      args.device, args.smoke)
        res["src"] = args.src
        lines.append(json.dumps(res))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
