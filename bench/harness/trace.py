"""The trace of a bounded stretch of steady calls, and its reduction.

``record`` runs a runner's stretch under ``torch.profiler`` (CPU and CUDA
activities) inside one ``bench.window`` range, and reads the profiler's
raw events (a prefill makes tens of thousands; the event tree is too
slow): the device operations in the window, the host operations, and the
window's span on the same clock.  ``View`` is what the per-layer readers
(``bench/metrics/``) see.

Kernel kinds, as the card's time is split: the port's kernels by the
substrings of their symbols (``rooflines/*.NAMES``), GEMMs by the
cuBLAS / CUTLASS substrings below, copies and sets (``Memcpy``,
``Memset``) apart, and the rest PyTorch's elementwise, reduction and
indexing kernels.
"""
from __future__ import annotations

import bisect
import importlib
import os
from dataclasses import dataclass, field

from bench.harness.env import BENCH

GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma", "nvjet")
WINDOW = "bench.window"
# device-side records that are no operation: the GPU side of the
# benchmark's own ranges, and CUDA's synchronisations
NOT_OPS = ("gpu_user_annotation", "cuda_sync", "overhead")


def _activity(e) -> str:
    try:
        return str(e.activity_type())
    except AttributeError:          # an older profiler
        return "unknown"


def kernel_files() -> list:
    return sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, "rooflines"))
                  if f.endswith(".py") and not f.startswith("_"))


def roofline(kernel: str):
    return importlib.import_module(f"bench.rooflines.{kernel}")


def port_names() -> tuple:
    return tuple(n for k in kernel_files() for n in roofline(k).NAMES)


def kind(name: str, port: tuple) -> str:
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "copy"
    if any(p in low for p in port):
        return "port"
    if any(g in low for g in GEMM_NAMES):
        return "gemm"
    return "other"


@dataclass
class View:
    """What a per-layer reader sees of a traced run."""
    cfg: object                 # the program's ModelConfig
    calls: list                 # the traced calls (``rooflines`` format)
    ops: list                   # device operations: (name, start_ns, end_ns)
    host: list = field(default_factory=list)   # host ops, by start
    window_ns: tuple = (0, 0)
    window_calls: list = field(default_factory=list)  # the measured window
    window_s: float = 0.0       # the measured window's length (host clock)

    @property
    def traced_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def kernels(self) -> list:
        return [o for o in self.ops if kind(o[0], ()) != "copy"]

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.ops]) / 1e9


def union_ns(spans) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def record(stretch, device_only: bool = False):
    """Run ``stretch()`` (which returns the calls it made) under the
    profiler; returns (calls, device ops, host ops, window span in ns,
    the device records counted by activity).

    With ``device_only`` the profiler records the device alone, which adds
    little host time to a call (recording the host's operations as well
    slows a host-paced decode step by ~50%): the window is then the span
    from a one-element marker kernel enqueued before the first call to one
    enqueued after the last.  Otherwise the host's operations are recorded
    too, for naming idle gaps, and the window is the ``bench.window``
    range."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [] if device_only else [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        marker = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            if device_only:
                marker.fill_(1.0)
            calls = stretch()
            if device_only:
                marker.fill_(2.0)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    dev, host, span, kinds = [], [], None, {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            act = _activity(e)
            kinds[act] = kinds.get(act, 0) + 1
            if act not in NOT_OPS and not e.name().startswith("bench."):
                dev.append((e.name(), s, t))
        elif e.name() == WINDOW:
            span = (s, t)
        else:
            host.append((e.name(), s, t))
    if device_only:
        dev.sort(key=lambda o: o[1])
        if len(dev) < 2:
            raise RuntimeError("the profiler recorded no device operation")
        span = (dev[0][1], dev[-1][2])
        dev = dev[1:-1]
    if span is None:
        raise RuntimeError("the profiler recorded no bench.window range")
    dev = [(n, max(s, span[0]), min(t, span[1])) for n, s, t in dev
           if t > span[0] and s < span[1]]
    host.sort(key=lambda h: h[1])
    return calls, dev, host, span, kinds


def breakdown(view: View, named: View = None, top: int = 10) -> dict:
    """The device operations of ``view`` that took most time, and the
    longest idle gaps of ``named`` (a stretch traced with the host's
    operations; default ``view``), each named by the innermost host
    operation running at its middle."""
    by_name: dict = {}
    for n, s, e in view.ops:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    view = named or view
    gaps, cur = [], view.window_ns[0]
    for _, s, e in sorted(view.ops, key=lambda o: o[1]):
        if s > cur:
            gaps.append((s - cur, cur, s))
        cur = max(cur, e)
    if view.window_ns[1] > cur:
        gaps.append((view.window_ns[1] - cur, cur, view.window_ns[1]))
    gaps.sort(reverse=True)
    starts = [h[1] for h in view.host]
    idle = []
    for length, s, e in gaps[:top]:
        mid = (s + e) // 2
        name = "host (no op)"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if view.host[i][2] >= mid:      # the latest start covering mid
                name = view.host[i][0]
                break
        idle.append([name[:160], length / 1e9])
    return {"device_ops": [[n[:160], ns / 1e9] for n, ns in ops],
            "idle_gaps": idle}
