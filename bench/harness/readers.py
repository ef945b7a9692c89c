"""The arithmetic the per-layer readers in ``bench/metrics/`` share.  A
reader returns None where its trace holds nothing to read, and the run
then leaves the metric out of its line."""
from __future__ import annotations

from bench.harness import flops, peaks, trace


def launches_per_call(view):
    """Kernel launches on the device a traced call (copies not counted)."""
    if not view.calls or not view.kernels():
        return None
    return len(view.kernels()) / len(view.calls)


def elementwise_ms(view):
    """The card's time a call in kernels that are neither the port's nor
    GEMMs: PyTorch's elementwise, reduction, indexing and copy kernels."""
    if not view.calls or not view.kernels():
        return None
    port = trace.port_names()
    ns = sum(e - s for n, s, e in view.kernels()
             if trace.kind(n, port) == "other")
    return ns / 1e6 / len(view.calls)


def mfu(view):
    """Model flops of every call of the measured window over the bf16 peak
    times the window (host clock), in %."""
    if not view.window_calls or view.window_s <= 0:
        return None
    total = sum(flops.call_flops(view.cfg, c) for c in view.window_calls)
    return 100.0 * total / (peaks.PEAK_FLOPS["bfloat16"] * view.window_s)


def tokens_per_s(view):
    """Tokens generated in the measured window (one a session a decode
    step) over the window (host clock)."""
    steps = [c for c in view.window_calls if c["mode"] == "decode"]
    if not steps or view.window_s <= 0:
        return None
    return sum(c["B"] for c in steps) / view.window_s


def roofline(view, kernel: str):
    """A kernel's share of its roofline in %: the least time the chip could
    take for the traced calls' work (counted from their shapes) over the
    time its launches took on the device."""
    mod = trace.roofline(kernel)
    names = tuple(n.lower() for n in mod.NAMES)
    ns = sum(e - s for n, s, e in view.kernels()
             if any(p in n.lower() for p in names))
    if ns <= 0:
        return None
    work = [mod.work(view.cfg, c) for c in view.calls]
    f = sum(w[0] for w in work)
    b = sum(w[1] for w in work)
    if f <= 0 and b <= 0:
        return None
    return 100.0 * peaks.bound_s(f, b, mod.DTYPE) / (ns / 1e9)


def idle_share(view):
    """The share of the traced span in which no operation ran on the
    device, in %."""
    if view.traced_s <= 0 or not view.ops:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.traced_s)
