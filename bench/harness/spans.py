"""The arithmetic of the readers of the program's own spans
(``repro_torch.spans``): host time by span name over the calls whose
outermost span lies inside the traced window ``view.window_ns``.  The
spans take their times from the profiler's clock, so the window selects
the device-only stretch's calls alone: the stretch traced with the host's
operations starts seconds after it, and the measured window runs with no
profiler, which records no span.  A call is taken by the middle of its
outermost span: at a stretch's ends the card's timestamps and the host's
were seen to disagree by up to a few milliseconds, less than half a call.

Each reader returns None where the program has no spans (an older
program) or no call lies in the window."""
from __future__ import annotations


def in_window(view) -> list:
    """The program's closed span records, with None in place of those
    whose outermost span's middle does not lie inside the traced window
    (indices, and so parents, kept)."""
    try:
        from repro_torch import spans
    except ImportError:
        return []
    lo, hi = view.window_ns
    recs = spans.records()
    root = []
    for r in recs:     # a parent comes before its children
        root.append(root[r.parent] if r.parent >= 0 else r)
    return [r if r.end_ns >= 0 and top.end_ns >= 0
            and lo <= (top.start_ns + top.end_ns) // 2 <= hi else None
            for r, top in zip(recs, root)]


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def _under(recs, r, name: str) -> bool:
    """Whether ``r`` is a ``name`` span or lies inside one."""
    while r is not None:
        if r.name == name:
            return True
        r = recs[r.parent] if r.parent >= 0 else None
    return False


def host_ms_per_step(view, name: str = "engine.dispatch"):
    """Host ms a decode step in ``name`` spans that lie inside an
    ``engine.dispatch`` (the enqueue of the step's launches; refills,
    which ``engine.fill_slot`` holds outside it, are left out), summed
    over the window's ``engine.step`` spans and divided by their number."""
    recs = in_window(view)
    steps = sum(1 for r in recs if r is not None and r.name == "engine.step")
    mine = [_ms(r) for r in recs if r is not None and r.name == name
            and _under(recs, r, "engine.dispatch")]
    if not steps or not mine:
        return None
    return sum(mine) / steps


def host_ms_per_call(view, name: str = "serve.prefill_step"):
    """The mean host ms of the window's ``name`` spans."""
    mine = [_ms(r) for r in in_window(view) if r is not None
            and r.name == name]
    return sum(mine) / len(mine) if mine else None
