"""Named host-time spans at the port's serving and model boundaries.

``span(name)`` is a context manager.  With no profiler running it is one
shared no-op: it enters no ``record_function``, reads no clock and records
nothing.  Under ``torch.profiler`` it enters ``record_function(name)``, so
the span shows in the profiler's trace over the operations it covers, and
keeps a record ``(name, start_ns, end_ns, parent)`` in a ring of the last
``CAPACITY`` spans.  Both times come from ``time.time_ns()``, the clock of
the profiler's own events; ``parent`` is the index in ``records()`` of the
span open around it, or -1.  ``timed(name)`` is the same span, but reads
the clock in either case, for a caller that keeps the time itself
(``Engine.step_ms`` and ``prefill_ms``).

Spans nest within one thread; the ring is the process's.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

CAPACITY = 65_536


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int         # -1 while the span is open
    parent: int         # index in records() of the enclosing span, or -1


_ring: list = [None] * CAPACITY     # [name, start, end, parent's number]
_count = 0                          # spans started in this process
_first = 0                          # the number of the first since clear()
_open: list = []                    # numbers of the open spans, innermost last
_NULL = contextlib.nullcontext()
_enabled = torch.autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "start_ns", "end_ns", "_rf", "_rec")

    def __init__(self, name: str, on: bool):
        self.name = name
        self._rf = torch.profiler.record_function(name) if on else None

    def __enter__(self):
        global _count
        self.start_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__enter__()
            # the profiler stamps the range's start inside the enter: the
            # middle of the enter lies nearer that stamp than either end
            self.start_ns = (self.start_ns + time.time_ns()) // 2
            self._rec = [self.name, self.start_ns, -1,
                         _open[-1] if _open else -1]
            _ring[_count % CAPACITY] = self._rec
            _open.append(_count)
            _count += 1
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        if self._rf is not None:
            _open.pop()
            self._rec[2] = self.end_ns
        return False


def span(name: str):
    """A span named ``name``: recorded only while a profiler runs."""
    if not _enabled():
        return _NULL
    return _Span(name, True)


def timed(name: str) -> _Span:
    """``span(name)`` that also reads the clock with no profiler running:
    its ``start_ns`` and ``end_ns`` (``time.time_ns()``) are set either
    way."""
    return _Span(name, _enabled())


def records() -> list:
    """The spans kept since ``clear()``, in the order they started."""
    lo = max(_first, _count - CAPACITY)
    out = []
    for n in range(lo, _count):
        name, start, end, parent = _ring[n % CAPACITY]
        out.append(Record(name, start, end,
                          parent - lo if parent >= lo else -1))
    return out


def dropped() -> int:
    """Spans started since ``clear()`` that the ring no longer holds."""
    return max(0, _count - _first - CAPACITY)


def clear() -> None:
    """Forget every span kept so far (open ones close unrecorded)."""
    global _first
    _first = _count
