"""The benchmark's own arithmetic over samples (it reads none of the
program's): percentiles with linear interpolation between closest ranks,
as numpy's default."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values``."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    r = (len(xs) - 1) * q / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)

