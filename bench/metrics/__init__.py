"""One reader a per-layer metric, in a file named after the metric
(``<name>.py``), loaded by path: ``read(view)`` returns the metric's value
from a traced run (``harness.trace.View``), or None where there is nothing
to read."""
