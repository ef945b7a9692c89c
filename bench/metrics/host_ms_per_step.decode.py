"""Host ms an Engine.step takes to enqueue its decode: the program's
``engine.dispatch`` spans over its ``engine.step`` spans in the traced
window, against the card's time a step."""
from bench.harness.spans import host_ms_per_step as read  # noqa: F401
