"""Host ms a decode step spends enqueueing attention: the program's
``block.attention`` spans inside its ``engine.dispatch`` spans (every
layer's projections, RoPE, cache write, kernel and output projection),
over the window's ``engine.step`` spans."""
from bench.harness.spans import host_ms_per_step


def read(view):
    return host_ms_per_step(view, "block.attention")
