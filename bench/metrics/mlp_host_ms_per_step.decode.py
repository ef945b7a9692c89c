"""Host ms a decode step spends enqueueing the MLP: the program's
``block.mlp`` spans inside its ``engine.dispatch`` spans, over the
window's ``engine.step`` spans."""
from bench.harness.spans import host_ms_per_step


def read(view):
    return host_ms_per_step(view, "block.mlp")
