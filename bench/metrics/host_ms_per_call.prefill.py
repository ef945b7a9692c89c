"""Host ms a ``prefill_step`` call takes to enqueue its launches (the
program's ``serve.prefill_step`` spans in the traced window, their mean),
against the card's time a call; it includes any wait on a full launch
queue."""
from bench.harness.spans import host_ms_per_call as read  # noqa: F401
