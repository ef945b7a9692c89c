"""The prefill window's model flops over the bf16 peak times its wall, in %."""
from bench.harness.readers import mfu as read  # noqa: F401
