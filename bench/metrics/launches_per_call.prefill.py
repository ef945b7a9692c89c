"""Kernel launches a prefill_step call (device trace): what fusing or
capturing the prefill would cut."""
from bench.harness.readers import launches_per_call as read  # noqa: F401
