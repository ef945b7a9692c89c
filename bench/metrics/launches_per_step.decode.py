"""Kernel launches an Engine.step (device trace): what a CUDA graph per
decode step would cut to a few."""
from bench.harness.readers import launches_per_call as read  # noqa: F401
