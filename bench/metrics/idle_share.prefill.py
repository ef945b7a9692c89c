"""The share of the traced prefill calls' span with the device idle, in %."""
from bench.harness.readers import idle_share as read  # noqa: F401
