"""Tokens generated in the decode window over its wall (host clock): the
window's rate, unbounded, beside ``itl_p95_ms``."""
from bench.harness.readers import tokens_per_s as read  # noqa: F401
