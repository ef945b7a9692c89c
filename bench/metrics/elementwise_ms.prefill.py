"""The card's time a prefill call in PyTorch's own kernels (neither the
port's nor GEMMs), in ms (device trace)."""
from bench.harness.readers import elementwise_ms as read  # noqa: F401
