"""flash_attention's share of its roofline over the traced calls, in %
(``bench/rooflines/flash_attention.py``)."""
from bench.harness.readers import roofline


def read(view):
    return roofline(view, "flash_attention")
