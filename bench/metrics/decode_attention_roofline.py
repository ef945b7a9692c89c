"""decode_attention's share of its roofline over the traced calls, in %
(``bench/rooflines/decode_attention.py``)."""
from bench.harness.readers import roofline


def read(view):
    return roofline(view, "decode_attention")
