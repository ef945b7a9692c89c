"""Synthetic datasets, the vertical partitioner and the LM token stream
(numpy copies of ``repro.data``)."""
