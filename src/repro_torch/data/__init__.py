"""Synthetic datasets and the vertical partitioner (numpy copies of
``repro.data``)."""
