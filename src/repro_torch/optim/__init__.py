"""Optimizers of the port: the paper's Adam (``adam.paper_adam``)."""
