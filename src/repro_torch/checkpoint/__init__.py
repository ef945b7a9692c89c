"""Flat-path ``.npz`` checkpoints, format-compatible with
``repro.checkpoint.ckpt``."""
