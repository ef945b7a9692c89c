"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json``; everything a cell
needs is found by name under this folder: its configuration
(``configs/``), its traffic mix (``traffic/``), its correctness limits
(``limits/``), each per-layer metric's reader (``metrics/``) and each
kernel's operation and byte counts (``rooflines/``).  The plain fp32
reference that decides ``correct`` is in ``reference/``.
"""
