"""The general machinery of the benchmark: the run of one cell, the runners
of the traffic modes, the trace reduction and the correctness check."""
