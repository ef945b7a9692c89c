"""The unified experiment result type (``results.RunResult``)."""
