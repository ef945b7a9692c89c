"""The LM model zoo: the dense decoder family so far (``model`` dispatches
by family)."""
