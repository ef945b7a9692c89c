"""Optimizers of the port: the paper's Adam (``adam.paper_adam``), the LM
trainer's ``adam.AdamW`` and its schedules (``schedule``)."""
