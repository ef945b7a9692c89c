"""The LM training step (``loop.make_train_step``)."""
