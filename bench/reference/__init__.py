"""The plain fp32 reference that decides a run's ``correct``
(``model.logits_at``), and its lower-precision control (the same code with
``precision="fp8"``)."""
