"""Rule registry.  Each rule module exposes ``RULE`` (id), ``TITLE``,
``HINT`` and ``check(project) -> list[Finding]``; the driver in
:mod:`repro_torch.analysis.lint` runs them in id order.

Two of the reference's seven rules keep a meaning for an eager PyTorch
package: R001 (host calls in per-step code) and R007 (dtype hygiene).
R002 (traced branch), R003 (jit static args), R004 (donation), R005 (PRNG
key reuse) and R006 (Pallas grid) speak of ``jit``, traced values, donated
buffers, ``jax.random`` keys and ``pallas_call`` grids, none of which the
port has.
"""
from __future__ import annotations

from repro_torch.analysis.rules import r001_host_calls, r007_dtype_hygiene

ALL_RULES = [r001_host_calls, r007_dtype_hygiene]

RULE_DOCS = {m.RULE: (m.TITLE, m.HINT) for m in ALL_RULES}

__all__ = ["ALL_RULES", "RULE_DOCS"]
