"""PyTorch/CUDA port of the APC-VFL reproduction in ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``repro_torch/serve/vfl.py`` is the counterpart of ``repro/serve/vfl.py``)
and imports nothing of it.  Weights keep the reference's ``(d_in, d_out)``
layout and checkpoints its flat-path ``.npz`` format, so bundles cross
between the two packages.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; on a
host without a card such a call raises (``resolve_device``) instead of
carrying on on the CPU.  Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

# fp32 means IEEE fp32 here, as in the reference kernels: no TF32 anywhere
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a host that has
    no card (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but no CUDA card is "
            f"available on this host; pass device='cpu' for the plain path")
    return dev
