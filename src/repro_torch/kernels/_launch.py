"""Checks shared by the CUDA launchers: every tensor a kernel reads or
writes is checked here for device, dtype, shape and contiguity before its
pointer crosses into C.  Also the launch geometry two kernels share: the
card's SM count and the thread-block cluster size that fills it."""
from __future__ import annotations

import functools

import torch


def check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
          device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on_error(rc: int, what: str, error_string) -> None:
    if rc != 0:
        msg = error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_size(units: int, device: torch.device, per_sm: int) -> int:
    """The smallest thread-block cluster size C in {1, 2, 4, 8} for which
    ``units`` clusters of C blocks give at least ``per_sm`` blocks on every
    SM of ``device``; 8 where none does."""
    want = per_sm * sm_count(device.index if device.index is not None
                             else torch.cuda.current_device())
    return next((c for c in (1, 2, 4) if units * c >= want), 8)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary (a view into a larger tensor may not), for kernels that read
    16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
