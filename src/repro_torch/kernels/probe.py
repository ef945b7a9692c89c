"""CUDA launcher for the weighted softmax-CE probe step (``csrc/probe.cu``).

Counterpart of ``repro.kernels.probe`` (``_probe_kernel``): for K fold
lanes of probes sharing ``x`` and ``y``, the weighted CE loss, ``dW`` and
``db`` from pre-normalized row weights, without the L2 term.  The kernel
writes per-tile partials; ``launch`` sums them over the tile axis.  The
public wrapper, which normalizes the weights, adds L2 and dispatches CPU
tensors to the plain version, is ``kernels.ops.probe_grad_step``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_SMEM = 232448          # bytes of shared memory a Hopper block may hold


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("probe")
    lib.probe.argtypes = [_P] * 8 + [_I] * 4 + [_P]
    lib.probe.restype = _I
    lib.probe_tile_rows.restype = _I
    lib.probe_smem_bytes.argtypes = [_I, _I]
    lib.probe_smem_bytes.restype = ctypes.c_longlong
    lib.probe_error_string.argtypes = [_I]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def launch(w, b, x, y, rwn):
    """One launch: w (K, d, C), b (K, C), x (n, d), y (n,) int32, rwn
    (K, n), contiguous CUDA tensors.  Returns ``(loss (K,), dw (K, d, C),
    db (K, C))``."""
    if w.dim() != 3 or x.dim() != 2:
        raise ValueError(f"probe: w must be (K, d, C) and x (n, d), got "
                         f"{tuple(w.shape)} and {tuple(x.shape)}")
    K, d, C = w.shape
    n = x.shape[0]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"probe.launch needs CUDA tensors, got {dev}")
    f32 = torch.float32
    for name, t, shape, dt in (("w", w, (K, d, C), f32), ("b", b, (K, C), f32),
                               ("x", x, (n, d), f32),
                               ("y", y, (n,), torch.int32),
                               ("rwn", rwn, (K, n), f32)):
        _launch.check(name, t, shape, dt, dev)
    lib = _lib()
    if lib.probe_smem_bytes(d, C) > MAX_SMEM:
        raise ValueError(f"probe: d={d}, C={C} need more shared memory "
                         f"than a block holds")
    if n == 0:
        raise ValueError("probe.launch: no rows")
    T = -(-n // lib.probe_tile_rows())
    lossp = torch.empty((K, T), dtype=f32, device=dev)
    dwp = torch.empty((K, T, d, C), dtype=f32, device=dev)
    dbp = torch.empty((K, T, C), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.probe(x.data_ptr(), y.data_ptr(), rwn.data_ptr(),
                       w.data_ptr(), b.data_ptr(), lossp.data_ptr(),
                       dwp.data_ptr(), dbp.data_ptr(), K, n, d, C,
                       torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "probe launch", lib.probe_error_string)
    return lossp.sum(dim=1), dwp.sum(dim=1), dbp.sum(dim=1)
