"""CUDA launcher for the weighted softmax-CE probe step (``csrc/probe.cu``).

Counterpart of ``repro.kernels.probe`` (``_probe_kernel``): for K fold
lanes of probes sharing ``x`` and ``y``, the weighted CE loss, ``dW`` and
``db`` from pre-normalized row weights, without the L2 term.  One call of
the C entry point makes two launches for each group of lanes (more than
one group only where K * C passes 64 or shared memory runs short): the
kernel, which reads x once for the group's lanes and leaves one partial
(dW, db, loss) per block of rows, nb * (d * K * C + K * C + K) floats of
scratch for nb <= 128 blocks, and a second launch that sums the partials
in a fixed order, so ``launch`` returns its outputs as they are.  The
public wrapper, which normalizes the weights, adds L2 and dispatches CPU
tensors to the plain version, is ``kernels.ops.probe_grad_step``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("probe")
    lib.probe.argtypes = [_P] * 9 + [_I] * 4 + [_P]
    lib.probe.restype = _I
    lib.probe_group_lanes.argtypes = [_I, _I]
    lib.probe_group_lanes.restype = _I
    lib.probe_scratch_floats.argtypes = [_I] * 4
    lib.probe_scratch_floats.restype = ctypes.c_longlong
    lib.probe_error_string.argtypes = [_I]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def launch(w, b, x, y, rwn):
    """One call: w (K, d, C), b (K, C), x (n, d), y (n,) int32, rwn
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
    if lib.probe_group_lanes(d, C) == 0:
        raise ValueError(f"probe: d={d}, C={C} need more shared memory "
                         f"than a block holds")
    if n == 0:
        raise ValueError("probe.launch: no rows")
    loss = torch.empty((K,), dtype=f32, device=dev)
    dw = torch.empty((K, d, C), dtype=f32, device=dev)
    db = torch.empty((K, C), dtype=f32, device=dev)
    part = torch.empty((lib.probe_scratch_floats(n, d, C, K),), dtype=f32,
                       device=dev)
    with torch.cuda.device(dev):
        rc = lib.probe(x.data_ptr(), y.data_ptr(), rwn.data_ptr(),
                       w.data_ptr(), b.data_ptr(), loss.data_ptr(),
                       dw.data_ptr(), db.data_ptr(), part.data_ptr(), K, n,
                       d, C, torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "probe launch", lib.probe_error_string)
    return loss, dw, db
