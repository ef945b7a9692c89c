"""CUDA launchers for the Eq. 5 row loss and its backward
(``csrc/distill_loss.cu``).

Counterpart of ``repro.kernels.distill_loss`` (``_kernel`` and
``_bwd_kernel``): per row, ``mean_d (x - x_hat)^2 + lam * mask *
mean_m |z - z_t|^p`` (p = 2 for ``"mse"``, 1 for ``"mae"``), and its
closed-form gradients.  Rows are 2-D here; the public wrappers in
``kernels.ops`` fold a lane axis into the rows and dispatch CPU tensors
to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KINDS = {"mse": 0, "mae": 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("distill_loss")
    lib.distill_fwd.argtypes = [_P] * 6 + [_I] * 3 + [_F, _I, _P]
    lib.distill_fwd.restype = _I
    lib.distill_bwd.argtypes = [_P] * 9 + [_I] * 3 + [_F, _I, _P]
    lib.distill_bwd.restype = _I
    lib.distill_error_string.argtypes = [_I]
    lib.distill_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, x_hat, z, z_t, mask, kind):
    if kind not in KINDS:
        raise ValueError(f"distill_loss: unknown kind {kind!r}")
    if x.dim() != 2 or z.dim() != 2:
        raise ValueError(f"distill_loss: x and z must be 2-D rows, got "
                         f"{tuple(x.shape)} and {tuple(z.shape)}")
    (N, D), M = x.shape, z.shape[1]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"distill_loss needs CUDA tensors, got {dev}")
    f32 = torch.float32
    for name, t, shape in (("x", x, (N, D)), ("x_hat", x_hat, (N, D)),
                           ("z", z, (N, M)), ("z_t", z_t, (N, M)),
                           ("mask", mask, (N,))):
        _launch.check(name, t, shape, f32, dev)
    return N, D, M, dev


def launch_fwd(x, x_hat, z, z_t, mask, *, lam: float, kind: str):
    """One launch: x, x_hat (N, D), z, z_t (N, M), mask (N,) contiguous
    fp32 CUDA tensors.  Returns the (N,) row losses."""
    N, D, M, dev = _check(x, x_hat, z, z_t, mask, kind)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.distill_fwd(x.data_ptr(), x_hat.data_ptr(), z.data_ptr(),
                             z_t.data_ptr(), mask.data_ptr(), out.data_ptr(),
                             N, D, M, float(lam), KINDS[kind],
                             torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "distill_fwd launch", lib.distill_error_string)
    return out


def launch_bwd(g, x, x_hat, z, z_t, mask, *, lam: float, kind: str):
    """One launch for row cotangents ``g`` (N,): returns ``(dx, dz,
    dmask)``; the gradients of ``x_hat`` and ``z_t`` are their
    negatives."""
    N, D, M, dev = _check(x, x_hat, z, z_t, mask, kind)
    _launch.check("g", g, (N,), torch.float32, dev)
    dx = torch.empty((N, D), dtype=torch.float32, device=dev)
    dz = torch.empty((N, M), dtype=torch.float32, device=dev)
    dm = torch.empty((N,), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.distill_bwd(g.data_ptr(), x.data_ptr(), x_hat.data_ptr(),
                             z.data_ptr(), z_t.data_ptr(), mask.data_ptr(),
                             dx.data_ptr(), dz.data_ptr(), dm.data_ptr(),
                             N, D, M, float(lam), KINDS[kind],
                             torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "distill_bwd launch", lib.distill_error_string)
    return dx, dz, dm
