"""CUDA launchers for the Eq. 5 row loss and its backward
(``csrc/distill_loss.cu``).

Counterpart of ``repro.kernels.distill_loss`` (``_kernel`` and
``_bwd_kernel``): per row, ``mean_d (x - x_hat)^2 + lam * mask *
mean_m |z - z_t|^p`` (p = 2 for ``"mse"``, 1 for ``"mae"``), and its
closed-form gradients.  ``mean_of=S`` folds in the mean of each S
consecutive rows (a lane's batch) and, in the backward, the mean's
backward, so the loss of a training step is one launch each way.  Rows
are 2-D here; the public wrappers in ``kernels.ops`` fold a lane axis
into the rows and dispatch CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KINDS = {"mse": 0, "mae": 1}
# slots for the block sums of the mean form's cooperative grid: more than
# the blocks an H100 holds at once (132 SMs x 3)
PARTIALS = 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("distill_loss")
    lib.distill_fwd.argtypes = [_P] * 8 + [_I] * 5 + [_F, _I, _P]
    lib.distill_fwd.restype = _I
    lib.distill_bwd.argtypes = [_P] * 11 + [_I] * 4 + [_F, _I, _P]
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


def _check_mean_of(N: int, mean_of: int) -> None:
    if mean_of < 0 or (mean_of and N % mean_of):
        raise ValueError(f"distill_loss: mean_of={mean_of} does not divide "
                         f"{N} rows")


def launch_fwd(x, x_hat, z, z_t, mask, *, lam: float, kind: str,
               mean_of: int = 0):
    """One launch: x, x_hat (N, D), z, z_t (N, M), mask (N,) contiguous
    fp32 CUDA tensors.  Returns the (N,) row losses; with ``mean_of=S``
    (S >= 1 dividing N) ``(rows, means)``, the means (N // S,) of each S
    consecutive rows, summed in a fixed order: on one thread-block cluster
    up to 128 rows a segment, else on a cooperative grid over the card."""
    N, D, M, dev = _check(x, x_hat, z, z_t, mask, kind)
    _check_mean_of(N, mean_of)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    means = part = None
    if mean_of:             # the means, then the grid's block sums
        buf = torch.empty((N // mean_of + PARTIALS,), dtype=torch.float32,
                          device=dev)
        means, part = buf[:N // mean_of], buf[N // mean_of:]
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.distill_fwd(x.data_ptr(), x_hat.data_ptr(), z.data_ptr(),
                             z_t.data_ptr(), mask.data_ptr(), out.data_ptr(),
                             *((None, None) if means is None else
                               (means.data_ptr(), part.data_ptr())),
                             PARTIALS, N, mean_of, D, M, float(lam),
                             KINDS[kind],
                             torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "distill_fwd launch", lib.distill_error_string)
    return out if means is None else (out, means)


def launch_bwd(g, x, x_hat, z, z_t, mask, *, lam: float, kind: str,
               mean_of: int = 0, needs=(True, False, True, False, True)):
    """One launch for row cotangents ``g`` (N,), or with ``mean_of=S`` the
    cotangents (N // S,) of ``launch_fwd``'s means.  ``needs`` flags which
    of the gradients of (x, x_hat, z, z_t, mask) to write (by default the
    TPU kernel's three, dx, dz and dmask); returns all five, None where
    not written.  The gradients of ``x_hat`` and ``z_t`` are ``-dx`` and
    ``-dz``, bit for bit."""
    N, D, M, dev = _check(x, x_hat, z, z_t, mask, kind)
    _check_mean_of(N, mean_of)
    _launch.check("g", g, (N // mean_of if mean_of else N,), torch.float32,
                  dev)
    if len(needs) != 5:
        raise ValueError(f"needs flags the gradients of (x, x_hat, z, z_t, "
                         f"mask), got {needs}")
    widths = (D, D, M, M, None)
    grads = [torch.empty((N, w) if w else (N,), dtype=torch.float32,
                         device=dev) if need else None
             for need, w in zip(needs, widths)]
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.distill_bwd(g.data_ptr(), x.data_ptr(), x_hat.data_ptr(),
                             z.data_ptr(), z_t.data_ptr(), mask.data_ptr(),
                             *(None if t is None else t.data_ptr()
                               for t in grads),
                             N, mean_of, D, M, float(lam), KINDS[kind],
                             torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "distill_bwd launch", lib.distill_error_string)
    return tuple(grads)
