"""CUDA launcher for the lane-MLP forward kernel (``csrc/lane_mlp_fwd.cu``).

Counterpart of the forward half of ``repro.kernels.lane_mlp``
(``_fwd_kernel``): ``selu(x @ w0 + b0) @ w1 + b1``, optionally selu'd, for
each lane of an ``(L, B, din)`` stack, with the hidden activation kept on
chip.  ``save=True`` also returns the pre-activations ``a1`` and ``a2``
the backward will need.  The public wrappers, which dispatch CPU tensors
to the plain version, are in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("lane_mlp_fwd")
    lib.lane_mlp_fwd.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    lib.lane_mlp_fwd.restype = _I
    lib.lane_mlp_fwd_max_din.restype = _I
    lib.lane_mlp_fwd_max_hidden.restype = _I
    lib.lane_mlp_fwd_error_string.argtypes = [_I]
    lib.lane_mlp_fwd_error_string.restype = ctypes.c_char_p
    return lib


def launch(xs, w0s, b0s, w1s, b1s, *, final_act: bool = False,
           save: bool = False):
    """One kernel launch on the current stream.  xs (L, B, din), w0s
    (L, din, h), b0s (L, h), w1s (L, h, dz), b1s (L, dz): contiguous fp32
    CUDA tensors on one device, B >= 1.  Returns ``out`` (L, B, dz), or
    ``(out, a1, a2)`` with ``save``."""
    if xs.dim() != 3:
        raise ValueError(f"xs must be (L, B, din), got {tuple(xs.shape)}")
    L, B, din = xs.shape
    h, dz = w0s.shape[-1], w1s.shape[-1]
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"lane_mlp.launch needs CUDA tensors, got {dev}")
    f32 = torch.float32
    for name, t, shape in (("xs", xs, (L, B, din)),
                           ("w0s", w0s, (L, din, h)), ("b0s", b0s, (L, h)),
                           ("w1s", w1s, (L, h, dz)), ("b1s", b1s, (L, dz))):
        _launch.check(name, t, shape, f32, dev)
    lib = _lib()
    if h > lib.lane_mlp_fwd_max_hidden():
        raise ValueError(f"hidden width {h} exceeds the kernel's "
                         f"{lib.lane_mlp_fwd_max_hidden()}")
    if din > lib.lane_mlp_fwd_max_din():
        raise ValueError(f"input width {din} exceeds the kernel's "
                         f"{lib.lane_mlp_fwd_max_din()}")
    if B == 0:
        raise ValueError("lane_mlp.launch: empty batch")
    out = torch.empty((L, B, dz), dtype=f32, device=dev)
    a1 = torch.empty((L, B, h), dtype=f32, device=dev) if save else None
    a2 = torch.empty((L, B, dz), dtype=f32, device=dev) if save else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.lane_mlp_fwd(
            xs.data_ptr(), w0s.data_ptr(), b0s.data_ptr(), w1s.data_ptr(),
            b1s.data_ptr(), out.data_ptr(), ptr(a1), ptr(a2), L, B, din, h,
            dz, int(bool(final_act)), torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "lane_mlp_fwd launch",
                           lib.lane_mlp_fwd_error_string)
    return (out, a1, a2) if save else out
