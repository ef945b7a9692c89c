"""CUDA launcher for the weight-only int8 matmul (``csrc/int8_matmul.cu``).

Counterpart of ``repro.kernels.int8_matmul`` (``_int8_kernel``):
``x @ (float(w_q) * scale) + b``, optionally followed by SELU, with the
int8 weight dequantized on its way into shared memory and never written
to device memory.  The public wrapper, which dispatches CPU tensors to the
plain version, is ``kernels.ops.int8_matmul``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch

_P, _I = ctypes.c_void_p, ctypes.c_int
ACTS = {"none": 0, "selu": 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("int8_matmul")
    lib.int8_matmul.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.int8_matmul.restype = _I
    lib.int8_matmul_error_string.argtypes = [_I]
    lib.int8_matmul_error_string.restype = ctypes.c_char_p
    return lib


def launch(x, w_q, scale, b, *, act: str = "none"):
    """One kernel launch on the current stream.  x (B, d) fp32, w_q (d, c)
    int8, scale/b (c,) fp32: contiguous CUDA tensors on one device,
    B >= 1.  Returns (B, c) fp32."""
    if act not in ACTS:
        raise ValueError(f"int8_matmul: unknown act {act!r}")
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"int8_matmul: x and w_q must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    B, d = x.shape
    c = w_q.shape[1]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"int8_matmul.launch needs CUDA tensors, got {dev}")
    f32 = torch.float32
    _launch.check("x", x, (B, d), f32, dev)
    _launch.check("w_q", w_q, (d, c), torch.int8, dev)
    _launch.check("scale", scale, (c,), f32, dev)
    _launch.check("b", b, (c,), f32, dev)
    if B == 0:
        raise ValueError("int8_matmul.launch: empty batch")
    lib = _lib()
    out = torch.empty((B, c), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.int8_matmul(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), b.data_ptr(),
            out.data_ptr(), B, d, c, ACTS[act],
            torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "int8_matmul launch",
                           lib.int8_matmul_error_string)
    return out
