"""CUDA launcher for flash attention (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention`` (``_attn_kernel``):
causal, sliding-window or full attention with an online softmax over kv
tiles and fp32 running max, denominator and accumulator.  It reads q in the
model's ``(B, S, H, hd)`` layout and k/v in ``(B, S, K, hd)``, mapping q
head ``h`` to kv head ``h // (H // K)``, so neither the reference wrapper's
transpose nor the GQA copy is made.  Two routes by dtype: fp32 runs IEEE
fp32 FMAs on the CUDA cores (any head dim up to 128); bf16 runs on the
tensor cores (``mma.sync`` m16n8k16 with fp32 accumulation, ``ldmatrix``,
a ``cp.async`` double-buffered kv ring) and takes head dims that are
multiples of 16 up to 128.  The public wrapper, which dispatches CPU
tensors to the plain version, is ``kernels.ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, _launch

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.library("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/flash_attention.cu``."""
    lib.flash_attention.argtypes = [_P] * 4 + [_I] * 7 + [_F, _I, _P]
    lib.flash_attention.restype = _I
    lib.flash_attention_max_hd.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def launch(q, k, v, *, causal: bool = True, window: int = 0):
    """One launch on the current stream.  q (B, S, H, hd), k/v (B, S, K,
    hd) with K dividing H: contiguous CUDA tensors of one dtype (fp32, or
    bf16 with hd a multiple of 16) on one device.  Returns (B, S, H, hd) in
    that dtype."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, hd = q.shape
    K = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention.launch needs CUDA tensors, got "
                         f"{dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: {K} kv heads do not divide "
                         f"{H} heads")
    _launch.check("q", q, (B, S, H, hd), q.dtype, dev)
    _launch.check("k", k, (B, S, K, hd), q.dtype, dev)
    _launch.check("v", v, (B, S, K, hd), q.dtype, dev)
    lib = _lib()
    if hd > lib.flash_attention_max_hd():
        raise ValueError(f"flash_attention: head dim {hd} exceeds the "
                         f"kernel's {lib.flash_attention_max_hd()}")
    if q.dtype == torch.bfloat16 and hd % 16:
        raise ValueError(f"flash_attention: the bf16 kernel takes head dims "
                         f"that are multiples of 16, got {hd}")
    if q.dtype == torch.bfloat16 and S * K * hd >= 2 ** 31:
        raise ValueError(f"flash_attention: the bf16 kernel addresses a "
                         f"batch row of k/v with 32-bit offsets; S * K * hd "
                         f"= {S * K * hd} is too large")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    q, k, v = (_launch.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, K, hd, int(bool(causal)), int(window),
            1.0 / math.sqrt(hd), DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "flash_attention launch",
                           lib.flash_attention_error_string)
    return out
