"""CUDA launcher for one-token decode attention
(``csrc/decode_attention.cu``).

Counterpart of ``repro.kernels.decode_attention`` (``_kernel``): one query
row per (batch, head) against the slot cache, with the
``slot_pos``/``pos``/window mask applied inside and an online softmax in
fp32.  It reads the cache in its own ``(B, W, K, hd)`` layout: one cluster
of blocks per (batch, kv head) serves the ``H // K`` q heads of that kv
head (q head ``h`` reads kv head ``h // (H // K)``), so each K/V row is
read once, with no transpose of the cache and no GQA copy.  The cluster's
blocks split the slots; ``launch`` picks their number so that the grid
fills the card.  ``pos`` is a host int, as the serving engine holds it.
The public wrapper, which dispatches CPU tensors to the plain version, is
``kernels.ops.decode_attention``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, _launch

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# blocks an SM the cluster size aims for: at least three 4-warp blocks,
# so that a dozen warps' loads are in flight on each SM
BLOCKS_PER_SM = 3


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.library("decode_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/decode_attention.cu``."""
    lib.decode_attention.argtypes = [_P] * 5 + [_I] * 7 + [_F, _I, _I, _P]
    lib.decode_attention.restype = _I
    lib.decode_attention_max_hd.restype = _I
    lib.decode_attention_max_group.restype = _I
    lib.decode_attention_error_string.argtypes = [_I]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def launch(q, k, v, slot_pos, pos: int, *, window: int = 0):
    """One launch on the current stream.  q (B, H, hd), k/v (B, W, K, hd)
    with K dividing H and H // K at most 8, one dtype (fp32 or bf16) with
    hd a multiple of 4 (fp32) or 8 (bf16) up to 128; slot_pos (W,) int32;
    all contiguous CUDA tensors on one device.  Returns (B, H, hd) in q's
    dtype.  Raises where the card refuses the cluster launch."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"decode_attention: q must be (B, H, hd) and k "
                         f"(B, W, K, hd), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention.launch needs CUDA tensors, got "
                         f"{dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if K == 0 or H % K:
        raise ValueError(f"decode_attention: {K} kv heads do not divide "
                         f"{H} heads")
    _launch.check("q", q, (B, H, hd), q.dtype, dev)
    _launch.check("k", k, (B, W, K, hd), q.dtype, dev)
    _launch.check("v", v, (B, W, K, hd), q.dtype, dev)
    _launch.check("slot_pos", slot_pos, (W,), torch.int32, dev)
    lib = _lib()
    if hd > lib.decode_attention_max_hd():
        raise ValueError(f"decode_attention: head dim {hd} exceeds the "
                         f"kernel's {lib.decode_attention_max_hd()}")
    vec = 16 // q.element_size()
    if hd % vec:
        raise ValueError(f"decode_attention: the kernel reads 16 bytes at a "
                         f"time, so a {q.dtype} head dim must be a multiple "
                         f"of {vec}, got {hd}")
    if H // K > lib.decode_attention_max_group():
        raise ValueError(f"decode_attention: {H // K} q heads per kv head "
                         f"exceed the kernel's "
                         f"{lib.decode_attention_max_group()}")
    if window < 0:
        raise ValueError(f"decode_attention: window {window} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0 or W == 0:
        return out.zero_()
    q, k, v = (_launch.aligned16(t) for t in (q, k, v))
    cluster = _launch.cluster_size(B * K, dev, BLOCKS_PER_SM)
    with torch.cuda.device(dev):
        rc = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
            out.data_ptr(), B, H, K, W, hd, int(pos), int(window),
            1.0 / math.sqrt(hd), cluster, DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "decode_attention launch",
                           lib.decode_attention_error_string)
    return out
