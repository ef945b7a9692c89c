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
fills the card (the slots route) or stays within one block an SM (the
grouped route).  ``pos`` is a host int, or a one-element int32 tensor on
the launch's device whose address the kernel reads it from (null for an
int): the serving engine's CUDA graph of a decode step replays one launch
at every position.
Two routes, picked by ``route`` from (G, hd, dtype) alone:

- ``"grouped"``: bf16 with G = H / K >= 4 q heads a kv head and hd a
  multiple of 16 (qwen3-moe's G 8, the VLM's G 4 and its image cache):
  16-slot tiles through a ``cp.async`` ring a warp, scores and P.V on
  ``mma.sync`` with P carried as two bf16 halves.
- ``"slots"``: every other case (fp32 at every G, bf16 at G <= 3 or at a
  head dim that is not a multiple of 16): the kernel that splits each row
  over a sub-warp's lanes, fp32 math on the CUDA cores.

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
# the fewest q heads a kv head that take the grouped route
GROUPED_MIN_G = 4


def route(G: int, hd: int, dtype: torch.dtype) -> str:
    """The route of a launch with ``G`` q heads a kv head, head dim ``hd``
    and ``dtype``: ``"grouped"`` for bf16 with G >= GROUPED_MIN_G and hd a
    multiple of 16, else ``"slots"``."""
    return ("grouped" if dtype == torch.bfloat16 and G >= GROUPED_MIN_G
            and hd % 16 == 0 else "slots")


def grouped_cluster(units: int, device: torch.device) -> int:
    """The grouped route's cluster size for ``units`` (b, kv head) pairs:
    the largest C in {1, 2, 4, 8} for which the grid is at most one block
    an SM of ``device`` (1 where even C = 1 is more).  Fewer blocks, each
    with more tiles a warp, beat a fuller card here: the merges and the
    cluster barrier grow with C (``tools/kernel_variants.py decode``)."""
    sms = _launch.sm_count(device.index if device.index is not None
                           else torch.cuda.current_device())
    return next((c for c in (8, 4, 2) if units * c <= sms), 1)


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.library("decode_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/decode_attention.cu``."""
    for fn in (lib.decode_attention, lib.decode_attention_grouped):
        fn.argtypes = [_P] * 5 + [_I] * 6 + [_P, _I, _F, _I, _I, _P]
        fn.restype = _I
    lib.decode_attention_max_hd.restype = _I
    lib.decode_attention_max_group.restype = _I
    lib.decode_attention_error_string.argtypes = [_I]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def launch(q, k, v, slot_pos, pos, *, window: int = 0):
    """One launch on the current stream.  q (B, H, hd), k/v (B, W, K, hd)
    with K dividing H and H // K at most 8, one dtype (fp32 or bf16) with
    hd a multiple of 4 (fp32) or 8 (bf16) up to 128; slot_pos (W,) int32;
    all contiguous CUDA tensors on one device; ``pos`` a host int or a (1,)
    int32 tensor on that device, read by the kernel.  Returns (B, H, hd) in
    q's dtype.  The route is ``route``'s.  Raises where the card refuses
    the cluster launch."""
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
    if torch.is_tensor(pos):
        _launch.check("pos", pos, (1,), torch.int32, dev)
        pos_int, pos_at = 0, pos.data_ptr()
    else:
        pos_int, pos_at = int(pos), None
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
    grouped = route(H // K, hd, q.dtype) == "grouped"
    cluster = (grouped_cluster(B * K, dev) if grouped
               else _launch.cluster_size(B * K, dev, BLOCKS_PER_SM))
    fn = lib.decode_attention_grouped if grouped else lib.decode_attention
    with torch.cuda.device(dev):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
            out.data_ptr(), B, H, K, W, hd, pos_int, pos_at, int(window),
            1.0 / math.sqrt(hd), cluster, DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "decode_attention launch",
                           lib.decode_attention_error_string)
    return out
