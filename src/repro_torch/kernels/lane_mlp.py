"""CUDA launchers for the lane-MLP forward and backward kernels
(``csrc/lane_mlp_fwd.cu``, ``csrc/lane_mlp_bwd.cu``).

Counterparts of ``repro.kernels.lane_mlp``: ``launch`` runs
``_fwd_kernel``, ``selu(x @ w0 + b0) @ w1 + b1``, optionally selu'd, for
each lane of an ``(L, B, din)`` stack, with the hidden activation kept on
chip; ``save=True`` also returns the pre-activations ``a1`` and ``a2`` the
backward needs.  ``launch_bwd`` runs ``_bwd_kernel``, the closed-form
backward, as two launches, each gradient summed over the rows in a fixed
order.  Each kernel has two routes, picked by ``route`` from the widths
alone, with the same bits whichever runs:

- ``"narrow"``: every width a multiple of 4 and at most ``NARROW_MAX``
  (the million-row scale MLPs, 16 -> 32 -> 64 and back, over batches of
  8,192 rows).  Both kernels give a block 128 rows of one lane and stage
  the lane's weights once; the backward computes g1 and dx there and
  writes its four 32-row tiles' weight-gradient partials to a scratch of
  ``partial_shape`` (43.5 MB at the scale encoder) that a second launch
  folds in the cluster route's order.
- ``"cluster"``: every other shape (the Table-3 MLPs): a cluster of blocks
  a 16-row tile for the forward, flat tile grids for the backward.

The public wrappers (``kernels.ops``: ``fused_mlp2``, ``fused_lane_mlp2``
and the autograd Function behind them) dispatch CPU tensors to the plain
versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch

_P, _I = ctypes.c_void_p, ctypes.c_int


# blocks an SM the cluster size aims for: one 4-warp block of a row tile
# on every SM where the rows allow
BLOCKS_PER_SM = 1
# the narrow route's widest width, and the rows of the backward's tile
# partials (NARROW_MAX and TM in the sources)
NARROW_MAX = 64
TILE_ROWS = 32


def route(din: int, h: int, dz: int) -> str:
    """The route both kernels take at these widths: ``"narrow"`` where
    each is a multiple of 4 in [4, NARROW_MAX], else ``"cluster"``."""
    return ("narrow" if all(0 < w <= NARROW_MAX and w % 4 == 0
                            for w in (din, h, dz)) else "cluster")


def partial_shape(L: int, B: int, din: int, h: int, dz: int) -> tuple:
    """The narrow backward's scratch: each lane's 32-row tile partials of
    [dW0; db0] and [dW1; db1], (L, ceil(B / 32), (din + 1) h + (h + 1)
    dz) fp32."""
    return (L, -(-B // TILE_ROWS), (din + 1) * h + (h + 1) * dz)


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.library("lane_mlp_fwd"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/lane_mlp_fwd.cu``."""
    lib.lane_mlp_fwd.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.lane_mlp_fwd.restype = _I
    lib.lane_mlp_fwd_narrow.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    lib.lane_mlp_fwd_narrow.restype = _I
    lib.lane_mlp_fwd_max_hidden.restype = _I
    lib.lane_mlp_fwd_tile_rows.restype = _I
    lib.lane_mlp_fwd_error_string.argtypes = [_I]
    lib.lane_mlp_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    return bind_bwd(_build.library("lane_mlp_bwd"))


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/lane_mlp_bwd.cu``."""
    lib.lane_mlp_bwd.argtypes = [_P] * 12 + [_I] * 6 + [_P]
    lib.lane_mlp_bwd.restype = _I
    lib.lane_mlp_bwd_narrow.argtypes = [_P] * 12 + [_I] * 7 + [_P]
    lib.lane_mlp_bwd_narrow.restype = _I
    lib.lane_mlp_bwd_error_string.argtypes = [_I]
    lib.lane_mlp_bwd_error_string.restype = ctypes.c_char_p
    return lib


def launch(xs, w0s, b0s, w1s, b1s, *, final_act: bool = False,
           save: bool = False):
    """One kernel launch on the current stream.  xs (L, B, din), w0s
    (L, din, h), b0s (L, h), w1s (L, h, dz), b1s (L, dz): contiguous fp32
    CUDA tensors on one device, B >= 1.  Returns ``out`` (L, B, dz), or
    ``(out, a1, a2)`` with ``save``.  The route is ``route``'s for the
    widths.  Raises where the card refuses the launch."""
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
    narrow = route(din, h, dz) == "narrow"
    lib = _lib()
    if h > lib.lane_mlp_fwd_max_hidden():
        raise ValueError(f"hidden width {h} exceeds the kernel's "
                         f"{lib.lane_mlp_fwd_max_hidden()}")
    if B == 0:
        raise ValueError("lane_mlp.launch: empty batch")
    # rows are copied 16 bytes at a time where their widths allow (the
    # narrow route's biases too)
    xs, w0s, w1s = (_launch.aligned16(t) for t in (xs, w0s, w1s))
    if narrow:
        b0s, b1s = _launch.aligned16(b0s), _launch.aligned16(b1s)
    out = torch.empty((L, B, dz), dtype=f32, device=dev)
    a1 = torch.empty((L, B, h), dtype=f32, device=dev) if save else None
    a2 = torch.empty((L, B, dz), dtype=f32, device=dev) if save else None
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (xs.data_ptr(), w0s.data_ptr(), b0s.data_ptr(), w1s.data_ptr(),
            b1s.data_ptr(), out.data_ptr(), ptr(a1), ptr(a2), L, B, din, h,
            dz, int(bool(final_act)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if narrow:
            rc = lib.lane_mlp_fwd_narrow(*args, stream)
        else:
            tiles = -(-B // lib.lane_mlp_fwd_tile_rows())
            cluster = _launch.cluster_size(L * tiles, dev, BLOCKS_PER_SM)
            rc = lib.lane_mlp_fwd(*args, cluster, stream)
    _launch.raise_on_error(rc, "lane_mlp_fwd launch",
                           lib.lane_mlp_fwd_error_string)
    return (out, a1, a2) if save else out


def launch_bwd(g, xs, a1, a2, w0s, w1s, *, final_act: bool = False,
               need_dx: bool = True):
    """The backward for output cotangent ``g`` (L, B, dz), from the inputs
    and saved pre-activations of ``launch(..., save=True)``: two kernel
    launches on the current stream.  Returns ``(dx, dw0, db0, dw1, db1)``
    with the lane axis; ``dx`` is None unless ``need_dx``.  The route as
    for ``launch``."""
    if xs.dim() != 3:
        raise ValueError(f"xs must be (L, B, din), got {tuple(xs.shape)}")
    L, B, din = xs.shape
    h, dz = w0s.shape[-1], w1s.shape[-1]
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"lane_mlp.launch_bwd needs CUDA tensors, got {dev}")
    f32 = torch.float32
    for name, t, shape in (("g", g, (L, B, dz)), ("xs", xs, (L, B, din)),
                           ("a1", a1, (L, B, h)), ("a2", a2, (L, B, dz)),
                           ("w0s", w0s, (L, din, h)),
                           ("w1s", w1s, (L, h, dz))):
        _launch.check(name, t, shape, f32, dev)
    if B == 0:
        raise ValueError("lane_mlp.launch_bwd: empty batch")
    narrow = route(din, h, dz) == "narrow"
    if narrow:      # the narrow route reads every row 16 bytes at a time
        g, xs, a1, a2, w0s, w1s = (_launch.aligned16(t)
                                   for t in (g, xs, a1, a2, w0s, w1s))
    lib = _lib_bwd()
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    dx = new(L, B, din) if need_dx else None
    dw0, db0, dw1, db1 = new(L, din, h), new(L, h), new(L, h, dz), new(L, dz)
    # g1 (L, B, h) between the cluster route's launches; the narrow route's
    # tile partials
    scratch = new(*partial_shape(L, B, din, h, dz)) if narrow \
        else new(L, B, h)
    args = (g.data_ptr(), xs.data_ptr(), a1.data_ptr(), a2.data_ptr(),
            w0s.data_ptr(), w1s.data_ptr(),
            None if dx is None else dx.data_ptr(), dw0.data_ptr(),
            db0.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            scratch.data_ptr(), L, B, din, h, dz, int(bool(final_act)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if narrow:
            rc = lib.lane_mlp_bwd_narrow(*args, scratch.shape[1], stream)
        else:
            rc = lib.lane_mlp_bwd(*args, stream)
    _launch.raise_on_error(rc, "lane_mlp_bwd launch",
                           lib.lane_mlp_bwd_error_string)
    return dx, dw0, db0, dw1, db1
