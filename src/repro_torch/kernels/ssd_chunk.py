"""CUDA launcher for the Mamba2 SSD intra-chunk block
(``csrc/ssd_chunk.cu``).

Counterpart of ``repro.kernels.ssd_chunk`` (``_kernel``): per (batch,
chunk, head), ``y_intra = (C B^T o L) (x dt)`` with the decays ``L =
tril(exp(cs_l - cs_s))``, and the chunk-final states ``B^T diag(exp(cs_end
- cs)) (x dt)``.  It reads the model's layout in place (x (B, S, H, P), dt
(B, S, H), Bm/Cm (B, S, G, N), head h on group h // (H // G)), so the
reference's transposes and its per-head repeat of B and C are never
materialised, and writes ``y_intra`` in (B, S, H, P) and the states in (B,
S // Lc, H, N, P).  ``bf16`` launches the kernel's bf16 variant
(``cfg.ssd_bf16``): the same fp32 tensors in and out, the products'
operands and results rounded to bf16 where the plain version
(``ref.ssd_intra_chunk_ref(..., bf16=True)``) rounds them.  The public
wrapper, which dispatches CPU tensors to the plain version, is
``kernels.ops.ssd_intra_chunk``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("ssd_chunk")
    for fn in (lib.ssd_intra_chunk, lib.ssd_intra_chunk_bf16):
        fn.argtypes = [_P] * 7 + [_I] * 7 + [_P]
        fn.restype = _I
    lib.ssd_intra_chunk_max_np.restype = _I
    lib.ssd_intra_chunk_max_chunk.restype = _I
    lib.ssd_intra_chunk_error_string.argtypes = [_I]
    lib.ssd_intra_chunk_error_string.restype = ctypes.c_char_p
    return lib


def launch(x, dt, A, Bm, Cm, Lc: int, *, bf16: bool = False):
    """One launch on the current stream.  x (B, S, H, P), dt (B, S, H), A
    (H,), Bm/Cm (B, S, G, N) with G dividing H and ``Lc`` dividing S; all
    fp32, contiguous CUDA tensors on one device.  Returns ``(y_intra (B, S,
    H, P), states (B, S // Lc, H, N, P))``, fp32; with ``bf16`` from the
    bf16 variant."""
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd_intra_chunk: x must be (B, S, H, P) and Bm "
                         f"(B, S, G, N), got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_intra_chunk.launch needs CUDA tensors, got "
                         f"{dev}")
    f32 = torch.float32
    _launch.check("x", x, (B, S, H, P), f32, dev)
    _launch.check("dt", dt, (B, S, H), f32, dev)
    _launch.check("A", A, (H,), f32, dev)
    _launch.check("Bm", Bm, (B, S, G, N), f32, dev)
    _launch.check("Cm", Cm, (B, S, G, N), f32, dev)
    lib = _lib()
    if max(N, P) > lib.ssd_intra_chunk_max_np():
        raise ValueError(f"ssd_intra_chunk: N {N} or P {P} exceeds the "
                         f"kernel's {lib.ssd_intra_chunk_max_np()}")
    if Lc > lib.ssd_intra_chunk_max_chunk():
        raise ValueError(f"ssd_intra_chunk: chunk {Lc} exceeds the "
                         f"kernel's {lib.ssd_intra_chunk_max_chunk()}")
    y = torch.empty_like(x)
    states = torch.empty((B, S // Lc, H, N, P), dtype=f32, device=dev)
    if y.numel() == 0:
        return y, states.zero_()
    fn = lib.ssd_intra_chunk_bf16 if bf16 else lib.ssd_intra_chunk
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), states.data_ptr(), B, S, H, G, N,
            P, int(Lc), torch.cuda.current_stream().cuda_stream)
    _launch.raise_on_error(rc, "ssd_intra_chunk launch",
                           lib.ssd_intra_chunk_error_string)
    return y, states
