"""Build ``csrc/*.cu`` into shared libraries with ``nvcc`` and load them
with ``ctypes`` (a plain C interface: no PyTorch headers, so a build takes
seconds rather than minutes).

Each source becomes ``build/<name>-<digest>.so``, keyed on a hash of the
source text and the flags, so an edit rebuilds and an unchanged tree
reuses the library.  ``build_all`` starts one ``nvcc`` per source, all at
once, and waits for every one of them.  Nothing is built at import time:
the first launch on a CUDA tensor builds what is missing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
SOURCES = ("lane_mlp_fwd", "lane_mlp_bwd", "int8_matmul",
           "distill_loss", "probe", "flash_attention", "decode_attention",
           "ssd_chunk")
# no --use_fast_math: it swaps expm1f/expf for approximations and the SELU
# would drift from the reference's rounding
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of repro_torch are built from source at first use")
    return nvcc


def _target(name: str) -> tuple:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}")
    return src, stem + ".so", stem + ".log"


def build_all() -> dict:
    """Build every missing library in parallel; return ``{name: log}``,
    the ``-Xptxas -v`` report of each (from this build or the cached
    one).  Raises with nvcc's output if any build fails."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in SOURCES:
            src, so, log = _target(name)
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so, log)
        failed = []
        for name, (proc, tmp, so, log) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (exit "
                              f"{proc.returncode}) ---\n{out}")
                continue
            with open(log, "w") as fh:
                fh.write(out)
            os.replace(tmp, so)     # atomic: a concurrent build is harmless
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        logs = {}
        for name in SOURCES:
            _, _, log = _target(name)
            with open(log) as fh:
                logs[name] = fh.read()
        return logs


def library(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it first if
    needed (together with every other missing source).  Callers cache the
    handle."""
    build_all()
    return ctypes.CDLL(_target(name)[1])
