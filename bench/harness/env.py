"""Where a run finds the program and keeps its caches, and what it must
not have loaded.

The checkout's root is the parent of ``bench/``.  The program is the
package ``repro_torch`` under ``src/``; a run puts ``src`` on the path
itself.  Every build and kernel cache a run may touch lives at a fixed
path inside the checkout, so that only the first run of a cell there
builds: the port's CUDA libraries go to ``src/repro_torch/kernels/build/``
(fixed in the program), and the caches of PyTorch's extension builds,
Triton and the CUDA JIT go under ``.bench_cache/``.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "bench")
SRC = os.path.join(ROOT, "src")
CACHE = os.path.join(ROOT, ".bench_cache")

# top-level module names a run must never hold: JAX, its libraries and the
# JAX package the port was made from (compared whole: ``repro_torch`` is
# the program and allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class SetupError(RuntimeError):
    """The run cannot start here (no card, no program, an unknown cell);
    it prints no result and exits with a code other than 0."""


def set_cache_dirs() -> None:
    """Point every cache a build or compile may write at a fixed directory
    inside the checkout, and keep libraries that could pull in JAX from
    doing so."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def add_program_path() -> None:
    """Put ``src`` on the path, or raise where the checkout has no program
    (a directory holding only ``BENCHMARK.json`` and ``bench/``)."""
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SetupError(f"no program under {SRC}: repro_torch is missing")
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_loaded(modules=None) -> list:
    """The names in ``modules`` (default ``sys.modules``) whose top-level
    part is one of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
