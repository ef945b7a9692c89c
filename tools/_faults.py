"""Shared by the tools that build a kernel source beside edited copies of it
(planted faults, timed variants), and by their readings."""
from __future__ import annotations

import math
import os
import subprocess


def apply_edits(text: str, edits, name: str) -> str:
    """``text`` with ``edits`` made: one (old, new) pair or a list of them,
    each ``old`` found exactly once, else ``SystemExit`` naming ``name``."""
    for old, new in ([edits] if isinstance(edits, tuple) else edits):
        if text.count(old) != 1:
            raise SystemExit(f"variant {name!r}: {old!r} is not in the "
                             f"source exactly once")
        text = text.replace(old, new)
    return text


def build_variants(source: str, faults: dict, out_dir: str) -> dict:
    """``{"unchanged" or fault name: path of its .so}``: ``csrc/<source>.cu``
    as it stands and one copy per entry of ``faults`` (name -> (text of the
    source, its replacement), or a list of such pairs), each built by its
    own ``nvcc``, all started together, into ``out_dir``."""
    from repro_torch.kernels import _build
    with open(os.path.join(_build.CSRC, f"{source}.cu")) as fh:
        text = fh.read()
    os.makedirs(out_dir, exist_ok=True)
    sources = {"unchanged": text}
    for name, edits in faults.items():
        sources[name] = apply_edits(text, edits, name)
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        cu = os.path.join(out_dir, f"{source}_{i}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = cu[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    paths = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name!r}:\n{out}")
        with open(so[:-3] + ".log", "w") as fh:     # the -Xptxas -v report
            fh.write(out)
        paths[name] = so
    return paths


def worse(r: float, worst: float) -> bool:
    """Whether reading ``r`` replaces ``worst``; a NaN is the worst."""
    return not math.isnan(worst) and (math.isnan(r) or r > worst)
