#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s bound for the bf16 SSD kernel
(``cfg.ssd_bf16``) against its plain bf16 version (``TOL_SSD_BF16``).

    python3 tools/ssd_planted_faults.py [--bound REL ...]

Builds ``csrc/ssd_chunk.cu`` as it stands and copies of it that each carry
one planted fault in the bf16 variant, all with one ``nvcc`` each started
together, into ``src/repro_torch/kernels/build/faults/`` (ignored by git).
Each build's bf16 variant runs through ``ssd_chunk.launch(..., bf16=True)``
on the card at ``chip_smoke.SSD_CASES``, against the plain version's bf16
route on the same card tensors; the unchanged build's fp32 route is read
against that bf16 plain version too.  Per build and bound the script prints
the largest ratio ``max|got - want| / (rel * max|want|)`` over y and the
states of every case.  A bound is sound where the unchanged bf16 variant's
and the fp32 kernel's ratios are at most 1 and every planted fault's is
above 1; the exit code is 0 when the first bound given is sound.  The last
line is a JSON summary.  Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (text of csrc/ssd_chunk.cu, its replacement): each a fault a
# review of the bf16 variant could miss
FAULTS = {
    # each row's own position left out of y: s < l where s <= l belongs
    "dropped diagonal term": (
        "            v[i] = !skip && sa <= la && la < Lc\n",
        "            v[i] = !skip && sa < la && la < Lc\n"),
    # the decay of a pair read one position off: exp(cs[l] - cs[s - 1])
    "decay one position off": (
        "rb<true>(expf(csl[i] - css))",
        "rb<true>(expf(csl[i] - cse[sa > 0 ? sa - 1 : 0]))"),
    # the states' end decays one position off: exp(cs[Lc - 2] - cs[s])
    "end decay one position off": (
        "rb<BF16>(expf(cs_h[Lc - 1] - cs_h[s]))",
        "rb<BF16>(expf(cs_h[Lc - 2] - cs_h[s]))"),
}


def _ratio(got, want, rel: float) -> float:
    """max|got - want| / (rel * max|want|); NaN where got is NaN."""
    return float((got - want).abs().max() / (rel * want.abs().max()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bound", action="append", type=float, default=None,
                    metavar="REL",
                    help="bound to read, relative to max|want| "
                         "(repeatable); default chip_smoke.TOL_SSD_BF16")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tools")]
    import torch

    import chip_smoke as cs
    from _faults import build_variants, worse
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_chunk as sc
    if not torch.cuda.is_available():
        raise SystemExit("ssd_planted_faults: needs a CUDA card")
    bounds = args.bound or [cs.TOL_SSD_BF16]
    sos = build_variants("ssd_chunk", FAULTS,
                         os.path.join(_build.BUILD_DIR, "faults"))
    libs = {}
    for name, so in sos.items():
        real = _build.library
        _build.library = lambda _name, so=so: ctypes.CDLL(so)
        try:
            libs[name] = sc._lib.__wrapped__()
        finally:
            _build.library = real
    # reading -> the unchanged build's fp32 route, or a build's bf16 variant
    readings = {"fp32 kernel": ("unchanged", False)}
    readings.update({name: (name, True) for name in libs})
    worst = {r: {b: [0.0, None] for b in bounds} for r in readings}
    gen = torch.Generator().manual_seed(0)
    for case, (B, S, H, G, N, P, Lc, steep) in cs.SSD_CASES.items():
        args_ = cs._ssd_inputs(gen, B, S, H, G, N, P, steep)
        want = ref.ssd_intra_chunk_ref(*args_, Lc, bf16=True)
        for reading, (build, bf16) in readings.items():
            sc._lib = lambda lib=libs[build]: lib
            got = sc.launch(*args_, Lc, bf16=bf16)
            torch.cuda.synchronize()
            for b in bounds:
                r = max(_ratio(g, w, b) for g, w in zip(got, want))
                print(f"{case} | {reading} | rel={b:g}: {r:.4g}", flush=True)
                acc = worst[reading][b]
                if worse(r, acc[0]):
                    acc[0], acc[1] = r, case
        del want
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    summary = {}
    for reading in readings:
        for b in bounds:
            r, case = worst[reading][b]
            print(f"{reading:28s} rel={b:g}: bound ratio {r:.4g}, worst at "
                  f"{case}")
            summary.setdefault(reading, {})[f"{b:g}"] = {"ratio": r,
                                                         "worst": case}
    print(json.dumps({"device": smi, "bounds": summary}))
    first = bounds[0]
    sound = (worst["unchanged"][first][0] <= 1.0
             and worst["fp32 kernel"][first][0] <= 1.0
             and all(not worst[name][first][0] <= 1.0 for name in FAULTS))
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
