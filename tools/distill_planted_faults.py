#!/usr/bin/env python3
"""Whether ``chip_smoke.py``'s phase-2 check of the Eq. 5 kernels
(``distill_errors`` against ``TOL_DISTILL``) sees a wrong gradient of the
size the mean form gives, where every gradient carries a factor 1/B.

    python3 tools/distill_planted_faults.py

Builds ``csrc/distill_loss.cu`` as it stands and copies of it that each
carry one planted fault in the backward's dz (one ``nvcc`` each, started
together) into ``src/repro_torch/kernels/build/faults/distill/`` (ignored
by git), runs ``chip_smoke.distill_errors`` through each build at B 1, 77,
128 and 2000 in both kinds, and prints each case's forward and backward
error and whether it lies above the bound.  The exit code is 0 when the
unchanged build passes every case and each fault fails at B 128 and 2000
in both kinds.  The last line is a JSON summary.  Needs one card and nvcc.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_VEC = "          if (pz) reinterpret_cast<float4*>(pz + t * CHUNK)[l] = v;"
_ONE = "        if (pz) pz[Z.elem(t, l)] = v;"
# name -> edits of csrc/distill_loss.cu: dz wrong in the 16-byte and the
# element-by-element stores alike
FAULTS = {
    "dz = 0": [(_VEC, _VEC.replace("= v;", "= make_float4(0.f, 0.f, 0.f, "
                                           "0.f);")),
               (_ONE, _ONE.replace("= v;", "= 0.f;"))],
    "dz 1% low": [(_VEC, _VEC.replace("= v;", "= make_float4(0.99f * v.x, "
                                              "0.99f * v.y, 0.99f * v.z, "
                                              "0.99f * v.w);")),
                  (_ONE, _ONE.replace("= v;", "= 0.99f * v;"))],
}


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tools")]
    import torch

    import chip_smoke as cs
    from _faults import build_variants
    from kernel_variants import _bound
    from repro_torch.kernels import _build
    from repro_torch.kernels import distill_loss as dl
    if not torch.cuda.is_available():
        raise SystemExit("distill_planted_faults: needs a CUDA card")
    sos = build_variants("distill_loss", FAULTS,
                         os.path.join(_build.BUILD_DIR, "faults", "distill"))
    loader, summary, sound = dl._lib, {}, True
    try:
        for name, so in sos.items():
            lib = _bound(loader, so)
            dl._lib = lambda lib=lib: lib
            rows = cs.distill_errors(torch.Generator().manual_seed(0))
            summary[name] = [dict(kind=k, B=B, fwd=e, bwd=e2,
                                  above=max(e, e2) > cs.TOL_DISTILL)
                             for k, B, e, e2, *_ in rows]
            for r in summary[name]:
                print(f"{name} | {r['kind']} B={r['B']}: fwd {r['fwd']:.3e}, "
                      f"bwd {r['bwd']:.3e}, "
                      f"{'above' if r['above'] else 'within'} "
                      f"{cs.TOL_DISTILL:g}", flush=True)
            if name == "unchanged":
                sound &= not any(r["above"] for r in summary[name])
            else:
                sound &= all(r["above"] for r in summary[name]
                             if r["B"] in (cs.TRAIN_B, 2000))
    finally:
        dl._lib = loader
    smi = cs._smi()
    print(smi)
    print(json.dumps({"device": smi, "sound": sound, "cases": summary}))
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
