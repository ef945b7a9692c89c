#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s bound for the bf16 decode-attention
kernel against its plain version in fp32 (``TOL_DECODE_BF16_F32``).

    python3 tools/decode_planted_faults.py [--bound ATOL,RTOL ...]

Builds ``csrc/decode_attention.cu`` as it stands and copies of it that each
carry one planted fault, all with one ``nvcc`` each started together, into
``src/repro_torch/kernels/build/faults/`` (ignored by git).  Each build runs
through ``ops.decode_attention`` on the card at phase 2's cases
(``chip_smoke.DECODE_HEADS`` x ``DECODE_W`` x ``DECODE_WINDOWS``, batch 8,
``pos`` = 3W/4 with a few empty slots) in bf16, against the plain version
in fp32 on the same bf16 inputs, and the script prints, per build and
bound, the largest bound ratio ``max |got - want| / (atol + rtol *
|want|)``.  A bound is sound where the unchanged build's ratio is at most 1
and every planted fault's is above 1; the exit code is 0 when the first
bound given is sound.  The last line is a JSON summary.  Needs one card
and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (text of csrc/decode_attention.cu, its replacement): each a fault
# a review of the kernel could miss
FAULTS = {
    # the last block of each cluster left out of rank 0's merge (where the
    # cluster has more than one block)
    "dropped split": ("      if (r >= C) break;\n      const float c",
                      "      if (r >= C - (C > 1)) break;\n"
                      "      const float c"),
    # rank 1's partial merged without its exp(m_1 - M) rescale
    "rescale skipped": ("      const float c = expf(pmax[r * G + g] - M);\n",
                        "      const float c = r == 1 ? 1.f : "
                        "expf(pmax[r * G + g] - M);\n"),
    # q head g * K + kh read where kh * G + g belongs: kv head h % K for
    # head h, instead of h / G (no change where G = 1)
    "wrong kv head": ("kh * G + g) * hd + d0;", "g * K + kh) * hd + d0;"),
    # the window's oldest slot, pos - window, kept
    "window >=": ("sp > pos - window)", "sp >= pos - window)"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bound", action="append", default=None,
                    metavar="ATOL,RTOL",
                    help="bound to read (repeatable); default "
                         "chip_smoke.TOL_DECODE_BF16_F32")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tools")]
    import torch

    import chip_smoke as cs
    from _faults import build_variants, worse
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as da
    if not torch.cuda.is_available():
        raise SystemExit("decode_planted_faults: needs a CUDA card")
    bounds = ([tuple(float(x) for x in b.split(",")) for b in args.bound]
              if args.bound else [cs.TOL_DECODE_BF16_F32])
    libs = {name: da.bind(ctypes.CDLL(so)) for name, so in build_variants(
        "decode_attention", FAULTS,
        os.path.join(_build.BUILD_DIR, "faults")).items()}
    # ratio[name][bound] = [largest ratio, its case]
    ratio = {name: {b: [0.0, None] for b in bounds} for name in libs}
    gen = torch.Generator().manual_seed(0)
    B = cs.LM["batch"]
    for (H, K, hd), W in itertools.product(cs.DECODE_HEADS, cs.DECODE_W):
        pos = W * 3 // 4
        sp = cs._slot_pos(W, pos)
        q = cs._rand(gen, (B, H, hd)).bfloat16()
        kc, vc = (cs._rand(gen, (B, W, K, hd)).bfloat16() for _ in range(2))
        for window in cs.DECODE_WINDOWS:
            want = ref.decode_attention_cache(q.float(), kc.float(),
                                              vc.float(), sp, pos,
                                              window=window)
            case = f"B={B} H={H} K={K} hd={hd} W={W} pos={pos} " \
                   f"window={window}"
            for name, lib in libs.items():
                da._lib = lambda lib=lib: lib
                got = ops.decode_attention(q, kc, vc, sp, pos,
                                           window=window).float()
                for b in bounds:
                    r = cs.bound_ratio(got, want, *b)
                    print(f"{case} | {name} | atol={b[0]:g} rtol={b[1]:g}: "
                          f"{r:.4g}", flush=True)
                    acc = ratio[name][b]
                    if worse(r, acc[0]):
                        acc[0], acc[1] = r, case
    summary = {}
    smi = cs._smi()
    print(smi)
    for name in libs:
        for b in bounds:
            r, case = ratio[name][b]
            print(f"{name:16s} atol={b[0]:g} rtol={b[1]:g}: bound ratio "
                  f"{r:.4g}, worst at {case}")
            summary.setdefault(name, {})[f"{b[0]:g},{b[1]:g}"] = {
                "ratio": r, "worst": case}
    print(json.dumps({"device": smi, "bounds": summary}))
    first = bounds[0]
    sound = ratio["unchanged"][first][0] <= 1.0 and all(
        not ratio[name][first][0] <= 1.0 for name in FAULTS)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
