#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s bound for the bf16 flash-attention
kernel against its plain version in fp32 (``TOL_FLASH_BF16_F32``).

    python3 tools/flash_planted_faults.py [--bound ATOL,RTOL ...]

Builds ``csrc/flash_attention.cu`` as it stands and copies of it that each
carry one planted fault, all with one ``nvcc`` each started together, into
``src/repro_torch/kernels/build/faults/`` (ignored by git).  Each build runs
through ``ops.flash_attention`` on the card at ``chip_smoke.FLASH_SHAPES`` x
``FLASH_MASKS`` in bf16, against the plain version in fp32 on the same
bf16 inputs, and the script prints, per build and bound, the largest bound
ratio ``max |got - want| / (atol + rtol * |want|)`` over every row and over
rows >= S/2.  A bound is sound where the unchanged build's ratio is at most
1 and every planted fault's is above 1; the exit code is 0 when the first
bound given is sound.  The last line is a JSON summary.  Needs one card and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (text of csrc/flash_attention.cu, its replacement): each a fault
# a review of the kernel could miss
FAULTS = {
    # keys 64..127 left out of every row whose mask reaches past key 127:
    # only rows >= 128, so early rows (large |out|) stay right
    "dropped kv tile": (
        "    const uint32_t Kt = k_lane + (t & 1) * STAGE;\n",
        "    if (t == 1 && n_tiles > 2) continue;\n"
        "    const uint32_t Kt = k_lane + (t & 1) * STAGE;\n"),
    "scale 5% high": ("      scale * LOG2E);\n",
                      "      scale * 1.05f * LOG2E);\n"),
    # P's A fragment with its second and third registers swapped: row g + 8
    # keys 0..7 where row g keys 8..15 belong
    "P fragment mis-packed": (
        "      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),\n"
        "                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),\n"
        "                              pack_bf16(s[2 * kk + 1][0], "
        "s[2 * kk + 1][1]),\n",
        "      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),\n"
        "                              pack_bf16(s[2 * kk + 1][0], "
        "s[2 * kk + 1][1]),\n"
        "                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),\n"),
    # the diagonal masked: each row loses its own key
    "diagonal key masked": (
        "        if (!(col < S && (!causal || col <= row) &&",
        "        if (!(col < S && (!causal || col < row) &&"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bound", action="append", default=None,
                    metavar="ATOL,RTOL",
                    help="bound to read (repeatable); default "
                         "chip_smoke.TOL_FLASH_BF16_F32")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tools")]
    import torch

    import chip_smoke as cs
    from _faults import build_variants, worse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    if not torch.cuda.is_available():
        raise SystemExit("flash_planted_faults: needs a CUDA card")
    bounds = ([tuple(float(x) for x in b.split(",")) for b in args.bound]
              if args.bound else [cs.TOL_FLASH_BF16_F32])
    from repro_torch.kernels import _build
    libs = {name: fa.bind(ctypes.CDLL(so)) for name, so in build_variants(
        "flash_attention", FAULTS,
        os.path.join(_build.BUILD_DIR, "faults")).items()}
    # ratio[name][bound] = [all rows, rows >= S/2, worst case]
    ratio = {name: {b: [0.0, 0.0, None] for b in bounds} for name in libs}
    gen = torch.Generator().manual_seed(0)
    for B, S, H, K, hd in cs.FLASH_SHAPES:
        q = cs._rand(gen, (B, S, H, hd)).bfloat16()
        k, v = (cs._rand(gen, (B, S, K, hd)).bfloat16() for _ in range(2))
        for causal, window in cs.FLASH_MASKS:
            want = ref.flash_attention_model(q.float(), k.float(), v.float(),
                                             causal=causal, window=window)
            case = f"B={B} S={S} H={H} K={K} hd={hd} causal={causal} " \
                   f"window={window}"
            for name, lib in libs.items():
                fa._lib = lambda lib=lib: lib
                got = ops.flash_attention(q, k, v, causal=causal,
                                          window=window).float()
                for b in bounds:
                    r = cs.bound_ratio(got, want, *b)
                    late = cs.bound_ratio(got[:, S // 2:], want[:, S // 2:],
                                          *b)
                    print(f"{case} | {name} | atol={b[0]:g} "
                          f"rtol={b[1]:g}: {r:.4g} (rows >= S/2 {late:.4g})",
                          flush=True)
                    acc = ratio[name][b]
                    if worse(r, acc[0]):
                        acc[0], acc[2] = r, case
                    if worse(late, acc[1]):
                        acc[1] = late
            del want
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    summary = {}
    for name in libs:
        for b in bounds:
            r, late, case = ratio[name][b]
            print(f"{name:24s} atol={b[0]:g} rtol={b[1]:g}: bound ratio "
                  f"{r:.4g} (rows >= S/2 {late:.4g}), worst at {case}")
            summary.setdefault(name, {})[f"{b[0]:g},{b[1]:g}"] = {
                "ratio": r, "ratio_late_rows": late, "worst": case}
    print(json.dumps({"device": smi, "bounds": summary}))
    first = bounds[0]
    sound = ratio["unchanged"][first][0] <= 1.0 and all(
        not ratio[name][first][0] <= 1.0 for name in FAULTS)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
