#!/usr/bin/env python3
"""Where the time of the hand-written kernels goes: each kernel as it
stands, copies of it with one part taken out, and, for the two cluster
kernels, the unchanged kernel at each thread-block cluster size, timed at
the main path's shapes.

    python3 tools/kernel_variants.py [--before] [decode lane bwd int8 ...]

Builds ``csrc/<source>.cu`` of each named group (default: all four) with
its variants (one ``nvcc`` each, all started together) into
``src/repro_torch/kernels/build/variants/`` (ignored by git) and times each
with ``chip_smoke.graph_ms`` (CUDA events over CUDA-graph replays; inputs
warm in L2, as in phase 5).  A variant with a part taken out computes a
wrong result: its time is what the rest of the kernel costs, so the
difference to the unchanged kernel is what that part costs on the
critical path.  Decode runs at the engine's B 8 over 1024 slots with 512
written (internlm2-1.8b's H 16, K 8, hd 128 and zamba2's H = K = 32, hd
80, bf16); the lane-MLP forward at g2, g3 and g1_active's Table-3 widths at
buckets 16 and 256; the lane-MLP backward (``bwd``) at the eight Table-3
autoencoder MLPs at the training batch of 128; the int8 matmul at the
quantized active path's three layers at buckets 256 and 16.

``--before`` takes the backward and int8 variants of those two kernels as
they stood before their redesign (commit ba1cb40): run it from an unpacked
copy of that tree (``git archive``) with this tool and ``chip_smoke.py``
copied in.
Prints one line per time and a JSON summary last.  Needs one card and
nvcc.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> edits of the source; each takes one part of the kernel out
DECODE = {
    # the slot loop runs, but reads no K/V row
    "no K/V loads": ("      const bool ld = ok[u] && on;",
                     "      const bool ld = false;"),
    # no slot loop: launch, slot positions, merges and the barrier
    "no slot loop": ("for (int base = 0; base < cn; base += U * stride)",
                     "for (int base = 0; base < 0; base += U * stride)"),
    # the blocks stop after their own slots: no block merge, no stores to
    # rank 0, no cluster barrier, no rank-0 merge (the compiler then drops
    # the slot loop too, whose results nothing reads)
    "no merges": ("  cluster_wait();                       // every block of "
                  "the cluster runs\n", "  return;\n"),
    # every block stores its partial to rank 0, but rank 0 merges nothing
    "no rank-0 merge": ("  if (rank != 0) return;", "  return;"),
}
LANE = {
    # the slabs stream and the barriers run, but no FMA
    "no FMA loop": ("for (int kk = 0; kk < KS; ++kk) {\n      const float av",
                    "for (int kk = 0; kk < 0; ++kk) {\n      const float av"),
    # neither layer: launch, zero-fill and the cluster barriers
    "no layers": [("  for (int p0 = h0; p0 < h1; p0 += PC) {",
                   "  for (int p0 = h0; p0 < h0; p0 += PC) {"),
                  ("  for (int p0 = z0; p0 < z1; p0 += PC) {",
                   "  for (int p0 = z0; p0 < z0; p0 += PC) {")],
    # layer 1's hidden activation kept in the block, not stored to peers
    "no stores to peers": ("for (int q = 0; q < C; ++q)",
                           "for (int q = rank; q <= rank; ++q)"),
    # the FMA loop without its shared-memory reads of the rows ...
    "no row reads": ("const float av = a[kk];", "const float av = 1.f + kk;"),
    # ... or of the weights
    "no weight reads": (
        "const float4 wv = *reinterpret_cast<const float4*>(w + kk * PC);",
        "const float4 wv = make_float4(kk, 1.f, 2.f, 3.f);"),
}
# The lane-MLP backward and the int8 matmul as they stood before their
# redesign (run with --before in that tree)
BWD_BEFORE = {
    # launch (a), g1 and dx by 8-row tiles, left out
    "no rows pass": ("  lane_mlp_bwd_rows<<<",
                     "  if (false) lane_mlp_bwd_rows<<<"),
    # launch (a) without its dx loop
    "rows pass without dx": ("  if (dx) {\n", "  if (false) {\n"),
    # launch (b), the per-tile weight partials, left out
    "no weights pass": ("  lane_mlp_bwd_weights<<<",
                        "  if (false) lane_mlp_bwd_weights<<<"),
}
INT8_BEFORE = {
    # the k loop reads no weight byte
    "no weight loads": (
        "const float w = (float)__ldg(w_q + (size_t)k * c + col) * s;",
        "const float w = (float)k * s;"),
    "no FMA loop": ("for (int k = 0; k < d; ++k) {",
                    "for (int k = 0; k < 0; ++k) {"),
}
BWD = {
    # the first launch (dW1/db1 and g1 tiles) left out
    "no launch 1": ("  lane_mlp_bwd_kernel<<<dim3((unsigned)n1, L)",
                    "  if (false) lane_mlp_bwd_kernel<<<dim3((unsigned)n1, L)"),
    # the second launch (dW0/db0 and dx tiles) left out
    "no launch 2": ("  lane_mlp_bwd_kernel<<<dim3((unsigned)n2, L)",
                    "  if (false) lane_mlp_bwd_kernel<<<dim3((unsigned)n2, L)"),
    # the first launch without its g1 tiles, the second without dx tiles
    "no g1 tiles": ("                       rows * cdiv(h, SC);",
                    "                       0;"),
    "no dx tiles": ("(dx ? rows * cdiv(din, SC) : 0)", "0"),
    # the weight tiles launched, but returning at once
    "no weight-tile work": ("  float* As = smem;                 // [RC][WT]",
                            "  return;\n  float* As = smem;"),
    # the weight tiles stage their rows but run no FMA
    "no row-sum FMAs": ("    for (int r = 0; r < TM; ++r) {",
                        "    for (int r = 0; r < 0; ++r) {"),
    # the g1 and dx tiles stage their slabs but run no k step ...
    "no strided-dot steps": ("      if (k0 + s * 32 >= K) break;",
                             "      break;"),
    # ... or the butterfly's adds without its shuffles (each lane sums its
    # own 32 partials, so no FMA becomes dead)
    "no butterfly shuffles": (
        "  tree_level<16>(acc, lane);\n  tree_level<8>(acc, lane);\n"
        "  tree_level<4>(acc, lane);\n  tree_level<2>(acc, lane);\n"
        "  tree_level<1>(acc, lane);\n",
        "  for (int m = 1; m < 32; ++m) acc[0] += acc[m];\n"),
}
INT8 = {
    # the weight slab is dequantized from zeros, without reading w_q
    "no weight loads": [("q[i] = cs < c && kk < kn ? *", "q[i] = false ? *"),
                        ("q[i] = ok ? w_q[", "q[i] = false ? w_q[")],
    # the x slab is filled without reading x
    "no x loads": ("? x[(size_t)(row0 + r) * d + k0 + kk] : 0.f;",
                   "? 1.f : 0.f;"),
    "no FMA loop": ("    for (int kk = 0; kk < kn; ++kk) {",
                    "    for (int kk = 0; kk < 0; ++kk) {"),
}
CLUSTERS = (1, 2, 4, 8)
GROUPS = ("decode", "lane", "bwd", "int8")


def _bound(loader, so: str):
    """What the cached library loader ``loader`` of a kernel module
    returns, bound to the library at ``so`` instead of the one
    ``_build`` builds."""
    from repro_torch.kernels import _build
    real = _build.library
    _build.library = lambda name: ctypes.CDLL(so)
    try:
        return loader.__wrapped__()
    finally:
        _build.library = real


@contextlib.contextmanager
def _tile_sums_skipped():
    """``torch.Tensor.sum`` as the identity while a call is captured: the
    backward as it stood before its redesign then returns its per-tile weight
    partials without its four ``torch.sum`` launches."""
    import torch
    real = torch.Tensor.sum
    torch.Tensor.sum = lambda self, *a, **kw: self
    try:
        yield
    finally:
        torch.Tensor.sum = real


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("groups", nargs="*",
                    help=f"any of {', '.join(GROUPS)} (default: all)")
    ap.add_argument("--before", action="store_true",
                    help="the bwd and int8 variants of those kernels as "
                         "they stood before their redesign")
    args = ap.parse_args(argv)
    groups = args.groups or list(GROUPS)
    if set(groups) - set(GROUPS):
        ap.error(f"groups are {', '.join(GROUPS)}")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tools")]
    import torch

    import chip_smoke as cs
    from _faults import build_variants
    from repro_torch.kernels import _build, _launch, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import lane_mlp as lm
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    # group -> (module, its loader's name, source, edits, bind)
    spec = {"decode": (da, "_lib", "decode_attention", DECODE,
                       lambda so: da.bind(ctypes.CDLL(so))),
            "lane": (lm, "_lib", "lane_mlp_fwd", LANE,
                     lambda so: lm.bind(ctypes.CDLL(so))),
            "bwd": (lm, "_lib_bwd", "lane_mlp_bwd",
                    BWD_BEFORE if args.before else BWD,
                    lambda so: _bound(lm._lib_bwd, so)),
            "int8": (i8, "_lib", "int8_matmul",
                     INT8_BEFORE if args.before else INT8,
                     lambda so: _bound(i8._lib, so))}
    libs, ptxas = {}, {}
    for grp in groups:
        module, attr, source, edits, bind = spec[grp]
        sos = build_variants(source, edits, os.path.join(out_dir, grp))
        libs[grp] = (module, attr, {n: bind(so) for n, so in sos.items()})
        for n, so in sos.items():       # each entry's registers and spills
            with open(so[:-3] + ".log") as fh:
                log = fh.read()
            ptxas.setdefault(grp, {})[n] = list(zip(
                map(int, re.findall(r"Used (\d+) registers", log)),
                map(int, re.findall(r"(\d+) bytes spill stores", log))))
            print(f"{grp} | {n}: (registers, spill bytes) "
                  f"{ptxas[grp][n]}", flush=True)
    gen = torch.Generator().manual_seed(0)
    cases = []
    if "decode" in groups:
        B, W, pos = cs.LM["batch"], cs.LM["slots"], cs.LM["slots"] // 2 - 1
        sp = torch.where(torch.arange(W) <= pos, torch.arange(W), -1).to(
            torch.int32).cuda()
        for H, K, hd in ((16, 8, 128), (32, 32, 80)):
            q = cs._rand(gen, (B, H, hd)).bfloat16()
            kc, vc = (cs._rand(gen, (B, W, K, hd)).bfloat16()
                      for _ in range(2))
            cases.append(("decode", f"B={B} W={W} valid={pos + 1} H={H} "
                          f"K={K} hd={hd} bf16", lambda a=(q, kc, vc):
                          ops.decode_attention(*a, sp, pos)))
    if "lane" in groups:
        for name, Bm in (("g2", 16), ("g2", 256), ("g3", 256),
                         ("g1_active", 16)):
            din, h, dz = cs.ENCODERS[name]
            a = cs._mlp_inputs(gen, Bm, din, h, dz)
            cases.append(("lane", f"{name} {din}->{h}->{dz} B={Bm}",
                          lambda a=a: ops.fused_mlp2(*a)))
    if "bwd" in groups:
        for name, (din, h, dz) in cs.AE_SHAPES.items():
            a = cs._bwd_inputs(gen, cs.TRAIN_B, din, h, dz)
            cases.append(("bwd", f"{name} {din}->{h}->{dz} B={cs.TRAIN_B}",
                          lambda a=a: lm.launch_bwd(*a)))
    if "int8" in groups:
        for Bm in (cs.BUCKET, 16):
            for name, (d, c, act) in cs.INT8_LAYERS.items():
                a = cs._int8_inputs(gen, Bm, d, c)
                cases.append(("int8", f"{name} {d}->{c} B={Bm}",
                              lambda a=a, act=act: ops.int8_matmul(
                                  *a, act=act)))
    summary = {}
    cluster_size = _launch.cluster_size
    for kernel, shape, fn in cases:
        module, attr, variants = libs[kernel]
        loader = getattr(module, attr)
        row = summary.setdefault(kernel, {}).setdefault(shape, {})
        try:
            for name, lib in variants.items():
                setattr(module, attr, lambda lib=lib: lib)
                row[name] = cs.graph_ms(fn) * 1e3
                print(f"{kernel} {shape} | {name}: {row[name]:.3f} us",
                      flush=True)
            setattr(module, attr, lambda lib=variants["unchanged"]: lib)
            if kernel == "bwd" and args.before:
                with _tile_sums_skipped():
                    row["no tile sums"] = cs.graph_ms(fn) * 1e3
                print(f"{kernel} {shape} | no tile sums: "
                      f"{row['no tile sums']:.3f} us", flush=True)
            for c in (CLUSTERS if kernel in ("decode", "lane") else ()):
                _launch.cluster_size = lambda *_, c=c: c
                row[f"cluster {c}"] = cs.graph_ms(fn) * 1e3
                print(f"{kernel} {shape} | unchanged, cluster {c}: "
                      f"{row[f'cluster {c}']:.3f} us", flush=True)
        finally:
            _launch.cluster_size = cluster_size
            setattr(module, attr, loader)
    smi = cs._smi()
    print(smi)
    print(json.dumps({"device": smi, "before": args.before,
                      "us": summary, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
