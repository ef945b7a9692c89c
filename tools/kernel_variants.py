#!/usr/bin/env python3
"""Where the time of the decode-attention and lane-MLP forward kernels goes:
each kernel as it stands, copies of it with one part taken out, and the
unchanged kernel at each thread-block cluster size, timed at the main
path's shapes.

    python3 tools/kernel_variants.py

Builds ``csrc/decode_attention.cu`` and ``csrc/lane_mlp_fwd.cu`` with their
variants (one ``nvcc`` each, all started together) into
``src/repro_torch/kernels/build/variants/`` (ignored by git) and times each
with ``chip_smoke.graph_ms`` (CUDA events over CUDA-graph replays; inputs
warm in L2, as in phase 5).  A variant with a part taken out computes a
wrong result: its time is what the rest of the kernel costs, so the
difference to the unchanged kernel is what that part costs on the
critical path.  Decode runs at the engine's B 8 over 1024 slots with 512
written (internlm2-1.8b's H 16, K 8, hd 128 and zamba2's H = K = 32, hd
80, bf16); the lane-MLP forward at g2, g3 and g1_active's Table-3 widths at
buckets 16 and 256.  Prints one line per time and a JSON summary last.
Needs one card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
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
CLUSTERS = (1, 2, 4, 8)


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tools")]
    import torch

    import chip_smoke as cs
    from _faults import build_variants
    from repro_torch.kernels import _build, _launch, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import lane_mlp as lm
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    libs = {"decode": (da, {n: da.bind(ctypes.CDLL(so)) for n, so in
                            build_variants("decode_attention", DECODE,
                                           out_dir).items()}),
            "lane": (lm, {n: lm.bind(ctypes.CDLL(so)) for n, so in
                          build_variants("lane_mlp_fwd", LANE,
                                         out_dir).items()})}
    gen = torch.Generator().manual_seed(0)
    cases = []
    B, W, pos = cs.LM["batch"], cs.LM["slots"], cs.LM["slots"] // 2 - 1
    sp = torch.where(torch.arange(W) <= pos, torch.arange(W), -1).to(
        torch.int32).cuda()
    for H, K, hd in ((16, 8, 128), (32, 32, 80)):
        q = cs._rand(gen, (B, H, hd)).bfloat16()
        kc, vc = (cs._rand(gen, (B, W, K, hd)).bfloat16() for _ in range(2))
        cases.append(("decode", f"B={B} W={W} valid={pos + 1} H={H} K={K} "
                      f"hd={hd} bf16", lambda a=(q, kc, vc):
                      ops.decode_attention(*a, sp, pos)))
    for name, Bm in (("g2", 16), ("g2", 256), ("g3", 256), ("g1_active", 16)):
        din, h, dz = cs.ENCODERS[name]
        a = cs._mlp_inputs(gen, Bm, din, h, dz)
        cases.append(("lane", f"{name} {din}->{h}->{dz} B={Bm}",
                      lambda a=a: ops.fused_mlp2(*a)))
    summary = {}
    cluster_size = _launch.cluster_size
    for kernel, shape, fn in cases:
        module, variants = libs[kernel]
        row = summary.setdefault(kernel, {}).setdefault(shape, {})
        try:
            for name, lib in variants.items():
                module._lib = lambda lib=lib: lib
                row[name] = cs.graph_ms(fn) * 1e3
                print(f"{kernel} {shape} | {name}: {row[name]:.3f} us",
                      flush=True)
            module._lib = lambda lib=variants["unchanged"]: lib
            for c in CLUSTERS:
                _launch.cluster_size = lambda *_, c=c: c
                row[f"cluster {c}"] = cs.graph_ms(fn) * 1e3
                print(f"{kernel} {shape} | unchanged, cluster {c}: "
                      f"{row[f'cluster {c}']:.3f} us", flush=True)
        finally:
            _launch.cluster_size = cluster_size
    smi = cs._smi()
    print(smi)
    print(json.dumps({"device": smi, "us": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
