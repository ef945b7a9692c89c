#!/usr/bin/env python3
"""Where the time of the hand-written kernels goes: each kernel as it
stands, copies of it with one part taken out, and, for the two cluster
kernels, the unchanged kernel at each thread-block cluster size, timed at
the main path's shapes.

    python3 tools/kernel_variants.py [flash decode lane bwd int8 ssd
                                      probe distill ...] [--before-distill CU]

Builds ``csrc/<source>.cu`` of each named group (default: all eight) with
its variants (one ``nvcc`` each, all started together) into
``src/repro_torch/kernels/build/variants/`` (ignored by git) and times each
with ``chip_smoke.graph_ms`` (CUDA events over CUDA-graph replays; inputs
warm in L2, as in phase 5).  A variant with a part taken out computes a
wrong result: its time is what the rest of the kernel costs, so the
difference to the unchanged kernel is what that part costs on the
critical path.  Flash attention's bf16 route runs at internlm2-1.8b's
``prefill_step`` (B 2, S 2048, H 16, K 8, hd 128, causal), the VLM's
cross-attention (S 2048 against T 1600, H 32, K 8, no mask) and zamba2's
shared block (H = K = 32, hd 80, causal); besides parts taken out, its
variants leave the two consumers' turns unordered, run each tile's softmax
after the previous P.V, or resize the K/V ring.  Decode runs at the
engine's B 8 over 1024 slots with 512 written (internlm2-1.8b's H 16, K
8, hd 128 and zamba2's H = K = 32, hd 80 on the slots route; qwen3-moe's
H 32, K 4 and the VLM's H 32, K 8, hd 128 on the grouped route) and over
the VLM's 1600 image tokens, every slot valid, all bf16; each route's
variants leave the other route's times as they are, and the cluster sweep
sets both routes' sizes; the lane-MLP forward at g2, g3 and g1_active's Table-3 widths at
buckets 16 and 256 (its cluster route) and at the scale lanes' encoder and
decoder (16 lanes of 8,192 rows with ``save``: its narrow route); the
lane-MLP backward (``bwd``) at the eight Table-3 autoencoder MLPs at the
training batch of 128 and at the scale lanes (16 lanes of 8,192 rows); an
edit of one route leaves the other's times as they are.  The int8 matmul
at the quantized active path's three layers at buckets 256 and 16; the SSD
intra-chunk block at zamba2's ``prefill_step`` (B 2, S 2048, H 80, N = P =
64, Lc 256, fp32); the probe step at phase 5's 10 fold lanes over mimic3's
active rows (d 256, C 4); Eq. 5 (``distill``) at step 3's batch of 128
rows, D 5, M 256: each form of each kernel and a g3 step's whole loss,
and the mean form on other cluster, grid and block shapes; then the mean
form at the validation pass's 2,000 rows and at 20,000, beside the rows
form then ``torch.mean`` (with ``--before-distill``, also the kernel
before the mean form's rows then ``torch.mean``).

The edits match the kernels' sources as they stand.  To split a kernel as
it stood before a redesign, unpack that commit (``git archive``) and run
its own copy of this tool there, with its tables edited to match.
Prints one line per time and a JSON summary last.  Needs one card and
nvcc.
"""
from __future__ import annotations

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
    # the grouped route (bf16, G >= 4): no tile (launch, Q's fragments, the
    # slot positions, the merges and the barriers)
    "grouped: no slot loop": ("    const int nt = (cn + TS - 1) / TS;",
                              "    const int nt = 0;"),
    # its tiles' rows zero-filled, none read
    "grouped: no K/V loads": ("          const bool in = (mask >> r) & 1u;",
                              "          const bool in = false;"),
    # no score products (K's fragments not read): the softmax on zeros
    "grouped: no score products": (
        "  for (int kk = 0; kk < KS; ++kk) {\n    // slots 0..7",
        "  for (int kk = 0; kk < 0; ++kk) {\n    // slots 0..7"),
    # no P.V products (V's fragments not read)
    "grouped: no P.V products": ("  for (int dp = 0; dp < DN / 2; ++dp) {",
                                 "  for (int dp = 0; dp < 0; ++dp) {"),
    # the blocks stop once their warps' partials are in shared memory: no
    # block merge, no stores to rank 0, no cluster barrier, no rank-0 merge
    "grouped: no merges": ("    wl[warp][g] = l;\n  }\n  __syncthreads();\n",
                           "    wl[warp][g] = l;\n  }\n  return;\n"),
    # every block stores its slices, but none merges its own
    "grouped: no final merge": (
        "  cluster_arrive();                     // every block holds its "
        "slices\n  cluster_wait();\n",
        "  cluster_arrive();\n  cluster_wait();\n  return;\n"),
    # a ring of three stages a warp
    "grouped: three stages": ("constexpr int NS = 2;",
                              "constexpr int NS = 3;"),
    # blocks of 8 or 2 warps
    "grouped: 8 warps a block": ("constexpr int GWARPS = 4;",
                                 "constexpr int GWARPS = 8;"),
    "grouped: 2 warps a block": ("constexpr int GWARPS = 4;",
                                 "constexpr int GWARPS = 2;"),
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
    # the narrow route: the weights and rows staged and the results stored,
    # but no FMA (each output its bias)
    "narrow: no FMA loop": ("for (int k = 0; k < K; k += 4) {\n      float4 a[R];",
                            "for (int k = 0; k < 0; k += 4) {\n      float4 a[R];"),
    # units of at most 2 rows (fewer registers), or blocks of 64 or 256
    # rows
    "narrow: units of at most 2 rows": ("if (fill >= 4) narrow_layer<4>",
                                        "if (false) narrow_layer<4>"),
    "narrow: blocks of 64 rows": ("constexpr int NROWS = 128;",
                                  "constexpr int NROWS = 64;"),
    "narrow: blocks of 256 rows": ("constexpr int NROWS = 128;",
                                   "constexpr int NROWS = 256;"),
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
    "no row-sum FMAs": (
        "    for (int r = 0; r < TM; ++r) {\n      const float4 x = "
        "*reinterpret_cast<const float4*>(ap + r * WT);",
        "    for (int r = 0; r < 0; ++r) {\n      const float4 x = "
        "*reinterpret_cast<const float4*>(ap + r * WT);"),
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
    # the narrow route: its rows pass or its fold left out
    "narrow: no rows pass": ("  if (m.kp1 == 32 && m.kp2 == 32)\n",
                             "  if (true) {\n  } else if (m.kp1 == 32 && "
                             "m.kp2 == 32)\n"),
    "narrow: no fold": ("  lane_mlp_bwd_fold_kernel<<<",
                        "  if (false) lane_mlp_bwd_fold_kernel<<<"),
    # the rows pass staging its rows, without the strided dots (g1, dx) or
    # without the tile partials
    "narrow: no strided dots": ("  for (int c0 = 0; c0 < n; c0 += 32) {",
                                "  for (int c0 = 0; c0 < 0; c0 += 32) {"),
    "narrow: no tile partials": (
        "for (int it = threadIdx.x; it < tiles * ga * gb; it += NTHREADS)",
        "for (int it = threadIdx.x; it < 0; it += NTHREADS)"),
    # the rows pass held to three blocks an SM (85 registers), or its
    # strided dots two rows at a time
    "narrow: three blocks an SM": (
        "template <int S1, int S2>\n__global__ void __launch_bounds__(NTHREADS)",
        "template <int S1, int S2>\n__global__ void __launch_bounds__(NTHREADS, 3)"),
    "narrow: dots two rows at a time": (
        "    for (int r = warp * rw + lane / cw; r < rows; r += NWARPS * rw) {",
        "#pragma unroll 2\n    for (int r = warp * rw + lane / cw; r < rows; "
        "r += NWARPS * rw) {"),
    # blocks of two or of eight 32-row tiles
    "narrow: blocks of 64 rows": ("constexpr int NROWS = 4 * TM;",
                                  "constexpr int NROWS = 2 * TM;"),
    "narrow: blocks of 256 rows": ("constexpr int NROWS = 4 * TM;",
                                   "constexpr int NROWS = 8 * TM;"),
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
SSD = {
    # no tile is copied: the block computes on what shared memory holds
    "no staging": ("for (int r = threadIdx.x >> 4; r < R; r += THREADS / 16) "
                   "{\n    const bool ok = r < rows;",
                   "for (int r = threadIdx.x >> 4; r < 0; r += THREADS / 16) "
                   "{\n    const bool ok = r < rows;"),
    # the decays' expf left out (their cs loads and subtraction stay)
    "no exp": ("sc[i][j] * expf(csl[i] - css)", "sc[i][j] * (csl[i] - css)"),
    # the states blocks return at once
    "no states": ("  const bool states = role == nt;       // else the y "
                  "block of l tile lt\n",
                  "  const bool states = role == nt;       // else the y "
                  "block of l tile lt\n  if (states) return;\n"),
    "no score products": ("for (int n4 = 0; n4 < nq; ++n4) {",
                          "for (int n4 = 0; n4 < 0; ++n4) {"),
    # neither y's nor the states' products (their tiles still staged)
    "no y or state products": (
        "fma_tile(acc, St_h, Xk, s_hi, r0, q);",
        "fma_tile(acc, St_h, Xk, 0, r0, q);"),
}
PROBE = {
    "no x staging": ("for (int r = t >> 4; r < TR; r += THREADS / 16) {",
                     "for (int r = t >> 4; r < 0; r += THREADS / 16) {"),
    "no logits pass": ("for (int jq = 16 * sl; jq < q1; ++jq) {",
                       "for (int jq = 16 * sl; jq < 16 * sl; ++jq) {"),
    "no softmax": ("for (int e = t; e < TR * K; e += THREADS) {",
                   "for (int e = t; e < 0; e += THREADS) {"),
    "no dW pass": ("        for (int r = 0; r < rows; ++r) {\n          "
                   "const float4 u", "        for (int r = 0; r < 0; ++r) "
                   "{\n          const float4 u"),
    # the second launch, the blocks' partials summed, left out
    "no tile sum": ("    probe_sum<<<", "    if (false) probe_sum<<<"),
}
DISTILL = {
    # the mean form without its cluster reduction (rows only, no barrier)
    "no mean reduction": (
        "    cluster_wait();                     // every block of the "
        "cluster runs\n", "    return;\n"),
    # the chunks' elements summed in arrival order, without the shuffles
    "no old_order shuffles": (
        "  return make_float4(got[0], got[1], got[2], got[3]);",
        "  return e;"),
    # the mean form on one cluster, or on the cooperative grid, at every N
    "cluster at every N": ("  if (S <= CLUSTER_ROWS) {", "  if (true) {"),
    "grid at every N": ("  if (S <= CLUSTER_ROWS) {", "  if (false) {"),
    # the cooperative grid with half or a quarter of its blocks (two or four
    # rows a warp)
    "grid of half the blocks": (
        "min((S + ROWS_WARPS - 1) / ROWS_WARPS, fit)",
        "min((S + 2 * ROWS_WARPS - 1) / (2 * ROWS_WARPS), fit)"),
    "grid of a quarter the blocks": (
        "min((S + ROWS_WARPS - 1) / ROWS_WARPS, fit)",
        "min((S + 4 * ROWS_WARPS - 1) / (4 * ROWS_WARPS), fit)"),
    # the mean form's cluster: one block, or 8 blocks, whatever the rows
    "mean on one block": ("  while (C < CLUSTER_MAX && C * FWD_WARPS < S) "
                          "C <<= 1;", ""),
    "mean on 8 blocks": ("  while (C < CLUSTER_MAX && C * FWD_WARPS < S) "
                         "C <<= 1;", "  C = CLUSTER_MAX;"),
    # no row read from memory: the sums run on zeros (the loads' trip)
    "no row loads": [
        ("    if (i < nc) {\n      va = __ldg",
         "    if (false) {\n      va = __ldg"),
        ("    } else if (elem(i, l) < K) {\n      va.x = __ldg",
         "    } else if (false) {\n      va.x = __ldg")],
    # every row element by element in the old order: no 16-byte loads and
    # no shuffles
    "scalar strided loads only": ("nc(vec ? K_ / CHUNK : 0)", "nc(0)"),
    # ... with a lane's next 4 or 8 items of each pair loaded at once
    "scalar loads, 4 at once": [("nc(vec ? K_ / CHUNK : 0)", "nc(0)"),
                                ("int ITEMS = 2;", "int ITEMS = 4;")],
    "scalar loads, 8 at once": [("nc(vec ? K_ / CHUNK : 0)", "nc(0)"),
                                ("int ITEMS = 2;", "int ITEMS = 8;")],
    # the backward's blocks of 256 threads (half the blocks)
    "backward blocks of 256": ("constexpr int BWD_THREADS = 128;",
                               "constexpr int BWD_THREADS = 256;"),
    # the mean form's blocks of 1024 or 256 threads (fewer or more blocks
    # a cluster)
    "mean blocks of 1024": ("constexpr int FWD_THREADS = 512;",
                            "constexpr int FWD_THREADS = 1024;"),
    "mean blocks of 256": ("constexpr int FWD_THREADS = 512;",
                           "constexpr int FWD_THREADS = 256;"),
}
# the loops of flash's S (issue_qk) and P.V (issue_pv) products
_QK = ("  for (int ks = 0; ks < HD / 16; ++ks) {\n"
       "    const int col = 16 * ks, cls = C::cls(col), c0 = C::start(col);\n"
       "    const uint32_t off")
_PV = ("  for (int kk = 0; kk < BK / 16; ++kk) {\n"
       "    const uint64_t d0")
FLASH = {
    # the scores' online softmax left out: P is the raw score, alpha 1
    "no softmax": (
        "  float mx[2] = {NEG_INF, NEG_INF};     // of the raw scores\n",
        "  float mx[2] = {NEG_INF, NEG_INF};     // of the raw scores\n"
        "  alpha[0] = alpha[1] = 1.f;\n  return;\n"),
    # the softmax without its exponentials (p = the scaled score less m)
    "no exponentials": (
        "      float p = exp2f(fmaf(s[j][e], scale_log2, -m[e >> 1]));",
        "      float p = fmaf(s[j][e], scale_log2, -m[e >> 1]);"),
    # no Q.K^T products: the softmax runs on zero scores
    "no Q.K^T products": (_QK, _QK.replace("ks < HD / 16", "ks < 0")),
    # no P.V products (the softmax still feeds l)
    "no P.V products": (_PV, _PV.replace("kk < BK / 16", "kk < 0")),
    # everything but the copies and the barriers: no products, no softmax
    "copies only": [
        (_QK, _QK.replace("ks < HD / 16", "ks < 0")),
        (_PV, _PV.replace("kk < BK / 16", "kk < 0")),
        ("  float mx[2] = {NEG_INF, NEG_INF};     // of the raw scores\n",
         "  float mx[2] = {NEG_INF, NEG_INF};     // of the raw scores\n"
         "  alpha[0] = alpha[1] = 1.f;\n  return;\n")],
    # the consumers free every tile as it lands: the copies alone
    "loads only": [
        ("    const int tb = ce > cb ? (cb - kv_begin) / BK : n_tiles;",
         "    const int tb = n_tiles;"),
        ("    const int te = ce > cb ? (ce - kv_begin + BK - 1) / BK "
         ": n_tiles;", "    const int te = n_tiles;")],
    # the consumers' turns at the tensor cores left unordered
    "no turns": [
        ("void turn_wait(int consumer) {\n",
         "void turn_wait(int consumer) {\n  return;\n"),
        ("void turn_pass(int consumer) {\n",
         "void turn_pass(int consumer) {\n  return;\n")],
    # tile t's softmax after tile t-1's P.V has finished (no overlap of the
    # two within a consumer)
    "softmax after P.V": (
        "        wgmma_wait<1>();                // S done, P.V may run on",
        "        wgmma_wait<0>();"),
    # a ring of two or four K/V stages
    "two stages": ("constexpr int NSTAGE = 3;", "constexpr int NSTAGE = 2;"),
    "four stages": ("constexpr int NSTAGE = 3;", "constexpr int NSTAGE = 4;"),
}
CLUSTERS = (1, 2, 4, 8)
# group -> (csrc/<source>.cu, its edits)
SOURCES = {"flash": ("flash_attention", FLASH),
           "decode": ("decode_attention", DECODE),
           "lane": ("lane_mlp_fwd", LANE), "bwd": ("lane_mlp_bwd", BWD),
           "int8": ("int8_matmul", INT8), "ssd": ("ssd_chunk", SSD),
           "probe": ("probe", PROBE), "distill": ("distill_loss", DISTILL)}
GROUPS = tuple(SOURCES)


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


def _distill_before(cu: str):
    """The rows of the Eq. 5 kernel at ``cu`` (the C interface before the
    mean form: ``distill_fwd(x, xh, z, zt, mask, out, N, D, M, lam, mae,
    stream)``), built once, as a function of (x, xh, z, zt, mask) for MSE
    at step 3's lam."""
    import subprocess
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    so = os.path.join(_build.BUILD_DIR, "variants", "distill_before.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.distill_fwd.argtypes = [P] * 6 + [I] * 3 + [F, I, P]

    def rows(x, xh, z, zt, mask):
        (N, D), M = x.shape, z.shape[1]
        out = torch.empty(N, device=x.device)
        rc = lib.distill_fwd(*(t.data_ptr() for t in (x, xh, z, zt, mask)),
                             out.data_ptr(), N, D, M, cs.DISTILL["lam"], 0,
                             torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"distill before: CUDA error {rc}")
        return out
    return rows


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("groups", nargs="*",
                    help=f"any of {', '.join(GROUPS)} (default: all)")
    ap.add_argument("--before-distill", metavar="CU",
                    help="the Eq. 5 kernel before its mean form (C "
                         "interface of 76aa2af): also time its rows, then "
                         "torch.mean, at each mean-form shape")
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
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import lane_mlp as lm
    from repro_torch.kernels import probe as pr
    from repro_torch.kernels import ssd_chunk as sc
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    # group -> (module, its loader's name, bind)
    spec = {"flash": (fa, "_lib", lambda so: fa.bind(ctypes.CDLL(so))),
            "decode": (da, "_lib", lambda so: da.bind(ctypes.CDLL(so))),
            "lane": (lm, "_lib", lambda so: lm.bind(ctypes.CDLL(so))),
            "bwd": (lm, "_lib_bwd", lambda so: lm.bind_bwd(ctypes.CDLL(so))),
            "int8": (i8, "_lib", lambda so: _bound(i8._lib, so)),
            "ssd": (sc, "_lib", lambda so: _bound(sc._lib, so)),
            "probe": (pr, "_lib", lambda so: _bound(pr._lib, so)),
            "distill": (dl, "_lib", lambda so: _bound(dl._lib, so))}
    libs, ptxas = {}, {}
    for grp in groups:
        module, attr, bind = spec[grp]
        source, edits = SOURCES[grp]
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
    cases, before = [], []
    if "flash" in groups:
        # internlm2-1.8b's prefill_step (causal), the VLM's cross shape and
        # zamba2's shared block (hd 80, causal)
        (B, S), T = cs.LM_PREFILL, cs.VLM_IMAGE_TOKENS
        for H, K, hd, Tk, causal in ((16, 8, 128, S, True),
                                     (32, 8, 128, T, False),
                                     (32, 32, 80, S, True)):
            q = cs._rand(gen, (B, S, H, hd)).bfloat16()
            k, v = (cs._rand(gen, (B, Tk, K, hd)).bfloat16()
                    for _ in range(2))
            cases.append(("flash", f"B={B} S={S} T={Tk} H={H} K={K} hd={hd} "
                          f"{'causal' if causal else 'full'} bf16",
                          lambda a=(q, k, v), c=causal:
                          ops.flash_attention(*a, causal=c)))
    if "decode" in groups:
        B, W, pos = cs.LM["batch"], cs.LM["slots"], cs.LM["slots"] // 2 - 1
        sp = torch.where(torch.arange(W) <= pos, torch.arange(W), -1).to(
            torch.int32).cuda()
        Wi = cs.VLM_IMAGE_TOKENS
        spi = torch.arange(Wi, dtype=torch.int32, device="cuda")
        # internlm2's G 2, zamba2's G 1, qwen3-moe's G 8 and the VLM's G 4
        # over the engine's cache; the VLM's image K/V, every slot valid
        for H, K, hd, Wc, sc, p in ((16, 8, 128, W, sp, pos),
                                    (32, 32, 80, W, sp, pos),
                                    (32, 4, 128, W, sp, pos),
                                    (32, 8, 128, W, sp, pos),
                                    (32, 8, 128, Wi, spi, Wi - 1)):
            q = cs._rand(gen, (B, H, hd)).bfloat16()
            kc, vc = (cs._rand(gen, (B, Wc, K, hd)).bfloat16()
                      for _ in range(2))
            cases.append(("decode", f"B={B} W={Wc} valid={p + 1} H={H} "
                          f"K={K} hd={hd} bf16", lambda a=(q, kc, vc, sc, p):
                          ops.decode_attention(*a)))
    L, Bs = len(cs.SCALE["seeds"]) * cs.SCALE["parties"], cs.SCALE["batch"]
    if "lane" in groups:
        for name, Bm in (("g2", 16), ("g2", 256), ("g3", 256),
                         ("g1_active", 16)):
            din, h, dz = cs.ENCODERS[name]
            a = cs._mlp_inputs(gen, Bm, din, h, dz)
            cases.append(("lane", f"{name} {din}->{h}->{dz} B={Bm}",
                          lambda a=a: ops.fused_mlp2(*a)))
        # the scale lanes (the narrow route), as training launches them
        for name, (din, h, dz) in cs.SCALE_LANE_MLPS.items():
            s = [torch.stack(t) for t in zip(*[
                cs._mlp_inputs(gen, Bs, din, h, dz) for _ in range(L)])]
            cases.append(("lane", f"{name} {din}->{h}->{dz} L={L} B={Bs} "
                          f"save", lambda s=s: lm.launch(*s, save=True)))
    if "bwd" in groups:
        for name, (din, h, dz) in cs.AE_SHAPES.items():
            a = cs._bwd_inputs(gen, cs.TRAIN_B, din, h, dz)
            cases.append(("bwd", f"{name} {din}->{h}->{dz} B={cs.TRAIN_B}",
                          lambda a=a: lm.launch_bwd(*a)))
        for name, (din, h, dz) in cs.SCALE_LANE_MLPS.items():
            a = cs._bwd_inputs(gen, Bs, din, h, dz, lanes=L)
            cases.append(("bwd", f"{name} {din}->{h}->{dz} L={L} B={Bs}",
                          lambda a=a: lm.launch_bwd(*a)))
    if "int8" in groups:
        for Bm in (cs.BUCKET, 16):
            for name, (d, c, act) in cs.INT8_LAYERS.items():
                a = cs._int8_inputs(gen, Bm, d, c)
                cases.append(("int8", f"{name} {d}->{c} B={Bm}",
                              lambda a=a, act=act: ops.int8_matmul(
                                  *a, act=act)))
    if "ssd" in groups:
        cfg = cs._zamba_cfg()
        B, S = cs.ZAMBA["prefill"]
        H, G, N, P, Lc = (cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state,
                          cfg.ssm_head_dim, cfg.ssm_chunk)
        a = cs._ssd_inputs(gen, B, S, H, G, N, P)
        cases.append(("ssd", f"B={B} S={S} H={H} G={G} N={N} P={P} Lc={Lc} "
                      f"fp32", lambda a=a: ops.ssd_intra_chunk(*a, Lc)))
    if "probe" in groups:
        n, d, C, k = (len(cs._scenario().active.x), 256, cs.N_CLASSES,
                      cs.PROBE_FOLDS)
        w, b, x, y, rw = cs._probe_inputs(gen, n, d, C, k)
        rwn = rw / rw.sum(-1, keepdim=True).clamp(min=1.0)
        cases.append(("probe", f"{k} fold lanes n={n} d={d} C={C}",
                      lambda a=(w, b, x, y, rwn): pr.launch(*a)))
    if "distill" in groups:
        B, D, M, lam = cs.TRAIN_B, cs.DISTILL["D"], cs.DISTILL["M"], \
            cs.DISTILL["lam"]
        a = cs._distill_inputs(gen, B, D, M)
        kw = dict(lam=lam, kind="mse")
        one = torch.ones(1, device="cuda")
        for what, fn in (
                ("forward, mean form", lambda: dl.launch_fwd(
                    *a, mean_of=B, **kw)),
                ("forward, rows form", lambda: dl.launch_fwd(*a, **kw)),
                ("backward, g3 form", lambda: dl.launch_bwd(
                    one, *a, mean_of=B, needs=cs.G3_NEEDS, **kw)),
                ("a g3 step's loss", cs._eq5_step(a, lam))):
            cases.append(("distill", f"{what} B={B} D={D} M={M}", fn))
        # the validation pass (a tenth of mimic3's or credit's 20,000 rows,
        # D 5 at both) and the whole of either, also at the widest rows
        for N, Dn, Mn in ((2000, D, M), (20000, D, M), (20000, 1024, 1000)):
            an = cs._distill_inputs(gen, N, Dn, Mn)
            for what, fn in (
                    ("forward, mean form", lambda a=an, N=N: dl.launch_fwd(
                        *a, mean_of=N, **kw)),
                    ("forward, rows form then torch.mean",
                     lambda a=an: torch.mean(dl.launch_fwd(*a, **kw)))):
                cases.append(("distill", f"{what} N={N} D={Dn} M={Mn}", fn))
            if args.before_distill:
                before.append((f"N={N} D={Dn} M={Mn}", an))
    summary = {}
    cluster_size, grouped_cluster = _launch.cluster_size, da.grouped_cluster
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
            sweep = kernel == "decode" or (kernel == "lane"
                                           and "L=" not in shape)
            for c in (CLUSTERS if sweep else ()):
                _launch.cluster_size = lambda *_, c=c: c
                da.grouped_cluster = lambda *_, c=c: c
                row[f"cluster {c}"] = cs.graph_ms(fn) * 1e3
                print(f"{kernel} {shape} | unchanged, cluster {c}: "
                      f"{row[f'cluster {c}']:.3f} us", flush=True)
        finally:
            _launch.cluster_size = cluster_size
            da.grouped_cluster = grouped_cluster
            setattr(module, attr, loader)
    if before:
        lib = _distill_before(args.before_distill)
        for shape, a in before:
            t = cs.graph_ms(lambda a=a: torch.mean(lib(*a))) * 1e3
            summary.setdefault("distill_before", {})[shape] = t
            print(f"distill before, rows then torch.mean {shape}: {t:.3f} us",
                  flush=True)
    smi = cs._smi()
    print(smi)
    print(json.dumps({"device": smi, "us": summary, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
