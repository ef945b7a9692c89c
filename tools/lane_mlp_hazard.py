#!/usr/bin/env python3
"""Look for a read of memory no thread wrote, or a missed barrier, in the
lane-MLP kernels, at the shape of
``tests/test_torch_gpu.py::test_lane_mlp_grads_through_function_with_dead_lane_on_card``
(L 3, B 77, din 256, h 256, dz 384, lane 1 dead).

    python3 tools/lane_mlp_hazard.py [--runs 200] [--jobs 8]

Runs the test's computation in ``--runs`` fresh processes, ``--jobs`` at a
time, and the same computation at a scale-lane shape that the kernels'
narrow route takes (L 3, B 300, 16 -> 32 -> 64, lane 1 dead; its keys are
prefixed ``narrow_``).  Each process (``--worker``) first does exactly
what the test does, on the card and on CPU copies, and holds each of the
five gradients to the test's 1e-5 relative bound; then it repeats the
card's gradients
- after filling the caching allocator's small blocks with NaN (so an
  output or scratch tensor from ``torch.empty`` holds NaN until written),
- after a kernel has filled every SM's shared memory with NaN,
- with the forward at every cluster size (1, 2, 4, 8), with and without
  the saved pre-activations,
- ``--repeats`` more times in the process (10),
and compares each result bit for bit with the first.  Every process writes
one JSON line (the SHA-256 of each gradient on the card and on the CPU);
the summary counts failures and distinct hashes across processes.  Then,
in one process, every output and scratch tensor of both kernels between
guard regions that must come back untouched, at four shapes and every
cluster size, and at four shapes of the narrow route with its tile
partials' scratch (writes out of bounds).

Writes ``lane_mlp_hazard.jsonl`` (one line per process) and
``lane_mlp_hazard_summary.json`` into ``--out`` (default: the ignored
``kernels/build/hazard/``), and prints the summary last.  Needs one card
and nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 1e-5                    # the test's bound, relative
POISON_CU = r"""
#include <cuda_runtime.h>
__global__ void poison_smem(int n) {
  extern __shared__ unsigned s[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = 0x7fc00000u;
}
extern "C" int poison(int blocks, void* stream) {
  const int bytes = 232448;
  static const cudaError_t a = cudaFuncSetAttribute(
      poison_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (a != cudaSuccess) return (int)a;
  poison_smem<<<blocks, 1024, bytes, (cudaStream_t)stream>>>(bytes / 4);
  return (int)cudaGetLastError();
}
"""


def _poison_lib():
    from repro_torch.kernels import _build
    out = os.path.join(_build.BUILD_DIR, "hazard")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "poison.cu"), os.path.join(out, "poison.so")
    if not os.path.exists(so):
        with open(cu, "w") as fh:
            fh.write(POISON_CU)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", tmp,
                        cu], check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.poison.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


def _randn(rng, *shape, scale=1.0):
    import torch
    return torch.from_numpy((rng.randn(*shape) * scale).astype("float32"))


def _mlp(seed, B, din, h, dz, dev, lanes=()):
    """The lane-MLP inputs (x, w0, b0, w1, b1) the card tests draw from
    ``seed``, on ``dev``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [t.to(dev) for t in (
        _randn(rng, *lanes, B, din),
        _randn(rng, *lanes, din, h, scale=din ** -0.5),
        _randn(rng, *lanes, h, scale=0.1),
        _randn(rng, *lanes, h, dz, scale=h ** -0.5),
        _randn(rng, *lanes, dz, scale=0.1))]


def _sha(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


# the test's shape, and a scale-lane shape on the narrow route (16 -> 32
# -> 64, ragged 300 rows, lane 1 dead): (L, B, din, h, dz)
CASES = {"test": (3, 77, 256, 256, 384), "narrow": (3, 300, 16, 32, 64)}


def _grads_fn(L, B, din, h, dz, dev):
    """The test's computation at this shape: the five gradients of
    sum(fused_lane_mlp2(...) * g) with lane 1 dead, from the test's seeds;
    returns (card step, its inputs, live, g)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    arrs = [t.requires_grad_(True)
            for t in _mlp(3, B, din, h, dz, dev, lanes=(L,))]
    live = torch.ones(L, device=dev)
    live[1] = 0.0
    g = _randn(np.random.RandomState(4), L, B, dz).to(dev)

    def card():
        out = ops.fused_lane_mlp2(*arrs, live)
        return [t.detach().clone() for t in torch.autograd.grad(
            torch.sum(out * g), arrs)]
    return card, arrs, live, g


def worker(repeats: int = 10) -> dict:
    import torch
    sys.path[:0] = [os.path.join(ROOT, "src")]
    from repro_torch.kernels import _launch, lane_mlp, ops
    dev = torch.device("cuda")
    res = {"pid": os.getpid()}
    steps = {}
    for case, shape in CASES.items():
        card, arrs, live, g = _grads_fn(*shape, dev)
        got = card()
        torch.cuda.synchronize()
        cpu = [t.detach().cpu().requires_grad_(True) for t in arrs]
        want = torch.autograd.grad(
            torch.sum(ops.fused_lane_mlp2(*cpu, live.cpu()) * g.cpu()), cpu)
        rel = [float((a.cpu() - b).abs().max()
                     / max(float(b.abs().max()), 1.0))
               for a, b in zip(got, want)]
        pre = "" if case == "test" else f"{case}_"
        res.update({f"{pre}rel": rel,
                    f"{pre}pass": max(rel) <= BOUND and all(
                        not bool(a[1].any()) for a in got),
                    f"{pre}card_sha": [_sha(a) for a in got],
                    f"{pre}cpu_sha": [_sha(b) for b in want]})
        steps[case] = (card, got, arrs)

    def same(case):
        card, got, _ = steps[case]
        return all(torch.equal(a, b) for a, b in zip(card(), got))

    # the caching allocator's small blocks (<= 1 MB) hold NaN
    junk = [torch.full((1 << 18,), float("nan"), device=dev)
            for _ in range(512)]
    del junk
    for case in CASES:
        pre = "" if case == "test" else f"{case}_"
        res[f"{pre}nan_allocator_same"] = same(case)
    # every SM's shared memory holds NaN before each launch of the step
    lib = _poison_lib()
    sms = _launch.sm_count(0)
    stream = torch.cuda.current_stream().cuda_stream
    launch, launch_bwd = lane_mlp.launch, lane_mlp.launch_bwd

    def poisoned(fn):
        def run(*a, **kw):
            assert lib.poison(4 * sms, stream) == 0
            return fn(*a, **kw)
        return run
    lane_mlp.launch, lane_mlp.launch_bwd = poisoned(launch), \
        poisoned(launch_bwd)
    try:
        for case in CASES:
            pre = "" if case == "test" else f"{case}_"
            res[f"{pre}nan_smem_same"] = same(case)
    finally:
        lane_mlp.launch, lane_mlp.launch_bwd = launch, launch_bwd
    # the forward at each cluster size, with and without save: the sum
    # order does not depend on the cluster, so neither do the bits
    xs, w0, b0, w1, b1 = (t.detach() for t in steps["test"][2])
    base = launch(xs, w0, b0, w1, b1, save=True)
    pick = _launch.cluster_size
    by_c = {}
    try:
        for c in (1, 2, 4, 8):
            _launch.cluster_size = lambda *a, c=c: c
            for save in (False, True):
                run = launch(xs, w0, b0, w1, b1, save=save)
                run = run if save else (run,)
                by_c[f"C{c} save={save}"] = all(
                    torch.equal(a, b) for a, b in zip(run, base))
    finally:
        _launch.cluster_size = pick
    res["cluster_same"] = by_c
    for case in CASES:
        pre = "" if case == "test" else f"{case}_"
        res[f"{pre}repeat_same"] = all(same(case) for _ in range(repeats))
    torch.cuda.synchronize()
    return res


SENTINEL = 0x7FBADBAD                 # a NaN no kernel computes
# the narrow route's shapes among the canaries: the scale lanes' encoder
# and decoder over ragged rows, one row, the widest widths
NARROW_SHAPES = ((16, 300, 16, 32, 64), (3, 77, 64, 32, 16),
                 (1, 1, 16, 32, 64), (2, 129, 64, 64, 64))
GUARD = 4096                          # floats of guard on each side


def canaries() -> dict:
    """Writes outside their tensors: each output and scratch tensor of the
    two kernels sits between GUARD floats of SENTINEL, which must survive,
    and the inputs must not change; at the test's shape and at one row,
    the training batch and many row tiles, at every cluster size."""
    import numpy as np
    import torch
    from repro_torch.kernels import lane_mlp
    dev = torch.device("cuda")
    fwd, bwd = lane_mlp._lib(), lane_mlp._lib_bwd()
    stream = torch.cuda.current_stream().cuda_stream
    bad = []
    for L, B, din, h, dz in ((3, 77, 256, 256, 384), (1, 1, 5, 64, 128),
                             (2, 128, 10, 128, 256), (1, 2000, 256, 256, 5),
                             *NARROW_SHAPES):
        xs, w0, b0, w1, b1 = _mlp(B, B, din, h, dz, dev, lanes=(L,))
        g = _randn(np.random.RandomState(B), L, B, dz).to(dev)
        inputs = [xs, w0, b0, w1, b1, g]
        before = [t.clone() for t in inputs]
        bufs = []

        def guarded(*shape):
            n = int(np.prod(shape))
            buf = torch.full((n + 2 * GUARD,), SENTINEL, dtype=torch.int32,
                             device=dev)
            bufs.append(buf)
            return buf[GUARD:GUARD + n].view(torch.float32).view(*shape)

        narrow = lane_mlp.route(din, h, dz) == "narrow"
        for c in ((0,) if narrow else (1, 2, 4, 8)):
            out, a1, a2 = guarded(L, B, dz), guarded(L, B, h), \
                guarded(L, B, dz)
            ptrs = [t.data_ptr() for t in (xs, w0, b0, w1, b1, out, a1, a2)]
            if narrow:
                assert fwd.lane_mlp_fwd_narrow(*ptrs, L, B, din, h, dz, 1,
                                               stream) == 0
            else:
                assert fwd.lane_mlp_fwd(*ptrs, L, B, din, h, dz, 1, c,
                                        stream) == 0
            grads = [guarded(L, B, din), guarded(L, din, h), guarded(L, h),
                     guarded(L, h, dz), guarded(L, dz)]
            if narrow:
                part = guarded(*lane_mlp.partial_shape(L, B, din, h, dz))
                assert bwd.lane_mlp_bwd_narrow(
                    *(t.data_ptr() for t in (g, xs, a1, a2, w0, w1, *grads,
                                             part)),
                    L, B, din, h, dz, 1, part.shape[1], stream) == 0
            else:
                grads.append(guarded(L, B, h))
                assert bwd.lane_mlp_bwd(
                    *(t.data_ptr() for t in (g, xs, a1, a2, w0, w1,
                                             *grads)),
                    L, B, din, h, dz, 1, stream) == 0
        torch.cuda.synchronize()
        for buf in bufs:
            if not (bool((buf[:GUARD] == SENTINEL).all())
                    and bool((buf[-GUARD:] == SENTINEL).all())):
                bad.append(f"guard written at L {L} B {B}")
        if not all(torch.equal(a, b) for a, b in zip(inputs, before)):
            bad.append(f"input changed at L {L} B {B}")
    return {"shapes": 4 + len(NARROW_SHAPES), "cluster_sizes": [1, 2, 4, 8],
            "faults": bad}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--repeats", type=int, default=10,
                    help="in-process repeats of a worker")
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", help="directory of the JSON files")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src")]
    if args.worker:
        print(json.dumps(worker(args.repeats)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("lane_mlp_hazard: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    _build.build_all()
    _poison_lib()
    out_dir = args.out or os.path.join(_build.BUILD_DIR, "hazard")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    lines, errors, running = [], [], []
    todo = list(range(args.runs))
    while todo or running:
        while todo and len(running) < args.jobs:
            todo.pop()
            running.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        p = running.pop(0)
        out, err = p.communicate()
        if p.returncode:
            errors.append(err[-2000:])
        else:
            lines.append(json.loads(out.strip().splitlines()[-1]))
    with open(os.path.join(out_dir, "lane_mlp_hazard.jsonl"), "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in lines)
    checks = [f"{pre}{k}" for pre in ("", "narrow_")
              for k in ("nan_allocator_same", "nan_smem_same", "repeat_same")]
    summary = {
        "processes": len(lines), "process_errors": len(errors),
        "first_error": errors[0] if errors else None,
        "bits_differ": {k: sum(not r[k] for r in lines) for k in checks},
        "cluster_bits_differ": sum(not all(r["cluster_same"].values())
                                   for r in lines),
        "cases": {case: dict(zip(("L", "B", "din", "h", "dz"), shape))
                  for case, shape in CASES.items()},
        "seconds": time.perf_counter() - t0,
        **{k: v for pre in ("", "narrow_") for k, v in {
            f"{pre}failed": sum(not r[f"{pre}pass"] for r in lines),
            f"{pre}max_rel": [max(r[f"{pre}rel"][i] for r in lines)
                              for i in range(5)] if lines else None,
            f"{pre}distinct_card_sha": len({tuple(r[f"{pre}card_sha"])
                                            for r in lines}),
            f"{pre}distinct_cpu_sha": len({tuple(r[f"{pre}cpu_sha"])
                                           for r in lines})}.items()},
        "device": torch.cuda.get_device_name(0)}
    summary["canaries"] = canaries()
    with open(os.path.join(out_dir, "lane_mlp_hazard_summary.json"),
              "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary))
    ok = (lines and not errors and not summary["failed"]
          and not summary["narrow_failed"]
          and summary["distinct_card_sha"] == 1
          and summary["narrow_distinct_card_sha"] == 1
          and not any(summary["bits_differ"].values())
          and not summary["cluster_bits_differ"]
          and not summary["canaries"]["faults"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
