#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. build  — compile every kernel of the serving path from ``csrc/*.cu``
   (one ``nvcc`` per source, all at once) and print ``-Xptxas -v``.
2. check  — hold each kernel against its plain PyTorch version on the
   card: the lane-MLP forward at the three Table-3 encoder shapes x
   B in {16, 77, 256, 4096} within 1e-4 max-abs, the int8 matmul at the
   three quantized layers within 1e-5 (the reference's pinned bounds).
3. serve  — a full-width bundle (Table-3 g3, g1_active, g2; random heads;
   10000 cached latents) on the paper's largest scenario (mimic3, 5 active
   features, 10000 aligned rows), served by
   ``repro_torch.launch.serve_vfl.main`` in fp32 and then int8.  Launch
   counters are zeroed just before each run and read just after; both
   kernels must have launched.  The card's logits are held against the
   CPU engine's on mixed-id rows.
4. time   — at the bucket-256 shapes: kernel, plain-version and library
   times (CUDA events over CUDA-graph replays, so host launch overhead is
   excluded) and the work bound; then the stream's rows/s and p50/p99,
   served fp32, int8, int8, fp32 by warmed engines.

The last lines are a ``details:`` line (every measurement as JSON), the
``kernels`` JSON, the card's name and power limit, and
``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_FP32_FLOPS = 67e12        # H100 SXM, fp32 on the CUDA cores
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3
TOL_MLP = 1e-4                 # lane-MLP forward vs plain, max-abs
TOL_INT8 = 1e-5                # int8 matmul vs plain, max-abs
TOL_ENGINE = 1e-4              # card engine vs CPU engine (sum order)
# Table-3 encoders on the serving path: (din, h, dz)
ENCODERS = {"g1_active": (5, 64, 128), "g3": (5, 256, 256),
            "g2": (384, 256, 256)}
BATCHES = (16, 77, 256, 4096)
N_CLASSES = 4                  # mimic3
# the three layers of the int8 active path: (d, c, act)
INT8_LAYERS = {"l0_selu": (5, 256, "selu"), "l1": (256, 256, "none"),
               "head": (256, N_CLASSES, "none")}
BUCKET = 256
SCENARIO = dict(dataset="mimic3", active_features=5, aligned=10000,
                requests=2000, seed=0)


def log(msg: str) -> None:
    print(msg, flush=True)


def _require(ok: bool, what) -> None:
    """A failed check ends the run (kept under ``python -O``, unlike
    ``assert``)."""
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def _rand(gen, shape, scale=1.0):
    import torch
    return (torch.randn(shape, generator=gen) * scale).cuda()


def _mlp_inputs(gen, B, din, h, dz):
    return (_rand(gen, (B, din)), _rand(gen, (din, h), din ** -0.5),
            _rand(gen, (h,), 0.1), _rand(gen, (h, dz), h ** -0.5),
            _rand(gen, (dz,), 0.1))


def _int8_inputs(gen, B, d, c):
    import torch
    from repro_torch.serve import quant
    w_q, scale = quant.quantize_weight(
        torch.randn((d, c), generator=gen) * d ** -0.5)
    return (_rand(gen, (B, d)), torch.from_numpy(w_q).cuda(),
            torch.from_numpy(scale).cuda(), _rand(gen, (c,), 0.1))


def _maxerr(a, b) -> float:
    return float((a - b).abs().max())


def phase_build() -> None:
    from repro_torch.kernels import _build
    log("=== phase 1: build ===")
    for name, text in _build.build_all().items():
        log(f"--- {name}.cu: ptxas -v ---\n{text.strip()}")


def phase_check() -> dict:
    import torch
    from repro_torch.kernels import lane_mlp, ops, ref
    log("=== phase 2: kernels vs plain versions on the card ===")
    gen = torch.Generator().manual_seed(1)
    err = {"lane_mlp_fwd": 0.0, "int8_matmul": 0.0}
    for name, (din, h, dz) in ENCODERS.items():
        for B in BATCHES:
            x, w0, b0, w1, b1 = _mlp_inputs(gen, B, din, h, dz)
            for fa in (False, True):
                got = ops.fused_mlp2(x, w0, b0, w1, b1, final_act=fa)
                want = ref.mlp2_ref(x, w0, b0, w1, b1, final_act=fa)
                torch.cuda.synchronize()
                e = _maxerr(got, want)
                log(f"lane_mlp_fwd {name} B={B} final_act={fa}: "
                    f"max|err| {e:.3e}")
                _require(e <= TOL_MLP, (name, B, fa, e))
                err["lane_mlp_fwd"] = max(err["lane_mlp_fwd"], e)
    # saved pre-activations (the training slice's residuals), lane axis L=3
    din, h, dz = ENCODERS["g2"]
    stack = [torch.stack(t) for t in zip(*[_mlp_inputs(gen, 77, din, h, dz)
                                           for _ in range(3)])]
    out, a1, a2 = lane_mlp.launch(*stack, final_act=True, save=True)
    xs, w0s, b0s, w1s, b1s = stack
    a1_ref = xs @ w0s + b0s[:, None]
    a2_ref = ref.selu(a1_ref) @ w1s + b1s[:, None]
    torch.cuda.synchronize()
    for what, got, want in (("out", out, ref.selu(a2_ref)),
                            ("a1", a1, a1_ref), ("a2", a2, a2_ref)):
        e = _maxerr(got, want)
        log(f"lane_mlp_fwd L=3 save {what}: max|err| {e:.3e}")
        _require(e <= TOL_MLP, (what, e))
        err["lane_mlp_fwd"] = max(err["lane_mlp_fwd"], e)
    for name, (d, c, act) in INT8_LAYERS.items():
        for B in BATCHES:
            x, w_q, scale, b = _int8_inputs(gen, B, d, c)
            got = ops.int8_matmul(x, w_q, scale, b, act=act)
            want = ref.int8_matmul_ref(x, w_q, scale, b)
            want = ref.selu(want) if act == "selu" else want
            torch.cuda.synchronize()
            e = _maxerr(got, want)
            log(f"int8_matmul {name} {d}->{c} B={B}: max|err| {e:.3e}")
            _require(e <= TOL_INT8, (name, B, e))
            err["int8_matmul"] = max(err["int8_matmul"], e)
    return err


def make_bundle(seed: int = 0):
    """A full-width serving bundle for the SCENARIO with random weights
    from a seeded generator (no training: serving cost and correctness do
    not depend on the weights' values)."""
    import torch
    from repro_torch import convert
    from repro_torch.core import autoencoder as ae
    from repro_torch.core.psi import psi
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.data.vertical import make_scenario
    from repro_torch.serve.vfl import ModelBundle
    ds = make_dataset(SCENARIO["dataset"], seed=SCENARIO["seed"])
    sc = make_scenario(ds, n_active_features=SCENARIO["active_features"],
                       n_aligned=SCENARIO["aligned"], seed=SCENARIO["seed"])
    gen = torch.Generator().manual_seed(seed)
    d_a = sc.active.x.shape[1]
    g1p_z = ae.table3_encoder("g1_passive", sc.passive.x.shape[1])[-1]
    g1a = ae.table3_encoder("g1_active", d_a)
    init = lambda w: convert.to_numpy(
        ae.init_autoencoder(gen, w, device="cpu"))
    head = lambda: {"w": (torch.randn((256, sc.n_classes), generator=gen)
                          / 16).numpy(),
                    "b": (torch.randn((sc.n_classes,), generator=gen)
                          * 0.1).numpy()}
    aligned, _, _ = psi(sc.active.ids, sc.passive.ids)
    bundle = ModelBundle(
        meta={"method": "apcvfl", "dataset": SCENARIO["dataset"],
              "n_classes": int(sc.n_classes), "z_dim": 256,
              "n_features_active": int(d_a), "seed": seed,
              "n_cached": int(len(aligned))},
        g3=init(ae.table3_encoder("g3", d_a)), head_active=head(),
        x_mean=np.zeros(d_a, np.float32), x_scale=np.ones(d_a, np.float32),
        g1_active=init(g1a), g2=init(ae.table3_encoder("g2", g1a[-1] + g1p_z)),
        head_joint=head(), cache_ids=aligned.astype(np.int64),
        cache_z=torch.randn((len(aligned), g1p_z), generator=gen).numpy())
    return sc, bundle


def phase_serve() -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_vfl
    from repro_torch.serve import quant
    from repro_torch.serve.vfl import ModelBundle, VFLServingEngine
    log("=== phase 3: serve a full-width bundle on mimic3 ===")
    sc, bundle = make_bundle()
    res = {"launches": {k: 0 for k in ops.LAUNCHES}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bundle")
        bundle.save(path)
        bundle = ModelBundle.load(path)
        for mode in ("none", "int8"):
            out = os.path.join(tmp, f"stats_{mode}.json")
            argv = ["--load", path, "--dataset", SCENARIO["dataset"],
                    "--aligned", str(SCENARIO["aligned"]),
                    "--active-features", str(SCENARIO["active_features"]),
                    "--requests", str(SCENARIO["requests"]),
                    "--quantize", mode, "--out", out]
            ops.reset_launches()
            rc = serve_vfl.main(argv)
            counts = dict(ops.LAUNCHES)
            _require(rc == 0, rc)
            with open(out) as fh:
                stats = json.load(fh)
            log(f"serve {mode}: launches {counts}")
            _require(counts["lane_mlp_fwd"] > 0,
                     "lane-MLP kernel never ran")
            if mode == "int8":
                _require(counts["int8_matmul"] > 0,
                         "int8 kernel never ran")
                q = stats["quant"]
                _require(q["max_abs_logit_delta"] <= quant.MAX_LOGIT_DELTA
                         and q["rel_logit_delta"]
                         <= quant.MAX_REL_LOGIT_DELTA, q)
            _require(stats["cache_hit_rate"] > 0, stats["cache_hit_rate"])
            _require(stats["rows"] > 0 and stats["dispatches"], stats)
            for k, v in counts.items():
                res["launches"][k] += v
            res[mode] = {k: stats[k] for k in (
                "requests", "rows", "wall_s", "rows_per_s", "latency_ms_p50",
                "latency_ms_p99", "cache_hit_rate", "dispatches",
                "padded_rows")}
            res[mode]["launches"] = counts
            if mode == "int8":
                res[mode]["quant"] = stats["quant"]

    # launches per micro-batch, and the card's logits vs the CPU engine's
    rng = np.random.RandomState(2)
    rows = rng.randint(0, len(sc.active.x), 300)
    x = sc.active.x[rows]
    ids = sc.active.ids[rows].copy()
    ids[::2] = -7                     # half the rows miss the cache
    hit_rows = np.isin(sc.active.ids, bundle.cache_ids)
    x_hit = sc.active.x[hit_rows][:BUCKET]
    ids_hit = sc.active.ids[hit_rows][:BUCKET]
    per_batch = {}
    for quantize in (None, "int8"):
        gpu = VFLServingEngine(bundle, quantize=quantize, device="cuda")
        cpu = VFLServingEngine(bundle, quantize=quantize, device="cpu")
        got, want = gpu.predict(x, ids), cpu.predict(x, ids)
        _require(got.shape == (len(x), N_CLASSES)
                 and bool(np.isfinite(got).all()),
                 f"logits not finite or of shape {got.shape}")
        e = float(np.abs(got - want).max())
        log(f"engine card vs cpu (quantize={quantize}): max|dlogit| "
            f"{e:.3e}")
        _require(e <= TOL_ENGINE, e)
        res[f"engine_err_{quantize or 'fp32'}"] = e
        for path, call in (("active", lambda: gpu.predict_active(x_hit)),
                           ("collab", lambda: gpu.predict(x_hit, ids_hit))):
            ops.reset_launches()
            call()
            per_batch[f"{quantize or 'fp32'}/{path}"] = dict(ops.LAUNCHES)
    log(f"launches per {BUCKET}-row micro-batch: {per_batch}")
    for key, want in (("fp32/active", (1, 0)), ("fp32/collab", (2, 0)),
                      ("int8/active", (0, 3))):
        got = (per_batch[key]["lane_mlp_fwd"], per_batch[key]["int8_matmul"])
        _require(got == want, f"{key}: launches {got}, expected {want}")
    res["launches_per_batch"] = per_batch
    torch.cuda.synchronize()
    return res


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one ``fn()`` (ms): ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * iters)


def _bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_time() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    log(f"=== phase 4: timing at the bucket-{BUCKET} shapes ===")
    gen = torch.Generator().manual_seed(3)
    B = BUCKET
    sets = {"lane_mlp_fwd": [], "int8_matmul": []}
    for name, (din, h, dz) in ENCODERS.items():
        x, w0, b0, w1, b1 = _mlp_inputs(gen, B, din, h, dz)
        flops = 2.0 * B * (din * h + h * dz)
        nbytes = 4.0 * (B * din + din * h + h + h * dz + dz + B * dz)
        sets["lane_mlp_fwd"].append(dict(
            shape=f"{name} {din}->{h}->{dz} B={B}", flops=flops,
            bytes=nbytes,
            kernel=lambda a=(x, w0, b0, w1, b1): ops.fused_mlp2(*a),
            plain=lambda a=(x, w0, b0, w1, b1): ref.mlp2_ref(*a),
            library=lambda a=(x, w0, b0, w1, b1): torch.addmm(
                a[4], F.selu(torch.addmm(a[2], a[0], a[1])), a[3])))
    for name, (d, c, act) in INT8_LAYERS.items():
        x, w_q, scale, b = _int8_inputs(gen, B, d, c)
        flops = 2.0 * B * d * c
        nbytes = 4.0 * B * d + d * c + 8.0 * c + 4.0 * B * c
        sel = (lambda t: F.selu(t)) if act == "selu" else (lambda t: t)
        plain_sel = ref.selu if act == "selu" else (lambda t: t)
        sets["int8_matmul"].append(dict(
            shape=f"{name} {d}->{c} B={B}", flops=flops, bytes=nbytes,
            kernel=lambda a=(x, w_q, scale, b), act=act: ops.int8_matmul(
                *a, act=act),
            plain=lambda a=(x, w_q, scale, b), s=plain_sel: s(
                ref.int8_matmul_ref(*a)),
            library=lambda a=(x, w_q, scale, b), s=sel: s(torch.addmm(
                a[3], a[0], a[1].float() * a[2]))))
    res = {}
    for kname, items in sets.items():
        per_shape = []
        for it in items:
            row = {"shape": it["shape"]}
            for which in ("kernel", "plain", "library"):
                row[f"{which}_ms"] = graph_ms(it[which])
            row["bound_ms"], row["bound_by"] = _bound_ms(it["flops"],
                                                         it["bytes"])
            per_shape.append(row)
            log(f"{kname} {row}")
        bound, by = _bound_ms(sum(i["flops"] for i in items),
                              sum(i["bytes"] for i in items))
        res[kname] = {
            "ms": sum(r["kernel_ms"] for r in per_shape),
            "plain_ms": sum(r["plain_ms"] for r in per_shape),
            "library_ms": sum(r["library_ms"] for r in per_shape),
            "bound_ms": bound, "bound_by": by, "per_shape": per_shape}
    return res


def phase_turns() -> list:
    """The same request stream served fp32, int8, int8, fp32 by warmed
    engines in one process, so the two modes are compared in turns and
    not in the order phase 3 ran them."""
    from repro_torch.serve import vfl
    log("=== phase 4b: fp32 and int8 streams in turns ===")
    sc, bundle = make_bundle()
    engines = {mode: vfl.VFLServingEngine(bundle, quantize=q, device="cuda")
               for mode, q in (("fp32", None), ("int8", "int8"))}
    for eng in engines.values():
        eng.warmup()
    turns = []
    for mode in ("fp32", "int8", "int8", "fp32"):
        reqs = vfl.make_request_stream(sc.active.x, sc.active.ids,
                                       SCENARIO["requests"],
                                       seed=SCENARIO["seed"] + 1)
        engines[mode].reset_stats()
        st = vfl.serve_stream(engines[mode], reqs)
        turns.append({"mode": mode, "rows_per_s": st["rows_per_s"],
                      "latency_ms_p50": st["latency_ms_p50"],
                      "latency_ms_p99": st["latency_ms_p99"]})
        log(f"turn {turns[-1]}")
    return turns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card on this host; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import ops

    phase_build()
    errs = phase_check()
    serve = phase_serve()
    timing = phase_time()
    turns = phase_turns()

    srcs = {"lane_mlp_fwd": ("src/repro_torch/kernels/csrc/lane_mlp_fwd.cu",
                             "src/repro/kernels/lane_mlp.py:57"),
            "int8_matmul": ("src/repro_torch/kernels/csrc/int8_matmul.cu",
                            "src/repro/kernels/int8_matmul.py:35")}
    kernels = []
    for name in ops.LAUNCHES:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": srcs[name][0],
            "replaces": srcs[name][1],
            "launches": serve["launches"][name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    stream = {m: {k: serve[m][k] for k in ("rows_per_s", "latency_ms_p50",
                                           "latency_ms_p99")}
              for m in ("none", "int8")}
    log(f"stream (mimic3, {SCENARIO['requests']} requests): {stream}")
    log("details: " + json.dumps({"timing": timing, "serve": serve,
                                  "turns": turns,
                                  "torch": torch.__version__,
                                  "cuda": torch.version.cuda}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
