"""Train an APC-VFL model with the PyTorch/CUDA port, export it and serve
it: train -> export -> round-trip through the checkpoint layer -> drive a
simulated request stream through ``repro_torch.serve.vfl``.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_vfl --smoke
      PYTHONPATH=src python -m repro_torch.launch.serve_vfl --dataset bcw \
          --aligned 150 --epochs 30 --requests 5000 --bundle /tmp/apcvfl
      PYTHONPATH=src python -m repro_torch.launch.serve_vfl \
          --load /tmp/apcvfl --dataset bcw --aligned 150 --requests 1000
      ... --quantize int8          # int8 active path (int8 matmul kernel)
      ... --device cpu             # the plain path, no card needed
      ... --n-parties 3            # one active and two passive parties
      PYTHONPATH=src python -m repro_torch.launch.serve_vfl \
          --load /tmp/apcvfl --dataset bcw --aligned 150 \
          --arrival poisson --rate-rps 300 --slo-ms 100 \
          [--fault examples/faults/passive_dropout.json]

Without ``--load`` it trains ``run_apcvfl`` with ``use_kernel=True`` (on
the card every autoencoder and the Eq. 5 loss go through the kernels),
exports the bundle, saves it (to ``--bundle`` or a temporary directory),
reloads it, asserts that the reloaded bundle predicts identically and
serves the reloaded copy.  ``--load`` serves an existing bundle from
either package (both write the same checkpoint format); the scenario is
rebuilt only to source request features.  The engine is warmed over
every bucket shape before the stream (on CUDA that builds and loads the
kernels), so the stream's latencies are serving, not set-up.
``--n-parties K`` (K > 2) trains ``multiparty.run_apcvfl_k`` on a K-party
split instead (``make_scenario_k``); the bundle caches the concat of the
K-1 passive latent blocks.

``--arrival poisson|bursty`` switches from the backlog drain
(``serve_stream``) to the live serving runtime (``serve.runtime``):
requests arrive on a seeded virtual clock, the SLO-aware scheduler
micro-batches them with admission control, and queueing latency is
reported apart from service latency, with SLO attainment and shed rate.
``--fault PLAN.json`` injects a ``robustness.faults.FaultPlan`` into that
runtime (its events target tenant ``default``); the backlog drain has no
clock to fire events on, so ``--fault`` with ``--arrival stream`` is
refused.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import multiparty, pipeline
from repro_torch.data.synthetic import make_dataset
from repro_torch.data.vertical import make_scenario
from repro_torch.robustness.faults import FaultPlan
from repro_torch.serve import quant
from repro_torch.serve import runtime as rt
from repro_torch.serve import vfl as sv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="train, export and serve APC-VFL (PyTorch port)")
    ap.add_argument("--dataset", default="bcw")
    ap.add_argument("--aligned", type=int, default=150)
    ap.add_argument("--n-parties", type=int, default=2,
                    help="parties: one active, the rest passive")
    ap.add_argument("--active-features", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--max-rows", type=int, default=64,
                    help="largest request size in the simulated stream")
    ap.add_argument("--p-known", type=float, default=0.5,
                    help="probability a request row keeps its real id "
                         "(cache candidate)")
    ap.add_argument("--buckets", default="16,32,64,128,256")
    ap.add_argument("--quantize", choices=["none", "int8"], default="none",
                    help="'int8' serves the active path from per-channel "
                         "symmetric int8 weights (serve.quant) and prints "
                         "the fp32-parity report")
    ap.add_argument("--arrival", choices=["stream", "poisson", "bursty"],
                    default="stream",
                    help="'stream' = drain the request list as a backlog "
                         "(serve_stream); 'poisson'/'bursty' = live "
                         "arrival-clocked runtime with SLO micro-batching")
    ap.add_argument("--rate-rps", type=float, default=200.0,
                    help="arrival rate for --arrival poisson/bursty")
    ap.add_argument("--slo-ms", type=float, default=100.0,
                    help="end-to-end latency SLO for the live runtime")
    ap.add_argument("--queue-rows", type=int, default=4096,
                    help="admission bound: queued rows beyond this shed")
    ap.add_argument("--fault", default=None, metavar="PLAN.json",
                    help="inject a robustness.faults.FaultPlan into the "
                         "live runtime (requires --arrival poisson|"
                         "bursty); events target tenant 'default' (see "
                         "examples/faults/passive_dropout.json)")
    ap.add_argument("--bundle", default=None,
                    help="save the exported bundle here and serve the "
                         "RELOADED copy (round-trip proof)")
    ap.add_argument("--load", default=None,
                    help="serve this bundle (path without .npz) instead of "
                         "training")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny settings: 2 epochs, 300 requests")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on (default cuda)")
    ap.add_argument("--out", default=None,
                    help="also write the stream stats JSON here")
    args = ap.parse_args(argv)
    if args.smoke:
        args.epochs = min(args.epochs, 2)
        args.requests = min(args.requests, 300)
    if args.n_parties < 2:
        ap.error("--n-parties needs at least 2 (one active, one passive)")
    plan = None
    if args.fault:
        if args.arrival == "stream":
            ap.error("--fault needs the live runtime: use --arrival "
                     "poisson or bursty (the backlog drain has no clock "
                     "to trigger events on)")
        plan = FaultPlan.load(args.fault)
        print(f"fault plan {plan.name!r}: "
              f"{len(plan.serving_events())} serving events")
    device = resolve_device(args.device)

    ds = make_dataset(args.dataset, seed=args.seed)
    if args.n_parties == 2:
        sc = make_scenario(ds, n_active_features=args.active_features,
                           n_aligned=args.aligned, seed=args.seed)
    else:
        sc = multiparty.make_scenario_k(
            ds, n_parties=args.n_parties,
            n_active_features=args.active_features,
            n_aligned=args.aligned, seed=args.seed)
    train_info = None
    if args.load:
        bundle = sv.ModelBundle.load(args.load)
        print(f"loaded bundle {args.load}: {bundle.meta}")
        # the scenario here only sources request features/ids: refuse a
        # bundle trained on a different feature split or dataset before
        # the mismatch surfaces as a shape error (or mis-keyed routing)
        d = sc.active.x.shape[1]
        want_d = bundle.meta.get("n_features_active")
        if want_d is not None and int(want_d) != d:
            ap.error(f"bundle expects {want_d} active features but the "
                     f"rebuilt scenario has {d}; rerun with the training "
                     f"flags (--dataset/--active-features/--seed)")
        want_ds = bundle.meta.get("dataset")
        if want_ds and want_ds != args.dataset:
            ap.error(f"bundle was trained on dataset {want_ds!r}, not "
                     f"{args.dataset!r}")
    else:
        bundle, train_info = _train_and_export(args, sc, device)

    buckets = [int(b) for b in args.buckets.split(",") if b]
    quantize = None if args.quantize == "none" else args.quantize
    if quantize:
        parity = quant.parity_report(bundle, sc.active.x, sc.active.y,
                                     n_classes=sc.n_classes, device=device)
        print(f"int8 parity vs fp32: max|dlogit|="
              f"{parity['max_abs_logit_delta']:.4f} "
              f"(rel {parity['rel_logit_delta']:.4f}), flip rate "
              f"{parity['pred_flip_rate']:.4f}, "
              f"{parity['compression']}x weight compression")
    dev_name = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
    if args.arrival != "stream":
        stats = _serve_live(args, sc, bundle, buckets, quantize, plan,
                            device, dev_name)
    else:
        engine = sv.VFLServingEngine(bundle, buckets=buckets,
                                     quantize=quantize, device=device)
        engine.warmup()
        requests = sv.make_request_stream(
            sc.active.x, sc.active.ids, args.requests, seed=args.seed + 1,
            max_rows=args.max_rows, p_known=args.p_known)
        stats = sv.serve_stream(engine, requests)
        print(f"\n=== served {stats['requests']} requests "
              f"({stats['rows']} rows) in {stats['wall_s']}s on "
              f"{dev_name} ===")
        print(f"throughput: {stats['rows_per_s']} rows/s "
              f"({stats['requests_per_s']} req/s)")
        print(f"latency p50/p99: {stats['latency_ms_p50']} / "
              f"{stats['latency_ms_p99']} ms (service; queueing separate "
              f"in latency_ms block)")
        print(f"cache hit-rate: {stats['cache_hit_rate']}  "
              f"dispatches: {stats['dispatches']}")
        print(f"batch shapes: {stats['compiled']['by_path']} "
              f"(distinct: {stats['compiled']['distinct_batch_shapes']})")
    stats["device"] = {"type": device.type, "name": dev_name}
    if train_info is not None:
        stats["train"] = train_info
    if quantize:
        stats["quant"] = parity
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(stats, fh, indent=1)
        print(f"wrote {args.out}")
    return 0


def _serve_live(args, sc, bundle, buckets, quantize, plan, device,
                dev_name) -> dict:
    """The arrival-clocked runtime with one tenant, ``default``: a seeded
    timed stream, served under the SLO and admission bound (and the fault
    plan); returns the runtime's report."""
    registry = rt.TenantRegistry(buckets=buckets, device=device)
    engine = registry.register("default", bundle, quantize=quantize)
    engine.warmup()
    stream = rt.make_timed_stream(
        sc.active.x, sc.active.ids, args.requests, tenant="default",
        arrivals=args.arrival, rate_rps=args.rate_rps, seed=args.seed + 1,
        max_rows=args.max_rows, p_known=args.p_known)
    runtime = rt.ServingRuntime(
        registry, rt.RuntimeConfig(slo_ms=args.slo_ms,
                                   max_queue_rows=args.queue_rows))
    stats = runtime.run(stream, faults=plan)
    lat = stats["latency_ms"]
    print(f"\n=== {args.arrival} arrivals at {args.rate_rps} req/s on "
          f"{dev_name}: served {stats['served']}/{stats['requests']} "
          f"requests ({stats['rows']} rows) in "
          f"{stats['virtual_elapsed_ms']:.0f} virtual ms ===")
    print(f"throughput: {stats['rows_per_s']} rows/s over "
          f"{stats['dispatches']} micro-batches "
          f"(mean {stats['mean_batch_rows']} rows)")
    print(f"queueing  p50/p99: {lat['queue']['p50']} / "
          f"{lat['queue']['p99']} ms")
    print(f"service   p50/p99: {lat['service']['p50']} / "
          f"{lat['service']['p99']} ms")
    print(f"SLO {args.slo_ms} ms: attainment "
          f"{stats['slo']['attainment']}  shed rate {stats['shed_rate']}")
    print(f"batch shapes: {stats['compiled']['by_path']} "
          f"(distinct: {stats['compiled']['distinct_batch_shapes']})")
    if plan is not None:
        fb = stats["faults"]["tenants"].get("default", {})
        print(f"faults: applied {stats['faults']['events_applied']} "
              f"events, faulted={fb.get('faulted')}, "
              f"collab_while_faulted="
              f"{fb.get('collab_dispatches_while_faulted')}, "
              f"cache_stale={fb.get('cache_stale')}, "
              f"cache_version={fb.get('cache_version')}")
    return stats


def _train_and_export(args, sc, device):
    """Train ``run_apcvfl`` (``run_apcvfl_k`` for K > 2 parties) through
    the kernels, export, save, reload and check the round trip.  Returns
    the reloaded bundle and a JSON-ready summary of the training run."""
    print(f"training apcvfl on {args.dataset} (K={args.n_parties}, "
          f"aligned={args.aligned}, epochs<={args.epochs}) on {device} ...")
    run = (pipeline.run_apcvfl if args.n_parties == 2
           else multiparty.run_apcvfl_k)
    t0 = time.perf_counter()
    result = run(sc, seed=args.seed, max_epochs=args.epochs,
                 use_kernel=True, device=device)
    seconds = time.perf_counter() - t0
    print(f"trained in {seconds:.1f}s: acc={result.metrics['accuracy']:.4f} "
          f"epochs={result.epochs}")
    bundle = sv.export_bundle(result, sc)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.bundle or os.path.join(tmp, "bundle")
        bundle.save(path)
        reloaded = sv.ModelBundle.load(path)     # eager: outlives tmp
    probe = np.asarray(sc.active.x[:32], np.float32)
    a = sv.VFLServingEngine(bundle, device=device).predict_active(probe)
    b = sv.VFLServingEngine(reloaded, device=device).predict_active(probe)
    if not np.array_equal(a, b):
        raise RuntimeError("bundle round-trip changed predictions")
    where = f"{args.bundle}.npz" if args.bundle else "(ephemeral)"
    print(f"bundle saved -> {where} (round-trip verified, "
          f"{reloaded.meta['n_cached']} cached latents)")
    info = {"seconds": seconds, "metrics": result.metrics,
            "rounds": result.rounds, "epochs": result.epochs,
            "comm": result.comm,
            "train_loss": result.train_loss, "steps": result.steps,
            "stage_seconds": result.seconds}
    return reloaded, info


if __name__ == "__main__":
    sys.exit(main())
