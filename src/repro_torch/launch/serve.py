"""Serve a dense or MoE decoder through the continuous-batching engine
with the PyTorch/CUDA port: random weights from a seeded
``torch.Generator``, seeded requests, greedy decode.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve \
          --arch qwen3-moe-30b-a3b --device cpu        # the MoE smoke
      PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \
          --batch 8 --slots 1024 --prefill-len 128 --requests 32 \
          --prompt-len 16 128 --max-new 64 --out /tmp/lm.json
      PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \
          --arch qwen3-moe-30b-a3b --batch 8 --slots 1024 \
          --prefill-len 128 --requests 16 --prompt-len 16 128 \
          --max-new 32                         # the card: 56.9 GiB in bf16

The engine serves the families with a KV cache, dense and MoE
(``kimi-k2-1t-a32b`` only as ``--smoke``: 1.04e12 params fit no card);
``--arch hubert-xlarge``, the zamba2 hybrid and the VLM are refused
before any weight is made, with the reference engine's reason (the VLM
serves through ``serve/decode.py``'s ``prefill_step`` and
``make_decode_step`` from ``M.init_cache(..., image_embeds=)``).

The flags are the reference CLI's (``repro.launch.serve``) plus
``--device`` (default ``cuda``; a host without a card refuses it),
``--prefill-len``, ``--prompt-len`` and ``--out``.  The weights always draw
from seed 0, as the reference's from ``PRNGKey(0)``.  Two faults
of the reference CLI are not copied: ``--smoke`` there is a
``store_true`` flag that defaults to True, so the full config can never
be chosen (here ``--smoke/--no-smoke``); and it builds fp32 params for any
config, which fails the reference's engine under the full config's
bfloat16 (here the params are built in ``cfg.dtype``, norm scales fp32).

On the card every prefill attention is one flash-attention launch per
layer and every decode step one decode-attention launch per layer.  The
engine runs with ``use_flash_kernel`` set, so on the CPU the same calls take
the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request, require_kv_cache_family
from repro_torch.sharding.policy import init_params


def make_requests(n: int, vocab: int, *, lo: int, hi: int, max_new: int,
                  seed: int = 0) -> list:
    """``n`` requests with prompt lengths in ``[lo, hi)`` and token ids
    from ``np.random.RandomState(seed)``, drawn as the reference CLI draws
    them (a length, then that many ids, per request)."""
    rng = np.random.RandomState(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.randint(lo, hi))
        reqs.append(Request(rid, rng.randint(0, vocab, plen).astype(np.int32),
                            max_new=max_new))
    return reqs


def build_params(cfg, *, seed: int = 0, device="cuda"):
    """Random params for ``cfg`` in ``cfg.dtype`` on ``device``, from a
    ``torch.Generator`` on that device seeded with ``seed``; leaves whose
    fp32 draw would pass ``policy.SLICE_ELEMENTS`` are drawn in slices, so
    the full qwen3-moe-30b-a3b (56.9 GiB in bf16) is made on one 80 GB
    card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(M.schema(cfg), gen, cfg.dtype, device=dev)


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve a dense or MoE decoder (PyTorch port)")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced config (--no-smoke: the full one)")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--slots", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prefill-len", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 24),
                    metavar=("MIN", "MAX"),
                    help="prompt lengths drawn from [MIN, MAX)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain path")
    ap.add_argument("--out", default=None,
                    help="write the run's statistics here as JSON")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    try:
        require_kv_cache_family(cfg)
    except ValueError as e:
        raise SystemExit(f"serve: {e}") from None
    cfg = cfg.with_(use_flash_kernel=True)
    params = build_params(cfg, device=dev)
    eng = Engine(params, cfg, batch=args.batch, n_slots=args.slots,
                 prefill_len=args.prefill_len, device=dev)
    lo, hi = args.prompt_len
    for req in make_requests(args.requests, cfg.vocab_size, lo=lo, hi=hi,
                             max_new=args.max_new):
        eng.submit(req)

    t0 = time.perf_counter()
    stats = eng.run()
    dt = time.perf_counter() - t0
    size = "reduced" if args.smoke else "full"
    print(f"arch={cfg.name} ({size}, {cfg.n_layers} layers, {cfg.dtype}) "
          f"batch={args.batch} device={dev}")
    print(f"completed {stats.completed}/{args.requests} requests, "
          f"{stats.tokens_out} tokens in {dt:.1f}s "
          f"({stats.tokens_out / max(dt, 1e-9):.1f} tok/s, "
          f"{stats.decode_steps} decode steps, {stats.prefills} prefills)")
    if args.out:
        res = {"arch": cfg.name, "smoke": args.smoke,
               "n_layers": cfg.n_layers, "dtype": cfg.dtype,
               "device": str(dev), "batch": args.batch, "slots": args.slots,
               "prefill_len": args.prefill_len, "requests": args.requests,
               "completed": stats.completed, "tokens_out": stats.tokens_out,
               "decode_steps": stats.decode_steps,
               "prefills": stats.prefills, "wall_s": dt,
               "tokens_per_s": stats.tokens_out / max(dt, 1e-9),
               "step_ms_p50": _percentile(eng.step_ms, 50),
               "step_ms_p99": _percentile(eng.step_ms, 99),
               "prefill_ms_p50": _percentile(eng.prefill_ms, 50),
               "prefill_ms_max": max(eng.prefill_ms, default=float("nan"))}
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0 if stats.completed == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
