"""LM training driver of the PyTorch/CUDA port: train an ``--arch`` (cut
with ``--smoke`` for the CPU) on the synthetic Markov token stream, with
checkpointing and metrics.  The port of ``repro.launch.train``.

Run:  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
      PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
          --smoke --steps 30 --batch 4 --seq 64 --device cpu
      PYTHONPATH=src python -m repro_torch.launch.train \
          --arch internlm2-1.8b --steps 20 --batch 8 --seq 128   # the card
      PYTHONPATH=src python -m repro_torch.launch.train \
          --arch qwen3-moe-30b-a3b --layers 2 --steps 20   # full width
      PYTHONPATH=src python -m repro_torch.launch.train \
          --arch llama-3.2-vision-11b --smoke --device cpu
      PYTHONPATH=src python -m repro_torch.launch.train \
          --arch xlstm-350m --steps 20   # full width and depth, the card

``--layers N`` cuts the config's depth (a model of 30.5 B params does not
train with AdamW on one 80 GB card); for the VLM it must be a multiple of
``cross_attn_period`` (whole groups of self blocks and their cross block),
for the xLSTM of ``slstm_period`` (whole groups of mLSTM blocks and their
sLSTM block).
``--arch hubert-xlarge`` is refused with the reference's message: the
audio encoder trains on the frame objective (``train.loop.task_loss``), not
the token stream.  The VLM's batches carry zero ``image_embeds`` (B,
n_image_tokens, d_model), as the reference's CLI feeds them: its cross
blocks then add nothing and their gates get no gradient.

Params are drawn in ``cfg.dtype`` from a ``torch.Generator`` seeded 0 on
the device.  The optimizer steps (``train.loop.make_train_step``, AdamW)
run under autograd, so the model takes the reference's training route
(``_sdpa``, the SSD's einsums); the fixed held-out eval batch runs under
``torch.no_grad()``, so on the card it goes through the flash-attention
kernel (and the SSD kernel for zamba2).  ``improved`` compares the eval
loss of that SAME batch before and after training, immune to the
batch-to-batch noise of the stream.  The last line is the reference's JSON
(``first_loss``, ``last_loss``, ``eval_before``, ``eval_after``,
``improved``); the line before names the device.  ``--ckpt PATH`` saves
``{"params": ...}`` in the reference's flat ``.npz`` + ``.json`` format
(``checkpoint/ckpt.py``); ``--out PATH`` writes every step's loss, MoE
aux and host-clock time, the peak device memory and the kernel launches
of the eval passes and of the steps as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.tokens import batches
from repro_torch.kernels import ops
from repro_torch.optim.adam import AdamW
from repro_torch.train.loop import make_train_step, task_loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="train an LM on the Markov token stream (PyTorch port)")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: keep)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("--out", default=None,
                    help="also write per-step losses and times, peak "
                         "memory and kernel launches as JSON here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "audio":
        raise SystemExit("use launch/train for LM families; hubert trains "
                         "via the masked-frame objective in tests/examples")
    if args.layers:
        g = {"vlm": cfg.cross_attn_period,
             "ssm": cfg.slstm_period}.get(cfg.family, 1)
        if args.layers % g:
            closer = {"vlm": "self blocks and one cross block",
                      "ssm": "mLSTM blocks and one sLSTM block"}[cfg.family]
            raise SystemExit(
                f"--layers {args.layers}: {cfg.name} stacks its layers in "
                f"groups of {g} ({g - 1} {closer}), so --layers must be a "
                f"multiple of {g}")
        cfg = cfg.with_(n_layers=args.layers)
    fns = make_train_step(cfg, AdamW(lr=args.lr))
    params, opt = fns.init(torch.Generator(device=device).manual_seed(0))
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    def full_batch(tokens):
        b = {"tokens": torch.from_numpy(tokens).to(device)}
        if cfg.family == "vlm":
            b["image_embeds"] = torch.zeros(
                (args.batch, cfg.n_image_tokens, cfg.d_model),
                dtype=torch.float32, device=device)
        return b

    def eval_loss(b) -> float:
        with torch.no_grad():
            return float(task_loss(params, cfg, b)[0])

    # fixed held-out batch: "improved" compares the SAME data before/after
    eval_b = full_batch(next(batches(cfg.vocab_size, args.batch, args.seq,
                                     1, seed=1234))["tokens"])
    ops.reset_launches()
    loss_before = eval_loss(eval_b)
    launches = {"eval_before": dict(ops.LAUNCHES)}

    losses, auxes, step_s = [], [], []
    ops.reset_launches()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches(cfg.vocab_size, args.batch, args.seq,
                                      args.steps)):
        ts = time.perf_counter()
        params, opt, metrics = fns.step(params, opt,
                                        full_batch(batch["tokens"]))
        losses.append(float(metrics["loss"]))      # the step's host sync
        step_s.append(time.perf_counter() - ts)
        auxes.append(float(metrics["aux"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    launches["steps"] = dict(ops.LAUNCHES)

    ops.reset_launches()
    loss_after = eval_loss(eval_b)
    launches["eval_after"] = dict(ops.LAUNCHES)
    if args.ckpt:
        ckpt.save(args.ckpt, {"params": params}, step=args.steps,
                  meta={"arch": args.arch, "loss": losses[-1]})
        print("saved", args.ckpt)
    result = {"first_loss": losses[0], "last_loss": losses[-1],
              "eval_before": loss_before, "eval_after": loss_after,
              "improved": loss_after < loss_before}
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(result, arch=cfg.name, smoke=args.smoke,
                           n_layers=cfg.n_layers, dtype=cfg.dtype,
                           batch=args.batch, seq=args.seq, losses=losses,
                           aux=auxes, step_s=step_s, launches=launches,
                           device={"type": device.type, "name": name},
                           peak_bytes=(torch.cuda.max_memory_allocated(
                               device) if on_card else None)), fh)
    print(f"device: {name}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
