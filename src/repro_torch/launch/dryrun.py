"""Multi-device dry run on a fake world: the port of
``repro.launch.dryrun``.

The reference lowers and compiles one step (train, prefill or decode) on
512 fake XLA host devices and reads the per-device program's memory and
cost.  The port runs the step once, eagerly, on ``meta`` ``DTensor``s
over a fake world of 256 ranks (512 with ``--multi-pod``,
``launch.mesh.fake_world``), through ``make_production_mesh`` on the
``cpu`` device type, and counts one rank's work with
``launch.op_analysis``.  Params, AdamW state, batch and cache are built
from their local shard shapes (``DTensor.from_local(..., run_check=False,
shape=, stride=)``): the params and moments from
``policy.abstract_params`` placed by ``policy.sharding_tree``, the cache
by ``serve.decode.cache_pspecs``, so no global tensor is ever allocated and nothing touches a device or a
kernel: the models take the reference's routes on meta tensors
(``_sdpa``; the SSD's einsums), and the kernel wrappers are never
reached.  Plain tensors the models create (masks, positions, zeros)
join as replicated (``implicit_replication``).

Where ``DTensor`` has no sharding rule for an op the models run, the
port redistributes explicitly at that op's site, and the collective it
costs is counted:

* the MoE's routing (``models/ffn.route``): the router probabilities are
  gathered whole (a ``Replicate`` redistribute) before the stable sort,
  and the slot math (``argsort``, ``searchsorted``, the slot writes) runs
  on each rank's replicated expert ids as local tensors;
* the LM loss's gather of the gold logits (``train/loop.cross_entropy``):
  the vocab dim is gathered whole and pending partial sums reduced first
  (``common.unshard_dim``), since ``DTensor``'s rule for a gather along a
  sharded or partial dim fails;
* heads split from, or merged into, a dim sharded over more ranks than
  there are heads (GQA's kv heads, the xLSTM's 4 heads on a tp axis of
  16: ``common.split_last``, and ``merge_last``'s backward): that dim is
  gathered whole first, since ``DTensor`` refuses an uneven split.

The record keeps the reference's keys.  Keys with no counterpart here
are ``null``: ``t_lower_s``, ``t_compile_s`` (nothing is lowered or
compiled), ``mem_generated_code_bytes``, and the XLA cost analysis'
``xla_flops_per_device_raw`` / ``xla_bytes_per_device_raw``.  The
``hlo_*`` keys and the collectives hold ``op_analysis``'s counts of the
eager step (one rank's matmul flops, op bytes, collective operand
bytes); ``DTensor`` picks its own strategies, so they are the port's own
and need not equal XLA's.  ``mem_argument_bytes`` is the local bytes of
params, optimizer state and inputs; ``mem_output_bytes`` the local bytes
of the step's outputs; ``mem_temp_bytes`` the peak bytes of the tensors
the step created, as ``op_analysis`` tracks them.  ``t_step_s`` is the
host wall of the meta step.  As in the reference, ``remat`` is forced on
for ``train``.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
          --shape decode_32k [--multi-pod] [--objective lm] [--opt ...] \\
          [--out experiments/dryrun] [--tag T]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import (fake_world, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamState, AdamW
from repro_torch.serve import decode as serve
from repro_torch.sharding import policy
from repro_torch.sharding.policy import batch_pspec
from repro_torch.tree import tree_map
from repro_torch.train.loop import make_train_step


def dtensor(meta: torch.Tensor, placements: tuple, mesh):
    """A meta ``DTensor`` standing for the global meta tensor ``meta``
    under ``placements``, built from its local shard."""
    from torch.distributed.tensor import DTensor
    local = policy.local_shape(meta.shape, placements, mesh)
    return DTensor.from_local(
        torch.empty(local, dtype=meta.dtype, device="meta"), mesh,
        placements, run_check=False, shape=meta.shape, stride=meta.stride())


def _batch_dtensor(shape, dtype: torch.dtype, mesh):
    """A meta input with its leading batch dim on dp (replicated where dp
    does not divide it)."""
    spec = (batch_pspec(mesh.mesh_dim_names),) + (None,) * (len(shape) - 1)
    return dtensor(torch.empty(shape, dtype=dtype, device="meta"),
                   policy.placements(policy._divisible(shape, spec, mesh),
                                     mesh), mesh)


def _local_bytes(tree) -> int:
    """One rank's bytes of the tensors in a tree of dicts, NamedTuples,
    lists and tuples."""
    sizes = []
    serve.map_cache(lambda t: sizes.append(
        t.to_local() if hasattr(t, "to_local") else t)
        if isinstance(t, torch.Tensor) else None, tree)
    return sum(t.numel() * t.element_size() for t in sizes)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                objective: str = "lm") -> dict:
    """(shape, dtype) of every model input of this shape."""
    B, S = shape.global_batch, shape.seq_len
    bf16, i32, f32 = torch.bfloat16, torch.int32, torch.float32
    if shape.mode in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {"frames": ((B, S, cfg.d_model), bf16)}
            if shape.mode == "train":
                batch["labels"] = ((B, S), i32)
        else:
            batch = {"tokens": ((B, S), i32)}
            if cfg.family == "vlm":
                batch["image_embeds"] = ((B, cfg.n_image_tokens,
                                          cfg.d_model), bf16)
        if objective == "apcvfl_distill":
            batch["z_teacher"] = ((B, cfg.d_model), f32)
            batch["aligned"] = ((B,), i32)
        return batch
    # decode: one new token against a full cache; the port's decode takes
    # the position as a host int
    return {"token": ((B,), i32)}


def run_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
              objective: str = "lm", cfg: ModelConfig | None = None,
              local_mesh: tuple | None = None) -> dict:
    """One dry run: builds the fake world and the mesh, runs the step
    once under ``op_analysis`` and returns the record.  ``local_mesh=(data,
    model)`` runs on a small fake world of that shape in place of the
    production mesh (the tests)."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape.mode == "train" and not cfg.remat:
        # the production default, as the reference: activation
        # checkpointing per block
        cfg = cfg.with_(remat=True)
    if shape.mode == "decode" and not M.supports_decode(cfg):
        raise SystemExit(f"{arch} is encoder-only: no decode step (skip)")
    n = math.prod(local_mesh) if local_mesh else (512 if multi_pod else 256)
    with fake_world(n):
        mesh = (make_local_mesh(*local_mesh) if local_mesh
                else make_production_mesh(multi_pod=multi_pod))
        rec = _run(cfg, shape, mesh, objective)
    rec.update(arch=arch, shape=shape_name,
               mesh="x".join(str(s) for s in mesh.shape),
               objective=objective, n_chips=n)
    return rec


def _run(cfg: ModelConfig, shape: ShapeConfig, mesh, objective: str) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication
    sch = M.schema(cfg)
    abstract = policy.abstract_params(sch, cfg.dtype)
    layout = policy.sharding_tree(sch, mesh)
    params = tree_map(lambda t, p: dtensor(t, p, mesh), abstract, layout)
    B = shape.global_batch
    inputs = {k: _batch_dtensor(s, t, mesh) for k, (s, t) in
              input_specs(cfg, shape, objective=objective).items()}
    if shape.mode == "decode":
        slots = serve.n_cache_slots(cfg, shape)
        kw = {}
        if cfg.family == "vlm":
            kw["image_embeds"] = torch.empty(
                (B, cfg.n_image_tokens, cfg.d_model), dtype=torch.bfloat16,
                device="meta")
        with torch.no_grad():
            plain = M.init_cache(abstract, cfg, B, slots, **kw)
        inputs["cache"] = serve.map_cache(
            lambda t, spec: dtensor(t, policy.placements(spec, mesh), mesh),
            plain, serve.cache_pspecs(plain, mesh, B))
    state = None
    if shape.mode == "train":
        # AdamW's fp32 moments mirror the params' placements
        moment = lambda: tree_map(lambda t, p: dtensor(
            t.float(), p, mesh), abstract, layout)
        state = AdamState(dtensor(torch.empty((), dtype=torch.int32,
                                              device="meta"),
                                  policy.placements((), mesh), mesh),
                          moment(), moment())
    args_bytes = _local_bytes((params, inputs, state))

    t0 = time.perf_counter()
    with implicit_replication():
        if shape.mode == "train":
            fns = make_train_step(cfg, AdamW(), objective=objective)
            out, oa = op_analysis.analyze(fns.step, params, state, inputs)
        elif shape.mode == "prefill":
            with torch.no_grad():
                out, oa = op_analysis.analyze(serve.prefill_step, params,
                                              cfg, inputs)
        else:
            step = serve.make_decode_step(cfg, serve.decode_window(cfg,
                                                                   shape))
            # pos: the last slot of a full cache, a host int as the
            # port's decode takes it
            with torch.no_grad():
                out, oa = op_analysis.analyze(
                    step, params, inputs["token"], inputs["cache"],
                    shape.seq_len - 1)
    t_step = time.perf_counter() - t0
    res = oa.result()
    return {
        "t_lower_s": None, "t_compile_s": None,
        "t_step_s": round(t_step, 2),
        "params": M.count_params_analytic(cfg),
        "active_params": M.count_active_params(cfg),
        "param_bytes_per_device": _local_bytes(params),
        "mem_argument_bytes": args_bytes,
        "mem_output_bytes": _local_bytes(out),
        "mem_temp_bytes": res["peak_bytes"],
        "mem_generated_code_bytes": None,
        "xla_flops_per_device_raw": None,
        "xla_bytes_per_device_raw": None,
        "hlo_flops_per_device": res["flops"],
        "hlo_bytes_per_device": res["bytes"],
        "collective_bytes_per_device": res["collective_bytes"],
        "collectives": res["collectives"],
        "breakdown": oa.breakdown(10),
        "analysis": "launch/op_analysis.py: eager ATen ops on one rank's "
                    "meta shards (no device, no compile)",
    }


KNOBS = ("chunked_attn[:N], seq_par, replicate_kv, ssd_chunk:N, ssd_bf16, "
         "softmax_bf16, window:N")


def apply_opt(cfg: ModelConfig, opt: str, multi_pod: bool) -> ModelConfig:
    for knob in [k for k in opt.split(",") if k]:
        name, _, val = knob.partition(":")
        if name == "chunked_attn":
            cfg = cfg.with_(attn_chunk=int(val or 512))
        elif name == "seq_par":
            axes = ("pod", "data", "model") if multi_pod else \
                ("data", "model")
            cfg = cfg.with_(seq_parallel=True, mesh_axes=axes)
        elif name == "replicate_kv":
            cfg = cfg.with_(replicate_kv=True)
        elif name == "ssd_chunk":
            cfg = cfg.with_(ssm_chunk=int(val))
        elif name == "ssd_bf16":
            cfg = cfg.with_(ssd_bf16=True)
        elif name == "softmax_bf16":
            cfg = cfg.with_(softmax_bf16=True)
        elif name == "window":
            cfg = cfg.with_(sliding_window=int(val))
        else:
            raise SystemExit(f"unknown opt {name}")
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="meta-device dry run of one step on a fake world")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--objective", default="lm",
                    choices=["lm", "apcvfl_distill"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", default="", help=f"comma list of knobs: {KNOBS}")
    args = ap.parse_args(argv)

    cfg = apply_opt(get_config(args.arch), args.opt, args.multi_pod)
    rec = run_combo(args.arch, args.shape, multi_pod=args.multi_pod,
                    objective=args.objective, cfg=cfg)
    rec["opt"] = args.opt
    print({k: rec[k] for k in ("hlo_flops_per_device",
                               "hlo_bytes_per_device",
                               "collective_bytes_per_device",
                               "mem_argument_bytes", "t_step_s")})
    os.makedirs(args.out, exist_ok=True)
    tag = (args.tag + "_") if args.tag else ""
    name = f"{tag}{args.arch}_{args.shape}_{rec['mesh']}"
    if args.objective != "lm":
        name += "_" + args.objective
    path = os.path.join(args.out, name + ".json")
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
