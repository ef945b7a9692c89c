#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--time-only]

Phases, in order; any failure ends the run with a non-zero exit:

1. build  — compile every kernel from ``csrc/*.cu`` (one ``nvcc`` per
   source, all at once) and print ``-Xptxas -v``.
2. check  — hold each kernel against its plain PyTorch version on the
   card: the lane-MLP forward at the three Table-3 encoder shapes x
   B in {16, 77, 256, 4096} within 1e-4 max-abs and the int8 matmul at the
   three quantized layers within 1e-5 (the reference's pinned bounds);
   the lane-MLP backward at the eight Table-3 autoencoder MLPs x
   B in {1, 77, 128, 2000} plus a three-lane stack with a dead lane within
   1e-5 relative; the Eq. 5 rows forward and backward (mse and mae, mask
   rows at 0 and 1) within 1e-5; the probe step (rows at weight 0) within
   1e-4.  Then each training wrapper as the path calls it, on the card
   against itself on CPU copies at the same bounds: ``fused_mlp2`` and
   ``fused_lane_mlp2`` under autograd with and without an input gradient,
   ``fused_distill_rows`` and ``probe_grad_step`` in both forms.  Then the
   flash-attention wrapper at eight (B, S, H, K, hd) shapes (zamba2's MHA
   at hd 80, ragged S at hd 32 and 64 and S 4096 among them), causal with
   window 0, 128 and 100 (inside a kv tile) and full, and the
   decode-attention wrapper at four GQA ratios (internlm2-1.8b's 2,
   zamba2's 1 at hd 80, 6 and 8), W 64, 1000 and 1024 with empty slots,
   window 0 and 48, fp32 within 2e-5 and bf16 within 3e-2 (the
   reference's bounds), and with every slot empty (0); bf16 flash and
   decode also against their plain versions in fp32 on the same bf16
   inputs, within 5e-3 + 1e-2 |want| (TOL_FLASH_BF16_F32) and 1e-4 + 1e-2
   |want| (TOL_DECODE_BF16_F32).
   Then the SSD intra-chunk wrapper within 2e-4 (the reference's bound) at
   zamba2's width (B 2, S 512, H 80, N = P = 64, Lc 256), a ragged grouped
   chunk (S 100, H 6, G 2) and per-step log-decays down to -16.
3. serve  — a full-width bundle (Table-3 g3, g1_active, g2; random heads;
   10000 cached latents) on the paper's largest scenario (mimic3, 5 active
   features, 10000 aligned rows), served by
   ``repro_torch.launch.serve_vfl.main --load`` in fp32 and then int8.
   The card's logits are held against the CPU engine's on mixed-id rows.
4. train  — ``serve_vfl.main`` without ``--load`` on the same scenario:
   ``run_apcvfl(use_kernel=True)`` at Table-3 widths, batch 128, 2 epochs
   per stage, then export, save, reload and serve.  The same run on the
   CPU (same seed: same inits, same batches) must give the same epochs and
   comm bytes, train losses within 1e-4 relative per epoch (g3's last
   epoch within TOL_LOSS_G3_LAST, whose readings phase 6 takes) and metrics
   within 0.03.  Then ``kfold_cv(use_kernel=True)`` on the trained latents
   (every fold step one probe launch) within 0.03 of the plain probe.
5. time   — kernel, plain-version and library times (CUDA events over
   CUDA-graph replays) and the work bound at the serving bucket (256) and
   the training batch (128), the lane-MLP forward and the int8 matmul also
   at bucket 16 (the serving stream's smallest), the forward also with
   training's saved pre-activations; each stage's steps/s as phase 4's run timed
   it, and one more ``run_apcvfl`` epoch on the card with each stage's
   launches per step and a profiler split; then the served stream's
   rows/s, fp32, int8, int8, fp32 by warmed engines.
6. limit  — the readings that place TOL_LOSS_G3_LAST: the CPU's own spread
   between two orderings of the same math (closed-form backward vs
   autograd) must lie below it, and ``run_apcvfl`` on the card with a
   planted fault in the Eq. 5 backward (the distillation gradient scaled)
   must land above it.
7. lm     — the dense decoder's serving path: internlm2-1.8b at full width
   and depth in bf16 through ``repro_torch.launch.serve.main --no-smoke``
   (batch 8, 1024 slots, prefill 128, 32 requests of 16-128 prompt tokens,
   64 new tokens each), then ``prefill_step`` at B 2, S 2048 (and one more
   call under the profiler); flash
   attention must launch once per layer per prefill and decode attention
   once per layer per decode step.  Ten warm decode steps run under the
   profiler (the card's busy share and its time by kind).  Then the same
   config at depth 2 in fp32, weights made once on the CPU: 8 requests
   through the engine on the card and on the CPU give identical tokens,
   and the prefill and decode logits agree within 1e-4 x max|logit|, also
   against the plain ``_sdpa`` sites the CPU runs with the switch off.
   Phase 5 times both attention kernels at the engine's decode shape and
   at the ``prefill_step`` shape, and both at zamba2's heads (hd 80).
8. zamba  — the hybrid's serving path: zamba2-2.7b at full width and depth
   in bf16, ``prefill_step`` at B 2, S 2048 (exactly 54 SSD and 9 flash
   launches a call) and greedy decode through ``make_decode_step`` from
   ``init_cache`` at B 8 with 1024 slots, 16 prompt tokens fed through
   decode steps then 48 generated (exactly 9 decode launches a step), each
   with a profiled window.  Then one group (6 mamba layers, one shared
   application) in fp32 at full width: ``prefill_step`` at B 2, S 512 and 8
   decode steps on the card and the CPU (identical tokens, logits within
   1e-4 x max|logit|), and on the card 512 decode steps against the full
   forward (1e-3 x max|logit|).  Phase 5 times the SSD kernel at the
   prefill's shape.

Launch counters are zeroed just before each run of a path (serve fp32,
serve int8, train, probe, lm, each zamba prefill and the zamba decode) and
read just after; every kernel must have launched on its path.  The last
lines are a ``details:`` line (every measurement as JSON), the ``kernels``
JSON, the card's name and power limit, and ``{"ok": true, "device":
...}``.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_FP32_FLOPS = 67e12        # H100 SXM, fp32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12       # H100 SXM, bf16 dense tensor cores
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3
TOL_MLP = 1e-4                 # lane-MLP forward vs plain, max-abs
TOL_GRAD = 1e-5                # lane-MLP backward vs plain, relative
TOL_INT8 = 1e-5                # int8 matmul vs plain, max-abs
TOL_DISTILL = 1e-5             # Eq. 5 rows and gradients, max-abs
TOL_PROBE = 1e-4               # probe loss / dW / db, max-abs
TOL_ENGINE = 1e-4              # card engine vs CPU engine (sum order)
TOL_LOSS = 1e-4                # card vs CPU train loss per epoch, relative
# g3's last epoch, relative: g3 trains on the output of three earlier fits
# and Adam divides each gradient coordinate by its own running scale, so
# float reassociation in near-zero coordinates moves whole steps and two
# orderings of the same math drift apart there.  Phase 6 shows in every
# run that the CPU's own spread lies below this limit and that every
# planted fault of FAULTS lies above it.
TOL_LOSS_G3_LAST = 5e-4
# planted faults of the g3 stage: the Eq. 5 backward kernel's distillation
# gradient dz scaled by this factor
FAULTS = {"dz x0.5 (mse gradient without its factor 2)": 0.5,
          "dz x0.9 (the distillation gradient 10% low)": 0.9}
TOL_METRIC = 0.03              # probe metrics band (tests/test_replicas.py)
# Table-3 encoders on the serving path: (din, h, dz)
ENCODERS = {"g1_active": (5, 64, 128), "g3": (5, 256, 256),
            "g2": (384, 256, 256)}
# the eight autoencoder MLPs trained at mimic3 widths: (din, h, dz)
AE_SHAPES = {"g1_active.enc": (5, 64, 128), "g1_active.dec": (128, 64, 5),
             "g1_passive.enc": (10, 128, 256),
             "g1_passive.dec": (256, 128, 10),
             "g2.enc": (384, 256, 256), "g2.dec": (256, 256, 384),
             "g3.enc": (5, 256, 256), "g3.dec": (256, 256, 5)}
BATCHES = (16, 77, 256, 4096)
BWD_BATCHES = (1, 77, 128, 2000)
TRAIN_B = 128                  # the paper's batch size
DISTILL = dict(D=5, M=256, lam=0.01)          # step 3 at mimic3 widths
PROBE_FOLDS = 10
N_CLASSES = 4                  # mimic3
# the three layers of the int8 active path: (d, c, act)
INT8_LAYERS = {"l0_selu": (5, 256, "selu"), "l1": (256, 256, "none"),
               "head": (256, N_CLASSES, "none")}
BUCKET = 256
SCENARIO = dict(dataset="mimic3", active_features=5, aligned=10000,
                requests=2000, seed=0)
TRAIN = dict(epochs=2, requests=500)
# run_apcvfl's training stages and the roles each one trains
STAGES = {"g1": ("g1_active", "g1_passive"), "g2": ("g2",), "g3": ("g3",)}
# attention vs plain per input dtype: |got - want| <= tol + tol * |want|,
# the reference's allclose bounds (tests/test_kernels.py, atol = rtol)
TOL_ATTN = {"float32": 2e-5, "bfloat16": 3e-2}
# bf16 flash attention also against its plain version in fp32 on the same
# bf16 inputs: |got - want| <= atol + rtol * |want|.  The kernel keeps its
# scores in fp32, so what is left is the rounding of P and of the output to
# bf16; the bound lies between the correct kernel's largest reading and
# those of planted faults (tools/flash_planted_faults.py, PERF.md)
TOL_FLASH_BF16_F32 = (5e-3, 1e-2)
# card vs CPU logits of the depth-2 decoder, relative to max|logit|
TOL_LM = 1e-4
FLASH_SHAPES = ((1, 128, 16, 8, 128), (2, 2048, 16, 8, 128),
                (1, 32, 16, 8, 128), (1, 200, 4, 2, 64), (2, 77, 4, 4, 32),
                (2, 512, 32, 32, 80), (2, 2048, 32, 32, 80),
                (2, 4096, 16, 8, 128))
# (B, S, H, K, hd); (2, 2048, 32, 32, 80) is zamba2's shared block at
# prefill_step's size; the last is internlm2's heads at twice its length
# (causal, window); a window of 100 ends inside a 64-key tile
FLASH_MASKS = ((True, 0), (True, 128), (True, 100), (False, 0))
DECODE_W = (64, 1000, 1024)
# decode attention's (H, K, hd): internlm2-1.8b's GQA (2 q heads a kv
# head), zamba2's MHA, internlm2-20b's and nemotron-4-15b's 6, yi-6b's 8
DECODE_HEADS = ((16, 8, 128), (32, 32, 80), (48, 8, 128), (32, 4, 128))
DECODE_WINDOWS = (0, 48)
# bf16 decode attention also against its plain version in fp32 on the same
# bf16 inputs: |got - want| <= atol + rtol * |want|.  The kernel keeps its
# scores, softmax and sums in fp32, so what is left is the rounding of the
# output to bf16 (at most 2^-8 relative); the bound lies between the
# correct kernel's largest reading and those of planted faults
# (tools/decode_planted_faults.py, PERF.md)
TOL_DECODE_BF16_F32 = (1e-4, 1e-2)
# the SSD intra-chunk block vs its plain version, the reference's allclose
# bound (tests/test_kernels.py::test_ssd_intra_chunk_kernel, atol = rtol)
TOL_SSD = 2e-4
# (B, S, H, G, N, P, Lc, steep): zamba2's width over two chunks and at
# prefill_step's B 2, S 2048 (eight chunks, the main path's shape); a ragged
# grouped chunk (S 100, so Lc 100); per-step log-decays down to -16, where
# far pairs underflow to 0
SSD_CASES = {"zamba2 width": (2, 512, 80, 1, 64, 64, 256, False),
             "zamba2 prefill": (2, 2048, 80, 1, 64, 64, 256, False),
             "ragged grouped": (1, 100, 6, 2, 16, 32, 100, False),
             "steep decay": (2, 512, 8, 1, 64, 64, 256, True)}
# the hybrid serving cell: zamba2-2.7b, full width and depth, bf16
ZAMBA = dict(arch="zamba2-2.7b", prefill=(2, 2048), prefill_calls=3,
             batch=8, slots=1024, prompt=16, new=48, profile_steps=10)
# card vs CPU and decode vs forward: one group (6 mamba layers, one
# shared-block application) at full width in fp32
ZAMBA_CHECK = dict(layers=6, prefill=(2, 512), steps=8)
TOL_DECODE_VS_FORWARD = 1e-3            # x max|logit|, on the card
# the LM serving cell: internlm2-1.8b, full width
LM = dict(arch="internlm2-1.8b", batch=8, slots=1024, prefill_len=128,
          requests=32, prompt=(16, 129), max_new=64)
LM_PREFILL = (2, 2048)                  # prefill_step's (B, S)
LM_CHECK = dict(layers=2, requests=8, slots=256, max_new=16, steps=8)
CARD = "cuda"                           # the device the LM phase serves on


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


def _relerr(a, b) -> float:
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


def _bwd_inputs(gen, B, din, h, dz, lanes=1):
    """Inputs of the lane-MLP backward: the forward's, its saved
    pre-activations and an output cotangent, with a lane axis."""
    import torch
    from repro_torch.kernels import lane_mlp
    stack = [torch.stack(t) for t in zip(*[_mlp_inputs(gen, B, din, h, dz)
                                           for _ in range(lanes)])]
    _, a1, a2 = lane_mlp.launch(*stack, save=True)
    g = _rand(gen, (lanes, B, dz))
    xs, w0s, _, w1s, _ = stack
    return g, xs, a1, a2, w0s, w1s


def _distill_inputs(gen, B, D, M):
    import torch
    x, xh = _rand(gen, (B, D)), _rand(gen, (B, D))
    z, zt = _rand(gen, (B, M)), _rand(gen, (B, M))
    zt[::3, ::4] = z[::3, ::4]              # exact ties: sign(0) = 0
    mask = (torch.rand((B,), generator=gen) > 0.5).float().cuda()
    return x, xh, z, zt, mask


def _probe_inputs(gen, n, d, C, k):
    import torch
    x = _rand(gen, (n, d))
    y = torch.randint(0, C, (n,), generator=gen, dtype=torch.int32).cuda()
    w, b = _rand(gen, (k, d, C), 0.1), _rand(gen, (k, C), 0.1)
    rw = (torch.rand((k, n), generator=gen) > 0.1).float().cuda()
    return w, b, x, y, rw


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
    check_training_kernels(gen, err)
    check_attention_kernels(gen, err)
    check_ssd_kernel(gen, err)
    return err, check_wrappers(gen)


def _card_vs_cpu(fn, args, grad_of, gen):
    """``fn(*args)`` and the gradients of ``sum(fn(*args) * c)`` (c a
    random cotangent) w.r.t. the args flagged in ``grad_of``: once on the
    card (the wrapper launches its kernels) and once on CPU copies (the
    wrapper's plain path).  Returns the two lists ``[out, *grads]``."""
    import torch
    runs, cot = [], None
    for dev in ("cuda", "cpu"):
        a = [t.detach().to(dev).requires_grad_(g)
             for t, g in zip(args, grad_of)]
        out = fn(*a)
        if cot is None:
            cot = torch.randn(out.shape, generator=gen)
        grads = torch.autograd.grad(torch.sum(out * cot.to(dev)),
                                    [t for t in a if t.requires_grad])
        runs.append([out.detach().cpu()] + [t.cpu() for t in grads])
    return runs


def check_wrappers(gen) -> dict:
    """The training path's wrappers on the card against the same wrappers
    on CPU copies (part of phase 2): ``fused_mlp2`` under autograd at the
    eight Table-3 MLPs with x not requiring a gradient (the encoder case:
    the backward's null-dx branch) and requiring one (the decoder case),
    ``fused_lane_mlp2`` with a dead lane, ``fused_distill_rows``'s
    ``(dx, -dx, dz, -dz, dmask)`` over rows and over a lane axis, and
    ``probe_grad_step``'s weight normalisation and L2 term in the single
    and the fold-lane form that ``kfold_cv`` uses."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    err = {"mlp": 0.0, "distill": 0.0, "probe": 0.0}
    for name, (din, h, dz) in AE_SHAPES.items():
        for B in (77, TRAIN_B):
            args = _mlp_inputs(gen, B, din, h, dz)
            for need_dx in (False, True):
                got, want = _card_vs_cpu(ops.fused_mlp2, args,
                                         (need_dx, True, True, True, True),
                                         gen)
                e = max(_relerr(a, b) for a, b in zip(got, want))
                _require(len(got) == 5 + need_dx and e <= TOL_GRAD,
                         (name, B, need_dx, e))
                err["mlp"] = max(err["mlp"], e)
    din, h, dz = AE_SHAPES["g2.dec"]
    stack = [torch.stack(t) for t in zip(*[_mlp_inputs(gen, 77, din, h, dz)
                                           for _ in range(3)])]
    live = torch.tensor([1.0, 0.0, 1.0])
    for need_dx in (False, True):
        got, want = _card_vs_cpu(
            lambda *a: ops.fused_lane_mlp2(*a, live.to(a[0].device)),
            stack, (need_dx, True, True, True, True), gen)
        e = max(_relerr(a, b) for a, b in zip(got, want))
        _require(e <= TOL_GRAD and all(not bool(t[1].any()) for t in got),
                 ("fused_lane_mlp2 dead lane", need_dx, e))
        err["mlp"] = max(err["mlp"], e)
    for kind in ("mse", "mae"):
        for lead in ((77,), (TRAIN_B,), (3, 77)):
            x, xh, z, zt, mask = _distill_inputs(
                gen, int(np.prod(lead)), DISTILL["D"], DISTILL["M"])
            args = [t.reshape(lead + t.shape[1:]) for t in (x, xh, z, zt,
                                                            mask)]
            got, want = _card_vs_cpu(
                lambda *a: ops.fused_distill_rows(*a, lam=0.3, kind=kind),
                args, (True,) * 5, gen)
            e = max(_maxerr(a, b) for a, b in zip(got, want))
            _require(e <= TOL_DISTILL, ("fused_distill_rows", kind, lead, e))
            err["distill"] = max(err["distill"], e)
    for n, k in ((77, None), (77, 3), (15000, PROBE_FOLDS)):
        w, b, x, y, rw = _probe_inputs(gen, n, 256, N_CLASSES, k or 1)
        if k is None:
            w, b, rw = w[0], b[0], rw[0]
        runs = [ops.probe_grad_step(*(t.to(dev) for t in (w, b, x, y, rw)),
                                    l2=1e-4) for dev in ("cuda", "cpu")]
        e = max(_maxerr(a.cpu(), bb) for a, bb in zip(*runs))
        _require(e <= TOL_PROBE, ("probe_grad_step", n, k, e))
        err["probe"] = max(err["probe"], e)
    launched = dict(ops.LAUNCHES)
    _require(all(launched[k] > 0 for k in ("lane_mlp_fwd", "lane_mlp_bwd",
                                           "distill_fwd", "distill_bwd",
                                           "probe")), launched)
    log(f"wrappers card vs cpu: {err} (launches {launched})")
    return err


def check_training_kernels(gen, err: dict) -> None:
    """The lane-MLP backward, the Eq. 5 rows and the probe step against
    their plain versions (part of phase 2)."""
    import torch
    from repro_torch.kernels import distill_loss, lane_mlp, probe, ref
    err.update(lane_mlp_bwd=0.0, lane_mlp_bwd_rel=0.0, distill_fwd=0.0,
               distill_bwd=0.0, probe=0.0)
    cases = [(name, shp, B, 1, B == 77) for name, shp in AE_SHAPES.items()
             for B in BWD_BATCHES]
    cases.append(("g2.dec 3 lanes, one dead", AE_SHAPES["g2.dec"], 77, 3,
                  False))
    for name, (din, h, dz), B, lanes, fa in cases:
        g, xs, a1, a2, w0s, w1s = _bwd_inputs(gen, B, din, h, dz, lanes)
        if lanes == 3:
            g[1] = 0.0                      # a dead lane's cotangent
        got = lane_mlp.launch_bwd(g, xs, a1, a2, w0s, w1s, final_act=fa)
        want = ref.mlp2_bwd_ref(g, xs, a1, a2, w0s, w1s, fa)
        torch.cuda.synchronize()
        e = max(_relerr(a, b) for a, b in zip(got, want))
        e_abs = max(_maxerr(a, b) for a, b in zip(got, want))
        if lanes == 3:
            _require(all(not bool(t[1].any()) for t in got),
                     "dead lane gradient not exactly zero")
        log(f"lane_mlp_bwd {name} B={B} final_act={fa}: rel err {e:.3e}, "
            f"max|err| {e_abs:.3e}")
        _require(e <= TOL_GRAD, (name, B, e))
        err["lane_mlp_bwd_rel"] = max(err["lane_mlp_bwd_rel"], e)
        err["lane_mlp_bwd"] = max(err["lane_mlp_bwd"], e_abs)
    for kind in ("mse", "mae"):
        for B in (1, 77, TRAIN_B, 2000):
            args = _distill_inputs(gen, B, DISTILL["D"], DISTILL["M"])
            kw = dict(lam=0.3, kind=kind)
            e = _maxerr(distill_loss.launch_fwd(*args, **kw),
                        ref.distill_rows_ref(*args, **kw))
            g = _rand(gen, (B,))
            e2 = max(_maxerr(a, b) for a, b in zip(
                distill_loss.launch_bwd(g, *args, **kw),
                ref.distill_rows_bwd_ref(g, *args, **kw)))
            torch.cuda.synchronize()
            log(f"distill {kind} B={B}: fwd max|err| {e:.3e}, bwd {e2:.3e}")
            _require(e <= TOL_DISTILL and e2 <= TOL_DISTILL, (kind, B, e, e2))
            err["distill_fwd"] = max(err["distill_fwd"], e)
            err["distill_bwd"] = max(err["distill_bwd"], e2)
    for n, C, k in ((15000, 4, PROBE_FOLDS), (77, 2, 3)):
        w, b, x, y, rw = _probe_inputs(gen, n, 256, C, k)
        rwn = rw / torch.clamp(rw.sum(-1, keepdim=True), min=1.0)
        got = probe.launch(w, b, x, y, rwn)
        want = ref.probe_grad_ref(w, b, x, y, rwn)
        torch.cuda.synchronize()
        e = max(_maxerr(a, bb) for a, bb in zip(got, want))
        log(f"probe n={n} C={C} lanes={k}: max|err| {e:.3e}")
        _require(e <= TOL_PROBE, (n, e))
        err["probe"] = max(err["probe"], e)


def _attn_dtypes():
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _slot_pos(W: int, pos: int):
    """Slots 0..pos written, a few empty ones inside the prefix, the rest
    empty (-1)."""
    import torch
    sp = np.where(np.arange(W) <= pos, np.arange(W), -1).astype(np.int32)
    sp[5:9] = -1
    return torch.from_numpy(sp).cuda()


def _within(got, want, tol: float) -> bool:
    """``np.testing.assert_allclose(got, want, atol=tol, rtol=tol)``; False
    where ``got`` is NaN."""
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def bound_ratio(got, want, atol: float, rtol: float) -> float:
    """max |got - want| / (atol + rtol * |want|): at most 1 where
    ``assert_allclose(got, want, atol, rtol)`` holds; NaN where ``got`` is
    NaN and ``want`` is not."""
    r = (got - want).abs() / (atol + rtol * want.abs())
    return float(r.max()) if r.numel() else 0.0


def check_attention_kernels(gen, err: dict) -> None:
    """The flash-attention and decode-attention wrappers, as the model
    calls them, against their plain versions on the same card tensors
    (part of phase 2); each wrapper call must count one launch."""
    import torch
    from repro_torch.kernels import ops, ref
    for name in ("flash_attention", "decode_attention"):
        for dt in TOL_ATTN:
            err[f"{name}/{dt}"] = 0.0
    ratio_key = "flash_attention/bf16_vs_f32_ratio"
    dratio_key = "decode_attention/bf16_vs_f32_ratio"
    err[ratio_key] = err[dratio_key] = 0.0
    calls = {"flash_attention": 0, "decode_attention": 0}
    ops.reset_launches()
    for dname, dt in _attn_dtypes().items():
        for B, S, H, K, hd in FLASH_SHAPES:
            q = _rand(gen, (B, S, H, hd)).to(dt)
            k, v = (_rand(gen, (B, S, K, hd)).to(dt) for _ in range(2))
            for causal, window in FLASH_MASKS:
                got = ops.flash_attention(q, k, v, causal=causal,
                                          window=window)
                calls["flash_attention"] += 1
                want = ref.flash_attention_model(q, k, v, causal=causal,
                                                 window=window)
                torch.cuda.synchronize()
                e = _maxerr(got.float(), want.float())
                log(f"flash_attention {dname} B={B} S={S} H={H} K={K} "
                    f"hd={hd} causal={causal} window={window}: max|err| "
                    f"{e:.3e}")
                _require(got.dtype == dt and _within(
                    got.float(), want.float(), TOL_ATTN[dname]),
                    ("flash", dname, B, S, causal, window, e))
                key = f"flash_attention/{dname}"
                err[key] = max(err[key], e)
                if dt == torch.bfloat16:
                    # the tight bound, over all rows and the later half
                    want = ref.flash_attention_model(
                        q.float(), k.float(), v.float(), causal=causal,
                        window=window)
                    r = bound_ratio(got.float(), want, *TOL_FLASH_BF16_F32)
                    late = bound_ratio(got[:, S // 2:].float(),
                                       want[:, S // 2:], *TOL_FLASH_BF16_F32)
                    log(f"flash_attention bf16 vs fp32 plain B={B} S={S} "
                        f"H={H} K={K} hd={hd} causal={causal} "
                        f"window={window}: bound ratio {r:.3f} (rows >= S/2 "
                        f"{late:.3f})")
                    _require(r <= 1.0, ("flash bf16 vs fp32", B, S, H, K, hd,
                                        causal, window, r))
                    err[ratio_key] = max(err[ratio_key], r)
            del q, k, v, got, want
        B = LM["batch"]
        for (H, K, hd), W in itertools.product(DECODE_HEADS, DECODE_W):
            pos = W * 3 // 4
            sp = _slot_pos(W, pos)
            q = _rand(gen, (B, H, hd)).to(dt)
            kc, vc = (_rand(gen, (B, W, K, hd)).to(dt) for _ in range(2))
            for window in DECODE_WINDOWS:
                got = ops.decode_attention(q, kc, vc, sp, pos,
                                           window=window)
                calls["decode_attention"] += 1
                want = ref.decode_attention_cache(q, kc, vc, sp, pos,
                                                  window=window)
                torch.cuda.synchronize()
                e = _maxerr(got.float(), want.float())
                log(f"decode_attention {dname} B={B} H={H} K={K} hd={hd} "
                    f"W={W} pos={pos} window={window}: max|err| {e:.3e}")
                _require(got.dtype == dt and _within(
                    got.float(), want.float(), TOL_ATTN[dname]),
                    ("decode", dname, H, hd, W, window, e))
                key = f"decode_attention/{dname}"
                err[key] = max(err[key], e)
                if dt == torch.bfloat16:
                    want = ref.decode_attention_cache(
                        q.float(), kc.float(), vc.float(), sp, pos,
                        window=window)
                    r = bound_ratio(got.float(), want, *TOL_DECODE_BF16_F32)
                    log(f"decode_attention bf16 vs fp32 plain B={B} H={H} "
                        f"K={K} hd={hd} W={W} pos={pos} window={window}: "
                        f"bound ratio {r:.3f}")
                    _require(r <= 1.0, ("decode bf16 vs fp32", H, K, hd, W,
                                        window, r))
                    err[dratio_key] = max(err[dratio_key], r)
        # every slot empty: the row is 0 in the kernel and its plain version
        W0 = DECODE_W[0]
        sp = torch.full((W0,), -1, dtype=torch.int32, device="cuda")
        kc, vc = kc[:, :W0], vc[:, :W0]
        got = ops.decode_attention(q, kc, vc, sp, 10)
        calls["decode_attention"] += 1
        want = ref.decode_attention_cache(q, kc, vc, sp, 10)
        torch.cuda.synchronize()
        log(f"decode_attention {dname} every slot empty: max|out| "
            f"{float(got.float().abs().max()):.3e}")
        _require(not bool((got != 0).any()) and not bool((want != 0).any()),
                 ("decode, every slot empty", dname))
    counts = dict(ops.LAUNCHES)
    log(f"attention wrappers' launches {counts}, calls {calls}")
    _require(counts == {k: calls.get(k, 0) for k in counts}, (counts, calls))
    for name in ("flash_attention", "decode_attention"):
        err[name] = err[f"{name}/float32"]


def _ssd_inputs(gen, B, S, H, G, N, P, steep=False):
    """x, dt, A, Bm, Cm on the card as ``ssd_chunked`` receives them: dt a
    softplus and A negative, or (``steep``) dt in [0, 1) and A in [-16,
    -1], so per-step log-decays reach -16."""
    import torch
    import torch.nn.functional as F
    x = _rand(gen, (B, S, H, P))
    if steep:
        dt = torch.rand((B, S, H), generator=gen).cuda()
        A = -torch.exp(torch.rand((H,), generator=gen)
                       * float(np.log(16.0))).cuda()
    else:
        dt = F.softplus(_rand(gen, (B, S, H)))
        A = -torch.exp(_rand(gen, (H,), 0.5))
    return x, dt, A, _rand(gen, (B, S, G, N)), _rand(gen, (B, S, G, N))


def check_ssd_kernel(gen, err: dict) -> None:
    """The SSD intra-chunk wrapper, as ``ssd_chunked`` calls it, against
    its plain version on the same card tensors in the SSD_CASES (part of
    phase 2), and against the plain version on CPU copies, whose products
    sum in another order; each wrapper call must count one launch."""
    import torch
    from repro_torch.kernels import ops, ref
    err["ssd_intra_chunk"] = err["ssd_intra_chunk_vs_cpu"] = 0.0
    ops.reset_launches()
    for name, (B, S, H, G, N, P, Lc, steep) in SSD_CASES.items():
        args = _ssd_inputs(gen, B, S, H, G, N, P, steep)
        y, st = ops.ssd_intra_chunk(*args, Lc)
        y_want, st_want = ref.ssd_intra_chunk_ref(*args, Lc)
        torch.cuda.synchronize()
        _require(tuple(y.shape) == (B, S, H, P) and tuple(st.shape) == (
            B, S // Lc, H, N, P), (name, tuple(y.shape), tuple(st.shape)))
        y_cpu, st_cpu = ref.ssd_intra_chunk_ref(*(t.cpu() for t in args), Lc)
        y, st = y.cpu(), st.cpu()
        e = max(_maxerr(y, y_want.cpu()), _maxerr(st, st_want.cpu()))
        e_cpu = max(_maxerr(y, y_cpu), _maxerr(st, st_cpu))
        log(f"ssd_intra_chunk {name} B={B} S={S} H={H} G={G} N={N} P={P} "
            f"Lc={Lc}: max|err| {e:.3e}, vs the cpu {e_cpu:.3e} (max|y| "
            f"{float(y_cpu.abs().max()):.3e}, max|states| "
            f"{float(st_cpu.abs().max()):.3e}, decays that underflow to 0: "
            f"{_underflow_share(args[1] * args[2], Lc):.3f})")
        for want, want_st in ((y_want.cpu(), st_want.cpu()), (y_cpu, st_cpu)):
            _require(_within(y, want, TOL_SSD) and _within(
                st, want_st, TOL_SSD), ("ssd", name, e, e_cpu))
        err["ssd_intra_chunk"] = max(err["ssd_intra_chunk"], e)
        err["ssd_intra_chunk_vs_cpu"] = max(err["ssd_intra_chunk_vs_cpu"],
                                            e_cpu)
    counts = dict(ops.LAUNCHES)
    _require(counts["ssd_intra_chunk"] == len(SSD_CASES), counts)


def _underflow_share(a, Lc: int) -> float:
    """The share of the lower-triangle decays exp(cs_l - cs_s) of the first
    chunk that are exactly 0 in fp32."""
    import torch
    from repro_torch.kernels.ref import prefix_sum
    cs = prefix_sum(a[:, :Lc], 1).movedim(1, -1)          # (B, H, Lc)
    d = torch.exp(cs[..., :, None] - cs[..., None, :])
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=a.device).tril()
    return float((d[..., tri] == 0).float().mean())


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


def _scenario():
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.data.vertical import make_scenario
    ds = make_dataset(SCENARIO["dataset"], seed=SCENARIO["seed"])
    return make_scenario(ds, n_active_features=SCENARIO["active_features"],
                         n_aligned=SCENARIO["aligned"], seed=SCENARIO["seed"])


def _run(sc, device: str, use_kernel: bool = True):
    """``run_apcvfl`` at phase 4's settings on ``device``."""
    from repro_torch.core import pipeline
    return pipeline.run_apcvfl(sc, seed=SCENARIO["seed"],
                               max_epochs=TRAIN["epochs"],
                               use_kernel=use_kernel, device=device)


def _loss_rel_err(got: dict, want: dict) -> dict:
    """Per stage, each epoch's relative train-loss gap of ``got`` to
    ``want`` (``inf`` where the histories differ in length)."""
    return {stage: ([abs(a - b) / abs(b) for a, b in zip(got[stage], hist)]
                    if len(got[stage]) == len(hist) else [float("inf")])
            for stage, hist in want.items()}


def _losses_agree(loss_err: dict) -> bool:
    """Every epoch within TOL_LOSS, g3's last within TOL_LOSS_G3_LAST."""
    return all(max(errs[:-1], default=0.0) <= TOL_LOSS and errs[-1] <= (
        TOL_LOSS_G3_LAST if stage == "g3" else TOL_LOSS)
        for stage, errs in loss_err.items())


def phase_train() -> dict:
    """Train, export and serve through the CLI on the card; hold it
    against the same run on the CPU; then the probe kernel's k-fold CV on
    the trained latents."""
    import time
    import torch
    from repro_torch import convert
    from repro_torch.core import autoencoder as ae
    from repro_torch.core import classifier as clf
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_vfl
    from repro_torch.serve.vfl import ModelBundle
    log("=== phase 4: train on mimic3 at full width, export, serve ===")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bundle")
        out = os.path.join(tmp, "stats.json")
        argv = ["--dataset", SCENARIO["dataset"],
                "--aligned", str(SCENARIO["aligned"]),
                "--active-features", str(SCENARIO["active_features"]),
                "--epochs", str(TRAIN["epochs"]),
                "--requests", str(TRAIN["requests"]),
                "--seed", str(SCENARIO["seed"]), "--bundle", path,
                "--out", out]
        ops.reset_launches()
        rc = serve_vfl.main(argv)
        train_counts = dict(ops.LAUNCHES)
        _require(rc == 0, rc)
        with open(out) as fh:
            stats = json.load(fh)
        bundle = ModelBundle.load(path)
    log(f"train + export + serve: launches {train_counts}")
    for k in ("lane_mlp_fwd", "lane_mlp_bwd", "distill_fwd", "distill_bwd"):
        _require(train_counts[k] > 0, f"{k} never ran while training")
    _require(stats["rows"] > 0 and stats["dispatches"], stats)
    card = stats["train"]

    # the same run on the CPU: same seed, so same inits and batches
    sc = _scenario()
    t0 = time.perf_counter()
    cpu = _run(sc, "cpu")
    cpu_s = time.perf_counter() - t0
    _require(card["epochs"] == cpu.epochs, (card["epochs"], cpu.epochs))
    _require(card["comm"] == json.loads(json.dumps(cpu.comm)),
             (card["comm"], cpu.comm))
    loss_err = _loss_rel_err(card["train_loss"], cpu.train_loss)
    _require(_losses_agree(loss_err), loss_err)
    metric_gap = {k: abs(card["metrics"][k] - v)
                  for k, v in cpu.metrics.items()}
    _require(max(metric_gap.values()) < TOL_METRIC, metric_gap)
    log(f"card vs cpu: epochs {cpu.epochs}, train-loss rel err per epoch "
        f"{loss_err}, metric gap {metric_gap}")

    # step 4's probe through the kernel, on the trained latents
    with torch.no_grad():
        z_all = ae.fused_encode(convert.to_torch(bundle.g3, device="cuda"),
                                torch.as_tensor(sc.active.x, device="cuda"))
    torch.cuda.synchronize()
    ops.reset_launches()
    m_kernel = clf.kfold_cv(z_all, sc.active.y, sc.n_classes,
                            use_kernel=True, device="cuda")
    probe_counts = dict(ops.LAUNCHES)
    _require(probe_counts["probe"] > 0, "probe kernel never ran")
    m_plain = clf.kfold_cv(z_all, sc.active.y, sc.n_classes, device="cuda")
    probe_gap = {k: abs(m_kernel[k] - m_plain[k]) for k in m_plain}
    _require(max(probe_gap.values()) < TOL_METRIC, probe_gap)
    _require(all(0.0 <= v <= 1.0 for v in m_kernel.values()), m_kernel)
    log(f"kfold_cv with the probe kernel: {m_kernel} (launches "
        f"{probe_counts['probe']}), gap to plain {probe_gap}")
    return {"launches": {k: train_counts[k] + probe_counts[k]
                         for k in train_counts},
            "train_launches": train_counts, "probe_launches": probe_counts,
            "card": card, "cpu_train_loss": cpu.train_loss,
            "cpu_seconds": cpu_s,
            "cpu_metrics": cpu.metrics, "loss_rel_err": loss_err,
            "metric_gap": metric_gap, "kfold_kernel": m_kernel,
            "kfold_plain": m_plain, "probe_metric_gap": probe_gap,
            "stream": {k: stats[k] for k in ("rows_per_s", "latency_ms_p50",
                                              "latency_ms_p99")}}


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


def _bound_ms(flops: float, nbytes: float,
              peak: float = PEAK_FP32_FLOPS) -> tuple:
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_time() -> dict:
    import torch
    log(f"=== phase 5: kernel timing (bucket {BUCKET}, batch "
        f"{TRAIN_B}) ===")
    gen = torch.Generator().manual_seed(3)
    B = BUCKET
    sets = {"lane_mlp_fwd": _lane_mlp_fwd_set(gen, ENCODERS, B),
            "lane_mlp_fwd_bucket16": _lane_mlp_fwd_set(gen, ENCODERS, 16),
            "lane_mlp_fwd_train": _lane_mlp_fwd_set(gen, AE_SHAPES, TRAIN_B,
                                                    save=True),
            "int8_matmul": _int8_set(gen, B),
            "int8_matmul_bucket16": _int8_set(gen, 16)}
    sets.update(_training_kernel_sets(gen))
    sets.update(_attention_kernel_sets(gen))
    sets.update(_ssd_kernel_sets(gen))
    res = {}
    for kname, items in sets.items():
        per_shape = []
        peak = items[0].get("peak", PEAK_FP32_FLOPS)
        for it in items:
            row = {"shape": it["shape"]}
            for which in ("kernel", "plain", "library"):
                row[f"{which}_ms"] = (None if it[which] is None
                                      else graph_ms(it[which],
                                                    it.get("iters", 50)))
            row["bound_ms"], row["bound_by"] = _bound_ms(
                it["flops"], it["bytes"], peak)
            per_shape.append(row)
            log(f"{kname} {row}")
        bound, by = _bound_ms(sum(i["flops"] for i in items),
                              sum(i["bytes"] for i in items), peak)
        lib = [r["library_ms"] for r in per_shape]
        res[kname] = {
            "ms": sum(r["kernel_ms"] for r in per_shape),
            "plain_ms": sum(r["plain_ms"] for r in per_shape),
            "library_ms": None if None in lib else sum(lib),
            "bound_ms": bound, "bound_by": by, "per_shape": per_shape}
    return res


def _int8_set(gen, B: int) -> list:
    """Timing items of the int8 matmul at ``B`` rows over the quantized
    active path's three layers; the library call dequantizes the weight
    and runs ``addmm`` (and ``F.selu`` on the first layer)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    items = []
    for name, (d, c, act) in INT8_LAYERS.items():
        a = _int8_inputs(gen, B, d, c)
        sel = F.selu if act == "selu" else (lambda t: t)
        plain_sel = ref.selu if act == "selu" else (lambda t: t)
        items.append(dict(
            shape=f"{name} {d}->{c} B={B}", flops=2.0 * B * d * c,
            bytes=4.0 * B * d + d * c + 8.0 * c + 4.0 * B * c,
            kernel=lambda a=a, act=act: ops.int8_matmul(*a, act=act),
            plain=lambda a=a, s=plain_sel: s(ref.int8_matmul_ref(*a)),
            library=lambda a=a, s=sel: s(torch.addmm(
                a[3], a[0], a[1].float() * a[2]))))
    return items


def _lane_mlp_fwd_set(gen, shapes: dict, B: int, save: bool = False) -> list:
    """Timing items of the lane-MLP forward at ``B`` rows over ``shapes``
    (din, h, dz): the wrapper as serving calls it, or with ``save`` the
    launch training's ``LaneMLP2`` makes (a1 and a2 written too, counted
    in the bytes).  The library calls are ``addmm``, ``F.selu``,
    ``addmm``, which also leave a1 and a2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import lane_mlp, ops, ref
    items = []
    for name, (din, h, dz) in shapes.items():
        a = _mlp_inputs(gen, B, din, h, dz)
        if save:
            kernel = lambda s=tuple(t[None] for t in a): lane_mlp.launch(
                *s, save=True)
            plain = lambda a=a: ref.mlp2_fwd_ref(*a)
        else:
            kernel = lambda a=a: ops.fused_mlp2(*a)
            plain = lambda a=a: ref.mlp2_ref(*a)
        items.append(dict(
            shape=f"{name} {din}->{h}->{dz} B={B}" + (" save" if save
                                                      else ""),
            flops=2.0 * B * (din * h + h * dz),
            bytes=4.0 * (B * din + din * h + h + h * dz + dz + B * dz
                         + (B * (h + dz) if save else 0)),
            kernel=kernel, plain=plain,
            library=lambda a=a: torch.addmm(
                a[4], F.selu(torch.addmm(a[2], a[0], a[1])), a[3])))
    return items


def _library_mlp_bwd(g, x, a1, a2, w0, w1):
    """The lane-MLP backward in the fewest PyTorch calls: five ``mm`` for
    the gradient products, ``elu_backward`` for selu', two sums."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import SELU_ALPHA, SELU_SCALE
    dw1 = torch.mm(F.selu(a1).T, g)
    g1 = torch.ops.aten.elu_backward(torch.mm(g, w1.T), SELU_ALPHA,
                                     SELU_SCALE, 1.0, False, a1)
    return torch.mm(g1, w0.T), torch.mm(x.T, g1), g1.sum(0), dw1, g.sum(0)


def _library_probe(w, b, x, y, rwn):
    """The probe step as ``log_softmax`` cross-entropy plus ``matmul``."""
    import torch
    import torch.nn.functional as F
    logits = torch.matmul(x, w) + b[:, None]
    lp = F.log_softmax(logits, dim=-1)
    yl = y.long()[None, :, None].expand(w.shape[0], -1, 1)
    loss = -(lp.gather(-1, yl)[..., 0] * rwn).sum(-1)
    g = (lp.exp() - F.one_hot(y.long(), w.shape[-1])) * rwn[..., None]
    return loss, torch.matmul(x.T, g), g.sum(1)


def _training_kernel_sets(gen) -> dict:
    """Timing sets of the training kernels at the shapes the training
    path gives them: the lane-MLP backward of each Table-3 MLP at the
    batch of 128, step 3's Eq. 5 rows, and one probe step of the 10 fold
    lanes over mimic3's active rows."""
    from repro_torch.kernels import distill_loss, lane_mlp, probe, ref
    B = TRAIN_B
    sets = {"lane_mlp_bwd": []}
    for name, (din, h, dz) in AE_SHAPES.items():
        a = _bwd_inputs(gen, B, din, h, dz)
        flops = 4.0 * B * (din * h + h * dz)
        nbytes = 4.0 * (B * (2 * dz + din + h) + din * h + h * dz      # in
                        + B * din + din * h + h + h * dz + dz)         # out
        sets["lane_mlp_bwd"].append(dict(
            shape=f"{name} {din}->{h}->{dz} B={B}", flops=flops,
            bytes=nbytes, kernel=lambda a=a: lane_mlp.launch_bwd(*a),
            plain=lambda a=a: ref.mlp2_bwd_ref(*a),
            library=lambda a=tuple(t[0] for t in a): _library_mlp_bwd(*a)))
    D, M = DISTILL["D"], DISTILL["M"]
    args = _distill_inputs(gen, B, D, M)
    g = _rand(gen, (B,))
    kw = dict(lam=DISTILL["lam"], kind="mse")
    shape = f"step 3 B={B} D={D} M={M} mse"
    sets["distill_fwd"] = [dict(
        shape=shape, flops=3.0 * B * (D + M + 1),
        bytes=4.0 * (2 * B * D + 2 * B * M + 2 * B),
        kernel=lambda: distill_loss.launch_fwd(*args, **kw),
        plain=lambda: ref.distill_rows_ref(*args, **kw), library=None)]
    sets["distill_bwd"] = [dict(
        shape=shape, flops=B * (3.0 * D + 4.0 * M + 5),
        bytes=4.0 * (3 * B + 3 * B * D + 3 * B * M),
        kernel=lambda: distill_loss.launch_bwd(g, *args, **kw),
        plain=lambda: ref.distill_rows_bwd_ref(g, *args, **kw),
        library=None)]
    n, d, C, k = len(_scenario().active.x), 256, N_CLASSES, PROBE_FOLDS
    w, b, x, y, rw = _probe_inputs(gen, n, d, C, k)
    rwn = rw / rw.sum(-1, keepdim=True).clamp(min=1.0)
    pa = (w, b, x, y, rwn)
    sets["probe"] = [dict(
        shape=f"{k} fold lanes n={n} d={d} C={C}",
        flops=k * (4.0 * n * d * C + 8.0 * n * C),
        bytes=4.0 * (n * d + n + k * n + 2 * k * d * C + 2 * k * C + k),
        kernel=lambda: probe.launch(*pa),
        plain=lambda: ref.probe_grad_ref(*pa),
        library=lambda: _library_probe(*pa))]
    return sets


def _attention_kernel_sets(gen) -> dict:
    """Timing sets of the attention kernels in bf16 at the LM cells'
    shapes (internlm2-1.8b: H 16, K 8, hd 128): flash attention at
    ``prefill_step``'s B 2, S 2048 (causal) and, apart, at the engine's
    one-prompt prefill (B 1, S 128) and at zamba2's shared block in its
    ``prefill_step`` (B 2, S 2048, H = K = 32, hd 80); decode attention at
    the engine's batch of 8 against its 1024-slot cache with slots 0..511
    written, and apart at zamba2's heads (H = K = 32, hd 80).  Operations
    count the pairs the mask keeps; bytes count q, k, v and out once (for
    decode, the written slots' K/V rows)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    bf16 = torch.bfloat16
    sets = {}
    for key, (B, S), (H, K, hd) in (
            ("flash_attention", LM_PREFILL, (16, 8, 128)),
            ("flash_attention_engine_prefill", (1, LM["prefill_len"]),
             (16, 8, 128)),
            ("flash_attention_zamba2_prefill", ZAMBA["prefill"],
             (32, 32, 80))):
        q = _rand(gen, (B, S, H, hd)).to(bf16)
        k, v = (_rand(gen, (B, S, K, hd)).to(bf16) for _ in range(2))
        sets[key] = [dict(
            shape=f"B={B} S={S} H={H} K={K} hd={hd} causal bf16",
            flops=4.0 * B * H * hd * S * (S + 1) / 2,
            bytes=2.0 * (2 * B * S * H * hd + 2 * B * S * K * hd),
            peak=PEAK_BF16_FLOPS, iters=10,
            kernel=lambda a=(q, k, v): ops.flash_attention(*a, causal=True),
            plain=lambda a=(q, k, v): ref.flash_attention_model(
                *a, causal=True),
            library=lambda a=(q, k, v): F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in a), is_causal=True,
                enable_gqa=True))]
    B, W, pos = LM["batch"], LM["slots"], LM["slots"] // 2 - 1
    sp = torch.where(torch.arange(W) <= pos, torch.arange(W), -1).to(
        torch.int32).cuda()
    valid = int((sp >= 0).sum())
    mask = (sp >= 0) & (sp <= pos)
    for key, (H, K, hd) in (("decode_attention", (16, 8, 128)),
                            ("decode_attention_zamba2", (32, 32, 80))):
        q = _rand(gen, (B, H, hd)).to(bf16)
        kc, vc = (_rand(gen, (B, W, K, hd)).to(bf16) for _ in range(2))
        sets[key] = [dict(
            shape=f"B={B} W={W} valid={valid} H={H} K={K} hd={hd} bf16",
            flops=4.0 * B * H * hd * valid,
            bytes=2.0 * (2 * B * H * hd + 2 * B * valid * K * hd) + 4.0 * W,
            peak=PEAK_BF16_FLOPS,
            kernel=lambda a=(q, kc, vc): ops.decode_attention(*a, sp, pos),
            plain=lambda a=(q, kc, vc): ref.decode_attention_cache(
                *a, sp, pos),
            library=lambda a=(q, kc, vc): F.scaled_dot_product_attention(
                a[0][:, :, None], a[1].transpose(1, 2), a[2].transpose(1, 2),
                attn_mask=mask[None, None, None], enable_gqa=True))]
    return sets


def ssd_work(B, S, H, G, N, P, Lc) -> tuple:
    """(operations, bytes) of the SSD intra-chunk block: per (b, chunk,
    head) the lower triangle's scores (N) and y (P) products, 2 operations
    a multiply-add, and the states' Lc * N * P; bytes count x, dt, A, B, C
    in and y, states out once."""
    tri = Lc * (Lc + 1) / 2
    flops = B * (S // Lc) * H * (2.0 * tri * (N + P) + 2.0 * Lc * N * P)
    nbytes = 4.0 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * G * N
                    + B * (S // Lc) * H * N * P)
    return flops, nbytes


def _ssd_kernel_sets(gen) -> dict:
    """The SSD kernel at zamba2's prefill (``prefill_step``'s B 2, S 2048:
    H 80, one group, N = P = 64, Lc 256), inputs distributed as the model
    gives them; no single PyTorch call computes the block."""
    from repro_torch.kernels import ops, ref
    cfg = _zamba_cfg()
    B, S = ZAMBA["prefill"]
    H, G, N, P, Lc = (cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_head_dim, cfg.ssm_chunk)
    args = _ssd_inputs(gen, B, S, H, G, N, P)
    flops, nbytes = ssd_work(B, S, H, G, N, P, Lc)
    return {"ssd_intra_chunk": [dict(
        shape=f"B={B} S={S} H={H} G={G} N={N} P={P} Lc={Lc} fp32",
        flops=flops, bytes=nbytes, iters=10,
        kernel=lambda: ops.ssd_intra_chunk(*args, Lc),
        plain=lambda: ref.ssd_intra_chunk_ref(*args, Lc), library=None)]}


def _observed(fn, calls: list):
    """``fn`` (a stage's training call) wrapped to record its launches and
    a profiler split of its device time into ``calls``."""
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops

    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launches = dict(ops.LAUNCHES)
        split = {"port kernels": 0.0, "other device work": 0.0}
        other: dict = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            if any(k in e.name for k in ("lane_mlp", "distill", "probe")):
                split["port kernels"] += us
            else:
                split["other device work"] += us
                other[e.name] = other.get(e.name, 0.0) + us
        rs = out if isinstance(out, list) else [out]
        steps = max(r.steps_run for r in rs)     # a group steps together
        busy = sum(split.values())
        calls.append({
            "steps": steps, "launches": launches,
            "launches_per_step": sum(launches.values()) / steps,
            "wall_ms_profiled": wall_us / 1e3,
            "device_ms": {k: v / 1e3 for k, v in split.items()},
            "device_busy_share": busy / wall_us,
            "top_other": sorted(((v / 1e3, k[:80]) for k, v in
                                 other.items()), reverse=True)[:6]})
        return out
    return wrapped


def phase_train_time(card: dict) -> dict:
    """Each stage's steps/s and ms per epoch in phase 4's card run, as
    ``run_apcvfl`` timed it; then one epoch of ``run_apcvfl`` on the card
    with each stage's training call observed (``_observed``): its launches
    per step, and how its device time splits between the port's kernels
    and the other device work (Adam's elementwise ops, the losses, gathers,
    partial sums) against the wall time, the rest being the host."""
    from repro_torch.core import pipeline, training
    log("=== phase 5b: training stages at full width ===")
    res = {}
    for stage, roles in STAGES.items():
        sec = card["stage_seconds"][stage]
        steps = max(card["steps"][r] for r in roles)
        epochs = max(card["epochs"][r] for r in roles)
        res[stage] = {"seconds": sec, "steps": steps, "epochs": epochs,
                      "steps_per_s": steps / sec,
                      "ms_per_epoch": sec / epochs * 1e3}
        log(f"train {stage}: {res[stage]}")
    calls: list = []
    plain = {name: getattr(training, name) for name in ("train",
                                                        "train_lanes")}
    try:
        for name, fn in plain.items():
            setattr(training, name, _observed(fn, calls))
        pipeline.run_apcvfl(_scenario(), seed=SCENARIO["seed"],
                            max_epochs=1, use_kernel=True, device="cuda")
    finally:
        for name, fn in plain.items():
            setattr(training, name, fn)
    _require(len(calls) == len(STAGES), f"{len(calls)} training calls")
    for stage, call in zip(STAGES, calls):
        res[stage]["profiled_epoch"] = call
        log(f"profile of one {stage} epoch: {call}")
    return res


def phase_turns() -> list:
    """The same request stream served fp32, int8, int8, fp32 by warmed
    engines in one process, so the two modes are compared in turns and
    not in the order phase 3 ran them."""
    from repro_torch.serve import vfl
    log("=== phase 5c: fp32 and int8 streams in turns ===")
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


def phase_limit(train: dict) -> dict:
    """The readings that place TOL_LOSS_G3_LAST, taken in this run against
    phase 4's CPU run: below the limit, the CPU's own spread (the same
    seed through autograd, ``use_kernel=False``, instead of the closed-form
    backward); above it, ``run_apcvfl`` on the card with each planted fault
    of FAULTS in the Eq. 5 backward kernel's output."""
    from repro_torch.kernels import distill_loss
    log("=== phase 6: readings of the g3 limit ===")
    sc = _scenario()
    want = train["cpu_train_loss"]
    spread = _loss_rel_err(_run(sc, "cpu", use_kernel=False).train_loss,
                           want)
    log(f"cpu closed-form vs autograd: train-loss rel err {spread}")
    _require(spread["g3"][-1] <= TOL_LOSS_G3_LAST,
             f"the CPU's own g3 spread {spread['g3']} is not below "
             f"{TOL_LOSS_G3_LAST}")
    faults = {}
    launch_bwd = distill_loss.launch_bwd
    for what, scale in FAULTS.items():
        def planted(*args, scale=scale, **kw):
            dx, dz, dm = launch_bwd(*args, **kw)
            return dx, dz * scale, dm
        distill_loss.launch_bwd = planted
        try:
            faults[what] = _loss_rel_err(_run(sc, "cuda").train_loss, want)
        finally:
            distill_loss.launch_bwd = launch_bwd
        log(f"planted fault {what}: train-loss rel err {faults[what]}")
        _require(faults[what]["g3"][-1] > TOL_LOSS_G3_LAST,
                 f"planted fault {what} passes the g3 limit")
    return {"limit": TOL_LOSS_G3_LAST, "card": train["loss_rel_err"],
            "cpu_spread": spread, "faults": faults}


def _engine_prompts(reqs, P: int) -> np.ndarray:
    """The requests' prompts cut or right-padded (repeating the last token)
    to ``P``, as the engine prefills them."""
    rows = []
    for r in reqs:
        p = np.asarray(r.prompt, np.int32)[:P]
        rows.append(np.concatenate([p, np.full(P - len(p), p[-1], np.int32)]))
    return np.stack(rows)


def phase_lm() -> dict:
    """The dense decoder's serving path on the card (phase 7): the full
    cell through the CLI, ``prefill_step``, then depth 2 against the
    CPU."""
    import time
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve.decode import prefill_step
    log(f"=== phase 7: serve {LM['arch']} at full width and depth ===")
    cfg = get_config(LM["arch"]).with_(use_flash_kernel=True)
    L = cfg.n_layers
    res = {"launches": {k: 0 for k in ops.LAUNCHES}}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "lm.json")
        argv = ["--arch", LM["arch"], "--no-smoke", "--device", CARD,
                "--batch", str(LM["batch"]), "--slots", str(LM["slots"]),
                "--prefill-len", str(LM["prefill_len"]),
                "--requests", str(LM["requests"]),
                "--prompt-len", *map(str, LM["prompt"]),
                "--max-new", str(LM["max_new"]), "--out", out]
        ops.reset_launches()
        rc = serve.main(argv)
        counts = dict(ops.LAUNCHES)
        _require(rc == 0, rc)
        with open(out) as fh:
            stats = json.load(fh)
    log(f"lm serve: {stats} (launches {counts})")
    _require(stats["n_layers"] == L and stats["dtype"] == "bfloat16"
             and stats["completed"] == LM["requests"]
             and stats["tokens_out"] == LM["requests"] * LM["max_new"],
             stats)
    _require(counts["flash_attention"] == L * stats["prefills"],
             f"flash launches {counts['flash_attention']}, expected "
             f"{L} x {stats['prefills']} prefills")
    _require(counts["decode_attention"] == L * stats["decode_steps"],
             f"decode launches {counts['decode_attention']}, expected "
             f"{L} x {stats['decode_steps']} steps")
    res["serve"] = stats
    res["serve_launches"] = counts
    res["launches_per_decode_step"] = (counts["decode_attention"]
                                       / stats["decode_steps"])

    # prefill_step at B 2, S 2048 on the same weights
    params = serve.build_params(cfg, device=CARD)
    B, S = LM_PREFILL
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(CARD)
    walls = []
    ops.reset_launches()
    for _ in range(2):                 # the first call also warms cuBLAS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = prefill_step(params, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    pcounts = dict(ops.LAUNCHES)
    _require(tuple(lg.shape) == (B, cfg.vocab_size) and lg.dtype
             == torch.bfloat16 and bool(torch.isfinite(lg).all()),
             (tuple(lg.shape), lg.dtype))
    _require(pcounts["flash_attention"] == 2 * L, pcounts)
    prof = _profiled(lambda: prefill_step(params, cfg, {"tokens": toks}), 1)
    res["prefill_step"] = {"B": B, "S": S, "ms": walls,
                           "launches": pcounts, "profile": prof}
    log(f"prefill_step B={B} S={S}: {walls} ms (launches {pcounts}); "
        f"profile {prof}")
    for k in ops.LAUNCHES:
        res["launches"][k] = counts[k] + pcounts[k]
    res["decode_profile"] = _profile_decode(params, cfg)
    del params, lg
    torch.cuda.empty_cache()
    res["check"] = lm_card_vs_cpu()
    return res


# the port's kernels by the name of their __global__ function
KERNEL_NAMES = {"decode_kernel": "decode_attention",
                "flash_kernel": "flash_attention",
                "ssd_kernel": "ssd_intra_chunk"}


def _profiled(fn, calls: int) -> dict:
    """``calls`` calls of ``fn`` under the profiler: the host wall per call,
    the card's time per call by kind (each port kernel, GEMMs (cuBLAS), and
    the rest: PyTorch's elementwise, copy and reduction kernels), its busy
    share of the wall, and the largest device items."""
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = {k: 0.0 for k in (*KERNEL_NAMES.values(), "gemm", "other")}
    names: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        low = e.name.lower()
        kind = next((v for k, v in KERNEL_NAMES.items() if k in low), None)
        if kind is None:
            kind = ("gemm" if any(t in low for t in (
                "gemm", "gemv", "cutlass", "xmma", "nvjet")) else "other")
        kinds[kind] += us
        names[e.name[:80]] = names.get(e.name[:80], 0.0) + us
    return {"calls": calls, "wall_ms_per_call_profiled": wall_us / calls / 1e3,
            "device_ms_per_call": {k: v / calls / 1e3
                                   for k, v in kinds.items()},
            "device_busy_share": sum(kinds.values()) / wall_us,
            "top": sorted(((v / calls / 1e3, k) for k, v in names.items()),
                          reverse=True)[:8]}


def _profile_decode(params, cfg, steps: int = 10) -> dict:
    """Decode steps of the LM cell's engine (8 requests in flight, warm):
    ``steps`` timed by the engine, then ``steps`` under the profiler
    (``_profiled``)."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import Engine
    eng = Engine(params, cfg, batch=LM["batch"], n_slots=LM["slots"],
                 prefill_len=LM["prefill_len"], device=CARD)
    for r in serve.make_requests(LM["batch"], cfg.vocab_size,
                                 lo=LM["prompt"][0], hi=LM["prompt"][1],
                                 max_new=LM["max_new"]):
        eng.submit(r)
    for _ in range(3 + steps):       # the prefills, then warm decode steps
        eng.step()
    out = {"steps": steps, "step_ms_unprofiled": eng.step_ms[-steps:]}
    out.update(_profiled(eng.step, steps))
    log(f"decode profile: {out}")
    return out


def lm_card_vs_cpu() -> dict:
    """internlm2-1.8b at full width, depth 2, fp32, weights made once on
    the CPU and copied to the card: the prefill and decode logits agree
    within TOL_LM x max|logit| and the engine's tokens are identical."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.transformer import decoder_prefill_with_cache
    from repro_torch.serve.engine import Engine
    from repro_torch.tree import tree_map
    c = LM_CHECK
    cfg = get_config(LM["arch"]).with_(n_layers=c["layers"], dtype="float32",
                                       use_flash_kernel=True)
    cpu = serve.build_params(cfg, device="cpu")
    card = tree_map(lambda t: t.to(CARD), cpu)
    reqs = lambda: serve.make_requests(c["requests"], cfg.vocab_size,
                                       lo=LM["prompt"][0], hi=LM["prompt"][1],
                                       max_new=c["max_new"])
    P = LM["prefill_len"]
    toks = torch.from_numpy(_engine_prompts(reqs(), P))
    runs = {}
    ops.reset_launches()
    for dev, p in ((CARD, card), ("cpu", cpu)):
        with torch.no_grad():
            lg, cache = decoder_prefill_with_cache(p, cfg, toks.to(dev),
                                                   c["slots"])
            logits = [lg.cpu()]
            tok = torch.argmax(lg, -1)
            for t in range(c["steps"]):
                lg, cache = M.decode(p, cfg, tok, cache, P + t)
                logits.append(lg.cpu())
                tok = torch.argmax(lg, -1)
        runs[dev] = logits
    direct = dict(ops.LAUNCHES)
    _require(direct["flash_attention"] == cfg.n_layers and
             direct["decode_attention"] == cfg.n_layers * c["steps"], direct)
    rel = []
    for got, want in zip(runs[CARD], runs["cpu"]):
        _require(bool(torch.isfinite(got).all()), "card logits not finite")
        _require(torch.equal(torch.argmax(got, -1), torch.argmax(want, -1)),
                 "card and cpu disagree on a greedy token")
        rel.append(float((got - want).abs().max() / want.abs().max()))
    log(f"depth-2 card vs cpu logits, max|d| / max|logit| per step: {rel}")
    _require(max(rel) <= TOL_LM, rel)
    # the card's kernels against the reference's plain _sdpa sites (the
    # switch off, so the CPU runs _sdpa): prefill and the first decode step
    with torch.no_grad():
        plain = cfg.with_(use_flash_kernel=False)
        lg, cache = decoder_prefill_with_cache(cpu, plain, toks, c["slots"])
        lg2, _ = M.decode(cpu, plain, torch.argmax(lg, -1), cache, P)
    routing = [float((a - b).abs().max() / b.abs().max())
               for a, b in zip(runs[CARD][:2], (lg, lg2))]
    log(f"depth-2, the card's kernels vs the plain _sdpa sites on the cpu, "
        f"max|d| / max|logit| (prefill, decode): {routing}")
    _require(max(routing) <= TOL_LM, routing)
    gens = {}
    for dev, p in ((CARD, card), ("cpu", cpu)):
        eng = Engine(p, cfg, batch=c["requests"], n_slots=c["slots"],
                     prefill_len=P, device=dev)
        rs = reqs()
        for r in rs:
            eng.submit(r)
        ops.reset_launches()
        st = eng.run()
        if dev == CARD:
            eng_counts = dict(ops.LAUNCHES)
        gens[dev] = ([r.generated for r in rs], st)
    _require(gens[CARD][0] == gens["cpu"][0],
             "card and cpu engines generated different tokens")
    _require(gens[CARD][1] == gens["cpu"][1], (gens[CARD][1],
                                                 gens["cpu"][1]))
    _require(eng_counts["flash_attention"] > 0
             and eng_counts["decode_attention"] > 0, eng_counts)
    log(f"depth-2 engines: identical tokens ({gens['cpu'][1]}); card "
        f"launches {eng_counts}")
    return {"layers": c["layers"], "logit_rel_err": rel,
            "max_logit_rel_err": max(rel), "routing_rel_err": routing,
            "tokens_identical": True,
            "stats": gens["cpu"][1].__dict__, "launches": eng_counts,
            "direct_launches": direct}


def _zamba_cfg(**kw):
    from repro_torch.configs import get_config
    return get_config(ZAMBA["arch"]).with_(**kw)


def _tokens(seed: int, B: int, S: int, vocab: int):
    import torch
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, (B, S)).astype(np.int32))


def phase_zamba() -> dict:
    """The zamba2 hybrid's serving path on the card (phase 8): at full width
    and depth in bf16, ``prefill_step`` at B 2, S 2048 (54 SSD and 9 flash
    launches a call) and lockstep greedy decode through
    ``make_decode_step`` from ``init_cache`` (9 decode launches a step),
    with a profiled window of each; then one group in fp32 against the CPU
    and the card's decode against its forward (``zamba_checks``)."""
    import time
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve.decode import make_decode_step, prefill_step
    from repro_torch.tree import tree_leaves
    log(f"=== phase 8: serve {ZAMBA['arch']} at full width and depth ===")
    cfg = _zamba_cfg()
    L, G = cfg.n_layers, cfg.n_layers // cfg.attn_period
    params = serve.build_params(cfg, device=CARD)
    res = {"n_params": sum(t.numel() for t in tree_leaves(params)),
           "launches": {k: 0 for k in ops.LAUNCHES}}
    per_prefill = {k: 0 for k in ops.LAUNCHES}
    per_prefill.update(ssd_intra_chunk=L, flash_attention=G)

    B, S = ZAMBA["prefill"]
    toks = _tokens(1, B, S, cfg.vocab_size).to(CARD)
    walls = []
    with torch.no_grad():
        for _ in range(1 + ZAMBA["prefill_calls"]):   # the first warms up
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            lg = prefill_step(params, cfg, {"tokens": toks})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            counts = dict(ops.LAUNCHES)
            _require(counts == per_prefill, (counts, per_prefill))
            for k, v in counts.items():
                res["launches"][k] += v
        _require(tuple(lg.shape) == (B, cfg.vocab_size) and lg.dtype
                 == torch.bfloat16 and bool(torch.isfinite(lg).all()),
                 (tuple(lg.shape), lg.dtype))
        prof = _profiled(lambda: prefill_step(params, cfg, {"tokens": toks}),
                         1)
    res["prefill_step"] = {"B": B, "S": S, "ms": walls,
                           "ms_p50_warm": float(np.median(walls[1:])),
                           "launches_per_call": counts, "profile": prof}
    log(f"zamba prefill_step B={B} S={S}: {walls} ms, launches per call "
        f"{counts}; profile {prof}")
    del lg

    Bd, P, new = ZAMBA["batch"], ZAMBA["prompt"], ZAMBA["new"]
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (Bd, P)).astype(np.int32)
    step = make_decode_step(cfg)
    state = {"cache": M.init_cache(params, cfg, Bd, ZAMBA["slots"]),
             "pos": 0, "tok": torch.from_numpy(prompts[:, 0]).to(CARD)}

    def one_step():
        """One decode step, ending in the device->host copy of its tokens;
        the next input is the prompt's next token or this step's output."""
        nxt, state["cache"] = step(params, state["tok"], state["cache"],
                                   state["pos"])
        out = nxt.cpu().numpy()
        state["pos"] += 1
        state["tok"] = (torch.from_numpy(prompts[:, state["pos"]]).to(CARD)
                        if state["pos"] < P else nxt)
        return out

    step_ms, generated = [], []
    ops.reset_launches()
    with torch.no_grad():
        for t in range(P + new):
            t0 = time.perf_counter()
            out = one_step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if t >= P - 1:
                generated.append(out)
        dcounts = dict(ops.LAUNCHES)
        per_step = {k: 0 for k in ops.LAUNCHES}
        per_step["decode_attention"] = G * (P + new)
        _require(dcounts == per_step, (dcounts, per_step))
        gen = np.stack(generated[:new], axis=1)        # (B, new)
        _require(gen.shape == (Bd, new) and int(gen.min()) >= 0
                 and int(gen.max()) < cfg.vocab_size, gen.shape)
        for k, v in dcounts.items():
            res["launches"][k] += v
        prof = _profiled(one_step, ZAMBA["profile_steps"])
    gen_ms = sum(step_ms[P:])
    res["decode"] = {
        "batch": Bd, "slots": ZAMBA["slots"], "prompt": P, "new": new,
        "steps": P + new, "step_ms_p50": float(np.percentile(step_ms, 50)),
        "step_ms_p99": float(np.percentile(step_ms, 99)),
        "step_ms": step_ms, "generated_tokens_per_s": Bd * new / gen_ms * 1e3,
        "launches": dcounts, "first_row_tokens": gen[0].tolist(),
        "profile": prof}
    log(f"zamba decode: {res['decode']}")
    del params, state
    torch.cuda.empty_cache()
    res["check"] = zamba_checks()
    return res


def zamba_checks() -> dict:
    """zamba2-2.7b at full width with one group (6 mamba layers and one
    shared-block application) in fp32, weights made once on the CPU and
    copied to the card.  Card vs CPU: ``prefill_step`` logits at B 2, S 512
    (two SSD chunks, so the recurrence runs) and 8 greedy decode steps from
    ``init_cache``, identical tokens and logits within TOL_LM x max|logit|.
    Then, on the card, the 512 tokens through 512 decode steps (the
    recurrent ``mamba_decode`` and the decode kernel) against the full
    forward (the SSD and flash kernels) within TOL_DECODE_VS_FORWARD x
    max|logit|."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve.decode import prefill_step
    from repro_torch.tree import tree_map
    c = ZAMBA_CHECK
    cfg = _zamba_cfg(n_layers=c["layers"], dtype="float32")
    G = cfg.n_layers // cfg.attn_period
    cpu = serve.build_params(cfg, device="cpu")
    card = tree_map(lambda t: t.to(CARD), cpu)
    B, S = c["prefill"]
    toks = _tokens(2, B, S, cfg.vocab_size)
    runs = {}
    ops.reset_launches()
    for dev, p in ((CARD, card), ("cpu", cpu)):
        with torch.no_grad():
            lgs = [prefill_step(p, cfg, {"tokens": toks.to(dev)}).cpu()]
            cache = M.init_cache(p, cfg, B, 16)
            tok = toks[:, 0].to(dev)
            for t in range(c["steps"]):
                lg, cache = M.decode(p, cfg, tok, cache, t)
                lgs.append(lg.cpu())
                tok = torch.argmax(lg, -1).to(torch.int32)
        runs[dev] = lgs
    counts = dict(ops.LAUNCHES)
    _require(counts["ssd_intra_chunk"] == cfg.n_layers
             and counts["flash_attention"] == G
             and counts["decode_attention"] == G * c["steps"], counts)
    rel = []
    for got, want in zip(runs[CARD], runs["cpu"]):
        _require(bool(torch.isfinite(got).all()), "card logits not finite")
        _require(torch.equal(torch.argmax(got, -1), torch.argmax(want, -1)),
                 "card and cpu disagree on a greedy token")
        rel.append(float((got - want).abs().max() / want.abs().max()))
    log(f"zamba depth-{cfg.n_layers} card vs cpu logits, max|d| / "
        f"max|logit| (prefill, then each decode step): {rel}")
    _require(max(rel) <= TOL_LM, rel)
    del cpu

    ops.reset_launches()
    with torch.no_grad():
        tc = toks.to(CARD)
        full, _ = M.logits(card, cfg, {"tokens": tc})
        cache = M.init_cache(card, cfg, B, S)
        gap = torch.zeros((), device=CARD)
        agree = torch.zeros((), dtype=torch.int64, device=CARD)
        for t in range(S):
            lg, cache = M.decode(card, cfg, tc[:, t], cache, t)
            gap = torch.maximum(gap, (lg - full[:, t]).abs().max())
            agree += (lg.argmax(-1) == full[:, t].argmax(-1)).sum()
        dvf = float(gap) / float(full.abs().max())
    dvf_counts = dict(ops.LAUNCHES)
    _require(dvf_counts["ssd_intra_chunk"] == cfg.n_layers
             and dvf_counts["flash_attention"] == G
             and dvf_counts["decode_attention"] == G * S, dvf_counts)
    log(f"zamba depth-{cfg.n_layers} on the card, {S} decode steps vs the "
        f"forward: max|d| / max|logit| {dvf:.3e}; greedy tokens agree at "
        f"{int(agree)} of {B * S} positions")
    _require(dvf <= TOL_DECODE_VS_FORWARD, dvf)
    return {"layers": cfg.n_layers, "logit_rel_err": rel,
            "max_logit_rel_err": max(rel), "tokens_identical": True,
            "launches": counts, "decode_vs_forward_rel_err": dvf,
            "decode_vs_forward_token_agreement": int(agree) / (B * S),
            "decode_vs_forward_launches": dvf_counts}


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time-only", action="store_true",
                    help="build, then only phase 5's kernel timing; its "
                         "rows as one JSON line (to time two trees' "
                         "kernels in one call, each with this script)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card on this host; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    if args.time_only:
        phase_build()
        print(json.dumps({"timing": phase_time(), "device": _smi()}))
        return 0

    import time
    t0 = time.perf_counter()
    elapsed = {}

    def done(phase: str) -> None:
        elapsed[phase] = time.perf_counter() - t0
        log(f"--- {phase} done at {elapsed[phase]:.1f} s")

    phase_build()
    done("build")
    errs, wrappers = phase_check()
    done("check")
    serve = phase_serve()
    done("serve")
    train = phase_train()
    done("train")
    timing = phase_time()
    done("time")
    train_time = phase_train_time(train["card"])
    done("train_time")
    turns = phase_turns()
    done("turns")
    limit = phase_limit(train)
    done("limit")
    lm = phase_lm()
    done("lm")
    zamba = phase_zamba()
    done("zamba")

    csrc = "src/repro_torch/kernels/csrc/"
    srcs = {"lane_mlp_fwd": ("lane_mlp_fwd.cu", "lane_mlp.py:57"),
            "lane_mlp_bwd": ("lane_mlp_bwd.cu", "lane_mlp.py:72"),
            "int8_matmul": ("int8_matmul.cu", "int8_matmul.py:35"),
            "distill_fwd": ("distill_loss.cu", "distill_loss.py:31"),
            "distill_bwd": ("distill_loss.cu", "distill_loss.py:45"),
            "probe": ("probe.cu", "probe.py:35"),
            "flash_attention": ("flash_attention.cu",
                                "flash_attention.py:28"),
            "decode_attention": ("decode_attention.cu",
                                 "decode_attention.py:30"),
            "ssd_intra_chunk": ("ssd_chunk.cu", "ssd_chunk.py:24")}
    kernels = []
    for name in ops.LAUNCHES:
        t = timing[name]
        launches = (serve["launches"][name] + train["launches"][name]
                    + lm["launches"][name] + zamba["launches"][name])
        _require(launches > 0, f"{name} never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + srcs[name][0],
            "replaces": "src/repro/kernels/" + srcs[name][1],
            "launches": launches,
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if name == "lane_mlp_bwd":          # its check's bound is relative
            kernels[-1]["max_rel_err"] = errs["lane_mlp_bwd_rel"]
        if "attention" in name:             # fp32 above, bf16 here; bf16
            kernels[-1]["max_abs_err_bf16"] = errs[f"{name}/bfloat16"]
            kernels[-1]["bf16_bound_ratio"] = errs[   # vs fp32 plain, <= 1
                f"{name}/bf16_vs_f32_ratio"]
        if name == "ssd_intra_chunk":       # against the plain version on CPU
            kernels[-1]["max_abs_err_vs_cpu"] = errs["ssd_intra_chunk_vs_cpu"]
    smi = _smi()
    stream = {m: {k: serve[m][k] for k in ("rows_per_s", "latency_ms_p50",
                                           "latency_ms_p99")}
              for m in ("none", "int8")}
    log(f"stream (mimic3, {SCENARIO['requests']} requests): {stream}")
    log(f"lm ({LM['arch']}, bf16, {LM['requests']} requests): " + json.dumps(
        {k: lm["serve"][k] for k in ("tokens_per_s", "step_ms_p50",
                                     "step_ms_p99", "prefill_ms_p50")}
        | {"launches_per_decode_step": lm["launches_per_decode_step"],
           "prefill_step_ms": lm["prefill_step"]["ms"]}))
    log(f"zamba ({ZAMBA['arch']}, bf16): " + json.dumps(
        {"prefill_step_ms": zamba["prefill_step"]["ms"]}
        | {k: zamba["decode"][k] for k in (
            "step_ms_p50", "step_ms_p99", "generated_tokens_per_s")}
        | {k: zamba["check"][k] for k in ("max_logit_rel_err",
                                          "decode_vs_forward_rel_err")}))
    log("details: " + json.dumps({"timing": timing, "serve": serve,
                                  "train": train, "train_time": train_time,
                                  "turns": turns, "g3_limit": limit,
                                  "lm": lm, "zamba": zamba,
                                  "elapsed_s": elapsed,
                                  "wrappers": wrappers,
                                  "torch": torch.__version__,
                                  "cuda": torch.version.cuda}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    # the script drives one card, whatever the host has
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
