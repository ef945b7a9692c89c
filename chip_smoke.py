#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--time-only]

Phases, in order; any failure ends the run with a non-zero exit:

1. build  — compile every kernel from ``csrc/*.cu`` (one ``nvcc`` per
   source, all at once) and print ``-Xptxas -v``; decode attention's SASS
   (``cuobjdump -sass``) must show HMMA in every instantiation of its
   grouped route and none in its fp32 kernel.
2. check  — hold each kernel against its plain PyTorch version on the
   card: the lane-MLP forward at the three Table-3 encoder shapes x
   B in {16, 77, 256, 4096} within 1e-4 max-abs and the int8 matmul at the
   three quantized layers within 1e-5 (the reference's pinned bounds);
   the lane-MLP backward at the eight Table-3 autoencoder MLPs x
   B in {1, 77, 128, 2000} plus a three-lane stack with a dead lane within
   1e-5 relative; both also at phase 9's new widths (VFedTrans's extractor
   5 -> 256 -> 15 and back, the K = 3 passives' g1 5 -> 128 -> 256 and
   back, the K = 3 g2 640 -> 256 -> 256 and back), at phase 10's (the
   inversion attacker's MLP 256 -> 128 -> 25 with no final SELU, bcw's
   passive g1 25 -> 128 -> 256 and back, the K = 4 g2 896 -> 256 -> 256
   and back) and at SplitNN's two encoders with the final SELU; Eq. 5 (mse and mae, mask rows at 0 and 1) within 1e-5
   of max(|want|) where that lies below 1, else absolute (``_scalederr``):
   the forward's rows and mean forms, the backward for row cotangents, for
   the mean's cotangent, and with only the g3 step's gradients; the probe
   step (rows at weight 0) within 1e-4.  Then each training wrapper as the
   path calls it, on the card against itself on CPU copies at the same
   bounds: ``fused_mlp2`` (also at phase 9's widths, and SplitNN's encoders
   with the final SELU) and ``fused_lane_mlp2`` under autograd with and
   without an input gradient, ``fused_distill_rows``, ``fused_distill_loss``
   (all five gradients, and the g3 step's two) and ``probe_grad_step`` in
   both forms.  Then the
   flash-attention wrapper at eight (B, S, H, K, hd) shapes (zamba2's MHA
   at hd 80, ragged S at hd 32 and 64 and S 4096 among them), causal with
   window 0, 128 and 100 (inside a kv tile) and full, and the
   decode-attention wrapper at four GQA ratios (internlm2-1.8b's 2,
   zamba2's 1 at hd 80, 6 and 8; in bf16, G >= 4 takes the grouped
   route), W 64, 1000 and 1024 with empty slots,
   window 0 and 48, fp32 within 2e-5 and bf16 within 3e-2 (the
   reference's bounds), and with every slot empty (0); bf16 flash and
   decode also against their plain versions in fp32 on the same bf16
   inputs, within 5e-3 + 1e-2 |want| (TOL_FLASH_BF16_F32) and 1e-4 + 1e-2
   |want| (TOL_DECODE_BF16_F32).  Flash also with a key length of its own
   (FLASH_CROSS: the VLM's cross shape B 2, S 2048, T 1600, H 32, K 8, hd
   128, one text row against T 1600, and a ragged S 100 against T 37 at hd
   64, non-causal) and causal at the VLM's GQA 4; decode also at GQA 4 and
   over the VLM's image cache (W 1600, every slot valid).
   The lane-MLP pair also at phase 17's shapes: 16 lanes of 8,192 rows,
   16 -> 32 -> 64 and 64 -> 32 -> 16, which take the kernels' narrow
   route, the forward with and without ``save`` (and without it at the
   validation pass's 100,000 rows) within 1e-4, the backward within 1e-5
   relative.
   Then the SSD intra-chunk wrapper within 2e-4 (the reference's bound) at
   zamba2's width (B 2, S 512, H 80, N = P = 64, Lc 256), a ragged grouped
   chunk (S 100, H 6, G 2) and per-step log-decays down to -16, and its
   bf16 variant (``cfg.ssd_bf16``) against the plain bf16 route at zamba2's
   width and the ragged grouped chunk within TOL_SSD_BF16 x max|want|.
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
   the training batch (128), the lane-MLP pair also at phase 17's 16
   lanes of 8,192 rows, the lane-MLP forward and the int8 matmul also
   at bucket 16 (the serving stream's smallest), the forward also with
   training's saved pre-activations, Eq. 5 in the g3 step's forms and the
   rows form and as a whole step's loss, and an empty kernel (the launch
   floor); each stage's steps/s as phase 4's run timed it, and one more
   ``run_apcvfl`` epoch on the card with each stage's launches and device
   kernels per step and a profiler split, and Eq. 5's device kernels and
   time in a g3 step (the two Eq. 5 kernels, once each); then the served
   stream's rows/s, fp32, int8, int8, fp32 by warmed engines.
6. limit  — the readings that place TOL_LOSS_G3_LAST: the CPU's own spread
   between two orderings of the same math (closed-form backward vs
   autograd) must lie below it, and ``run_apcvfl`` on the card with a
   planted fault in the Eq. 5 backward kernel's dz (the distillation
   gradient scaled) must land above it.
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
   forward (1e-3 x max|logit|); that group's ``prefill_step`` with
   ``ssd_bf16`` (the SSD kernel's bf16 variant) against the CPU's plain bf16
   route within TOL_SSD_BF16 x max|logit|.  Phase 5 times the SSD kernel,
   and its bf16 variant, at the prefill's shape.
9. comparison — the paper's comparison on phase 4's scenario, 2 epochs a
   stage: ``run_splitnn``, ``run_vfedtrans`` and ``run_apcvfl(ablation=True,
   use_kernel=True)`` on the card and on the CPU at the same seed, held as
   phase 4 holds its run (epochs, rounds and comm equal, losses per epoch
   within TOL_LOSS, g3's last within TOL_LOSS_G3_LAST, metrics within
   0.03), FedSVD's U and S the same bits; ``serve_vfl.main --n-parties 3``
   (train, export, reload, serve) held the same way to ``run_apcvfl_k`` on
   the CPU (its g2's last epoch within TOL_LOSS_K3_G2_LAST, whose readings
   the phase takes: the CPU's own spread below it, two planted faults in
   the lane-MLP backward kernel above it); then on the card
   ``run_apcvfl_replicated`` and
   ``run_apcvfl_k_replicated`` over seeds 0 and 1, each seed held to the
   sequential run on the card at that seed (every epoch of every stage
   within TOL_LOSS).  Every run must launch both lane-MLP
   kernels, and every run that trains g3 both Eq. 5 kernels; a
   ``comparison (...)`` line gives each method's wall time, metrics and
   bytes.
10. experiments — the experiment driver, ``repro_torch.launch.experiment``:
   (a) ``--smoke`` on the card and with ``--device cpu``: every record has
   the reference's keys, rounds, bytes and epochs equal, each method held
   as phase 9 holds its runs; (b) ``bcw_fig5.json``, ``kparty_fig7.json``,
   ``serve_smoke.json`` and ``privacy_frontier.json`` as written (every
   record an accuracy in [0, 1] or a finite leakage, the int8 exchange at
   1 byte an element, ``serve_parity_max_abs`` <= 1e-4), both lane-MLP
   kernels launched; (c) ``reduced_alignment_fig8.json`` cut only in
   depth (seeds (0, 1), 2 epochs; the cut printed); (d) 2-seed groups of
   ``apcvfl`` and ``apcvfl_dp`` (sigma 0.5) replicated against
   sequential on the card, every epoch within TOL_LOSS, the dp lanes'
   received latents the same bits; (e) ``train_encoder_with_probe`` at
   mimic3's active features through g1_active's widths, 3 epochs, k 5,
   card against CPU (losses within TOL_LOSS, probe metrics within 0.03),
   and the same at g3's widths as a reading with the CPU's own spread.
   An ``experiments (...)`` line gives each spec's wall time and runs.

11. runtime — the live multi-tenant runtime (``serve/runtime.py``) on
   phase 3's bundle, tenants ``fp32`` and ``int8`` in one
   ``TenantRegistry``: (a) a Poisson stream of 2,000 requests a tenant
   (1-64 rows, half the ids known) at 300 req/s and a bursty one (4x the
   rate ON for 200 ms, a quarter OFF), SLO 100 ms, measured service
   times; rows/s, queue and service p50/p99, SLO attainment, shed rate,
   dispatches and mean batch rows per tenant; (b) ``verify_dispatch_
   parity``: every micro-batch bit-identical to a solo engine's on the
   card; (c) under a fixed service model, the card and the CPU give the
   same dispatch log (tenant, time, members) and shed set (an admission
   bound of 1,024 rows sheds part of the bursty stream), logits within
   TOL_ENGINE; (d) ``examples/faults/passive_dropout.json`` through
   ``serve_vfl.main --arrival poisson --fault``: 2 events applied, no
   collaborative dispatch while faulted, cache version 2, collaborative
   dispatches after the recovery.
12. lm_train — LM training (``train/loop.py``, ``launch/train.py``):
   (a) internlm2-1.8b at full width and depth in bf16, B 8, S 128, 20
   AdamW steps through ``launch/train.main``: every loss finite, the eval
   loss falls, the flash kernel launches once a layer in each no-grad
   eval pass and no kernel inside the steps (the training route); ms a
   step, tokens/s and peak memory; (b) fp32 copies at full width, card
   against CPU from the same weights: internlm2-1.8b at depth 2 (B 2, S 64,
   3 steps) and zamba2-2.7b at one group (6 mamba layers and the shared
   block; B 2, S 256, 2 steps), warmup_cosine; the first loss and grad
   norm within TOL_TRAIN_FIRST, each loss within TOL_TRAIN_LOSS, each
   param leaf within TOL_TRAIN_PARAMS (relative L2), and the trained
   params' eval pass (flash, and the SSD for zamba2, on the card) within
   TOL_TRAIN_LOSS; (c) the smoke configs, ``lm`` and ``apcvfl_distill``
   at one and two micro-batches, one step each, card against CPU.
13. moe_audio — the MoE decoder and the encoder-only audio stack: (a)
   qwen3-moe-30b-a3b at full width and depth in bf16 (56.9 GiB, drawn in
   slices on the card) through ``launch/serve.main --no-smoke`` (batch 8,
   1024 slots, prefill 128, 16 requests of 16-128 prompt tokens, 32 new
   each; exactly 48 flash launches a prefill and 48 decode launches a
   step): tokens/s, step p50/p99, peak memory, the init time; then
   ``prefill_step`` at B 2, S 2048 (C 320) and ten warm decode steps under
   the profiler, the card's time split into routing, dispatch and
   combine, the expert products, attention and the rest; (b) depth 2 in
   fp32, weights made once on the CPU: the engine's tokens identical,
   prefill and decode logits within TOL_LM, every layer's routes equal in
   every call (the same top-1, the same experts with the same slots, so
   the same dropped set); (c) on the card, ``capacity_factor = E / k``,
   16 decode steps against the full forward within
   TOL_DECODE_VS_FORWARD; (d) hubert-xlarge at full width and depth in
   bf16, ``M.logits`` on 4 x 1500 frames (48 non-causal flash launches a
   call), and at depth 2 in fp32 against the CPU within TOL_LM; (e)
   qwen3 at full width, depth 2, bf16 through ``launch/train.main
   --layers 2`` (20 steps: losses and aux finite, the eval loss falls, no
   kernel inside the steps), and one step of the qwen3, kimi-k2 and
   hubert (frame CE) smokes on the card against the CPU.
   Phase 2 also holds flash at qwen3's heads, (1, 128, 32, 4, 128) and
   (2, 2048, 32, 4, 128), and at hubert's, (4, 1500, 16, 16, 80), every
   mask; phase 5 times them and decode attention at qwen3's heads.
14. vlm — the VLM, every gate drawn nonzero from a seed (the schema's
   zeros would leave the cross blocks out) and the image embeddings normal
   from a seed: (a) llama-3.2-vision-11b at full width and depth in bf16
   (9,775,157,256 params), ``prefill_step`` at B 2, S 2048 against 1600
   image tokens (exactly 40 flash launches a call: 32 causal, 8 cross) and
   greedy decode through ``make_decode_step`` from
   ``M.init_cache(image_embeds=)`` at B 8 over 1024 slots, 16 prompt tokens
   fed through decode steps then 48 generated (exactly 40 decode launches a
   step: 32 self, 8 image), each with a profiled window; prefill ms, step
   p50/p99, tokens/s, peak memory, init seconds; (b) one group (4 self
   blocks + 1 cross block) at full width in fp32, weights made once on the
   CPU: ``prefill_step`` at B 2, S 128 and 8 decode steps give identical
   tokens on the card and the CPU, logits within TOL_LM x max|logit|, and
   the image zeroed moves the prefill's logits by more than 10 x TOL_LM;
   (c) on the card, 64 decode steps against the forward within
   TOL_DECODE_VS_FORWARD x max|logit|; (d) ``launch/train.main --layers 5``
   in bf16 (B 8, S 128, 20 steps: losses finite, the eval loss falls,
   flash only in the no-grad eval passes), then the smoke's one step on the
   card against the CPU with nonzero gates and images at phase 12's
   bounds.  Phase 5 times flash at the cross shape and at the VLM's causal
   self shape, and decode at G 4 over 1024 slots and over the image cache.
15. xlstm — the xLSTM (no kernel computes it: PyTorch ops on the card):
   (a) xlstm-350m at full width and depth in bf16 (518,686,888 params,
   the schema's init): ``prefill_step`` at B 2, S 2048, with the host wall
   split by block kind (mLSTM, sLSTM; each block synchronised), the card's
   span by block kind (CUDA events) and one call's device busy share
   (the profiler's raw events), then greedy decode through
   ``make_decode_step`` from ``init_cache`` at B 8 (16 prompt tokens fed
   through decode steps, then 48 generated), profiled; no kernel launches
   on either path; the same 64 tokens at full depth in fp32 (gates drawn
   away from their init from a seed, as in every check below) through
   decode steps against the forward, and ``prefill_step`` on the prompt
   against the forward at its last position, each within
   TOL_DECODE_VS_FORWARD x max|logit| (the bf16 forward's agreement with
   the bf16 decode's tokens is a reading only: in bf16 this random model
   moves by 0.264 x max|logit| between two chunkings of one prefix on the
   CPU, ``tools/xlstm_conditioning.py``);
   (b) one group (7 mLSTM + 1
   sLSTM blocks) at full width in fp32, weights made once on the CPU:
   ``prefill_step`` at B 2, S 512 and 8 decode steps give identical tokens
   on the card and the CPU, logits within TOL_LM x max|logit|, and 512
   decode steps against the forward on the card within
   TOL_DECODE_VS_FORWARD x max|logit|; (c) ``launch/train.main`` at full
   width and depth in bf16 (B 8, S 128, 20 steps: losses finite, the eval
   loss falls), then the smoke's one step on the card against the CPU
   with ``cfg.remat`` off and on at phase 12's bounds.
16. guards — ``repro_torch.analysis.guards`` on the card against
   ``ANALYSIS_budgets.json``: a warmed VFL dispatch (``predict_active``
   and the mixed ``predict`` on phase 3's bundle), one epoch of
   ``training.train`` through the lane-MLP kernels, one xLSTM decode step
   (one group at full width, bf16) and one warm dense-engine step
   (internlm2-1.8b at depth 2), each under ``no_host_sync``,
   ``compile_counter`` and ``cuda_sync_events``
   (``torch.cuda.set_sync_debug_mode``, each sync attributed to its op):
   one ``to_host`` copy a
   dispatch, an epoch and a decode step, as many device->host syncs, no
   compile; blocking host->device copies reported apart.
17. scale — lane meshes and the million-row workload (``data/scale.py``,
   ``train_lanes(mesh=, shard_rows=)``, ``launch/mesh.py``): (a) the
   reference's workload at its full size (``benchmarks/trainbench.py``'s
   ``run_scale`` defaults): 10^6 rows x 8 parties x 2 seeds = 16 lanes of
   16 features (1.024 GB), generated on ``cuda:0`` block by block (2^17
   rows), widths 16 -> 32 -> 64, trained through ``train_lanes(mesh=
   make_lane_mesh(lane=1))`` (a world of one) on the kernel loss at batch
   8,192, 2 epochs with patience 2, cold, warm and once under the
   profiler: generation seconds, cold and warm fit seconds, steps/s,
   rows/s, the card's busy share, the lane-MLP pair's device time and
   each kernel's time a launch, peak memory and the final mean train
   loss; the data on ``cuda:0``, a seed's parties correlated through
   their shared latents (another seed's not), the loss falling from epoch
   1 to 2, both lane-MLP kernels launched; (b) a cut (2 parties x 1 seed
   x 65,540 rows, generated on the CPU, moved to the card; one epoch):
   the card's fit held to the CPU's at phase 4's bounds (epochs and
   steps equal, every epoch's loss within TOL_LOSS); (c) two ranks
   spawned on the one card
   over gloo (``launch.mesh.run_ranks``): the cut at ``lane=2`` and at
   ``lane=1, data=2`` with ``shard_rows`` (each rank keeping 32,770 of a
   lane's rows), each rank's results held to (b)'s one-process card run
   at phase 4's bounds, whether they are the same bits reported.  A
   ``scale (...)`` line gives the numbers beside the card's name and
   power limit.

Launch counters are zeroed just before each run of a path (serve fp32,
serve int8, train, probe, lm, each zamba prefill and the zamba decode,
each card run of phase 9, phase 10's spec files, each runtime stream and
the fault run, each eval pass and the steps of phase 12, phase 13's
serve, ``prefill_step``, hubert's calls, eval passes and steps, phase
14's prefills, its decode, eval passes and steps, phase 15's prefills,
decode and checks, which must launch none, phase 17's first full-size
fit) and read
just after; every kernel must have launched on its path.  The last
lines are a ``details:`` line (every measurement as JSON), the ``kernels``
JSON, the card's name and power limit, and ``{"ok": true, "device":
...}``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
_T0 = time.perf_counter()
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_FP32_FLOPS = 67e12        # H100 SXM, fp32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12       # H100 SXM, bf16 dense tensor cores
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3
TOL_MLP = 1e-4                 # lane-MLP forward vs plain, max-abs
TOL_GRAD = 1e-5                # lane-MLP backward vs plain, relative
TOL_INT8 = 1e-5                # int8 matmul vs plain, max-abs
TOL_DISTILL = 1e-5             # Eq. 5 rows and gradients, _scalederr
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
# the K = 3 g2's last epoch, relative (phase 9): 640 inputs from three g1
# fits.  The CPU's own spread between two orderings of the same math
# reads ~1.2e-4 there, so TOL_LOSS cannot hold it; phase 9 shows in every
# run that the CPU's spread lies below this limit and that every fault of
# K3_G2_FAULTS lies above it.  Adam's update ignores a constant scale of
# any gradient coordinate, so a scaled gradient is no fault here: each of
# these changes the gradient's direction, in the backward kernel's output
# for the 640-wide MLP (g2's encoder)
TOL_LOSS_K3_G2_LAST = 5e-4


def _skip_last_k_tile(dx, dw0, db0, dw1, db1):
    dw0[..., -128:, :] = 0.0
    return dx, dw0, db0, dw1, db1


def _drop_db0(dx, dw0, db0, dw1, db1):
    db0.zero_()
    return dx, dw0, db0, dw1, db1


K3_G2_FAULTS = {"dW0's last 128 input rows zero (a k tile left out)":
                _skip_last_k_tile,
                "db0 zero (the hidden bias gradient dropped)": _drop_db0}
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
# the comparison's new MLP widths (phase 9), checked in phase 2 beside the
# Table-3 ones and timed nowhere: VFedTrans's extractor [5, 256, x_total]
# (x_total = 15 at mimic3), the K = 3 passives' g1 (5 features each) and
# the K = 3 g2 (128 + 2 x 256 = 640 inputs)
COMPARISON_SHAPES = {"vfedtrans.enc": (5, 256, 15),
                     "vfedtrans.dec": (15, 256, 5),
                     "g1_passive_k3.enc": (5, 128, 256),
                     "g1_passive_k3.dec": (256, 128, 5),
                     "g2_k3.enc": (640, 256, 256),
                     "g2_k3.dec": (256, 256, 640),
                     # phase 10's widths: the inversion attacker's MLP at
                     # bcw (256 -> 128 -> 25 passive features, no final
                     # SELU), bcw's passive g1 and the K = 4 g2
                     # (128 + 3 x 256 = 896 inputs) of kparty_fig7.json
                     "inverter.bcw": (256, 128, 25),
                     "g1_passive.bcw.enc": (25, 128, 256),
                     "g1_passive.bcw.dec": (256, 128, 25),
                     "g2_k4.enc": (896, 256, 256),
                     "g2_k4.dec": (256, 256, 896)}
# SplitNN's two party encoders: the g1 widths with a final SELU
SPLITNN_ENCODERS = {"splitnn.la": (5, 64, 128), "splitnn.lp": (10, 128, 256)}
BATCHES = (16, 77, 256, 4096)
BWD_BATCHES = (1, 77, 128, 2000)
TRAIN_B = 128                  # the paper's batch size
DISTILL = dict(D=5, M=256, lam=0.01)          # step 3 at mimic3 widths
VAL_ROWS = 2000                # the validation pass: a tenth of 20,000 rows
# which of Eq. 5's (x, x_hat, z, z_t, mask) a g3 step differentiates
G3_NEEDS = (False, True, True, False, False)
PROBE_FOLDS = 10
N_CLASSES = 4                  # mimic3
# the three layers of the int8 active path: (d, c, act)
INT8_LAYERS = {"l0_selu": (5, 256, "selu"), "l1": (256, 256, "none"),
               "head": (256, N_CLASSES, "none")}
BUCKET = 256
SCENARIO = dict(dataset="mimic3", active_features=5, aligned=10000,
                requests=2000, seed=0)
TRAIN = dict(epochs=2, requests=500)
# phase 9: the K of the K-party runs and the seeds of the replica runs
COMPARISON = dict(n_parties=3, seeds=(0, 1))
# phase 10: the experiment driver.  (b) runs these spec files as written;
# (c) runs EXPERIMENT_CUT's file cut only in depth (seeds and epochs)
EXPERIMENT_SPECS = ("bcw_fig5.json", "kparty_fig7.json", "serve_smoke.json",
                    "privacy_frontier.json")
EXPERIMENT_CUT = dict(spec="reduced_alignment_fig8.json", seeds=(0, 1),
                      max_epochs=2)
# (d): 2-seed groups, replicated against sequential on the card, on the
# privacy frontier's cell; (e): Appendix F's probe at mimic3's active
# features through the active party's local encoder (g1_active's Table-3
# widths), and a reading at g3's
EXPERIMENT_GROUP = dict(dataset="bcw", aligned=150, seeds=(0, 1),
                        max_epochs=8, sigma=0.5)
EXPERIMENT_PROBE = dict(epochs=3, k=5, role="g1_active")
TOL_SERVE_PARITY = 1e-4         # serve_smoke's serve_parity_max_abs
# a classification record's keys, the reference's ``RunResult.to_record``
# over ``classifier.f1_scores`` (tests/test_torch_experiments.py holds the
# port's records to the live reference's key for key)
RECORD_KEYS = ("method", "seed", "dataset", "n_aligned", "n_parties",
               "n_active_features", "accuracy", "f1_micro", "f1_macro",
               "f1_weighted", "f1_binary", "rounds", "comm_total_bytes",
               "comm_uplink_bytes", "comm_downlink_bytes", "comm_mb",
               "epochs_total", "z_dim")
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
                (2, 4096, 16, 8, 128), (1, 128, 32, 4, 128),
                (2, 2048, 32, 4, 128), (4, 1500, 16, 16, 80),
                (2, 2048, 32, 8, 128))
# (B, S, H, K, hd); (2, 2048, 32, 32, 80) is zamba2's shared block at
# prefill_step's size; (2, 4096, 16, 8, 128) is internlm2's heads at twice
# its length (causal, window); then qwen3-moe-30b-a3b's GQA (8 q heads a
# kv head) at the engine's prefill and at prefill_step's size, and
# hubert-xlarge's MHA over 30 s of frames (1500, not a multiple of the
# 64-key tile; the model runs it non-causal), and llama-3.2-vision-11b's
# self-attention (4 q heads a kv head) at prefill_step's size; a window of
# 100 ends inside a 64-key tile
FLASH_MASKS = ((True, 0), (True, 128), (True, 100), (False, 0))
# flash at a key length of its own (B, S, T, H, K, hd), non-causal: the VLM's
# cross-attention at prefill_step's size (2048 text rows against its 1600
# image tokens, GQA 4), one text row, and a ragged S 100 against T 37
FLASH_CROSS = ((2, 2048, 1600, 32, 8, 128), (2, 1, 1600, 32, 8, 128),
               (1, 100, 37, 4, 2, 64))
DECODE_W = (64, 1000, 1024)
# decode attention's (H, K, hd): internlm2-1.8b's GQA (2 q heads a kv
# head), zamba2's MHA, internlm2-20b's and nemotron-4-15b's 6, yi-6b's
# and qwen3-moe-30b-a3b's 8, llama-3.2-vision-11b's 4
DECODE_HEADS = ((16, 8, 128), (32, 32, 80), (48, 8, 128), (32, 4, 128),
                (32, 8, 128))
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
# the bf16 SSD (cfg.ssd_bf16) vs its plain bf16 version on the card, relative
# to max|y| (max|states|): the plain version's own gap to the reference's
# bf16 route reads 1.3e-3 and 1.9e-3 on the CPU (tests/test_torch_ssd.py).
# The bound is placed by the kernel's and the planted faults' readings in
# tools/ssd_planted_faults.py (the kernel well inside it, every fault far
# above); that tool also reads the fp32 kernel against the plain bf16
# version, finds it above the bound and so exits 1 at 5e-3: whether a bf16
# variant's bound should also hold the fp32 function is an open question.
# Phase 2 holds it in SSD_BF16_CASES, phase 8 holds zamba2's one-group bf16
# prefill to the CPU's plain route within it (x max|logit|)
TOL_SSD_BF16 = 5e-3
SSD_BF16_CASES = ("zamba2 width", "ragged grouped")
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
# phase 11: the live runtime on phase 3's bundle, two tenants (fp32, int8);
# (a) a Poisson and a bursty stream per tenant (the reference's burst
# defaults: 4x the rate ON for 200 ms, a quarter OFF for 200 ms); (c) the
# card against the CPU under a fixed service model, with an admission bound
# that sheds part of the bursty stream; (d) a fault plan through the CLI
RUNTIME = dict(requests=2000, rate_rps=300.0, max_rows=64, p_known=0.5,
               slo_ms=100.0)
RUNTIME_CHECK = dict(arrivals="bursty", queue_rows=1024,
                     service_ms=(2.0, 0.02))     # ms a dispatch + a row
RUNTIME_FAULT = dict(plan="passive_dropout.json", requests=500)
# phase 12: LM training.  (a) the full config at full width and depth in
# bf16 through launch/train; (b) depth-cut fp32 copies at full width, card
# against CPU, AdamW with warmup_cosine; (c) the smoke configs, one step of
# each objective and micro-batch count, card against CPU
LM_TRAIN = dict(arch="internlm2-1.8b", steps=20, batch=8, seq=128)
LM_TRAIN_CHECK = {
    "internlm2-1.8b": dict(layers=2, batch=2, seq=64, steps=3),
    "zamba2-2.7b": dict(layers=6, batch=2, seq=256, steps=2)}
LM_TRAIN_LR = (3e-4, 1, 3)       # warmup_cosine(peak, warmup, total)
TOL_TRAIN_LOSS = 1e-4            # card vs CPU loss a step, relative
TOL_TRAIN_FIRST = 1e-5           # the first step's loss and grad norm
TOL_TRAIN_PARAMS = 1e-4          # card vs CPU params, relative L2 a leaf
# a zero-initialised leaf (zamba2's conv_b) holds only the steps' updates,
# so Adam's sign-like steps on its noise-level gradient coordinates weigh on
# its norm: its bound is placed by the readings (b) takes in every run, the
# CPU's own spread below it and two planted faults above it
TOL_TRAIN_PARAMS_ZERO_INIT = 5e-4
LM_TRAIN_FAULTS = ("AdamW eps 1e-6", "mamba D's gradient dropped")
# phase 13: the MoE decoder and the encoder-only audio stack.  (a) the MoE
# serving cell: qwen3-moe-30b-a3b, full width and depth, bf16 (56.9 GiB)
MOE = dict(arch="qwen3-moe-30b-a3b", batch=8, slots=1024, prefill_len=128,
           requests=16, prompt=(16, 129), max_new=32)
MOE_PREFILL = (2, 2048)                 # prefill_step's (B, S): C = 320
# (b) card vs CPU at full width, fp32, depth 2 (7.4 GiB a copy)
MOE_CHECK = dict(layers=2, requests=8, slots=256, max_new=16, steps=8)
# (c) decode vs forward on the card, capacity_factor = E / k (no drops)
MOE_DECODE_VS_FORWARD = dict(batch=2, steps=16)
# (d) hubert-xlarge at full width and depth in bf16: 30 s of 50 Hz frames
# (1500 is not a multiple of the 64-key tile); depth 2 fp32 vs the CPU
HUBERT = dict(arch="hubert-xlarge", batch=4, frames=1500, check_layers=2,
              check_batch=2)
# (e) training: qwen3 at full width, depth 2, bf16 through launch/train;
# one step of each smoke config, card against CPU
MOE_TRAIN = dict(arch="qwen3-moe-30b-a3b", layers=2, steps=20, batch=8,
                 seq=128)
MOE_TRAIN_SMOKES = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "hubert-xlarge")
# phase 14: the VLM.  (a) llama-3.2-vision-11b at full width and depth in
# bf16 (19.55 GB): prefill_step at B 2, S 2048 against its 1600 image
# tokens; greedy decode at B 8 over 1024 slots, 16 prompt tokens fed
# through decode steps then 48 generated, ten steps profiled
VLM_IMAGE_TOKENS = 1600                 # the config's n_image_tokens
VLM = dict(arch="llama-3.2-vision-11b", prefill=(2, 2048), prefill_calls=2,
           batch=8, slots=1024, prompt=16, new=48, profile_steps=10)
# (b) one group (4 self blocks + 1 cross block) at full width in fp32, card
# against CPU; (c) decode against forward on the card at that group
VLM_CHECK = dict(layers=5, prefill=(2, 128), steps=8, dvf=(2, 64))
# (d) training at full width, one group, bf16 through launch/train
VLM_TRAIN = dict(layers=5, steps=20, batch=8, seq=128)
XLSTM = dict(arch="xlstm-350m", prefill=(2, 2048), prefill_calls=1,
             batch=8, slots=0, prompt=16, new=48, profile_steps=10)
XLSTM_PARAMS = 518_686_888
XLSTM_CHECK = dict(layers=8, prefill=(2, 512), steps=8)
XLSTM_TRAIN = dict(steps=20, batch=8, seq=128)

# phase 17: the reference's million-row workload at its full size
# (benchmarks/trainbench.py:27-29, run_scale's defaults)
SCALE = dict(rows=1_000_000, parties=8, seeds=(0, 1), features=16,
             widths=[16, 32, 64], block_rows=1 << 17, batch=8192, epochs=2,
             patience=2)
# the lane-MLP pair at its shapes: 16 lanes, the batch, encoder and decoder
SCALE_LANE_MLPS = {"scale.enc": (16, 32, 64), "scale.dec": (64, 32, 16)}
# (b), (c): a cut of it, generated on the CPU.  65,540 rows rather than
# 2^16: the data axis of 2 must divide the validation rows (6,554; 2^16
# gives 6,553) and the train rows for the rows to split at all
SCALE_CUT = dict(rows=65_540, parties=2, seeds=(0,), epochs=1)


def _elapsed() -> str:
    """Seconds since this module was imported."""
    return f"{time.perf_counter() - _T0:.1f}"


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


def _scalederr(a, b) -> float:
    """max|a - b| over max|b| where that lies below 1, else over 1: the
    absolute error of values of order one and the relative error of small
    ones (the mean form's gradients carry a factor 1/B), which an
    absolute bound would not see."""
    import torch
    tiny = torch.finfo(torch.float32).tiny
    scale = min(max(float(b.abs().max()), tiny), 1.0)
    return float((a - b).abs().max()) / scale


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
    # decode's grouped route (bf16, G >= 4) runs on the tensor cores; its
    # fp32 kernel keeps IEEE fp32 on the CUDA cores
    census = _build.sass_census("decode_attention", ("HMMA", "LDGSTS",
                                                     "LDSM"))
    log(f"decode_attention SASS, (HMMA, LDGSTS, LDSM) a function: "
        f"{ {f: tuple(c.values()) for f, c in census.items()} }")
    grouped = [c["HMMA"] for f, c in census.items()
               if "decode_kernel_grouped" in f]
    fp32 = [c["HMMA"] for f, c in census.items() if "decode_kernelIf" in f]
    _require(len(grouped) == 8 and min(grouped) > 0 and len(fp32) == 8
             and max(fp32) == 0, ("decode SASS", census))


def phase_check() -> dict:
    import torch
    from repro_torch.kernels import lane_mlp, ops, ref
    log("=== phase 2: kernels vs plain versions on the card ===")
    gen = torch.Generator().manual_seed(1)
    err = {"lane_mlp_fwd": 0.0, "int8_matmul": 0.0}
    for name, (din, h, dz) in (ENCODERS | COMPARISON_SHAPES
                               | SPLITNN_ENCODERS).items():
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
    check_scale_lane_mlp(gen, err)
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
    eight Table-3 MLPs and the comparison's six (``COMPARISON_SHAPES``)
    with x not requiring a gradient (the encoder case: the backward's
    null-dx branch) and requiring one (the decoder case), and at SplitNN's
    two encoders with the final SELU,
    ``fused_lane_mlp2`` with a dead lane, ``fused_distill_rows``'s
    ``(dx, -dx, dz, -dz, dmask)`` over rows and over a lane axis, and
    ``fused_distill_loss``'s with all five and with the g3 step's two, and
    ``probe_grad_step``'s weight normalisation and L2 term in the single
    and the fold-lane form that ``kfold_cv`` uses."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    err = {"mlp": 0.0, "distill": 0.0, "probe": 0.0}
    mlps = [(name, shp, need_dx, False)
            for name, shp in (AE_SHAPES | COMPARISON_SHAPES).items()
            for need_dx in (False, True)]
    mlps += [(name, shp, False, True)          # as SplitNN's encoders run
             for name, shp in SPLITNN_ENCODERS.items()]
    for name, (din, h, dz), need_dx, fa in mlps:
        for B in (77, TRAIN_B):
            args = _mlp_inputs(gen, B, din, h, dz)
            got, want = _card_vs_cpu(
                lambda *a: ops.fused_mlp2(*a, final_act=fa), args,
                (need_dx, True, True, True, True), gen)
            e = max(_relerr(a, b) for a, b in zip(got, want))
            _require(len(got) == 5 + need_dx and e <= TOL_GRAD,
                     (name, B, need_dx, fa, e))
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
            for fn, grad_of in (
                    (ops.fused_distill_rows, (True,) * 5),
                    (ops.fused_distill_loss, (True,) * 5),
                    (ops.fused_distill_loss, G3_NEEDS)):
                got, want = _card_vs_cpu(
                    lambda *a: fn(*a, lam=0.3, kind=kind), args, grad_of,
                    gen)
                e = max(_scalederr(a, b) for a, b in zip(got, want))
                _require(len(got) == 1 + sum(grad_of) and e <= TOL_DISTILL,
                         (fn.__name__, kind, lead, grad_of, e))
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


def distill_errors(gen) -> list:
    """``(kind, B, forward error, backward error, their max-abs errors)``
    of the Eq. 5 kernels against their plain versions (the first two
    ``_scalederr``, which phase 2 bounds) at step 3's widths: both
    forward forms, and the backward for row cotangents with every
    gradient, for the mean's cotangent with every gradient and with the g3
    step's (x_hat, z) only."""
    import torch
    from repro_torch.kernels import distill_loss, ref
    out = []
    for kind in ("mse", "mae"):
        for B in (1, 77, TRAIN_B, 2000):
            args = _distill_inputs(gen, B, DISTILL["D"], DISTILL["M"])
            kw = dict(lam=0.3, kind=kind)
            want = ref.distill_rows_ref(*args, **kw)
            rows, mean = distill_loss.launch_fwd(*args, mean_of=B, **kw)
            pairs = [(distill_loss.launch_fwd(*args, **kw), want),
                     (rows, want), (mean, torch.mean(want).reshape(1))]
            e = max(_scalederr(u, v) for u, v in pairs)
            a = max(_maxerr(u, v) for u, v in pairs)
            e2 = a2 = 0.0
            for g, mean_of, needs in ((_rand(gen, (B,)), 0, (True,) * 5),
                                      (_rand(gen, (1,)), B, (True,) * 5),
                                      (torch.ones(1).cuda(), B, G3_NEEDS)):
                got = distill_loss.launch_bwd(g, *args, mean_of=mean_of,
                                              needs=needs, **kw)
                want_g = ref.distill_bwd_ref(g, *args, mean_of=mean_of,
                                             needs=needs, **kw)
                _require(all((a is None) == (not n)
                             for a, n in zip(got, needs)), needs)
                pairs = [(u, v) for u, v in zip(got, want_g)
                         if u is not None]
                e2 = max([e2] + [_scalederr(u, v) for u, v in pairs])
                a2 = max([a2] + [_maxerr(u, v) for u, v in pairs])
            torch.cuda.synchronize()
            out.append((kind, B, e, e2, a, a2))
    return out


def check_training_kernels(gen, err: dict) -> None:
    """The lane-MLP backward, the Eq. 5 rows and the probe step against
    their plain versions (part of phase 2)."""
    import torch
    from repro_torch.kernels import lane_mlp, probe, ref
    err.update(lane_mlp_bwd=0.0, lane_mlp_bwd_rel=0.0, distill_fwd=0.0,
               distill_bwd=0.0, probe=0.0)
    cases = [(name, shp, B, 1, B == 77)
             for name, shp in (AE_SHAPES | COMPARISON_SHAPES).items()
             for B in BWD_BATCHES]
    cases += [(name, shp, B, 1, True) for name, shp in SPLITNN_ENCODERS.items()
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
    for kind, B, e, e2, a, a2 in distill_errors(gen):
        log(f"distill {kind} B={B}: fwd (rows, mean) scaled err {e:.3e}, "
            f"bwd (rows, mean, g3 gradients) {e2:.3e}; max|err| {a:.3e}, "
            f"{a2:.3e}")
        _require(e <= TOL_DISTILL and e2 <= TOL_DISTILL, (kind, B, e, e2))
        err["distill_fwd"] = max(err["distill_fwd"], a)
        err["distill_bwd"] = max(err["distill_bwd"], a2)
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


def check_scale_lane_mlp(gen, err: dict) -> None:
    """The lane-MLP pair at phase 17's shapes (part of phase 2): 16 lanes,
    the scale encoder 16 -> 32 -> 64 and its decoder 64 -> 32 -> 16.  The
    forward at the batch's 8,192 rows with and without ``save``, and
    without it at the whole validation set's rows (each epoch's
    validation pass), within TOL_MLP of ``ref.mlp2_fwd_ref``; the backward
    (dW summing 8,192 rows) within TOL_GRAD relative."""
    import inspect
    import torch
    from repro_torch.core import training
    from repro_torch.kernels import lane_mlp, ref
    L, B = len(SCALE["seeds"]) * SCALE["parties"], SCALE["batch"]
    val_frac = inspect.signature(training.train_lanes).parameters[
        "val_frac"].default
    n_val = max(int(SCALE["rows"] * val_frac), 1)
    for name, (din, h, dz) in SCALE_LANE_MLPS.items():
        _require(lane_mlp.route(din, h, dz) == "narrow",
                 (name, lane_mlp.route(din, h, dz)))
        stacks = {}
        for rows, saves in ((B, (False, True)), (n_val, (False,))):
            stacks[rows] = stack = [torch.stack(t) for t in zip(*[
                _mlp_inputs(gen, rows, din, h, dz) for _ in range(L)])]
            out_ref, a1_ref, a2_ref = ref.mlp2_fwd_ref(*stack)
            for save in saves:
                got = lane_mlp.launch(*stack, save=save)
                pairs = [("out", got, out_ref)] if not save else [
                    ("out", got[0], out_ref), ("a1", got[1], a1_ref),
                    ("a2", got[2], a2_ref)]
                torch.cuda.synchronize()
                for what, a, b in pairs:
                    e = _maxerr(a, b)
                    log(f"lane_mlp_fwd {name} L={L} B={rows} save={save} "
                        f"{what}: max|err| {e:.3e}")
                    _require(e <= TOL_MLP, (name, rows, save, what, e))
                    err["lane_mlp_fwd"] = max(err["lane_mlp_fwd"], e)
            del out_ref, a1_ref, a2_ref
        xs, w0s, b0s, w1s, b1s = stack = stacks.pop(B)
        del stacks
        _, a1, a2 = lane_mlp.launch(*stack, save=True)
        g = _rand(gen, (L, B, dz))
        got = lane_mlp.launch_bwd(g, xs, a1, a2, w0s, w1s, final_act=False)
        want = ref.mlp2_bwd_ref(g, xs, a1, a2, w0s, w1s, False)
        torch.cuda.synchronize()
        e = max(_relerr(a, b) for a, b in zip(got, want))
        e_abs = max(_maxerr(a, b) for a, b in zip(got, want))
        log(f"lane_mlp_bwd {name} L={L} B={B}: rel err {e:.3e}, "
            f"max|err| {e_abs:.3e}")
        _require(e <= TOL_GRAD, (name, B, e))
        err["lane_mlp_bwd_rel"] = max(err["lane_mlp_bwd_rel"], e)
        err["lane_mlp_bwd"] = max(err["lane_mlp_bwd"], e_abs)


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
        for B, S, T, H, K, hd in FLASH_CROSS:
            q = _rand(gen, (B, S, H, hd)).to(dt)
            k, v = (_rand(gen, (B, T, K, hd)).to(dt) for _ in range(2))
            got = ops.flash_attention(q, k, v, causal=False)
            calls["flash_attention"] += 1
            want = ref.flash_attention_model(q, k, v, causal=False)
            torch.cuda.synchronize()
            e = _maxerr(got.float(), want.float())
            what = f"B={B} S={S} T={T} H={H} K={K} hd={hd}"
            line = f"flash_attention {dname} {what} (keys of their own): " \
                   f"max|err| {e:.3e}"
            _require(got.dtype == dt and tuple(got.shape) == (B, S, H, hd)
                     and _within(got.float(), want.float(), TOL_ATTN[dname]),
                     ("flash cross", dname, what, e))
            key = f"flash_attention/{dname}"
            err[key] = max(err[key], e)
            if dt == torch.bfloat16:
                want = ref.flash_attention_model(q.float(), k.float(),
                                                 v.float(), causal=False)
                r = bound_ratio(got.float(), want, *TOL_FLASH_BF16_F32)
                line += f", bound ratio vs fp32 plain {r:.3f}"
                _require(r <= 1.0, ("flash cross bf16 vs fp32", what, r))
                err[ratio_key] = max(err[ratio_key], r)
            log(line)
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
        # the VLM's image cache: one row against its 1600 image tokens at G 4,
        # every slot valid, as decode_cross_attention reads it
        W = VLM_IMAGE_TOKENS
        q = _rand(gen, (B, 32, 128)).to(dt)
        kc, vc = (_rand(gen, (B, W, 8, 128)).to(dt) for _ in range(2))
        sp = torch.arange(W, dtype=torch.int32, device="cuda")
        got = ops.decode_attention(q, kc, vc, sp, W - 1)
        calls["decode_attention"] += 1
        want = ref.decode_attention_cache(q, kc, vc, sp, W - 1)
        torch.cuda.synchronize()
        e = _maxerr(got.float(), want.float())
        line = f"decode_attention {dname} B={B} H=32 K=8 hd=128 W={W} " \
               f"every slot valid (the image cache): max|err| {e:.3e}"
        _require(_within(got.float(), want.float(), TOL_ATTN[dname]),
                 ("decode image cache", dname, e))
        err[f"decode_attention/{dname}"] = max(
            err[f"decode_attention/{dname}"], e)
        if dt == torch.bfloat16:
            want = ref.decode_attention_cache(q.float(), kc.float(),
                                              vc.float(), sp, W - 1)
            r = bound_ratio(got.float(), want, *TOL_DECODE_BF16_F32)
            line += f", bound ratio vs fp32 plain {r:.3f}"
            _require(r <= 1.0, ("decode image cache bf16 vs fp32", r))
            err[dratio_key] = max(err[dratio_key], r)
        log(line)
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
    # the bf16 variant (cfg.ssd_bf16) against the plain bf16 route on the
    # same card tensors, relative to max|y| and max|states|
    err["ssd_intra_chunk_bf16_rel"] = 0.0
    for name in SSD_BF16_CASES:
        B, S, H, G, N, P, Lc, steep = SSD_CASES[name]
        args = _ssd_inputs(gen, B, S, H, G, N, P, steep)
        got = ops.ssd_intra_chunk(*args, Lc, bf16=True)
        want = ref.ssd_intra_chunk_ref(*args, Lc, bf16=True)
        f32 = ref.ssd_intra_chunk_ref(*args, Lc)
        torch.cuda.synchronize()
        rel = max(_maxerr(g, w) / float(w.abs().max())
                  for g, w in zip(got, want))
        rel_f32 = max(_maxerr(g, w) / float(w.abs().max())
                      for g, w in zip(f32, want))
        log(f"ssd_intra_chunk bf16 {name} B={B} S={S} H={H} G={G} N={N} "
            f"P={P} Lc={Lc}: max|err| / max|want| {rel:.3e} (bound "
            f"{TOL_SSD_BF16:g}; the fp32 route's gap to it {rel_f32:.3e})")
        _require(rel <= TOL_SSD_BF16, ("ssd bf16", name, rel))
        err["ssd_intra_chunk_bf16_rel"] = max(err["ssd_intra_chunk_bf16_rel"],
                                              rel)
    counts = dict(ops.LAUNCHES)
    _require(counts["ssd_intra_chunk"] == len(SSD_CASES)
             + len(SSD_BF16_CASES), counts)


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


# the last-epoch limits of a card run held to the CPU: g3's (phase 6) and,
# where a stage is named, that stage's (phase 9)
CARD_VS_CPU_LAST = {"g3": TOL_LOSS_G3_LAST}


def _losses_agree(loss_err: dict, last: dict = CARD_VS_CPU_LAST) -> bool:
    """Every epoch within TOL_LOSS, and the last epoch of each stage in
    ``last`` within its limit there (TOL_LOSS for the other stages)."""
    return all(max(errs[:-1], default=0.0) <= TOL_LOSS
               and errs[-1] <= last.get(stage, TOL_LOSS)
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
    t0 = time.perf_counter()
    m_kernel = clf.kfold_cv(z_all, sc.active.y, sc.n_classes,
                            use_kernel=True, device="cuda")
    torch.cuda.synchronize()
    kfold_s = {"kernel": time.perf_counter() - t0}
    probe_counts = dict(ops.LAUNCHES)
    _require(probe_counts["probe"] > 0, "probe kernel never ran")
    t0 = time.perf_counter()
    m_plain = clf.kfold_cv(z_all, sc.active.y, sc.n_classes, device="cuda")
    torch.cuda.synchronize()
    kfold_s["plain"] = time.perf_counter() - t0
    probe_gap = {k: abs(m_kernel[k] - m_plain[k]) for k in m_plain}
    _require(max(probe_gap.values()) < TOL_METRIC, probe_gap)
    _require(all(0.0 <= v <= 1.0 for v in m_kernel.values()), m_kernel)
    log(f"kfold_cv with the probe kernel: {m_kernel} (launches "
        f"{probe_counts['probe']}), gap to plain {probe_gap}")
    log(f"kfold_cv wall (host clock, synchronised): probe kernel "
        f"{kfold_s['kernel']:.4f} s, plain probe {kfold_s['plain']:.4f} s")
    return {"launches": {k: train_counts[k] + probe_counts[k]
                         for k in train_counts},
            "train_launches": train_counts, "probe_launches": probe_counts,
            "card": card, "cpu_train_loss": cpu.train_loss,
            "cpu_seconds": cpu_s,
            "cpu_metrics": cpu.metrics, "loss_rel_err": loss_err,
            "metric_gap": metric_gap, "kfold_kernel": m_kernel,
            "kfold_plain": m_plain, "probe_metric_gap": probe_gap,
            "kfold_wall_s": kfold_s,
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
    sets.update(_scale_kernel_sets(gen))
    sets.update(_launch_floor_set())
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


def _library_mlp_bwd_lanes(g, x, a1, a2, w0, w1):
    """``_library_mlp_bwd`` over a lane stack: ``bmm`` in place of ``mm``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import SELU_ALPHA, SELU_SCALE
    dw1 = torch.bmm(F.selu(a1).transpose(1, 2), g)
    g1 = torch.ops.aten.elu_backward(torch.bmm(g, w1.transpose(1, 2)),
                                     SELU_ALPHA, SELU_SCALE, 1.0, False, a1)
    return (torch.bmm(g1, w0.transpose(1, 2)),
            torch.bmm(x.transpose(1, 2), g1), g1.sum(1), dw1, g.sum(1))


def _bwd_bytes(B, din, h, dz, final_act=False) -> float:
    """Bytes a lane of the lane-MLP backward must move: g, x, a1 and the
    weights in (a2 only with ``final_act``, which the timed calls and
    training leave off), dx and the weight gradients out."""
    return 4.0 * (B * ((2 if final_act else 1) * dz + din + h) + din * h
                  + h * dz                                           # in
                  + B * din + din * h + h + h * dz + dz)             # out


def _scale_kernel_sets(gen) -> dict:
    """Timing sets of the lane-MLP pair at phase 17's shapes: 16 lanes of
    8,192 rows through the scale encoder and its decoder, the forward as
    training launches it (``save``), the backward; the library calls are
    ``baddbmm``, ``F.selu``, ``baddbmm`` and the ``bmm`` backward.  These
    shapes take the kernels' narrow route."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import lane_mlp, ref
    L, B = len(SCALE["seeds"]) * SCALE["parties"], SCALE["batch"]
    fwd, bwd = [], []
    for name, (din, h, dz) in SCALE_LANE_MLPS.items():
        s = [torch.stack(t) for t in zip(*[_mlp_inputs(gen, B, din, h, dz)
                                           for _ in range(L)])]
        fwd.append(dict(
            shape=f"{name} {din}->{h}->{dz} L={L} B={B} save", iters=10,
            flops=2.0 * L * B * (din * h + h * dz),
            bytes=4.0 * L * (B * din + din * h + h + h * dz + dz + B * dz
                             + B * (h + dz)),
            kernel=lambda s=s: lane_mlp.launch(*s, save=True),
            plain=lambda s=s: ref.mlp2_fwd_ref(*s),
            library=lambda s=s: torch.baddbmm(
                s[4][:, None], F.selu(torch.baddbmm(s[2][:, None], s[0],
                                                    s[1])), s[3])))
        a = _bwd_inputs(gen, B, din, h, dz, lanes=L)
        bwd.append(dict(
            shape=f"{name} {din}->{h}->{dz} L={L} B={B}", iters=10,
            flops=4.0 * L * B * (din * h + h * dz),
            bytes=L * _bwd_bytes(B, din, h, dz),
            kernel=lambda a=a: lane_mlp.launch_bwd(*a),
            plain=lambda a=a: ref.mlp2_bwd_ref(*a),
            library=lambda a=a: _library_mlp_bwd_lanes(*a)))
    return {"lane_mlp_fwd_scale": fwd, "lane_mlp_bwd_scale": bwd}


def _training_kernel_sets(gen) -> dict:
    """Timing sets of the training kernels at the shapes the training
    path gives them: the lane-MLP backward of each Table-3 MLP at the
    batch of 128, step 3's Eq. 5 (``_distill_sets``), and one probe step
    of the 10 fold lanes over mimic3's active rows."""
    from repro_torch.kernels import lane_mlp, probe, ref
    B = TRAIN_B
    sets = {"lane_mlp_bwd": []}
    for name, (din, h, dz) in AE_SHAPES.items():
        a = _bwd_inputs(gen, B, din, h, dz)
        flops = 4.0 * B * (din * h + h * dz)
        sets["lane_mlp_bwd"].append(dict(
            shape=f"{name} {din}->{h}->{dz} B={B}", flops=flops,
            bytes=_bwd_bytes(B, din, h, dz),
            kernel=lambda a=a: lane_mlp.launch_bwd(*a),
            plain=lambda a=a: ref.mlp2_bwd_ref(*a),
            library=lambda a=tuple(t[0] for t in a): _library_mlp_bwd(*a)))
    sets.update(_distill_sets(gen, B))
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


def _eq5_step(args, lam: float):
    """Eq. 5 forward and backward as a g3 step runs it: the loss through
    ``ops.fused_distill_loss``, then the gradients of x_hat and z for a
    loss cotangent of 1."""
    import torch
    from repro_torch.kernels import ops
    x, xh, z, zt, mask = args
    xh, z = xh.detach().requires_grad_(True), z.detach().requires_grad_(True)
    one = torch.ones((), device=x.device)
    return lambda: torch.autograd.grad(
        ops.fused_distill_loss(x, xh, z, zt, mask, lam=lam), [xh, z], one)


def _distill_sets(gen, B: int) -> dict:
    """Timing items of Eq. 5 at step 3's batch: the forward and backward
    as a g3 step launches them (the mean form; the mean's cotangent with
    only x_hat's and z's gradients) and in the rows form with the TPU
    kernel's outputs (dx, dz, dmask), then the whole loss of a step
    (``_eq5_step``); and the mean form at the validation pass's
    ``VAL_ROWS``, which sums on a cooperative grid where the batch sums on
    one cluster."""
    import torch
    from repro_torch.kernels import distill_loss, ref
    D, M, lam = DISTILL["D"], DISTILL["M"], DISTILL["lam"]
    args = _distill_inputs(gen, B, D, M)
    g = _rand(gen, (B,))
    kw = dict(lam=lam, kind="mse")
    shape = f"step 3 B={B} D={D} M={M} mse"
    fwd = dict(flops=3.0 * B * (D + M + 1),
               bytes=4.0 * (2 * B * D + 2 * B * M + 2 * B))
    bwd = dict(flops=B * (3.0 * D + 4.0 * M + 5),
               bytes=4.0 * (3 * B + 3 * B * D + 3 * B * M))
    rows = {
        "fwd": [dict(shape=shape + " rows", **fwd,
                     kernel=lambda: distill_loss.launch_fwd(*args, **kw),
                     plain=lambda: ref.distill_rows_ref(*args, **kw),
                     library=None)],
        "bwd": [dict(shape=shape + " rows, dx dz dmask", **bwd,
                     kernel=lambda: distill_loss.launch_bwd(g, *args, **kw),
                     plain=lambda: ref.distill_rows_bwd_ref(g, *args, **kw),
                     library=None)]}
    fwd_mean = dict(flops=fwd["flops"] + B, bytes=fwd["bytes"] + 4.0)
    bwd_g3 = dict(flops=B * (2.0 * D + 4.0 * M + 3),
                  bytes=4.0 * (1 + 2 * B * D + 2 * B * M + B + B * D + B * M))

    def plain_step():
        rows_p = ref.distill_rows_ref(*args, **kw)
        gr = torch.full((B,), 1.0 / B, device=rows_p.device)
        dx, dz, _ = ref.distill_rows_bwd_ref(gr, *args, **kw)
        return torch.mean(rows_p), -dx, dz
    step = [dict(shape=shape + " mean, d x_hat and dz",
                 flops=fwd_mean["flops"] + bwd_g3["flops"],
                 bytes=fwd_mean["bytes"] + bwd_g3["bytes"],
                 kernel=_eq5_step(args, lam), plain=plain_step, library=None)]
    one = torch.ones(1, device=g.device)
    val = _distill_inputs(gen, VAL_ROWS, D, M)
    return {
        "distill_fwd": [dict(
            shape=shape + " mean", **fwd_mean,
            kernel=lambda: distill_loss.launch_fwd(*args, mean_of=B, **kw),
            plain=lambda: torch.mean(ref.distill_rows_ref(*args, **kw)),
            library=None)],
        "distill_bwd": [dict(
            shape=shape + " mean, d x_hat and dz", **bwd_g3,
            kernel=lambda: distill_loss.launch_bwd(
                one, *args, mean_of=B, needs=G3_NEEDS, **kw),
            plain=lambda: ref.distill_bwd_ref(one, *args, mean_of=B,
                                              needs=G3_NEEDS, **kw),
            library=None)],
        "distill_fwd_validation": [dict(
            shape=f"validation N={VAL_ROWS} D={D} M={M} mse mean",
            flops=3.0 * VAL_ROWS * (D + M + 1) + VAL_ROWS,
            bytes=4.0 * (2 * VAL_ROWS * (D + M) + 2 * VAL_ROWS + 1),
            kernel=lambda: distill_loss.launch_fwd(*val, mean_of=VAL_ROWS,
                                                   **kw),
            plain=lambda: torch.mean(ref.distill_rows_ref(*val, **kw)),
            library=None)],
        "distill_fwd_rows": rows["fwd"], "distill_bwd_rows": rows["bwd"],
        "eq5_step": step}


def _launch_floor_set() -> dict:
    """An empty kernel (``csrc/launch_floor.cu``) timed as every row is:
    what one launch costs in a CUDA-graph replay, the floor under every
    kernel whose bound is smaller."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    lib = _build.library("launch_floor")
    lib.launch_floor.argtypes = [ctypes.c_void_p]
    lib.launch_floor.restype = ctypes.c_int

    def launch():
        rc = lib.launch_floor(torch.cuda.current_stream().cuda_stream)
        _require(rc == 0, f"launch_floor: CUDA error {rc}")
    return {"launch_floor": [dict(shape="empty kernel, 1 block of 32",
                                  flops=0.0, bytes=0.0, kernel=launch,
                                  plain=launch, library=None)]}


def _attention_kernel_sets(gen) -> dict:
    """Timing sets of the attention kernels in bf16 at the LM cells'
    shapes (internlm2-1.8b: H 16, K 8, hd 128; the VLM's H 32, K 8 and its
    cross shape, 2048 text rows against 1600 image tokens, where the
    library call is SDPA with GQA and no mask): flash attention at
    ``prefill_step``'s B 2, S 2048 (causal) and, apart, at the engine's
    one-prompt prefill (B 1, S 128), at zamba2's shared block in its
    ``prefill_step`` (B 2, S 2048, H = K = 32, hd 80), at qwen3-moe's
    heads (H 32, K 4, hd 128) at both, and non-causal at hubert's (B 4, S
    1500, H = K = 16, hd 80); decode attention at the engine's batch of 8
    against its 1024-slot cache with slots 0..511 written, and apart at
    zamba2's heads (H = K = 32, hd 80) and qwen3-moe's.  Operations count
    the pairs the mask keeps; bytes count q, k, v and out once (for
    decode, the written slots' K/V rows)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    bf16 = torch.bfloat16
    sets = {}
    for key, (B, S), (H, K, hd), causal in (
            ("flash_attention", LM_PREFILL, (16, 8, 128), True),
            ("flash_attention_engine_prefill", (1, LM["prefill_len"]),
             (16, 8, 128), True),
            ("flash_attention_zamba2_prefill", ZAMBA["prefill"],
             (32, 32, 80), True),
            ("flash_attention_qwen3_prefill", MOE_PREFILL, (32, 4, 128),
             True),
            ("flash_attention_qwen3_engine_prefill",
             (1, MOE["prefill_len"]), (32, 4, 128), True),
            ("flash_attention_hubert", (HUBERT["batch"], HUBERT["frames"]),
             (16, 16, 80), False),
            ("flash_attention_vlm_prefill", VLM["prefill"], (32, 8, 128),
             True)):
        q = _rand(gen, (B, S, H, hd)).to(bf16)
        k, v = (_rand(gen, (B, S, K, hd)).to(bf16) for _ in range(2))
        pairs = S * (S + 1) / 2 if causal else S * S
        sets[key] = [dict(
            shape=f"B={B} S={S} H={H} K={K} hd={hd} "
                  f"{'causal' if causal else 'full'} bf16",
            flops=4.0 * B * H * hd * pairs,
            bytes=2.0 * (2 * B * S * H * hd + 2 * B * S * K * hd),
            peak=PEAK_BF16_FLOPS, iters=10,
            kernel=lambda a=(q, k, v), c=causal: ops.flash_attention(
                *a, causal=c),
            plain=lambda a=(q, k, v), c=causal: ref.flash_attention_model(
                *a, causal=c),
            library=lambda a=(q, k, v), c=causal:
                F.scaled_dot_product_attention(
                    *(t.transpose(1, 2) for t in a), is_causal=c,
                    enable_gqa=True))]
    # the VLM's cross-attention at prefill_step's size: 2048 text rows
    # against the 1600 image tokens, no mask
    (B, S), T, (H, K, hd) = VLM["prefill"], VLM_IMAGE_TOKENS, (32, 8, 128)
    q = _rand(gen, (B, S, H, hd)).to(bf16)
    k, v = (_rand(gen, (B, T, K, hd)).to(bf16) for _ in range(2))
    sets["flash_attention_vlm_cross"] = [dict(
        shape=f"B={B} S={S} T={T} H={H} K={K} hd={hd} full bf16",
        flops=4.0 * B * H * hd * S * T,
        bytes=2.0 * (2 * B * S * H * hd + 2 * B * T * K * hd),
        peak=PEAK_BF16_FLOPS, iters=10,
        kernel=lambda a=(q, k, v): ops.flash_attention(*a, causal=False),
        plain=lambda a=(q, k, v): ref.flash_attention_model(*a,
                                                            causal=False),
        library=lambda a=(q, k, v): F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in a), enable_gqa=True))]
    B, W, pos = LM["batch"], LM["slots"], LM["slots"] // 2 - 1
    sp = torch.where(torch.arange(W) <= pos, torch.arange(W), -1).to(
        torch.int32).cuda()
    valid = int((sp >= 0).sum())
    mask = (sp >= 0) & (sp <= pos)
    for key, (H, K, hd) in (("decode_attention", (16, 8, 128)),
                            ("decode_attention_zamba2", (32, 32, 80)),
                            ("decode_attention_qwen3", (32, 4, 128)),
                            ("decode_attention_vlm", (32, 8, 128))):
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
    # one decode row against the VLM's image K/V: 1600 slots, all valid
    W, (H, K, hd) = VLM_IMAGE_TOKENS, (32, 8, 128)
    spi = torch.arange(W, dtype=torch.int32, device="cuda")
    q = _rand(gen, (B, H, hd)).to(bf16)
    kc, vc = (_rand(gen, (B, W, K, hd)).to(bf16) for _ in range(2))
    sets["decode_attention_vlm_image"] = [dict(
        shape=f"B={B} W={W} valid={W} H={H} K={K} hd={hd} bf16 (image)",
        flops=4.0 * B * H * hd * W,
        bytes=2.0 * (2 * B * H * hd + 2 * B * W * K * hd) + 4.0 * W,
        peak=PEAK_BF16_FLOPS,
        kernel=lambda a=(q, kc, vc): ops.decode_attention(*a, spi, W - 1),
        plain=lambda a=(q, kc, vc): ref.decode_attention_cache(*a, spi,
                                                               W - 1),
        library=lambda a=(q, kc, vc): F.scaled_dot_product_attention(
            a[0][:, :, None], a[1].transpose(1, 2), a[2].transpose(1, 2),
            enable_gqa=True))]
    return sets


def ssd_work(B, S, H, G, N, P, Lc) -> tuple:
    """(operations, bytes) of the SSD intra-chunk block, 2 operations a
    multiply-add: per (b, chunk, group) the lower triangle's scores C·Bᵀ
    (N each; B and C are the group's, so its heads share them), per (b,
    chunk, head) the lower triangle's y products (P each) and the states'
    Lc * N * P; bytes count x, dt, A, B, C in and y, states out once."""
    tri = Lc * (Lc + 1) / 2
    flops = B * (S // Lc) * (G * 2.0 * tri * N
                             + H * (2.0 * tri * P + 2.0 * Lc * N * P))
    nbytes = 4.0 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * G * N
                    + B * (S // Lc) * H * N * P)
    return flops, nbytes


def _ssd_kernel_sets(gen) -> dict:
    """The SSD kernel and its bf16 variant at zamba2's prefill
    (``prefill_step``'s B 2, S 2048: H 80, one group, N = P = 64, Lc 256),
    inputs distributed as the model gives them; no single PyTorch call
    computes the block."""
    from repro_torch.kernels import ops, ref
    cfg = _zamba_cfg()
    B, S = ZAMBA["prefill"]
    H, G, N, P, Lc = (cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_head_dim, cfg.ssm_chunk)
    args = _ssd_inputs(gen, B, S, H, G, N, P)
    flops, nbytes = ssd_work(B, S, H, G, N, P, Lc)
    # every product of the bf16 variant is bf16 x bf16 summed in fp32, work
    # the card does at the bf16 peak however the kernel is built; its
    # operands arrive and leave as fp32, so the bytes are the fp32 route's
    return {f"ssd_intra_chunk{tag}": [dict(
        shape=f"B={B} S={S} H={H} G={G} N={N} P={P} Lc={Lc} "
              f"{'bf16 variant' if bf16 else 'fp32'}",
        flops=flops, bytes=nbytes, iters=10,
        peak=PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS,
        kernel=lambda b=bf16: ops.ssd_intra_chunk(*args, Lc, bf16=b),
        plain=lambda b=bf16: ref.ssd_intra_chunk_ref(*args, Lc, bf16=b),
        library=None)] for tag, bf16 in (("", False), ("_bf16", True))}


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
        kernels = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            kernels += 1
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
            "device_kernels_per_step": kernels / steps,
            "wall_ms_profiled": wall_us / 1e3,
            "device_ms": {k: v / 1e3 for k, v in split.items()},
            "device_busy_share": busy / wall_us,
            "top_other": sorted(((v / 1e3, k[:80]) for k, v in
                                 other.items()), reverse=True)[:6]})
        return out
    return wrapped


def eq5_profile(steps: int = 20) -> dict:
    """Eq. 5's part of a g3 step on the card (``_eq5_step`` at the batch of
    128, the g3 widths): ``steps`` steps under the profiler, with every
    CUDA kernel of its full list counted, their device time, and their
    names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    gen = torch.Generator().manual_seed(4)
    step = _eq5_step(_distill_inputs(gen, TRAIN_B, DISTILL["D"],
                                     DISTILL["M"]), DISTILL["lam"])
    step()
    torch.cuda.synchronize()
    # one step in the profiler's warm-up cycle, whose events it drops, so
    # that the counted cycle starts with the tracing running; the counted
    # cycle's events are taken as it ends
    traced: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(p.events())) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        prof.step()
    names: dict = {}
    us = 0.0
    for e in traced:       # the schedule's step annotation is no kernel
        if (e.device_type == DeviceType.CUDA
                and not e.name.startswith("ProfilerStep")):
            names[e.name[:80]] = names.get(e.name[:80], 0) + 1
            us += e.time_range.elapsed_us()
    res = {"steps": steps,
           "device_kernels_per_step": sum(names.values()) / steps,
           "device_us_per_step": us / steps,
           "kernels": {k: v / steps for k, v in names.items()}}
    log(f"Eq. 5 of a g3 step (B {TRAIN_B}): {res}")
    return res


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
    res["g3"]["eq5"] = eq5 = eq5_profile()
    # only the two Eq. 5 kernels, once a step (a trace may drop an event)
    _require(len(eq5["kernels"]) == 2
             and all("distill" in k and v <= 1 for k, v in
                     eq5["kernels"].items())
             and eq5["device_kernels_per_step"] > 1.9, eq5)
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
            dx, dxh, dz, dzt, dm = launch_bwd(*args, **kw)
            return (dx, dxh, dz * scale, None if dzt is None else dzt * scale,
                    dm)
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
    log(f"=== phase 7: serve {LM['arch']} at full width and depth ===")
    res = serve_cell(LM, LM_PREFILL)
    res["check"] = lm_card_vs_cpu()
    return res


def serve_cell(cell: dict, prefill: tuple, labels: tuple = ()) -> dict:
    """An LM serving cell at full width and depth in bf16 on the card:
    ``launch/serve.main --no-smoke`` (exactly one flash launch a layer a
    prefill and one decode launch a layer a step; its peak memory), the
    same weights drawn again (timed), ``prefill_step`` at ``prefill``
    twice (the first also warms cuBLAS) and once under the profiler, and
    ten warm decode steps under the profiler; with ``labels``, the
    profiles split by the program's spans of those names (MOE_RANGES).
    The launches of the CLI run and of the two timed ``prefill_step``
    calls are the path's."""
    import time
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve.decode import prefill_step
    from repro_torch.sharding.policy import leaves
    cfg = get_config(cell["arch"]).with_(use_flash_kernel=True)
    L = cfg.n_layers
    smi = _smi()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "lm.json")
        argv = ["--arch", cell["arch"], "--no-smoke", "--device", CARD,
                "--batch", str(cell["batch"]), "--slots", str(cell["slots"]),
                "--prefill-len", str(cell["prefill_len"]),
                "--requests", str(cell["requests"]),
                "--prompt-len", *map(str, cell["prompt"]),
                "--max-new", str(cell["max_new"]), "--out", out]
        ops.reset_launches()
        rc = serve.main(argv)
        counts = dict(ops.LAUNCHES)
        _require(rc == 0, rc)
        with open(out) as fh:
            stats = json.load(fh)
    stats["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"{cfg.name} serve ({smi}): {stats} (launches {counts})")
    _require(stats["n_layers"] == L and stats["dtype"] == "bfloat16"
             and stats["completed"] == cell["requests"]
             and stats["tokens_out"] == cell["requests"] * cell["max_new"],
             stats)
    _require(counts["flash_attention"] == L * stats["prefills"],
             f"flash launches {counts['flash_attention']}, expected "
             f"{L} x {stats['prefills']} prefills")
    _require(counts["decode_attention"] == L * stats["decode_steps"],
             f"decode launches {counts['decode_attention']}, expected "
             f"{L} x {stats['decode_steps']} steps")
    res = {"serve": stats, "serve_launches": counts,
           "launches_per_decode_step": (counts["decode_attention"]
                                        / stats["decode_steps"])}
    torch.cuda.empty_cache()

    # the same weights again, timed; then prefill_step on them
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = serve.build_params(cfg, device=CARD)
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in leaves(params))
    log(f"{cfg.name} init: {res['init_s']:.2f} s for "
        f"{res['param_bytes'] / 2**30:.2f} GiB")
    B, S = prefill
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(CARD)
    walls = []
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
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
    del lg
    peak = torch.cuda.max_memory_allocated()
    prof = _profiled(lambda: prefill_step(params, cfg, {"tokens": toks}),
                     1, labels)
    res["decode_profile"] = _profile_decode(params, cfg, cell, labels)
    res["prefill_step"] = {"B": B, "S": S, "ms": walls, "launches": pcounts,
                           "peak_bytes": peak, "profile": prof}
    log(f"prefill_step B={B} S={S}: {walls} ms, peak {peak / 2**30:.2f} "
        f"GiB (launches {pcounts}); profile {prof}")
    res["launches"] = {k: counts[k] + pcounts[k] for k in ops.LAUNCHES}
    del params
    torch.cuda.empty_cache()
    return res


# the port's kernels by the name of their __global__ function
# substrings of the cuBLAS / CUTLASS kernel names that are GEMMs
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma", "nvjet")
KERNEL_NAMES = {"decode_kernel": "decode_attention",
                "flash_kernel": "flash_attention",
                "ssd_kernel": "ssd_intra_chunk"}


def _profiled(fn, calls: int, labels: tuple = ()) -> dict:
    """``calls`` calls of ``fn`` under the profiler: the host wall per call,
    the card's time per call by kind (each port kernel, GEMMs (cuBLAS), and
    the rest: PyTorch's elementwise, copy and reduction kernels), its busy
    share of the wall, and the largest device items; with ``labels``, also
    the card's time per call inside each ``record_function`` range of those
    names (the program's spans, ``repro_torch.spans``)."""
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
    ranges = {k: 0.0 for k in labels}
    decode_routes = set()

    def kernel_us(ev) -> float:
        """The kernels launched inside a CPU event, its children's too
        (not the range's own span on the device timeline)."""
        return (sum(kn.duration for kn in ev.kernels if kn.name not in ranges)
                + sum(kernel_us(c) for c in ev.cpu_children))
    for e in prof.events():
        if e.name in ranges:
            if e.device_type == DeviceType.CPU:
                ranges[e.name] += kernel_us(e)
            continue
        # a span's range on the device timeline is no operation
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        us = e.time_range.elapsed_us()
        low = e.name.lower()
        kind = next((v for k, v in KERNEL_NAMES.items() if k in low), None)
        if kind == "decode_attention":
            decode_routes.add("grouped" if "decode_kernel_grouped" in low
                              else "slots")
        if kind is None:
            kind = "gemm" if any(t in low for t in GEMM_NAMES) else "other"
        kinds[kind] += us
        names[e.name[:80]] = names.get(e.name[:80], 0.0) + us
    out = {"calls": calls,
           "wall_ms_per_call_profiled": wall_us / calls / 1e3,
           "device_ms_per_call": {k: v / calls / 1e3
                                  for k, v in kinds.items()},
           "device_busy_share": sum(kinds.values()) / wall_us,
           "top": sorted(((v / calls / 1e3, k) for k, v in names.items()),
                         reverse=True)[:8],
           "decode_routes": sorted(decode_routes)}
    if labels:
        busy = sum(kinds.values())
        out["device_ms_per_call_by_range"] = dict(
            {k: v / calls / 1e3 for k, v in ranges.items()},
            rest=(busy - sum(ranges.values())) / calls / 1e3)
    return out


def _profile_decode(params, cfg, cell: dict, labels: tuple = (),
                    steps: int = 10) -> dict:
    """Decode steps of an LM cell's engine (a batch of requests in flight,
    warm): ``steps`` timed by the engine, then ``steps`` under the profiler
    (``_profiled``, with ``labels``)."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import Engine
    eng = Engine(params, cfg, batch=cell["batch"], n_slots=cell["slots"],
                 prefill_len=cell["prefill_len"], device=CARD)
    for r in serve.make_requests(cell["batch"], cfg.vocab_size,
                                 lo=cell["prompt"][0], hi=cell["prompt"][1],
                                 max_new=cell["max_new"]):
        eng.submit(r)
    for _ in range(3 + steps):       # the prefills, then warm decode steps
        eng.step()
    out = {"steps": steps, "step_ms_unprofiled": eng.step_ms[-steps:]}
    out.update(_profiled(eng.step, steps, labels))
    log(f"decode profile: {out}")
    _require(out["decode_routes"] == [_decode_route(cfg)],
             ("decode routes", out["decode_routes"], _decode_route(cfg)))
    return out


def _decode_route(cfg) -> str:
    """The decode-attention route an LM config's decode steps take on the
    card (``kernels/decode_attention.route`` at its heads and dtype)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    return da.route(cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
                    getattr(torch, cfg.dtype))


def lm_card_vs_cpu(cell: dict = LM, c: dict = LM_CHECK) -> dict:
    """An LM cell's config (internlm2-1.8b; qwen3-moe-30b-a3b for phase
    13) at full width, depth ``c["layers"]``, fp32, weights made once on
    the CPU and copied to the card: the prefill and decode logits agree
    within TOL_LM x max|logit| and the engine's tokens are identical; for
    an MoE, every layer's experts and slots (so its dropped set) at the
    prefill are equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.transformer import decoder_prefill_with_cache
    from repro_torch.serve.engine import Engine
    from repro_torch.tree import tree_map
    cfg = get_config(cell["arch"]).with_(n_layers=c["layers"],
                                         dtype="float32",
                                         use_flash_kernel=True)
    cpu = serve.build_params(cfg, device="cpu")
    card = tree_map(lambda t: t.to(CARD), cpu)
    reqs = lambda: serve.make_requests(c["requests"], cfg.vocab_size,
                                       lo=cell["prompt"][0],
                                       hi=cell["prompt"][1],
                                       max_new=c["max_new"])
    P = cell["prefill_len"]
    toks = torch.from_numpy(_engine_prompts(reqs(), P))
    runs, routes = {}, {}
    ops.reset_launches()
    for dev, p in ((CARD, card), ("cpu", cpu)):
        with torch.no_grad(), _recorded_routes(routes.setdefault(dev, [])):
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
    L = cfg.n_layers
    routing = []
    rel = []
    for i, (got, want) in enumerate(zip(runs[CARD], runs["cpu"])):
        if cfg.n_experts:       # the routes that fed call i, layer by layer
            routing.append(_same_routes(
                cfg, routes[CARD][i * L:(i + 1) * L],
                routes["cpu"][i * L:(i + 1) * L],
                "prefill" if i == 0 else f"decode step {i - 1}"))
        _require(bool(torch.isfinite(got).all()), "card logits not finite")
        _require(torch.equal(torch.argmax(got, -1), torch.argmax(want, -1)),
                 "card and cpu disagree on a greedy token")
        rel.append(float((got - want).abs().max() / want.abs().max()))
    log(f"depth-2 card vs cpu logits, max|d| / max|logit| per step: {rel}")
    if routing:
        log(f"depth-2 card vs cpu moe routes, the same in every call and "
            f"layer: {routing}")
    _require(max(rel) <= TOL_LM, rel)
    # the card's kernels against the reference's plain _sdpa sites (the
    # switch off, so the CPU runs _sdpa): prefill and the first decode step
    with torch.no_grad():
        plain = cfg.with_(use_flash_kernel=False)
        lg, cache = decoder_prefill_with_cache(cpu, plain, toks, c["slots"])
        lg2, _ = M.decode(cpu, plain, torch.argmax(lg, -1), cache, P)
    sites = [float((a - b).abs().max() / b.abs().max())
             for a, b in zip(runs[CARD][:2], (lg, lg2))]
    log(f"depth-2, the card's kernels vs the plain _sdpa sites on the cpu, "
        f"max|d| / max|logit| (prefill, decode): {sites}")
    _require(max(sites) <= TOL_LM, sites)
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
            "max_logit_rel_err": max(rel), "routing_rel_err": sites,
            "tokens_identical": True,
            "moe_dropped_per_layer": [r["dropped"] for r in routing],
            "moe_tokens_with_swapped_order": [
                r["tokens_with_swapped_order"] for r in routing],
            "stats": gens["cpu"][1].__dict__, "launches": eng_counts,
            "direct_launches": direct}


@contextlib.contextmanager
def _recorded_routes(into: list):
    """Append every ``ffn.route`` result (a ``Routing``, on the CPU) to
    ``into`` while the block runs."""
    from repro_torch.models import ffn
    real = ffn.route

    def recording(router, cfg, xt):
        r = real(router, cfg, xt)
        into.append(type(r)(*(t.cpu() if hasattr(t, "cpu") else t
                              for t in r)))
        return r
    ffn.route = recording
    try:
        yield
    finally:
        ffn.route = real


def _same_routes(cfg, card: list, cpu: list, what: str) -> dict:
    """The card's and the CPU's routes layer by layer: for every token the
    same top-1 expert and the same k experts, each with the same slot (so
    the same dropped set).  The order of a token's other k - 1 experts is
    not part of the function (an entry's rank in its expert counts earlier
    tokens only; the combine adds in slot order), and two near-equal
    probabilities may swap places there: such tokens are counted.  At the
    first token that differs, the probabilities of the experts in question
    and the k-th against the (k+1)-th on each device are printed before
    the run fails: a flip near a tie."""
    import torch
    k, E = cfg.experts_per_token, cfg.n_experts
    _require(len(card) == len(cpu) == cfg.n_layers, (what, len(card),
                                                     len(cpu)))

    def by_expert(r):
        order = torch.argsort(r.topi, dim=1)
        return (torch.gather(r.topi, 1, order),
                torch.gather(r.slot, 1, order))
    dropped, swapped = [], 0
    for layer, (a, b) in enumerate(zip(card, cpu)):
        (ea, sa), (eb, sb) = by_expert(a), by_expert(b)
        bad = ((ea != eb) | (sa != sb)).any(1) | (a.topi[:, 0] != b.topi[:, 0])
        if a.capacity != b.capacity or bool(bad.any()):
            t = int(bad.nonzero()[0, 0]) if bool(bad.any()) else 0
            ids = sorted(set(a.topi[t].tolist()) ^ set(b.topi[t].tolist())
                         | {int(a.topi[t, 0]), int(b.topi[t, 0])})
            probs = {}
            for dev, r in (("card", a), ("cpu", b)):
                top = torch.sort(r.probs[t], descending=True).values
                probs[dev] = {"experts": {e: float(r.probs[t, e])
                                          for e in ids},
                              "k-th, (k+1)-th": [float(top[k - 1]),
                                                 float(top[k])]}
            log(f"moe routes differ at {what}, layer {layer}, token {t}: "
                f"experts {a.topi[t].tolist()} slots {a.slot[t].tolist()} "
                f"(card) vs {b.topi[t].tolist()} {b.slot[t].tolist()} "
                f"(cpu), capacity {a.capacity} vs {b.capacity}; "
                f"probabilities {probs}")
            _require(False, f"moe routes differ at {what}, layer {layer}")
        swapped += int((a.topi != b.topi).any(1).sum())
        dropped.append(int((b.slot == E * b.capacity).sum()))
    return {"what": what, "capacity": cpu[0].capacity, "dropped": dropped,
            "tokens_with_swapped_order": swapped}


# the program's spans (``repro_torch.spans``) phase 13 splits an MoE
# prefill and decode step into; ``block.attention`` holds the projections,
# RoPE, the decode cache write and the kernel
MOE_RANGES = ("moe.route", "moe.dispatch_combine", "moe.experts",
              "block.attention")


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
    from repro_torch.serve.decode import prefill_step
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

    with torch.no_grad():
        cache = M.init_cache(params, cfg, ZAMBA["batch"], ZAMBA["slots"])
    res["decode"] = _lockstep_decode(params, cfg, cache, ZAMBA, G)
    del cache
    for k, v in res["decode"]["launches"].items():
        res["launches"][k] += v
    log(f"zamba decode: {res['decode']}")
    del params
    torch.cuda.empty_cache()
    res["check"] = zamba_checks()
    return res


def _lockstep_decode(params, cfg, cache, cell: dict, per_step: int,
                     kinds: dict = None) -> dict:
    """Greedy decode through ``make_decode_step`` on the card from
    ``cache`` (``M.init_cache``'s, at ``cell["batch"]`` rows; updated in
    place): ``cell["prompt"]`` seeded prompt tokens fed through decode
    steps, then ``cell["new"]`` generated, each step ending in the
    device->host copy of its tokens.  Exactly ``per_step`` decode launches
    a step and no other kernel (with ``kinds``, also these attention calls
    a step by kind, ``_attention_kinds``); then ``cell["profile_steps"]``
    more steps under the profiler."""
    import time
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.decode import make_decode_step
    Bd, P, new = cell["batch"], cell["prompt"], cell["new"]
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (Bd, P)).astype(np.int32)
    step = make_decode_step(cfg)
    state = {"cache": cache, "pos": 0,
             "tok": torch.from_numpy(prompts[:, 0]).to(CARD)}

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
    with torch.no_grad(), _attention_kinds({}) as seen:
        for t in range(P + new):
            t0 = time.perf_counter()
            out = one_step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if t >= P - 1:
                generated.append(out)
    counts = dict(ops.LAUNCHES)
    want = {k: 0 for k in ops.LAUNCHES}
    want["decode_attention"] = per_step * (P + new)
    _require(counts == want and (kinds is None or seen == {
        k: v * (P + new) for k, v in kinds.items()}), (counts, seen))
    gen = np.stack(generated[:new], axis=1)            # (B, new)
    _require(gen.shape == (Bd, new) and int(gen.min()) >= 0
             and int(gen.max()) < cfg.vocab_size, gen.shape)
    with torch.no_grad():
        prof = _profiled(one_step, cell["profile_steps"])
    want = [_decode_route(cfg)] if per_step else []
    _require(prof["decode_routes"] == want,
             ("decode routes", prof["decode_routes"], want))
    gen_ms = sum(step_ms[P:])
    return {"batch": Bd, "slots": cell["slots"], "prompt": P, "new": new,
            "steps": P + new,
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_p99": float(np.percentile(step_ms, 99)),
            "step_ms": step_ms,
            "generated_tokens_per_s": Bd * new / gen_ms * 1e3,
            "launches": counts, "kinds": seen,
            "first_row_tokens": gen[0].tolist(), "generated": gen.tolist(),
            "profile": prof}


def _prefill_then_decode(p, cfg, inputs: dict, steps: int) -> list:
    """``prefill_step``'s logits, then ``steps`` greedy decode steps from
    ``M.init_cache`` (16 slots; the VLM's from ``inputs["image_embeds"]``)
    fed the prompt's first token: every call's logits, on the host."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.decode import prefill_step
    toks = inputs["tokens"]
    with torch.no_grad():
        lgs = [prefill_step(p, cfg, inputs).cpu()]
        cache = M.init_cache(p, cfg, toks.shape[0], 16,
                             image_embeds=inputs.get("image_embeds"))
        tok = toks[:, 0]
        for t in range(steps):
            lg, cache = M.decode(p, cfg, tok, cache, t)
            lgs.append(lg.cpu())
            tok = torch.argmax(lg, -1).to(torch.int32)
    return lgs


def _held_logits(card: list, cpu: list, what: str) -> list:
    """The card's calls against the CPU's: finite, the same greedy tokens,
    each call's max|d| / max|logit| (returned) within TOL_LM."""
    import torch
    rel = []
    for got, want in zip(card, cpu):
        _require(bool(torch.isfinite(got).all()), "card logits not finite")
        _require(torch.equal(torch.argmax(got, -1), torch.argmax(want, -1)),
                 "card and cpu disagree on a greedy token")
        rel.append(float((got - want).abs().max() / want.abs().max()))
    log(f"{what} card vs cpu logits, max|d| / max|logit| (prefill, then "
        f"each decode step): {rel}")
    _require(max(rel) <= TOL_LM, rel)
    return rel


def _decode_vs_forward(p, cfg, inputs: dict, what: str) -> dict:
    """On the card: the full forward over ``inputs["tokens"]`` (B, T)
    against T decode steps from ``M.init_cache`` with T slots, within
    TOL_DECODE_VS_FORWARD x max|logit|."""
    import torch
    from repro_torch.models import model as M
    toks = inputs["tokens"]
    B, T = toks.shape
    with torch.no_grad():
        full, _ = M.logits(p, cfg, inputs)
        cache = M.init_cache(p, cfg, B, T,
                             image_embeds=inputs.get("image_embeds"))
        gap = torch.zeros((), device=CARD)
        agree = torch.zeros((), dtype=torch.int64, device=CARD)
        for t in range(T):
            lg, cache = M.decode(p, cfg, toks[:, t], cache, t)
            gap = torch.maximum(gap, (lg - full[:, t]).abs().max())
            agree += (lg.argmax(-1) == full[:, t].argmax(-1)).sum()
        dvf = float(gap) / float(full.abs().max())
    log(f"{what} on the card, {T} decode steps vs the forward: max|d| / "
        f"max|logit| {dvf:.3e}; greedy tokens agree at {int(agree)} of "
        f"{B * T} positions")
    _require(dvf <= TOL_DECODE_VS_FORWARD, dvf)
    return {"decode_vs_forward_rel_err": dvf,
            "decode_vs_forward_token_agreement": int(agree) / (B * T)}


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
    from repro_torch.serve.decode import prefill_step
    from repro_torch.tree import tree_map
    c = ZAMBA_CHECK
    cfg = _zamba_cfg(n_layers=c["layers"], dtype="float32")
    G = cfg.n_layers // cfg.attn_period
    cpu = serve.build_params(cfg, device="cpu")
    card = tree_map(lambda t: t.to(CARD), cpu)
    B, S = c["prefill"]
    toks = _tokens(2, B, S, cfg.vocab_size)
    what = f"zamba depth-{cfg.n_layers}"
    ops.reset_launches()
    runs = {dev: _prefill_then_decode(p, cfg, {"tokens": toks.to(dev)},
                                      c["steps"])
            for dev, p in ((CARD, card), ("cpu", cpu))}
    counts = dict(ops.LAUNCHES)
    _require(counts["ssd_intra_chunk"] == cfg.n_layers
             and counts["flash_attention"] == G
             and counts["decode_attention"] == G * c["steps"], counts)
    rel = _held_logits(runs[CARD], runs["cpu"], what)
    # the bf16 SSD (cfg.ssd_bf16): the card's kernel variant against the
    # CPU's plain bf16 route, one prefill_step
    bcfg = cfg.with_(ssd_bf16=True)
    ops.reset_launches()
    with torch.no_grad():
        got = prefill_step(card, bcfg, {"tokens": toks.to(CARD)}).cpu()
        bcounts = dict(ops.LAUNCHES)
        want = prefill_step(cpu, bcfg, {"tokens": toks})
    bf16_rel = float((got - want).abs().max() / want.abs().max())
    bf16_vs_f32 = float((want - runs["cpu"][0]).abs().max()
                        / runs["cpu"][0].abs().max())
    log(f"zamba depth-{cfg.n_layers} ssd_bf16 prefill_step, card vs cpu: "
        f"max|d| / max|logit| {bf16_rel:.3e} (bound {TOL_SSD_BF16:g}; the "
        f"CPU's bf16 route vs its fp32 route {bf16_vs_f32:.3e}; launches "
        f"{bcounts})")
    _require(bcounts["ssd_intra_chunk"] == cfg.n_layers, bcounts)
    _require(bf16_rel <= TOL_SSD_BF16, bf16_rel)
    del cpu

    ops.reset_launches()
    dvf = _decode_vs_forward(card, cfg, {"tokens": toks.to(CARD)}, what)
    dvf_counts = dict(ops.LAUNCHES)
    _require(dvf_counts["ssd_intra_chunk"] == cfg.n_layers
             and dvf_counts["flash_attention"] == G
             and dvf_counts["decode_attention"] == G * S, dvf_counts)
    return dict(dvf, layers=cfg.n_layers, logit_rel_err=rel,
                max_logit_rel_err=max(rel), tokens_identical=True,
                launches=counts, ssd_bf16_prefill_rel_err=bf16_rel,
                ssd_bf16_vs_fp32_cpu_rel=bf16_vs_f32,
                decode_vs_forward_launches=dvf_counts)


def _held(card, cpu: dict, what: str,
          last: dict = CARD_VS_CPU_LAST) -> dict:
    """Hold a card run to the CPU run at the same seed (phase 4's checks):
    epochs, rounds and comm equal, each stage's train loss per epoch within
    TOL_LOSS (the last epoch of ``last``'s stages within theirs: by default
    g3's within TOL_LOSS_G3_LAST), metrics within TOL_METRIC.  Both sides
    as JSON-ready dicts; returns the readings.  ``last={}`` holds every
    epoch to TOL_LOSS, as a card run is held to another card run."""
    _require(card["epochs"] == cpu["epochs"],
             (what, card["epochs"], cpu["epochs"]))
    _require(card["rounds"] == cpu["rounds"],
             (what, card["rounds"], cpu["rounds"]))
    _require(card["comm"] == cpu["comm"], (what, card["comm"], cpu["comm"]))
    loss_err = _loss_rel_err(card["train_loss"], cpu["train_loss"])
    _require(_losses_agree(loss_err, last), (what, loss_err))
    gap = {k: abs(card["metrics"][k] - v) for k, v in cpu["metrics"].items()}
    _require(max(gap.values()) < TOL_METRIC, (what, gap))
    log(f"{what}: epochs {cpu['epochs']}, train-loss rel err per epoch "
        f"{loss_err}, metric gap {gap}")
    return {"loss_rel_err": loss_err, "metric_gap": gap}


def _summary(r) -> dict:
    """What phase 9 compares of a ``RunResult``, JSON-ready."""
    return json.loads(json.dumps({
        "epochs": r.epochs, "rounds": r.rounds, "comm": r.comm,
        "train_loss": r.train_loss, "metrics": r.metrics}))


def _launched(counts: dict, what: str, distill: bool) -> None:
    """The lane-MLP kernels ran in every run of phase 9, and the Eq. 5
    kernels in every run that trains g3."""
    need = ["lane_mlp_fwd", "lane_mlp_bwd"]
    need += ["distill_fwd", "distill_bwd"] if distill else []
    _require(all(counts[k] > 0 for k in need), (what, counts))


def k3_g2_limit(sck, kw: dict, cpu_loss: dict) -> dict:
    """The readings that place TOL_LOSS_K3_G2_LAST, taken in this run
    against phase 9's CPU ``run_apcvfl_k``, as phase 6 places g3's: below
    the limit, the CPU's own spread (g1 and g2 through the closed-form
    backward instead of autograd); above it, ``run_apcvfl_k`` on the card
    with each planted fault of K3_G2_FAULTS in the lane-MLP backward
    kernel's output for the 640-wide MLP."""
    from repro_torch.core import autoencoder as ae
    from repro_torch.core import multiparty
    from repro_torch.kernels import lane_mlp
    run = lambda dev: multiparty.run_apcvfl_k(sck, use_kernel=True,
                                              device=dev, **kw).train_loss
    autograd = ae.masked_recon_loss
    ae.masked_recon_loss = ae.make_masked_recon_loss(True)
    try:
        spread = _loss_rel_err(run("cpu"), cpu_loss)
    finally:
        ae.masked_recon_loss = autograd
    log(f"k3 cpu closed-form vs autograd: train-loss rel err {spread}")
    _require(spread["g2"][-1] <= TOL_LOSS_K3_G2_LAST,
             f"the CPU's own K = 3 g2 spread {spread['g2']} is not below "
             f"{TOL_LOSS_K3_G2_LAST}")
    faults = {}
    launch_bwd = lane_mlp.launch_bwd
    for what, fault in K3_G2_FAULTS.items():
        def planted(g, xs, *args, fault=fault, **kw_bwd):
            out = launch_bwd(g, xs, *args, **kw_bwd)
            return fault(*out) if xs.shape[-1] == 640 else out
        lane_mlp.launch_bwd = planted
        try:
            faults[what] = _loss_rel_err(run("cuda"), cpu_loss)
        finally:
            lane_mlp.launch_bwd = launch_bwd
        log(f"k3 planted fault {what}: train-loss rel err {faults[what]}")
        _require(faults[what]["g2"][-1] > TOL_LOSS_K3_G2_LAST,
                 f"planted fault {what} passes the K = 3 g2 limit")
    return {"limit": TOL_LOSS_K3_G2_LAST, "cpu_spread": spread,
            "faults": faults}


def phase_comparison() -> dict:
    """The paper's comparison on phase 4's scenario (phase 9): SplitNN,
    VFedTrans and the ablation on the card, each held to its CPU run at the
    same seed; the serving CLI with ``--n-parties 3`` (train, export,
    reload, serve) held to ``run_apcvfl_k`` on the CPU, and the readings of
    its g2 limit (``k3_g2_limit``); then on the card
    ``run_apcvfl_replicated`` and ``run_apcvfl_k_replicated`` over two
    seeds, each seed's lane held to the sequential run at that seed."""
    import time
    import torch
    from repro_torch.core import multiparty, pipeline, splitnn, vfedtrans
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_vfl
    log("=== phase 9: the paper's comparison on mimic3 at full width ===")
    sc = _scenario()
    seed, epochs = SCENARIO["seed"], TRAIN["epochs"]
    sck = multiparty.make_scenario_k(
        make_dataset(SCENARIO["dataset"], seed=seed),
        n_parties=COMPARISON["n_parties"],
        n_active_features=SCENARIO["active_features"],
        n_aligned=SCENARIO["aligned"], seed=seed)
    kw = dict(seed=seed, max_epochs=epochs)
    methods = {
        "splitnn": lambda dev: splitnn.run_splitnn(sc, device=dev, **kw),
        "vfedtrans": lambda dev: vfedtrans.run_vfedtrans(sc, device=dev,
                                                         **kw),
        "ablation": lambda dev: pipeline.run_apcvfl(
            sc, ablation=True, use_kernel=True, device=dev, **kw)}
    res, launches = {}, dict.fromkeys(ops.LAUNCHES, 0)

    def on_card(what, fn, distill):
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        _launched(counts, what, distill)
        for k, v in counts.items():
            launches[k] += v
        res[what] = {"wall_s": wall, "launches": counts}
        return out

    def record(what, card: dict) -> None:
        res[what]["summary"] = {"metrics": card["metrics"],
                                "comm_bytes": card["comm"]["total_bytes"],
                                "rounds": card["rounds"]}

    fed = {}
    for name, run in methods.items():
        card = on_card(name, lambda: run("cuda"), name == "ablation")
        t0 = time.perf_counter()
        cpu = run("cpu")
        res[name]["cpu_wall_s"] = time.perf_counter() - t0
        res[name].update(_held(_summary(card), _summary(cpu), name))
        record(name, _summary(card))
        if name == "vfedtrans":
            fed = {dev: r.artifacts for dev, r in (("card", card),
                                                   ("cpu", cpu))}
    # FedSVD's server is the host in both runs: the same bits
    _require(all(np.array_equal(fed["card"][k], fed["cpu"][k])
                 for k in ("U", "S")), "FedSVD's U and S differ")

    # the CLI at K = 3: train, export, save, reload, serve
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "stats.json")
        argv = ["--dataset", SCENARIO["dataset"],
                "--aligned", str(SCENARIO["aligned"]),
                "--active-features", str(SCENARIO["active_features"]),
                "--n-parties", str(COMPARISON["n_parties"]),
                "--epochs", str(epochs), "--requests", str(TRAIN["requests"]),
                "--seed", str(seed), "--bundle", os.path.join(tmp, "b"),
                "--out", out]
        rc = on_card("k3_cli", lambda: serve_vfl.main(argv), True)
        _require(rc == 0, rc)
        with open(out) as fh:
            stats = json.load(fh)
    _require(stats["rows"] > 0 and stats["dispatches"], stats)
    t0 = time.perf_counter()
    cpu_k = multiparty.run_apcvfl_k(sck, use_kernel=True, device="cpu", **kw)
    res["k3_cli"]["cpu_wall_s"] = time.perf_counter() - t0
    card_k = {k: stats["train"][k] for k in ("epochs", "rounds", "comm",
                                             "train_loss", "metrics")}
    k3_last = {**CARD_VS_CPU_LAST, "g2": TOL_LOSS_K3_G2_LAST}
    res["k3_cli"].update(_held(card_k, _summary(cpu_k), "k3_cli", k3_last),
                         train_s=stats["train"]["seconds"],
                         rows_per_s=stats["rows_per_s"])
    record("k3_cli", card_k)
    res["k3_g2_limit"] = k3_g2_limit(sck, kw, cpu_k.train_loss)

    # seed replicas on the card, each lane against the sequential run on
    # the card: every epoch of every stage within TOL_LOSS (no last-epoch
    # limit of a card-vs-CPU comparison applies)
    seeds = COMPARISON["seeds"]
    for what, rep_fn, seq_fn, scen in (
            ("replicated", pipeline.run_apcvfl_replicated,
             pipeline.run_apcvfl, sc),
            ("k3_replicated", multiparty.run_apcvfl_k_replicated,
             multiparty.run_apcvfl_k, sck)):
        rep = on_card(what, lambda: rep_fn(
            scen, seeds=seeds, max_epochs=epochs, use_kernel=True,
            device="cuda"), True)
        t0 = time.perf_counter()
        seq = [seq_fn(scen, seed=s, max_epochs=epochs, use_kernel=True,
                      device="cuda") for s in seeds]
        res[what]["sequential_wall_s"] = time.perf_counter() - t0
        res[what]["per_seed"] = [
            _held(_summary(r), _summary(q), f"{what} seed {s} vs sequential",
                  last={})
            for s, r, q in zip(seeds, rep, seq)]
        record(what, _summary(rep[0]))          # seed 0's lane
    res["launches"] = launches
    return res


def _experiment_cli(argv: list) -> dict:
    """``launch.experiment.main(argv)``; returns its payload (the
    ``--out`` file), the ``RunResult``s behind the records and the wall
    time on the host clock.  The results are read off the CLI's own
    ``sweep`` call (losses are not in the tidy records)."""
    import time
    import torch
    from repro_torch.launch import experiment
    caught, sweep = [], experiment.sweep

    def keep(*a, **kw):
        caught.append(sweep(*a, **kw))
        return caught[-1]

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.json")
        experiment.sweep = keep
        try:
            t0 = time.perf_counter()
            rc = experiment.main([*argv, "--quiet", "--out", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            experiment.sweep = sweep
        _require(rc == 0, (argv, rc))
        with open(out) as fh:
            payload = json.load(fh)
    (results,) = caught
    return {"payload": payload, "results": results, "wall_s": wall}


def _check_records(what: str, records: list) -> None:
    """Every record a probe's accuracy in [0, 1] or an attack's finite
    leakage in [0, 1]."""
    for r in records:
        if "leakage" in r:
            ok = np.isfinite(r["leakage"]) and 0.0 <= r["leakage"] <= 1.0
        else:
            ok = 0.0 <= r["accuracy"] <= 1.0
        _require(ok, (what, r))


def probe_g3_reading(probe_run) -> dict:
    """Appendix F's probe at g3's widths (5 -> 256 -> 256 and back), read
    and not held: the card against the CPU, and the CPU's own spread
    between two orderings of the same math (the closed-form backward the
    card's kernels compute, against autograd of the layer loop).  The two
    move together (PERF.md, Findings), so TOL_LOSS cannot hold this fit."""
    from repro_torch.core import autoencoder as ae
    card, cpu = probe_run("g3", "cuda"), probe_run("g3", "cpu")
    autograd = ae.recon_loss
    ae.recon_loss = ae.make_recon_loss(True)
    try:
        closed = probe_run("g3", "cpu")
    finally:
        ae.recon_loss = autograd
    loss = lambda r: {"g": r["history"]["loss"]}
    return {"card_vs_cpu": _loss_rel_err(loss(card), loss(cpu))["g"],
            "cpu_closed_form_vs_autograd":
                _loss_rel_err(loss(closed), loss(cpu))["g"],
            "card_vs_cpu_closed_form":
                _loss_rel_err(loss(card), loss(closed))["g"]}


def phase_experiments() -> dict:
    """The experiment driver on the card (phase 10): (a) ``--smoke`` on
    the card and on the CPU, held record for record; (b) four spec files
    as written, under the launch counters; (c) the fig. 8 spec cut in
    seeds and epochs; (d) 2-seed groups of ``apcvfl`` and ``apcvfl_dp``
    replicated against sequential on the card; (e) Appendix F's
    ``train_encoder_with_probe`` on the card against the CPU."""
    import dataclasses
    import time
    import torch
    from repro_torch.core import autoencoder as ae
    from repro_torch.core import pipeline
    from repro_torch.experiments import ExperimentSpec, MethodSpec, sweep
    from repro_torch.kernels import ops
    log("=== phase 10: the experiment driver ===")
    specs_dir = os.path.join(ROOT, "examples", "specs")
    res = {}

    # (a) the smoke spec on the card and on the CPU
    card, cpu = (_experiment_cli(["--smoke", "--device", dev])
                 for dev in ("cuda", "cpu"))
    smoke = {"wall_s": card["wall_s"], "cpu_wall_s": cpu["wall_s"],
             "runs": len(card["payload"]["records"]), "held": {}}
    for rc, rp, r_card, r_cpu in zip(card["payload"]["records"],
                                     cpu["payload"]["records"],
                                     card["results"], cpu["results"]):
        name = rc["method"]
        _require(tuple(rc) == RECORD_KEYS and tuple(rp) == RECORD_KEYS,
                 (name, list(rc), list(rp)))
        for k in ("rounds", "comm_mb", "comm_total_bytes",
                  "comm_uplink_bytes", "comm_downlink_bytes",
                  "epochs_total", "z_dim"):
            _require(rc[k] == rp[k], (name, k, rc[k], rp[k]))
        smoke["held"][name] = _held(_summary(r_card), _summary(r_cpu),
                                    f"smoke {name}")
    res["smoke"] = smoke

    # (b) four spec files as written, under the launch counters
    ops.reset_launches()
    runs = {}
    for fname in EXPERIMENT_SPECS:
        before = dict(ops.LAUNCHES)
        out = _experiment_cli([os.path.join(specs_dir, fname),
                               "--device", "cuda"])
        records = out["payload"]["records"]
        _check_records(fname, records)
        runs[fname] = {
            "wall_s": out["wall_s"], "runs": len(records),
            "launches": {k: v - before[k] for k, v in ops.LAUNCHES.items()}}
        for r in records:
            if r["method"] == "apcvfl-int8":        # 1 byte an element
                want = r["n_aligned"] * 256 + 256 * 4
                _require(r["exchange_bytes"] == want, (r, want))
                runs[fname]["int8_exchange_bytes"] = r["exchange_bytes"]
            if "serve_parity_max_abs" in r:
                _require(r["serve_parity_max_abs"] <= TOL_SERVE_PARITY, r)
                runs[fname]["serve_parity_max_abs"] = \
                    r["serve_parity_max_abs"]
        log(f"{fname}: {len(records)} runs in {out['wall_s']:.1f} s, "
            f"launches {runs[fname]['launches']}")
    launches = dict(ops.LAUNCHES)
    _require(launches["lane_mlp_fwd"] > 0 and launches["lane_mlp_bwd"] > 0,
             ("the lane-MLP kernels never ran in phase 10 (b)", launches))
    _require(any("int8_exchange_bytes" in r for r in runs.values())
             and any("serve_parity_max_abs" in r for r in runs.values()),
             runs)
    res["specs"], res["launches"] = runs, launches

    # (c) the fig. 8 spec, cut only in depth
    with open(os.path.join(specs_dir, EXPERIMENT_CUT["spec"])) as fh:
        full = ExperimentSpec.from_json(fh.read())
    cut = dataclasses.replace(
        full, seeds=EXPERIMENT_CUT["seeds"],
        overrides={**full.overrides,
                   "max_epochs": EXPERIMENT_CUT["max_epochs"]})
    cut_note = (f"{EXPERIMENT_CUT['spec']} cut in depth only: seeds "
                f"{list(full.seeds)} -> {list(cut.seeds)}, max_epochs "
                f"{full.overrides.get('max_epochs')} -> "
                f"{EXPERIMENT_CUT['max_epochs']}; aligned "
                f"{list(cut.aligned)}, methods and dataset as written")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cut.json")
        with open(path, "w") as fh:
            fh.write(cut.to_json())
        out = _experiment_cli([path, "--device", "cuda"])
    _check_records("fig8 cut", out["payload"]["records"])
    res["fig8_cut"] = {"wall_s": out["wall_s"],
                       "runs": len(out["payload"]["records"]),
                       "cut": cut_note}
    log(f"{cut_note}: {res['fig8_cut']['runs']} runs in "
        f"{out['wall_s']:.1f} s")

    # (d) seed groups: replicated against sequential, on the card
    g = EXPERIMENT_GROUP
    group = ExperimentSpec(
        name="seed-groups", dataset=g["dataset"], aligned=(g["aligned"],),
        seeds=g["seeds"],
        methods=(MethodSpec("apcvfl"),
                 MethodSpec("apcvfl_dp", params={"sigma": g["sigma"]})),
        overrides={"max_epochs": g["max_epochs"]})
    t0 = time.perf_counter()
    rep = sweep(group, device="cuda")
    rep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = sweep(dataclasses.replace(group, replicate=False), device="cuda")
    seq_s = time.perf_counter() - t0
    held = []
    for r, q in zip(rep, seq):
        held.append(_held(_summary(r), _summary(q),
                          f"group {r.method} seed {r.seed} replicated vs "
                          f"sequential", last={}))
        if r.method == "apcvfl_dp":
            _require(torch.equal(r.artifacts["z_passive_aligned"],
                                 q.artifacts["z_passive_aligned"]),
                     f"seed {r.seed}: the replicated dp lane received "
                     f"other latents than its sequential run")
    res["groups"] = {"replicated_wall_s": rep_s, "sequential_wall_s": seq_s,
                     "held": held}

    # (e) Appendix F on the card and on the CPU, at the active party's
    # local encoder (g1_active's Table-3 widths) and, as a reading, at g3's
    sc = _scenario()
    x, y = sc.active.x, sc.active.y

    def probe_run(role, dev):
        t0 = time.perf_counter()
        out = pipeline.train_encoder_with_probe(
            x, y, sc.n_classes, ae.table3_encoder(role, x.shape[1]),
            max_epochs=EXPERIMENT_PROBE["epochs"], k=EXPERIMENT_PROBE["k"],
            device=dev)
        out["wall_s"] = time.perf_counter() - t0
        return out

    probe = {dev: probe_run(EXPERIMENT_PROBE["role"], dev)
             for dev in ("cuda", "cpu")}
    loss_err = _loss_rel_err({"g": probe["cuda"]["history"]["loss"]},
                             {"g": probe["cpu"]["history"]["loss"]})
    _require(_losses_agree(loss_err, {}), ("probe losses", loss_err))
    probe_gap = [abs(a - b) for a, b in zip(probe["cuda"]["history"]["probe"],
                                            probe["cpu"]["history"]["probe"])]
    probe_gap.append(abs(probe["cuda"]["metric_raw_x"]
                         - probe["cpu"]["metric_raw_x"]))
    _require(len(probe_gap) == EXPERIMENT_PROBE["epochs"] + 1
             and max(probe_gap) < TOL_METRIC, ("probe metrics", probe_gap))
    res["probe"] = {"role": EXPERIMENT_PROBE["role"],
                    "loss_rel_err": loss_err["g"], "metric_gap": probe_gap,
                    "wall_s": {d: probe[d]["wall_s"] for d in probe},
                    "gap": {d: probe[d]["gap"] for d in probe},
                    "g3_widths": probe_g3_reading(probe_run)}
    log(f"train_encoder_with_probe ({EXPERIMENT_PROBE['role']} widths) card "
        f"vs cpu: loss rel err {loss_err['g']}, probe gap {probe_gap}; at "
        f"g3's widths {res['probe']['g3_widths']}")
    return res


def _tenant_lines(report: dict) -> dict:
    """Per tenant: rows/s, queue and service p50/p99, SLO attainment, shed
    rate, dispatches and mean batch rows."""
    out = {}
    for name, t in report["tenants"].items():
        lat = t["latency_ms"]
        offered = t["requests"] + t["shed_requests"]
        out[name] = {
            "rows_per_s": t["rows_per_s"],
            "queue_ms_p50": lat["queue"]["p50"],
            "queue_ms_p99": lat["queue"]["p99"],
            "service_ms_p50": lat["service"]["p50"],
            "service_ms_p99": lat["service"]["p99"],
            "slo_attainment": t["slo"]["attainment"],
            "shed_rate": round(t["shed_requests"] / offered, 4)
            if offered else 0.0,
            "dispatches": t["dispatches"],
            "mean_batch_rows": t["mean_batch_rows"]}
    return out


def _timed_streams(sc, rt, arrivals: str, requests: int) -> list:
    tenants = ("fp32", "int8")
    return rt.merge_streams(*(
        rt.make_timed_stream(sc.active.x, sc.active.ids, requests,
                             tenant=name, arrivals=arrivals,
                             rate_rps=RUNTIME["rate_rps"], seed=21 + k,
                             max_rows=RUNTIME["max_rows"],
                             p_known=RUNTIME["p_known"])
        for k, name in enumerate(tenants)))


def _registry(rt, bundle, device: str):
    reg = rt.TenantRegistry(device=device)
    for name, q in (("fp32", None), ("int8", "int8")):
        reg.register(name, bundle, quantize=q)
    reg.warmup()
    return reg


def phase_runtime() -> dict:
    """The live multi-tenant runtime (``serve/runtime.py``) on phase 3's
    full-width bundle: (a) live Poisson and bursty streams on the card,
    measured service times; (b) every micro-batch replayed bit for bit by
    a solo engine; (c) the card against the CPU under a fixed service
    model: the same dispatch log and shed set, logits within TOL_ENGINE;
    (d) a fault plan through ``serve_vfl.main --arrival poisson --fault``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_vfl
    from repro_torch.serve import runtime as rt
    from repro_torch.serve.vfl import ModelBundle
    log("=== phase 11: the live runtime, two tenants (fp32, int8) on "
        "mimic3 ===")
    sc, bundle = make_bundle()
    res = {"launches": {k: 0 for k in ops.LAUNCHES}}
    reg = _registry(rt, bundle, CARD)
    bundles = {"fp32": bundle, "int8": bundle}
    smi = _smi()
    for arrivals in ("poisson", "bursty"):
        reg.reset_stats()
        stream = _timed_streams(sc, rt, arrivals, RUNTIME["requests"])
        runtime = rt.ServingRuntime(
            reg, rt.RuntimeConfig(slo_ms=RUNTIME["slo_ms"]))
        ops.reset_launches()
        report = runtime.run(stream)
        counts = dict(ops.LAUNCHES)
        _require(counts["lane_mlp_fwd"] > 0 and counts["int8_matmul"] > 0,
                 f"runtime {arrivals}: launches {counts}")
        _require(report["served"] + report["shed_requests"]
                 == 2 * RUNTIME["requests"], report["served"])
        for k, v in counts.items():
            res["launches"][k] += v
        parity = rt.verify_dispatch_parity(runtime, bundles)
        for name, p in parity.items():
            _require(p["batches"] > 0 and p["bit_identical"],
                     f"runtime {arrivals} {name}: replay {p}")
        lines = _tenant_lines(report)
        res[arrivals] = {"tenants": lines, "parity": parity,
                         "launches": counts,
                         "measured_wall_s": report["measured_wall_s"],
                         "virtual_elapsed_ms": report["virtual_elapsed_ms"],
                         "slo": report["slo"],
                         "shed_rate": report["shed_rate"]}
        log(f"runtime {arrivals} at {RUNTIME['rate_rps']} req/s a tenant, "
            f"SLO {RUNTIME['slo_ms']} ms ({smi}): {json.dumps(lines)}; "
            f"replay bit-identical {[p['batches'] for p in parity.values()]}"
            f" batches; launches {counts}")

    # (c) the card against the CPU under a fixed service model
    a, b = RUNTIME_CHECK["service_ms"]
    model = lambda rows: a + b * rows
    cfg = rt.RuntimeConfig(slo_ms=RUNTIME["slo_ms"],
                           max_queue_rows=RUNTIME_CHECK["queue_rows"])
    runs = {}
    for dev in (CARD, "cpu"):
        r = reg if dev == CARD else _registry(rt, bundle, "cpu")
        r.reset_stats()
        stream = _timed_streams(sc, rt, RUNTIME_CHECK["arrivals"],
                                RUNTIME["requests"])
        runtime = rt.ServingRuntime(r, cfg, service_model=model)
        report = runtime.run(stream)
        runs[dev] = (stream, runtime, report)
    log_of = lambda rtm: [(d.tenant, d.t_dispatch_ms,
                           [tr.req.rid for tr in d.group])
                          for d in rtm.dispatch_log]
    shed_of = lambda st: [(tr.tenant, tr.req.rid) for tr in st if tr.shed]
    _require(log_of(runs[CARD][1]) == log_of(runs["cpu"][1]),
             "card and cpu runtimes dispatched differently")
    _require(shed_of(runs[CARD][0]) == shed_of(runs["cpu"][0])
             and shed_of(runs["cpu"][0]),
             "card and cpu runtimes shed differently (or shed nothing)")
    err = max(float(np.abs(g.req.logits - w.req.logits).max())
              for g, w in zip(runs[CARD][0], runs["cpu"][0]) if not w.shed)
    _require(err <= TOL_ENGINE, f"runtime card vs cpu logits {err}")
    res["card_vs_cpu"] = {"dispatches": len(runs["cpu"][1].dispatch_log),
                          "shed": len(shed_of(runs["cpu"][0])),
                          "max_abs_logit_err": err}
    log(f"runtime card vs cpu (fixed service model, bursty, queue bound "
        f"{RUNTIME_CHECK['queue_rows']} rows): identical dispatch log "
        f"({res['card_vs_cpu']['dispatches']} dispatches) and shed set "
        f"({res['card_vs_cpu']['shed']}), max|dlogit| {err:.3e}")

    # (d) a fault plan through the CLI; the dispatches' paths are recorded
    # by a subclass of the runtime put in the CLI's way
    class Recorded(rt.ServingRuntime):
        runs = []

        def run(self, stream, **kw):
            paths = []
            for eng in self.registry.engines.values():
                def predict(x, ids=None, _e=eng, _real=eng.predict):
                    c0 = _e.stats.dispatches.get("collab", 0)
                    out = _real(x, ids)
                    paths.append(_e.stats.dispatches.get("collab", 0) > c0)
                    return out
                eng.predict = predict
            report = super().run(stream, **kw)
            Recorded.runs.append((self, paths))
            return report

    plan = os.path.join(ROOT, "examples", "faults", RUNTIME_FAULT["plan"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bundle")
        bundle.save(path)
        out = os.path.join(tmp, "fault.json")
        argv = ["--load", path, "--dataset", SCENARIO["dataset"],
                "--aligned", str(SCENARIO["aligned"]),
                "--active-features", str(SCENARIO["active_features"]),
                "--requests", str(RUNTIME_FAULT["requests"]),
                "--arrival", "poisson", "--fault", plan, "--out", out]
        real = serve_vfl.rt.ServingRuntime
        serve_vfl.rt.ServingRuntime = Recorded
        try:
            ops.reset_launches()
            rc = serve_vfl.main(argv)
            counts = dict(ops.LAUNCHES)
        finally:
            serve_vfl.rt.ServingRuntime = real
        _require(rc == 0, rc)
        with open(out) as fh:
            stats = json.load(fh)
    fb = stats["faults"]["tenants"]["default"]
    runtime, paths = Recorded.runs[-1]
    recovered = fb["recovered_at_ms"]
    after = [c for d, c in zip(runtime.dispatch_log, paths)
             if d.t_dispatch_ms >= recovered]
    _require(stats["faults"]["events_applied"] == 2
             and fb["collab_dispatches_while_faulted"] == 0
             and fb["cache_version"] == 2 and not fb["cache_stale"]
             and any(after), f"faults: {fb}, collab after recovery "
             f"{sum(after)}")
    _require(counts["lane_mlp_fwd"] > 0, f"fault run launches {counts}")
    for k, v in counts.items():
        res["launches"][k] += v
    res["fault"] = {"faults": stats["faults"], "launches": counts,
                    "collab_dispatches_after_recovery": int(sum(after)),
                    "slo": stats["slo"]}
    log(f"runtime fault plan {RUNTIME_FAULT['plan']}: {fb}; collab "
        f"dispatches after recovery {sum(after)} of {len(after)}")
    torch.cuda.synchronize()
    return res


def _l2_rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def _train_run(fns, params, state, batches: list, device: str) -> tuple:
    """Steps on ``device`` from copies of ``params``: (losses, grad norms,
    final params, launches during the steps)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_map
    p = tree_map(lambda t: t.to(device), params)
    s = tree_map(lambda t: t.to(device), state._asdict())
    s = type(state)(**s)
    losses, norms = [], []
    ops.reset_launches()
    for b in batches:
        p, s, m = fns.step(p, s, {k: v.to(device) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    counts = dict(ops.LAUNCHES)
    if device != "cpu":
        torch.cuda.synchronize()
    return losses, norms, p, counts


def _lm_batches(cfg, B: int, S: int, n: int, objective: str = "lm",
                seed: int = 0) -> list:
    import torch
    from repro_torch.data.tokens import batches
    rng = np.random.RandomState(seed + 100)
    out = []
    for b in batches(cfg.vocab_size, B, S, n, seed=seed):
        d = {"tokens": torch.from_numpy(b["tokens"])}
        if objective == "apcvfl_distill":
            d["z_teacher"] = torch.from_numpy(
                rng.randn(B, cfg.d_model).astype(np.float32))
            d["aligned"] = torch.from_numpy(
                (rng.rand(B) < 0.5).astype(np.float32))
        out.append(d)
    return out


def _param_errs(cfg, got, want) -> dict:
    """Each param leaf's relative L2 gap by name, and its ratio to the
    leaf's bound (TOL_TRAIN_PARAMS, or TOL_TRAIN_PARAMS_ZERO_INIT for a
    leaf the schema initialises to zeros)."""
    from repro_torch.models import model as M
    from repro_torch.sharding.policy import leaves

    def names(t, pre=""):
        if isinstance(t, dict):
            return [n for k in sorted(t) for n in names(t[k], f"{pre}/{k}")]
        return [pre]
    defs = leaves(M.schema(cfg))
    out = {}
    for n, d, g, w in zip(names(want), defs, leaves(got), leaves(want)):
        tol = (TOL_TRAIN_PARAMS_ZERO_INIT if d.init == "zeros"
               else TOL_TRAIN_PARAMS)
        e = _l2_rel(g, w)
        out[n] = {"l2_rel": e, "of_bound": e / tol}
    return out


def _held_training(what: str, cfg, card, cpu) -> dict:
    """Card against CPU: the first step's loss and grad norm within
    TOL_TRAIN_FIRST, every step's loss within TOL_TRAIN_LOSS, every param
    leaf within its bound in relative L2 (``_param_errs``)."""
    loss_err = [abs(g - w) / abs(w) for g, w in zip(card[0], cpu[0])]
    norm_err = [abs(g - w) / abs(w) for g, w in zip(card[1], cpu[1])]
    errs = _param_errs(cfg, card[2], cpu[2])
    worst = max(errs, key=lambda n: errs[n]["of_bound"])
    ok = (all(np.isfinite(card[0])) and loss_err[0] <= TOL_TRAIN_FIRST
          and norm_err[0] <= TOL_TRAIN_FIRST
          and max(loss_err) <= TOL_TRAIN_LOSS
          and errs[worst]["of_bound"] <= 1.0)
    r = {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
         "param_l2_rel_err": max(e["l2_rel"] for e in errs.values()),
         "worst_leaf": {worst: errs[worst]}, "losses": card[0]}
    log(f"train {what} card vs cpu: {r}")
    _require(ok, f"train {what}: {r}")
    return r


def train_limit_readings(cfg, fns_of, params, state, batches: list,
                         cpu) -> dict:
    """The readings that place TOL_TRAIN_PARAMS_ZERO_INIT: the CPU's own
    spread (the same steps at half the intra-op threads, other blockings
    of the same math) must pass every leaf's bound, and each planted
    fault (LM_TRAIN_FAULTS, run on the card) must fail some leaf's."""
    import torch
    from repro_torch.optim import schedule
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    try:
        spread = _train_run(fns_of(), params, state, batches, "cpu")
    finally:
        torch.set_num_threads(threads)
    real = schedule.value_and_grad

    def drop_d(loss_fn):
        vag = real(loss_fn)

        def f(p, b):
            out, g = vag(p, b)
            g["mamba"]["D"] = torch.zeros_like(g["mamba"]["D"])
            return out, g
        return f
    runs = {"cpu spread": spread,
            LM_TRAIN_FAULTS[0]: _train_run(fns_of(eps=1e-6), params, state,
                                           batches, CARD)}
    schedule.value_and_grad = drop_d
    try:
        runs[LM_TRAIN_FAULTS[1]] = _train_run(fns_of(), params, state,
                                              batches, CARD)
    finally:
        schedule.value_and_grad = real
    out = {}
    for name, run in runs.items():
        errs = _param_errs(cfg, run[2], cpu[2])
        worst = max(errs, key=lambda n: errs[n]["of_bound"])
        out[name] = {"worst_leaf": worst, **errs[worst],
                     "zero_init": {n: e["l2_rel"] for n, e in errs.items()
                                   if n.endswith("conv_b")}}
    log(f"train limit readings ({cfg.name}): {out}")
    _require(out["cpu spread"]["of_bound"] <= 1.0,
             f"the CPU's own spread exceeds the param bounds: {out}")
    for f in LM_TRAIN_FAULTS:
        _require(out[f]["of_bound"] > 1.0,
                 f"planted fault {f!r} within the param bounds: {out}")
    return out


def phase_lm_train() -> dict:
    """LM training (``train/loop.py``, ``launch/train.py``): (a) the full
    config on the card through ``launch/train.main`` (the steps on the
    training route, the eval passes through the flash kernel); (b)
    depth-cut fp32 copies at full width, card against CPU, with the eval
    pass (flash, and the SSD for zamba2) held too; (c) the smoke configs,
    ``apcvfl_distill`` and two micro-batches against one, card against
    CPU."""
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adam import AdamW
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.loop import make_train_step, task_loss
    log(f"=== phase 12: train {LM_TRAIN['arch']} at full width and depth "
        f"===")
    res = {"launches": {k: 0 for k in ops.LAUNCHES}}
    cfg = get_config(LM_TRAIN["arch"])
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "train.json")
        argv = ["--arch", LM_TRAIN["arch"], "--steps",
                str(LM_TRAIN["steps"]), "--batch", str(LM_TRAIN["batch"]),
                "--seq", str(LM_TRAIN["seq"]), "--log-every", "5",
                "--out", out]
        torch.cuda.empty_cache()
        rc = train_cli.main(argv)
        _require(rc == 0, rc)
        with open(out) as fh:
            rec = json.load(fh)
    L = cfg.n_layers
    la = rec["launches"]
    _require(all(np.isfinite(rec["losses"])) and rec["improved"]
             and rec["eval_after"] < rec["eval_before"], rec)
    _require(la["eval_before"]["flash_attention"] == L
             and la["eval_after"]["flash_attention"] == L, la)
    _require(all(v == 0 for v in la["steps"].values()),
             f"kernels launched inside the steps: {la['steps']}")
    for part in la.values():
        for k, v in part.items():
            res["launches"][k] += v
    warm = rec["step_s"][1:]
    tokens = LM_TRAIN["batch"] * LM_TRAIN["seq"]
    smi = _smi()
    res["full"] = {
        "arch": LM_TRAIN["arch"], "dtype": cfg.dtype, "layers": L,
        "batch": LM_TRAIN["batch"], "seq": LM_TRAIN["seq"],
        "losses": rec["losses"], "eval_before": rec["eval_before"],
        "eval_after": rec["eval_after"], "step_ms": [s * 1e3 for s in
                                                     rec["step_s"]],
        "step_ms_p50": float(np.median(warm)) * 1e3,
        "tokens_per_s": tokens / float(np.median(warm)),
        "peak_bytes": rec["peak_bytes"], "launches": la}
    f = res["full"]
    log(f"train {LM_TRAIN['arch']} (bf16, B {LM_TRAIN['batch']}, S "
        f"{LM_TRAIN['seq']}, {LM_TRAIN['steps']} steps; {smi}): step "
        f"{f['step_ms_p50']:.1f} ms p50 after the first "
        f"({f['step_ms'][0]:.1f}), {f['tokens_per_s']:.0f} tokens/s, peak "
        f"{(f['peak_bytes'] or 0) / 2**30:.2f} GiB; eval {rec['eval_before']:.4f} "
        f"-> {rec['eval_after']:.4f}; launches {la}")
    torch.cuda.empty_cache()

    # (b) depth-cut fp32 copies at full width, card against CPU
    res["check"] = {}
    for arch, c in LM_TRAIN_CHECK.items():
        cfg = get_config(arch).with_(n_layers=c["layers"], dtype="float32")
        fns_of = lambda **kw: make_train_step(
            cfg, AdamW(lr=LM_TRAIN_LR[0], **kw),
            lr_schedule=warmup_cosine(*LM_TRAIN_LR))
        fns = fns_of()
        params, state = fns.init(torch.Generator().manual_seed(0))
        batches = _lm_batches(cfg, c["batch"], c["seq"], c["steps"])
        card = _train_run(fns, params, state, batches, CARD)
        _require(all(v == 0 for v in card[3].values()),
                 f"{arch}: kernels launched inside the steps: {card[3]}")
        cpu = _train_run(fns, params, state, batches, "cpu")
        r = _held_training(f"{arch} x{c['layers']} layers", cfg, card, cpu)
        if cfg.family == "hybrid":
            r["limit_readings"] = train_limit_readings(
                cfg, fns_of, params, state, batches, cpu)
        # the eval pass on the trained params: the kernels on the card
        ev = _lm_batches(cfg, c["batch"], c["seq"], 1, seed=1234)[0]
        ops.reset_launches()
        with torch.no_grad():
            e_card = float(task_loss(card[2], cfg, {
                k: v.to(CARD) for k, v in ev.items()})[0])
        counts = dict(ops.LAUNCHES)
        with torch.no_grad():
            e_cpu = float(task_loss(cpu[2], cfg, ev)[0])
        n_attn = (cfg.n_layers if cfg.family == "dense"
                  else cfg.n_layers // cfg.attn_period)
        n_ssd = cfg.n_layers if cfg.family == "hybrid" else 0
        _require(counts["flash_attention"] == n_attn
                 and counts["ssd_intra_chunk"] == n_ssd,
                 f"{arch} eval launches {counts}")
        e_err = abs(e_card - e_cpu) / abs(e_cpu)
        _require(e_err <= TOL_TRAIN_LOSS, f"{arch} eval {e_card} {e_cpu}")
        for k, v in counts.items():
            res["launches"][k] += v
        r.update(eval_rel_err=e_err, eval_launches=counts, **c)
        res["check"][arch] = r
        del card, cpu, params, state
        torch.cuda.empty_cache()

    # (c) the smoke configs: each objective and micro-batch count
    res["smoke"] = {}
    for arch in LM_TRAIN_CHECK:
        cfg = get_smoke(arch)
        for objective in ("lm", "apcvfl_distill"):
            batches = _lm_batches(cfg, 4, 64, 1, objective)
            runs = {}
            for n_micro in (1, 2):
                fns = make_train_step(cfg, AdamW(), objective=objective,
                                      n_micro=n_micro)
                params, state = fns.init(torch.Generator().manual_seed(0))
                card = _train_run(fns, params, state, batches, CARD)
                cpu = _train_run(fns, params, state, batches, "cpu")
                key = f"{arch}/{objective}/n_micro={n_micro}"
                res["smoke"][key] = _held_training(key, cfg, card, cpu)
                runs[n_micro] = card
            if objective == "lm":
                e = abs(runs[2][0][0] - runs[1][0][0]) / abs(runs[1][0][0])
                _require(e <= TOL_TRAIN_FIRST,
                         f"{arch}: n_micro 2 vs 1 loss {e}")
                res["smoke"][f"{arch}/lm/micro_vs_whole"] = e
    torch.cuda.synchronize()
    return res


def phase_moe_audio() -> dict:
    """The MoE decoder and the audio encoder (phase 13): (a) the MoE cell
    through the CLI, ``prefill_step`` and a profiled decode, the card's
    time split by the program's spans MOE_RANGES (``serve_cell``; the
    ``block.attention`` span holds the decode's cache write, as the
    ``attn.decode_attention`` range before it did); (b) depth 2 against
    the CPU; (c) decode against forward; (d) hubert; (e) training."""
    import torch
    log(f"=== phase 13: serve {MOE['arch']} at full width and depth ===")
    res = serve_cell(MOE, MOE_PREFILL, MOE_RANGES)
    res["check"] = lm_card_vs_cpu(MOE, MOE_CHECK)
    torch.cuda.empty_cache()
    res["decode_vs_forward"] = moe_decode_vs_forward()
    torch.cuda.empty_cache()
    res["hubert"] = hubert_encoder(res["launches"])
    torch.cuda.empty_cache()
    res["train"] = moe_audio_train(res["launches"])
    return res


def moe_decode_vs_forward() -> dict:
    """The MoE cell's config at depth 2 in fp32 with ``capacity_factor =
    E / k`` (no entry dropped, so decode and forward route alike), on the
    card: ``MOE_DECODE_VS_FORWARD["steps"]`` decode steps from an empty
    cache against the full forward within TOL_DECODE_VS_FORWARD x
    max|logit|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_config(MOE["arch"])
    cfg = cfg.with_(n_layers=MOE_CHECK["layers"], dtype="float32",
                    use_flash_kernel=True,
                    capacity_factor=cfg.n_experts / cfg.experts_per_token)
    B, T = MOE_DECODE_VS_FORWARD["batch"], MOE_DECODE_VS_FORWARD["steps"]
    params = serve.build_params(cfg, device=CARD, seed=2)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (B, T)).astype(np.int32)).to(CARD)
    ops.reset_launches()
    with torch.no_grad():
        full, _ = M.logits(params, cfg, {"tokens": toks})
        cache = M.init_cache(params, cfg, B, T)
        errs = []
        for t in range(T):
            lg, cache = M.decode(params, cfg, toks[:, t], cache, t)
            errs.append(float((lg - full[:, t]).abs().max()
                              / full.abs().max()))
    counts = dict(ops.LAUNCHES)
    log(f"moe decode vs forward on the card ({T} steps, capacity factor "
        f"{cfg.capacity_factor}): max|d| / max|logit| {errs} (launches "
        f"{counts})")
    _require(counts["flash_attention"] == cfg.n_layers
             and counts["decode_attention"] == cfg.n_layers * T, counts)
    _require(max(errs) <= TOL_DECODE_VS_FORWARD, errs)
    return {"steps": T, "rel_err": errs, "max_rel_err": max(errs)}


def hubert_encoder(launches: dict) -> dict:
    """hubert-xlarge at full width and depth in bf16: ``M.logits`` on
    HUBERT's frames twice (one non-causal flash launch a layer a call; the
    second call's wall is the warm one), with the peak memory; then depth
    2 in fp32, weights made once on the CPU: the card's logits within
    TOL_LM x max|logit| of the CPU's."""
    import time
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    h = HUBERT
    cfg = get_config(h["arch"])
    log(f"--- phase 13 (d): {h['arch']} at full width and depth, bf16")
    params = serve.build_params(cfg, device=CARD)
    gen = torch.Generator(device=CARD).manual_seed(4)
    frames = torch.randn((h["batch"], h["frames"], cfg.d_model),
                         generator=gen, device=CARD).to(torch.bfloat16)
    walls = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for _ in range(2):                 # the first call also warms cuBLAS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            lg, aux = M.logits(params, cfg, {"frames": frames})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = dict(ops.LAUNCHES)
    _require(tuple(lg.shape) == (h["batch"], h["frames"], cfg.vocab_size)
             and lg.dtype == torch.bfloat16
             and bool(torch.isfinite(lg).all()) and float(aux) == 0.0,
             (tuple(lg.shape), lg.dtype))
    _require(counts["flash_attention"] == 2 * cfg.n_layers
             and sum(counts.values()) == 2 * cfg.n_layers, counts)
    for k, v in counts.items():
        launches[k] += v
    out = {"B": h["batch"], "S": h["frames"], "ms": walls,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": counts}
    del params, frames, lg
    torch.cuda.empty_cache()
    log(f"hubert logits B={h['batch']} S={h['frames']} ({_smi()}): {walls} "
        f"ms, peak {out['peak_bytes'] / 2**30:.2f} GiB (launches {counts})")

    cfg = cfg.with_(n_layers=h["check_layers"], dtype="float32")
    cpu = serve.build_params(cfg, device="cpu")
    frames = torch.from_numpy(np.random.RandomState(5).randn(
        h["check_batch"], h["frames"], cfg.d_model).astype(np.float32))
    with torch.no_grad():
        want, _ = M.logits(cpu, cfg, {"frames": frames})
        got, _ = M.logits(tree_map(lambda t: t.to(CARD), cpu), cfg,
                          {"frames": frames.to(CARD)})
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    log(f"hubert depth {h['check_layers']} fp32, card vs cpu: max|d| / "
        f"max|logit| {rel}")
    _require(rel <= TOL_LM, rel)
    out["check"] = {"layers": h["check_layers"], "B": h["check_batch"],
                    "logit_rel_err": rel}
    return out


def _frame_batches(cfg, B: int, S: int, n: int, seed: int = 0) -> list:
    """hubert's frame objective: frames and a label a frame, from numpy."""
    import torch
    rng = np.random.RandomState(seed + 200)
    return [{"frames": torch.from_numpy(rng.randn(B, S, cfg.d_model).astype(
        np.float32)), "labels": torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (B, S)).astype(np.int32))} for _ in range(n)]


def moe_audio_train(launches: dict) -> dict:
    """(e) qwen3-moe-30b-a3b at full width and depth 2 in bf16 through
    ``launch/train.main``: every loss and aux finite, the eval loss falls,
    no kernel inside the steps (the training route), flash once a layer in
    each no-grad eval pass; then one AdamW step of each smoke config (the
    token stream; hubert's frame CE) on the card against the CPU from the
    same weights (``_held_training``)."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adam import AdamW
    from repro_torch.train.loop import make_train_step
    t = MOE_TRAIN
    log(f"--- phase 13 (e): train {t['arch']} at full width, depth "
        f"{t['layers']}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "train.json")
        argv = ["--arch", t["arch"], "--layers", str(t["layers"]),
                "--steps", str(t["steps"]), "--batch", str(t["batch"]),
                "--seq", str(t["seq"]), "--log-every", "5", "--device",
                CARD, "--out", out]
        rc = train_cli.main(argv)
        _require(rc == 0, rc)
        with open(out) as fh:
            rec = json.load(fh)
    la = rec["launches"]
    _require(rec["n_layers"] == t["layers"] and rec["dtype"] == "bfloat16",
             rec)
    _require(all(np.isfinite(rec["losses"])) and all(np.isfinite(rec["aux"]))
             and rec["improved"] and rec["eval_after"] < rec["eval_before"],
             rec)
    _require(la["eval_before"]["flash_attention"] == t["layers"]
             and la["eval_after"]["flash_attention"] == t["layers"], la)
    _require(all(v == 0 for v in la["steps"].values()),
             f"kernels launched inside the steps: {la['steps']}")
    for part in la.values():
        for k, v in part.items():
            launches[k] += v
    warm = rec["step_s"][1:]
    res = {"full": {
        "arch": t["arch"], "layers": t["layers"], "batch": t["batch"],
        "seq": t["seq"], "losses": rec["losses"], "aux": rec["aux"],
        "eval_before": rec["eval_before"], "eval_after": rec["eval_after"],
        "step_ms": [x * 1e3 for x in rec["step_s"]],
        "step_ms_p50": float(np.median(warm)) * 1e3,
        "tokens_per_s": t["batch"] * t["seq"] / float(np.median(warm)),
        "peak_bytes": rec["peak_bytes"], "launches": la}}
    f = res["full"]
    log(f"train {t['arch']} x{t['layers']} layers (bf16; {_smi()}): step "
        f"{f['step_ms_p50']:.1f} ms p50 after the first "
        f"({f['step_ms'][0]:.1f}), peak "
        f"{(f['peak_bytes'] or 0) / 2**30:.2f} GiB; eval "
        f"{rec['eval_before']:.4f} -> {rec['eval_after']:.4f}; aux "
        f"{rec['aux'][0]:.4f} -> {rec['aux'][-1]:.4f}")
    torch.cuda.empty_cache()
    res["smoke"] = {}
    for arch in MOE_TRAIN_SMOKES:
        cfg = get_smoke(arch)
        batches = (_frame_batches(cfg, 4, 64, 1) if cfg.family == "audio"
                   else _lm_batches(cfg, 4, 64, 1))
        fns = make_train_step(cfg, AdamW())
        params, state = fns.init(torch.Generator().manual_seed(0))
        card = _train_run(fns, params, state, batches, CARD)
        _require(all(v == 0 for v in card[3].values()), (arch, card[3]))
        cpu = _train_run(fns, params, state, batches, "cpu")
        res["smoke"][arch] = _held_training(f"{arch} smoke", cfg, card, cpu)
    return res


# ---------------------------------------------------------------------------
# phase 14: the VLM
# ---------------------------------------------------------------------------

def _vlm_gates(params, seed: int) -> list:
    """Set each group's cross gate, in place, to a value drawn from
    ``seed``: |gate| in [0.3, 1.2], either sign.  The schema starts the
    gates at 0, where ``tanh(0)`` leaves the cross blocks out of every
    comparison.  Returns the values."""
    import torch
    gate = params["groups"]["cross"]["gate"]
    rng = np.random.RandomState(seed)
    g = (rng.uniform(0.3, 1.2, tuple(gate.shape))
         * rng.choice([-1.0, 1.0], tuple(gate.shape))).astype(np.float32)
    gate.copy_(torch.from_numpy(g))
    return g.reshape(-1).tolist()


def _vlm_image(seed: int, B: int, cfg):
    """Projected image embeddings (B, n_image_tokens, d_model), fp32, normal
    from a numpy seed (the vision tower is a stub in the reference too)."""
    import torch
    return torch.from_numpy(np.random.RandomState(seed).randn(
        B, cfg.n_image_tokens, cfg.d_model).astype(np.float32))


@contextlib.contextmanager
def _attention_kinds(tally: dict):
    """Count each call of the attention wrappers by kind into ``tally``:
    flash ``causal`` or ``cross`` (keys of their own, no mask), decode
    ``self`` or ``image`` (the VLM's image K/V: VLM_IMAGE_TOKENS slots).
    The wrappers themselves still count the launches."""
    from repro_torch.kernels import ops
    flash, decode = ops.flash_attention, ops.decode_attention

    def counted_flash(q, k, v, **kw):
        kind = "flash causal" if kw.get("causal", True) else (
            "flash cross" if k.shape[1] != q.shape[1] else "flash full")
        tally[kind] = tally.get(kind, 0) + 1
        return flash(q, k, v, **kw)

    def counted_decode(q, k, *a, **kw):
        kind = ("decode image" if k.shape[1] == VLM_IMAGE_TOKENS
                else "decode self")
        tally[kind] = tally.get(kind, 0) + 1
        return decode(q, k, *a, **kw)
    ops.flash_attention, ops.decode_attention = counted_flash, counted_decode
    try:
        yield tally
    finally:
        ops.flash_attention, ops.decode_attention = flash, decode


def phase_vlm() -> dict:
    """The VLM (phase 14): (a) llama-3.2-vision-11b at full width and depth
    in bf16 with nonzero gates: ``prefill_step`` at B 2, S 2048 against
    1600 image tokens (40 flash launches a call: 32 causal, 8 cross) and
    greedy decode through ``make_decode_step`` from
    ``M.init_cache(image_embeds=)`` (40 decode launches a step: 32 self, 8
    image), each profiled; (b) one group in fp32 against the CPU and the
    zeroed image; (c) decode against forward; (d) training."""
    import time
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve.decode import prefill_step
    from repro_torch.sharding.policy import leaves
    log(f"=== phase 14: serve {VLM['arch']} at full width and depth ===")
    cfg = get_config(VLM["arch"])
    L, G = cfg.n_layers, cfg.n_layers // cfg.cross_attn_period
    _require(cfg.n_image_tokens == VLM_IMAGE_TOKENS, cfg.n_image_tokens)
    smi = _smi()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = serve.build_params(cfg, device=CARD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gates = _vlm_gates(params, 0)
    n_params = sum(t.numel() for t in leaves(params))
    res = {"n_params": n_params, "init_s": init_s, "gates": gates,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in leaves(params)),
           "launches": {k: 0 for k in ops.LAUNCHES}}
    log(f"vlm init ({smi}): {init_s:.2f} s for {n_params} params "
        f"({res['param_bytes'] / 2**30:.2f} GiB); every gate nonzero, drawn "
        f"from seed 0: {gates}")
    _require(n_params == M.count_params_analytic(cfg)
             and all(g != 0.0 for g in gates), (n_params, gates))

    B, S = VLM["prefill"]
    inputs = {"tokens": _tokens(1, B, S, cfg.vocab_size).to(CARD),
              "image_embeds": _vlm_image(1, B, cfg).to(CARD)}
    per_prefill = {k: 0 for k in ops.LAUNCHES}
    per_prefill["flash_attention"] = L
    kinds_want = {"flash causal": L - G, "flash cross": G}
    walls = []
    with torch.no_grad():
        for _ in range(1 + VLM["prefill_calls"]):     # the first warms up
            torch.cuda.synchronize()
            ops.reset_launches()
            with _attention_kinds({}) as kinds:
                t0 = time.perf_counter()
                lg = prefill_step(params, cfg, inputs)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            counts = dict(ops.LAUNCHES)
            _require(counts == per_prefill and kinds == kinds_want,
                     (counts, kinds))
            for k, v in counts.items():
                res["launches"][k] += v
        _require(tuple(lg.shape) == (B, cfg.vocab_size) and lg.dtype
                 == torch.bfloat16 and bool(torch.isfinite(lg).all()),
                 (tuple(lg.shape), lg.dtype))
        prof = _profiled(lambda: prefill_step(params, cfg, inputs), 1)
    res["prefill_step"] = {"B": B, "S": S, "T": cfg.n_image_tokens,
                           "ms": walls,
                           "ms_p50_warm": float(np.median(walls[1:])),
                           "launches_per_call": counts,
                           "kinds_per_call": kinds, "profile": prof}
    log(f"vlm prefill_step B={B} S={S} T={cfg.n_image_tokens}: {walls} ms, "
        f"launches per call {counts} ({kinds}); profile {prof}")
    del lg, inputs

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = M.init_cache(params, cfg, VLM["batch"], VLM["slots"],
                             image_embeds=_vlm_image(2, VLM["batch"],
                                                     cfg).to(CARD))
        torch.cuda.synchronize()
        cache_ms = (time.perf_counter() - t0) * 1e3
    res["decode"] = _lockstep_decode(
        params, cfg, cache, VLM, L,
        kinds={"decode self": L - G, "decode image": G})
    res["decode"]["init_cache_ms"] = cache_ms
    del cache
    for k, v in res["decode"]["launches"].items():
        res["launches"][k] += v
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"vlm decode ({smi}): {res['decode']}; peak "
        f"{res['peak_bytes'] / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    res["check"] = vlm_checks()
    torch.cuda.empty_cache()
    res["train"] = vlm_train(res["launches"])
    return res


def vlm_checks() -> dict:
    """(b) llama-3.2-vision-11b at full width with one group (4 self blocks
    and the cross block) in fp32, nonzero gates, weights made once on the
    CPU and copied to the card: ``prefill_step`` at B 2, S 128 and 8 greedy
    decode steps from ``init_cache(image_embeds=)`` on the card and the CPU
    give identical tokens and logits within TOL_LM x max|logit|; the same
    prefill with the image zeroed moves the card's logits by more than
    10 x TOL_LM (the cross path is live).  (c) On the card, 64 decode
    steps against the full forward within TOL_DECODE_VS_FORWARD x
    max|logit|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve.decode import prefill_step
    from repro_torch.tree import tree_map
    c = VLM_CHECK
    cfg = get_config(VLM["arch"]).with_(n_layers=c["layers"],
                                        dtype="float32")
    L = cfg.n_layers
    cpu = serve.build_params(cfg, seed=1, device="cpu")
    gates = _vlm_gates(cpu, 1)
    card = tree_map(lambda t: t.to(CARD), cpu)
    B, S = c["prefill"]
    toks, img = _tokens(3, B, S, cfg.vocab_size), _vlm_image(3, B, cfg)
    what = f"vlm depth-{L} fp32 (gates {gates})"
    ops.reset_launches()
    runs = {dev: _prefill_then_decode(p, cfg, {"tokens": toks.to(dev),
                                               "image_embeds": img.to(dev)},
                                      c["steps"])
            for dev, p in ((CARD, card), ("cpu", cpu))}
    counts = dict(ops.LAUNCHES)
    _require(counts["flash_attention"] == L
             and counts["decode_attention"] == L * c["steps"], counts)
    rel = _held_logits(runs[CARD], runs["cpu"], what)
    with torch.no_grad():
        zeroed = prefill_step(card, cfg, {
            "tokens": toks.to(CARD),
            "image_embeds": torch.zeros_like(img).to(CARD)}).cpu()
    moved = float((zeroed - runs[CARD][0]).abs().max()
                  / runs[CARD][0].abs().max())
    log(f"{what}: the image zeroed moves the card's prefill logits by "
        f"{moved:.3e}")
    _require(moved > 10 * TOL_LM, moved)
    del cpu

    Bv, T = c["dvf"]
    ops.reset_launches()
    dvf = _decode_vs_forward(card, cfg, {
        "tokens": _tokens(4, Bv, T, cfg.vocab_size).to(CARD),
        "image_embeds": _vlm_image(4, Bv, cfg).to(CARD)}, f"vlm depth-{L}")
    dvf_counts = dict(ops.LAUNCHES)
    _require(dvf_counts["flash_attention"] == L
             and dvf_counts["decode_attention"] == L * T, dvf_counts)
    return dict(dvf, layers=L, gates=gates, logit_rel_err=rel,
                max_logit_rel_err=max(rel), tokens_identical=True,
                zeroed_image_moves=moved, launches=counts,
                decode_vs_forward_launches=dvf_counts)


def vlm_train(launches: dict) -> dict:
    """(d) llama-3.2-vision-11b at full width, one group (4 self blocks and
    the cross block), bf16 through ``launch/train.main --layers 5`` (zero
    images, as the reference's CLI): every loss finite, the eval loss
    falls, flash once a block in each no-grad eval pass and no kernel
    inside the steps; then one AdamW step of the smoke config with nonzero
    gates and images on the card against the CPU (``_held_training``)."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adam import AdamW
    from repro_torch.train.loop import make_train_step
    t = VLM_TRAIN
    log(f"--- phase 14 (d): train {VLM['arch']} at full width, depth "
        f"{t['layers']}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "train.json")
        argv = ["--arch", VLM["arch"], "--layers", str(t["layers"]),
                "--steps", str(t["steps"]), "--batch", str(t["batch"]),
                "--seq", str(t["seq"]), "--log-every", "5", "--device",
                CARD, "--out", out]
        rc = train_cli.main(argv)
        _require(rc == 0, rc)
        with open(out) as fh:
            rec = json.load(fh)
    la = rec["launches"]
    _require(rec["n_layers"] == t["layers"] and rec["dtype"] == "bfloat16",
             rec)
    _require(all(np.isfinite(rec["losses"])) and rec["improved"]
             and rec["eval_after"] < rec["eval_before"], rec)
    _require(la["eval_before"]["flash_attention"] == t["layers"]
             and la["eval_after"]["flash_attention"] == t["layers"], la)
    _require(all(v == 0 for v in la["steps"].values()),
             f"kernels launched inside the steps: {la['steps']}")
    for part in la.values():
        for k, v in part.items():
            launches[k] += v
    warm = rec["step_s"][1:]
    res = {"full": {
        "arch": VLM["arch"], "layers": t["layers"], "batch": t["batch"],
        "seq": t["seq"], "losses": rec["losses"],
        "eval_before": rec["eval_before"], "eval_after": rec["eval_after"],
        "step_ms": [x * 1e3 for x in rec["step_s"]],
        "step_ms_p50": float(np.median(warm)) * 1e3,
        "tokens_per_s": t["batch"] * t["seq"] / float(np.median(warm)),
        "peak_bytes": rec["peak_bytes"], "launches": la}}
    f = res["full"]
    log(f"train {VLM['arch']} x{t['layers']} layers (bf16; {_smi()}): step "
        f"{f['step_ms_p50']:.1f} ms p50 after the first "
        f"({f['step_ms'][0]:.1f}), {f['tokens_per_s']:.0f} tokens/s, peak "
        f"{(f['peak_bytes'] or 0) / 2**30:.2f} GiB; eval "
        f"{rec['eval_before']:.4f} -> {rec['eval_after']:.4f}")
    torch.cuda.empty_cache()
    cfg = get_smoke(VLM["arch"])
    fns = make_train_step(cfg, AdamW())
    params, state = fns.init(torch.Generator().manual_seed(0))
    _vlm_gates(params, 5)
    batches = _lm_batches(cfg, 4, 64, 1)
    batches[0]["image_embeds"] = _vlm_image(5, 4, cfg)
    card = _train_run(fns, params, state, batches, CARD)
    _require(all(v == 0 for v in card[3].values()), card[3])
    cpu = _train_run(fns, params, state, batches, "cpu")
    res["smoke"] = _held_training(f"{VLM['arch']} smoke", cfg, card, cpu)
    return res



def _xlstm_gates(params, seed: int) -> dict:
    """Set the gates, in place, from a numpy seed: mLSTM ``w_if`` N(0,
    0.01) (the init's scale, redrawn), ``b_i`` U(-0.5, 0.5) and ``b_f``
    U(0.5, 3) (the init's are 0 and 1 everywhere, where a wrong gate bias
    passes unseen), and the sLSTM bias ``b`` N(0, 0.5) (init 0).  Wider
    gates make this random model ill-conditioned at full width: with
    ``w_if`` N(0, 0.05) and ``b_i`` U(-1, 1) the fp32 decode and forward of
    the same tokens differ by 0.131 x max|logit| on the CPU at 24 layers
    (2.907e-4 at these; ``tools/xlstm_conditioning.py``), as they would on
    any device."""
    import torch
    rng = np.random.RandomState(seed)
    ml, sl = params["groups"]["mlstms"], params["groups"]["slstm"]
    draws = {"w_if": (ml["w_if"], lambda n: rng.randn(*n) * 0.01),
             "b_i": (ml["b_i"], lambda n: rng.uniform(-0.5, 0.5, n)),
             "b_f": (ml["b_f"], lambda n: rng.uniform(0.5, 3, n)),
             "b": (sl["b"], lambda n: rng.randn(*n) * 0.5)}
    for t, draw in draws.values():
        t.copy_(torch.from_numpy(draw(tuple(t.shape)).astype(np.float32)))
    return {k: float(t.abs().max()) for k, (t, _) in draws.items()}


@contextlib.contextmanager
def _xlstm_blocks(synced: bool):
    """Time the xLSTM's two block kinds in one call, summed by kind into
    the yielded dict: with ``synced``, each block's host wall, synchronised
    before and after (``wall_ms``); else each block's span on the card
    between two CUDA events, no sync (``device_span_ms``, read on exit)."""
    import time
    import torch
    from repro_torch.models import xlstm
    orig = {"mlstm": xlstm.mlstm_block, "slstm": xlstm.slstm_block}
    out, pairs = {}, []

    def wrap(kind, fn):
        def block(p, cfg, x):
            if not synced:
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                y = fn(p, cfg, x)
                ev[1].record()
                pairs.append((kind, ev))
                return y
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(p, cfg, x)
            torch.cuda.synchronize()
            out[kind] = out.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3
            return y
        return block
    xlstm.mlstm_block = wrap("mlstm", orig["mlstm"])
    xlstm.slstm_block = wrap("slstm", orig["slstm"])
    try:
        yield out
        torch.cuda.synchronize()
        for kind, (a, b) in pairs:
            out[kind] = out.get(kind, 0.0) + a.elapsed_time(b)
    finally:
        xlstm.mlstm_block, xlstm.slstm_block = orig["mlstm"], orig["slstm"]


def _gemm_or_other(name: str) -> str:
    low = name.lower()
    return "gemm" if any(t in low for t in GEMM_NAMES) else "other"


def _busy(fn, kind_of=_gemm_or_other, kinds=("gemm", "other")) -> dict:
    """One call of ``fn`` under the profiler, read from its raw events (a
    prefill's ~360k events are too many for ``_profiled``'s event tree):
    the host wall, the card's busy time and launches by kind
    (``kind_of(kernel name)``, one of ``kinds``: by default GEMMs and the
    rest) and its share of the wall."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms = dict.fromkeys(kinds, 0.0)
    launches = dict.fromkeys(kinds, 0)
    for e in prof.profiler.kineto_results.events():
        # a span's range on the device timeline is no operation
        note = getattr(e, "is_user_annotation", None)
        if e.device_type() != torch.autograd.DeviceType.CUDA or (
                note is not None and note()):
            continue
        kind = kind_of(e.name())
        ms[kind] += (e.end_ns() - e.start_ns()) / 1e6
        launches[kind] += 1
    return {"wall_ms_profiled": wall_ms, "device_ms": ms,
            "device_events": sum(launches.values()),
            "device_launches": launches,
            "device_busy_share": sum(ms.values()) / wall_ms}


def phase_xlstm() -> dict:
    """The xLSTM (phase 15): (a) xlstm-350m at full width and depth in
    bf16, the schema's init: ``prefill_step`` at B 2, S 2048, its host wall
    split by block kind, the card's span by block kind and one call's busy
    share, and greedy decode through ``make_decode_step`` from
    ``init_cache`` at B 8 (16 prompt tokens fed through decode steps, then
    48 generated), profiled;
    no kernel launches on either path; then the same tokens at full depth
    in fp32, gates drawn away from their init, through decode steps
    against the forward and ``prefill_step`` on the prompt
    (``_xlstm_fp32_vs_forward``); (b) one group at full width in fp32
    against the CPU, and decode against forward on the card
    (``xlstm_checks``); (c) training (``xlstm_train``)."""
    import time
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve.decode import prefill_step
    from repro_torch.sharding.policy import leaves
    log(f"=== phase 15: serve and train {XLSTM['arch']} at full width and "
        f"depth ===")
    cfg = get_config(XLSTM["arch"])
    smi = _smi()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = serve.build_params(cfg, device=CARD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    none = {k: 0 for k in ops.LAUNCHES}
    res = {"n_params": n_params, "init_s": init_s,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in leaves(params)),
           "launches": dict(none)}
    log(f"xlstm init ({smi}): {init_s:.2f} s for {n_params} params "
        f"({res['param_bytes'] / 2**30:.2f} GiB)")
    _require(n_params == M.count_params_analytic(cfg) == XLSTM_PARAMS,
             n_params)

    B, S = XLSTM["prefill"]
    inputs = {"tokens": _tokens(1, B, S, cfg.vocab_size).to(CARD)}
    walls = []
    with torch.no_grad():
        for _ in range(1 + XLSTM["prefill_calls"]):    # the first warms up
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            lg = prefill_step(params, cfg, inputs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            _require(dict(ops.LAUNCHES) == none, dict(ops.LAUNCHES))
        _require(tuple(lg.shape) == (B, cfg.vocab_size) and lg.dtype
                 == torch.bfloat16 and bool(torch.isfinite(lg).all()),
                 (tuple(lg.shape), lg.dtype))
        with _xlstm_blocks(synced=True) as split:
            t0 = time.perf_counter()
            prefill_step(params, cfg, inputs)
            torch.cuda.synchronize()
            split_wall = (time.perf_counter() - t0) * 1e3
        with _xlstm_blocks(synced=False) as spans:
            prefill_step(params, cfg, inputs)
        prof = _busy(lambda: prefill_step(params, cfg, inputs))
    warm = float(np.median(walls[1:]))
    res["prefill_step"] = {
        "B": B, "S": S, "ms": walls, "ms_p50_warm": warm,
        "wall_ms_by_block_synced": split, "wall_ms_synced": split_wall,
        "slstm_share_of_wall": split["slstm"] / split_wall,
        "device_span_ms_by_block": spans, "profile": prof}
    log(f"xlstm prefill_step B={B} S={S} ({smi}): {walls} ms; host wall by "
        f"block kind, each block synchronised: {split} of {split_wall:.1f} "
        f"ms (sLSTM {split['slstm'] / split_wall:.3f}); the card's span by "
        f"block kind {spans}; profile {prof} "
        f"(at {_elapsed()} s)")
    del lg, inputs

    with torch.no_grad():
        cache = M.init_cache(params, cfg, XLSTM["batch"], 0)
    res["decode"] = _lockstep_decode(params, cfg, cache, XLSTM, 0)
    del cache
    P, new = XLSTM["prompt"], XLSTM["new"]
    with torch.no_grad():                    # a bf16 reading, not a gate
        seq = _decoded_sequence(cfg, res["decode"]["generated"]).to(CARD)
        fwd = M.logits(params, cfg, {"tokens": seq})[0][
            :, P - 1:P + new - 1].argmax(-1)
        res["decode"]["bf16_forward_token_agreement"] = float(
            (fwd == seq[:, P:]).float().mean())
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"xlstm decode ({smi}): {res['decode']}; peak "
        f"{res['peak_bytes'] / 2**30:.2f} GiB (at {_elapsed()} s)")
    del params
    torch.cuda.empty_cache()
    res["full_fp32"] = _xlstm_fp32_vs_forward(res["decode"]["generated"])
    log(f"--- phase 15 (b) at {_elapsed()} s")
    res["check"] = xlstm_checks()
    torch.cuda.empty_cache()
    res["train"] = xlstm_train()
    return res


def _decoded_sequence(cfg, generated: list):
    """What ``_lockstep_decode`` fed its steps: the seeded prompts, then
    the generated tokens (B, prompt + new)."""
    import torch
    gen = torch.tensor(generated, dtype=torch.int32)
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (gen.shape[0], XLSTM["prompt"])).astype(np.int32))
    return torch.cat([prompts, gen], dim=1)


def _xlstm_fp32_vs_forward(generated: list) -> dict:
    """xlstm-350m at full width and depth in fp32 (gates drawn): the bf16
    decode's sequence (the seeded prompts, then the generated tokens as the
    decode fed them) through decode steps on the card against the forward
    over it (``_decode_vs_forward``), and the forward at the prompt's last
    position against ``prefill_step`` on the prompt, each within
    TOL_DECODE_VS_FORWARD x max|logit|.  The same check in bf16 is only a
    reading (the share of the bf16 decode's greedy tokens the bf16 forward
    repeats): at this random init the bf16 function itself moves by 0.264
    x max|logit| between two chunkings of the same prefix on the CPU,
    where fp32 gives the same bits (``tools/xlstm_conditioning.py``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve.decode import prefill_step
    P = XLSTM["prompt"]
    cfg = get_config(XLSTM["arch"]).with_(dtype="float32")
    seq = _decoded_sequence(cfg, generated).to(CARD)
    params = serve.build_params(cfg, device=CARD)
    gates = _xlstm_gates(params, 2)
    what = f"xlstm full depth fp32 (B {seq.shape[0]}, T {seq.shape[1]})"
    out = _decode_vs_forward(params, cfg, {"tokens": seq}, what)
    with torch.no_grad():
        full, _ = M.logits(params, cfg, {"tokens": seq})
        pre = prefill_step(params, cfg, {"tokens": seq[:, :P]})
    gap = float((pre - full[:, P - 1]).abs().max()
                / full[:, P - 1].abs().max())
    log(f"{what}: prefill_step on the {P}-token prompt vs the forward at "
        f"its last position, max|d| / max|logit| {gap:.3e}")
    _require(gap <= TOL_DECODE_VS_FORWARD
             and torch.equal(pre.argmax(-1), full[:, P - 1].argmax(-1)), gap)
    del params
    torch.cuda.empty_cache()
    return dict(out, prefill_step_vs_forward_rel_err=gap,
                gates_max_abs=gates)


def xlstm_checks() -> dict:
    """xlstm-350m at full width with one group (7 mLSTM blocks and the
    sLSTM block) in fp32, gates drawn, weights made once on the CPU and
    copied to the card.  Card vs CPU: ``prefill_step`` logits at B 2, S 512
    (two mLSTM chunks, so the inter-chunk recurrence runs) and 8 greedy
    decode steps from ``init_cache``, identical tokens and logits within
    TOL_LM x max|logit|.  Then, on the card, the 512 tokens through 512
    decode steps against the full forward within TOL_DECODE_VS_FORWARD x
    max|logit|.  No kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.tree import tree_map
    c = XLSTM_CHECK
    cfg = get_config(XLSTM["arch"]).with_(n_layers=c["layers"],
                                          dtype="float32")
    cpu = serve.build_params(cfg, seed=1, device="cpu")
    gates = _xlstm_gates(cpu, 1)
    card = tree_map(lambda t: t.to(CARD), cpu)
    B, S = c["prefill"]
    toks = _tokens(2, B, S, cfg.vocab_size)
    what = f"xlstm depth-{cfg.n_layers} fp32"
    ops.reset_launches()
    runs = {dev: _prefill_then_decode(p, cfg, {"tokens": toks.to(dev)},
                                      c["steps"])
            for dev, p in ((CARD, card), ("cpu", cpu))}
    rel = _held_logits(runs[CARD], runs["cpu"], what)
    del cpu
    dvf = _decode_vs_forward(card, cfg, {"tokens": toks.to(CARD)}, what)
    counts = dict(ops.LAUNCHES)
    _require(all(v == 0 for v in counts.values()), counts)
    return dict(dvf, layers=cfg.n_layers, gates_max_abs=gates,
                logit_rel_err=rel, max_logit_rel_err=max(rel),
                tokens_identical=True, launches=counts)


def xlstm_train() -> dict:
    """xlstm-350m at full width and depth in bf16 through
    ``launch/train.main`` (B 8, S 128, 20 AdamW steps): every loss finite,
    the eval loss falls, no kernel launches anywhere; ms a step, tokens/s
    and peak memory.  Then one AdamW step of the smoke config with drawn
    gates on the card against the CPU (``_held_training``), with
    ``cfg.remat`` off and on."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adam import AdamW
    from repro_torch.train.loop import make_train_step
    t = XLSTM_TRAIN
    log(f"--- phase 15 (c): train {XLSTM['arch']} at full width and depth")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "train.json")
        rc = train_cli.main(["--arch", XLSTM["arch"], "--steps",
                             str(t["steps"]), "--batch", str(t["batch"]),
                             "--seq", str(t["seq"]), "--log-every", "5",
                             "--device", CARD, "--out", out])
        _require(rc == 0, rc)
        with open(out) as fh:
            rec = json.load(fh)
    la = rec["launches"]
    _require(rec["dtype"] == "bfloat16" and all(np.isfinite(rec["losses"]))
             and rec["improved"], rec)
    _require(all(v == 0 for part in la.values() for v in part.values()), la)
    warm = rec["step_s"][1:]
    res = {"full": {
        "arch": XLSTM["arch"], "layers": rec["n_layers"],
        "batch": t["batch"], "seq": t["seq"], "losses": rec["losses"],
        "eval_before": rec["eval_before"], "eval_after": rec["eval_after"],
        "step_ms": [x * 1e3 for x in rec["step_s"]],
        "step_ms_p50": float(np.median(warm)) * 1e3,
        "tokens_per_s": t["batch"] * t["seq"] / float(np.median(warm)),
        "peak_bytes": rec["peak_bytes"]}}
    f = res["full"]
    log(f"train {XLSTM['arch']} (bf16; {_smi()}): step "
        f"{f['step_ms_p50']:.1f} ms p50 after the first "
        f"({f['step_ms'][0]:.1f}), {f['tokens_per_s']:.0f} tokens/s, peak "
        f"{(f['peak_bytes'] or 0) / 2**30:.2f} GiB; eval "
        f"{rec['eval_before']:.4f} -> {rec['eval_after']:.4f}")
    torch.cuda.empty_cache()
    for remat in (False, True):
        cfg = get_smoke(XLSTM["arch"]).with_(remat=remat)
        fns = make_train_step(cfg, AdamW())
        params, state = fns.init(torch.Generator().manual_seed(0))
        _xlstm_gates(params, 5)
        batches = _lm_batches(cfg, 4, 64, 1)
        card = _train_run(fns, params, state, batches, CARD)
        _require(all(v == 0 for v in card[3].values()), card[3])
        cpu = _train_run(fns, params, state, batches, "cpu")
        res[f"smoke_remat_{remat}"] = _held_training(
            f"{XLSTM['arch']} smoke (remat {remat})", cfg, card, cpu)
    return res


def phase_guards() -> dict:
    """The runtime guards on the card (phase 16), against
    ``ANALYSIS_budgets.json``: (a) a warmed VFL dispatch on phase 3's
    bundle, ``predict_active`` and the mixed ``predict``, each under
    ``no_host_sync``, ``compile_counter`` and ``cuda_sync_events``:
    ``host_syncs_per_dispatch`` copies a dispatch, as many device->host
    syncs, no compile; the engine's device tree in ``engine_dtypes``; (b)
    one epoch of ``training.train`` (g1_active's autoencoder at Table-3
    widths on the mimic3 scenario, batch 128, the lane-MLP kernels): one
    copy; (c) one greedy decode step of xlstm-350m at full width, one group
    in bf16, and (d) one warm engine step of internlm2-1.8b at full width,
    depth 2 in bf16: one copy each (the tokens).  Blocking host->device
    copies are reported apart."""
    import torch
    from repro_torch.analysis import guards
    from repro_torch.configs import get_config
    from repro_torch.core import autoencoder as ae
    from repro_torch.core import training
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve.decode import make_decode_step
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.vfl import VFLServingEngine
    log("=== phase 16: the runtime guards on the card ===")
    budgets = guards.load_budgets()
    per = budgets["serve_bucket_warm"]["host_syncs_per_dispatch"]
    res = {}

    def guarded(what: str, allowed: int, fn):
        with guards.compile_counter(0, label=what) as comp, \
                guards.no_host_sync(allowed, label=what,
                                    device=CARD) as tally, \
                guards.cuda_sync_events() as ev:
            out = fn()
        r = {"copies": tally.copies, "compiles": comp.count,
             "sync_events": ev.as_dict()}
        log(f"guards {what}: {r}")
        _require(ev.d2h == tally.copies, (what, r))
        res[what] = r
        return out, r

    sc, bundle = make_bundle(0)
    eng = VFLServingEngine(bundle, device=CARD)
    x, ids = sc.active.x[:200], sc.active.ids[:200]
    eng.predict_active(x)
    eng.predict(x, ids)                                    # warm both paths
    for what, call in (("vfl predict_active", lambda: eng.predict_active(x)),
                       ("vfl predict", lambda: eng.predict(x, ids))):
        before = sum(eng.stats.dispatches.values())
        _, r = guarded(what, 2 * per, call)
        r["dispatches"] = sum(eng.stats.dispatches.values()) - before
        _require(r["copies"] == per * r["dispatches"] >= 1, (what, r))
    guards.audit_dtypes({"active": eng._p_active, "collab": eng._p_collab,
                         "cache_z": eng.cache.z},
                        budgets["engine_dtypes"], label="vfl engine")
    del eng

    xa = sc.active.x.astype(np.float32)
    p = ae.init_autoencoder(torch.Generator().manual_seed(0),
                            ae.table3_encoder("g1_active", xa.shape[1]),
                            device=CARD)
    fit, r = guarded("vfl train epoch", 1, lambda: training.train(
        p, {"x": xa}, ae.make_recon_loss(True), batch_size=TRAIN_B,
        max_epochs=1))
    _require(fit.epochs_run == 1 and r["copies"] == 1, r)
    guards.audit_dtypes(fit.params, budgets["engine_dtypes"],
                        label="fitted g1_active")

    cfg = get_config(XLSTM["arch"]).with_(n_layers=XLSTM_CHECK["layers"])
    params = serve.build_params(cfg, device=CARD)
    step = make_decode_step(cfg)
    with torch.no_grad():
        cache = M.init_cache(params, cfg, XLSTM["batch"], 0)
        tok = _tokens(5, 1, XLSTM["batch"], cfg.vocab_size)[0].to(CARD)
        for pos in range(2):                               # warm
            tok, cache = step(params, tok, cache, pos)

        def xlstm_step():
            nxt, _ = step(params, tok, cache, 2)
            return guards.to_host(nxt)
        out, r = guarded("xlstm decode step", 1, xlstm_step)
    _require(r["copies"] == 1 and out.shape == (XLSTM["batch"],), r)
    del params, cache

    lcfg = get_config(LM["arch"]).with_(n_layers=2)
    engine = Engine(serve.build_params(lcfg, device=CARD), lcfg, batch=4,
                    n_slots=64, prefill_len=16, device=CARD)
    for q in serve.make_requests(4, lcfg.vocab_size, lo=8, hi=16,
                                 max_new=16):
        engine.submit(q)
    for _ in range(3):                                     # prefills, warm
        engine.step()
    _, r = guarded("dense engine decode step", 1, engine.step)
    _require(r["copies"] == 1, r)
    return res

def _corr(a, b) -> float:
    import torch
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))


def _fit_summary(rs) -> list:
    from repro_torch.tree import tree_leaves
    return [{"epochs": r.epochs_run, "steps": r.steps_run,
             "train": list(r.train_loss), "val": list(r.val_loss),
             "params": [t.detach().cpu() for t in tree_leaves(r.params)]}
            for r in rs]


def _fits_held(what: str, got: list, want: list) -> dict:
    """Two fits of the same lanes: epochs and steps equal, every epoch's
    train and val loss within TOL_LOSS relative; whether they are the same
    bits, and the params' largest relative gap."""
    same, loss_err, param_err = True, 0.0, 0.0
    for g, w in zip(got, want):
        _require((g["epochs"], g["steps"]) == (w["epochs"], w["steps"]),
                 (what, g["epochs"], w["epochs"]))
        for k in ("train", "val"):
            a, b = np.asarray(g[k]), np.asarray(w[k])
            loss_err = max(loss_err, float(np.max(np.abs(a - b)
                                                  / np.abs(b))))
            same &= bool(np.array_equal(a, b))
        for a, b in zip(g["params"], w["params"]):
            param_err = max(param_err, _relerr(a, b))
            same &= bool(a.equal(b))
    log(f"{what}: same bits {same}, loss rel err {loss_err:.3e}, params "
        f"rel err {param_err:.3e}")
    _require(loss_err <= TOL_LOSS, (what, loss_err))
    return {"same_bits": same, "loss_rel_err": loss_err,
            "param_rel_err": param_err}


def _scale_rank(lanes: list, kw: dict) -> dict:
    """One of phase 17c's two ranks, both on cuda:0 over gloo: the cut
    lanes over a lane mesh of 2, then over lane 1 x data 2 with the rows
    split (each rank records the rows it keeps of each lane)."""
    import torch
    from repro_torch.core import autoencoder as ae
    from repro_torch.core import training
    from repro_torch.launch import mesh as meshlib
    from repro_torch.tree import tree_map
    torch.cuda.set_device(0)
    specs = [training.LaneSpec(tree_map(lambda t: t.cuda(), p),
                               {"x": x.cuda()}, s) for p, x, s in lanes]
    loss = ae.make_masked_recon_loss(True)
    out, held = {}, []
    inner = training._split_slab

    def split(data, seed, val_frac, dev, rows):
        tr, val, n_tr, loc = inner(data, seed, val_frac, dev, rows)
        held.append(len(tr["x"]) + len(val["x"]))
        return tr, val, n_tr, loc
    training._split_slab = split
    for name, mesh_kw, shard in (("lane2", dict(lane=2), False),
                                 ("rows2", dict(lane=1, data=2), True)):
        held.clear()
        t0 = time.perf_counter()
        rs = training.train_lanes(specs, loss,
                                  mesh=meshlib.make_lane_mesh(**mesh_kw),
                                  shard_rows=shard, **kw)
        torch.cuda.synchronize()
        out[name] = {"fits": _fit_summary(rs), "held": list(held),
                     "wall_s": time.perf_counter() - t0,
                     "device": str(rs[0].params["enc"]["w0"].device)}
    return out


# the profile's kinds: a kernel whose name holds one of the first two (each
# route's kernels, the backward's fold among them), or the rest
SCALE_KERNELS = ("lane_mlp_fwd", "lane_mlp_bwd", "other")


def _scale_profile(fn) -> dict:
    """``_busy`` with the card's kernels sorted into the lane-MLP pair and
    the rest, and each kind's mean time a launch."""
    prof = _busy(fn, lambda name: next((k for k in SCALE_KERNELS[:-1]
                                        if k in name), "other"),
                 SCALE_KERNELS)
    prof["kernels"] = {k: {"launches": n, "ms": prof["device_ms"][k],
                           "us_per_launch": 1e3 * prof["device_ms"][k]
                           / max(n, 1)}
                       for k, n in prof["device_launches"].items()}
    prof["pair_device_ms"] = sum(prof["device_ms"][k]
                                 for k in SCALE_KERNELS[:-1])
    return prof


def phase_scale() -> dict:
    """Phase 17: (a) the million-row workload at full size on the card
    through a lane mesh of one; (b) its cut, card against CPU; (c) the cut
    over two ranks sharing the card."""
    import torch
    from repro_torch.core import autoencoder as ae
    from repro_torch.core import training
    from repro_torch.data import scale
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.tree import tree_map
    log("=== phase 17: scale (lane meshes, the million-row workload) ===")
    c = SCALE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lanes = scale.make_scale_lanes(
        c["rows"], c["parties"], n_features=c["features"],
        widths=c["widths"], seeds=c["seeds"], block_rows=c["block_rows"],
        device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    L = len(lanes)
    _require(all(sp.data["x"].device == torch.device("cuda", 0)
                 for sp in lanes), "scale data not on cuda:0")
    nbytes = scale.lane_bytes(lanes)
    _require(nbytes == L * c["rows"] * c["features"] * 4, nbytes)
    # a seed's parties share z row by row: party p's feature 1 and party
    # p + 1's feature 0 read the same latent (noise apart); another seed's
    # do not
    x0, x1 = lanes[0].data["x"], lanes[1].data["x"]
    shared = _corr(x0[:, 1], x1[:, 0])
    other = _corr(x0[:, 1], lanes[c["parties"] + 1].data["x"][:, 0])
    log(f"scale: {L} lanes x {c['rows']} rows x {c['features']} features, "
        f"{nbytes} bytes on {x0.device} in {gen_s:.3f} s; corr of shared "
        f"latent columns {shared:.4f}, across seeds {other:.4f}")
    _require(shared > 0.4 and abs(other) < 0.02, (shared, other))
    mesh = meshlib.make_lane_mesh(lane=1)
    loss = ae.make_masked_recon_loss(True)
    kw = dict(batch_size=c["batch"], max_epochs=c["epochs"],
              patience=c["patience"])

    def fit():
        return training.train_lanes(lanes, loss, mesh=mesh, **kw)
    ops.reset_launches()
    t0 = time.perf_counter()
    rs = fit()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for k in ("lane_mlp_fwd", "lane_mlp_bwd"):
        _require(launches[k] > 0, f"{k} never launched in phase 17")
    t0 = time.perf_counter()
    rs = fit()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    prof = _scale_profile(fit)
    peak = torch.cuda.max_memory_allocated()
    steps = rs[0].steps_run
    _require(all(r.epochs_run == c["epochs"] and r.steps_run == steps
                 for r in rs), [(r.epochs_run, r.steps_run) for r in rs])
    tl = np.asarray([r.train_loss for r in rs])
    _require(bool(np.isfinite(tl).all()), "non-finite scale loss")
    _require(float(tl[:, 1].mean()) < float(tl[:, 0].mean()),
             ("scale loss did not fall", tl.mean(0)))
    rows = steps * c["batch"] * L
    full = {"lanes": L, "bytes": nbytes, "generate_s": gen_s,
            "cold_fit_s": cold_s, "warm_fit_s": warm_s,
            "steps_per_s": steps / warm_s, "rows_per_s": rows / warm_s,
            "steps": steps, "peak_bytes": peak,
            "mean_train_loss_by_epoch": tl.mean(0).tolist(),
            "final_mean_train_loss": float(tl[:, -1].mean()),
            "lanes_falling": int((tl[:, 1] < tl[:, 0]).sum()),
            "latent_corr": {"shared": shared, "across_seeds": other},
            "profile": prof, "launches": launches}
    log("scale (a): " + json.dumps(
        {k: v for k, v in full.items() if k not in ("profile",
                                                     "launches")}))
    log("scale (a) profile: " + json.dumps(prof))
    del lanes, rs, x0, x1
    torch.cuda.empty_cache()

    # (b) the cut, generated on the CPU, card against CPU
    k = SCALE_CUT
    cut = scale.make_scale_lanes(
        k["rows"], k["parties"], n_features=c["features"],
        widths=c["widths"], seeds=k["seeds"], block_rows=c["block_rows"],
        device="cpu")
    kw_cut = dict(batch_size=c["batch"], max_epochs=k["epochs"],
                  patience=c["patience"])
    card_specs = [training.LaneSpec(tree_map(lambda t: t.cuda(), sp.params),
                                    {"x": sp.data["x"].cuda()}, sp.seed)
                  for sp in cut]
    ops.reset_launches()
    t0 = time.perf_counter()
    card = _fit_summary(training.train_lanes(card_specs, loss, **kw_cut))
    card_s = time.perf_counter() - t0
    cut_launches = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    cpu = _fit_summary(training.train_lanes(cut, loss, **kw_cut))
    cpu_s = time.perf_counter() - t0
    check = _fits_held("scale (b) card vs cpu", card, cpu)

    # (c) two ranks on the one card over gloo, against (b)'s card run
    arrays = [(tree_map(lambda t: t.detach().clone(), sp.params),
               sp.data["x"], sp.seed) for sp in cut]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        outs = meshlib.run_ranks(_scale_rank, 2, arrays, kw_cut,
                                 init_dir=d)
        ranks_s = time.perf_counter() - t0
    two = {}
    for name in ("lane2", "rows2"):
        for r, o in enumerate(outs):
            _require(o[name]["device"].startswith("cuda"), o[name]["device"])
            two[f"{name} rank{r}"] = _fits_held(
                f"scale (c) {name} rank {r} vs one process",
                o[name]["fits"], card)
            two[f"{name} rank{r}"]["wall_s"] = o[name]["wall_s"]
    half = k["rows"] // 2
    held = [o["rows2"]["held"] for o in outs]
    log(f"scale (c): rows each rank keeps of each lane {held}; the lane "
        f"split keeps whole lanes ({[o['lane2']['held'] for o in outs]}); "
        f"{ranks_s:.1f} s with the spawn")
    _require(held == [[half] * k["parties"]] * 2, held)
    return {"full": full, "cut": {"card_s": card_s, "cpu_s": cpu_s,
                                  "check": check, "launches": cut_launches},
            "two_ranks": two | {"wall_s_with_spawn": ranks_s,
                                "rows_held": held},
            "launches": launches}


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
                    help="build, then only phase 5's kernel timing and "
                         "Eq. 5's profile; one JSON line (to time two "
                         "trees' kernels in one call, each with its own "
                         "copy of this script)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card on this host; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    if args.time_only:
        phase_build()
        print(json.dumps({"timing": phase_time(), "eq5": eq5_profile(),
                          "device": _smi()}))
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
    comparison = phase_comparison()
    done("comparison")
    experiments = phase_experiments()
    done("experiments")
    runtime = phase_runtime()
    done("runtime")
    lm_train = phase_lm_train()
    done("lm_train")
    moe_audio = phase_moe_audio()
    done("moe_audio")
    vlm = phase_vlm()
    done("vlm")
    xlstm = phase_xlstm()
    done("xlstm")
    guard = phase_guards()
    done("guards")
    scale = phase_scale()
    done("scale")

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
                    + lm["launches"][name] + zamba["launches"][name]
                    + comparison["launches"][name]
                    + experiments["launches"][name]
                    + runtime["launches"][name]
                    + lm_train["launches"][name]
                    + moe_audio["launches"][name]
                    + vlm["launches"][name]
                    + scale["launches"][name])
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
        if name.startswith("lane_mlp"):     # the narrow route, phase 17's
            sc = timing[f"{name}_scale"]    # shapes
            kernels[-1]["scale"] = {k: sc[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        if name == "decode_attention":      # its grouped route's shapes
            fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
            kernels[-1]["grouped"] = {
                k: {f: timing[f"{name}_{k}"][f] for f in fields}
                for k in ("qwen3", "vlm", "vlm_image")}
        if "attention" in name:             # fp32 above, bf16 here; bf16
            kernels[-1]["max_abs_err_bf16"] = errs[f"{name}/bfloat16"]
            kernels[-1]["bf16_bound_ratio"] = errs[   # vs fp32 plain, <= 1
                f"{name}/bf16_vs_f32_ratio"]
        if name == "ssd_intra_chunk":       # against the plain version on CPU
            kernels[-1]["max_abs_err_vs_cpu"] = errs["ssd_intra_chunk_vs_cpu"]
            # the bf16 variant vs the plain bf16 route, x max|want|
            kernels[-1]["max_rel_err_bf16"] = errs["ssd_intra_chunk_bf16_rel"]
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
    log(f"comparison ({SCENARIO['dataset']}, {SCENARIO['aligned']} aligned, "
        f"{TRAIN['epochs']} epochs a stage; wall s on the host clock): "
        + json.dumps({name: {"wall_s": r["wall_s"], **r["summary"]}
                      for name, r in comparison.items() if "summary" in r}))
    log("experiments (wall s on the host clock, runs): " + json.dumps(
        {"smoke card": [experiments["smoke"]["wall_s"],
                        experiments["smoke"]["runs"]],
         "smoke cpu": [experiments["smoke"]["cpu_wall_s"],
                       experiments["smoke"]["runs"]]}
        | {f: [r["wall_s"], r["runs"]]
           for f, r in experiments["specs"].items()}
        | {"fig8 cut": [experiments["fig8_cut"]["wall_s"],
                        experiments["fig8_cut"]["runs"]],
           "groups replicated": [experiments["groups"]["replicated_wall_s"],
                                 4],
           "groups sequential": [experiments["groups"]["sequential_wall_s"],
                                 4],
           "probe card": [experiments["probe"]["wall_s"]["cuda"], 1],
           "probe cpu": [experiments["probe"]["wall_s"]["cpu"], 1]})
        + f"; {experiments['fig8_cut']['cut']}")
    log(f"runtime ({SCENARIO['dataset']}, tenants fp32 + int8, "
        f"{RUNTIME['requests']} requests each at {RUNTIME['rate_rps']} "
        f"req/s, SLO {RUNTIME['slo_ms']} ms; {smi}): " + json.dumps(
            {a: runtime[a]["tenants"] for a in ("poisson", "bursty")}))
    log(f"lm_train ({LM_TRAIN['arch']}, bf16, B {LM_TRAIN['batch']}, S "
        f"{LM_TRAIN['seq']}; {smi}): " + json.dumps(
            {k: lm_train["full"][k] for k in (
                "step_ms_p50", "tokens_per_s", "peak_bytes", "eval_before",
                "eval_after")}
            | {f"{a} card vs cpu": {k: r[k] for k in (
                "loss_rel_err", "param_l2_rel_err", "eval_rel_err")}
               for a, r in lm_train["check"].items()}))
    ma = moe_audio
    log(f"moe_audio ({MOE['arch']}, bf16, {MOE['requests']} requests; "
        f"{HUBERT['arch']}, bf16; {smi}): " + json.dumps(
            {k: ma["serve"][k] for k in ("tokens_per_s", "step_ms_p50",
                                         "step_ms_p99", "prefill_ms_p50",
                                         "peak_bytes")}
            | {"init_s": ma["init_s"],
               "prefill_step_ms": ma["prefill_step"]["ms"],
               "decode_busy_share": ma["decode_profile"]["device_busy_share"],
               "decode_ms_by_range": ma["decode_profile"][
                   "device_ms_per_call_by_range"],
               "card_vs_cpu": ma["check"]["max_logit_rel_err"],
               "decode_vs_forward": ma["decode_vs_forward"]["max_rel_err"],
               "hubert_ms": ma["hubert"]["ms"],
               "hubert_card_vs_cpu": ma["hubert"]["check"]["logit_rel_err"],
               "train_step_ms_p50": ma["train"]["full"]["step_ms_p50"],
               "train_peak_bytes": ma["train"]["full"]["peak_bytes"]}))
    log(f"vlm ({VLM['arch']}, bf16; {smi}): " + json.dumps(
        {"prefill_step_ms": vlm["prefill_step"]["ms"],
         "prefill_busy_share": vlm["prefill_step"]["profile"][
             "device_busy_share"]}
        | {k: vlm["decode"][k] for k in (
            "step_ms_p50", "step_ms_p99", "generated_tokens_per_s")}
        | {"decode_busy_share": vlm["decode"]["profile"]["device_busy_share"],
           "decode_ms_by_kind": vlm["decode"]["profile"][
               "device_ms_per_call"],
           "peak_bytes": vlm["peak_bytes"], "init_s": vlm["init_s"],
           "card_vs_cpu": vlm["check"]["max_logit_rel_err"],
           "zeroed_image_moves": vlm["check"]["zeroed_image_moves"],
           "decode_vs_forward": vlm["check"]["decode_vs_forward_rel_err"],
           "train_step_ms_p50": vlm["train"]["full"]["step_ms_p50"],
           "train_tokens_per_s": vlm["train"]["full"]["tokens_per_s"],
           "train_peak_bytes": vlm["train"]["full"]["peak_bytes"]}))
    xl = xlstm
    log(f"xlstm ({XLSTM['arch']}, bf16; {smi}): " + json.dumps(
        {"prefill_step_ms": xl["prefill_step"]["ms"],
         "prefill_slstm_share_of_wall": xl["prefill_step"][
             "slstm_share_of_wall"],
         "prefill_busy_share": xl["prefill_step"]["profile"][
             "device_busy_share"],
         "prefill_device_span_ms_by_block": xl["prefill_step"][
             "device_span_ms_by_block"]}
        | {k: xl["decode"][k] for k in (
            "step_ms_p50", "step_ms_p99", "generated_tokens_per_s")}
        | {"decode_busy_share": xl["decode"]["profile"]["device_busy_share"],
           "full_fp32_decode_vs_forward": xl["full_fp32"][
               "decode_vs_forward_rel_err"],
           "peak_bytes": xl["peak_bytes"], "init_s": xl["init_s"],
           "card_vs_cpu": xl["check"]["max_logit_rel_err"],
           "decode_vs_forward": xl["check"]["decode_vs_forward_rel_err"],
           "train_step_ms_p50": xl["train"]["full"]["step_ms_p50"],
           "train_tokens_per_s": xl["train"]["full"]["tokens_per_s"],
           "train_peak_bytes": xl["train"]["full"]["peak_bytes"]}))
    log(f"guards (to_host copies and device->host / blocking host->device "
        f"syncs a block; {smi}): " + json.dumps(
            {k: [r["copies"], r["sync_events"]["d2h"],
                 r["sync_events"]["h2d"]] for k, r in guard.items()}))
    sf = scale["full"]
    log(f"scale ({SCALE['rows']} rows x {SCALE['parties']} parties x "
        f"{len(SCALE['seeds'])} seeds = {sf['lanes']} lanes, batch "
        f"{SCALE['batch']}, {SCALE['epochs']} epochs; {smi}): " + json.dumps(
            {k: sf[k] for k in ("generate_s", "cold_fit_s", "warm_fit_s",
                                "steps_per_s", "rows_per_s", "peak_bytes",
                                "final_mean_train_loss")}
            | {"busy_share": sf["profile"]["device_busy_share"],
               "device_ms": sum(sf["profile"]["device_ms"].values()),
               "lane_mlp_pair_device_ms": sf["profile"]["pair_device_ms"],
               "lane_mlp_us_per_launch": {
                   k: v["us_per_launch"]
                   for k, v in sf["profile"]["kernels"].items()},
               "cut_card_vs_cpu_loss_rel_err": scale["cut"]["check"][
                   "loss_rel_err"],
               "two_ranks": {k: [v["same_bits"], v["loss_rel_err"]]
                             for k, v in scale["two_ranks"].items()
                             if isinstance(v, dict) and "same_bits" in v}}))
    log("details: " + json.dumps({"timing": timing, "serve": serve,
                                  "train": train, "train_time": train_time,
                                  "turns": turns, "g3_limit": limit,
                                  "lm": lm, "zamba": zamba,
                                  "comparison": comparison,
                                  "experiments": experiments,
                                  "runtime": runtime, "lm_train": lm_train,
                                  "moe_audio": moe_audio, "vlm": vlm,
                                  "xlstm": xlstm, "guards": guard,
                                  "scale": scale,
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
