"""Vertical SplitNN baseline (paper Sec. 2.1, Fig. 1): the port of
``repro.core.splitnn``.

Local feature extractors use the paper's g1 architectures with a final
SELU; the active head is the g2 architecture + class layer (Appendix B
"fair comparison").  Joint end-to-end training on the ALIGNED rows only;
per-batch communication is one embedding upload (forward) + one gradient
download (backward), with byte accounting exactly as Appendix E.2.

Training runs on ``core.training.train``; the per-batch communication
pattern above is ACCOUNTED analytically (it is the protocol being
simulated), not re-enacted step by step.  The analytic totals are recorded
into the result's ``comm.Channel``, forward embeddings as uplink, gradient
returns as downlink.

On a CUDA batch the two party encoders (2-layer Table-3 MLPs) run through
the lane-MLP kernels, forward and closed-form backward
(``autoencoder.fused_mlp_apply``); the three-layer head takes the layer
loop, as the reference computes it outside any kernel.  Initial params
come from a ``torch.Generator`` seeded with ``seed`` (la, lp, head, in
that order) or, for parity with the reference, from ``init_params`` as
arrays; ``perm_fn`` replaces the epoch permutations.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.configs.apcvfl_paper import TABULAR as HP
from repro_torch.core import autoencoder as ae
from repro_torch.core import classifier as clf
from repro_torch.core import comm
from repro_torch.core import training
from repro_torch.core.psi import psi
from repro_torch.data.vertical import VFLScenario
from repro_torch.experiments.results import RunResult


def _head_widths(n_classes: int) -> list:
    return [384, 256, 256, n_classes]   # g2 + class layer (Appendix B)


def init_splitnn(generator: torch.Generator, n_feat_a: int, n_feat_p: int,
                 n_classes: int, *, device="cuda") -> dict:
    return {
        "la": ae.init_mlp(generator, ae.table3_encoder("g1_active", n_feat_a),
                          device=device),
        "lp": ae.init_mlp(generator,
                          ae.table3_encoder("g1_passive", n_feat_p),
                          device=device),
        "head": ae.init_mlp(generator, _head_widths(n_classes),
                            device=device),
    }


def splitnn_logits(params: dict, xa: torch.Tensor,
                   xp: torch.Tensor) -> torch.Tensor:
    # the card has no path but the kernels for the two encoders
    enc = ae.fused_mlp_apply if xa.is_cuda else ae.mlp_apply
    za = enc(params["la"], xa, final_act=True)
    zp = enc(params["lp"], xp, final_act=True)
    return ae.mlp_apply(params["head"], torch.cat([za, zp], dim=-1))


def splitnn_loss(params: dict, batch: dict) -> torch.Tensor:
    logits = splitnn_logits(params, batch["xa"], batch["xp"])
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"].long()[:, None])[:, 0]
    return torch.mean(lse - gold)


def run_splitnn(sc: VFLScenario, *, seed: int = 0,
                batch_size: int = HP.batch_size,
                max_epochs: int = HP.max_epochs, patience: int = HP.patience,
                lr: float = HP.lr, test_size: int = HP.test_size,
                init_params: Optional[dict] = None,
                perm_fn: Optional[Callable] = None,
                device="cuda") -> RunResult:
    """Train SplitNN on the aligned rows on ``device``; metrics on the
    ``test_size`` held-out rows.  ``train_loss``, ``steps`` and
    ``seconds`` carry the one stage, ``splitnn``."""
    dev = resolve_device(device)
    channel = comm.Channel()
    _, idx_a, idx_p = psi(sc.active.ids, sc.passive.ids, channel=channel)
    xa, xp = sc.active.x[idx_a], sc.passive.x[idx_p]
    y = np.asarray(sc.active.y[idx_a])

    perm = np.random.RandomState(seed).permutation(len(xa))
    te, tr = perm[:test_size], perm[test_size:]

    if init_params is not None:
        params = convert.to_torch(init_params, device=dev)
    else:
        params = init_splitnn(torch.Generator().manual_seed(seed),
                              xa.shape[1], xp.shape[1], sc.n_classes,
                              device=dev)
    rows = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        res = training.train(params, {"xa": rows(xa[tr]), "xp": rows(xp[tr]),
                                      "y": torch.as_tensor(y[tr],
                                                           device=dev)},
                             splitnn_loss, batch_size=batch_size,
                             max_epochs=max_epochs, patience=patience, lr=lr,
                             seed=seed, perm_fn=perm_fn)
        seconds = time.perf_counter() - t0
        logits = splitnn_logits(res.params, rows(xa[te]), rows(xp[te]))
    pred = torch.argmax(logits, dim=-1).cpu().numpy()
    metrics = clf.f1_scores(y[te], pred, sc.n_classes)

    # analytic Appendix-E.2 accounting, recorded on the channel so the
    # summary carries the same direction/stage structure as measured links
    n_al = len(tr)
    epochs = res.epochs_run
    channel.send("train/forward_embeddings",
                 comm.splitnn_forward_bytes(epochs, n_al),
                 direction="uplink")
    channel.send("train/backward_gradients",
                 comm.splitnn_backprop_bytes(epochs, n_al, batch_size),
                 direction="downlink")
    rounds = comm.splitnn_rounds(epochs, n_al, batch_size)
    return RunResult(method="splitnn", metrics=metrics, rounds=rounds,
                     epochs={"splitnn": epochs}, comm=channel.summary(),
                     seed=seed, train_loss={"splitnn": res.train_loss},
                     steps={"splitnn": res.steps_run},
                     seconds={"splitnn": seconds}, channels=(channel,))
