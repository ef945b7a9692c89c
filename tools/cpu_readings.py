#!/usr/bin/env python3
"""CPU readings behind two decisions of the port's comparison slice.

    PYTHONPATH=src python3 tools/cpu_readings.py [bmm] [k3] [aligned]

``bmm``: how often a lane of a batched CPU product (``a @ b`` over a
lane stack of 1 or 2) differs in its bits from the same lane's 2-D
product, over the training paths' shapes with and without transposed
operands, against ``kernels/ref.lane_matmul`` (one product a lane).

``k3``: the K = 3 g2's last-epoch train-loss gap (``run_apcvfl_k`` on
mimic3, 10000 aligned rows, 2 epochs, the CPU) against the same run with
g1 and g2 through the closed-form backward (the CPU's own spread, as
``chip_smoke.py`` phase 9 reads it), and with planted faults in the
closed-form backward's output for the 640-wide MLP: scaled ones, which
Adam's per-coordinate update does not see, and ones that change the
gradient's direction, which ``chip_smoke.py`` plants in the kernel.

``aligned``: the aligned-only g2's largest param gap to the reference
(bcw, 150 aligned, seed 0, 2 epochs, the reference's inits and
permutations) per g2 leaf, at one and at eight PyTorch intra-op threads.
Imports the JAX package (as the tests do).

Each prints one JSON line; no card needed.
"""
from __future__ import annotations

import itertools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def bmm() -> dict:
    import torch
    from repro_torch.kernels.ref import lane_matmul
    gen = torch.Generator().manual_seed(0)
    counts = {"cases": 0, "batch 1": 0, "batch 2": 0, "lane_matmul": 0}
    for (B, K, N), (ta, tb) in itertools.product(
            itertools.product((1, 77, 128, 135, 150, 2000),
                              (5, 10, 15, 64, 128, 256, 384, 640),
                              (5, 15, 64, 128, 256, 384, 640)),
            itertools.product((False, True), (False, True))):
        a = (torch.randn((2, K, B), generator=gen).transpose(-1, -2) if ta
             else torch.randn((2, B, K), generator=gen))
        b = (torch.randn((2, N, K), generator=gen).transpose(-1, -2) if tb
             else torch.randn((2, K, N), generator=gen))
        want = a[0] @ b[0]
        counts["cases"] += 1
        counts["batch 1"] += not torch.equal((a[:1] @ b[:1])[0], want)
        counts["batch 2"] += not torch.equal((a @ b)[0], want)
        counts["lane_matmul"] += not torch.equal(lane_matmul(a, b)[0], want)
    return {"differing lanes": counts, "threads": torch.get_num_threads()}


def _tail_rows(fn):
    """A fault on the 640-wide MLP's ``(dx, dw0, db0, dw1, db1)``."""
    def fault(out):
        return fn(*out) if out[1].shape[-2] == 640 else out
    return fault


def k3() -> dict:
    import chip_smoke as cs
    from repro_torch.core import autoencoder as ae
    from repro_torch.core import multiparty as mp
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import ref

    def scale_tail(s):
        def f(dx, dw0, db0, dw1, db1):
            dw0 = dw0.clone()
            dw0[..., -128:, :] *= s
            return dx, dw0, db0, dw1, db1
        return f

    def clone_then(fault):
        return lambda *o: fault(*(t.clone() for t in o))

    faults = {"dW 1% low": lambda dx, dw0, db0, dw1, db1: (
                  dx, dw0 * 0.99, db0, dw1 * 0.99, db1),
              "dW0's last 128 input rows x0.5": scale_tail(0.5),
              **{k: clone_then(f) for k, f in cs.K3_G2_FAULTS.items()}}
    sc = mp.make_scenario_k(make_dataset("mimic3", seed=0), n_parties=3,
                            n_active_features=5, n_aligned=10000, seed=0)
    run = lambda: mp.run_apcvfl_k(sc, seed=0, max_epochs=2, use_kernel=True,
                                  device="cpu").train_loss
    base = run()
    autograd, bwd = ae.masked_recon_loss, ref.mlp2_bwd_ref
    out = {}
    for what, fault in [("cpu spread (closed-form vs autograd)", None),
                        *faults.items()]:
        ae.masked_recon_loss = ae.make_masked_recon_loss(True)
        if fault is not None:
            wrap = _tail_rows(fault)
            ref.mlp2_bwd_ref = lambda *a, wrap=wrap, **k: wrap(bwd(*a, **k))
        try:
            out[what] = cs._loss_rel_err(run(), base)["g2"][-1]
        finally:
            ae.masked_recon_loss, ref.mlp2_bwd_ref = autograd, bwd
    return {"k3 g2 last-epoch gap": out, "limit": cs.TOL_LOSS_K3_G2_LAST}


def aligned() -> dict:
    import jax
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from repro.core import pipeline as jp
    from repro.data.synthetic import make_dataset
    from repro.data.vertical import make_scenario
    from repro_torch import convert
    from repro_torch.core import pipeline as tp
    from test_torch_pipeline import jax_perm, reference_inits
    sc = make_scenario(make_dataset("bcw", seed=0), n_active_features=5,
                       n_aligned=150, seed=0)
    want = jax.tree.map(np.asarray, jp.run_apcvfl_aligned_only(
        sc, seed=0, max_epochs=2, test_size=30).params["g2"])
    inits = reference_inits(sc, 0, roles=tp.ROLES[:3])
    out, n = {}, torch.get_num_threads()
    for threads in (1, 8):
        torch.set_num_threads(threads)
        try:
            got = convert.to_numpy(tp.run_apcvfl_aligned_only(
                sc, seed=0, max_epochs=2, test_size=30, init_params=inits,
                perm_fn=jax_perm, device="cpu").params["g2"])
        finally:
            torch.set_num_threads(n)
        out[f"{threads} thread(s)"] = {
            f"{part}.{k}": float(np.max(np.abs(got[part][k] - want[part][k])))
            for part in ("enc", "dec") for k in sorted(want[part])}
    return {"aligned-only g2 max |port - reference| per leaf": out}


def main(argv=None) -> int:
    parts = {"bmm": bmm, "k3": k3, "aligned": aligned}
    for name in (argv or sys.argv[1:]) or list(parts):
        print(json.dumps({name: parts[name]()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
