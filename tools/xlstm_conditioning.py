#!/usr/bin/env python3
"""CPU readings behind how ``chip_smoke.py`` phase 15 draws the xLSTM's
gates and what it holds in bf16.

    PYTHONPATH=src python3 tools/xlstm_conditioning.py

xlstm-350m at full width and depth (24 blocks), random weights from seed
0, on the CPU:

* ``decode_vs_forward``: in fp32, 32 tokens (B 2) through the recurrent
  decode against the chunked forward over the same tokens, max|d| /
  max|logit|, with the gates at the schema's init, drawn wide (``w_if``
  N(0, 0.05), ``b_i`` U(-1, 1): the CPU tests' draw at the smoke's width)
  and drawn as phase 15 draws them (``w_if`` N(0, 0.01), ``b_i``
  U(-0.5, 0.5)); ``b_f`` U(0.5, 3) and the sLSTM's ``b`` N(0, 0.5) in both
  draws.  The gap is the function's conditioning: both forms compute it.
* ``chunkings``: ``prefill_step`` on a 16-token prefix against the
  forward over 64 tokens at the prefix's last position (the same function
  of the same prefix, chunked as one chunk of 16 or of 64), in fp32 and
  bf16, at the init and drawn wide.

Prints one JSON line; ~2 minutes on 4 threads, ~8 GB of memory.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serve.decode import prefill_step

DRAWS = {"init": None, "wide": (0.05, 1.0), "phase15": (0.01, 0.5)}


def _params(cfg, draw):
    p = serve.build_params(cfg, device="cpu")
    if draw is not None:
        w_if, b_i = draw
        rng = np.random.RandomState(2)
        ml, sl = p["groups"]["mlstms"], p["groups"]["slstm"]
        for t, v in ((ml["w_if"], rng.randn(*ml["w_if"].shape) * w_if),
                     (ml["b_i"], rng.uniform(-b_i, b_i, ml["b_i"].shape)),
                     (ml["b_f"], rng.uniform(0.5, 3, ml["b_f"].shape)),
                     (sl["b"], rng.randn(*sl["b"].shape) * 0.5)):
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return p


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@torch.no_grad()
def main() -> int:
    torch.set_num_threads(4)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, 50304, (2, 64)).astype(np.int32))
    out = {"decode_vs_forward": {}, "chunkings": {}}
    cfg = get_config("xlstm-350m").with_(dtype="float32")
    for name, draw in DRAWS.items():
        p = _params(cfg, draw)
        seq = tokens[:, :32]
        full, _ = M.logits(p, cfg, {"tokens": seq})
        cache = M.init_cache(p, cfg, 2, 0)
        gap = 0.0
        for t in range(seq.shape[1]):
            lg, cache = M.decode(p, cfg, seq[:, t], cache, t)
            gap = max(gap, _rel(lg, full[:, t]))
        out["decode_vs_forward"][name] = gap
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("xlstm-350m").with_(dtype=dtype)
        for name in ("init", "wide"):
            p = _params(cfg, DRAWS[name])
            full, _ = M.logits(p, cfg, {"tokens": tokens})
            pre = prefill_step(p, cfg, {"tokens": tokens[:, :16]})
            out["chunkings"][f"{dtype} {name}"] = _rel(pre, full[:, 15])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
