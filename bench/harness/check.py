"""What decides ``correct``: the served tokens of a sample against the
plain fp32 reference (``bench/reference``), run after the window.

For each checked position the reference gives its logits; the number
compared is the widest gap by which a served token's reference logit
lies below the reference's best at that position (0 where the program
served the reference's argmax).  ``missing`` counts answers that never
came.  Each has its limit in ``bench/limits/<workload>.json``.

The control puts the reference in the program's place at the next
precision below the configuration's (bf16 -> fp8): at the same positions
of the same sequences the token the fp8 forward puts first takes the
served token's place, and the run is judged on it as on the program.
"""
from __future__ import annotations

import time

import torch

from bench.reference.model import logits_at, sizes


def gaps(weights: dict, fields: dict, items: list,
         control: str = None) -> dict:
    """``{"gap_max": .., "tokens_checked": .., "seconds": ..}``; with
    ``control`` (``"fp8"``) ``gap_max`` is the control's, whose picks take
    the served tokens' place."""
    m = sizes(fields)
    t0 = time.perf_counter()
    worst, n = 0.0, 0
    for it in items:
        if len(it.served) == 0:
            continue
        rows = it.rows[:len(it.served)]
        ref = logits_at(weights, m, it.tokens, rows)
        best = ref.max(dim=-1).values
        if control:
            picks = logits_at(weights, m, it.tokens, rows,
                              precision=control).argmax(dim=-1)
        else:
            picks = torch.as_tensor(it.served, dtype=torch.long,
                                    device=ref.device)
        if bool(((picks < 0) | (picks >= ref.shape[-1])).any()):
            worst = float("inf")            # a token outside the vocabulary
            break
        got = ref.gather(1, picks[:, None])[:, 0]
        worst = max(worst, float((best - got).max()))
        n += len(rows)
        del ref
    return {"gap_max": worst, "tokens_checked": n,
            "seconds": time.perf_counter() - t0}
