"""The runners of the traffic modes: each sets the program up, warms every
shape its traffic uses, runs the measured window, runs a bounded stretch
for the trace, and hands the check what was served.

The program is reached only through its serving entry points, looked up
on their modules at each call (``serve.decode.prefill_step``,
``serve.engine.Engine``), so that a test can break the timed path
underneath a run.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from bench.harness import stats
from bench.traffic.generator import (Tokens, block_counts, prefill_shapes,
                                     sub_seed)


@dataclass
class Item:
    """One sequence to check: ``tokens`` (T,) on the device, the positions
    ``rows`` whose next token was served, and the served tokens (len(rows),)
    on the host."""
    tokens: torch.Tensor
    rows: list
    served: np.ndarray


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PrefillRunner:
    """A closed loop of ``prefill_step`` calls; each prompt's first token is
    the argmax of its last position, copied to the host."""

    def __init__(self, cfg, weights: dict, traffic: dict, seed: int,
                 device):
        self.cfg, self.w, self.mix = cfg, weights, traffic
        self.seed, self.device = seed, device
        self.shapes = prefill_shapes(traffic, seed)
        self.tokens = Tokens(cfg.vocab_size, seed, device)
        self.calls: list = []       # (B, S, t0, t1, tokens, served)
        self.window_s = 0.0

    def _call(self, toks: torch.Tensor) -> np.ndarray:
        from repro_torch.serve import decode as serve_decode
        lg = serve_decode.prefill_step(self.w, self.cfg, {"tokens": toks})
        return torch.argmax(lg, dim=-1).cpu().numpy()

    @torch.no_grad()
    def setup(self) -> None:
        warm = Tokens(self.cfg.vocab_size, self.seed, self.device, stream=3)
        for S, n in block_counts(self.mix):
            for _ in range(2 if n else 0):
                self._call(warm.next(self.mix["token_budget"] // S, S))
        _sync(self.device)

    @torch.no_grad()
    def window(self, seconds: float) -> None:
        """Calls until ``seconds`` have passed; each started call ends."""
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            B, S = next(self.shapes)
            toks = self.tokens.next(B, S)
            t0 = time.perf_counter()
            served = self._call(toks)
            end = time.perf_counter()
            self.calls.append((B, S, t0, end, toks, served))
        self.window_s = end - start

    @torch.no_grad()
    def stretch(self) -> list:
        """One block of calls (every length in its share), for the trace."""
        out = []
        for _ in range(self.mix["block"]):
            B, S = next(self.shapes)
            toks = self.tokens.next(B, S)
            with torch.profiler.record_function("bench.prefill_step"):
                self._call(toks)
            out.append({"mode": "prefill", "B": B, "S": S})
        return out

    def window_calls(self) -> list:
        return [{"mode": "prefill", "B": B, "S": S}
                for B, S, *_ in self.calls]

    def end_to_end(self) -> dict:
        tokens = sum(B * S for B, S, *_ in self.calls)
        ttft = [(t1 - t0) * 1e3 for B, _, t0, t1, *_ in self.calls
                for _ in range(B)]
        return {"prefill_tokens_per_s": (tokens / self.window_s, "tokens/s"),
                "ttft_p95_ms": (stats.percentile(ttft, 95), "ms")}

    def attempted(self) -> int:
        return sum(B for B, *_ in self.calls)

    def missing(self) -> int:
        return sum(max(0, B - len(served))
                   for B, _, _, _, _, served in self.calls)

    def release(self) -> None:
        pass

    def check_items(self) -> list:
        """A sample of the window's prompts drawn from the seed: one of each
        length, the longest first, then prompts of the shortest length up
        to ``check_tokens`` prompt tokens in all, so that some hundreds of
        first tokens from many calls and rows are checked."""
        rng = random.Random(sub_seed(self.seed, 4))
        pools: dict = {}
        for i, (B, S, *_) in enumerate(self.calls):
            pools.setdefault(S, []).extend((i, b) for b in range(B))
        lengths = sorted(pools, reverse=True)
        for S in lengths:
            rng.shuffle(pools[S])
        pick = [pools[S][0] for S in lengths]
        used, short = sum(lengths), lengths[-1]
        for ib in pools[short][1:]:
            if used + short > self.mix["check_tokens"]:
                break
            pick.append(ib)
            used += short
        items = []
        for i, b in sorted(pick, key=lambda ib: (-self.calls[ib[0]][1], ib)):
            B, S, _, _, toks, served = self.calls[i]
            items.append(Item(toks[b], [S - 1], served[b:b + 1]
                              if b < len(served) else np.zeros(0, np.int64)))
        return items


class DecodeRunner:
    """``batch`` long sessions in the program's serving engine: prefilled
    in set-up (``Engine._fill_slot``), then every ``Engine.step`` decodes
    all of them by one token."""

    def __init__(self, cfg, weights: dict, traffic: dict, seed: int,
                 device):
        self.cfg, self.w, self.t = cfg, weights, traffic
        self.seed, self.device = seed, device
        self.steps: list = []       # (t0, t1, ctx, active)
        self.window_s = 0.0
        self.engine = None
        self.prompts = None
        self.requests: list = []

    @torch.no_grad()
    def setup(self) -> None:
        from repro_torch.serve import engine as serve_engine
        t = self.t
        toks = Tokens(self.cfg.vocab_size, self.seed, self.device)
        self.prompts = toks.next(t["batch"], t["prompt_len"])
        host = self.prompts.cpu().numpy()
        eng = serve_engine.Engine(self.w, self.cfg, batch=t["batch"],
                                  n_slots=t["n_slots"],
                                  prefill_len=t["prompt_len"],
                                  device=self.device)
        for i in range(t["batch"]):
            r = serve_engine.Request(rid=i, prompt=host[i],
                                     max_new=t["max_new"])
            self.requests.append(r)
            eng.submit(r)
        self.engine = eng
        for _ in range(1 + t["warm_steps"]):   # the prefills, then decode
            eng.step()
        _sync(self.device)

    def _step(self):
        eng = self.engine
        ctx = int(eng.pos.max()) + 1
        active = sum(s is not None for s in eng.slots)
        return eng.step(), ctx, active

    @torch.no_grad()
    def window(self, seconds: float) -> None:
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            t0 = time.perf_counter()
            ran, ctx, active = self._step()
            end = time.perf_counter()
            if not ran:
                break
            self.steps.append((t0, end, ctx, active))
        self.window_s = end - start

    @torch.no_grad()
    def stretch(self, steps: int = 20) -> list:
        out = []
        for _ in range(steps):
            with torch.profiler.record_function("bench.engine_step"):
                ran, ctx, active = self._step()
            if not ran:
                break
            out.append({"mode": "decode", "B": active, "ctx": ctx,
                        "slots": self.t["n_slots"]})
        return out

    def window_calls(self) -> list:
        return [{"mode": "decode", "B": a, "ctx": c,
                 "slots": self.t["n_slots"]} for _, _, c, a in self.steps]

    def end_to_end(self) -> dict:
        itl = [(t1 - t0) * 1e3 for t0, t1, *_ in self.steps]
        return {"itl_p95_ms": (stats.percentile(itl, 95), "ms")}

    def attempted(self) -> int:
        return sum(a for *_, a in self.steps)

    def missing(self) -> int:
        """Tokens a session should hold (one from its prefill, one a decode
        step) that it does not."""
        want = 1 + self.engine.stats.decode_steps
        return sum(abs(want - len(r.generated)) for r in self.requests)

    def release(self) -> None:
        """Free the engine and its cache before the reference runs."""
        self.engine = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check_items(self) -> list:
        """``check_sessions`` sessions drawn from the seed; each checks every
        token it was served, the prefill's first among them."""
        rng = random.Random(sub_seed(self.seed, 4))
        pick = sorted(rng.sample(range(len(self.requests)),
                                 min(self.t["check_sessions"],
                                     len(self.requests))))
        P = self.t["prompt_len"]
        items = []
        for i in pick:
            gen = np.asarray(self.requests[i].generated, np.int64)
            seq = torch.cat([self.prompts[i], torch.as_tensor(
                gen[:-1], dtype=self.prompts.dtype, device=self.device)])
            items.append(Item(seq, list(range(P - 1, P - 1 + len(gen))),
                              gen))
        return items


RUNNERS = {"prefill": PrefillRunner, "decode": DecodeRunner}
