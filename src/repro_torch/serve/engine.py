"""Batched serving engine with continuous batching (slot scheduler), a
copy of ``repro.serve.engine``.

A fixed pool of ``batch`` slots decodes in lockstep against a shared KV
cache; finished sequences (max-tokens or EOS) are retired and their slot
is refilled from the request queue by prefilling the new prompt into that
slot's cache rows.  Prefill uses the cache-emitting forward
(``decoder_prefill_with_cache``), decode the one-token step.  The
scheduler is the reference's, including its shared ``slot_pos`` (the
union over slots) and its lockstep position (the largest of the slots'),
since both are part of the function served.

The engine owns its cache and updates it in place; the prefill returns a
cache of its own, whose rows are copied into the slot.  Besides the
reference's ``EngineStats`` it keeps host-clock times: ``prefill_ms`` per
prefill and ``step_ms`` per decode step, each ending in the one
device->host copy of the tokens it produced.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.transformer import decoder_prefill_with_cache
from repro_torch.serve.decode import make_decode_step
from repro_torch.tree import tree_map


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new: int = 16
    generated: list = field(default_factory=list)
    done: bool = False


@dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    completed: int = 0
    tokens_out: int = 0


class Engine:
    """Greedy continuous-batching engine for the dense decoder family."""

    def __init__(self, params, cfg: ModelConfig, *, batch: int,
                 n_slots: int, eos_id: Optional[int] = None,
                 prefill_len: int = 32, device="cuda"):
        if cfg.family != "dense":
            raise ValueError("engine supports KV-cache families; SSM/hybrid "
                             "use decode()")
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.cfg = cfg
        self.batch, self.n_slots = batch, n_slots
        self.eos_id = eos_id
        # prompts are right-padded (repeat last token) to a fixed prefill
        # length so every slot's cache has the same filled prefix: the
        # shared slot_pos vector then masks identically for all slots.
        self.prefill_len = prefill_len
        self.cache = M.init_cache(self.params, cfg, batch, n_slots)
        self.pos = np.zeros(batch, np.int32)          # next position per slot
        self.cur = np.zeros(batch, np.int32)          # last token per slot
        self.slots: List[Optional[Request]] = [None] * batch
        self.queue: List[Request] = []
        self.stats = EngineStats()
        self.prefill_ms: List[float] = []
        self.step_ms: List[float] = []
        self._decode = make_decode_step(cfg, 0)

    def submit(self, req: Request):
        self.queue.append(req)

    @torch.no_grad()
    def _fill_slot(self, i: int, req: Request):
        t0 = time.perf_counter()
        P = self.prefill_len
        prompt = np.asarray(req.prompt, np.int32)[:P]
        if len(prompt) < P:
            prompt = np.concatenate(
                [prompt, np.full(P - len(prompt), prompt[-1], np.int32)])
        tokens = torch.as_tensor(prompt, device=self.device)[None, :]
        logits, cache1 = decoder_prefill_with_cache(self.params, self.cfg,
                                                    tokens, self.n_slots)
        # graft the prefilled rows into slot i of the shared cache (rows
        # beyond P arrive zeroed from the prefill pad)
        self.cache.k[:, i] = cache1.k[:, 0]
        self.cache.v[:, i] = cache1.v[:, 0]
        # slot_pos is shared across the batch: take the union so slots that
        # already decoded past P keep their rows visible.  A slot refilled
        # mid-stream attends zeroed K rows between P and the global
        # position: the reference's documented approximation, kept.
        torch.maximum(self.cache.slot_pos, cache1.slot_pos,
                      out=self.cache.slot_pos)
        self.slots[i] = req
        self.pos[i] = P
        self.cur[i] = int(torch.argmax(logits[0]))
        req.generated.append(int(self.cur[i]))
        self.stats.tokens_out += 1      # the prefill emits the first token
        self.stats.prefills += 1
        self.prefill_ms.append((time.perf_counter() - t0) * 1e3)

    def _retire(self, i: int):
        req = self.slots[i]
        req.done = True
        self.stats.completed += 1
        self.slots[i] = None

    @torch.no_grad()
    def step(self):
        """One engine tick: refill free slots, then one decode step."""
        for i in range(self.batch):
            if self.slots[i] is None and self.queue:
                self._fill_slot(i, self.queue.pop(0))
        active = [i for i in range(self.batch) if self.slots[i] is not None]
        if not active:
            return False
        # lockstep decode: positions differ per slot; cache layout uses the
        # max position for slot_pos (causal mask handles shorter rows)
        t0 = time.perf_counter()
        pos = int(self.pos.max())
        tok = torch.as_tensor(self.cur, device=self.device)
        nxt, self.cache = self._decode(self.params, tok, self.cache, pos)
        nxt_np = nxt.cpu().numpy()
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        self.stats.decode_steps += 1
        for i in active:
            self.cur[i] = nxt_np[i]
            self.pos[i] += 1
            req = self.slots[i]
            req.generated.append(int(nxt_np[i]))
            self.stats.tokens_out += 1
            hit_eos = self.eos_id is not None and int(nxt_np[i]) == self.eos_id
            if len(req.generated) >= req.max_new or hit_eos or \
                    self.pos[i] >= self.n_slots - 1:
                self._retire(i)
        return True

    def run(self, max_ticks: int = 10_000) -> EngineStats:
        for _ in range(max_ticks):
            if not self.step() and not self.queue:
                break
        return self.stats
