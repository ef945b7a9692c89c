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
device->host copy of the tokens it produced.  They are read from the same
clock as the spans ``engine.fill_slot`` and ``engine.dispatch``
(``repro_torch.spans``), which a profiler sees beside ``engine.step``.

On a CUDA device a decode step is one CUDA graph.  The step's inputs live
in one static int32 buffer on the device, the B current tokens and then
the lockstep position, filled each step from one pinned host buffer by a
single non-blocking copy; the model reads the position from it
(``attention.decode_attention`` with a tensor ``pos``).  The first decode
step runs eagerly, which warms cuBLAS, the kernels' lazy loads and the
allocator; the second captures the step (``engine.capture``) and every
step from then on replays it, so the host enqueues one copy and one graph
launch where it enqueued every layer's launches.  The graph holds the
addresses of the parameters and of the cache, which the engine updates in
place (refills included), and of its own output.  ``captures`` and
``replays`` count the graph's captures and launches; each replay adds the
captured step's kernel launches to ``kernels.ops.LAUNCHES``, which the
capture itself, running nothing, leaves as it was.  On the CPU the
engine steps eagerly with a host position, as the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, spans
from repro_torch.analysis.guards import to_host
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
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


def require_kv_cache_family(cfg: ModelConfig) -> None:
    """The engine serves the KV-cache families, dense and MoE (the
    reference's assertion, with its words); the hybrid, the VLM and the
    audio encoder are refused, as the reference refuses them."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"{cfg.name}: engine supports KV-cache families; "
                         f"SSM/hybrid use decode() (family {cfg.family!r})")


class Engine:
    """Greedy continuous-batching engine for the dense and MoE decoder
    families."""

    def __init__(self, params, cfg: ModelConfig, *, batch: int,
                 n_slots: int, eos_id: Optional[int] = None,
                 prefill_len: int = 32, device="cuda"):
        require_kv_cache_family(cfg)
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
        self.captures = self.replays = 0
        self._graph = None
        self._graphed = self.device.type == "cuda"
        if self._graphed:     # the step's inputs: B tokens, then the position
            self._inputs_host = torch.empty(batch + 1, dtype=torch.int32,
                                            pin_memory=True)
            self._inputs = torch.empty(batch + 1, dtype=torch.int32,
                                       device=self.device)

    def submit(self, req: Request):
        self.queue.append(req)

    @torch.no_grad()
    def _fill_slot(self, i: int, req: Request):
        with spans.timed("engine.fill_slot") as t:
            P = self.prefill_len
            prompt = np.asarray(req.prompt, np.int32)[:P]
            if len(prompt) < P:
                prompt = np.concatenate(
                    [prompt, np.full(P - len(prompt), prompt[-1], np.int32)])
            tokens = torch.as_tensor(prompt, device=self.device)[None, :]
            logits, cache1 = decoder_prefill_with_cache(
                self.params, self.cfg, tokens, self.n_slots)
            # graft the prefilled rows into slot i of the shared cache (rows
            # beyond P arrive zeroed from the prefill pad)
            self.cache.k[:, i] = cache1.k[:, 0]
            self.cache.v[:, i] = cache1.v[:, 0]
            # slot_pos is shared across the batch: take the union so slots
            # that already decoded past P keep their rows visible.  A slot
            # refilled mid-stream attends zeroed K rows between P and the
            # global position: the reference's documented approximation,
            # kept.
            torch.maximum(self.cache.slot_pos, cache1.slot_pos,
                          out=self.cache.slot_pos)
            self.slots[i] = req
            self.pos[i] = P
            self.cur[i] = int(to_host(torch.argmax(logits[0])))
            req.generated.append(int(self.cur[i]))
            self.stats.tokens_out += 1  # the prefill emits the first token
            self.stats.prefills += 1
        self.prefill_ms.append((t.end_ns - t.start_ns) / 1e6)

    def _retire(self, i: int):
        req = self.slots[i]
        req.done = True
        self.stats.completed += 1
        self.slots[i] = None

    @torch.no_grad()
    def step(self):
        """One engine tick: refill free slots, then one decode step."""
        with spans.span("engine.step"):
            for i in range(self.batch):
                if self.slots[i] is None and self.queue:
                    self._fill_slot(i, self.queue.pop(0))
            active = [i for i in range(self.batch)
                      if self.slots[i] is not None]
            if not active:
                return False
            # lockstep decode: positions differ per slot; cache layout uses
            # the max position for slot_pos (causal mask handles shorter
            # rows).  engine.dispatch ends once every launch of the step is
            # enqueued, before the copy of its tokens waits for them.
            with spans.timed("engine.dispatch") as t:
                pos = int(self.pos.max())
                if self._graphed:
                    nxt = self._graph_step(pos)
                else:
                    tok = torch.as_tensor(self.cur, device=self.device)
                    nxt, self.cache = self._decode(self.params, tok,
                                                   self.cache, pos)
            nxt_np = to_host(nxt)
            self.step_ms.append((time.time_ns() - t.start_ns) / 1e6)
            self.stats.decode_steps += 1
            for i in active:
                self.cur[i] = nxt_np[i]
                self.pos[i] += 1
                req = self.slots[i]
                req.generated.append(int(nxt_np[i]))
                self.stats.tokens_out += 1
                hit_eos = self.eos_id is not None and \
                    int(nxt_np[i]) == self.eos_id
                if len(req.generated) >= req.max_new or hit_eos or \
                        self.pos[i] >= self.n_slots - 1:
                    self._retire(i)
            return True

    def _graph_step(self, pos: int) -> torch.Tensor:
        """Enqueue a decode step on the card: fill the static inputs, then
        run the step eagerly (the first), capture and replay it (the
        second) or replay it; returns the step's tokens on the device.
        The previous step's copy has ended: its tokens reached the host."""
        host = self._inputs_host.numpy()
        host[:-1] = self.cur
        host[-1] = pos
        self._inputs.copy_(self._inputs_host, non_blocking=True)
        tok, pos_d = self._inputs[:-1], self._inputs[-1:]
        if self._graph is None:
            if self.stats.decode_steps == 0:
                return self._decode(self.params, tok, self.cache, pos_d)[0]
            self._capture(tok, pos_d)
        self._graph.replay()
        self.replays += 1
        for name, n in self._graph_launches.items():
            kops.LAUNCHES[name] += n
        return self._next

    def _capture(self, tok: torch.Tensor, pos: torch.Tensor) -> None:
        """Capture one decode step into ``self._graph``, on a side stream
        (``torch.cuda.graph``); it runs nothing."""
        before = dict(kops.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with spans.span("engine.capture"), torch.cuda.graph(graph):
            nxt, cache = self._decode(self.params, tok, self.cache, pos)
        if any(a is not b for a, b in zip(cache, self.cache)):
            raise RuntimeError(
                f"{self.cfg.name}: the decode step returned new cache "
                f"tensors; a CUDA graph replays into the ones it captured")
        self._graph_launches = {k: n - before[k]
                                for k, n in kops.LAUNCHES.items()}
        kops.LAUNCHES.update(before)
        self._graph, self._next = graph, nxt
        self.captures += 1

    def run(self, max_ticks: int = 10_000) -> EngineStats:
        for _ in range(max_ticks):
            if not self.step() and not self.queue:
                break
        return self.stats
