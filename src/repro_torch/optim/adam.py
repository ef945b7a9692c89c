"""Adam on parameter dicts: the port of ``repro.optim.adam``.

``PaperAdam`` is the APC-VFL paper's Adam (``paper_adam``: Kingma & Ba
defaults, Appendix B: b1 0.9, b2 0.999, eps 1e-8, no gradient clipping,
no weight decay), which the tabular stages run.  Its update keeps the
reference's operation order element for element: an int step counter
whose float32 value ``t`` gives the bias corrections ``1 - b**t``, then
``u = (m / bc1) / (sqrt(v / bc2) + eps)`` and ``p - lr * u``.  For a stack
of independent lanes the step is an ``(L,)`` vector and each lane's
correction broadcasts over its own leaves, as the reference's vmapped
update does.

``AdamW`` is the LM trainer's (``train/loop.py``): LLM defaults (b2 0.95,
global-norm clipping at 1.0), decoupled weight decay, fp32 ``m``/``v``
mirrors of each leaf, and new params cast back to each leaf's dtype.
``lr`` may be a float or a 0-dim float32 tensor (a schedule's value).

Plain tensor ops: the reference computes Adam outside any kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sharding.policy import leaves
from repro_torch.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor          # int32: () for one instance, (L,) per lane
    m: dict
    v: dict


class PaperAdam(NamedTuple):
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict, *, lanes: int | None = None) -> AdamState:
        """Zero moments; ``lanes`` gives the step counter a lane axis."""
        zeros = lambda t: tree_map(torch.zeros_like, t)
        dev = tree_leaves(params)[0].device
        shape = () if lanes is None else (lanes,)
        return AdamState(torch.zeros(shape, dtype=torch.int32, device=dev),
                         zeros(params), zeros(params))

    def update(self, grads: dict, state: AdamState, params: dict):
        """One step: returns ``(new_params, new_state)``."""
        step = state.step + 1
        t = step.to(torch.float32)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t

        def upd(g, m, v, p):
            # a lane vector of corrections broadcasts over each lane's leaf
            c1 = bc1.reshape(bc1.shape + (1,) * (p.dim() - bc1.dim()))
            c2 = bc2.reshape(bc2.shape + (1,) * (p.dim() - bc2.dim()))
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            return p - self.lr * u, m, v

        out = tree_map(upd, grads, state.m, state.v, params)
        pick = lambda i: tree_map(lambda o: o[i], out)
        return pick(0), AdamState(step, pick(1), pick(2))


def paper_adam(lr: float = 1e-3) -> PaperAdam:
    """Adam with the APC-VFL paper's settings (Appendix B)."""
    return PaperAdam(lr=lr)



class AdamW(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params: dict) -> AdamState:
        """A 0-dim int32 step and fp32 zero moments on each leaf's
        device."""
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        dev = tree_leaves(params)[0].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         tree_map(zeros, params), tree_map(zeros, params))

    def update(self, grads: dict, state: AdamState, params: dict):
        """One step: returns ``(new_params, new_state, grad_norm)``; the
        norm is the global norm of ``grads`` before clipping."""
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = (torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0)
                 if self.grad_clip else 1.0)
        t = step.to(torch.float32)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        f32 = torch.float32

        def upd(g, m, v, p):
            g = g.to(f32) * scale
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.to(f32)
            new_p = p.to(f32) - self.lr * u
            return new_p.to(p.dtype), m, v

        out = tree_map(upd, grads, state.m, state.v, params)
        pick = lambda i: tree_map(lambda o: o[i], out)
        return pick(0), AdamState(step, pick(1), pick(2)), gnorm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared fp32 entries, leaves in the
    reference's flatten order (dict keys sorted)."""
    return torch.sqrt(sum(torch.sum(leaf.to(torch.float32) ** 2)
                          for leaf in leaves(tree)))


def sgd_momentum_init(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
