"""Training step factory for the LM families (the dense and MoE decoders,
the zamba2 hybrid, the VLM (its batches carry ``image_embeds``), the xLSTM
and the encoder-only audio stack): LM
cross-entropy (all decoder families), frame cross-entropy (audio), and
the paper's ``apcvfl_distill`` composite objective (Eq. 5) scaled to a
sequence backbone.  The port of ``repro.train.loop``.  Both objectives
add the MoE aux term, ``cfg.router_aux_weight * aux``.

The APC-VFL objective treats the backbone as the student encoder g3: its
mean-pooled final hidden state is the representation z = g3(x).  The batch
carries a per-row ``aligned`` mask and the teacher joint latents
``z_teacher`` (zeros for unaligned rows); the loss is
    L = L_task + lambda * mean_over_aligned ||z - z_teacher||^2
mirroring the tabular Eq. 5 (L_task plays the role of L_enc-dec).  It is
computed with PyTorch ops, as the reference computes it with ``jnp``: it
is not the tabular Eq. 5 kernel's function.

The step runs under autograd, so the models take the reference's training
route (``models/attention.py``: ``_sdpa`` and the SSD's einsums, no
forward-only kernel); an eval pass under ``torch.no_grad()`` runs the
kernels on the card.  One eager step takes the place of the reference's
jitted one.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.common import unshard_dim
from repro_torch.optim.adam import AdamW
from repro_torch.optim.schedule import accumulate_grads
from repro_torch.sharding.policy import DTYPES, init_params


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE; logits (..., V) any dtype, stable fp32 reduction."""
    # under a mesh (the dry run) the vocab dim is gathered whole and any
    # partial sums reduced first: DTensor's rule for a gather along a
    # sharded or partial dim fails
    logits = unshard_dim(logits, -1, reduce_partial=True).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def task_loss(params, cfg: ModelConfig, batch: dict):
    """Next-token cross-entropy (audio: each frame's CE against
    ``batch["labels"]``, no shift) plus the MoE aux term (0.0 without
    experts): ``(loss, {"ce", "aux"})``."""
    lg, aux = M.logits(params, cfg, batch)
    if cfg.family == "audio":
        ce = cross_entropy(lg, batch["labels"])
    else:  # causal LM: next-token prediction
        ce = cross_entropy(lg[:, :-1], batch["tokens"][:, 1:])
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


def apcvfl_distill_loss(params, cfg: ModelConfig, batch: dict,
                        lam: float = 0.01, distill: str = "mse"):
    """Paper Eq. 5 on sequence backbones (module docstring)."""
    h, aux = M.hidden(params, cfg, batch)                # (B, S, d)
    z = torch.mean(h.to(torch.float32), dim=1)          # (B, d) student rep
    lg = torch.einsum("bsd,dv->bsv", h,
                      params["embed"]["out"].to(h.dtype))
    ce = cross_entropy(lg[:, :-1], batch["tokens"][:, 1:])
    diff = z - batch["z_teacher"].to(torch.float32)
    per_row = (torch.mean(torch.abs(diff), dim=-1) if distill == "mae"
               else torch.mean(diff * diff, dim=-1))    # (B,)
    mask = batch["aligned"].to(torch.float32)
    dloss = torch.sum(per_row * mask) / torch.clamp(torch.sum(mask), min=1.0)
    loss = ce + lam * dloss + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "distill": dloss, "aux": aux}


class TrainStepFns(NamedTuple):
    init: Callable
    step: Callable


def make_train_step(cfg: ModelConfig, opt: AdamW = AdamW(),
                    objective: str = "lm", n_micro: int = 1,
                    lr_schedule=None) -> TrainStepFns:
    """``init(gen)`` materializes ``cfg``'s params in ``cfg.dtype`` on the
    device of the ``torch.Generator`` ``gen`` (drawn in the reference's
    flatten order; the numbers differ from its ``jax.random`` draws) and
    the optimizer state; ``step(params, opt_state, batch)`` returns
    ``(params, opt_state, metrics)`` with ``loss``, ``grad_norm`` and the
    objective's parts.  ``lr_schedule(step)`` sets the lr of each step
    from the 1-based step count.  An unknown family raises
    (``models/model.py``)."""
    loss_fn = {"lm": task_loss,
               "apcvfl_distill": apcvfl_distill_loss}[objective]
    M.schema(cfg)                     # refuse an unknown family now

    def init(gen: torch.Generator):
        params = init_params(M.schema(cfg), gen, DTYPES[cfg.dtype],
                             device=gen.device)
        return params, opt.init(params)

    vag = accumulate_grads(lambda p, b: loss_fn(p, cfg, b), n_micro)

    def step(params, opt_state, batch):
        (loss, metrics), grads = vag(params, batch)
        o = (opt._replace(lr=lr_schedule(opt_state.step + 1))
             if lr_schedule is not None else opt)
        with torch.no_grad():
            params, opt_state, gnorm = o.update(grads, opt_state, params)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics

    return TrainStepFns(init, step)
