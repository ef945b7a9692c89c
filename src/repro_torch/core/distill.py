"""Paper Eq. 5: composite reconstruction + masked distillation loss; the
port of ``repro.core.distill``.

    L_total(x_i) = L_enc-dec(x_i) + lambda * L_distill(x_i)   if x_i aligned
                 = L_enc-dec(x_i)                              otherwise

L_distill is MSE or MAE between the teacher joint latent z_A_i and the
student latent g3(x_i).  The batch carries z_A rows (zeros where unaligned)
and an ``aligned`` {0,1} mask; masking reproduces the per-sample case split.

``use_kernel=True`` computes the per-row terms through the Eq. 5 kernels
(forward and closed-form backward, ``kernels.ops.fused_distill_rows``).
On a CUDA batch the autoencoder runs through the lane-MLP kernels either
way: the card has no other path for it.  Like the autoencoder losses,
these take an optional leading lane axis and then return ``(L,)``.
"""
from __future__ import annotations

import torch

from repro_torch.core import autoencoder as ae
from repro_torch.kernels import ops as kops


def _student(params: dict, x: torch.Tensor, use_kernel: bool):
    """(z, x_hat): the student's latent and its reconstruction."""
    mlp = ae.fused_mlp_apply if (use_kernel or x.is_cuda) else ae.mlp_apply
    z = mlp(params["enc"], x)
    return z, mlp(params["dec"], z)


def _distance(diff: torch.Tensor, kind: str) -> torch.Tensor:
    return torch.mean(torch.abs(diff) if kind == "mae"
                      else torch.square(diff), dim=-1)


def distill_loss(params: dict, batch: dict, *, lam: float = 0.01,
                 kind: str = "mse", use_kernel: bool = False) -> torch.Tensor:
    x, z_t, mask = batch["x"], batch["z_teacher"], batch["aligned"]
    z, x_hat = _student(params, x, use_kernel)
    if use_kernel:
        return torch.mean(kops.fused_distill_rows(x, x_hat, z, z_t, mask,
                                                  lam=lam, kind=kind),
                          dim=-1)
    rec = torch.mean(torch.square(x - x_hat), dim=-1)             # (B,)
    per_row = rec + lam * _distance(z - z_t, kind) * mask.to(rec.dtype)
    return torch.mean(per_row, dim=-1)


def make_loss(lam: float = 0.01, kind: str = "mse", use_kernel: bool = False):
    def loss(params, batch):
        return distill_loss(params, batch, lam=lam, kind=kind,
                            use_kernel=use_kernel)
    # the reference's semantic identity of the loss (its engine cache key)
    loss.cache_key = ("repro.core.distill.make_loss", float(lam), str(kind),
                      bool(use_kernel))
    return loss


def make_lanes_loss(lam: float = 0.01, kind: str = "mse",
                    use_kernel: bool = False):
    """Eq. 5 for replica-lane batches (``training.train_lanes``): consumes
    the engine's ``mask`` (real-feature columns) and ``row_w`` (real-row
    weights).  With 0/1 weights and no padding this equals
    ``make_loss(lam, kind)`` exactly.  Lanes share the latent width (true
    for every Table-3 architecture: M3 = 256).

    ``use_kernel=True`` computes the per-row terms through the Eq. 5
    kernel, which averages over all D feature columns, so the 0/1 feature
    mask is folded in by pre-masking x / x_hat and rescaling by
    sqrt(D / sum(mask)): exact for 0/1 masks, a no-op for unpadded
    lanes."""
    def loss(params, batch):
        x, z_t, al = batch["x"], batch["z_teacher"], batch["aligned"]
        fm, rw = batch["mask"], batch["row_w"]
        z, x_hat = _student(params, x, use_kernel)
        n_real = torch.clamp(torch.sum(fm, dim=-1, keepdim=True), min=1.0)
        if use_kernel:
            s = torch.sqrt(x.shape[-1] / n_real).unsqueeze(-1)
            m = fm.unsqueeze(-2)
            per_row = kops.fused_distill_rows(x * m * s, x_hat * m * s, z,
                                              z_t, al, lam=lam, kind=kind)
        else:
            se = torch.square(x - x_hat) * fm.unsqueeze(-2)
            rec = torch.sum(se, dim=-1) / n_real                     # (B,)
            per_row = rec + lam * _distance(z - z_t, kind) * al.to(rec.dtype)
        return torch.sum(per_row * rw, dim=-1) / torch.clamp(
            torch.sum(rw, dim=-1), min=1.0)
    loss.cache_key = ("repro.core.distill.make_lanes_loss", float(lam),
                      str(kind), bool(use_kernel))
    return loss
