"""Public wrappers around the port's kernels.

A CPU tensor takes the plain PyTorch version (``kernels.ref``); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback.
``LAUNCHES`` counts kernel launches per kernel, incremented right where a
kernel is launched and nowhere else, so a run can show that its path went
through the kernels (``reset_launches`` zeroes it).  ``lane_mlp_bwd``
counts one per backward, which is a pair of launches (g1 and dW1, then dW0
and dx; on the narrow route the rows pass, then the fold of its tile
partials).

The attention wrappers take the model's layouts and grouped-query heads
as they are (k/v with K kv heads, K dividing H): the kernels map q head
``h`` to kv head ``h // (H // K)``, and only the plain path expands them.

``ssd_intra_chunk`` likewise takes the model's layout (B and C per group,
G dividing the heads) and returns the states in the layout the inter-chunk
recurrence reads.

The two differentiable kernels carry a ``torch.autograd.Function`` whose
backward is the closed-form backward kernel (on the CPU its plain
version), as the reference's ``jax.custom_vjp`` does: ``LaneMLP2`` for the
lane-MLP, ``DistillRows`` for the Eq. 5 row loss and ``DistillMean`` for
its mean, whose backward folds the mean's in.  The three
forward-only kernels (flash attention, decode attention, the SSD block)
refuse a CUDA input that requires grad while grad is enabled, rather than
return an output detached from the graph; on the CPU their plain versions
stay differentiable.  The models never hand them such an input: under
autograd they take the reference's training route (``models/attention.py``
``needs_grad``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

LAUNCHES = {"lane_mlp_fwd": 0, "lane_mlp_bwd": 0, "int8_matmul": 0,
            "distill_fwd": 0, "distill_bwd": 0, "probe": 0,
            "flash_attention": 0, "decode_attention": 0,
            "ssd_intra_chunk": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _refuse_grad(what: str, *ts: torch.Tensor) -> None:
    """Raise where a forward-only kernel would silently cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, so its output would "
            f"be detached from autograd; under autograd the models take "
            f"the reference's training route instead (attention's _sdpa, "
            f"the SSD's einsums; the JAX package differentiates no Pallas "
            f"kernel there either): call the kernel under torch.no_grad() "
            f"or with inputs that do not require grad")


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{what}: no kernel or plain path for device "
                     f"{x.device}")


# ---------------------------------------------------------------------------
# lane MLP
# ---------------------------------------------------------------------------

class LaneMLP2(torch.autograd.Function):
    """``selu(x @ w0 + b0) @ w1 + b1`` (optionally selu'd) over a lane
    stack: xs (L, B, din), w0s (L, din, h), b0s (L, h), w1s (L, h, dz),
    b1s (L, dz).  Forward and backward are the lane-MLP kernels on CUDA,
    ``ref.mlp2_fwd_ref`` / ``ref.mlp2_bwd_ref`` on the CPU."""

    @staticmethod
    def forward(ctx, xs, w0s, b0s, w1s, b1s, final_act):
        ctx.final_act = final_act
        if not _on_cuda(xs, "fused_mlp2"):
            out, a1, a2 = ref.mlp2_fwd_ref(xs, w0s, b0s, w1s, b1s,
                                           final_act=final_act)
        else:
            from repro_torch.kernels import lane_mlp
            xs, w0s, b0s, w1s, b1s = (t.contiguous() for t in
                                      (xs, w0s, b0s, w1s, b1s))
            out, a1, a2 = lane_mlp.launch(xs, w0s, b0s, w1s, b1s,
                                          final_act=final_act, save=True)
            LAUNCHES["lane_mlp_fwd"] += 1
        ctx.save_for_backward(xs, a1, a2, w0s, w1s)
        return out

    @staticmethod
    def backward(ctx, g):
        xs, a1, a2, w0s, w1s = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        if not _on_cuda(xs, "fused_mlp2"):
            dx, dw0, db0, dw1, db1 = ref.mlp2_bwd_ref(
                g, xs, a1, a2, w0s, w1s, ctx.final_act)
        else:
            from repro_torch.kernels import lane_mlp
            dx, dw0, db0, dw1, db1 = lane_mlp.launch_bwd(
                g.contiguous(), xs, a1, a2, w0s, w1s,
                final_act=ctx.final_act, need_dx=need_dx)
            LAUNCHES["lane_mlp_bwd"] += 1
        return (dx if need_dx else None), dw0, db0, dw1, db1, None


def lane_mlp2(xs, w0s, b0s, w1s, b1s, *, final_act: bool = False):
    """The lane-stacked MLP, xs (L, B, din) with (L, ...) weight stacks:
    one lane-MLP kernel launch on CUDA for all L lanes, differentiable
    (``LaneMLP2``); without a gradient to record it saves nothing."""
    if xs.shape[-2] == 0:
        return xs.new_zeros(xs.shape[:-1] + (w1s.shape[-1],))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, w0s, b0s, w1s, b1s)):
        return LaneMLP2.apply(xs, w0s, b0s, w1s, b1s, bool(final_act))
    if not _on_cuda(xs, "fused_mlp2"):
        return ref.mlp2_ref(xs, w0s, b0s, w1s, b1s, final_act=final_act)
    from repro_torch.kernels import lane_mlp
    out = lane_mlp.launch(*(t.contiguous()
                            for t in (xs, w0s, b0s, w1s, b1s)),
                          final_act=final_act)
    LAUNCHES["lane_mlp_fwd"] += 1
    return out


def fused_mlp2(x, w0, b0, w1, b1, *, final_act: bool = False):
    """Fused ``selu(x @ w0 + b0) @ w1 + b1`` (optionally selu'd).
    x (B, din), w0 (din, h), w1 (h, dz): one lane-MLP kernel launch on
    CUDA, the plain version on the CPU; differentiable (``LaneMLP2``)."""
    return lane_mlp2(x[None], w0[None], b0[None], w1[None], b1[None],
                     final_act=final_act)[0]


def fused_lane_mlp2(xs, w0s, b0s, w1s, b1s, live, *,
                    final_act: bool = False):
    """The lane-stacked form: xs (L, B, din) with per-lane weight stacks
    and a ``live`` (L,) 0/1 mask; dead lanes produce exact zeros (and,
    through the backward, exact zero gradients)."""
    out = lane_mlp2(xs, w0s, b0s, w1s, b1s, final_act=final_act)
    return out * live.to(out.dtype)[:, None, None]


# ---------------------------------------------------------------------------
# Eq. 5 row loss
# ---------------------------------------------------------------------------

def _distill_bwd(ctx, g, mean_of: int):
    """The Eq. 5 backward for ``DistillRows`` (row cotangents) and
    ``DistillMean`` (the means' cotangents, ``mean_of`` rows each): one
    launch writing the gradients autograd asks for, None for the rest."""
    x, x_hat, z, z_t, mask = ctx.saved_tensors
    needs = tuple(ctx.needs_input_grad[:5])
    kw = dict(lam=ctx.lam, kind=ctx.kind, mean_of=mean_of, needs=needs)
    if not _on_cuda(x, "fused_distill_rows"):
        return ref.distill_bwd_ref(g.reshape(-1), x, x_hat, z, z_t, mask,
                                   **kw)
    from repro_torch.kernels import distill_loss
    grads = distill_loss.launch_bwd(g.reshape(-1).contiguous(), x, x_hat, z,
                                    z_t, mask, **kw)
    LAUNCHES["distill_bwd"] += 1
    return grads


def _distill_inputs(x, x_hat, z, z_t, mask, kind, what):
    """2-D rows (a leading lane axis folded in), contiguous on CUDA."""
    if kind not in ("mse", "mae"):
        raise ValueError(f"{what}: unknown kind {kind!r}")
    D, M = x.shape[-1], z.shape[-1]
    ts = (x.reshape(-1, D), x_hat.reshape(-1, D), z.reshape(-1, M),
          z_t.reshape(-1, M), mask.reshape(-1).to(x.dtype))
    return tuple(t.contiguous() for t in ts) if _on_cuda(x, what) else ts


class DistillRows(torch.autograd.Function):
    """Per-row Eq. 5 losses over 2-D rows; the backward returns the
    gradients autograd asks for of ``(dx, -dx, dz, -dz, dmask)``, as the
    reference's custom VJP computes them."""

    @staticmethod
    def forward(ctx, x, x_hat, z, z_t, mask, lam, kind):
        ctx.lam, ctx.kind = lam, kind
        if not _on_cuda(x, "fused_distill_rows"):
            out = ref.distill_rows_ref(x, x_hat, z, z_t, mask, lam=lam,
                                       kind=kind)
        else:
            from repro_torch.kernels import distill_loss
            out = distill_loss.launch_fwd(x, x_hat, z, z_t, mask, lam=lam,
                                          kind=kind)
            LAUNCHES["distill_fwd"] += 1
        ctx.save_for_backward(x, x_hat, z, z_t, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_distill_bwd(ctx, g, 0), None, None)


class DistillMean(torch.autograd.Function):
    """Eq. 5's mean over the rows of each lane: 2-D rows of ``lead`` (the
    callers' leading shape, lanes then rows) in, the means of shape
    ``lead[:-1]`` out.  On CUDA the forward is one launch (rows and means)
    and the backward one launch with the mean's backward folded in."""

    @staticmethod
    def forward(ctx, x, x_hat, z, z_t, mask, lam, kind, lead):
        ctx.lam, ctx.kind, ctx.rows = lam, kind, lead[-1]
        if not _on_cuda(x, "fused_distill_loss"):
            out = torch.mean(ref.distill_rows_ref(
                x, x_hat, z, z_t, mask, lam=lam, kind=kind).reshape(lead),
                dim=-1)
        else:
            from repro_torch.kernels import distill_loss
            _, out = distill_loss.launch_fwd(x, x_hat, z, z_t, mask, lam=lam,
                                             kind=kind, mean_of=lead[-1])
            LAUNCHES["distill_fwd"] += 1
            out = out.reshape(lead[:-1])
        ctx.save_for_backward(x, x_hat, z, z_t, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_distill_bwd(ctx, g, ctx.rows), None, None, None)


def fused_distill_rows(x, x_hat, z, z_t, mask, *, lam: float = 0.01,
                       kind: str = "mse"):
    """Per-row Eq. 5 losses: x/x_hat (..., B, D), z/z_t (..., B, M), mask
    (..., B); a leading lane axis is folded into the rows.  One kernel
    launch on CUDA, differentiable (``DistillRows``)."""
    rows = DistillRows.apply(
        *_distill_inputs(x, x_hat, z, z_t, mask, kind, "fused_distill_rows"),
        float(lam), str(kind))
    return rows.reshape(x.shape[:-1])


def fused_distill_loss(x, x_hat, z, z_t, mask, *, lam: float = 0.01,
                       kind: str = "mse"):
    """Paper Eq. 5, the mean of ``fused_distill_rows`` over the rows: a
    scalar for 2-D rows, one mean per lane for a leading lane axis (the
    lane convention of ``core.distill``).  One forward launch and one
    backward launch on CUDA (``DistillMean``)."""
    if x.shape[-2] == 0:
        raise ValueError("fused_distill_loss: the mean of no rows")
    return DistillMean.apply(
        *_distill_inputs(x, x_hat, z, z_t, mask, kind, "fused_distill_loss"),
        float(lam), str(kind), tuple(x.shape[:-1]))


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------

def probe_grad_step(w, b, x, y, rw, *, l2: float = 1e-4):
    """One weighted softmax-CE probe step: returns ``(loss, dW, db)``.

    w (d, C), b (C,), x (n, d), y (n,) int labels, rw (n,) row weights
    (0 disables a row exactly); or the lane form, w (k, d, C), b (k, C),
    rw (k, n) for k fold probes sharing x and y, in one call of the
    kernel's entry point (a launch pair per group of lanes: the kernel and
    the sum of its per-block partials; ``LAUNCHES["probe"]`` counts calls).
    The weights are normalized by ``max(sum(rw), 1)`` before the kernel
    and the L2 term is added after it, as the reference does."""
    lanes = w.dim() == 3
    W, B, RW = (w, b, rw) if lanes else (w[None], b[None], rw[None])
    rwn = (RW / torch.clamp(torch.sum(RW, dim=-1, keepdim=True), min=1.0)
           ).to(torch.float32)
    if not _on_cuda(x, "probe_grad_step"):
        loss, dw, db = ref.probe_grad_ref(W, B, x, y, rwn)
    else:
        from repro_torch.kernels import probe
        loss, dw, db = probe.launch(W.contiguous(), B.contiguous(),
                                    x.contiguous(),
                                    y.to(torch.int32).contiguous(),
                                    rwn.contiguous())
        LAUNCHES["probe"] += 1
    loss = loss + l2 * torch.sum(torch.square(W), dim=(-2, -1))
    dw = dw + 2.0 * l2 * W
    return (loss, dw, db) if lanes else (loss[0], dw[0], db[0])


# ---------------------------------------------------------------------------
# int8 matmul
# ---------------------------------------------------------------------------

def int8_matmul(x, w_q, scale, b, *, act: str = "none"):
    """Weight-only int8 matmul with the per-channel dequant fused in, plus
    an optional SELU: the quantized serving path's GEMM."""
    if act not in ("none", "selu"):
        raise ValueError(f"int8_matmul: unknown act {act!r}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul: w_q must be int8, got {w_q.dtype}")
    if not _on_cuda(x, "int8_matmul"):
        out = ref.int8_matmul_ref(x, w_q, scale, b)
        return ref.selu(out) if act == "selu" else out
    if x.shape[0] == 0:
        return x.new_zeros((0, w_q.shape[1]))
    from repro_torch.kernels import int8_matmul as i8
    out = i8.launch(x, w_q, scale, b, act=act)
    LAUNCHES["int8_matmul"] += 1
    return out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, S, H, hd), k/v (B, T, K, hd) [model layout] -> (B, S, H, hd):
    one flash-attention launch on CUDA; on the CPU
    ``ref.flash_attention_model`` (``flash_attention_ref`` with the kv heads
    expanded).  T = S for self-attention; a key length of its own (the
    VLM's cross-attention to its image tokens) only with ``causal=False``
    and ``window=0``, else ``ValueError``."""
    H = q.shape[2]
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"flash_attention: {k.shape[2]} kv heads do not "
                         f"divide {H} heads")
    ref.check_key_length(q.shape[1], k.shape[1], causal, window)
    if not _on_cuda(q, "flash_attention"):
        return ref.flash_attention_model(q, k, v, causal=causal,
                                         window=window)
    _refuse_grad("flash_attention", q, k, v)
    from repro_torch.kernels import flash_attention as fa
    out = fa.launch(q.contiguous(), k.contiguous(), v.contiguous(),
                    causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q, k, v, slot_pos, pos, *, window: int = 0):
    """One-token cache attention: q (B, H, hd), k/v (B, W, K, hd) [the
    cache's layout], slot_pos (W,) int32, pos a host int or a (1,) int32
    tensor on q's device -> (B, H, hd).  One decode-attention launch on
    CUDA, which reads a tensor ``pos`` from device memory; on the CPU
    ``ref.decode_attention_cache`` (``decode_attention_ref`` over (B*H, W,
    hd) rows)."""
    H = q.shape[1]
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"decode_attention: {k.shape[2]} kv heads do not "
                         f"divide {H} heads")
    if not _on_cuda(q, "decode_attention"):
        return ref.decode_attention_cache(q, k, v, slot_pos, pos,
                                          window=window)
    _refuse_grad("decode_attention", q, k, v)
    from repro_torch.kernels import decode_attention as da
    out = da.launch(q.contiguous(), k.contiguous(), v.contiguous(),
                    slot_pos.to(torch.int32).contiguous(), pos,
                    window=window)
    LAUNCHES["decode_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

def ssd_intra_chunk(x, dt, A, Bm, Cm, chunk: int, *, bf16: bool = False):
    """The SSD intra-chunk block in the model's layout: x (B, S, H, P), dt
    (B, S, H), A (H,), Bm/Cm (B, S, G, N), ``chunk`` dividing S -> (y_intra
    (B, S, H, P), states (B, S // chunk, H, N, P)), fp32.  One SSD kernel
    launch on CUDA; on the CPU ``ref.ssd_intra_chunk_ref``.  ``bf16`` is
    ``cfg.ssd_bf16``, the opt-in precision variant: the kernel's bf16
    variant on CUDA, the plain version's bf16 route on the CPU."""
    if not _on_cuda(x, "ssd_intra_chunk"):
        return ref.ssd_intra_chunk_ref(x, dt, A, Bm, Cm, chunk, bf16=bf16)
    _refuse_grad("ssd_intra_chunk", x, dt, A, Bm, Cm)
    from repro_torch.kernels import ssd_chunk
    out = ssd_chunk.launch(*(t.contiguous() for t in (x, dt, A, Bm, Cm)),
                           int(chunk), bf16=bool(bf16))
    LAUNCHES["ssd_intra_chunk"] += 1
    return out
