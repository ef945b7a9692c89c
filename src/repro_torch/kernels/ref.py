"""Plain PyTorch versions of the kernels in this package: what a CPU
tensor runs, and what the CUDA kernels are held against on the card.
Counterparts of ``repro.kernels.ref``, of the closed-form backward
passes in ``repro.kernels.lane_mlp`` / ``distill_loss`` / ``probe``, and of
the masked softmax the reference's tests hold ``decode_attention`` to, and
of the Mamba2 SSD intra-chunk block (``repro.models.mamba2.ssd_chunked``)
with its sequential oracle.

Each backward here is written out in closed form, as its Pallas kernel
computes it, and is not autograd of the forward.  Every function takes an
optional leading lane axis: weights ``(L, d_in, d_out)`` with biases
``(L, d_out)`` and inputs ``(L, B, d_in)``, or the unstacked shapes."""
from __future__ import annotations

import math

import torch

# jax.nn.selu constants (repro/kernels/lane_mlp.py): the expm1 form, not
# torch.nn.functional.selu, so the port rounds as the reference does
SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946


def selu(a: torch.Tensor) -> torch.Tensor:
    return SELU_SCALE * torch.where(a > 0, a, SELU_ALPHA * torch.expm1(a))


def dselu(a: torch.Tensor) -> torch.Tensor:
    """Exact derivative of the expm1 form (``lane_mlp._dselu``)."""
    return SELU_SCALE * torch.where(a > 0, 1.0, SELU_ALPHA * torch.exp(a))


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(-1, -2)


def lane_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; over a leading lane axis on the CPU, one product a lane.
    The CPU's batched product picks its blocking by the batch count, so
    one lane's bits would depend on how many lanes ride with it (and Adam
    turns such float noise on near-zero gradients into whole steps); a
    2-D product a lane gives each lane the bits of its own fit, whatever
    the stack, as the reference's vmapped lanes do.  A 2-D ``b`` (one
    weight for every lane) broadcasts as ``a @ b``.  Differentiable."""
    if a.dim() == 3 and b.dim() == 3 and a.device.type == "cpu":
        return torch.stack([u @ v for u, v in zip(a, b)])
    return a @ b


def mlp2_fwd_ref(x, w0, b0, w1, b1, *, final_act: bool = False):
    """``(out, a1, a2)``: the forward and the two pre-activations the
    backward needs (``lane_mlp._fwd_kernel``)."""
    a1 = lane_matmul(x, w0) + b0.unsqueeze(-2)
    a2 = lane_matmul(selu(a1), w1) + b1.unsqueeze(-2)
    return (selu(a2) if final_act else a2), a1, a2


def mlp2_ref(x, w0, b0, w1, b1, *, final_act: bool = False):
    """``selu(x @ w0 + b0) @ w1 + b1`` (optionally selu'd): the 2-layer
    Table-3 MLP, weights in ``(d_in, d_out)`` layout."""
    return mlp2_fwd_ref(x, w0, b0, w1, b1, final_act=final_act)[0]


def mlp2_bwd_ref(g, x, a1, a2, w0, w1, final_act: bool = False):
    """Closed-form backward of ``mlp2_ref`` for the output cotangent ``g``
    (``lane_mlp._bwd_kernel``): returns ``(dx, dw0, db0, dw1, db1)``."""
    g2 = g * dselu(a2) if final_act else g
    dw1 = lane_matmul(_t(selu(a1)), g2)
    db1 = g2.sum(-2)
    g1 = lane_matmul(g2, _t(w1)) * dselu(a1)
    dw0 = lane_matmul(_t(x), g1)
    db0 = g1.sum(-2)
    return lane_matmul(g1, _t(w0)), dw0, db0, dw1, db1


def distill_rows_ref(x, x_hat, z, z_t, mask, *, lam: float, kind: str):
    """Per-row Eq. 5 losses (``distill_loss._kernel``):
    ``mean_d (x - x_hat)^2 + lam * mask * mean_m |z - z_t|^p``."""
    rec = torch.mean(torch.square(x - x_hat), dim=-1)
    diff = z - z_t
    dis = torch.mean(torch.abs(diff) if kind == "mae"
                     else torch.square(diff), dim=-1)
    return rec + lam * mask * dis


def distill_rows_bwd_ref(g, x, x_hat, z, z_t, mask, *, lam: float,
                         kind: str):
    """Closed-form backward of ``distill_rows_ref`` for row cotangents
    ``g`` (``distill_loss._bwd_kernel``): returns ``(dx, dz, dmask)``;
    ``d x_hat = -dx`` and ``d z_t = -dz``.  ``sign(0) = 0``, as
    ``jnp.sign``."""
    dx, _, dz, _, dm = distill_bwd_ref(g, x, x_hat, z, z_t, mask, lam=lam,
                                       kind=kind)
    return dx, dz, dm


def distill_bwd_ref(g, x, x_hat, z, z_t, mask, *, lam: float, kind: str,
                    mean_of: int = 0,
                    needs=(True, False, True, False, True)):
    """The backward kernel's interface (``distill_loss.launch_bwd``): for
    row cotangents ``g`` (N,), or with ``mean_of=S`` the cotangents
    (N // S,) of the means of each S consecutive rows (a row's is then
    ``g / S``, as the mean's backward computes it on the CPU), the
    gradients ``(dx, d x_hat, dz, d z_t, dmask)`` that ``needs`` flags,
    None for the others; only those are computed."""
    if mean_of:
        g = (g.reshape(-1, 1) / mean_of).expand(-1, mean_of).reshape(-1)
    D, M = x.shape[-1], z.shape[-1]
    out = [None] * 5
    if needs[0] or needs[1]:
        dx = (g.unsqueeze(-1) * (2.0 / D)) * (x - x_hat)
        out[0], out[1] = (dx if needs[0] else None,
                          -dx if needs[1] else None)
    if not (needs[2] or needs[3] or needs[4]):
        return tuple(out)
    diff = z - z_t
    if needs[2] or needs[3]:
        ddis = torch.sign(diff) / M if kind == "mae" else 2.0 * diff / M
        dz = (g * lam * mask).unsqueeze(-1) * ddis
        out[2], out[3] = (dz if needs[2] else None,
                          -dz if needs[3] else None)
    if needs[4]:
        dis = torch.mean(torch.abs(diff) if kind == "mae"
                         else torch.square(diff), dim=-1)
        out[4] = g * lam * dis
    return tuple(out)


def probe_grad_ref(w, b, x, y, rwn):
    """Weighted softmax-CE loss and its closed-form gradient, without the
    L2 term (``probe._probe_kernel``): returns ``(loss, dw, db)``.
    ``rwn`` are row weights already divided by ``max(sum(rw), 1)``; rows
    of weight 0 are exactly inert.  With a lane axis, ``w`` (k, d, C),
    ``b`` (k, C) and ``rwn`` (k, n) share ``x`` (n, d) and ``y`` (n,)."""
    logits = x @ w + b.unsqueeze(-2)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    se = torch.sum(e, dim=-1, keepdim=True)
    lse = torch.log(se[..., 0]) + m[..., 0]
    onehot = torch.nn.functional.one_hot(
        y.long(), logits.shape[-1]).to(logits.dtype)
    gold = torch.sum(logits * onehot, dim=-1)
    loss = torch.sum((lse - gold) * rwn, dim=-1)
    g = (e / se - onehot) * rwn.unsqueeze(-1)
    return loss, _t(x) @ g, g.sum(-2)


def int8_matmul_ref(x, w_q, scale, b):
    """Weight-only int8: dequantize per output channel, then matmul."""
    return x @ (w_q.to(torch.float32) * scale[None, :]) + b


def check_key_length(S: int, T: int, causal: bool, window: int) -> None:
    """A key length of its own (T != S) only for full attention: the causal
    mask and the window compare a query's position with a key's, which
    only self-attention shares."""
    if T != S and (causal or window):
        raise ValueError(f"flash_attention: {T} keys for {S} queries needs "
                         f"causal=False and window=0, got causal={causal} "
                         f"window={window}")


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, H, S, hd), k/v (B, H, T, hd) -> (B, H, S, hd), softmax in
    fp32 (``repro.kernels.ref.flash_attention_ref``): mask ``j <= i`` when
    causal and ``i - j < window`` when ``window`` > 0; the probabilities
    are cast to q's dtype before the product with v, as the reference.  A
    key length of its own (T != S) takes neither mask: it is the
    reference's ``_sdpa`` with a zero bias (the VLM's cross-attention)."""
    S, T, hd = q.shape[2], k.shape[2], q.shape[-1]
    check_key_length(S, T, causal, window)
    scores = torch.einsum("bhsd,bhtd->bhst", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= j <= i
    if window:
        ok &= (i - j) < window
    scores = torch.where(ok, scores, -1e30)
    # masked pairs weigh exactly 0, so a row with no pair left gives 0, as
    # the kernels do (p = 0 there, out = acc / max(l, 1e-30))
    probs = torch.where(ok, torch.softmax(scores, dim=-1), 0.0)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(q.dtype), v)


def decode_attention_ref(q, k, v, slot_pos, pos, *, window: int = 0):
    """q (BH, hd) one query row per batch*head, k/v (BH, W, hd), slot_pos
    (W,) int, pos an int: the masked softmax the reference's tests hold
    ``decode_attention`` to (slots with ``slot_pos < 0``, ``> pos`` or, with
    a window, ``<= pos - window`` are masked), in fp32, out in q's
    dtype.  A row whose slots are all masked is 0, as in the reference's
    Pallas kernel."""
    hd = q.shape[-1]
    s = torch.einsum("bd,bwd->bw", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        ok &= slot_pos > pos - window
    s = torch.where(ok, s, -1e30)
    # masked slots weigh exactly 0: with every slot masked the row is 0, as
    # in the kernels (p = 0 there, out = acc / max(l, 1e-30))
    p = torch.where(ok, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bw,bwd->bd", p, v.to(torch.float32))
    return out.to(q.dtype)


def expand_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, T, K, hd) -> (B, T, H, hd), each kv head repeated H // K
    times (the reference's ``models.attention._gqa_expand``)."""
    B, T, K, hd = t.shape
    if K == H:
        return t
    return t[:, :, :, None, :].expand(B, T, K, H // K, hd).reshape(
        B, T, H, hd)


def flash_attention_model(q, k, v, *, causal: bool = True, window: int = 0):
    """``flash_attention_ref`` in the model's layout: q (B, S, H, hd), k/v
    (B, T, K, hd) with K dividing H -> (B, S, H, hd)."""
    H = q.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in
                  (q, expand_heads(k, H), expand_heads(v, H)))
    return flash_attention_ref(qt, kt, vt, causal=causal,
                               window=window).transpose(1, 2)


def decode_attention_cache(q, k, v, slot_pos, pos, *, window: int = 0):
    """``decode_attention_ref`` on the cache's layout: q (B, H, hd), k/v
    (B, W, K, hd) with K dividing H -> (B, H, hd); ``pos`` a host int or a
    one-element tensor, read as ``int(pos)``."""
    pos = int(pos)
    B, H, hd = q.shape
    W = k.shape[1]
    kf, vf = (expand_heads(t, H).transpose(1, 2).reshape(B * H, W, hd)
              for t in (k, v))
    return decode_attention_ref(q.reshape(B * H, hd), kf, vf, slot_pos, pos,
                                window=window).reshape(B, H, hd)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

def prefix_sum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """fp32 prefix sums accumulated in float64 and rounded once, which is
    what ``torch.cumsum`` does for fp32 on the CPU.  The SSD kernel sums the
    same way, so the card's plain version, the kernel and the CPU agree on
    every bit of the log-decay sums, whose differences the decays are made
    of (at ``|cs|`` ~ 2e3 one fp32 ulp of ``cs`` is 2.4e-4 of a decay)."""
    return torch.cumsum(a.to(torch.float64), dim).to(torch.float32)


def ssd_intra_chunk_ref(x, dt, A, Bm, Cm, Lc: int, *, bf16: bool = False):
    """The intra-chunk block of the chunked SSD in the model's layout
    (``repro.models.mamba2.ssd_chunked``, the lines from ``xdt`` to
    ``states``): x (B, S, H, P) fp32, dt (B, S, H) fp32, A (H,) fp32, Bm/Cm
    (B, S, G, N) with G dividing H (head h reads group h // (H // G)), and
    ``Lc`` dividing S.  With ``xdt = x * dt``, ``a = dt * A`` and ``cs`` the
    prefix sums of ``a`` over each chunk:

        y[l]  = sum_{s <= l} (C[l] . B[s]) * exp(cs[l] - cs[s]) * xdt[s]
        st    = sum_s B[s]^T * exp(cs[end] - cs[s]) * xdt[s]

    Returns ``y_intra`` (B, S, H, P) fp32 and the chunk-final ``states``
    (B, S // Lc, H, N, P) fp32.  ``bf16`` is ``cfg.ssd_bf16``: the products'
    operands ride in bf16 as the reference's ``cdt`` casts put them."""
    B_, S, H, P = x.shape
    if Lc <= 0 or S % Lc:
        raise ValueError(f"ssd: chunk {Lc} does not divide sequence {S}")
    Nc = S // Lc
    cdt = torch.bfloat16 if bf16 else torch.float32
    ch = lambda t: t.reshape((B_, Nc, Lc) + t.shape[2:])
    xdt = ch(x * dt[..., None]).to(cdt)                     # (B,Nc,Lc,H,P)
    a = ch(dt * A)                                          # (B,Nc,Lc,H)
    Bh = ch(expand_heads(Bm, H)).to(cdt)                    # (B,Nc,Lc,H,N)
    Ch = ch(expand_heads(Cm, H)).to(cdt)
    cs = prefix_sum(a, 2)
    csh = cs.movedim(3, 2)                                  # (B,Nc,H,Lc)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(tri, csh[..., :, None] - csh[..., None, :],
                      -torch.inf)
    Lmat = torch.exp(seg).to(cdt)                           # (B,Nc,H,Lc,Lc)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)
    y = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, xdt).to(
        torch.float32)
    decay_end = torch.exp(cs[:, :, -1:, :] - cs).to(cdt)    # (B,Nc,Lc,H)
    states = torch.einsum("bcshn,bcshp->bchnp", Bh * decay_end[..., None],
                          xdt).to(torch.float32)
    return y.reshape(B_, S, H, P), states


def ssd_chunk_ref(x, dt, A, Bm, Cm):
    """The sequential SSD oracle (``repro.kernels.ref.ssd_chunk_ref``):
    step by step, ``h = h * exp(dt * A) + dt * B^T x`` and ``y = C . h``.
    x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, G, N) -> y (B, S, H,
    P)."""
    B_, S, H, P = x.shape
    N = Bm.shape[3]
    Bh, Ch = expand_heads(Bm, H), expand_heads(Cm, H)
    h = torch.zeros((B_, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)[..., None, None]
        upd = torch.einsum("bh,bhn,bhp->bhnp", dt[:, t], Bh[:, t], x[:, t])
        h = h * decay + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1)
