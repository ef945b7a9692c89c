"""The port's attention kernels' plain versions and wrappers against the
live JAX package on the CPU: ``ref.flash_attention_ref`` and
``ops.flash_attention`` against the Pallas flash kernel in interpret mode
(a subset of ``tests/test_kernels.py``'s sweep), ``ref.decode_attention_ref``
and ``ops.decode_attention`` against ``repro.kernels.decode_attention``
(interpret mode) and the model's decode softmax.  Bounds are the
reference's: 2e-5 fp32, 3e-2 bf16.  Inputs come from a numpy seed."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import flash_attention_ref as jflash_ref
from repro.models.attention import _gqa_expand as jgqa
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        a16 = a.astype(ml_dtypes.bfloat16)
        return (jnp.asarray(a16),
                torch.from_numpy(a16.view(np.uint16).copy()).view(
                    torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("S,hd,bq,bk", [(128, 64, 64, 64),
                                        (256, 32, 128, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
def test_flash_attention_ref_matches_pallas_kernel(S, hd, bq, bk, causal,
                                                   window):
    B, H = 1, 2
    arrs = [_both(_randn(S + hd + i, B, H, S, hd), "float32")
            for i in range(3)]
    want = jflash(*(a for a, _ in arrs), causal=causal, window=window,
                  block_q=bq, block_k=bk, interpret=True)
    got = ref.flash_attention_ref(*(t for _, t in arrs), causal=causal,
                                  window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ref_dtypes(dtype):
    B, H, S, hd = 2, 2, 64, 32
    arrs = [_both(_randn(7 + i, B, H, S, hd), dtype) for i in range(3)]
    want = jflash_ref(*(a for a, _ in arrs), causal=True)
    got = ref.flash_attention_ref(*(t for _, t in arrs), causal=True)
    assert got.dtype == arrs[0][1].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("H,K,window", [(4, 4, 0), (4, 2, 0), (4, 2, 24),
                                        (4, 1, 0)])
def test_ops_flash_attention_model_layout_and_gqa(H, K, window):
    """``ops.flash_attention`` takes (B, S, H, hd) q and (B, S, K, hd) k/v:
    on the CPU it equals the JAX model-layout wrapper on GQA-expanded
    heads (Pallas interpret mode)."""
    B, S, hd = 2, 64, 32
    q = _randn(1, B, S, H, hd)
    k, v = _randn(2, B, S, K, hd), _randn(3, B, S, K, hd)
    want = jops.flash_attention(jnp.asarray(q), jgqa(jnp.asarray(k), H, K),
                                jgqa(jnp.asarray(v), H, K), causal=True,
                                window=window)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=window)
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert ops.LAUNCHES["flash_attention"] == 0     # the plain path


def test_ops_flash_attention_backpropagates_on_cpu():
    """On the CPU the wrapper's plain version stays differentiable (the
    card's forward-only kernel refuses grad instead): the gradients of q, k
    and v match ``jax.grad`` through the reference's plain attention on
    GQA-expanded heads."""
    B, S, H, K, hd, window = 2, 48, 4, 2, 16, 20
    q = _randn(30, B, S, H, hd)
    k, v = _randn(31, B, S, K, hd), _randn(32, B, S, K, hd)
    w = _randn(33, B, S, H, hd)

    def jloss(q, k, v):
        out = jflash_ref(*(t.transpose(0, 2, 1, 3) for t in (
            q, jgqa(k, H, K), jgqa(v, H, K))), causal=True, window=window)
        return jnp.sum(out.transpose(0, 2, 1, 3) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*ts, causal=True, window=window)
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-5,
                                   rtol=2e-5)
    assert ops.LAUNCHES["flash_attention"] == 0     # the plain path


def _slots(W, pos):
    sp = np.where(np.arange(W) <= pos, np.arange(W), -1).astype(np.int32)
    sp[3] = -1                                      # an empty slot inside
    return sp


@pytest.mark.parametrize("W,hd,bw,window", [(64, 32, 16, 0),
                                            (128, 64, 32, 48)])
def test_decode_attention_ref_matches_pallas_kernel(W, hd, bw, window):
    BH = 4
    q, k, v = (_randn(W + hd + i, *s) for i, s in
               enumerate(((BH, hd), (BH, W, hd), (BH, W, hd))))
    pos = W * 3 // 4
    sp = _slots(W, pos)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(sp), jnp.int32(pos), window=window,
                   block_w=bw, interpret=True)
    got = ref.decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v, sp)), pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("sp,pos,window", [
    (np.full(32, -1, np.int32), 10, 0),                  # every slot empty
    (np.arange(32, dtype=np.int32), 100, 16)])          # all out of window
def test_decode_attention_every_slot_masked_is_zero(sp, pos, window):
    """A row whose slots are all masked is 0 in the plain version and the
    wrapper, as in the Pallas kernel (interpret mode)."""
    BH, W, hd, H, K = 4, 32, 16, 2, 1
    q, k, v = (_randn(40 + i, *s) for i, s in
               enumerate(((BH, hd), (BH, W, hd), (BH, W, hd))))
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(sp), jnp.int32(pos), window=window,
                   block_w=16, interpret=True)
    got = ref.decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v, sp)), pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert not np.asarray(want).any() and not got.any()
    B = BH // H
    wrapped = ops.decode_attention(
        torch.from_numpy(q).reshape(B, H, hd),
        torch.from_numpy(k[:B]).reshape(B, W, K, hd),
        torch.from_numpy(v[:B]).reshape(B, W, K, hd),
        torch.from_numpy(sp), pos, window=window)
    assert not wrapped.any()


@pytest.mark.parametrize("K,window", [(2, 0), (4, 0), (2, 20)])
def test_ops_decode_attention_matches_jax_wrapper_and_model_softmax(K,
                                                                    window):
    """``ops.decode_attention`` reads the (B, W, K, hd) cache as it is: on
    the CPU it equals the JAX wrapper on GQA-expanded heads (Pallas
    interpret mode) and the model's decode softmax."""
    B, H, W, hd = 2, 4, 64, 32
    q = _randn(1, B, H, hd)
    kc, vc = _randn(2, B, W, K, hd), _randn(3, B, W, K, hd)
    pos = 50
    sp = _slots(W, pos)
    ke, ve = jgqa(jnp.asarray(kc), H, K), jgqa(jnp.asarray(vc), H, K)
    want = jops.decode_attention(jnp.asarray(q), ke, ve, jnp.asarray(sp),
                                 jnp.int32(pos), window=window)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc,
                                                               sp)),
                               pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    s = jnp.einsum("bhd,bwhd->bhw", jnp.asarray(q), ke) / np.sqrt(hd)
    ok = (sp >= 0) & (sp <= pos)
    if window:
        ok &= sp > pos - window
    s = jnp.where(jnp.asarray(ok), s, -1e30)
    model = jnp.einsum("bhw,bwhd->bhd", jax.nn.softmax(s, -1), ve)
    np.testing.assert_allclose(got.numpy(), np.asarray(model), atol=2e-5)
    assert ops.LAUNCHES["decode_attention"] == 0    # the plain path


def test_attention_wrappers_refuse_bad_heads_and_devices():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="kv heads"):
        ops.flash_attention(q, torch.zeros((1, 8, 3, 16)),
                            torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="kv heads"):
        ops.decode_attention(q[:, 0], torch.zeros((1, 8, 3, 16)),
                             torch.zeros((1, 8, 3, 16)),
                             torch.zeros(8, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
