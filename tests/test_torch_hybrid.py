"""The port's zamba2 hybrid serving path against the live JAX package on
the CPU, at the zamba2 smoke config (4 mamba layers in 2 groups, one
shared attention+MLP block, fp32) with the reference's params carried
across by ``convert.to_torch``: ``mamba_block`` and 32 ``mamba_decode``
steps (1e-5), the model's logits (1e-4), 16 greedy decode steps from
``init_cache`` (identical tokens, logits 1e-4), the port's own
decode-vs-forward (2e-3, the reference's ``test_decode_matches_forward``),
schema and cache shapes, the full config's parameter count, and the
engine's refusal of the family.  The reference's decode is jitted: its
unjitted scans take seconds per step here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import mamba2 as jmamba2
from repro.models import model as JM
from repro.serve import decode as jdecode
from repro.sharding.policy import init_params as jinit
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.models import hybrid, mamba2
from repro_torch.models import model as M
from repro_torch.serve import decode as tdecode
from repro_torch.serve.engine import Engine

TOL_BLOCK = 1e-5
TOL = 1e-4
TOL_DECODE_VS_FORWARD = 2e-3     # tests/test_arch_smoke.py


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def zamba():
    """(jax cfg, port cfg, jax params, port params) of the zamba2 smoke."""
    jc, tc = jget_smoke("zamba2-2.7b"), get_smoke("zamba2-2.7b")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jp = jax.jit(lambda k: jinit(JM.schema(jc), k, jnp.float32))(
        jax.random.PRNGKey(0))
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu",
                          float_dtype=None)
    return jc, tc, jp, tp


def _layer(tree, g, j):
    """Mamba layer (g, j) of the stacked (G, period, ...) leaves."""
    return jax.tree.map(lambda a: a[g, j], tree)


def _tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def test_mamba_block_matches(zamba):
    jc, tc, jp, tp = zamba
    x = (np.random.RandomState(1).randn(2, 64, tc.d_model) * 0.5).astype(
        np.float32)
    jl = _layer(jp["mamba"], 1, 0)
    tl = convert.to_torch(jax.tree.map(np.asarray, jl), device="cpu")
    want = jax.jit(lambda p, x: jmamba2.mamba_block(p, jc, x))(
        jl, jnp.asarray(x))
    got = mamba2.mamba_block(tl, tc, torch.from_numpy(x))
    _close(got.numpy(), want, TOL_BLOCK)


def test_32_mamba_decode_steps_match(zamba):
    jc, tc, jp, tp = zamba
    B, T = 2, 32
    x = (np.random.RandomState(2).randn(B, T, tc.d_model) * 0.5).astype(
        np.float32)
    jl = _layer(jp["mamba"], 0, 1)
    tl = convert.to_torch(jax.tree.map(np.asarray, jl), device="cpu")
    jstep = jax.jit(lambda p, xt, st: jmamba2.mamba_decode(p, jc, xt, st))
    jst = jmamba2.init_state(jc, B, jnp.float32)
    tst = mamba2.init_state(tc, B, torch.float32, device="cpu")
    for t in range(T):
        want, jst = jstep(jl, jnp.asarray(x[:, t:t + 1]), jst)
        got, tst = mamba2.mamba_decode(tl, tc, torch.from_numpy(
            x[:, t:t + 1]), tst)
        _close(got.numpy(), want, TOL_BLOCK)
    _close(tst.conv.numpy(), jst.conv, TOL_BLOCK)
    _close(tst.ssm.numpy(), jst.ssm, TOL_BLOCK)


def test_zamba_logits_match(zamba):
    jc, tc, jp, tp = zamba
    toks = _tokens(3, 2, 64, jc.vocab_size)       # two SSD chunks of 32
    want, _ = jax.jit(lambda p, t: JM.logits(p, jc, {"tokens": t}))(
        jp, jnp.asarray(toks))
    got, aux = M.logits(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 64, jc.vocab_size) and float(aux) == 0.0
    _close(got.numpy(), want, TOL)
    lg = tdecode.prefill_step(tp, tc, {"tokens": torch.from_numpy(toks)})
    _close(lg.numpy(), np.asarray(want)[:, -1], TOL)
    assert ops.LAUNCHES["ssd_intra_chunk"] == 0
    assert ops.LAUNCHES["flash_attention"] == 0


def test_16_decode_steps_match(zamba):
    """Greedy decode from ``init_cache``: the reference's jitted
    ``make_decode_step`` and ``decode`` against the port's, step by step
    (the port's cache is updated in place; its step runs on a copy)."""
    jc, tc, jp, tp = zamba
    B, n_slots = 2, 32
    jcache = JM.init_cache(jp, jc, B, n_slots)
    tcache = M.init_cache(tp, tc, B, n_slots)
    for got, want in zip(tcache, jcache):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        assert np.array_equal(got.numpy(), np.asarray(want))
    jdec = jax.jit(lambda p, tok, c, pos: JM.decode(p, jc, tok, c, pos))
    jstep = jax.jit(jdecode.make_decode_step(jc, 0))
    tstep = tdecode.make_decode_step(tc, 0)
    tok = _tokens(4, 1, B, jc.vocab_size)[0]
    for pos in range(16):
        jn, _ = jstep(jp, jnp.asarray(tok), jcache, jnp.int32(pos))
        tn, _ = tstep(tp, torch.from_numpy(tok),
                      hybrid.ZambaCache(*(c.clone() for c in tcache)), pos)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        jl, jcache = jdec(jp, jnp.asarray(tok), jcache, jnp.int32(pos))
        tl, tcache = M.decode(tp, tc, torch.from_numpy(tok), tcache, pos)
        _close(tl.numpy(), jl, TOL)
        assert np.array_equal(np.argmax(tl.numpy(), -1), np.asarray(jn))
        tok = np.array(jn)
    for got, want in zip(tcache, jcache):
        _close(got.numpy(), want, TOL)


def test_decode_matches_forward(zamba):
    """The port's recurrent decode reproduces its chunked forward (the
    reference's own check, ``tests/test_arch_smoke.py``)."""
    jc, tc, jp, tp = zamba
    B, T = 2, 64                                  # two SSD chunks of 32
    toks = torch.from_numpy(_tokens(5, B, T, tc.vocab_size))
    full, _ = M.logits(tp, tc, {"tokens": toks})
    cache = M.init_cache(tp, tc, B, T)
    errs = []
    for t in range(T):
        lg, cache = M.decode(tp, tc, toks[:, t], cache, t)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < TOL_DECODE_VS_FORWARD, errs


def test_schema_and_cache_shapes_match(zamba):
    jc, tc, jp, tp = zamba
    jl = jax.tree.leaves(jax.eval_shape(
        lambda: jinit(JM.schema(jc), jax.random.PRNGKey(0), jnp.float32)))
    assert [tuple(t.shape) for t in jax.tree.leaves(tp)] == \
        [a.shape for a in jl]
    assert tuple(tp["mamba"]["in_proj"].shape[:2]) == (2, 2)
    small = M.init_cache(tp, tc, 3, 24)
    assert [tuple(t.shape) for t in small] == \
        [a.shape for a in JM.init_cache(jp, jc, 3, 24)]
    # the full config's cache, shapes and dtypes only (no allocation)
    full = hybrid.zamba_init_cache(get_config("zamba2-2.7b"), 3, 24,
                                   torch.bfloat16, device="meta")
    want = jax.eval_shape(lambda: JM.init_cache(
        None, jget_config("zamba2-2.7b"), 3, 24))
    assert [(tuple(t.shape), str(t.dtype).split(".")[1]) for t in full] == \
        [(a.shape, str(a.dtype)) for a in want]


def test_full_config_param_count_matches():
    cfg, jc = get_config("zamba2-2.7b"), jget_config("zamba2-2.7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jc) \
        == 2_396_455_840
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_chunk,
            cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size,
            cfg.dtype, cfg.attn_period) == (
        54, 2560, 5120, 80, 64, 64, 1, 256, 32, 32, 80, 10240, 32000,
        "bfloat16", 6)


def test_engine_refuses_the_hybrid_family(zamba):
    jc, tc, jp, tp = zamba
    with pytest.raises(ValueError, match="SSM/hybrid use decode"):
        Engine(tp, tc, batch=2, n_slots=16, device="cpu")
