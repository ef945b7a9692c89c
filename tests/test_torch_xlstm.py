"""The port's xLSTM (``models/xlstm.py`` and the xLSTM half of
``models/hybrid.py``) against the live JAX package on the CPU, at the
xlstm-350m smoke config (4 blocks in 2 groups of one mLSTM and one sLSTM,
d_model 256, 2 heads, chunk 32, fp32), with the reference's params carried
across by ``convert.to_torch``.

The mLSTM gates are drawn away from their init (``w_if`` small, ``b_i``
zeros, ``b_f`` ones) and the sLSTM bias away from zeros: at the init the
input gate is ``exp(0) = 1`` everywhere, and a wrong ``logi`` would pass.

Bounds, each relative to the largest value compared where it says so:

* the blocks, the cell and the per-step decodes: 1e-5 (atol = rtol).  The
  port sums the log-decays ``cs`` in float64 and rounds once; the
  reference's fp32 ``jnp.cumsum`` is up to 1 ulp of ``|cs|`` off that.
  Inside a chunk of 32, ``|cs|`` stays below ~12 at these gates, where an
  ulp is 9.5e-7, and a decay ``exp(cs_l - cs_s)`` moves by that relative
  amount; inside the full config's chunk of 256 at the init
  (``log_sigmoid(1)`` ~ -0.31 a row) ``|cs|`` reaches ~80, an ulp 7.6e-6;
* the model's logits and the decode logits: 1e-4 x max|logit|, as for the
  other families; greedy tokens identical;
* mLSTM decode against the chunked forward: 5e-3 (the reference's own,
  ``tests/test_model_units.py``); the model's decode against its forward:
  2e-3 (``tests/test_arch_smoke.py``);
* a train step: the first loss and grad norm 1e-5 relative, params 1e-4
  in relative L2 a leaf (``tests/test_torch_train_lm.py``), with
  ``cfg.remat`` off and on.

The trap at ``exp(diff + logi)``: above the diagonal ``diff`` is a sum of
``-log f`` terms; with forget biases at -8 it passes 88.7 inside a chunk,
the reference's ``exp`` is ``inf`` there and its gradient NaN.  The port
masks before the ``exp``: the same forward bits, a finite gradient that
agrees with a central difference.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import hybrid as jhybrid
from repro.models import model as JM
from repro.models import xlstm as jxlstm
from repro.optim import adam as jadam
from repro.serve import decode as jdecode
from repro.sharding.policy import init_params as jinit
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.ref import prefix_sum
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import hybrid, xlstm
from repro_torch.models import model as M
from repro_torch.models.common import norm_apply
from repro_torch.optim import adam as tadam
from repro_torch.serve import decode as tdecode
from repro_torch.serve.engine import Engine
from repro_torch.sharding.policy import leaves
from repro_torch.train import loop as tloop

ARCH = "xlstm-350m"
TOL_BLOCK = 1e-5
TOL_LOGIT = 1e-4              # x max|logit|
TOL_MLSTM_DECODE = 5e-3       # tests/test_model_units.py
TOL_DECODE_VS_FORWARD = 2e-3  # tests/test_arch_smoke.py
FIRST_TOL = 1e-5              # tests/test_torch_train_lm.py
STEPS_TOL = 1e-4
EXP_OVERFLOW = 88.72          # log(float32 max)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: on six xdist workers the default pool
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _live_gates(tree: dict, seed: int) -> dict:
    """The reference's params with every gate drawn away from its init:
    mLSTM ``w_if`` N(0, 0.05), ``b_i`` U(-1, 1), ``b_f`` U(0.5, 3); sLSTM
    ``b`` N(0, 0.5)."""
    rng = np.random.RandomState(seed)
    g = jax.tree.map(np.array, tree)
    ml, sl = g["groups"]["mlstms"], g["groups"]["slstm"]
    ml["w_if"] = (rng.randn(*ml["w_if"].shape) * 0.05).astype(np.float32)
    ml["b_i"] = rng.uniform(-1, 1, ml["b_i"].shape).astype(np.float32)
    ml["b_f"] = rng.uniform(0.5, 3, ml["b_f"].shape).astype(np.float32)
    sl["b"] = (rng.randn(*sl["b"].shape) * 0.5).astype(np.float32)
    return g


@pytest.fixture(scope="module")
def xl():
    """(jax cfg, port cfg, jax params, port params) of the xLSTM smoke."""
    jc, tc = jget_smoke(ARCH), get_smoke(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jp = jax.jit(lambda k: jinit(JM.schema(jc), k, jnp.float32))(
        jax.random.PRNGKey(0))
    host = _live_gates(jp, 7)
    jp = jax.tree.map(jnp.asarray, host)
    tp = convert.to_torch(host, device="cpu", float_dtype=None)
    return jc, tc, jp, tp


def _layer(tree, *idx):
    return jax.tree.map(lambda a: a[idx], tree)


def _port(tree):
    return convert.to_torch(jax.tree.map(np.asarray, tree), device="cpu",
                            float_dtype=None)


def _x(seed, B, S, d):
    return (np.random.RandomState(seed).randn(B, S, d) * 0.5).astype(
        np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def test_params_cross_with_convert(xl):
    jc, tc, jp, tp = xl
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert [tuple(t.shape) for t in leaves(tp)] == [a.shape for _, a in jl]
    assert all(t.dtype == torch.float32 for t in leaves(tp))
    for (_, want), got in zip(jl, leaves(tp)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert tuple(tp["groups"]["mlstms"]["wq"].shape) == (2, 1, 512, 512)
    assert tuple(tp["groups"]["slstm"]["r"].shape) == (2, 2, 128, 512)


@pytest.mark.parametrize("g", [0, 1])
def test_mlstm_block_matches(xl, g):
    jc, tc, jp, tp = xl
    x = _x(1 + g, 2, 64, tc.d_model)             # two chunks of 32
    jl = _layer(jp["groups"]["mlstms"], g, 0)
    want = jax.jit(lambda p, x: jxlstm.mlstm_block(p, jc, x))(
        jl, jnp.asarray(x))
    got = xlstm.mlstm_block(_port(jl), tc, torch.from_numpy(x))
    _close(got.numpy(), want, TOL_BLOCK)


def test_mlstm_decode_steps_match(xl):
    jc, tc, jp, tp = xl
    B, T = 2, 32
    x = _x(3, B, T, tc.d_model)
    jl = _layer(jp["groups"]["mlstms"], 1, 0)
    tl = _port(jl)
    jstep = jax.jit(lambda p, xt, st: jxlstm.mlstm_decode(p, jc, xt, st))
    jst = jxlstm.mlstm_init_state(jc, B)
    tst = xlstm.mlstm_init_state(tc, B, device="cpu")
    outs = []
    for t in range(T):
        want, jst = jstep(jl, jnp.asarray(x[:, t:t + 1]), jst)
        got, tst = xlstm.mlstm_decode(tl, tc, torch.from_numpy(
            x[:, t:t + 1]), tst)
        _close(got.numpy(), want, TOL_BLOCK)
        outs.append(got)
    _close(tst.C.numpy(), jst.C, TOL_BLOCK)
    _close(tst.n.numpy(), jst.n, TOL_BLOCK)
    # the port's own decode against its chunked forward (T = one chunk)
    full = xlstm.mlstm_block(tl, tc, torch.from_numpy(x))
    _close(torch.cat(outs, 1).numpy(), full.numpy(), TOL_MLSTM_DECODE)


@pytest.mark.parametrize("g", [0, 1])
def test_slstm_block_matches(xl, g):
    jc, tc, jp, tp = xl
    x = _x(4 + g, 2, 48, tc.d_model)
    jl = _layer(jp["groups"]["slstm"], g)
    want = jax.jit(lambda p, x: jxlstm.slstm_block(p, jc, x))(
        jl, jnp.asarray(x))
    got = xlstm.slstm_block(_port(jl), tc, torch.from_numpy(x))
    _close(got.numpy(), want, TOL_BLOCK)


def test_slstm_cell_and_decode_match(xl):
    """``_slstm_cell`` from a drawn state (finite m, either sign of every
    gate), then 24 ``slstm_decode`` steps from ``slstm_init_state``
    (m = -1e30, fp32), each against the reference."""
    jc, tc, jp, tp = xl
    B, H, P = 3, tc.n_heads, tc.d_model // tc.n_heads
    rng = np.random.RandomState(6)
    jl = _layer(jp["groups"]["slstm"], 0)
    tl = _port(jl)
    xt = rng.randn(B, 4 * tc.d_model).astype(np.float32)
    st = [rng.randn(B, H, P).astype(np.float32) for _ in range(4)]
    st[1] = np.abs(st[1]) + 0.5                   # the normaliser n > 0
    want = jxlstm._slstm_cell(jl, jc, jnp.asarray(xt), jxlstm.SLSTMState(
        *map(jnp.asarray, st)))
    got = xlstm._slstm_cell(tl, tc, torch.from_numpy(xt), xlstm.SLSTMState(
        *map(torch.from_numpy, st)))
    for a, b in zip(got, want):
        _close(a.numpy(), b, TOL_BLOCK)

    x = _x(7, B, 24, tc.d_model)
    jstep = jax.jit(lambda p, xt, st: jxlstm.slstm_decode(p, jc, xt, st))
    jst = jxlstm.slstm_init_state(jc, B)
    tst = xlstm.slstm_init_state(tc, B, device="cpu")
    assert all(t.dtype == torch.float32 for t in tst)
    assert float(tst.m.max()) == float(jst.m.max()) == np.float32(-1e30)
    for t in range(x.shape[1]):
        want, jst = jstep(jl, jnp.asarray(x[:, t:t + 1]), jst)
        got, tst = xlstm.slstm_decode(tl, tc, torch.from_numpy(
            x[:, t:t + 1]), tst)
        _close(got.numpy(), want, TOL_BLOCK)
    for a, b in zip(tst, jst):
        _close(a.numpy(), b, TOL_BLOCK)
    full = xlstm.slstm_block(tl, tc, torch.from_numpy(x))
    assert _scaled_err(full[:, -1].numpy(), np.asarray(want)[:, 0]) \
        <= TOL_BLOCK


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_xlstm_logits_match(xl):
    jc, tc, jp, tp = xl
    toks = _tokens(8, 2, 64, jc.vocab_size)
    want, _ = jax.jit(lambda p, t: JM.logits(p, jc, {"tokens": t}))(
        jp, jnp.asarray(toks))
    ops.reset_launches()
    got, aux = M.logits(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 64, jc.vocab_size) and float(aux) == 0.0
    assert _scaled_err(got.numpy(), want) <= TOL_LOGIT
    lg = tdecode.prefill_step(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert _scaled_err(lg.numpy(), np.asarray(want)[:, -1]) <= TOL_LOGIT
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_init_cache_and_16_decode_steps_match(xl):
    """``init_cache`` the reference's bits, then greedy decode: the
    reference's jitted ``make_decode_step`` and ``decode`` against the
    port's, step by step (the port's cache is updated in place; its step
    runs on a copy)."""
    jc, tc, jp, tp = xl
    B = 2
    jcache = JM.init_cache(jp, jc, B, 16)
    tcache = M.init_cache(tp, tc, B, 16)
    assert isinstance(tcache, hybrid.XLSTMCache)
    for got, want in zip(tcache, jcache):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want))
    jdec = jax.jit(lambda p, tok, c: JM.decode(p, jc, tok, c, 0))
    jstep = jax.jit(jdecode.make_decode_step(jc, 0))
    tstep = tdecode.make_decode_step(tc, 0)
    tok = _tokens(9, 1, B, jc.vocab_size)[0]
    for pos in range(16):
        jn, _ = jstep(jp, jnp.asarray(tok), jcache, jnp.int32(pos))
        tn, _ = tstep(tp, torch.from_numpy(tok),
                      hybrid.XLSTMCache(*(c.clone() for c in tcache)), pos)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        jl, jcache = jdec(jp, jnp.asarray(tok), jcache)
        tl, tcache = M.decode(tp, tc, torch.from_numpy(tok), tcache, pos)
        assert _scaled_err(tl.numpy(), jl) <= TOL_LOGIT
        tok = np.array(jn)
    for got, want in zip(tcache, jcache):    # 16 steps through 4 blocks
        assert _scaled_err(got.numpy(), want) <= TOL_BLOCK


def test_decode_matches_prefill_and_forward(xl):
    """The port's recurrent decode against its own ``prefill_step`` on
    each prefix (every prefix length up to one chunk) and against the full
    forward over two chunks (the reference's ``test_decode_matches_forward``
    bound)."""
    jc, tc, jp, tp = xl
    B, T = 2, 64
    toks = torch.from_numpy(_tokens(10, B, T, tc.vocab_size))
    full, _ = M.logits(tp, tc, {"tokens": toks})
    cache = M.init_cache(tp, tc, B, T)
    errs, prefix = [], []
    for t in range(T):
        lg, cache = M.decode(tp, tc, toks[:, t], cache, t)
        errs.append(float((lg - full[:, t]).abs().max()))
        if t < tc.ssm_chunk and t % 4 == 3:
            pre = tdecode.prefill_step(tp, tc, {"tokens": toks[:, :t + 1]})
            prefix.append(float((lg - pre).abs().max()))
    assert max(errs) < TOL_DECODE_VS_FORWARD, errs
    assert max(prefix) < TOL_DECODE_VS_FORWARD, prefix


def test_schema_and_full_config(xl):
    jc, tc, jp, tp = xl
    assert tuple(tp["groups"]["mlstms"]["w_up"].shape[:2]) == (2, 1)
    cfg, jcf = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcf)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jcf) \
        == 518_686_888
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_heads,
            cfg.slstm_period, cfg.ssm_chunk, cfg.vocab_size, cfg.dtype) == (
        "ssm", 24, 1024, 2048, 4, 8, 256, 50304, "bfloat16")
    # the full config's cache, shapes and dtypes only (no allocation)
    full = hybrid.xlstm_init_cache(cfg, 3, device="meta")
    want = jax.eval_shape(lambda: jhybrid.xlstm_init_cache(jcf, 3))
    assert [(tuple(t.shape), str(t.dtype).split(".")[1]) for t in full] == \
        [(a.shape, str(a.dtype)) for a in want]


def test_bf16_forward_is_finite_and_keeps_fp32_state():
    """The smoke at bf16 (the full config's dtype): fp32 gates and states,
    bf16 stream and logits."""
    cfg = get_smoke(ARCH).with_(dtype="bfloat16")
    p = tserve.build_params(cfg, device="cpu")
    assert p["groups"]["mlstms"]["wq"].dtype == torch.bfloat16
    assert p["groups"]["mlstms"]["w_if"].dtype == torch.float32
    assert p["groups"]["slstm"]["r"].dtype == torch.float32
    toks = torch.from_numpy(_tokens(11, 2, 32, cfg.vocab_size))
    lg = tdecode.prefill_step(p, cfg, {"tokens": toks})
    assert lg.dtype == torch.bfloat16 and bool(torch.isfinite(lg).all())
    cache = M.init_cache(p, cfg, 2, 0)
    assert all(t.dtype == torch.float32 for t in cache)
    nxt, cache = tdecode.make_decode_step(cfg)(p, toks[:, 0], cache, 0)
    assert nxt.dtype == torch.int32 and nxt.shape == (2,)


def test_engine_and_serve_cli_refuse_the_family(xl):
    jc, tc, jp, tp = xl
    with pytest.raises(ValueError, match="SSM/hybrid use decode"):
        Engine(tp, tc, batch=2, n_slots=16, device="cpu")
    with pytest.raises(SystemExit, match="SSM/hybrid use decode"):
        tserve.main(["--arch", ARCH, "--device", "cpu"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _l2_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_reference(xl, remat):
    """Two AdamW steps from the live-gate params (B 2, S 64), with
    ``cfg.remat`` off and on in both packages."""
    jc, tc, jp, tp = xl
    jc, tc = jc.with_(remat=remat), tc.with_(remat=remat)
    jf = jloop.make_train_step(jc, jadam.AdamW(lr=3e-4))
    tf = tloop.make_train_step(tc, tadam.AdamW(lr=3e-4))
    js, ts = jadam.AdamW().init(jp), tadam.AdamW().init(tp)
    jstep = jax.jit(jf.step)
    params, jparams = tp, jp
    for i in range(2):
        toks = _tokens(20 + i, 2, 64, jc.vocab_size)
        jparams, js, jm = jstep(jparams, js, {"tokens": jnp.asarray(toks)})
        params, ts, tm = tf.step(params, ts, {"tokens": torch.from_numpy(
            toks)})
        tol = FIRST_TOL if i == 0 else STEPS_TOL
        for key in ("loss", "ce", "grad_norm"):
            assert _rel(tm[key], jm[key]) <= tol, (i, key)
    for want, got in zip(jax.tree.leaves(jparams), leaves(params)):
        assert _l2_rel(got.numpy(), want) <= STEPS_TOL


def test_remat_changes_no_bit_of_the_gradient(xl):
    jc, tc, jp, tp = xl
    toks = torch.from_numpy(_tokens(22, 2, 32, tc.vocab_size))
    grads = []
    for remat in (False, True):
        p = convert.to_torch(convert.to_numpy(tp), device="cpu",
                             float_dtype=None)
        for t in leaves(p):
            t.requires_grad_(True)
        loss, _ = tloop.task_loss(p, tc.with_(remat=remat), {"tokens": toks})
        grads.append(torch.autograd.grad(loss, leaves(p)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _trap(jc, seed=30) -> dict:
    """An mLSTM layer whose forget biases are -8: ``log_sigmoid`` ~ -8 a
    row, so ``diff`` above the diagonal reaches ~31 x 8 inside a chunk."""
    jl = jax.tree.map(np.array, jinit(jxlstm.schema_mlstm(jc),
                                      jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.RandomState(seed)
    jl["w_if"] = (rng.randn(*jl["w_if"].shape) * 0.05).astype(np.float32)
    jl["b_i"] = rng.uniform(-1, 1, jl["b_i"].shape).astype(np.float32)
    jl["b_f"] = np.full(jl["b_f"].shape, -8.0, np.float32)
    return jl


def _with_leaves(tree, new: list):
    """``tree`` with its leaves, in order, replaced by ``new``."""
    it = iter(new)

    def go(t):
        return ({k: go(v) for k, v in t.items()} if isinstance(t, dict)
                else next(it))
    return go(tree)


def test_exp_overflow_above_the_diagonal():
    """Forget biases at -8 push ``diff`` above the diagonal past 88.7.  The
    reference's gradient is NaN there (``inf * 0`` through its ``where``);
    the port's is finite and agrees with a central difference of its own
    forward, and masking before the ``exp`` changes no bit of the
    forward's decays."""
    jc, tc = jget_smoke(ARCH), get_smoke(ARCH)
    B, S, Lc, H = 2, 64, tc.ssm_chunk, tc.n_heads
    jl = _trap(jc)
    tl = _port(jl)
    x = _x(31, B, S, tc.d_model)
    w = np.random.RandomState(32).randn(B, S, tc.d_model).astype(np.float32)

    # the trap is live: above the diagonal diff + logi passes 88.7, and
    # the reference's where-after-exp and the port's mask-before-exp give
    # the same decays, bit for bit
    with torch.no_grad():
        h = norm_apply(tl["ln"], torch.from_numpy(x))
        xin = torch.split(h @ tl["w_up"], tc.d_inner, -1)[0]
        _, _, _, logi, fpre = xlstm._qkv_gates(tl, xin, H, tc.d_inner // H)
        cs = prefix_sum(xlstm.log_sigmoid(fpre).reshape(B, S // Lc, Lc, H),
                        2)
        A = (cs[:, :, :, None, :] - cs[:, :, None, :, :]
             + logi.reshape(B, S // Lc, Lc, H)[:, :, None, :, :])
        tril = torch.ones((Lc, Lc), dtype=torch.bool).tril()[
            None, None, :, :, None].expand_as(A)
        assert float(A[~tril].max()) > EXP_OVERFLOW
        assert torch.equal(torch.where(tril, torch.exp(A), 0.0),
                           torch.exp(torch.where(tril, A, -torch.inf)))

    jparams = jax.tree.map(jnp.asarray, jl)
    jy = jax.jit(lambda p, x: jxlstm.mlstm_block(p, jc, x))(
        jparams, jnp.asarray(x))
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(
        jxlstm.mlstm_block(p, jc, x) * w)))(jparams, jnp.asarray(x))
    assert np.isnan(np.asarray(jg["w_if"])).any()
    assert np.isnan(np.asarray(jg["w_up"])).any()

    ps = leaves(tl)
    for t in ps:
        t.requires_grad_(True)
    wt = torch.from_numpy(w)
    y = xlstm.mlstm_block(tl, tc, torch.from_numpy(x))
    _close(y.detach().numpy(), jy, TOL_BLOCK)
    g = torch.autograd.grad((y * wt).sum(), ps)
    assert all(bool(torch.isfinite(t).all()) for t in g)

    # the directional derivative along the gradient, a central difference
    # (the normaliser makes the loss steep here: at a step of 1e-3 along
    # the unit direction it reads 0.31 of the slope, at 1e-5 0.998)
    eps = 1e-5
    norm = float(torch.sqrt(sum((t.double() ** 2).sum() for t in g)))

    def f(sign: float) -> float:
        with torch.no_grad():
            p = _with_leaves(tl, [a + sign * eps * d / norm
                                  for a, d in zip(ps, g)])
            y = xlstm.mlstm_block(p, tc, torch.from_numpy(x))
            return float((y.double() * wt.double()).sum())
    fd = (f(1.0) - f(-1.0)) / (2 * eps)
    assert abs(fd - norm) <= 1e-2 * norm, (fd, norm)


# ---------------------------------------------------------------------------
# the registry, the dispatch and the CLI
# ---------------------------------------------------------------------------

def test_model_dispatch_accepts_the_family_and_refuses_unknown_ones(xl):
    jc, tc, jp, tp = xl
    assert set(M.schema(tc)) == {"embed", "groups", "ln_f"}
    assert tloop.make_train_step(tc) is not None
    with pytest.raises(ValueError, match="unknown model family"):
        M.schema(tc.with_(family="rwkv"))


def test_train_cli_on_cpu(capsys, tmp_path):
    out = tmp_path / "train.json"
    rc = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "12", "--batch", "4", "--seq", "32",
                       "--lr", "1e-3", "--out", str(out)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "device: cpu"
    res = json.loads(lines[-1])
    assert res["improved"] is True
    rec = json.loads(out.read_text())
    assert all(v == 0 for part in rec["launches"].values()
               for v in part.values())


@pytest.mark.parametrize("layers", [3, 5])
def test_train_cli_refuses_a_depth_off_the_groups(layers):
    with pytest.raises(SystemExit, match="multiple of 2"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--layers", str(layers), "--steps", "1"])
