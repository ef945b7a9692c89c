"""The port's MoE decoder (``models/ffn.moe``, the MoE half of
``models/transformer.py``, the engine and the serving CLI for
qwen3-moe-30b-a3b and kimi-k2-1t-a32b) against the live JAX package on
the CPU, at the smoke configs' widths, and the sliced initialisation of
``sharding/policy.py``.

Bounds: the routing (``topi``), every entry's slot and the dropped set
are identical; ``y`` within 1e-5 x max|y| and ``aux`` within 1e-6; the
gradients of ``sum(y * g) + aux`` with respect to x, the router and the
three expert banks within 1e-5 of each one's largest entry; decoder
logits and 16 greedy decode steps within 1e-4, with identical tokens;
the engine's tokens and ``EngineStats`` identical; three train steps
within the LM trainer's bounds (``tests/test_torch_train_lm.py``).  JAX
params cross with ``convert.to_torch``; inputs come from a numpy seed.

The reference's experts for each token are read from ``jax.lax.top_k``
as the reference calls it; the slots they imply follow from counting,
in entry order, the earlier entries of the same expert.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.data import tokens as jtokens
from repro.models import ffn as jffn
from repro.models import model as JM
from repro.models import transformer as jtr
from repro.optim import adam as jadam
from repro.optim import schedule as jsched
from repro.serve import engine as jengine
from repro.sharding.policy import init_params as jinit
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as tserve
from repro_torch.models import ffn
from repro_torch.models import model as M
from repro_torch.models import transformer as ttr
from repro_torch.optim import adam as tadam
from repro_torch.optim import schedule as tsched
from repro_torch.serve import engine as tengine
from repro_torch.sharding import policy
from repro_torch.sharding.policy import init_params, leaves
from repro_torch.train import loop as tloop

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
TOL_Y = 1e-5            # x max|y|
TOL_AUX = 1e-6
TOL_GRAD = 1e-5         # x each gradient's max
TOL = 1e-4              # logits
FIRST_TOL, STEPS_TOL = 1e-5, 1e-4     # the LM trainer's bounds
LR = (3e-4, 1, 3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: on six xdist workers the default pool
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _to_torch(tree):
    return convert.to_torch(jax.tree.map(np.asarray, tree), device="cpu",
                            float_dtype=None)


def _cfgs(arch, **kw):
    jc, tc = jget_smoke(arch).with_(**kw), get_smoke(arch).with_(**kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    return jc, tc


@pytest.fixture(scope="module")
def models():
    """For each smoke arch: (jax cfg, port cfg, jax params, port params)."""
    out = {}
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        jp = jinit(JM.schema(jc), jax.random.PRNGKey(0), jnp.float32)
        out[arch] = (jc, tc, jp, _to_torch(jp))
    return out


def _moe_params(jc, seed=1):
    jp = jinit(jffn.schema_moe(jc), jax.random.PRNGKey(seed), jnp.float32)
    return jp, _to_torch(jp)


def _reference_moe(jp, jc, x):
    """The reference's ``moe`` on ``x``, with the experts its
    ``jax.lax.top_k`` chose."""
    real, seen = jax.lax.top_k, {}

    def recording(a, k):
        out = real(a, k)
        seen["topi"] = np.asarray(out[1])
        return out
    jax.lax.top_k = recording
    try:
        y, aux = jffn.moe(jp, jc, jnp.asarray(x))
    finally:
        jax.lax.top_k = real
    return np.asarray(y), float(aux), seen["topi"]


def _slots_by_counting(topi, E, C):
    """Each entry's slot: e*C + (the earlier entries, in (token, j) order,
    of the same expert e), or E*C where that count reaches C."""
    seen = np.zeros(E, np.int64)
    slot = np.empty(topi.shape, np.int64)
    for t in range(topi.shape[0]):
        for j in range(topi.shape[1]):
            e = topi[t, j]
            slot[t, j] = e * C + seen[e] if seen[e] < C else E * C
            seen[e] += 1
    return slot


def _cf(jc, name):
    return {"1.0": 1.0, "1.25": 1.25,
            "E/k": jc.n_experts / jc.experts_per_token}[name]


@pytest.mark.parametrize("cf", ["1.0", "1.25", "E/k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_routing_slots_and_output_match(arch, cf):
    jc, tc = _cfgs(arch)
    jc, tc = (c.with_(capacity_factor=_cf(jc, cf)) for c in (jc, tc))
    jp, tp = _moe_params(jc)
    x = _randn(0, 3, 11, jc.d_model)
    want_y, want_aux, want_topi = _reference_moe(jp, jc, x)
    N, E, k = 33, jc.n_experts, jc.experts_per_token
    r = ffn.route(tp["router"], tc, torch.from_numpy(x).reshape(N, -1))
    C = int(np.ceil(N * k / E * jc.capacity_factor))
    assert r.capacity == C
    np.testing.assert_array_equal(r.topi.numpy(), want_topi)
    want_slot = _slots_by_counting(want_topi, E, C)
    np.testing.assert_array_equal(r.slot.numpy(), want_slot)
    dropped = want_slot == E * C
    np.testing.assert_array_equal(r.slot.numpy() == E * C, dropped)
    # capacity 1.0 drops entries here; E/k holds every entry
    assert dropped.any() == (cf == "1.0")
    y, aux = ffn.moe(tp, tc, torch.from_numpy(x))
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    assert np.abs(y.numpy() - want_y).max() <= TOL_Y * np.abs(want_y).max()
    assert abs(float(aux) - want_aux) <= TOL_AUX


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_all_ties_row_picks_jax_top_k(arch):
    """A zero router gives uniform probabilities: every expert ties, and
    ``jax.lax.top_k`` takes the lowest ids."""
    jc, tc = _cfgs(arch)
    jp, tp = _moe_params(jc)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _randn(3, 2, 5, jc.d_model)
    want_y, want_aux, want_topi = _reference_moe(jp, jc, x)
    r = ffn.route(tp["router"], tc, torch.from_numpy(x).reshape(10, -1))
    np.testing.assert_array_equal(r.topi.numpy(), want_topi)
    assert (want_topi == np.arange(jc.experts_per_token)).all()
    y, aux = ffn.moe(tp, tc, torch.from_numpy(x))
    assert np.abs(y.numpy() - want_y).max() <= TOL_Y * np.abs(want_y).max()
    assert abs(float(aux) - want_aux) <= TOL_AUX


@pytest.mark.parametrize("cf", ["1.0", "1.25", "E/k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match(arch, cf):
    """d/d(x, router, w_gate, w_up, w_down) of ``sum(y * g) + aux``: the
    gradient reaches the router through the probabilities (the mean and
    the chosen weights), not through the one-hot."""
    jc, tc = _cfgs(arch)
    jc, tc = (c.with_(capacity_factor=_cf(jc, cf)) for c in (jc, tc))
    jp, tp = _moe_params(jc)
    x = _randn(4, 3, 11, jc.d_model)
    g = _randn(5, 3, 11, jc.d_model)

    def jloss(p, x):
        y, aux = jffn.moe(p, jc, x)
        return jnp.sum(y * g) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tpp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, aux = ffn.moe(tpp, tc, tx)
    (torch.sum(y * torch.from_numpy(g)) + aux).backward()
    pairs = [(tx.grad, jgx)] + [(tpp[k].grad, jgp[k]) for k in sorted(tp)]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= TOL_GRAD * np.abs(
            want).max()


def test_combine_adds_in_slot_order_and_the_two_moves_are_adjoint():
    """The combine adds each token's rows onto zeros in the order of
    ``uses`` (ascending slots, the drop slot last: a zero row), in the
    rows' dtype (bf16 here, where the order shows in the bits); the
    dispatch's gradient is that sum and the combine's the gather."""
    rng = np.random.RandomState(7)
    n_slots, n_tok, k, d = 20, 5, 3, 16
    src = torch.from_numpy(rng.randn(n_slots, d).astype(np.float32) * 100)
    src = src.to(torch.bfloat16)
    # each slot holds at most one token's entry; two entries dropped
    u = rng.permutation(n_slots)[:n_tok * k].reshape(n_tok, k)
    u[1, 0] = u[3, 2] = n_slots
    uses = torch.from_numpy(np.sort(u, 1))
    want = torch.zeros((n_tok, d), dtype=torch.bfloat16)
    for t in range(n_tok):
        for s in uses[t].tolist():
            if s < n_slots:
                want[t] = want[t] + src[s]
    assert torch.equal(ffn._sum_rows(src, uses), want)
    # as the moe builds them: each slot's token (n_tok: none)
    idx = torch.full((n_slots + 1,), n_tok, dtype=torch.int64)
    for t in range(n_tok):
        idx[uses[t]] = t
    idx = idx[:-1]
    x = torch.randn(n_tok, d, dtype=torch.float64, requires_grad=True)
    c = torch.randn(n_slots, d, dtype=torch.float64, requires_grad=True)
    g_slots = torch.randn(n_slots, d, dtype=torch.float64)
    g_tok = torch.randn(n_tok, d, dtype=torch.float64)
    (ffn._Gather.apply(x, idx, uses) * g_slots).sum().backward()
    (ffn._Sum.apply(c, uses, idx) * g_tok).sum().backward()
    assert torch.equal(x.grad, ffn._sum_rows(g_slots, uses))
    assert torch.equal(c.grad, ffn._rows(g_tok, idx))
    # adjoint: <gather(x), g> == <x, sum(g)>
    lhs = (ffn._rows(x.detach(), idx) * g_slots).sum()
    rhs = (x.detach() * ffn._sum_rows(g_slots, uses)).sum()
    assert abs(float(lhs - rhs)) <= 1e-9 * abs(float(lhs))


@pytest.mark.parametrize("switch", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decoder_logits_and_aux_match(models, arch, switch):
    jc, tc, jp, tp = models[arch]
    toks = np.random.RandomState(1).randint(0, jc.vocab_size, (2, 16)).astype(
        np.int32)
    want, want_aux = jtr.decoder_logits(jp, jc, {"tokens": jnp.asarray(toks)})
    got, aux = ttr.decoder_logits(tp, tc.with_(use_flash_kernel=switch),
                                  {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert float(aux) > 0 and abs(float(aux) - float(want_aux)) <= TOL_AUX


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_16_decode_steps_match(models, arch):
    jc, tc, jp, tp = models[arch]
    tc = tc.with_(use_flash_kernel=True)
    B, S, n_slots = 2, 8, 32
    toks = np.random.RandomState(2).randint(0, jc.vocab_size, (B, S)).astype(
        np.int32)
    jlog, jcache = jtr.decoder_prefill_with_cache(jp, jc, jnp.asarray(toks),
                                                  n_slots)
    tlog, tcache = ttr.decoder_prefill_with_cache(tp, tc,
                                                  torch.from_numpy(toks),
                                                  n_slots)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    jdec = jax.jit(lambda p, tok, c, pos: JM.decode(p, jc, tok, c, pos))
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for t in range(16):
        jl, jcache = jdec(jp, jnp.asarray(tok), jcache, jnp.int32(S + t))
        tl, tcache = M.decode(tp, tc, torch.from_numpy(tok), tcache, S + t)
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).max() <= TOL * max(
            float(np.abs(jl).max()), 1.0), t
        nxt = np.argmax(jl, -1).astype(np.int32)
        assert np.array_equal(np.argmax(tl.numpy(), -1), nxt), t
        tok = nxt


def test_decode_matches_forward_with_room_for_every_entry():
    """With ``capacity_factor = E / k`` no entry is dropped, so the decode
    (N = B) and the forward (N = B*S) route alike: 16 decode steps from an
    empty cache against the full forward's logits, as the reference's
    ``test_decode_matches_forward``."""
    cfg = get_smoke(ARCHS[0])
    cfg = cfg.with_(capacity_factor=cfg.n_experts / cfg.experts_per_token,
                    use_flash_kernel=True)
    params = init_params(M.schema(cfg), torch.Generator().manual_seed(3),
                         torch.float32, device="cpu")
    B, T = 2, 16
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (B, T)).astype(np.int32))
    with torch.no_grad():
        full, _ = M.logits(params, cfg, {"tokens": toks})
        cache = M.init_cache(params, cfg, B, T)
        for t in range(T):
            lg, cache = M.decode(params, cfg, toks[:, t], cache, t)
            assert float((lg - full[:, t]).abs().max()) <= TOL * float(
                full.abs().max()), t


def _requests(module, n, vocab, max_new=6):
    rng = np.random.RandomState(0)
    return [module.Request(rid, rng.randint(0, vocab, int(rng.randint(
        4, 24))).astype(np.int32), max_new=max_new) for rid in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_and_stats_match_jax_engine(models, arch):
    """Every slot of the batch, idle ones too, competes for the decode's
    capacity in token order, as in the reference."""
    jc, tc, jp, tp = models[arch]
    kw = dict(batch=3, n_slots=48, prefill_len=12)
    jeng = jengine.Engine(jp, jc, **kw)
    teng = tengine.Engine(tp, tc.with_(use_flash_kernel=True), device="cpu",
                          **kw)
    jreqs = _requests(jengine, 7, jc.vocab_size)
    treqs = _requests(tengine, 7, jc.vocab_size)
    for a, b in zip(jreqs, treqs):
        jeng.submit(a)
        teng.submit(b)
    jstats, tstats = jeng.run(), teng.run()
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.done for r in treqs)


def test_serve_cli_serves_qwen3_smoke_on_cpu(tmp_path):
    out = tmp_path / "moe.json"
    rc = tserve.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu",
                      "--requests", "5", "--batch", "2", "--max-new", "4",
                      "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["arch"] == "qwen3-moe-30b-a3b" and res["smoke"]
    assert res["completed"] == 5 and res["tokens_out"] == 20


def _batches(cfg, n=3):
    return [{"tokens": b["tokens"]}
            for b in jtokens.batches(cfg.vocab_size, 4, 32, n, seed=3)]


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    """The aux term is part of the loss: its gradient reaches the router."""
    jc, tc = _cfgs(arch)
    jf = jloop.make_train_step(jc, jadam.AdamW(lr=LR[0]),
                               lr_schedule=jsched.warmup_cosine(*LR))
    tf = tloop.make_train_step(tc, tadam.AdamW(lr=LR[0]),
                               lr_schedule=tsched.warmup_cosine(*LR))
    jp, js = jf.init(jax.random.PRNGKey(0))
    tp = _to_torch(jp)
    ts = tadam.AdamW().init(tp)
    jstep = jax.jit(jf.step)
    for i, b in enumerate(_batches(tc)):
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(b["tokens"])})
        tp, ts, tm = tf.step(tp, ts, {"tokens": torch.from_numpy(
            b["tokens"])})
        assert float(tm["aux"]) > 0
        for key in jm:
            tol = FIRST_TOL if i == 0 else STEPS_TOL
            assert abs(float(tm[key]) - float(jm[key])) <= tol * abs(
                float(jm[key])), (i, key)
    for want, got in zip(jax.tree.leaves(jp), leaves(tp)):
        want = np.asarray(want, np.float64)
        assert np.linalg.norm(got.numpy() - want) <= STEPS_TOL * \
            np.linalg.norm(want)


@pytest.mark.parametrize("arch,total,active", [
    ("qwen3-moe-30b-a3b", 30_532_110_336, 3_353_020_416),
    ("kimi-k2-1t-a32b", 1_042_174_407_680, 32_068_563_968)])
def test_full_config_param_counts_without_allocation(arch, total, active):
    cfg, jc = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jc) \
        == total
    assert M.count_active_params(cfg) == JM.count_active_params(jc) == active
    assert M.supports_decode(cfg) and ttr._is_moe(cfg)


# ---------------------------------------------------------------------------
# the sliced initialisation
# ---------------------------------------------------------------------------

def _whole_draw(d, gen, dtype):
    """A leaf drawn whole in fp32 and cast: the initialisation before
    slicing, copied as it stood."""
    dt = policy.DTYPES[d.dtype] if d.dtype else dtype
    shape = tuple(int(s) for s in d.shape)
    f32 = torch.float32
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dt)
    if d.init == "ones":
        return torch.ones(shape, dtype=dt)
    normal = lambda: torch.randn(shape, generator=gen, dtype=f32)
    uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(
        shape, generator=gen, dtype=f32)
    if d.init == "fan_in":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return (normal() * d.scale / math.sqrt(fan_in)).to(dt)
    if d.init == "embed":
        return (normal() * d.scale * 0.02).to(dt)
    if d.init == "normal":
        return (normal() * d.scale).to(dt)
    if d.init == "mamba_A":
        return torch.log(uniform(1.0, 16.0)).to(dt)
    if d.init == "dt_bias":
        u = uniform(1e-3, 1e-1)
        return (u + torch.log(-torch.expm1(-u))).to(dt)
    if d.init == "small":
        return (normal() * d.scale * 1e-2).to(dt)
    raise ValueError(d.init)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-2.7b"] +
                         list(ARCHS))
def test_small_leaves_keep_the_bits_of_a_whole_draw(arch):
    schema = M.schema(get_smoke(arch))
    got = init_params(schema, torch.Generator().manual_seed(0),
                      torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    defs = leaves(schema)
    assert all(math.prod(d.shape) <= policy.SLICE_ELEMENTS for d in defs)
    for d, t in zip(defs, leaves(got)):
        assert torch.equal(t, _whole_draw(d, gen, torch.float32))


@pytest.mark.parametrize("init,shape,scale", [
    ("fan_in", (6, 40, 50), 1.0), ("fan_in", (300, 40), 2.0),
    ("embed", (50, 40), 1.0), ("normal", (7, 3, 60), 0.5)])
def test_a_sliced_leaf_has_its_recipes_dtype_and_scale(monkeypatch, init,
                                                       shape, scale):
    monkeypatch.setattr(policy, "SLICE_ELEMENTS", 1000)
    d = policy.ParamDef(shape, (None,) * len(shape), init=init, scale=scale)
    t = init_params({"w": d}, torch.Generator().manual_seed(0),
                    torch.bfloat16, device="cpu")["w"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == shape
    std = {"fan_in": scale / math.sqrt(shape[-2]), "embed": 0.02 * scale,
           "normal": scale}[init]
    assert abs(float(t.float().std()) / std - 1) < 0.08
    rows = t.float().reshape(shape[0], -1)
    assert not torch.equal(rows[0], rows[-1])       # slices draw afresh
    again = init_params({"w": d}, torch.Generator().manual_seed(0),
                        torch.bfloat16, device="cpu")["w"]
    assert torch.equal(t, again)                     # the same slices again


def test_full_qwen3_builds_with_no_fp32_tensor_past_a_slice(monkeypatch):
    """``build_params`` for the full qwen3-moe-30b-a3b on the meta device
    (shapes only): every fp32 tensor made holds at most SLICE_ELEMENTS, and
    the result has every leaf's shape and dtype."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        fp32 = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor) and o.dtype == torch.float32:
                    Largest.fp32 = max(Largest.fp32, o.numel())
            return out
    real = torch.Generator

    class CPUGenerator(real):
        """The meta device has no generator: draw from a CPU one."""
        def __new__(cls, device=None):
            return real(device="cpu")
    monkeypatch.setattr(torch, "Generator", CPUGenerator)
    cfg = get_config("qwen3-moe-30b-a3b")
    with Largest():
        p = tserve.build_params(cfg, device="meta")
    # the embedding's slices of 131072 rows x 2048 are the largest
    assert Largest.fp32 == policy.SLICE_ELEMENTS
    defs = leaves(M.schema(cfg))
    assert [tuple(t.shape) for t in leaves(p)] == [d.shape for d in defs]
    assert p["blocks"]["mlp"]["w_gate"].dtype == torch.bfloat16
    assert p["blocks"]["mlp"]["router"].dtype == torch.float32
    assert sum(t.numel() for t in leaves(p)) == 30_532_110_336


# ---------------------------------------------------------------------------
# the registry and the models: every family accepted, unknown ones refused
# ---------------------------------------------------------------------------

# the names are kept from when the VLM and the xLSTM were refused; both are
# ported since, and each test now checks that the family is accepted and
# that an unknown arch or family still raises
@pytest.mark.parametrize("arch", ["xlstm-350m"])
def test_registry_still_refuses_the_vlm_and_xlstm(arch):
    for get in (get_config, get_smoke):
        assert get(arch).family == "ssm"
        with pytest.raises(KeyError, match="unknown arch"):
            get(arch.replace("350m", "7b"))


@pytest.mark.parametrize("family", ["ssm"])
def test_models_refuse_the_vlm_and_xlstm_families(family):
    cfg = get_smoke("xlstm-350m")
    assert cfg.family == family
    assert set(M.schema(cfg)["groups"]) == {"mlstms", "slstm"}
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(
        jget_smoke("xlstm-350m"))
    with pytest.raises(ValueError, match="unknown model family"):
        M.schema(get_smoke("qwen3-moe-30b-a3b").with_(family="rwkv"))
