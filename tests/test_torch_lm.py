"""The port's dense-decoder serving slice against the live JAX package on
the CPU, at the smoke configs' widths: norms, RoPE and the three FFNs;
``decoder_logits`` with the kernel switch on and off, the cache prefill
and 16 decode steps on the internlm2 and nemotron smoke configs (1e-4);
windowed decode through an 8-slot ring (28 steps, also on the zamba2
smoke);
the continuous-batching engine (identical tokens and ``EngineStats``);
the CLI on the CPU; the four full configs' parameter counts; the
registry.  JAX params cross with ``convert.to_torch``; other inputs come
from a numpy seed."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import model as JM
from repro.models import transformer as jtr
from repro.serve import decode as jdecode
from repro.serve import engine as jengine
from repro.sharding.policy import init_params as jinit
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, PORTED, get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import common, ffn
from repro_torch.models import model as M
from repro_torch.models import transformer as ttr
from repro_torch.serve import decode as tdecode
from repro_torch.serve import engine as tengine
from repro_torch.sharding.policy import init_params, leaves

TOL = 1e-4
SMOKES = ("internlm2-1.8b", "nemotron-4-15b")


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _cfgs(arch):
    jc = jget_smoke(arch)
    tc = get_smoke(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    return jc, tc


@pytest.fixture(scope="module")
def models():
    """For each smoke arch: (jax cfg, port cfg, jax params, port params)."""
    out = {}
    for arch in SMOKES:
        jc, tc = _cfgs(arch)
        jp = jinit(JM.schema(jc), jax.random.PRNGKey(0), jnp.float32)
        tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu",
                              float_dtype=None)
        out[arch] = (jc, tc, jp, tp)
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    x = _randn(0, 2, 5, 64, scale=3.0)
    p = {"scale": _randn(1, 64), "bias": _randn(2, 64)}
    if kind == "rmsnorm":
        p.pop("bias")
    want = jcommon.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind)
    got = common.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches(theta):
    x = _randn(3, 2, 7, 4, 64)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 100, (2, 7))
    want = jcommon.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                      theta)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("ffn_type", ["swiglu", "squared_relu", "gelu"])
def test_ffn_matches(ffn_type):
    jc = jget_smoke("internlm2-1.8b").with_(ffn_type=ffn_type)
    tc = get_smoke("internlm2-1.8b").with_(ffn_type=ffn_type)
    schema = jffn.schema_ffn(jc)
    p = {k: _randn(i, *d.shape, scale=d.shape[0] ** -0.5)
         for i, (k, d) in enumerate(sorted(schema.items()))}
    assert set(p) == set(ffn.schema_ffn(tc))
    x = _randn(9, 3, 5, jc.d_model)
    want = jffn.ffn({k: jnp.asarray(v) for k, v in p.items()}, jc,
                    jnp.asarray(x))
    got = ffn.ffn({k: torch.from_numpy(v) for k, v in p.items()}, tc,
                  torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5)


def test_sdpa_variants_match():
    """``_sdpa`` (fp32 softmax, and bf16 scores with ``softmax_bf16``) and
    the chunked online-softmax ``_sdpa_chunked`` against the reference's."""
    import ml_dtypes
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    B, S, H, hd = 2, 32, 4, 16
    q, k, v = (_randn(20 + i, B, S, H, hd) for i in range(3))
    bias = np.array(jcommon.causal_mask(S, 8))
    np.testing.assert_array_equal(
        common.causal_mask(S, 8).numpy(), bias)
    want = jattn._sdpa(*(jnp.asarray(a) for a in (q, k, v, bias)))
    got = tattn._sdpa(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    _close(got.numpy(), want, 2e-5)
    bf = [a.astype(ml_dtypes.bfloat16) for a in (q, k, v)]
    want = jattn._sdpa(*(jnp.asarray(a) for a in bf), jnp.asarray(bias),
                       softmax_bf16=True)
    got = tattn._sdpa(*(torch.from_numpy(a.view(np.uint16).copy()).view(
        torch.bfloat16) for a in bf), torch.from_numpy(bias),
        softmax_bf16=True)
    _close(got.float().numpy(), np.asarray(want, np.float32), 3e-2)
    for causal, window in ((True, 0), (True, 12), (False, 0)):
        want = jattn._sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=causal, window=window, chunk=8)
        got = tattn._sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal, window=window, chunk=8)
        _close(got.numpy(), want, 2e-5)


def test_attention_chunked_path_matches(models):
    """``attention`` takes the chunked path under ``attn_chunk``."""
    jc, tc, jp, tp = models["internlm2-1.8b"]
    toks = _tokens(4, 2, 32, jc.vocab_size)
    want, _ = jtr.decoder_logits(jp, jc.with_(attn_chunk=8),
                                 {"tokens": jnp.asarray(toks)})
    got, _ = ttr.decoder_logits(tp, tc.with_(attn_chunk=8),
                                {"tokens": torch.from_numpy(toks)})
    _close(got.numpy(), want)


def _tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", SMOKES)
def test_decoder_logits_match_with_switch_on_and_off(models, arch):
    jc, tc, jp, tp = models[arch]
    toks = _tokens(1, 2, 16, jc.vocab_size)
    want, _ = jtr.decoder_logits(jp, jc, {"tokens": jnp.asarray(toks)})
    want_flash, _ = jtr.decoder_logits(jp, jc.with_(use_flash_kernel=True),
                                       {"tokens": jnp.asarray(toks)})
    for switch, jwant in ((False, want), (True, want_flash)):
        got, aux = ttr.decoder_logits(
            tp, tc.with_(use_flash_kernel=switch),
            {"tokens": torch.from_numpy(toks)})
        assert got.shape == (2, 16, jc.vocab_size) and float(aux) == 0.0
        _close(got.numpy(), jwant)
        _close(got.numpy(), want)
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("arch", SMOKES)
@pytest.mark.parametrize("switch", [False, True])
def test_prefill_cache_and_16_decode_steps_match(models, arch, switch):
    jc, tc, jp, tp = models[arch]
    tc = tc.with_(use_flash_kernel=switch)
    B, S, n_slots = 2, 8, 32
    toks = _tokens(2, B, S, jc.vocab_size)
    jlog, jcache = jtr.decoder_prefill_with_cache(jp, jc, jnp.asarray(toks),
                                                  n_slots)
    tlog, tcache = ttr.decoder_prefill_with_cache(tp, tc,
                                                  torch.from_numpy(toks),
                                                  n_slots)
    _close(tlog.numpy(), jlog)
    for got, want in zip(tcache, jcache):
        assert tuple(got.shape) == want.shape
        _close(got.numpy(), want)
    jstep = jax.jit(jdecode.make_decode_step(jc, 0))
    tstep = tdecode.make_decode_step(tc, 0)
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for t in range(16):
        pos = S + t
        jl, jcache = JM.decode(jp, jc, jnp.asarray(tok), jcache,
                               jnp.int32(pos))
        tl, tcache = M.decode(tp, tc, torch.from_numpy(tok), tcache, pos)
        _close(tl.numpy(), jl)
        jn, _ = jstep(jp, jnp.asarray(tok), jcache, jnp.int32(pos + 1))
        tn, _ = tstep(tp, torch.from_numpy(tok),
                      type(tcache)(*(c.clone() for c in tcache)), pos + 1)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for got, want in zip(tcache, jcache):
        _close(got.numpy(), want)


@pytest.mark.parametrize("window", [8, 5])
@pytest.mark.parametrize("arch", SMOKES + ("zamba2-2.7b",))
def test_windowed_decode_ring_matches_jax(models, arch, window):
    """Greedy decode from ``init_cache`` into 8 slots, 28 steps so the ring
    slot ``pos % W`` wraps three times; window 8 fills the ring, window 5
    leaves slots that the ``slot_pos > pos - window`` mask must drop.  The
    port's ``decode`` against the reference's (jitted) on the same weights:
    logits within 1e-4 x max|logit| and identical greedy tokens at every
    step."""
    if arch in models:
        jc, tc, jp, tp = models[arch]
    else:
        jc, tc = _cfgs(arch)
        jp = jax.jit(lambda key: jinit(JM.schema(jc), key, jnp.float32))(
            jax.random.PRNGKey(0))
        tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu",
                              float_dtype=None)
    B, W = 2, 8
    jcache = JM.init_cache(jp, jc, B, W)
    tcache = M.init_cache(tp, tc, B, W)
    jdec = jax.jit(lambda p, tok, c, pos: JM.decode(p, jc, tok, c, pos,
                                                   window))
    tok = _tokens(5, 1, B, jc.vocab_size)[0]
    for pos in range(28):
        jl, jcache = jdec(jp, jnp.asarray(tok), jcache, jnp.int32(pos))
        tl, tcache = M.decode(tp, tc, torch.from_numpy(tok), tcache, pos,
                              window=window)
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).max() <= TOL * max(
            float(np.abs(jl).max()), 1.0), pos
        nxt = np.argmax(jl, -1).astype(np.int32)
        assert np.array_equal(np.argmax(tl.numpy(), -1), nxt), pos
        tok = nxt
    assert ops.LAUNCHES["decode_attention"] == 0    # the plain path


def _requests(module, n, vocab, max_new=6):
    rng = np.random.RandomState(0)
    return [module.Request(rid, rng.randint(0, vocab, int(rng.randint(
        4, 24))).astype(np.int32), max_new=max_new) for rid in range(n)]


@pytest.mark.parametrize("switch", [False, True])
def test_engine_tokens_and_stats_match_jax_engine(models, switch):
    jc, tc, jp, tp = models["internlm2-1.8b"]
    kw = dict(batch=3, n_slots=48, prefill_len=12)
    jeng = jengine.Engine(jp, jc, **kw)
    teng = tengine.Engine(tp, tc.with_(use_flash_kernel=switch),
                          device="cpu", **kw)
    jreqs = _requests(jengine, 7, jc.vocab_size)
    treqs = _requests(tengine, 7, jc.vocab_size)
    for a, b in zip(jreqs, treqs):
        jeng.submit(a)
        teng.submit(b)
    jstats, tstats = jeng.run(), teng.run()
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.done for r in treqs)
    assert len(teng.step_ms) == tstats.decode_steps
    assert len(teng.prefill_ms) == tstats.prefills


def test_serve_cli_on_cpu(tmp_path):
    out = tmp_path / "lm.json"
    rc = tserve.main(["--device", "cpu", "--requests", "5", "--batch", "2",
                      "--max-new", "4", "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["completed"] == 5 and res["tokens_out"] == 20
    assert res["smoke"] and res["device"] == "cpu"
    assert res["step_ms_p50"] > 0 and res["prefills"] == 5


def test_serve_cli_builds_params_in_the_config_dtype():
    cfg = get_smoke("internlm2-1.8b").with_(dtype="bfloat16")
    p = tserve.build_params(cfg, seed=0, device="cpu")
    assert p["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["embed"]["tok"].dtype == torch.bfloat16
    assert p["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert p["ln_f"]["scale"].dtype == torch.float32
    logits = tdecode.prefill_step(
        p, cfg, {"tokens": torch.from_numpy(_tokens(3, 1, 8, 512))})
    assert logits.dtype == torch.bfloat16 and logits.shape == (1, 512)
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", PORTED)
def test_full_config_param_counts_match_without_allocation(arch):
    cfg = get_config(arch)
    jc = jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jc)
    assert cfg.n_params() == jc.n_params()


def test_registry_raises_for_unported_families():
    for arch in ARCH_IDS:
        if arch in PORTED:
            assert get_config(arch).family == (
                "hybrid" if arch == "zamba2-2.7b" else "dense")
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.schema(get_smoke("yi-6b").with_(family="moe"))


def test_init_recipes():
    """Every init recipe of the schema: the reference's distributions,
    drawn from the generator on the target device."""
    from repro_torch.sharding.policy import ParamDef
    n = 20000
    schema = {r: ParamDef((n, 4) if r == "fan_in" else (n,),
                          (None, None) if r == "fan_in" else (None,),
                          init=r, scale=2.0)
              for r in ("zeros", "ones", "fan_in", "embed", "normal",
                        "mamba_A", "dt_bias", "small")}
    p = init_params(schema, torch.Generator().manual_seed(1), torch.float32,
                    device="cpu")
    assert not p["zeros"].any() and bool((p["ones"] == 1).all())
    for r, std in (("fan_in", 2.0 / np.sqrt(n)), ("embed", 0.04),
                   ("normal", 2.0), ("small", 0.02)):
        assert abs(float(p[r].std()) / std - 1) < 0.05, r
    a = p["mamba_A"].exp()
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)


def test_init_params_shapes_dtypes_and_flatten_order():
    cfg = get_smoke("yi-6b")
    gen = torch.Generator().manual_seed(0)
    p = init_params(M.schema(cfg), gen, torch.float32, device="cpu")
    jp = jax.eval_shape(lambda: jinit(JM.schema(jget_smoke("yi-6b")),
                                      jax.random.PRNGKey(0), jnp.float32))
    jl, _ = jax.tree.flatten(jp)
    tl = leaves(p)
    assert [tuple(t.shape) for t in tl] == [a.shape for a in jl]
    assert all(str(t.dtype).split(".")[1] == str(a.dtype)
               for t, a in zip(tl, jl))
    again = init_params(M.schema(cfg), torch.Generator().manual_seed(0),
                        torch.float32, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tl, leaves(again)))
    assert bool((p["blocks"]["ln1"]["scale"] == 1).all())
