"""The port's VLM (llama-3.2-vision-11b: groups of self blocks closed by a
gated cross-attention block) against the live JAX package on the CPU, at
the smoke config (4 layers in 2 groups of one self block and one cross
block, 16 image tokens, fp32).

The reference's params cross with ``convert.to_torch``.  Its cross blocks'
gates start at zero (``tanh(0) = 0``), which would leave every cross path
out of every comparison, so the fixture sets each group's gate to a
nonzero value drawn from a numpy seed, the same array in both packages;
the image embeddings are normal from a numpy seed.  A zero-gate case shows
that the image then has no effect, and that with the drawn gates it moves
the logits far beyond the bounds, so the other cases are not vacuous.

Bounds: cross-attention and its decode 1e-5; the plain flash at a key
length of its own against the reference's ``_sdpa`` with a zero bias
1e-5; ``vlm_logits`` 1e-4 x max|logit| with the kernel switch on and off;
``init_cache``'s image K/V 1e-5; 16 greedy decode steps identical tokens
and logits 1e-4 x max|logit|; the port's decode against its forward 2e-3
(the reference's ``test_decode_matches_forward``); a train step's first
loss and grad norm 1e-5 relative, params after two steps 1e-4 in relative
L2 a leaf (``tests/test_torch_train_lm.py``)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import schedule as jsched
from repro.serve import decode as jdecode
from repro.sharding.policy import init_params as jinit
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import model as M
from repro_torch.models import transformer as ttr
from repro_torch.optim import adam as tadam
from repro_torch.optim import schedule as tsched
from repro_torch.serve import decode as tdecode
from repro_torch.serve.engine import Engine
from repro_torch.sharding.policy import leaves
from repro_torch.train import loop as tloop

ARCH = "llama-3.2-vision-11b"
TOL_ATTN = 1e-5
TOL = 1e-4                       # x max|logit|
TOL_DECODE_VS_FORWARD = 2e-3     # tests/test_arch_smoke.py
FIRST_TOL = 1e-5                 # first step's loss and grad norm, relative
STEPS_TOL = 1e-4                 # params, relative L2 a leaf
LR = (3e-4, 1, 3)                # warmup_cosine(peak, warmup, total)
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: on six xdist workers the default pool
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates(jp, seed):
    """``jp`` with each group's cross gate drawn from ``seed``: |gate| in
    [0.3, 1.2], either sign."""
    rng = np.random.RandomState(seed)
    g = jp["groups"]["cross"]["gate"].shape
    gate = (rng.uniform(0.3, 1.2, g) * rng.choice([-1.0, 1.0], g)).astype(
        np.float32)
    cross = dict(jp["groups"]["cross"], gate=jnp.asarray(gate))
    return dict(jp, groups=dict(jp["groups"], cross=cross))


def _image(seed, batch, cfg):
    return np.random.RandomState(seed).randn(
        batch, cfg.n_image_tokens, cfg.d_model).astype(np.float32)


def _tokens(seed, batch, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (batch, S)).astype(
        np.int32)


@pytest.fixture(scope="module")
def vlm():
    """(jax cfg, port cfg, jax params, port params) of the VLM smoke, the
    gates nonzero."""
    jc, tc = jget_smoke(ARCH), get_smoke(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jp = jax.jit(lambda k: jinit(JM.schema(jc), k, jnp.float32))(
        jax.random.PRNGKey(0))
    jp = _gates(jp, 1)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu",
                          float_dtype=None)
    return jc, tc, jp, tp


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _cross(tree, g):
    """Group ``g``'s cross block of a stacked (G, ...) params tree."""
    return jax.tree.map(lambda a: a[g], tree["groups"]["cross"])


# ---------------------------------------------------------------------------
# cross-attention and the flash plain version at a key length of its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["cross_attention",
                                   "decode_cross_attention"])
def test_cross_attention_matches_reference(vlm, which):
    """S text positions (24, or one decode row) against T = 16 image
    tokens, GQA 4 heads on 2 kv heads."""
    jc, tc, jp, tp = vlm
    jx = _cross(jp, 1)["xattn"]
    tx = convert.to_torch(jax.tree.map(np.asarray, jx), device="cpu")
    S = 24 if which == "cross_attention" else 1
    x = np.random.RandomState(2).randn(B, S, tc.d_model).astype(np.float32)
    img = _image(3, B, tc)
    if which == "cross_attention":
        want = jax.jit(lambda p, x, f: jattn.cross_attention(p, jc, x, f))(
            jx, jnp.asarray(x), jnp.asarray(img))
        got = tattn.cross_attention(tx, tc, torch.from_numpy(x),
                                    torch.from_numpy(img))
    else:
        want = jattn.decode_cross_attention(
            jx, jc, jnp.asarray(x), jattn.cross_kv(jx, jc, jnp.asarray(img)))
        got = tattn.decode_cross_attention(
            tx, tc, torch.from_numpy(x),
            tattn.cross_kv(tx, tc, torch.from_numpy(img)))
    assert tuple(got.shape) == (B, S, tc.d_model)
    _close(got.numpy(), want, TOL_ATTN)
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.LAUNCHES["decode_attention"] == 0


def test_plain_flash_at_a_key_length_of_its_own_matches_sdpa():
    """``ref.flash_attention_model`` (what ``ops.flash_attention`` runs for
    a CPU tensor) with T != S, non-causal: the reference's ``_sdpa`` with a
    zero bias, GQA expanded; S 100 against T 37 at hd 64 and S 1 against T
    16."""
    for seed, (S, T, H, K, hd) in enumerate(((100, 37, 4, 2, 64),
                                             (1, 16, 4, 2, 64))):
        rng = np.random.RandomState(10 + seed)
        q = rng.randn(B, S, H, hd).astype(np.float32)
        k, v = (rng.randn(B, T, K, hd).astype(np.float32) for _ in range(2))
        want = jattn._sdpa(jnp.asarray(q),
                           jattn._gqa_expand(jnp.asarray(k), H, K),
                           jattn._gqa_expand(jnp.asarray(v), H, K), 0.0)
        for fn in (ref.flash_attention_model, ops.flash_attention):
            got = fn(*map(torch.from_numpy, (q, k, v)), causal=False)
            assert tuple(got.shape) == (B, S, H, hd)
            _close(got.numpy(), want, TOL_ATTN)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8), (True, 8)])
def test_flash_refuses_masks_at_a_key_length_of_its_own(causal, window):
    q = torch.zeros((1, 24, 4, 64))
    kv = torch.zeros((1, 16, 2, 64))
    for fn in (ref.flash_attention_model, ops.flash_attention):
        with pytest.raises(ValueError, match="16 keys for 24 queries"):
            fn(q, kv, kv, causal=causal, window=window)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("switch", [False, True])
def test_vlm_logits_match(vlm, switch):
    jc, tc, jp, tp = vlm
    toks, img = _tokens(4, B, 32, jc.vocab_size), _image(5, B, jc)
    want, _ = jax.jit(lambda p, t, i: JM.logits(
        p, jc, {"tokens": t, "image_embeds": i}))(jp, jnp.asarray(toks),
                                                  jnp.asarray(img))
    inputs = {"tokens": torch.from_numpy(toks),
              "image_embeds": torch.from_numpy(img)}
    cfg = tc.with_(use_flash_kernel=switch)
    got, aux = M.logits(tp, cfg, inputs)
    assert got.shape == (B, 32, jc.vocab_size) and float(aux) == 0.0
    assert _rel(got.numpy(), want) <= TOL
    lg = tdecode.prefill_step(tp, cfg, inputs)
    assert _rel(lg.numpy(), np.asarray(want)[:, -1]) <= TOL
    assert ops.LAUNCHES["flash_attention"] == 0


def test_init_cache_and_16_decode_steps_match(vlm):
    """Greedy decode from ``init_cache(image_embeds=)``: the reference's
    jitted ``make_decode_step`` and ``decode`` against the port's, step
    by step (the port's cache is updated in place; its step runs on a
    copy)."""
    jc, tc, jp, tp = vlm
    n_slots, img = 24, _image(6, B, jc)
    jcache = JM.init_cache(jp, jc, B, n_slots, image_embeds=jnp.asarray(img))
    tcache = M.init_cache(tp, tc, B, n_slots,
                          image_embeds=torch.from_numpy(img))
    assert isinstance(tcache, ttr.VLMCache)
    for got, want in zip(tcache, jcache):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[1] == str(want.dtype)
    for got, want in zip(tcache[:3], jcache[:3]):
        assert np.array_equal(got.numpy(), np.asarray(want))
    _close(tcache.xk.numpy(), jcache.xk, TOL_ATTN)
    _close(tcache.xv.numpy(), jcache.xv, TOL_ATTN)
    jdec = jax.jit(lambda p, tok, c, pos: JM.decode(p, jc, tok, c, pos))
    jstep = jax.jit(jdecode.make_decode_step(jc, 0))
    tstep = tdecode.make_decode_step(tc, 0)
    tok = _tokens(7, 1, B, jc.vocab_size)[0]
    for pos in range(16):
        jn, _ = jstep(jp, jnp.asarray(tok), jcache, jnp.int32(pos))
        tn, _ = tstep(tp, torch.from_numpy(tok),
                      ttr.VLMCache(*(c.clone() for c in tcache)), pos)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        jl, jcache = jdec(jp, jnp.asarray(tok), jcache, jnp.int32(pos))
        tl, tcache = M.decode(tp, tc, torch.from_numpy(tok), tcache, pos)
        assert _rel(tl.numpy(), jl) <= TOL
        assert np.array_equal(np.argmax(tl.numpy(), -1), np.asarray(jn))
        tok = np.array(jn)
    for got, want in zip(tcache, jcache):
        _close(got.numpy(), want, TOL)


def test_decode_matches_forward(vlm):
    """The port's decode (self-attention caches, the image K/V) reproduces
    its forward (the reference's own check, ``tests/test_arch_smoke.py``)."""
    jc, tc, jp, tp = vlm
    T = 16
    toks = torch.from_numpy(_tokens(8, B, T, tc.vocab_size))
    img = torch.from_numpy(_image(9, B, tc))
    full, _ = M.logits(tp, tc, {"tokens": toks, "image_embeds": img})
    cache = M.init_cache(tp, tc, B, T, image_embeds=img)
    errs = []
    for t in range(T):
        lg, cache = M.decode(tp, tc, toks[:, t], cache, t)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < TOL_DECODE_VS_FORWARD, errs


def test_zero_gates_leave_the_image_out(vlm):
    """With every gate 0 the image has no effect on the logits or the
    decode; with the fixture's gates another image moves the logits by far
    more than the bounds above, so the cases above see the cross path."""
    jc, tc, jp, tp = vlm
    toks = torch.from_numpy(_tokens(10, B, 16, tc.vocab_size))
    imgs = [torch.from_numpy(_image(s, B, tc)) for s in (11, 12)]
    zero = dict(tp, groups=dict(tp["groups"], cross=dict(
        tp["groups"]["cross"], gate=torch.zeros_like(
            tp["groups"]["cross"]["gate"]))))
    lgs = {name: [M.logits(p, tc, {"tokens": toks, "image_embeds": i})[0]
                  for i in imgs] for name, p in (("zero", zero),
                                                 ("gated", tp))}
    assert torch.equal(*lgs["zero"])
    moved = _rel(lgs["gated"][0].numpy(), lgs["gated"][1].numpy())
    assert moved > 100 * TOL, moved
    steps = []
    for i in imgs:
        cache = M.init_cache(zero, tc, B, 4, image_embeds=i)
        steps.append(M.decode(zero, tc, toks[:, 0], cache, 0)[0])
    assert torch.equal(*steps)


def test_schema_shapes_and_full_param_count(vlm):
    jc, tc, jp, tp = vlm
    assert [tuple(t.shape) for t in leaves(tp)] == \
        [a.shape for a in jax.tree.leaves(jp)]
    assert tuple(tp["groups"]["selfs"]["attn"]["wq"].shape[:2]) == (2, 1)
    assert tp["groups"]["cross"]["gate"].dtype == torch.float32
    cfg = get_config(ARCH)
    assert M.count_params_analytic(cfg) == 9_775_157_256
    assert (cfg.n_layers, cfg.cross_attn_period, cfg.n_image_tokens,
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_size, cfg.dtype) == (40, 5, 1600, 4096, 32, 8, 128,
                                           14336, 128256, "bfloat16")


def test_refusals(vlm):
    """The decode cache needs the image; a depth that does not tile into
    groups; the engine and the serving CLI refuse the family, as the
    reference's engine does."""
    jc, tc, jp, tp = vlm
    with pytest.raises(ValueError, match="image_embeds"):
        M.init_cache(tp, tc, B, 8)
    with pytest.raises(ValueError, match="tile into cross groups"):
        M.schema(tc.with_(n_layers=3))
    with pytest.raises(ValueError, match="KV-cache families"):
        Engine(tp, tc, batch=2, n_slots=16, device="cpu")
    with pytest.raises(SystemExit, match="KV-cache families"):
        tserve.main(["--arch", ARCH, "--device", "cpu"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batches(cfg, n=2, batch=4, S=32, seed=3):
    """Markov tokens with nonzero seeded images (the CLI feeds zeros)."""
    from repro.data import tokens as jtokens
    rng = np.random.RandomState(13)
    return [{"tokens": b["tokens"],
             "image_embeds": rng.randn(batch, cfg.n_image_tokens,
                                       cfg.d_model).astype(np.float32)}
            for b in jtokens.batches(cfg.vocab_size, batch, S, n, seed=seed)]


def test_train_step_matches_reference():
    jc, tc = jget_smoke(ARCH), get_smoke(ARCH)
    jf = jloop.make_train_step(jc, jadam.AdamW(lr=LR[0]),
                               lr_schedule=jsched.warmup_cosine(*LR))
    tf = tloop.make_train_step(tc, tadam.AdamW(lr=LR[0]),
                               lr_schedule=tsched.warmup_cosine(*LR))
    jp, js = jf.init(jax.random.PRNGKey(0))
    jp = _gates(jp, 14)
    gate0 = np.asarray(jp["groups"]["cross"]["gate"])
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu",
                          float_dtype=None)
    ts = tadam.AdamW().init(tp)
    jstep = jax.jit(jf.step)
    for i, b in enumerate(_batches(tc)):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tf.step(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        if i == 0:
            for key in ("loss", "grad_norm"):
                assert abs(float(tm[key]) - float(jm[key])) \
                    <= FIRST_TOL * abs(float(jm[key])), key
    assert int(ts.step) == 2
    for want, got in zip(jax.tree.leaves(jp), leaves(tp)):
        want = np.asarray(want, np.float64)
        gap = np.linalg.norm(got.numpy().astype(np.float64) - want)
        assert gap <= STEPS_TOL * np.linalg.norm(want)
    # the gates moved: the cross path carries a gradient
    assert not np.allclose(np.asarray(jp["groups"]["cross"]["gate"]), gate0,
                           rtol=0, atol=1e-6)


def test_grad_route_calls_no_forward_only_kernel(monkeypatch):
    """Under autograd no kernel wrapper is called; the no-grad eval with
    the switch on calls the flash wrapper (its plain version) once a self
    block, while on the CPU cross-attention stays ``_sdpa``."""
    calls = {"flash_attention": 0, "decode_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    cfg = get_smoke(ARCH).with_(use_flash_kernel=True)
    fns = tloop.make_train_step(cfg, tadam.AdamW())
    params, state = fns.init(torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in _batches(cfg, n=1)[0].items()}
    params, state, m = fns.step(params, state, b)
    assert np.isfinite(float(m["loss"]))
    assert calls == {"flash_attention": 0, "decode_attention": 0}
    with torch.no_grad():
        tloop.task_loss(params, cfg, b)
    G = cfg.n_layers // cfg.cross_attn_period
    assert calls == {"flash_attention": cfg.n_layers - G,
                     "decode_attention": 0}


def test_train_cli_on_cpu(capsys):
    rc = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "30", "--batch", "4", "--seq", "64"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "device: cpu"
    res = json.loads(lines[-1])
    assert list(res) == ["first_loss", "last_loss", "eval_before",
                         "eval_after", "improved"]
    assert res["improved"] is True


@pytest.mark.parametrize("layers", [3, 5])
def test_train_cli_refuses_a_depth_off_the_groups(layers):
    with pytest.raises(SystemExit, match="multiple of 2"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--layers", str(layers), "--steps", "1"])
