"""The port's encoder-only audio stack (hubert-xlarge: pre-embedded
frames, bidirectional attention, layernorm, gelu, no decode) against the
live JAX package on the CPU, at the smoke config's widths: logits within
1e-4 with the kernel switch on and off, the card's attention route (the
flash kernel's plain version with ``causal=False``) against the
reference's ``_sdpa`` with a zero bias, the frame cross-entropy within
1e-5 and two train steps within the LM trainer's bounds; and what the
family refuses: the engine, ``launch/serve``, ``launch/train`` and a
decode cache, with the reference's reasons.  JAX params cross with
``convert.to_torch``; frames and labels come from a numpy seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import transformer as jtr
from repro.optim import adam as jadam
from repro.sharding.policy import init_params as jinit
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as M
from repro_torch.models import transformer as ttr
from repro_torch.optim import adam as tadam
from repro_torch.serve import engine as tengine
from repro_torch.sharding.policy import leaves
from repro_torch.train import loop as tloop

ARCH = "hubert-xlarge"
TOL = 1e-4                       # logits
TOL_CE = 1e-5                    # frame CE, first step's loss and grad norm
STEPS_TOL = 1e-4                 # later losses; params, relative L2 a leaf


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hubert():
    jc, tc = jget_smoke(ARCH), get_smoke(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jp = jinit(JM.schema(jc), jax.random.PRNGKey(0), jnp.float32)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu",
                          float_dtype=None)
    return jc, tc, jp, tp


def _frames(seed, B, S, d):
    return np.random.RandomState(seed).randn(B, S, d).astype(np.float32)


def _labels(seed, B, S, V):
    return np.random.RandomState(seed).randint(0, V, (B, S)).astype(np.int32)


def test_schema_has_no_token_table(hubert):
    jc, tc, jp, tp = hubert
    assert list(tp["embed"]) == ["out"] and "tok" not in jp["embed"]
    assert [tuple(t.shape) for t in leaves(tp)] == [
        a.shape for a in jax.tree.leaves(jp)]
    assert not M.supports_decode(tc) and not ttr._is_moe(tc)


@pytest.mark.parametrize("switch", [False, True])
@pytest.mark.parametrize("B,S", [(2, 24), (1, 77)])
def test_logits_match(hubert, switch, B, S):
    jc, tc, jp, tp = hubert
    x = _frames(1, B, S, jc.d_model)
    want, want_aux = jtr.decoder_logits(jp, jc, {"frames": jnp.asarray(x)})
    got, aux = M.logits(tp, tc.with_(use_flash_kernel=switch),
                        {"frames": torch.from_numpy(x)})
    assert got.shape == (B, S, jc.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert float(aux) == float(want_aux) == 0.0
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("B,S,H,hd", [(2, 24, 4, 64), (1, 150, 16, 80)])
def test_card_route_is_the_reference_bidirectional_sdpa(B, S, H, hd):
    """On the card the encoder's attention is the flash kernel with
    ``causal=False``; its plain version (what the kernel is held to)
    against the reference's ``_sdpa`` with a zero bias, which the
    reference takes for a non-causal config."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(B, S, H, hd).astype(np.float32) for _ in range(3))
    want = jattn._sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                       jnp.zeros((S, S), jnp.float32))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _batch(cfg, seed, B=2, S=32):
    return {"frames": _frames(seed, B, S, cfg.d_model),
            "labels": _labels(seed + 1, B, S, cfg.vocab_size)}


def test_frame_cross_entropy_matches(hubert):
    jc, tc, jp, tp = hubert
    b = _batch(tc, 3)
    want, wm = jloop.task_loss(jp, jc, {k: jnp.asarray(v)
                                        for k, v in b.items()})
    got, gm = tloop.task_loss(tp, tc, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
    assert abs(float(got) - float(want)) <= TOL_CE * abs(float(want))
    assert abs(float(gm["ce"]) - float(wm["ce"])) <= TOL_CE * abs(
        float(wm["ce"]))
    assert float(gm["aux"]) == 0.0


def test_two_train_steps_match_reference(hubert):
    jc, tc, jp, tp = hubert
    jf = jloop.make_train_step(jc, jadam.AdamW(lr=3e-4))
    tf = tloop.make_train_step(tc, tadam.AdamW(lr=3e-4))
    js, ts = jadam.AdamW().init(jp), tadam.AdamW().init(tp)
    jstep = jax.jit(jf.step)
    for i in range(2):
        b = _batch(tc, 10 + i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tf.step(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        tol = TOL_CE if i == 0 else STEPS_TOL
        for key in ("loss", "ce", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= tol * abs(
                float(jm[key])), (i, key)
    for want, got in zip(jax.tree.leaves(jp), leaves(tp)):
        want = np.asarray(want, np.float64)
        assert np.linalg.norm(got.numpy() - want) <= STEPS_TOL * \
            np.linalg.norm(want)


def test_no_decode_cache_and_no_engine(hubert):
    jc, tc, jp, tp = hubert
    with pytest.raises(ValueError, match="encoder-only"):
        M.init_cache(tp, tc, 2, 16)
    with pytest.raises(ValueError, match="encoder-only"):
        ttr.decoder_prefill_with_cache(tp, tc, torch.zeros((1, 4),
                                                           dtype=torch.int32),
                                       16)
    with pytest.raises(ValueError, match="engine supports KV-cache families"):
        tengine.Engine(tp, tc, batch=2, n_slots=16, device="cpu")


@pytest.mark.parametrize("smoke", [["--smoke"], ["--no-smoke"]])
def test_serve_cli_refuses_before_any_weight(monkeypatch, smoke):
    def no_weights(*a, **kw):
        raise AssertionError("weights made for a refused family")
    monkeypatch.setattr(tserve, "build_params", no_weights)
    with pytest.raises(SystemExit, match="engine supports KV-cache"):
        tserve.main(["--arch", ARCH, "--device", "cpu", *smoke])


@pytest.mark.parametrize("smoke", [["--smoke"], []])
def test_train_cli_refuses_with_the_reference_message(smoke):
    with pytest.raises(SystemExit, match="masked-frame objective"):
        tlaunch.main(["--arch", ARCH, "--device", "cpu", *smoke])


def test_full_config_counts():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.causal) == (
        48, 1280, 16, 80, False)
    assert M.count_params_analytic(cfg) == M.count_active_params(cfg) \
        == JM.count_params_analytic(jget_config(ARCH)) == 944_611_840
