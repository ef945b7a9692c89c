"""The port's LM trainer (``repro_torch.train.loop``, ``optim.adam.AdamW``,
``optim.schedule``, ``data.tokens``, ``launch.train``) against the live
JAX package on the CPU, at the smoke configs' widths.

The reference's params cross as arrays (``convert.to_torch``); tokens come
from the Markov stream, which both packages draw from the same numpy
seed.  Bounds:

* the Markov tokens are the same bits; the schedules within 1 ulp;
* AdamW on one tree (an fp32 and a bf16 leaf) within 1e-6 relative;
* a train step's first loss and grad norm within 1e-5 relative; three
  steps' losses within 1e-4 relative, and each param leaf within 1e-4 in
  the relative L2 norm ``|p - p_ref| / |p_ref|``.  The L2 norm, not the
  largest entry: Adam's first steps are ``lr * g / (|g| + eps)``, so a
  coordinate whose gradient is at float-noise level (1e-7 of the leaf's)
  moves by up to ``lr`` with the noise's sign in either package; at the
  reference's lr 3e-4 that reads up to 2.4e-4 of the leaf's largest entry
  (zamba2's smoke), while the leaves' L2 gaps stay below 1e-5.

The grad route: under autograd no forward-only kernel wrapper is called
(the models take ``_sdpa`` and the SSD's einsums); without a gradient the
CPU eval with ``use_flash_kernel`` set still runs the flash wrapper's
plain version, and zamba2's eval the SSD wrapper.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_smoke as jget_smoke
from repro.data import tokens as jtokens
from repro.optim import adam as jadam
from repro.optim import schedule as jsched
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke
from repro_torch.data import tokens as ttokens
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adam as tadam
from repro_torch.optim import schedule as tsched
from repro_torch.sharding.policy import leaves
from repro_torch.train import loop as tloop

FIRST_TOL = 1e-5          # first step's loss and grad norm, relative
STEPS_TOL = 1e-4          # three steps' losses; params, relative L2 a leaf
ADAMW_TOL = 1e-6
LR = (3e-4, 1, 3)         # warmup_cosine(peak, warmup, total)
B, S = 4, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: on six xdist workers the default pool
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _l2_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# tokens and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed", [(512, 0), (1000, 1234)])
def test_markov_tokens_are_the_reference_bits(vocab, seed):
    want = list(jtokens.batches(vocab, 3, 40, 2, seed=seed))
    got = list(ttokens.batches(vocab, 3, 40, 2, seed=seed))
    for w, g in zip(want, got):
        assert g["tokens"].dtype == np.int32
        assert np.array_equal(g["tokens"], w["tokens"])
    jm, tm = jtokens.MarkovTokens(vocab, seed), ttokens.MarkovTokens(vocab,
                                                                     seed)
    assert np.array_equal(tm.support, jm.support)
    assert np.array_equal(tm.probs, jm.probs)


@pytest.mark.parametrize("sched", ["warmup_cosine", "constant"])
def test_schedules_within_one_ulp(sched):
    if sched == "warmup_cosine":
        want_fn = jsched.warmup_cosine(3e-4, 10, 50, final_frac=0.1)
        got_fn = tsched.warmup_cosine(3e-4, 10, 50, final_frac=0.1)
    else:
        want_fn, got_fn = jsched.constant(3e-4), tsched.constant(3e-4)
    for step in range(0, 55):
        want = np.float32(want_fn(jnp.asarray(step, jnp.int32)))
        got = got_fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        got = np.float32(got.item())
        assert abs(got - want) <= np.spacing(want), (step, got, want)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": {"w": rng.randn(7, 5).astype(np.float32)},
            "b": rng.randn(11).astype(np.float32).astype(ml_dtypes.bfloat16)}


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_matches_reference(clip):
    opt = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    jo, to = jadam.AdamW(**opt), tadam.AdamW(**opt)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = convert.to_torch(_tree(0), device="cpu", float_dtype=None)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: a * 3.0, _tree(10 + i))
        jp, js, jn = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tn = to.update(convert.to_torch(g, device="cpu",
                                                float_dtype=None), ts, tp)
        assert _rel(tn, jn) <= ADAMW_TOL
    assert int(ts.step) == 3 and ts.step.dtype == torch.int32
    assert tp["b"].dtype == torch.bfloat16
    for want, got in zip(jax.tree.leaves(jp), leaves(tp)):
        want = np.asarray(want, np.float32)
        got = got.to(torch.float32).numpy()
        assert np.abs(got - want).max() <= ADAMW_TOL * np.abs(want).max()
    for want, got in zip(jax.tree.leaves(js.m) + jax.tree.leaves(js.v),
                         leaves(ts.m) + leaves(ts.v)):
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - np.asarray(want)).max() \
            <= ADAMW_TOL * np.abs(np.asarray(want)).max()
    z = tadam.sgd_momentum_init(tp)
    assert all(t.dtype == torch.float32 and not t.any() for t in leaves(z))
    assert _rel(tadam.global_norm(tp), jadam.global_norm(jp)) <= ADAMW_TOL


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _batches(cfg, objective, n=3, seed=3):
    rng = np.random.RandomState(5)
    out = []
    for b in jtokens.batches(cfg.vocab_size, B, S, n, seed=seed):
        arrs = {"tokens": b["tokens"]}
        if objective == "apcvfl_distill":
            arrs["z_teacher"] = rng.randn(B, cfg.d_model).astype(np.float32)
            arrs["aligned"] = (rng.rand(B) < 0.5).astype(np.float32)
        out.append(arrs)
    return out


def _port_step(arch, objective, n_micro):
    cfg = get_smoke(arch)
    return cfg, tloop.make_train_step(
        cfg, tadam.AdamW(lr=LR[0]), objective=objective, n_micro=n_micro,
        lr_schedule=tsched.warmup_cosine(*LR))


@pytest.mark.parametrize("arch,objective,n_micro", [
    ("internlm2-1.8b", "lm", 1),
    ("zamba2-2.7b", "lm", 1),
    ("internlm2-1.8b", "lm", 2),
    ("internlm2-1.8b", "apcvfl_distill", 1),
    ("zamba2-2.7b", "apcvfl_distill", 2),
])
def test_train_step_matches_reference(arch, objective, n_micro):
    jc = jget_smoke(arch)
    jf = jloop.make_train_step(jc, jadam.AdamW(lr=LR[0]), objective=objective,
                               n_micro=n_micro,
                               lr_schedule=jsched.warmup_cosine(*LR))
    cfg, tf = _port_step(arch, objective, n_micro)
    jp, js = jf.init(jax.random.PRNGKey(0))
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu",
                          float_dtype=None)
    p0 = tp
    ts = tadam.AdamW().init(tp)
    jstep = jax.jit(jf.step)
    batches = _batches(cfg, objective)
    for i, b in enumerate(batches):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tf.step(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        for key in jm:
            tol = FIRST_TOL if i == 0 else STEPS_TOL
            if float(jm[key]) != 0.0 or float(tm[key]) != 0.0:
                assert _rel(tm[key], jm[key]) <= tol, (i, key)
    assert int(ts.step) == 3
    for want, got in zip(jax.tree.leaves(jp), leaves(tp)):
        assert got.dtype == torch.float32
        assert _l2_rel(got.numpy(), want) <= STEPS_TOL
    if n_micro > 1:
        # the accumulated step against one whole-batch step of the port:
        # the mean CE over equal micro-batches is the whole batch's; Eq. 5's
        # distillation term is a mean over each micro-batch's aligned rows,
        # so its loss and gradient differ by design (as in the reference)
        _, whole = _port_step(arch, objective, 1)
        b = {k: torch.from_numpy(v) for k, v in batches[0].items()}
        _, _, m1 = whole.step(p0, tadam.AdamW().init(p0), b)
        _, _, m2 = tf.step(p0, tadam.AdamW().init(p0), b)
        keys = ("ce", "loss", "grad_norm") if objective == "lm" else ("ce",)
        for key in keys:
            assert _rel(m2[key], m1[key]) <= FIRST_TOL, key


def test_cross_entropy_matches_reference():
    rng = np.random.RandomState(0)
    lg = (rng.randn(3, 9, 50) * 4).astype(np.float32)
    lab = rng.randint(0, 50, (3, 9)).astype(np.int32)
    want = float(jloop.cross_entropy(jnp.asarray(lg), jnp.asarray(lab)))
    got = tloop.cross_entropy(torch.from_numpy(lg), torch.from_numpy(lab))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6


def test_train_step_refuses_a_family_the_port_lacks():
    """The port has every family of the reference since the xLSTM; the
    step accepts it and still refuses an unknown family."""
    assert tloop.make_train_step(get_smoke("xlstm-350m")) is not None
    cfg = get_smoke("internlm2-1.8b").with_(family="rwkv")
    with pytest.raises(ValueError, match="unknown model family"):
        tloop.make_train_step(cfg)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-30b-a3b",
                                  "hubert-xlarge", "zamba2-2.7b",
                                  "llama-3.2-vision-11b", "xlstm-350m"])
def test_remat_recomputes_every_block_with_the_same_gradients(arch,
                                                              monkeypatch):
    """``cfg.remat`` checkpoints each block of every family, as the
    reference's ``jax.checkpoint`` does (the self and cross blocks, the
    mamba layers and the shared block), and leaves the loss and the
    gradients as they were."""
    import repro_torch.models.common as tcommon
    calls = []
    real = tcommon.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tcommon, "checkpoint", counted)
    cfg = get_smoke(arch).with_(dtype="float32")
    params, _ = tloop.make_train_step(cfg, tadam.AdamW()).init(
        torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    if cfg.family == "audio":
        batch = {"frames": torch.from_numpy(
                     rng.randn(B, S, cfg.d_model).astype(np.float32)),
                 "labels": torch.from_numpy(
                     rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    else:
        batch = {"tokens": torch.from_numpy(_batches(cfg, "lm", n=1)[0]
                                            ["tokens"])}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.randn(
            B, cfg.n_image_tokens, cfg.d_model).astype(np.float32))

    def loss_and_grads(c):
        ps = [t.detach().requires_grad_() for t in leaves(params)]
        tree = tree_unflatten_sorted(params, ps)
        loss = tloop.task_loss(tree, c, batch)[0]
        return loss, torch.autograd.grad(loss, ps)
    loss0, g0 = loss_and_grads(cfg)
    assert not calls
    loss1, g1 = loss_and_grads(cfg.with_(remat=True))
    n_blocks = cfg.n_layers + (cfg.n_layers // cfg.attn_period
                               if cfg.family == "hybrid" else 0)
    assert len(calls) == n_blocks
    assert torch.equal(loss1, loss0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


def tree_unflatten_sorted(tree, flat: list):
    """A tree shaped like ``tree`` holding ``flat`` in ``leaves``' order."""
    it = iter(flat)

    def build(t):
        if not isinstance(t, dict):
            return next(it)
        made = {k: build(t[k]) for k in sorted(t)}
        return {k: made[k] for k in t}
    return build(tree)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-2.7b"])
def test_grad_route_calls_no_forward_only_kernel(arch, monkeypatch):
    """Under autograd the models take the reference's training route,
    whatever ``use_flash_kernel`` says; the no-grad eval keeps the kernel
    wrappers (on the CPU their plain versions)."""
    calls = {"flash_attention": 0, "ssd_intra_chunk": 0,
             "decode_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    cfg = get_smoke(arch).with_(use_flash_kernel=True)
    fns = tloop.make_train_step(cfg, tadam.AdamW())
    params, state = fns.init(torch.Generator().manual_seed(0))
    b = {"tokens": torch.from_numpy(_batches(cfg, "lm", n=1)[0]["tokens"])}
    params, state, m = fns.step(params, state, b)
    assert np.isfinite(float(m["loss"]))
    assert calls == {"flash_attention": 0, "ssd_intra_chunk": 0,
                     "decode_attention": 0}
    with torch.no_grad():
        eval_loss = tloop.task_loss(params, cfg, b)[0]
    n_attn = (cfg.n_layers if cfg.family == "dense"
              else cfg.n_layers // cfg.attn_period)
    n_ssd = cfg.n_layers if cfg.family == "hybrid" else 0
    assert calls == {"flash_attention": n_attn, "ssd_intra_chunk": n_ssd,
                     "decode_attention": 0}
    # the eval's plain kernels and the training route agree
    with torch.no_grad():
        plain = tloop.task_loss(params, cfg.with_(use_flash_kernel=False),
                                b)[0]
    assert _rel(eval_loss, plain) <= FIRST_TOL
    assert ops.LAUNCHES["flash_attention"] == 0


def test_train_cli_on_cpu_prints_reference_keys_and_checkpoints(
        tmp_path, capsys):
    path = str(tmp_path / "lm")
    out = str(tmp_path / "train.json")
    rc = tlaunch.main(["--smoke", "--device", "cpu", "--ckpt", path,
                       "--out", out])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "device: cpu"
    res = json.loads(lines[-1])
    assert list(res) == ["first_loss", "last_loss", "eval_before",
                         "eval_after", "improved"]
    assert res["improved"] is True
    with open(out) as fh:
        rec = json.load(fh)
    assert len(rec["losses"]) == len(rec["step_s"]) == 50
    assert all(np.isfinite(rec["losses"]))
    assert rec["launches"]["steps"] == {k: 0 for k in ops.LAUNCHES}
    cfg = get_smoke("internlm2-1.8b")
    want = tloop.make_train_step(cfg).init(torch.Generator().manual_seed(0))
    for load in (ckpt.load_tree, jckpt.load_tree):
        tree, side = load(path)
        assert side["step"] == 50 and side["meta"]["arch"] == "internlm2-1.8b"
        got = tree["params"]
        assert jax.tree.structure(got) == jax.tree.structure(
            convert.to_numpy(want[0]))
        for a, w in zip(leaves(got), leaves(want[0])):
            assert a.shape == tuple(w.shape) and a.dtype == np.float32
