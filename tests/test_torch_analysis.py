"""The port's static analysis and runtime guards (``repro_torch.analysis``,
``repro_torch.launch.lint``) on the CPU.

Static layer: R001 and R007 fire on their bad fixtures and stay silent on
the sanctioned idioms (host casts of config and annotated scalars,
``guards.to_host``, the float64 sums allowed by name, an explicit dtype);
the baseline round-trips; the tree lints clean, and a planted ``.item()``
in a copy of a per-step module fails the CLI.

Runtime layer, against ``ANALYSIS_budgets.json``: each guard catches its
planted violation and passes the clean case; a warmed VFL dispatch makes
``serve_bucket_warm.host_syncs_per_dispatch`` copies; a fit makes one copy
per epoch run (the port's contract: early stopping decides on the host,
where the reference's ``train_fit`` makes one per fit); an xLSTM and a
dense-decoder decode step make one copy each (their tokens); the fitted
params and the bundle stay in ``engine_dtypes``; nothing compiles.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import guards
from repro_torch.analysis.lint import (apply_baseline, lint_paths, lint_source,
                                       load_baseline, write_baseline)
from repro_torch.configs import get_smoke
from repro_torch.core import autoencoder as ae
from repro_torch.core import training
from repro_torch.core.psi import psi
from repro_torch.data.synthetic import make_dataset
from repro_torch.data.vertical import make_scenario
from repro_torch.launch import serve as tserve
from repro_torch.models import model as M
from repro_torch.serve import vfl
from repro_torch.serve.decode import make_decode_step
from repro_torch.serve.engine import Engine
from repro_torch.sharding.policy import init_params

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BASELINE = os.path.join(REPO, "src", "repro_torch", "analysis",
                        "baseline.json")
PER_STEP = "repro_torch.models.fixture"        # a module of models/
HOST = "repro_torch.launch.fixture"            # host code


def rules_of(findings):
    return sorted({f.rule for f in findings})


def lint_snippet(code, modpath=PER_STEP):
    return lint_source(textwrap.dedent(code), modpath=modpath)


@pytest.fixture(scope="module")
def budgets():
    return guards.load_budgets()


# ---------------------------------------------------------------------------
# static rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("expr", ["x.sum().item()", "x.tolist()",
                                  "x.cpu()", "(x * 2).numpy()",
                                  "float(x.max())", "int(x[0])",
                                  "bool((x > 0).any())",
                                  "float(torch.exp(n))"])
def test_r001_fires_on_host_calls_of_tensors_in_per_step_code(expr):
    bad = lint_snippet(f"""
        import torch

        def block(p, cfg, x):
            n = torch.ones(3, dtype=torch.float32)
            return {expr}
    """)
    assert rules_of(bad) == ["R001"]
    assert bad[0].symbol == "block"


def test_r001_silent_on_host_values_to_host_and_host_code():
    good = lint_snippet("""
        import math
        import numpy as np
        import torch
        from repro_torch.analysis.guards import to_host

        def decode(p, cfg, x, pos: int, *, lam=0.5):
            pos = int(pos)
            scale = float(math.sqrt(x.shape[-1])) * float(lam)
            B = int(x.shape[0])
            toks = to_host(x.argmax(-1)).tolist()
            return x * scale, float(cfg.rope_theta), B, toks, int(np.sum(1))
    """)
    assert good == []
    host = lint_snippet("""
        def report(x):
            return float(x.max()), x.cpu().numpy()
    """, modpath=HOST)
    assert host == []


def test_r001_losses_by_name_in_the_loss_modules_not_factories():
    found = lint_snippet("""
        def recon_loss(params, batch):
            return float(batch["x"].sum())

        def make_recon_loss(lam: float):
            def loss(params, batch):
                return batch["x"].sum().item() * lam
            return loss

        def table(params):
            return params["w"].tolist()
    """, modpath="repro_torch.core.autoencoder")
    assert [f.symbol for f in found] == ["recon_loss",
                                         "make_recon_loss.loss"]


def test_r007_flags_float64_anywhere_but_the_sums_allowed_by_name():
    bad = lint_snippet("""
        import torch

        def stats(x):
            return x.to(torch.float64).sum(), x.double()

        EPS = torch.finfo(torch.double).eps
    """, modpath=HOST)
    assert [(f.rule, f.symbol) for f in bad] == [
        ("R007", "stats"), ("R007", "stats"), ("R007", "")]
    good = lint_snippet("""
        import torch

        def prefix_sum(a, dim: int):
            return torch.cumsum(a.to(torch.float64), dim).to(torch.float32)
    """, modpath="repro_torch.kernels.ref")
    assert good == []
    elsewhere = lint_snippet("""
        import torch

        def prefix_sum(a, dim: int):
            return torch.cumsum(a.to(torch.float64), dim)
    """, modpath="repro_torch.kernels.ops")
    assert rules_of(elsewhere) == ["R007"]


def test_r007_creation_without_dtype_in_per_step_code_only():
    src = """
        import torch

        def block(p, cfg, x):
            i = torch.arange(x.shape[1], device=x.device)
            z = torch.zeros((2, 3), dtype=torch.float32, device=x.device)
            return x[:, i] + z.sum() + torch.full((), 1.0, device=x.device)
    """
    bad = lint_snippet(src)
    assert [(f.rule, f.message.split("`")[1]) for f in bad] == [
        ("R007", "torch.arange"), ("R007", "torch.full")]
    assert lint_snippet(src, modpath=HOST) == []


def test_baseline_suppression_round_trips(tmp_path):
    src = tmp_path / "src" / "repro_torch" / "models"
    src.mkdir(parents=True)
    (src / "bad.py").write_text(textwrap.dedent("""
        def block(p, cfg, x):
            return x.item()
    """))
    raw = lint_paths(["src/repro_torch"], root=str(tmp_path))
    assert rules_of(raw) == ["R001"]
    path = str(tmp_path / "baseline.json")
    write_baseline(path, raw)
    assert apply_baseline(raw, load_baseline(path)) == []
    entry = json.load(open(path))["entries"][0]
    assert entry["justification"] == "TODO: justify or fix"
    assert apply_baseline(raw + raw, load_baseline(path)) == raw


def test_tree_lints_clean_and_a_planted_item_fails(tmp_path):
    assert lint_paths(["src/repro_torch"], root=REPO,
                      baseline_path=BASELINE) == []
    assert json.load(open(BASELINE))["entries"] == []
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.lint", "--json"]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert json.loads(r.stdout)["total"] == 0
    copy = tmp_path / "src" / "repro_torch"
    shutil.copytree(os.path.join(REPO, "src", "repro_torch"), copy,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    with open(copy / "models" / "xlstm.py", "a") as fh:
        fh.write("\n\ndef _gate_value(x):\n    return x.max().item()\n")
    r = subprocess.run(cmd + ["--root", str(tmp_path)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    out = json.loads(r.stdout)
    assert [(f["rule"], f["symbol"]) for f in out["findings"]] == [
        ("R001", "_gate_value")]


# ---------------------------------------------------------------------------
# the guards, each on a planted violation and the clean case
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("convert", [
    lambda t: t.item(), lambda t: t.tolist(), lambda t: t.numpy(),
    lambda t: t.cpu(), lambda t: float(t), lambda t: int(t),
    lambda t: bool(t), lambda t: [0, 1][t], lambda t: np.asarray(t),
    lambda t: np.array(t)])
def test_no_host_sync_traps_each_implicit_conversion(convert):
    t = torch.tensor(1, dtype=torch.int64)
    with pytest.raises(guards.HostSyncError, match="implicit"):
        with guards.no_host_sync(1, device="cpu", label="planted"):
            convert(t)
    convert(t)                              # restored on exit


def test_no_host_sync_counts_to_host_and_spares_host_tensors():
    x = torch.arange(6, dtype=torch.float32)
    with guards.no_host_sync(1, device="cpu") as tally:
        perm = training.default_perm(3, 1, 6)       # a host draw
        got = guards.to_host(x[perm])
    assert tally.copies == 1 and sorted(got.tolist()) == x.tolist()
    with pytest.raises(guards.HostSyncError, match="2 to_host"):
        with guards.no_host_sync(1, device="cpu"):
            guards.to_host(x)
            guards.to_host(x)
    with guards.no_host_sync(0, device="cuda"):     # CPU tensors are host
        assert float(x.sum()) == 15.0 and x.tolist()[1] == 1.0
    assert torch.equal(torch.from_numpy(training.default_perm(3, 1, 6)),
                       torch.from_numpy(perm))


def test_audit_dtypes_and_compile_counter(budgets):
    tree = {"w": torch.zeros(2, dtype=torch.float32),
            "q": np.zeros(2, np.int8), "st": ae.init_mlp(
                torch.Generator().manual_seed(0), [3, 4], device="cpu")}
    guards.audit_dtypes(tree, budgets["engine_dtypes"])
    for bad in (torch.zeros(2, dtype=torch.float64),
                torch.zeros(2, dtype=torch.bfloat16), 1.5):
        with pytest.raises(guards.DtypeAuditError, match="'bad'"):
            guards.audit_dtypes(dict(tree, bad=bad), budgets["engine_dtypes"])
    with guards.compile_counter(0) as c:
        torch.ones(3).sum()
    assert c.count == 0


# ---------------------------------------------------------------------------
# the budgets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundle():
    """A bcw bundle with seeded random weights (the sync count does not
    depend on their values) and the aligned rows' latents cached."""
    ds = make_dataset("bcw", seed=0)
    sc = make_scenario(ds, n_active_features=5, n_aligned=150, seed=0)
    gen = torch.Generator().manual_seed(0)
    d_a, d_p = sc.active.x.shape[1], sc.passive.x.shape[1]
    g1p = ae.table3_encoder("g1_passive", d_p)[-1]
    g1a = ae.table3_encoder("g1_active", d_a)
    init = lambda w: {k: {n: t.numpy() for n, t in v.items()} for k, v in
                      ae.init_autoencoder(gen, w, device="cpu").items()}
    head = lambda: {"w": torch.randn((256, sc.n_classes),
                                     generator=gen).numpy() / 16,
                    "b": np.zeros(sc.n_classes, np.float32)}
    aligned, _, _ = psi(sc.active.ids, sc.passive.ids)
    b = vfl.ModelBundle(
        meta={"n_classes": int(sc.n_classes)},
        g3=init(ae.table3_encoder("g3", d_a)), head_active=head(),
        x_mean=np.zeros(d_a, np.float32), x_scale=np.ones(d_a, np.float32),
        g1_active=init(g1a), g2=init(ae.table3_encoder("g2", g1a[-1] + g1p)),
        head_joint=head(), cache_ids=aligned.astype(np.int64),
        cache_z=torch.randn((len(aligned), g1p), generator=gen).numpy())
    return sc, b


def test_warmed_vfl_dispatch_makes_one_copy(bundle, budgets):
    sc, b = bundle
    per = budgets["serve_bucket_warm"]["host_syncs_per_dispatch"]
    eng = vfl.VFLServingEngine(b, device="cpu")
    # the bundle as the engine holds it (its cache ids stay on the host as
    # int64 row ids, as the reference's)
    guards.audit_dtypes({"active": eng._p_active, "collab": eng._p_collab,
                         "cache_z": eng.cache.z,
                         "scaler": (eng._mean, eng._inv_scale)},
                        budgets["engine_dtypes"], label="bundle")
    x, ids = sc.active.x[:40], sc.active.ids[:40]
    eng.predict_active(x)
    eng.predict(x, ids)                                 # warm both paths
    for call in (lambda: eng.predict_active(x), lambda: eng.predict(x, ids)):
        before = sum(eng.stats.dispatches.values())
        with guards.compile_counter(
                budgets["serve_bucket_warm"]["warm_compiles"]), \
                guards.no_host_sync(2 * per, device="cpu") as tally:
            call()
        n = sum(eng.stats.dispatches.values()) - before
        assert n >= 1 and tally.copies == per * n


@pytest.mark.parametrize("lanes", [False, True])
def test_fit_makes_one_copy_per_epoch(bundle, budgets, lanes):
    """The port's fit syncs once an epoch run (its early stopping decides
    on the host), not once a fit as the reference's ``train_fit`` budget;
    the epoch permutations are host draws and do not count."""
    sc, _ = bundle
    x = sc.active.x.astype(np.float32)
    gen = torch.Generator().manual_seed(1)
    p = ae.init_autoencoder(gen, [x.shape[1], 16, 8], device="cpu")
    with guards.no_host_sync(10, device="cpu", label="fit") as tally:
        if lanes:
            res = training.train_lanes(
                [training.LaneSpec(p, {"x": x}, seed=s) for s in (0, 1)],
                ae.masked_recon_loss, batch_size=64, max_epochs=4)
            epochs = max(r.epochs_run for r in res)
            params = res[0].params
        else:
            res = training.train(p, {"x": x}, ae.recon_loss, batch_size=64,
                                 max_epochs=4)
            epochs, params = res.epochs_run, res.params
    assert epochs == 4 and tally.copies == epochs
    assert budgets["train_fit"]["host_syncs"] == 1     # the reference's
    guards.audit_dtypes(params, budgets["engine_dtypes"], label="fitted")

    def leaky(params, batch):
        loss = ae.recon_loss(params, batch)
        float(loss)                                    # a planted sync
        return loss
    with pytest.raises(guards.HostSyncError, match="__float__"):
        with guards.no_host_sync(10, device="cpu"):
            training.train(p, {"x": x}, leaky, batch_size=64, max_epochs=1)


@pytest.mark.parametrize("arch", ["xlstm-350m", "internlm2-1.8b"])
def test_decode_step_makes_one_copy(arch):
    cfg = get_smoke(arch)
    params = init_params(M.schema(cfg), torch.Generator().manual_seed(0),
                         torch.float32, device="cpu")
    if arch == "internlm2-1.8b":                     # through the engine
        eng = Engine(params, cfg, batch=2, n_slots=32, prefill_len=8,
                     device="cpu")
        for r in tserve.make_requests(2, cfg.vocab_size, lo=4, hi=8,
                                      max_new=8):
            eng.submit(r)
        eng.step()
        eng.step()
        with guards.no_host_sync(1, device="cpu") as tally:
            eng.step()
        assert tally.copies == 1
        return
    step = make_decode_step(cfg)
    cache = M.init_cache(params, cfg, 2, 0)
    tok = torch.tensor([1, 2], dtype=torch.int32)
    with torch.no_grad():
        tok, cache = step(params, tok, cache, 0)
        for pos in (1, 2):
            with guards.no_host_sync(1, device="cpu") as tally:
                tok, cache = step(params, tok, cache, pos)
                out = guards.to_host(tok)
            assert tally.copies == 1 and out.shape == (2,)
