"""The port's own spans (``repro_torch.spans``) on the CPU, at smoke sizes:
with no profiler running they enter no ``record_function`` and record
nothing; under ``torch.profiler`` an engine step and a ``prefill_step``
record the expected tree, every span shows among the profiler's events at
the start the profiler took for it, and the served tokens keep their bits;
the MoE's three parts nest under ``block.mlp``; the ring keeps its last
``CAPACITY`` spans and counts the rest."""
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_smoke
from repro_torch.models import model as M
from repro_torch.serve import decode as serve_decode
from repro_torch.serve import engine as serve_engine
from repro_torch.sharding.policy import init_params

PAIR = ["block.attention", "block.mlp"]


def _model(arch="internlm2-1.8b"):
    cfg = get_smoke(arch).with_(use_flash_kernel=True)
    params = init_params(M.schema(cfg), torch.Generator().manual_seed(5),
                         torch.float32, device="cpu")
    return cfg, params


def _engine(cfg, params, n=3):
    eng = serve_engine.Engine(params, cfg, batch=n, n_slots=40,
                              prefill_len=12, device="cpu")
    rng = np.random.RandomState(2)
    reqs = [serve_engine.Request(i, rng.randint(0, cfg.vocab_size, 10 + i)
                                 .astype(np.int32), max_new=12)
            for i in range(n)]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def _tokens(cfg, B=2, S=8):
    return torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32))


def _children(recs, i):
    return [r.name for r in recs if r.parent == i]


def _profiled(fn):
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return spans.records(), prof


def test_with_no_profiler_no_span_enters_record_function(monkeypatch):
    cfg, params = _model()
    eng, _ = _engine(cfg, params)

    def refuse(*a, **kw):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    spans.clear()
    assert eng.step() and eng.step()         # the prefills, then decode
    serve_decode.prefill_step(params, cfg, {"tokens": _tokens(cfg)})
    assert spans.records() == [] and spans.dropped() == 0
    assert len(eng.step_ms) == 2 and len(eng.prefill_ms) == 3
    assert all(ms > 0 for ms in eng.step_ms + eng.prefill_ms)


def test_profiled_engine_step_and_prefill_step_record_the_tree():
    cfg, params = _model()
    eng, _ = _engine(cfg, params)
    eng.step()                               # fills every slot
    L = cfg.n_layers
    recs, prof = _profiled(lambda: (
        eng.step(),
        serve_decode.prefill_step(params, cfg, {"tokens": _tokens(cfg)})))
    roots = [i for i, r in enumerate(recs) if r.parent == -1]
    assert [recs[i].name for i in roots] == ["engine.step",
                                             "serve.prefill_step"]
    step, prefill = roots
    assert _children(recs, step) == ["engine.dispatch"]
    dispatch = recs.index(next(r for r in recs
                               if r.name == "engine.dispatch"))
    assert _children(recs, dispatch) == PAIR * L
    assert _children(recs, prefill) == PAIR * L
    assert all(r.start_ns <= r.end_ns for r in recs)
    for i, r in enumerate(recs):
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, i
    # the engine's host time is the span's own reading
    d = recs[dispatch]
    assert eng.step_ms[-1] >= (d.end_ns - d.start_ns) / 1e6

    # each span among the profiler's events, started where the profiler
    # started it (the same clock)
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        by_name.setdefault(e.name(), []).append(e.start_ns())
    gaps = []
    for name in {r.name for r in recs}:
        mine = sorted(r.start_ns for r in recs if r.name == name)
        theirs = sorted(by_name.get(name, []))
        assert len(theirs) == len(mine), name
        gaps += [abs(a - b) for a, b in zip(mine, theirs)]
    assert statistics.median(gaps) <= 50_000, statistics.median(gaps)


def test_refilled_slot_records_fill_slot_beside_dispatch():
    cfg, params = _model()
    eng, _ = _engine(cfg, params, n=2)
    recs, _ = _profiled(eng.step)            # two prefills, then decode
    step = recs.index(next(r for r in recs if r.name == "engine.step"))
    assert _children(recs, step) == ["engine.fill_slot"] * 2 + [
        "engine.dispatch"]
    fills = [r for r in recs if r.name == "engine.fill_slot"]
    assert eng.prefill_ms == [(r.end_ns - r.start_ns) / 1e6 for r in fills]
    first = recs.index(fills[0])
    assert _children(recs, first) == PAIR * cfg.n_layers


def test_served_tokens_keep_their_bits_under_the_profiler():
    cfg, params = _model()
    plain, want = _engine(cfg, params)
    plain.run()
    traced, got = _engine(cfg, params)
    _profiled(traced.run)
    assert [r.generated for r in got] == [r.generated for r in want]
    want = serve_decode.prefill_step(params, cfg, {"tokens": _tokens(cfg)})
    got = []
    recs, _ = _profiled(lambda: got.append(serve_decode.prefill_step(
        params, cfg, {"tokens": _tokens(cfg)})))
    assert torch.equal(got[0], want) and recs


def test_moe_parts_nest_under_block_mlp():
    cfg, params = _model("qwen3-moe-30b-a3b")
    eng, _ = _engine(cfg, params)
    eng.step()
    recs, _ = _profiled(eng.step)
    mlps = [i for i, r in enumerate(recs) if r.name == "block.mlp"]
    assert len(mlps) == cfg.n_layers
    for i in mlps:
        assert _children(recs, i) == ["moe.route", "moe.dispatch_combine",
                                      "moe.experts", "moe.dispatch_combine"]
    assert not any(r.name.startswith("moe.") and recs[r.parent].name
                   != "block.mlp" for r in recs)


def test_the_ring_keeps_its_last_spans_and_counts_the_dropped():
    n = spans.CAPACITY + 10
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer"):
            for _ in range(n - 1):
                with spans.span("inner"):
                    pass
    recs = spans.records()
    assert len(recs) == spans.CAPACITY and spans.dropped() == 10
    assert all(r.name == "inner" and r.parent == -1 for r in recs)
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0
    with pytest.raises(ValueError):
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span("outer"):
                raise ValueError
    (r,) = spans.records()
    assert r.name == "outer" and r.end_ns >= r.start_ns
    spans.clear()
