"""The readers of the program's own spans (``bench/harness/spans.py`` and
the four metrics that use it): on made-up records and a made-up window,
with no spans, with a program that has none, and in a traced smoke run of
each cell on the CPU."""
import importlib.util
import io
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import run_cell, trace  # noqa: E402
from repro_torch import spans  # noqa: E402

DECODE = ("host_ms_per_step.decode", "attention_host_ms_per_step.decode",
          "mlp_host_ms_per_step.decode")
PREFILL = "host_ms_per_call.prefill"
MS = 1_000_000


def _read(name, view):
    path = os.path.join(ROOT, "bench", "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(f"spans_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read(view)


def _view(lo=100 * MS, hi=200 * MS):
    return trace.View(cfg=None, calls=[], ops=[], window_ns=(lo, hi))


def _records(monkeypatch, recs):
    recs = [spans.Record(*r) for r in recs]
    monkeypatch.setattr(spans, "records", lambda: recs)


def _step(t0, parent0, dispatch_ms=6, attn=(2, 2), mlp=(1, 1),
          refill=False):
    """One engine.step at ``t0`` ms whose first record is number
    ``parent0``: an optional refill (with a layer pair of its own), then a
    dispatch over one (attention, mlp) pair a layer."""
    s = t0 * MS
    out = [("engine.step", s, s + 20 * MS, -1)]
    step = parent0
    if refill:
        out += [("engine.fill_slot", s, s + 9 * MS, step),
                ("block.attention", s, s + 5 * MS, step + 1),
                ("block.mlp", s + 5 * MS, s + 8 * MS, step + 1)]
    d = parent0 + len(out)
    out.append(("engine.dispatch", s + 10 * MS,
                s + (10 + dispatch_ms) * MS, step))
    t = s + 10 * MS
    for a, m in zip(attn, mlp):
        out.append(("block.attention", t, t + a * MS, d))
        t += a * MS
        out.append(("block.mlp", t, t + m * MS, d))
        t += m * MS
    return out


def test_decode_readers_on_made_up_spans(monkeypatch):
    recs = []
    # one step before the window; one that starts before it and one that
    # ends after it, their middles inside, and two inside (one refills),
    # all counted; one whose middle lies after it
    for t0, refill in ((50, False), (95, False), (110, True), (140, False),
                       (185, False), (195, False)):
        recs += _step(t0, len(recs), refill=refill)
    _records(monkeypatch, recs)
    view = _view()
    assert _read(DECODE[0], view) == pytest.approx(6.0)
    assert _read(DECODE[1], view) == pytest.approx(4.0)
    assert _read(DECODE[2], view) == pytest.approx(2.0)
    assert _read(PREFILL, view) is None


def test_prefill_reader_on_made_up_spans(monkeypatch):
    _records(monkeypatch, [
        ("serve.prefill_step", 80 * MS, 95 * MS, -1),       # before
        ("serve.prefill_step", 96 * MS, 120 * MS, -1),      # starts before
        ("block.attention", 101 * MS, 110 * MS, 1),
        ("serve.prefill_step", 150 * MS, 200 * MS, -1),
        ("serve.prefill_step", 180 * MS, 216 * MS, -1),     # ends after
        ("serve.prefill_step", 201 * MS, 260 * MS, -1),     # after
        ("serve.prefill_step", 120 * MS, -1, -1)])          # still open
    view = _view()
    assert _read(PREFILL, view) == pytest.approx((24 + 50 + 36) / 3)
    assert all(_read(n, view) is None for n in DECODE)


def test_readers_return_none_without_spans(monkeypatch):
    _records(monkeypatch, [])
    assert all(_read(n, _view()) is None for n in DECODE + (PREFILL,))
    # an older program, without the module
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "spans")
    assert [_read(n, _view()) for n in DECODE + (PREFILL,)] == [None] * 4


@pytest.mark.parametrize("workload,names", [
    ("internlm2-1.8b.decode-32k", DECODE),
    ("internlm2-1.8b.prefill-conv-8k", (PREFILL,))])
def test_traced_smoke_run_reports_the_span_metrics(monkeypatch, workload,
                                                   names):
    # a short window: the smoke sessions retire after 90 tokens, and the
    # traced stretches need 40 steps of them
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.setattr(run_cell, "forbidden_loaded", lambda: [])
    run_cell.emit(*run_cell.run(workload, 2**31 + 31, 0.05, True,
                                device="cpu", smoke=True), out=out, err=err)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    got = {n: res["metrics"][n]["value"] for n in names}
    assert all(v > 0 for v in got.values()), got
    assert {res["metrics"][n]["unit"] for n in names} == {
        "ms/step" if len(names) > 1 else "ms/call"}
    if len(names) > 1:
        assert got[DECODE[0]] >= got[DECODE[1]] + got[DECODE[2]]


def test_the_readings_tool_at_smoke_size():
    """``tools/span_readings.py`` on the CPU: the readers' values, the
    clock checks and the gaps of a cell, both stretches traced with the
    host (there is no device-only profile without a card)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import span_readings
    res = span_readings.reading("internlm2-1.8b.decode-32k", 2**31 + 7,
                                0.05, 1, "cpu", True)
    assert set(DECODE) <= set(res["per_layer"])
    assert res["spans_per_call"] == 2 + 2 * 2       # two smoke layers
    clock = res["clock"]
    assert clock["device_only_outside"] == 0 == clock.get("unpaired_names",
                                                          0)
    assert clock["start_offset_us_median"] <= 50
    assert len(res["idle_gaps"]) >= 1
    assert res["span_cost_us"]["span.none"] > 0
