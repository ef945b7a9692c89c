"""Each cell of BENCHMARK.json end to end on the CPU at its configuration's
smoke sizes (the kernels' plain versions run): a well-formed last line,
``correct`` true, every end-to-end metric the cell lists, and with
``--trace 1`` its per-layer metrics in place of them."""
import io
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import run_cell, spec  # noqa: E402
from bench.harness.run_cell import emit, run  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 977


def _line(monkeypatch, workload, traced, seed=SEED):
    """A run's printed last line and standard error; the test process may
    hold JAX (other tests load it), which ``emit`` is told to pass over."""
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.setattr(run_cell, "forbidden_loaded", lambda: [])
    emit(*run(workload, seed, 0.3, traced, device="cpu", smoke=True),
         out=out, err=err)
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_end_to_end_at_smoke_size(monkeypatch, workload):
    res, err = _line(monkeypatch, workload, False)
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    cell = spec.load_cell(workload)
    want = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    last = err.strip().splitlines()[-2:]
    assert [ln.split()[1] for ln in last] == list(res["checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_per_layer_metrics_only(monkeypatch, workload):
    res, _ = _line(monkeypatch, workload, True)
    cell = spec.load_cell(workload)
    layer = {m["name"] for m in cell.per_layer}
    assert set(res["metrics"]) <= layer
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def test_a_run_with_jax_loaded_prints_nothing(monkeypatch):
    res = {"correct": True, "checks": {}}
    monkeypatch.setattr(run_cell, "forbidden_loaded", lambda: ["jax"])
    out, err = io.StringIO(), io.StringIO()
    with pytest.raises(RuntimeError, match="jax"):
        emit(res, {}, out=out, err=err)
    assert out.getvalue() == "" and err.getvalue() == ""


def test_every_metric_has_a_reader_and_every_cell_its_files():
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "bench", "metrics",
                                           f"{m['name']}.py"))
    for w in CELLS:
        cell = spec.load_cell(w)
        assert cell.traffic["mode"] in ("prefill", "decode")
        assert set(cell.limits) == {"gap_max", "missing"}
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer


@pytest.mark.parametrize("traffic", sorted({w["traffic"]
                                             for w in BENCH["workloads"]}))
def test_traffic_names_its_source_and_what_it_assumed(traffic):
    with open(os.path.join(ROOT, "bench", "traffic", f"{traffic}.json")) \
            as fh:
        mix = json.load(fh)
    assert mix["source"].strip()
    assert mix["assumed"] and all(v.strip() for v in mix["assumed"].values())
    assert "arrivals" in mix["assumed"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(spec.SetupError, match="unknown workload"):
        spec.load_cell("no-such-model.no-such-mix")


def test_run_refuses_without_a_card_and_prints_no_result():
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench",
                                                     "run.py"),
                        "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_refuses_in_a_checkout_without_the_program(tmp_path):
    import shutil
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no program" in r.stderr
