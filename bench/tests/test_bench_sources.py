"""What the benchmark's sources may import, and how its files tie to the
program: no module under bench/ imports JAX, the JAX package or the old
benchmarks (top-level names compared whole), the reference imports
nothing of the program, the configuration files are the program's
registered configs, the weights have the program's layout, and the
reference computes the program's function (fp32, smoke sizes)."""
import ast
import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import env, spec  # noqa: E402
from bench.harness.weights import draw, layout  # noqa: E402
from bench.reference.model import logits_at, sizes  # noqa: E402

BENCH = os.path.join(ROOT, "bench")
CELLS = ["internlm2-1.8b.prefill-conv-8k"]


def _imports(path: str) -> set:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = ""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_under_bench_imports_jax_or_the_jax_package():
    bad = {}
    for path in _sources():
        hit = _imports(path) & {"jax", "jaxlib", "flax", "repro",
                                "benchmarks"}
        if hit:
            bad[os.path.relpath(path, ROOT)] = sorted(hit)
    assert bad == {}
    assert env.forbidden_loaded(["repro_torch.models", "jaxlib.x"]) \
        == ["jaxlib.x"]


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "repro_torch" not in _imports(path), path


@pytest.mark.parametrize("workload", CELLS)
def test_config_files_are_the_programs_configs(workload):
    from repro_torch.configs import get_config
    cell = spec.load_cell(workload)
    got = spec.model_config(cell)
    want = get_config(cell.config["name"])
    diff = {f.name for f in dataclasses.fields(got)
            if getattr(got, f.name) != getattr(want, f.name)}
    assert diff == set()
    assert cell.config["reduced"] == [] and cell.config["assumed"] == []


@pytest.mark.parametrize("workload", CELLS)
def test_weights_have_the_programs_layout(workload):
    from repro_torch.models import model as M
    from repro_torch.sharding.policy import DTYPES
    cfg = spec.model_config(spec.load_cell(workload, smoke=True))
    theirs, ours = M.schema(cfg), layout(cfg)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}.{k}")
            else:
                assert tuple(a[k].shape) == tuple(b[k][1]), f"{path}.{k}"
    walk(theirs, ours)
    w = draw(cfg, 2**31 + 3, "cpu")

    def dtypes(a, b):
        for k in a:
            if isinstance(a[k], dict):
                dtypes(a[k], b[k])
            else:
                want = DTYPES[a[k].dtype] if a[k].dtype else DTYPES[cfg.dtype]
                assert b[k].dtype == want, k
                assert bool(b[k].abs().amax() > 0), k
    dtypes(theirs, w)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_computes_the_programs_function(workload):
    from repro_torch.models import model as M
    cell = spec.load_cell(workload, smoke=True)
    cfg = spec.model_config(cell)
    w = draw(cfg, 2**31 + 11, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 96), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        lg, _ = M.logits(w, cfg, {"tokens": toks})
    for b in range(2):
        ref = logits_at(w, sizes(cell.model_fields), toks[b],
                        list(range(96)))
        assert float((ref - lg[b]).abs().max()) \
            <= 1e-5 * float(ref.abs().max())
