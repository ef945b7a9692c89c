"""The cell a run measures, read from ``BENCHMARK.json`` and the files its
names lead to: ``bench/configs/<config>.json``,
``bench/traffic/<traffic>.json`` and ``bench/limits/<workload>.json``."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from bench.harness.env import BENCH, ROOT, SetupError

# the keys of a configuration file that are the program's ModelConfig
# fields; the rest (source, reduced, assumed, deployment, departures,
# smoke) describe it
MODEL_KEYS = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size", "head_dim", "norm",
              "ffn_type", "causal", "rope_theta", "ssm_state", "ssm_expand",
              "ssm_head_dim", "ssm_groups", "conv_width", "ssm_chunk",
              "attn_period", "sliding_window", "dtype")


def _load(path: str) -> dict:
    if not os.path.exists(path):
        raise SetupError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    workload: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    limits: dict          # the correctness limits of this cell
    chips: int
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    model_fields: dict = field(default_factory=dict)


def _reports(metric: dict, workload: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(workload: str, smoke: bool = False) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``.  With ``smoke`` the
    configuration's and the traffic's ``smoke`` entries replace their
    sizes (the CPU tests' scale)."""
    spec = _load(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SetupError(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    config = _load(os.path.join(BENCH, "configs", f"{w['config']}.json"))
    traffic = _load(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    limits = _load(os.path.join(BENCH, "limits", f"{workload}.json"))
    fields = {k: config[k] for k in MODEL_KEYS if k in config}
    if smoke:
        fields.update(config.get("smoke", {}))
        traffic = dict(traffic, **traffic.get("smoke", {}))
    e2e = [m for m in spec["end_to_end"]
           if _reports(m, workload, {m["name"]})]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload=workload, config=config, traffic=traffic,
                limits=limits, chips=int(w["chips"]), end_to_end=e2e,
                per_layer=per_layer, model_fields=fields)


def model_config(cell: Cell):
    """The program's ``ModelConfig`` of the cell's configuration file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**cell.model_fields)
