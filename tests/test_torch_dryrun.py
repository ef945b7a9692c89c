"""The port's dry run (``repro_torch.launch.dryrun``) and its op counter
(``launch/op_analysis.py``, the counterpart of ``hlo_analysis.py``) on
fake worlds: one rank's counts on local meta shards, each family's smoke
config through every step it has, the parameter shards held to the
reference's specs, and no kernel entry reached.  The CLI runs once at
full size on 256 fake ranks, as ``tests/test_system.py:88`` runs the
reference's."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import model as JM
from repro.sharding import policy as jpolicy
from repro_torch.configs import base as tbase
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch import mesh as meshlib

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BYTES = {"float32": 4, "bfloat16": 2}
MODES = {"internlm2-1.8b": ("train", "prefill", "decode"),
         "qwen3-moe-30b-a3b": ("train", "prefill", "decode"),
         "hubert-xlarge": ("train", "prefill"),
         "zamba2-2.7b": ("train", "prefill", "decode"),
         "llama-3.2-vision-11b": ("train", "prefill", "decode"),
         "xlstm-350m": ("train", "prefill", "decode")}


class _JaxMesh:
    axis_names = ("data", "model")
    devices = np.empty((2, 2))


def _reference_param_bytes(arch) -> int:
    """One rank's parameter bytes on a (2, 2) mesh, reckoned from the
    reference's specs: each dim over the mesh sizes of its axes."""
    cfg = jget_smoke(arch)
    sizes = {"data": 2, "model": 2}
    total = 0
    for d in jax.tree.leaves(JM.schema(cfg), is_leaf=jpolicy.is_def):
        spec = jpolicy._divisible(d.shape, jpolicy.resolve(
            d.axes, ("data", "model")), _JaxMesh())
        n = 1
        for dim, ent in zip(d.shape, tuple(spec) + (None,) * len(d.shape)):
            names = () if ent is None else (
                ent if isinstance(ent, tuple) else (ent,))
            n *= dim // int(np.prod([sizes[a] for a in names]))
        total += n * BYTES[d.dtype or cfg.dtype]
    return total


def test_op_analysis_counts_a_product_on_the_local_shard():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with meshlib.fake_world(4):
        mesh = meshlib.make_local_mesh(2, 2)
        x = DTensor.from_local(torch.empty(4, 64, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=torch.Size((8, 64)), stride=(64, 1))
        w = DTensor.from_local(torch.empty(64, 16, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False,
                               shape=torch.Size((64, 32)), stride=(32, 1))
        y, oa = op_analysis.analyze(lambda a, b: a @ b, x, w)
        r = oa.result()
        # local (4, 64) @ (64, 16): 2 M N K, not the global 2 * 8 * 32 * 64
        assert r["flops"] == 2 * 4 * 16 * 64
        assert r["bytes"] == 4 * (4 * 64 + 64 * 16 + 4 * 16)
        assert r["collectives"] == {} and tuple(y.to_local().shape) == (4, 16)
        # a replicated result: the all-gather is counted by kind, with its
        # operand's bytes
        _, oa = op_analysis.analyze(lambda a, b: (a @ b).full_tensor(), x, w)
        assert oa.result()["collectives"]["all-gather"] > 0
        assert oa.breakdown(1)[0]["op"] == "aten.mm"


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel wrapper raises: a dry run must reach none."""
    def refuse(name):
        def f(*a, **kw):
            raise AssertionError(f"the dry run reached kops.{name}")
        return f
    for name in ("lane_mlp2", "fused_mlp2", "fused_lane_mlp2",
                 "fused_distill_rows", "fused_distill_loss",
                 "probe_grad_step", "int8_matmul", "flash_attention",
                 "decode_attention", "ssd_intra_chunk"):
        monkeypatch.setattr(kops, name, refuse(name))


@pytest.mark.parametrize("arch,mode", [(a, m) for a, ms in MODES.items()
                                       for m in ms])
def test_smoke_dry_run(no_kernels, monkeypatch, arch, mode):
    """Each family's smoke config through each step it has, on a fake
    (data 2, model 2) world: the parameter shards hold the bytes the
    reference's specs give, tp costs collectives, no kernel runs, and a
    train step checkpoints its blocks (``remat`` forced, as in the
    reference)."""
    import repro_torch.models.common as tcommon
    remats = []
    real = tcommon.checkpoint
    monkeypatch.setattr(tcommon, "checkpoint",
                        lambda *a, **kw: remats.append(1) or real(*a, **kw))
    name = f"smoke_{mode}"
    monkeypatch.setitem(tbase.INPUT_SHAPES, name,
                        tbase.ShapeConfig(name, 8, 4, mode))
    rec = dryrun.run_combo(arch, name, cfg=get_smoke(arch),
                           local_mesh=(2, 2))
    assert bool(remats) == (mode == "train")
    assert rec["mesh"] == "2x2" and rec["n_chips"] == 4
    assert rec["param_bytes_per_device"] == _reference_param_bytes(arch)
    assert rec["collectives"] and rec["collective_bytes_per_device"] > 0
    assert rec["hlo_flops_per_device"] > 0
    assert rec["hlo_bytes_per_device"] > rec["collective_bytes_per_device"]
    assert rec["mem_argument_bytes"] >= rec["param_bytes_per_device"]
    assert rec["mem_temp_bytes"] > 0
    for k in ("t_lower_s", "t_compile_s", "mem_generated_code_bytes",
              "xla_flops_per_device_raw"):
        assert rec[k] is None
    assert not torch.distributed.is_initialized()


def test_dry_run_refuses_decode_for_the_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        dryrun.run_combo("hubert-xlarge", "decode_32k",
                         cfg=get_smoke("hubert-xlarge"), local_mesh=(2, 2))


def test_cli_writes_the_full_size_decode_record(tmp_path):
    """internlm2-1.8b decode_32k on 256 fake ranks (a 16 x 16 mesh), at
    full size: ~10 s on the CPU, nothing allocated."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    path = tmp_path / "internlm2-1.8b_decode_32k_16x16.json"
    assert f"wrote {path}" in r.stdout
    rec = json.loads(path.read_text())
    assert rec["n_chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["params"] == 1889110016
    assert rec["hlo_flops_per_device"] > 0
    assert rec["collectives"]
