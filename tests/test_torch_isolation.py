"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package, and the
port's entry points run on the card unless asked for the CPU."""
import inspect
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

_BLOCKED_IMPORTS = r'''
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                     "repro")]
assert not bad, bad
import torch.distributed
assert not torch.distributed.is_initialized()   # no import starts a world
print(" ".join(mods))
print("imported", len(mods))
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def test_port_and_chip_smoke_import_without_jax_or_repro():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS, ROOT],
                       capture_output=True, text=True, env=_env(),
                       timeout=300)
    assert r.returncode == 0, r.stderr
    n = int(r.stdout.split()[-1])
    assert n >= 30                       # every module of the package
    for mod in ("optim.adam", "core.padding", "core.comm", "core.training",
                "core.distill", "core.pipeline", "configs.apcvfl_paper",
                "experiments.results", "kernels.distill_loss",
                "kernels.probe", "kernels.flash_attention",
                "kernels.decode_attention", "configs.base",
                "configs.internlm2_1_8b", "configs.internlm2_20b",
                "configs.yi_6b", "configs.nemotron_4_15b",
                "sharding.policy", "models.common", "models.ffn",
                "models.attention", "models.transformer", "models.model",
                "serve.decode", "serve.engine", "launch.serve",
                "configs.zamba2_2_7b", "kernels.ssd_chunk", "models.mamba2",
                "models.hybrid", "core.splitnn", "core.fedsvd",
                "core.vfedtrans", "core.multiparty",
                "experiments.specs", "experiments.registry",
                "experiments.methods", "experiments.sweeps",
                "launch.experiment", "core.protocol", "core.privacy",
                "robustness.defense", "robustness.attacks",
                "robustness.faults", "serve.runtime", "optim.schedule",
                "data.tokens", "train.loop", "launch.train",
                "configs.qwen3_moe_30b_a3b", "configs.kimi_k2_1t_a32b",
                "configs.hubert_xlarge", "configs.llama_3_2_vision_11b",
                "configs.xlstm_350m", "models.xlstm", "analysis",
                "analysis.guards", "analysis.lint", "analysis.rules",
                "analysis.rules.r001_host_calls",
                "analysis.rules.r007_dtype_hygiene", "launch.lint",
                "launch.mesh", "launch.op_analysis", "launch.dryrun",
                "data.scale"):
        assert f"repro_torch.{mod}" in r.stdout.split(), mod


def test_engine_without_device_raises_on_host_without_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    import numpy as np
    from repro_torch.serve import vfl
    w = {"enc": {"w0": np.zeros((2, 3), np.float32),
                 "b0": np.zeros(3, np.float32),
                 "w1": np.zeros((3, 4), np.float32),
                 "b1": np.zeros(4, np.float32)}}
    bundle = vfl.ModelBundle(
        meta={}, g3=w, head_active={"w": np.zeros((4, 2), np.float32),
                                    "b": np.zeros(2, np.float32)},
        x_mean=np.zeros(2, np.float32), x_scale=np.ones(2, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        vfl.VFLServingEngine(bundle)
    assert vfl.VFLServingEngine(bundle, device="cpu").predict_active(
        np.ones((3, 2), np.float32)).shape == (3, 2)


def test_entry_points_default_to_cuda():
    from repro_torch import convert
    from repro_torch.core import (autoencoder, classifier, multiparty,
                                  pipeline, privacy, splitnn, vfedtrans)
    from repro_torch.data import scale
    from repro_torch.experiments import sweeps
    from repro_torch.robustness import attacks, defense, faults
    from repro_torch.serve import quant, runtime, vfl
    for fn in (vfl.VFLServingEngine.__init__, vfl.RepresentationCache,
               runtime.TenantRegistry,
               autoencoder.init_mlp, autoencoder.init_autoencoder,
               quant.quantize_active_path, quant.parity_report,
               convert.to_torch, pipeline.run_apcvfl,
               pipeline.run_apcvfl_aligned_only, pipeline.run_local_baseline,
               pipeline.run_apcvfl_replicated,
               pipeline.run_apcvfl_aligned_only_replicated,
               classifier.init_logreg, classifier.kfold_cv,
               classifier.kfold_cv_many, splitnn.init_splitnn,
               splitnn.run_splitnn, vfedtrans.run_vfedtrans,
               multiparty.run_apcvfl_k, multiparty.run_apcvfl_k_replicated,
               pipeline.train_encoder_with_probe, privacy.run_inversion,
               sweeps.sweep, defense.run_apcvfl_dp, attacks.build_surfaces,
               faults.run_faulted_apcvfl, scale.make_scale_party,
               scale.make_scale_lanes):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    from repro_torch.launch import experiment, serve, serve_vfl, train
    from repro_torch.serve import engine
    from repro_torch.sharding import policy
    for fn in (engine.Engine.__init__, policy.init_params,
               serve.build_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for cli in (serve_vfl.main, serve.main, experiment.main, train.main):
        assert "default=\"cuda\"" in inspect.getsource(cli)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, where):
    if where == "checkout" and torch.cuda.is_available():
        pytest.skip("this host has a card: chip_smoke would run")
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, cwd=os.path.dirname(str(script)),
                       env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
