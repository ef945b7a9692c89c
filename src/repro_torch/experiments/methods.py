"""Built-in method adapters: the port's entry points behind the
registry's one signature ``(scenario, spec, *, seed, device) ->
RunResult``; the port of ``repro.experiments.methods``.

Each adapter forwards ``spec.params`` as keyword overrides to the
underlying ``run_*`` function, whose defaults are the paper's settings
(``configs.apcvfl_paper.TABULAR``), and ``device`` to where it runs;
the replicated adapters also take ``mesh``, the lane mesh ``sweep``
builds from a spec's ``devices``.  Importing this module registers every adapter (the registry does so
lazily on first lookup).
"""
from __future__ import annotations

from repro_torch.core import comm, multiparty, pipeline, privacy, splitnn, \
    vfedtrans
from repro_torch.experiments.registry import register_method, \
    register_replicas
from repro_torch.experiments.results import RunResult
from repro_torch.experiments.specs import MethodSpec
from repro_torch.robustness import attacks as rb_attacks
from repro_torch.robustness import defense as rb_defense


@register_method("local", supports_multiparty=True)
def _local(scenario, spec: MethodSpec, *, seed: int = 0,
           device="cuda") -> RunResult:
    """Raw-feature probe at the active party: no training
    hyperparameters, no communication; ``spec.params`` (e.g. sweep-wide
    overrides like ``max_epochs``) is intentionally ignored."""
    metrics = pipeline.run_local_baseline(scenario, seed=seed,
                                          device=device)
    return RunResult(method="local", metrics=metrics, rounds=0,
                     comm=comm.Channel().summary(), seed=seed)


@register_method("apcvfl", supports_multiparty=True,
                 params_from=pipeline.run_apcvfl)
def _apcvfl(scenario, spec: MethodSpec, *, seed: int = 0,
            device="cuda") -> RunResult:
    # run_apcvfl and run_apcvfl_k share one keyword surface, so
    # params_from covers both
    run = (multiparty.run_apcvfl_k if hasattr(scenario, "passives")
           else pipeline.run_apcvfl)
    return run(scenario, seed=seed, device=device, **spec.params)


@register_replicas("apcvfl")
def _apcvfl_replicated(scenarios, spec: MethodSpec, *, seeds, mesh=None,
                       device="cuda"):
    """Seed groups through the replica-lane runners: every protocol stage
    S stacked lanes (K-party cells S * K g1 lanes)."""
    run = (multiparty.run_apcvfl_k_replicated
           if hasattr(scenarios[0], "passives")
           else pipeline.run_apcvfl_replicated)
    return run(scenarios, seeds=seeds, mesh=mesh, device=device,
               **spec.params)


@register_method("serve_smoke", supports_multiparty=True,
                 params_from=pipeline.run_apcvfl)
def _serve_smoke(scenario, spec: MethodSpec, *, seed: int = 0,
                 device="cuda") -> RunResult:
    """Train-then-serve record: the full protocol, the ``ModelBundle``
    exported and round-tripped through the checkpoint layer, then a small
    mixed request stream through the bucketed serving engine
    (``repro_torch.serve.vfl``).  The metrics add the serving health
    numbers to the training accuracy: the active path against
    ``logreg_logits(head, encode(g3, x))`` on the same device (the plain
    layer loop, independent of the engine's kernels), cache hit-rate and
    throughput."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.core import autoencoder as ae
    from repro_torch.core import classifier as clf
    from repro_torch.serve import vfl as sv

    result = _apcvfl(scenario, spec, seed=seed, device=device)
    bundle = sv.export_bundle(result, scenario)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bundle")
        bundle.save(path)
        bundle = sv.ModelBundle.load(path)    # serve the reloaded copy
    engine = sv.VFLServingEngine(bundle, device=device)
    engine.warmup()
    requests = sv.make_request_stream(
        scenario.active.x, scenario.active.ids, 200, seed=seed + 1,
        max_rows=48, p_known=0.5)
    stats = sv.serve_stream(engine, requests)

    # active-path parity against the training-time evaluator
    probe_x = np.asarray(scenario.active.x[:64], np.float32)
    up = lambda t: convert.to_torch(t, device=engine.device)
    with torch.no_grad():
        want = clf.logreg_logits(
            up(bundle.head_active),
            ae.encode(up(bundle.g3), torch.as_tensor(
                probe_x, device=engine.device))).cpu().numpy()
    got = engine.predict_active(probe_x)
    parity = float(np.max(np.abs(got - want)))

    metrics = dict(result.metrics)
    metrics.update({
        "serve_parity_max_abs": parity,
        "serve_rows_per_s": float(stats["rows_per_s"]),
        "serve_latency_ms_p50": float(stats["latency_ms_p50"]),
        "serve_cache_hit_rate": float(stats["cache_hit_rate"] or 0.0),
        "serve_batch_shapes": float(
            stats["compiled"]["distinct_batch_shapes"]),
    })
    return RunResult(method="serve_smoke", metrics=metrics,
                     rounds=result.rounds, epochs=result.epochs,
                     comm=result.comm, seed=seed, z_dim=result.z_dim,
                     train_loss=result.train_loss, steps=result.steps,
                     seconds=result.seconds, params=result.params,
                     channels=result.channels, artifacts=result.artifacts)


@register_method("inversion", params_from=privacy.run_inversion)
def _inversion(scenario, spec: MethodSpec, *, seed: int = 0,
               device="cuda") -> RunResult:
    """Representation-inversion privacy probe (``core.privacy``); its
    metrics are leakage numbers (``r2_mean``, ``attack_mse``)."""
    return privacy.run_inversion(scenario, seed=seed, device=device,
                                 **spec.params)


@register_method("apcvfl_aligned_only",
                 params_from=pipeline.run_apcvfl_aligned_only)
def _apcvfl_aligned_only(scenario, spec: MethodSpec, *, seed: int = 0,
                         device="cuda") -> RunResult:
    return pipeline.run_apcvfl_aligned_only(scenario, seed=seed,
                                            device=device, **spec.params)


@register_replicas("apcvfl_aligned_only")
def _apcvfl_aligned_only_replicated(scenarios, spec: MethodSpec, *, seeds,
                                    mesh=None, device="cuda"):
    return pipeline.run_apcvfl_aligned_only_replicated(
        scenarios, seeds=seeds, mesh=mesh, device=device, **spec.params)


@register_method("apcvfl_dp", supports_multiparty=True,
                 params_from=rb_defense.run_apcvfl_dp)
def _apcvfl_dp(scenario, spec: MethodSpec, *, seed: int = 0,
               device="cuda") -> RunResult:
    """The full protocol with a hardened exchange
    (``repro_torch.robustness.defense``): spec params sweep the defense
    knobs (``sigma``, ``mechanism``, ``clip``, ``quantize``) beside the
    training hyperparameters.  With every defense off this is ``apcvfl``
    bit for bit."""
    return rb_defense.run_apcvfl_dp(scenario, seed=seed, device=device,
                                    **spec.params)


@register_replicas("apcvfl_dp")
def _apcvfl_dp_replicated(scenarios, spec: MethodSpec, *, seeds,
                          mesh=None, device="cuda"):
    return rb_defense.run_apcvfl_dp_replicated(scenarios, seeds=seeds,
                                               mesh=mesh, device=device,
                                               **spec.params)


@register_method("attack_inversion",
                 params_from=rb_attacks.run_attack_inversion)
def _attack_inversion(scenario, spec: MethodSpec, *, seed: int = 0,
                      device="cuda") -> RunResult:
    """Registry attacks (``repro_torch.robustness.attacks``): each runs
    the protocol's attack surface under a chosen defense (the same knobs
    as ``apcvfl_dp``) and emits the shared leakage schema."""
    return rb_attacks.run_attack_inversion(scenario, seed=seed,
                                           device=device, **spec.params)


@register_method("attack_label_leak",
                 params_from=rb_attacks.run_attack_label_leak)
def _attack_label_leak(scenario, spec: MethodSpec, *, seed: int = 0,
                       device="cuda") -> RunResult:
    return rb_attacks.run_attack_label_leak(scenario, seed=seed,
                                            device=device, **spec.params)


@register_method("attack_membership",
                 params_from=rb_attacks.run_attack_membership)
def _attack_membership(scenario, spec: MethodSpec, *, seed: int = 0,
                       device="cuda") -> RunResult:
    return rb_attacks.run_attack_membership(scenario, seed=seed,
                                            device=device, **spec.params)


@register_method("splitnn", params_from=splitnn.run_splitnn)
def _splitnn(scenario, spec: MethodSpec, *, seed: int = 0,
             device="cuda") -> RunResult:
    return splitnn.run_splitnn(scenario, seed=seed, device=device,
                               **spec.params)


@register_method("vfedtrans", params_from=vfedtrans.run_vfedtrans)
def _vfedtrans(scenario, spec: MethodSpec, *, seed: int = 0,
               device="cuda") -> RunResult:
    return vfedtrans.run_vfedtrans(scenario, seed=seed, device=device,
                                   **spec.params)
