"""Hardened one-shot exchange: composable ``ExchangeTransform``s applied
at APC-VFL's single latent exchange (``comm.exchange_array``); the port of
``repro.robustness.defense``.

APC-VFL's privacy surface is exactly one message: the passive party's
aligned-row latents.  Every defense composes at that one point: the
transform runs at the SENDER, the channel accounts the transformed wire
bytes (per dtype: an int8 payload is 1 B an element, a sign payload 1
bit), and the active party only ever consumes what the transform returns
(the receiver's reconstruction, fp32, on the latents' device).

* ``ClippedNoise``: per-row norm clipping (L2 for the Gaussian mechanism,
  L1 for Laplace), then additive noise of scale ``sigma * clip``
  (``clip=None``: no clipping, sensitivity 1).
* ``Quantize``: per-feature symmetric quantization, ``"int8"`` (scale =
  absmax / 127) or ``"sign"`` (1-bit sign times the per-feature mean
  magnitude).
* ``Chain``: stages in order at the sender; only the LAST stage's wire
  form is sent.

``make_transform`` returns ``None`` when every defense is off, so
``run_apcvfl_dp(sigma=0)`` takes the exact ``exchange=None`` path of
``run_apcvfl`` and is bit for bit the same run.

Noise.  A transform's key is the tuple ``(seed, EXCHANGE_SALT, link)``
(a ``Chain`` appends its stage index), the reference's ``fold_in`` chain
written as integers: a function of the run's seed and the passive link,
never of lane position, so a replicated lane receives its sequential
run's latents.  Noise is drawn on the host from a CPU ``torch.Generator``
seeded from the key and then moved to the latents' device, so the card
and the CPU receive the same noise; Laplace noise comes by inverse CDF
from that generator's uniforms (``torch.distributions`` takes no
generator).  ``jax.random`` streams cannot be reproduced, so parity with
the reference passes ``draw=``: a function ``draw(key, shape)`` that
returns the unit noise for a key, as ``init_params`` passes inits.
"""
from __future__ import annotations

from math import ceil
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.apcvfl_paper import TABULAR as HP
from repro_torch.core import comm, multiparty, pipeline
from repro_torch.experiments.results import RunResult

# domain separator for exchange randomness: keyed off the run seed so the
# sequential and replicated paths derive identical noise for a given seed
EXCHANGE_SALT = 0xD0_5E

MECHANISMS = ("gaussian", "laplace")
QUANT_MODES = ("int8", "sign")


def generator(key: Tuple[int, ...]) -> torch.Generator:
    """A CPU generator seeded from an integer key tuple."""
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


def normal_noise(key: Tuple[int, ...], shape) -> torch.Tensor:
    """Unit Gaussian noise for ``key``, drawn on the host."""
    return torch.randn(tuple(shape), generator=generator(key))


def laplace_noise(key: Tuple[int, ...], shape) -> torch.Tensor:
    """Unit Laplace noise for ``key`` by inverse CDF of the generator's
    uniforms (drawn in float64, rounded once)."""
    u = torch.rand(tuple(shape), generator=generator(key),
                   dtype=torch.float64) - 0.5
    tail = torch.clamp(1.0 - 2.0 * u.abs(),
                       min=torch.finfo(torch.float64).tiny)
    return (-torch.sign(u) * torch.log(tail)).to(torch.float32)


def as_f32(z) -> torch.Tensor:
    """An fp32 tensor of ``z`` (a tensor stays on its device; an array is
    copied to the host)."""
    if isinstance(z, torch.Tensor):
        return z.to(torch.float32)
    return torch.from_numpy(np.array(z, np.float32))


class ExchangeTransform:
    """Base: subclasses implement ``apply(z, key) -> (received, wire)``
    where ``received`` is the fp32 tensor the active party reconstructs
    and ``wire`` lists the actually-transmitted parts as ``(name_suffix,
    nbytes, dtype)``, read from shapes only.  ``exchange`` (the
    ``comm.exchange_array`` hook) forms the key, accounts the wire parts
    and returns the received tensor."""

    def apply(self, z: torch.Tensor, key) -> Tuple[torch.Tensor,
                                                  List[tuple]]:
        raise NotImplementedError

    def exchange(self, channel: comm.Channel, what: str, z, *,
                 seed: int = 0, link: int = 0,
                 direction: str = comm.UPLINK):
        received, wire = self.apply(as_f32(z),
                                    (int(seed), EXCHANGE_SALT, int(link)))
        for suffix, nbytes, dtype in wire:
            channel.send(what + suffix, nbytes, direction=direction,
                         dtype=dtype)
        return received.to(torch.float32)


class ClippedNoise(ExchangeTransform):
    """Row-norm clipping + additive DP noise on the exchanged latents.

    ``clip`` bounds each row's L2 (gaussian) or L1 (laplace) norm, the
    per-row sensitivity, and the noise scale is ``sigma * clip``
    (``clip=None``: no clipping, sensitivity 1.0).  The wire form stays
    fp32.  ``draw(key, shape)`` replaces the host draw of unit noise
    (module docstring)."""

    def __init__(self, sigma: float = 0.0, mechanism: str = "gaussian",
                 clip: Optional[float] = None,
                 draw: Optional[Callable] = None):
        if mechanism not in MECHANISMS:
            raise ValueError(f"mechanism must be one of {MECHANISMS}, "
                             f"got {mechanism!r}")
        if sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {sigma}")
        if clip is not None and clip <= 0:
            raise ValueError(f"clip must be positive, got {clip}")
        self.sigma = float(sigma)
        self.mechanism = mechanism
        self.clip = None if clip is None else float(clip)
        self.draw = draw or (normal_noise if mechanism == "gaussian"
                             else laplace_noise)

    def apply(self, z, key):
        if self.clip is not None:
            ord_ = 2 if self.mechanism == "gaussian" else 1
            norms = torch.linalg.vector_norm(z, ord=ord_, dim=1,
                                             keepdim=True)
            z = z * torch.clamp(self.clip / torch.clamp(norms, min=1e-12),
                                max=1.0)
        if self.sigma > 0.0:
            scale = self.sigma * (1.0 if self.clip is None else self.clip)
            noise = as_f32(self.draw(key, tuple(z.shape))).to(z.device)
            z = z + scale * noise
        return z, [("", int(z.numel()) * 4, "float32")]


class Quantize(ExchangeTransform):
    """Per-feature symmetric quantization of the exchanged latents.

    ``"int8"``: scale_j = absmax_j / 127, payload one int8 per element
    plus fp32 scales.  ``"sign"``: 1 bit per element (packed: ceil(n*m/8)
    wire bytes, dtype ``"sign1"``) times the per-feature mean magnitude.
    The receiver consumes the dequantized fp32 tensor."""

    def __init__(self, mode: str = "int8"):
        if mode not in QUANT_MODES:
            raise ValueError(f"quantize mode must be one of {QUANT_MODES}, "
                             f"got {mode!r}")
        self.mode = mode

    def apply(self, z, key):
        del key                                  # deterministic transform
        n, m = z.shape
        if self.mode == "int8":
            scale = torch.clamp(torch.amax(torch.abs(z), dim=0),
                                min=1e-12) / 127.0
            q = torch.clamp(torch.round(z / scale), -127.0, 127.0)
            deq = q * scale
            wire = [("/q8", n * m, "int8"), ("/scale", m * 4, "float32")]
        else:
            scale = torch.mean(torch.abs(z), dim=0)
            deq = torch.sign(z) * scale
            wire = [("/sign", ceil(n * m / 8), "sign1"),
                    ("/scale", m * 4, "float32")]
        return deq, wire


class Chain(ExchangeTransform):
    """Stages applied in order at the sender; the LAST stage's wire parts
    are what actually crosses the link (earlier stages are local).  Stage
    j's key is the chain's key with ``j`` appended."""

    def __init__(self, stages: Sequence[ExchangeTransform]):
        if len(stages) < 2:
            raise ValueError("Chain needs >= 2 stages; use the stage "
                             "directly otherwise")
        self.stages = tuple(stages)

    def apply(self, z, key):
        wire = [("", int(z.numel()) * 4, "float32")]
        for j, stage in enumerate(self.stages):
            z, wire = stage.apply(z, tuple(key) + (j,))
        return z, wire


def make_transform(*, sigma: float = 0.0, mechanism: str = "gaussian",
                   clip: Optional[float] = None,
                   quantize: Optional[str] = None,
                   draw: Optional[Callable] = None
                   ) -> Optional[ExchangeTransform]:
    """Build the defense chain from plain knobs; ``None`` when every
    defense is off: the identity path, so a sigma-0 run stays bit for
    bit the undefended protocol.  ``draw`` goes to ``ClippedNoise``."""
    stages: List[ExchangeTransform] = []
    if sigma > 0.0 or clip is not None:
        stages.append(ClippedNoise(sigma, mechanism, clip, draw=draw))
    elif mechanism not in MECHANISMS:      # validate even when unused
        raise ValueError(f"mechanism must be one of {MECHANISMS}, "
                         f"got {mechanism!r}")
    if quantize is not None:
        stages.append(Quantize(quantize))
    if not stages:
        return None
    return stages[0] if len(stages) == 1 else Chain(stages)


# ---------------------------------------------------------------------------
# the defended protocol as a registered method
# ---------------------------------------------------------------------------

def _tag_dp(res: RunResult, *, sigma: float) -> RunResult:
    res.method = "apcvfl_dp"
    res.metrics = dict(res.metrics)
    res.metrics["dp_sigma"] = float(sigma)
    res.metrics["exchange_bytes"] = float(
        res.comm.get("by_stage", {}).get("step1", 0))
    return res


def run_apcvfl_dp(sc, *, sigma: float = 0.0, mechanism: str = "gaussian",
                  clip: Optional[float] = None,
                  quantize: Optional[str] = None, lam: float = HP.lam,
                  kind: str = HP.kind, seed: int = 0,
                  batch_size: int = HP.batch_size,
                  max_epochs: int = HP.max_epochs,
                  patience: int = HP.patience, lr: float = HP.lr,
                  use_kernel: bool = False, ablation: bool = False,
                  init_params: Optional[dict] = None,
                  perm_fn: Optional[Callable] = None,
                  draw: Optional[Callable] = None,
                  device="cuda") -> RunResult:
    """The full protocol with a hardened exchange: the same training
    surface as ``apcvfl`` plus the defense knobs.  K-party scenarios go to
    ``run_apcvfl_k`` (every passive link the same transform,
    link-separated noise).  With every defense off this IS ``run_apcvfl``
    bit for bit.  ``init_params``, ``perm_fn`` and ``draw`` are the
    parity hooks (module docstring)."""
    t = make_transform(sigma=sigma, mechanism=mechanism, clip=clip,
                       quantize=quantize, draw=draw)
    kw = dict(lam=lam, kind=kind, batch_size=batch_size,
              max_epochs=max_epochs, patience=patience, lr=lr,
              use_kernel=use_kernel, ablation=ablation, exchange=t,
              init_params=init_params, perm_fn=perm_fn, device=device)
    if hasattr(sc, "passives"):                   # a K-party scenario
        res = multiparty.run_apcvfl_k(sc, seed=seed, **kw)
    else:
        res = pipeline.run_apcvfl(sc, seed=seed, **kw)
    return _tag_dp(res, sigma=sigma)


def run_apcvfl_dp_replicated(scenarios, *, seeds, sigma: float = 0.0,
                             mechanism: str = "gaussian",
                             clip: Optional[float] = None,
                             quantize: Optional[str] = None,
                             lam: float = HP.lam, kind: str = HP.kind,
                             batch_size: int = HP.batch_size,
                             max_epochs: int = HP.max_epochs,
                             patience: int = HP.patience, lr: float = HP.lr,
                             use_kernel: bool = False,
                             ablation: bool = False, mesh=None,
                             init_params: Optional[Sequence[dict]] = None,
                             perm_fn: Optional[Callable] = None,
                             device="cuda") -> List[RunResult]:
    """Seed replicas of one defended grid cell through the lane engine:
    the transform is shared across seeds (each seed's noise keyed by that
    seed), every protocol stage S lanes of one ``train_lanes`` call."""
    t = make_transform(sigma=sigma, mechanism=mechanism, clip=clip,
                       quantize=quantize)
    kw = dict(seeds=seeds, lam=lam, kind=kind, batch_size=batch_size,
              max_epochs=max_epochs, patience=patience, lr=lr,
              use_kernel=use_kernel, ablation=ablation, exchange=t,
              mesh=mesh, init_params=init_params, perm_fn=perm_fn,
              device=device)
    first = scenarios if hasattr(scenarios, "active") else (
        scenarios[0] if len(scenarios) else None)
    if hasattr(first, "passives"):                # K-party scenarios
        results = multiparty.run_apcvfl_k_replicated(scenarios, **kw)
    else:
        results = pipeline.run_apcvfl_replicated(scenarios, **kw)
    return [_tag_dp(r, sigma=sigma) for r in results]


def dp_frontier(sc, sigmas: Sequence[float], *,
                mechanism: str = "gaussian", clip: Optional[float] = None,
                quantize: Optional[str] = None, seed: int = 0,
                lam: float = HP.lam, kind: str = HP.kind,
                batch_size: int = HP.batch_size,
                max_epochs: int = HP.max_epochs,
                patience: int = HP.patience, lr: float = HP.lr,
                use_kernel: bool = False, mesh=None,
                init_params: Optional[dict] = None,
                perm_fn: Optional[Callable] = None,
                device="cuda") -> List[RunResult]:
    """The utility side of the utility-vs-leakage frontier: the WHOLE
    sigma grid as replica lanes of one protocol, one ``RunResult`` per
    sigma, the per-lane exchanges differing only in their transform.  All
    lanes share the run seed (and ``init_params``), so each lane is the
    sequential ``run_apcvfl_dp(sc, sigma=s, seed=seed)``."""
    transforms = [make_transform(sigma=float(s), mechanism=mechanism,
                                 clip=clip, quantize=quantize)
                  for s in sigmas]
    results = pipeline.run_apcvfl_replicated(
        sc, seeds=[seed] * len(transforms), lam=lam, kind=kind,
        batch_size=batch_size, max_epochs=max_epochs, patience=patience,
        lr=lr, use_kernel=use_kernel, exchange=transforms, mesh=mesh,
        init_params=None if init_params is None
        else [init_params] * len(transforms),
        perm_fn=perm_fn, device=device)
    return [_tag_dp(r, sigma=float(s)) for r, s in zip(results, sigmas)]
