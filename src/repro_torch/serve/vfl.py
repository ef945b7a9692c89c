"""Online VFL inference for the APC-VFL protocol: the port of
``repro.serve.vfl``.

After the ONE communication step the active participant predicts
**alone**: the distilled student g3 maps its local features straight into
the joint-representation space.  This module serves such a model:

* ``ModelBundle`` — what the active party holds after training (its
  encoders g1_active, g2, g3, the serving heads, the feature scaler, and
  the passive latents it received for the PSI-aligned rows).  Leaves are
  host numpy arrays; ``save``/``load`` use the reference's checkpoint
  format, so a bundle saved by either package loads in the other.
  ``export_bundle`` captures one from a finished ``run_apcvfl``.

* ``VFLServingEngine`` — two predict paths on one device:

  - **active-only**: ``logits = head(g3_enc(x))``, for any user the
    active party can feature-ize, with zero communication;
  - **collaborative**: rows whose id is PSI-aligned gather their passive
    latent from the device-resident ``RepresentationCache`` and predict
    from the joint teacher ``head_joint(g2_enc([g1a_enc(x), z_p]))``.

  Every encoder runs through the lane-MLP kernel (``ae.fused_encode``).
  With ``quantize="int8"`` on CUDA the active path is
  ``quant.int8_active_apply`` (three int8 matmul launches); on the CPU it
  keeps the reference's pre-dequantized plain path.

* A padded power-of-two **batch bucketer** maps every micro-batch onto
  one of ``DEFAULT_BUCKETS`` shapes (padding rows are inert through
  row-wise MLPs and sliced off), as the reference does for its jit cache;
  the port keeps the same dispatch shapes so the two engines' statistics
  agree row for row.

* ``serve_stream`` drives a request list through the engine, coalescing
  requests into micro-batches up to the largest bucket, and reports
  throughput, service-time latency percentiles and cache hit-rate.

* The cache is versioned (``refresh_cache`` / ``invalidate_cache``): a
  stale cache misses every lookup, so its rows degrade to the active-only
  path.  The live server that arrivals, SLOs, admission and fault plans
  drive over many tenants is ``serve.runtime``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.analysis.guards import to_host
from repro_torch.checkpoint import ckpt
from repro_torch.core import autoencoder as ae
from repro_torch.core import classifier as clf
from repro_torch.core.psi import id_positions
from repro_torch.serve import quant
from repro_torch.serve.metrics import ServeStats

DEFAULT_BUCKETS = (16, 32, 64, 128, 256)

# filler for rows without an identity: real row ids are the non-negative
# dataset ids PSI aligned on, so this can never hit the cache
ANON_ID = -1


# ---------------------------------------------------------------------------
# the exported model
# ---------------------------------------------------------------------------

@dataclass
class ModelBundle:
    """Everything the active party needs to serve a trained APC-VFL model.

    ``g3`` + ``head_active`` are the minimum (the paper's independent-
    inference mode).  ``g1_active``/``g2``/``head_joint`` plus the cache
    arrays enable the collaborative path for PSI-aligned users.
    ``x_mean`` / ``x_scale`` standardize incoming request features."""
    meta: Dict
    g3: dict
    head_active: dict
    x_mean: np.ndarray
    x_scale: np.ndarray
    g1_active: Optional[dict] = None
    g2: Optional[dict] = None
    head_joint: Optional[dict] = None
    cache_ids: Optional[np.ndarray] = None       # (n_al,) int64 row ids
    cache_z: Optional[np.ndarray] = None         # (n_al, z_p) fp32 latents

    @property
    def supports_collaborative(self) -> bool:
        return all(v is not None for v in (self.g1_active, self.g2,
                                           self.head_joint, self.cache_ids,
                                           self.cache_z))

    def tree(self) -> dict:
        """The flat-dict tree persisted by ``save``."""
        t = {"g3": self.g3, "head_active": self.head_active,
             "scaler": {"mean": np.asarray(self.x_mean),
                        "scale": np.asarray(self.x_scale)}}
        if self.supports_collaborative:
            t["g1_active"] = self.g1_active
            t["g2"] = self.g2
            t["head_joint"] = self.head_joint
            t["cache"] = {"ids": np.asarray(self.cache_ids),
                          "z": np.asarray(self.cache_z)}
        return t

    def save(self, path: str) -> None:
        ckpt.save(path, self.tree(), meta=dict(self.meta))

    @classmethod
    def load(cls, path: str) -> "ModelBundle":
        tree, side = ckpt.load_tree(path)
        return cls(
            meta=side.get("meta", {}),
            g3=tree["g3"],
            head_active=tree["head_active"],
            x_mean=tree["scaler"]["mean"],
            x_scale=tree["scaler"]["scale"],
            g1_active=tree.get("g1_active"),
            g2=tree.get("g2"),
            head_joint=tree.get("head_joint"),
            cache_ids=(tree["cache"]["ids"].astype(np.int64)
                       if "cache" in tree else None),
            cache_z=tree["cache"]["z"] if "cache" in tree else None,
        )


def export_bundle(result, sc, *, x_mean=None, x_scale=None,
                  head_steps: int = 300) -> ModelBundle:
    """Capture a finished ``run_apcvfl`` (its ``RunResult`` plus the
    scenario that trained it) as a ``ModelBundle``, on the device the run
    trained on.

    The serving head is fit ONCE on the full enhanced dataset
    ``g3_enc(X_active)`` with the active party's labels (the k-fold CV of
    training is an evaluation protocol, not a deployable classifier); when
    the run carries the collaborative artifacts, a joint head is fit the
    same way on the teacher representations of the aligned rows."""
    if result.params is None or "g3" not in result.params:
        raise ValueError("export_bundle needs a RunResult with trained g3 "
                         "params (run_apcvfl)")
    g3 = result.params["g3"]
    dev = g3["enc"]["w0"].device
    xa = np.asarray(sc.active.x, np.float32)
    y = np.asarray(sc.active.y)
    n_classes = int(sc.n_classes)
    with torch.no_grad():
        z_all = ae.fused_encode(g3, torch.as_tensor(xa, device=dev))
        head_active = clf.fit_logreg(z_all, y, n_classes, steps=head_steps)
        g1a = result.params.get("g1_active")
        g2 = result.params.get("g2")
        head_joint = cache_ids = cache_z = None
        if g1a is not None and g2 is not None and result.artifacts:
            cache_ids = np.asarray(result.artifacts["aligned_ids"],
                                   dtype=np.int64)
            cache_z = convert.to_numpy(
                result.artifacts["z_passive_aligned"]).astype(np.float32)
            pos = id_positions(sc.active.ids)
            idx_a = np.asarray([pos[int(i)] for i in cache_ids], np.int64)
            za = ae.fused_encode(g1a, torch.as_tensor(xa[idx_a], device=dev))
            zj = torch.cat([za, torch.as_tensor(cache_z, device=dev)], dim=1)
            head_joint = clf.fit_logreg(ae.fused_encode(g2, zj), y[idx_a],
                                        n_classes, steps=head_steps)

    d = xa.shape[1]
    host = lambda t: None if t is None else convert.to_numpy(t)
    meta = {"method": result.method, "dataset": getattr(sc, "name", ""),
            "n_classes": n_classes, "z_dim": result.z_dim,
            "n_features_active": d, "seed": result.seed,
            "n_cached": 0 if cache_ids is None else int(len(cache_ids))}
    return ModelBundle(
        meta=meta, g3=host(g3), head_active=host(head_active),
        x_mean=(np.zeros(d, np.float32) if x_mean is None
                else np.asarray(x_mean, np.float32)),
        x_scale=(np.ones(d, np.float32) if x_scale is None
                 else np.asarray(x_scale, np.float32)),
        g1_active=host(g1a), g2=host(g2), head_joint=host(head_joint),
        cache_ids=cache_ids, cache_z=cache_z)


# ---------------------------------------------------------------------------
# batch bucketing
# ---------------------------------------------------------------------------

class BatchBucketer:
    """Map arbitrary micro-batch row counts onto a small fixed set of
    padded shapes.  ``split(n)`` chunks an oversized batch into max-bucket
    pieces plus one tail bucket — every dispatch shape is a member of
    ``buckets``."""

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))

    @property
    def max(self) -> int:
        return self.buckets[-1]

    def fit(self, n: int) -> int:
        """Smallest bucket >= n (n must not exceed the largest bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} rows exceeds largest bucket "
                         f"{self.max}; use split()")

    def split(self, n: int) -> List[Tuple[int, int, int]]:
        """Chunk n rows into dispatches: [(start, rows, bucket), ...].
        ``n = 0`` gives no dispatches; a negative count raises."""
        if n < 0:
            raise ValueError(f"split: negative row count {n}")
        out, start = [], 0
        while n - start > self.max:
            out.append((start, self.max, self.max))
            start += self.max
        tail = n - start
        if tail:
            out.append((start, tail, self.fit(tail)))
        return out


# ---------------------------------------------------------------------------
# representation cache
# ---------------------------------------------------------------------------

class RepresentationCache:
    """Device-resident passive-latent cache keyed by row id: the Z_p rows
    the active party received for the PSI-aligned users.  The latents live
    on the device and are gathered there; only the id -> slot lookup is on
    the host.

    The cache is **versioned** for the lifecycle a long-lived server
    needs: a fresh training round re-exports latents -> ``refresh``
    installs the new arrays (one upload to the cache's device) and bumps
    ``version``; a passive party that drops out or is known to have
    drifted -> ``invalidate`` marks the cache stale WITHOUT discarding
    version history.  A stale cache never serves: every lookup misses
    (and is counted as a miss), so the engine degrades to the active-only
    path instead of silently predicting from old latents."""

    def __init__(self, ids: np.ndarray, z, *, version: int = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.version = int(version)
        self.stale = False
        self.hits = 0
        self.misses = 0
        self._install(ids, z)

    def _install(self, ids: np.ndarray, z) -> None:
        self._slot = id_positions(np.asarray(ids, np.int64))
        self.z = torch.as_tensor(np.asarray(z, np.float32),
                                 device=self.device)   # uploaded once

    def __len__(self) -> int:
        return len(self._slot)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def refresh(self, ids: np.ndarray, z) -> int:
        """Install a newly exported latent set (a fresh training round's
        ``cache_ids``/``cache_z``), clear staleness, bump + return the
        version.  Hit/miss counters survive: they describe the serving
        stream, not one latent generation."""
        self._install(ids, z)
        self.stale = False
        self.version += 1
        return self.version

    def invalidate(self) -> None:
        """Mark every cached latent stale (passive dropout / drift): all
        lookups miss until the next ``refresh``."""
        self.stale = True

    def lookup(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(hit_mask bool (n,), slot idx int32 (n,) — 0 where missed).
        Stale caches miss everything by construction."""
        ids = np.asarray(ids)
        if self.stale:
            self.misses += len(ids)
            return (np.zeros(len(ids), bool),
                    np.zeros(len(ids), np.int32))
        idx = np.fromiter((self._slot.get(int(i), -1) for i in ids),
                          np.int64, count=len(ids))
        hit = idx >= 0
        self.hits += int(hit.sum())
        self.misses += int((~hit).sum())
        return hit, np.where(hit, idx, 0).astype(np.int32)

    def gather(self, idx: np.ndarray) -> torch.Tensor:
        return self.z[torch.as_tensor(np.asarray(idx, np.int64),
                                      device=self.device)]


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

def _standardize(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (x - p["mean"]) * p["inv_scale"]


def _active_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Paper headline mode: the distilled student alone."""
    z = ae.fused_encode(p["g3"], _standardize(p, x))
    return clf.logreg_logits(p["head"], z)


def _collab_apply(p: dict, x: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """Joint-teacher mode for cached (PSI-aligned) users."""
    za = ae.fused_encode(p["g1a"], _standardize(p, x))
    zj = torch.cat([za, zp], dim=1)
    return clf.logreg_logits(p["head_joint"], ae.fused_encode(p["g2"], zj))


class VFLServingEngine:
    """Batched online inference over a ``ModelBundle`` (module docstring).

    ``predict(x, ids=None)`` routes rows between the two paths — ids found
    in the representation cache go collaborative, everything else goes
    active-only — pads each group to a bucket shape, and reassembles
    logits in request-row order.  ``compiled_shapes()`` reports every
    distinct (path, batch-rows) pair dispatched so far; PyTorch runs
    eagerly, so ``jit_cache_sizes()`` is empty.

    ``bucketer`` injects a SHARED bucketer (one across many tenants'
    engines, ``runtime.TenantRegistry``); by default each engine owns
    one.  The pure ``_active_apply`` / ``_collab_apply`` are what tenants
    share: the port runs them eagerly, so there is no executable cache to
    share and no ``jit_fns`` knob."""

    def __init__(self, bundle: ModelBundle, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 bucketer: Optional[BatchBucketer] = None,
                 quantize: Optional[str] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.bundle = bundle
        self.bucketer = bucketer if bucketer is not None \
            else BatchBucketer(buckets)
        self.stats = ServeStats()
        self._shapes: set = set()
        up = lambda t: convert.to_torch(t, device=self.device)
        scale = np.asarray(bundle.x_scale, np.float32)
        if not np.all(np.isfinite(scale)) or np.any(scale == 0.0):
            raise ValueError("bundle x_scale must be finite and nonzero "
                             "(a constant feature's std is 0 — clamp it "
                             "to 1 before export)")
        self._mean = up(np.asarray(bundle.x_mean, np.float32))
        self._inv_scale = 1.0 / up(scale)
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', "
                             f"got {quantize!r}")
        self.n_classes = int(np.shape(bundle.head_active["w"])[1])
        self.quantize = quantize
        self.quant_params = None
        self.quant_meta = None
        self._active_fn = _active_apply
        if quantize == "int8":
            self.quant_params = quant.quantize_active_path(
                bundle, device=self.device)
            self.quant_meta = self.quant_params["meta"]
            if self.device.type == "cuda":
                self._active_fn = quant.int8_active_apply
                self._p_active = self.quant_params
            else:
                self._p_active = quant.dequantized_active_params(
                    self.quant_params)
        else:
            self._p_active = {"g3": up(bundle.g3),
                              "head": up(bundle.head_active),
                              "mean": self._mean,
                              "inv_scale": self._inv_scale}
        self.cache: Optional[RepresentationCache] = None
        self._p_collab = None
        if bundle.supports_collaborative:
            self.cache = RepresentationCache(bundle.cache_ids,
                                             bundle.cache_z,
                                             device=self.device)
            self._p_collab = {"g1a": up(bundle.g1_active),
                              "g2": up(bundle.g2),
                              "head_joint": up(bundle.head_joint),
                              "mean": self._mean,
                              "inv_scale": self._inv_scale}

    # --- representation-cache lifecycle ------------------------------------

    def refresh_cache(self, ids: np.ndarray, z) -> int:
        """Install freshly re-exported passive latents (a new training
        round's ``bundle.cache_ids``/``cache_z``); returns the bumped
        cache version.  Only meaningful on a collaborative engine."""
        if self.cache is None:
            raise ValueError("refresh_cache: this bundle has no "
                             "collaborative path (no cache to refresh)")
        return self.cache.refresh(ids, z)

    def invalidate_cache(self) -> None:
        """Degrade to active-only for cached ids (passive dropout): the
        cache goes stale, every lookup misses until ``refresh_cache``."""
        if self.cache is not None:
            self.cache.invalidate()

    @property
    def cache_version(self) -> Optional[int]:
        return None if self.cache is None else self.cache.version

    # --- dispatch ----------------------------------------------------------

    def _dispatch(self, path: str, x: np.ndarray,
                  zp_idx: Optional[np.ndarray] = None) -> np.ndarray:
        """Bucket-pad one row group and run it through ``path``; returns
        unpadded logits.  Oversized groups are split into max-bucket
        chunks (every dispatched shape is a bucket member)."""
        n = len(x)
        if n == 0:
            return np.zeros((0, self.n_classes), np.float32)
        outs = []
        for start, rows, bucket in self.bucketer.split(n):
            xb = np.zeros((bucket, x.shape[1]), np.float32)
            xb[:rows] = x[start:start + rows]
            self._shapes.add((path, bucket))
            self.stats.dispatches[path] = \
                self.stats.dispatches.get(path, 0) + 1
            self.stats.padded_rows += bucket - rows
            xt = torch.from_numpy(xb).to(self.device)
            if path == "collab":
                ib = np.zeros((bucket,), np.int32)
                ib[:rows] = zp_idx[start:start + rows]
                logits = _collab_apply(self._p_collab, xt,
                                       self.cache.gather(ib))
            else:
                logits = self._active_fn(self._p_active, xt)
            # the ONE device->host sync per dispatch
            outs.append(to_host(logits)[:rows])
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def predict_active(self, x) -> np.ndarray:
        """Active-only logits for (n, D) features — no ids needed."""
        x = np.asarray(x, np.float32)
        self.stats.rows += len(x)
        return self._dispatch("active", x)

    def predict(self, x, ids=None) -> np.ndarray:
        """Route rows by id between the cache-backed collaborative path
        and the active-only path; logits come back in input-row order."""
        x = np.asarray(x, np.float32)
        if ids is None or self.cache is None:
            return self.predict_active(x)
        if len(ids) != len(x):
            raise ValueError(f"predict: {len(ids)} ids for {len(x)} rows")
        self.stats.rows += len(x)
        hit, slot = self.cache.lookup(ids)
        if not hit.any():
            return self._dispatch("active", x)
        logits = np.empty((len(x), self.n_classes), np.float32)
        hi = np.nonzero(hit)[0]
        logits[hi] = self._dispatch("collab", x[hi], slot[hi])
        mi = np.nonzero(~hit)[0]
        if len(mi):
            logits[mi] = self._dispatch("active", x[mi])
        return logits

    # --- warmup / introspection --------------------------------------------

    def warmup(self) -> None:
        """Dispatch every bucket shape once through each available path
        (on CUDA this builds and loads the kernels before the first real
        request).  Counters touched by the warmup are cleared via
        ``reset_stats``; the dispatched-shape record is kept."""
        d = int(self._mean.shape[0])
        for b in self.bucketer.buckets:
            xb = np.zeros((b, d), np.float32)
            self._dispatch("active", xb)
            if self._p_collab is not None:
                self._dispatch("collab", xb, np.zeros(b, np.int32))
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = ServeStats()
        if self.cache is not None:
            self.cache.hits = 0
            self.cache.misses = 0

    def compiled_shapes(self) -> dict:
        """Distinct dispatched (path, batch-rows) pairs and the number of
        distinct batch shapes across paths."""
        by_path: dict = {}
        for path, bucket in sorted(self._shapes):
            by_path.setdefault(path, []).append(bucket)
        return {"by_path": by_path,
                "distinct_batch_shapes":
                    len({b for _, b in self._shapes})}

    def jit_cache_sizes(self) -> dict:
        return {}


# ---------------------------------------------------------------------------
# simulated request stream
# ---------------------------------------------------------------------------

@dataclass
class ServeRequest:
    rid: int
    x: np.ndarray                        # (n, D) feature rows
    ids: Optional[np.ndarray] = None     # (n,) row ids (None = anonymous)
    logits: Optional[np.ndarray] = None
    latency_ms: float = 0.0              # service time of the batch
    queue_ms: float = 0.0                # wait before that batch dispatched


def make_request_stream(x_pool: np.ndarray, ids_pool: np.ndarray,
                        n_requests: int, *, seed: int = 0,
                        max_rows: int = 64, p_known: float = 0.5
                        ) -> List[ServeRequest]:
    """A mixed stream: request sizes uniform in [1, max_rows], rows drawn
    from the feature pool, and each request's ids kept real with
    probability ``p_known`` (cache candidates) or replaced by unseen ids
    (forced active-only).  The same numpy stream as the reference's."""
    rng = np.random.RandomState(seed)
    x_pool = np.asarray(x_pool, np.float32)
    ids_pool = np.asarray(ids_pool, np.int64)
    reqs = []
    for rid in range(n_requests):
        n = int(rng.randint(1, max_rows + 1))
        rows = rng.randint(0, len(x_pool), n)
        ids = ids_pool[rows].copy()
        unknown = rng.rand(n) >= p_known
        ids[unknown] = -1 - rng.randint(0, 1 << 30, int(unknown.sum()))
        reqs.append(ServeRequest(rid, x_pool[rows], ids))
    return reqs


def serve_stream(engine: VFLServingEngine,
                 requests: List[ServeRequest]) -> dict:
    """Drive a request list through the engine and return stream stats
    (the reference's schema, key for key).

    Consecutive requests are packed greedily into one micro-batch up to
    the largest bucket.  Per request, *service time* is the wall-clock of the
    micro-batch that completed it (each dispatch ends in a device->host
    copy, so it covers the device work) and *queueing time* how long it
    waited in the backlog before that batch dispatched."""
    t_start = time.perf_counter()
    max_rows = engine.bucketer.max
    i = 0
    while i < len(requests):
        group = [requests[i]]
        rows = len(requests[i].x)
        i += 1
        while i < len(requests) and rows + len(requests[i].x) <= max_rows:
            group.append(requests[i])
            rows += len(requests[i].x)
            i += 1
        t0 = time.perf_counter()
        wait_ms = (t0 - t_start) * 1e3
        x = np.concatenate([r.x for r in group])
        if any(r.ids is not None for r in group):
            # anonymous requests ride along under the never-matching
            # filler id, so an id-carrying neighbor keeps its cache
            # routing whatever it was coalesced with
            ids = np.concatenate([
                r.ids if r.ids is not None
                else np.full(len(r.x), ANON_ID, np.int64) for r in group])
        else:
            ids = None
        logits = engine.predict(x, ids)
        dt_ms = (time.perf_counter() - t0) * 1e3
        off = 0
        for r in group:
            r.logits = logits[off:off + len(r.x)]
            off += len(r.x)
            r.latency_ms = dt_ms
            r.queue_ms = wait_ms
            engine.stats.record(wait_ms, dt_ms)
        engine.stats.requests += len(group)
    wall_s = time.perf_counter() - t_start
    total_rows = int(sum(len(r.x) for r in requests))
    return {
        "requests": len(requests),
        "rows": total_rows,
        "wall_s": round(wall_s, 4),
        "rows_per_s": round(total_rows / max(wall_s, 1e-9), 1),
        "requests_per_s": round(len(requests) / max(wall_s, 1e-9), 1),
        "latency_ms_p50": round(engine.stats.percentile_ms(50), 3),
        "latency_ms_p99": round(engine.stats.percentile_ms(99), 3),
        "latency_ms": engine.stats.latency_summary(),
        "cache_hit_rate": (round(engine.cache.hit_rate, 4)
                           if engine.cache else None),
        "dispatches": dict(engine.stats.dispatches),
        "padded_rows": engine.stats.padded_rows,
        "compiled": engine.compiled_shapes(),
        "jit_cache_sizes": engine.jit_cache_sizes(),
    }
