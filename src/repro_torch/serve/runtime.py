"""Live multi-tenant VFL serving runtime: the port of
``repro.serve.runtime``.  Arrival simulation, SLO-aware continuous
micro-batching, admission control and the representation-cache
lifecycle, layered on the bucketed ``VFLServingEngine`` of ``serve.vfl``.

``serve_stream`` drains a static request list: every request is already
there, so it can only measure service time and throughput.  A live server
faces a different problem: requests ARRIVE, queue behind each other and
wait for a micro-batch to fill, and its two latency components are
measured separately (``serve.metrics``).  This module adds that half:

* **Arrival simulation**: seeded, deterministic request streams with
  virtual arrival timestamps: ``poisson_arrivals`` (memoryless steady
  traffic) and ``bursty_arrivals`` (on/off modulated Poisson: flash crowds
  alternating with lulls).  Both draw from ``np.random.RandomState``, so
  the timestamps are the reference's bits.  ``make_timed_stream`` wraps
  the request generator with a clock; ``merge_streams`` interleaves
  tenants into one global arrival order (a stable sort).

* **Continuous micro-batching with admission control**:
  ``ServingRuntime.run`` is a discrete-event loop over a virtual clock.
  Arrivals enqueue per tenant (a request that would push its tenant's
  queue past ``max_queue_rows`` is SHED at admission, never dropped
  mid-flight); a tenant dispatches when its queued rows fill the largest
  bucket OR its head-of-line request has waited the queueing budget
  (``max_wait_ms``, default half the SLO: service gets the other half);
  the clock advances by each dispatch's service time (single-executor
  model: arrivals during a dispatch queue up behind it).  The service time
  is the host clock around ``engine.predict``, which ends in the one
  device->host copy of the logits, so on the card it covers the device
  work (the copy synchronises).  Queueing latency (dispatch start -
  arrival) and service latency are recorded per request as separate
  series; SLO attainment is judged on their sum.  For deterministic
  scheduler runs a ``service_model`` drives the clock instead: dispatches
  still execute for real, only their timing is modelled, so a run on the
  card and one on the CPU give the same dispatch log.

* **Multi-tenant registry**: ``TenantRegistry`` puts many ``ModelBundle``s
  behind ONE ``BatchBucketer`` on one device.  The engines' predict bodies
  are the pure ``vfl._active_apply`` / ``vfl._collab_apply``, run eagerly
  (on the card: the lane-MLP forward kernel for fp32 tenants, the int8
  kernel for int8 tenants), so there is no executable cache:
  ``jit_cache_sizes()`` is ``{}``.  Per-tenant ``ServeStats`` keep the
  accounting apart, and ``verify_dispatch_parity`` replays every
  dispatched micro-batch through a fresh SOLO engine per tenant (same
  quantize mode, same device) and compares the logits bit for bit.

* **Representation-cache lifecycle**: the versioned
  ``vfl.RepresentationCache``.  Fault plans (``robustness.faults``) fire
  at dispatch boundaries: ``dropout``/``stale``/``drift`` invalidate a
  tenant's cache (its rows degrade to the active-only path, never stale
  latents), ``recover`` re-installs the bundle's latents with a version
  bump.

The CLI entry point is ``repro_torch.launch.serve_vfl --arrival
poisson|bursty [--fault PLAN.json]``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.serve import vfl as sv
from repro_torch.serve.metrics import series_summary, slo_report


# ---------------------------------------------------------------------------
# arrival processes (virtual clocks, milliseconds, fully seeded)
# ---------------------------------------------------------------------------

def poisson_arrivals(n: int, rate_rps: float, *, seed: int = 0,
                     t0_ms: float = 0.0) -> np.ndarray:
    """n arrival timestamps (ms) of a homogeneous Poisson process at
    ``rate_rps`` requests/second: iid exponential inter-arrival gaps."""
    if n < 0:
        raise ValueError(f"poisson_arrivals: negative n {n}")
    if rate_rps <= 0:
        raise ValueError(f"poisson_arrivals: rate must be positive, "
                         f"got {rate_rps}")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1000.0 / rate_rps, size=n)
    return t0_ms + np.cumsum(gaps)


def bursty_arrivals(n: int, *, rate_on_rps: float, rate_off_rps: float,
                    on_ms: float, off_ms: float, seed: int = 0,
                    t0_ms: float = 0.0) -> np.ndarray:
    """n arrival timestamps (ms) of an on/off modulated Poisson process:
    alternating ON windows (``on_ms`` long, rate ``rate_on_rps``) and OFF
    windows (``off_ms``, ``rate_off_rps`` — 0 allowed: a true lull).
    Starts in an ON window.  Memorylessness lets the gap simply be
    redrawn at each window boundary."""
    if n < 0:
        raise ValueError(f"bursty_arrivals: negative n {n}")
    if rate_on_rps <= 0 or rate_off_rps < 0:
        raise ValueError("bursty_arrivals: rate_on must be positive and "
                         "rate_off non-negative")
    if on_ms <= 0 or off_ms <= 0:
        raise ValueError("bursty_arrivals: window lengths must be positive")
    rng = np.random.RandomState(seed)
    out: List[float] = []
    t = float(t0_ms)
    on = True
    window_end = t + on_ms
    while len(out) < n:
        rate = rate_on_rps if on else rate_off_rps
        if rate <= 0:
            t = window_end
            on = not on
            window_end = t + (on_ms if on else off_ms)
            continue
        gap = rng.exponential(1000.0 / rate)
        if t + gap > window_end:
            t = window_end
            on = not on
            window_end = t + (on_ms if on else off_ms)
            continue
        t += gap
        out.append(t)
    return np.asarray(out)


@dataclass
class TimedRequest:
    """A ``ServeRequest`` with an arrival clock and a tenant label."""
    req: sv.ServeRequest
    tenant: str
    t_arrival_ms: float
    t_dispatch_ms: float = -1.0          # set when its micro-batch started
    shed: bool = False                   # refused at admission

    @property
    def rows(self) -> int:
        return len(self.req.x)

    @property
    def e2e_ms(self) -> float:
        return self.req.queue_ms + self.req.latency_ms


def make_timed_stream(x_pool, ids_pool, n_requests: int, *,
                      tenant: str = "t0", arrivals: str = "poisson",
                      rate_rps: float = 200.0, burst: Optional[dict] = None,
                      seed: int = 0, max_rows: int = 16,
                      p_known: float = 0.5, t0_ms: float = 0.0
                      ) -> List[TimedRequest]:
    """The mixed request generator (``vfl.make_request_stream``) plus a
    virtual arrival clock.
    ``arrivals``: ``"poisson"`` at ``rate_rps``, or ``"bursty"`` with the
    on/off parameters in ``burst`` (defaults: 4x ``rate_rps`` ON for
    200 ms, ``rate_rps``/4 OFF for 200 ms)."""
    reqs = sv.make_request_stream(x_pool, ids_pool, n_requests, seed=seed,
                                  max_rows=max_rows, p_known=p_known)
    if arrivals == "poisson":
        times = poisson_arrivals(n_requests, rate_rps, seed=seed + 7919,
                                 t0_ms=t0_ms)
    elif arrivals == "bursty":
        kw = {"rate_on_rps": 4.0 * rate_rps,
              "rate_off_rps": rate_rps / 4.0,
              "on_ms": 200.0, "off_ms": 200.0}
        kw.update(burst or {})
        times = bursty_arrivals(n_requests, seed=seed + 7919, t0_ms=t0_ms,
                                **kw)
    else:
        raise ValueError(f"unknown arrival process {arrivals!r} "
                         f"(poisson | bursty)")
    return [TimedRequest(r, tenant, float(t))
            for r, t in zip(reqs, times)]


def merge_streams(*streams: Sequence[TimedRequest]) -> List[TimedRequest]:
    """Interleave per-tenant streams into one global arrival order
    (stable: simultaneous arrivals keep their input order)."""
    merged = [tr for s in streams for tr in s]
    merged.sort(key=lambda tr: tr.t_arrival_ms)
    return merged


# ---------------------------------------------------------------------------
# multi-tenant bundle registry (one bucketer, one device)
# ---------------------------------------------------------------------------

class TenantRegistry:
    """Many tenants' ``ModelBundle``s served behind ONE shared
    ``BatchBucketer`` on one device.

    The engines' predict bodies are the pure ``vfl._active_apply`` /
    ``_collab_apply``, run eagerly: tenants share the functions and the
    kernels, and registering tenant N+1 builds nothing (the kernels are
    built once per process, on the first launch)."""

    def __init__(self, *, buckets: Sequence[int] = sv.DEFAULT_BUCKETS,
                 device="cuda"):
        self.device = resolve_device(device)
        self.bucketer = sv.BatchBucketer(buckets)
        self.engines: Dict[str, sv.VFLServingEngine] = {}

    def register(self, name: str, bundle: sv.ModelBundle, *,
                 quantize: Optional[str] = None) -> sv.VFLServingEngine:
        """``quantize="int8"`` registers the tenant on the quantized
        serving path (``serve.quant``: on the card the int8 kernel, on the
        CPU the pre-dequantized plain path)."""
        if name in self.engines:
            raise ValueError(f"tenant {name!r} already registered")
        engine = sv.VFLServingEngine(bundle, bucketer=self.bucketer,
                                     quantize=quantize, device=self.device)
        self.engines[name] = engine
        return engine

    def __getitem__(self, name: str) -> sv.VFLServingEngine:
        return self.engines[name]

    def __contains__(self, name: str) -> bool:
        return name in self.engines

    def __len__(self) -> int:
        return len(self.engines)

    def names(self) -> List[str]:
        return list(self.engines)

    def warmup(self) -> None:
        """Dispatch every bucket shape of every tenant through both paths
        (on the card the first dispatch builds and loads the kernels)."""
        for engine in self.engines.values():
            engine.warmup()

    def reset_stats(self) -> None:
        for engine in self.engines.values():
            engine.reset_stats()

    def jit_cache_sizes(self) -> dict:
        """The port runs eagerly: no executable cache."""
        return {}

    def compiled_shapes(self) -> dict:
        """Union of dispatched (path, bucket) pairs across tenants."""
        shapes = set()
        for engine in self.engines.values():
            shapes |= engine._shapes
        by_path: dict = {}
        for path, bucket in sorted(shapes):
            by_path.setdefault(path, []).append(bucket)
        return {"by_path": by_path,
                "distinct_batch_shapes": len({b for _, b in shapes})}


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RuntimeConfig:
    """SLO and admission knobs for ``ServingRuntime``.

    ``slo_ms`` is the end-to-end (queue + service) latency objective;
    ``max_wait_ms`` is the queueing budget that forces a partial batch
    out (default: half the SLO, leaving the other half for service);
    ``max_queue_rows`` is the per-tenant admission bound — an arriving
    request that would push its tenant's queued rows past it is shed."""
    slo_ms: float = 100.0
    max_wait_ms: Optional[float] = None
    max_queue_rows: int = 4096

    @property
    def wait_budget_ms(self) -> float:
        return (0.5 * self.slo_ms if self.max_wait_ms is None
                else float(self.max_wait_ms))


@dataclass
class DispatchRecord:
    """One micro-batch the runtime executed (kept for parity replay)."""
    tenant: str
    t_dispatch_ms: float
    service_ms: float
    group: List[TimedRequest] = field(repr=False, default_factory=list)

    @property
    def rows(self) -> int:
        return sum(tr.rows for tr in self.group)


def _merge_ids(reqs: List[sv.ServeRequest]) -> Optional[np.ndarray]:
    """Same coalescing rule as ``serve_stream``: anonymous requests ride
    along under the never-matching filler id so an id-carrying neighbor
    keeps its cache routing."""
    if not any(r.ids is not None for r in reqs):
        return None
    return np.concatenate([
        r.ids if r.ids is not None
        else np.full(len(r.x), sv.ANON_ID, np.int64) for r in reqs])


class ServingRuntime:
    """Discrete-event serving loop over a ``TenantRegistry`` (module
    docstring).  ``service_model(rows) -> ms`` replaces the measured
    dispatch time on the VIRTUAL clock only (dispatches always execute for
    real), which makes the scheduler's decisions deterministic: the same
    stream gives the same dispatch log on any device."""

    def __init__(self, registry: TenantRegistry,
                 config: RuntimeConfig = RuntimeConfig(), *,
                 service_model: Optional[Callable[[int], float]] = None):
        self.registry = registry
        self.config = config
        self.service_model = service_model
        self.dispatch_log: List[DispatchRecord] = []

    # --- the event loop ----------------------------------------------------

    def run(self, stream: Sequence[TimedRequest], *,
            faults=None) -> dict:
        """Serve a merged timed stream to completion; returns the report
        dict (shared ``serve.metrics`` schema, per-tenant + overall).

        ``faults`` is a ``robustness.faults.FaultPlan`` (duck-typed: any
        object whose ``serving_events()`` yields ``t_ms``-stamped
        events).  Events fire at dispatch boundaries once the virtual
        clock passes their timestamp: ``dropout``/``stale``/``drift``
        invalidate the tenant's representation cache (subsequent lookups
        miss, requests degrade to the active-only path — never stale
        latents), ``recover`` re-installs the bundle's latents with a
        version bump.  The report gains a ``"faults"`` block with
        per-tenant accounting, including ``collab_dispatches_while_
        faulted`` — the runtime's stale-serving violation counter, which
        must stay 0."""
        cfg = self.config
        unknown = {tr.tenant for tr in stream} - set(self.registry.engines)
        if unknown:
            raise ValueError(f"stream names unregistered tenants "
                             f"{sorted(unknown)}")
        fault_events: List = []
        fault_state: Dict[str, dict] = {}
        if faults is not None:
            fault_events = list(faults.serving_events())
            bad = {e.tenant for e in fault_events} \
                - set(self.registry.engines)
            if bad:
                raise ValueError(f"fault plan names unregistered tenants "
                                 f"{sorted(str(t) for t in bad)}")
            for e in fault_events:
                fault_state.setdefault(e.tenant, {
                    "faulted": False, "kinds": [], "faulted_at_ms": None,
                    "recovered_at_ms": None,
                    "collab_dispatches_while_faulted": 0})
        fi = 0

        def apply_faults(t: float) -> None:
            nonlocal fi
            while fi < len(fault_events) and fault_events[fi].t_ms <= t:
                ev = fault_events[fi]
                fi += 1
                engine = self.registry.engines[ev.tenant]
                st = fault_state[ev.tenant]
                if ev.kind == "recover":
                    bundle = engine.bundle
                    if bundle.supports_collaborative:
                        engine.refresh_cache(bundle.cache_ids,
                                             bundle.cache_z)
                    st["faulted"] = False
                    st["recovered_at_ms"] = float(ev.t_ms)
                else:                      # dropout | stale | drift
                    engine.invalidate_cache()
                    if not st["faulted"]:
                        st["faulted_at_ms"] = float(ev.t_ms)
                    st["faulted"] = True
                    st["kinds"].append(ev.kind)

        self.dispatch_log = []
        stream = sorted(stream, key=lambda tr: tr.t_arrival_ms)
        queues: Dict[str, deque] = {n: deque() for n in self.registry.names()}
        queued_rows = {n: 0 for n in queues}
        max_rows = self.registry.bucketer.max
        wait_budget = cfg.wait_budget_ms
        served: List[TimedRequest] = []
        shed: List[TimedRequest] = []
        i, n = 0, len(stream)
        now = stream[0].t_arrival_ms if stream else 0.0
        t_first = now
        wall_t0 = time.perf_counter()

        def admit_until(t: float) -> None:
            nonlocal i
            while i < n and stream[i].t_arrival_ms <= t:
                tr = stream[i]
                i += 1
                if queued_rows[tr.tenant] + tr.rows > cfg.max_queue_rows:
                    tr.shed = True
                    eng = self.registry.engines[tr.tenant]
                    eng.stats.shed_requests += 1
                    eng.stats.shed_rows += tr.rows
                    shed.append(tr)
                else:
                    queues[tr.tenant].append(tr)
                    queued_rows[tr.tenant] += tr.rows

        while i < n or any(queues.values()):
            admit_until(now)
            apply_faults(now)
            # pick the dispatchable tenant with the oldest head-of-line
            # request: full bucket, queueing budget exhausted, or nothing
            # left to wait for (drain)
            drain = i >= n
            ready: Optional[str] = None
            for name, q in queues.items():
                if not q:
                    continue
                full = queued_rows[name] >= max_rows
                # deadline spelled EXACTLY like the idle-jump candidates
                # below: (t + w) - t can float-round below w, so comparing
                # `now - t >= w` after jumping to `t + w` would livelock
                urgent = now >= q[0].t_arrival_ms + wait_budget
                if full or urgent or drain:
                    if ready is None or \
                            q[0].t_arrival_ms < queues[ready][0].t_arrival_ms:
                        ready = name
            if ready is None:
                # idle: jump the clock to the next event (an arrival or
                # the earliest head-of-line deadline)
                candidates = [q[0].t_arrival_ms + wait_budget
                              for q in queues.values() if q]
                if i < n:
                    candidates.append(stream[i].t_arrival_ms)
                now = max(now, min(candidates))
                continue
            # coalesce FIFO up to the largest warm bucket
            q = queues[ready]
            group = [q.popleft()]
            rows = group[0].rows
            while q and rows + q[0].rows <= max_rows:
                tr = q.popleft()
                group.append(tr)
                rows += tr.rows
            queued_rows[ready] -= rows
            engine = self.registry.engines[ready]
            x = np.concatenate([tr.req.x for tr in group])
            ids = _merge_ids([tr.req for tr in group])
            c0 = engine.stats.dispatches.get("collab", 0)
            t0 = time.perf_counter()
            logits = engine.predict(x, ids)
            measured_ms = (time.perf_counter() - t0) * 1e3
            st = fault_state.get(ready)
            if st is not None and st["faulted"] and \
                    engine.stats.dispatches.get("collab", 0) > c0:
                # a faulted tenant served cached (stale) latents: the
                # invariant that must stay 0
                st["collab_dispatches_while_faulted"] += 1
            service_ms = (measured_ms if self.service_model is None
                          else float(self.service_model(rows)))
            off = 0
            for tr in group:
                tr.req.logits = logits[off:off + tr.rows]
                off += tr.rows
                tr.t_dispatch_ms = now
                tr.req.queue_ms = now - tr.t_arrival_ms
                tr.req.latency_ms = service_ms
                engine.stats.record(tr.req.queue_ms, service_ms)
                served.append(tr)
            engine.stats.requests += len(group)
            self.dispatch_log.append(DispatchRecord(
                ready, now, service_ms, group))
            # single executor: the clock is busy for the whole dispatch
            now += service_ms
        # events stamped beyond the last dispatch still take effect (the
        # cache state must reflect the WHOLE plan, not just the served
        # window)
        apply_faults(float("inf"))
        wall_s = time.perf_counter() - wall_t0
        report = self._report(served, shed, t_first, now, wall_s)
        if faults is not None:
            tenants_block = {}
            for name, st in fault_state.items():
                engine = self.registry.engines[name]
                tenants_block[name] = {
                    **st,
                    "cache_stale": bool(engine.cache is not None
                                        and engine.cache.stale),
                    "cache_version": engine.cache_version,
                }
            report["faults"] = {
                "plan": getattr(faults, "name", "plan"),
                "events_applied": fi,
                "tenants": tenants_block,
            }
        return report

    # --- reporting ---------------------------------------------------------

    def _report(self, served: List[TimedRequest], shed: List[TimedRequest],
                t_first: float, t_end: float, wall_s: float) -> dict:
        cfg = self.config
        elapsed_ms = max(t_end - t_first, 1e-9)
        tenants = {}
        for name in self.registry.names():
            mine = [tr for tr in served if tr.tenant == name]
            mine_shed = [tr for tr in shed if tr.tenant == name]
            rows = int(sum(tr.rows for tr in mine))
            disp = [d for d in self.dispatch_log if d.tenant == name]
            tenants[name] = {
                "requests": len(mine),
                "rows": rows,
                "shed_requests": len(mine_shed),
                "shed_rows": int(sum(tr.rows for tr in mine_shed)),
                "dispatches": len(disp),
                "mean_batch_rows": round(
                    rows / len(disp), 2) if disp else 0.0,
                "rows_per_s": round(rows / (elapsed_ms / 1e3), 1),
                "latency_ms": {
                    "queue": series_summary(
                        [tr.req.queue_ms for tr in mine]),
                    "service": series_summary(
                        [tr.req.latency_ms for tr in mine]),
                    "end_to_end": series_summary(
                        [tr.e2e_ms for tr in mine]),
                },
                "slo": slo_report([tr.e2e_ms for tr in mine], cfg.slo_ms,
                                  offered=len(mine) + len(mine_shed)),
            }
        rows = int(sum(tr.rows for tr in served))
        offered = len(served) + len(shed)
        return {
            "config": {"slo_ms": cfg.slo_ms,
                       "max_wait_ms": cfg.wait_budget_ms,
                       "max_queue_rows": cfg.max_queue_rows,
                       "buckets": list(self.registry.bucketer.buckets)},
            "requests": offered,
            "served": len(served),
            "shed_requests": len(shed),
            "shed_rate": round(len(shed) / offered, 4) if offered else 0.0,
            "rows": rows,
            "dispatches": len(self.dispatch_log),
            "mean_batch_rows": round(
                rows / len(self.dispatch_log), 2) if self.dispatch_log
                else 0.0,
            "virtual_elapsed_ms": round(elapsed_ms, 3),
            "measured_wall_s": round(wall_s, 4),
            "rows_per_s": round(rows / (elapsed_ms / 1e3), 1),
            "requests_per_s": round(len(served) / (elapsed_ms / 1e3), 1),
            "latency_ms": {
                "queue": series_summary(
                    [tr.req.queue_ms for tr in served]),
                "service": series_summary(
                    [tr.req.latency_ms for tr in served]),
                "end_to_end": series_summary(
                    [tr.e2e_ms for tr in served]),
            },
            "slo": slo_report([tr.e2e_ms for tr in served], cfg.slo_ms,
                              offered=offered),
            "tenants": tenants,
            "compiled": self.registry.compiled_shapes(),
            "jit_cache_sizes": self.registry.jit_cache_sizes(),
        }


def verify_dispatch_parity(runtime: ServingRuntime,
                           bundles: Dict[str, sv.ModelBundle]) -> dict:
    """Replay every micro-batch the runtime dispatched through a FRESH
    solo ``VFLServingEngine`` per tenant (its own bucketer with the same
    buckets, the tenant's quantize mode, the registry's device) and
    compare logits bit for bit.  This is the multi-tenant isolation proof:
    serving behind the shared registry must equal dedicated per-tenant
    serving exactly."""
    out = {}
    reg = runtime.registry
    for tenant, bundle in bundles.items():
        # an int8 tenant's dedicated-serving twin is also int8
        q = reg[tenant].quantize if tenant in reg else None
        solo = sv.VFLServingEngine(bundle, buckets=reg.bucketer.buckets,
                                   quantize=q, device=reg.device)
        identical = True
        max_abs = 0.0
        batches = 0
        for rec in runtime.dispatch_log:
            if rec.tenant != tenant:
                continue
            reqs = [tr.req for tr in rec.group]
            x = np.concatenate([r.x for r in reqs])
            want = solo.predict(x, _merge_ids(reqs))
            got = np.concatenate([r.logits for r in reqs])
            identical = identical and np.array_equal(got, want)
            if len(got):
                max_abs = max(max_abs,
                              float(np.max(np.abs(got - want))))
            batches += 1
        out[tenant] = {"batches": batches, "bit_identical": bool(identical),
                       "max_abs_diff": max_abs}
    return out
