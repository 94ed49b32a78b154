"""ServingGateway: N InfServer replicas behind one routing/admission seam;
counterpart of `repro.serving.gateway`, the same code over the port's
manifests (`params.manifest.build_manifest`) and transport. Obs and
results are numpy, as in `repro`; a replica puts what it hosts on its
own device.

The millions-of-users story for the Model_M→Actor serving plane: the
paper deploys many inference consumers per model, and one InfServer
process — however well it batches — is a single flush lock and a single
accelerator. The gateway fronts a FLEET of replicas (in-process
`InfServer`s or remote `InfServerClient`s — both speak the same
submit/flush/get protocol, so the gateway never knows which it holds)
and adds the three things a fleet needs that a single server doesn't:

* **Routing** — a pluggable `Router` (see `repro_torch.serving.router`) picks
  the replica per submit. The default `LineageRouter` keeps each model
  lineage on a home replica (small stacked-model groups, warm param
  routes) and spills to the least-loaded replica when the home's
  outstanding load crosses the occupancy threshold. Load is the
  gateway's own outstanding-row ledger plus the replica-reported queue
  depth from `telemetry()` — the `InfServer.stats()` signal crossing
  the RPC seam.
* **SLO-aware continuous batching** — the InfServer already batches by
  SIZE (flush at `max_batch` rows); the gateway adds DEADLINE buckets:
  each submit may carry `deadline_s`, and the pump loop flushes any
  replica holding a request whose deadline is within the replica's
  expected batch latency. Size buckets fill throughput, deadline
  buckets bound tail latency; `stats()["deadlines"]` reports per-bucket
  p50/p99 and hit rate.
* **Admission control** — outstanding rows across the fleet are capped;
  past the cap `submit` sheds the request with a typed
  `AdmissionRejected` (reason, current load, cap, suggested retry-after)
  instead of queueing unboundedly. A shed is a fast, explicit signal the
  caller can back off on — an unbounded queue is a slow timeout for
  everyone.
* **Failover** — a replica that dies mid-request (TransportError from
  its client) is marked dead, its ledger is released, and every ticket
  it held is transparently resubmitted to a surviving replica on its
  next `get` (the gateway retains each ticket's observation rows until
  resolution for exactly this).
* **Fleet rollout** — `rollout()` propagates a (frozen) league model to
  every replica with `has_model(key, tree_hash)` probes first, so
  replicas already hosting the content receive ZERO param bytes; paired
  with `rollout_from_pool` the whole fleet warms from one delta pull.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.params.manifest import build_manifest
from repro_torch.serving.router import (NoReplicas, ReplicaView, Router,
                                        make_router)

from repro_torch.distributed.transport import RemoteError, TransportError


class AdmissionRejected(RuntimeError):
    """Typed load-shed: the fleet's outstanding-row cap (or the fleet
    itself) cannot absorb this request right now. Carries enough for the
    caller to back off intelligently instead of parsing a message."""

    def __init__(self, reason: str, *, rows: int, inflight_rows: int,
                 limit: int, retry_after_s: float = 0.0):
        super().__init__(
            f"admission rejected ({reason}): {rows} rows over "
            f"{inflight_rows}/{limit} outstanding; retry in "
            f"~{retry_after_s * 1e3:.0f}ms")
        self.reason = reason
        self.rows = rows
        self.inflight_rows = inflight_rows
        self.limit = limit
        self.retry_after_s = retry_after_s


class DeadlineBuckets:
    """Deadline-bucketed latency accounting (the SLO half of continuous
    batching). Buckets are by REQUESTED deadline — `le_50ms` collects
    every request that asked for <=50ms — so the hit rate reads as 'of
    requests wanting X, how many got it'. Latencies keep a bounded
    window per bucket (enough for a stable p99, bounded forever)."""

    def __init__(self, edges_s: Sequence[float] = (0.01, 0.05, 0.25, 1.0),
                 window: int = 4096):
        self.edges_s = tuple(sorted(edges_s))
        self._lat: Dict[str, deque] = {}
        self._met: Dict[str, int] = {}
        self._count: Dict[str, int] = {}
        self._window = window
        self._lock = threading.Lock()

    def label(self, deadline_s: Optional[float]) -> str:
        if deadline_s is None:
            return "le_inf"
        for e in self.edges_s:
            if deadline_s <= e:
                return f"le_{e * 1e3:g}ms"
        return "le_inf"

    def record(self, deadline_s: Optional[float], latency_s: float) -> bool:
        met = deadline_s is None or latency_s <= deadline_s
        lab = self.label(deadline_s)
        with self._lock:
            self._count[lab] = self._count.get(lab, 0) + 1
            self._met[lab] = self._met.get(lab, 0) + int(met)
            dq = self._lat.setdefault(lab, deque(maxlen=self._window))
            dq.append(latency_s)
        return met

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            out = {}
            for lab, n in self._count.items():
                lat = np.sort(np.asarray(self._lat[lab], dtype=np.float64))
                out[lab] = {
                    "count": n,
                    "met": self._met[lab],
                    "hit_rate": self._met[lab] / n,
                    "p50_ms": float(lat[int(0.50 * (len(lat) - 1))] * 1e3),
                    "p99_ms": float(lat[int(0.99 * (len(lat) - 1))] * 1e3),
                }
            return out


class GatewayTicket:
    """Fleet-level future: which replica holds the request, the inner
    replica ticket, and the retained observation rows (the failover
    resubmit payload). Resolve with `result()` / `gateway.get()`."""
    __slots__ = ("gid", "model", "rows", "obs", "deadline_s", "t_submit",
                 "handle", "inner", "_gateway")

    def __init__(self, gid, model, obs, deadline_s, handle, inner, gateway):
        self.gid = gid
        self.model = model
        self.obs = obs
        self.rows = obs.shape[0]
        self.deadline_s = deadline_s
        self.t_submit = time.perf_counter()
        self.handle = handle
        self.inner = inner
        self._gateway = gateway

    def result(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._gateway.get(self)

    def __repr__(self):
        return (f"GatewayTicket({self.gid}, model={self.model!r}, "
                f"rows={self.rows}, replica={self.handle.index})")


class _Handle:
    """Gateway-side ledger for one replica: liveness, outstanding rows,
    which routes the gateway installed, last-seen telemetry, and the
    deadlines pending since the last flush (what the pump reads)."""
    __slots__ = ("index", "replica", "alive", "inflight_rows", "hosted",
                 "outstanding", "pending_deadlines", "queue_depth",
                 "ewma_latency_s", "routed_rows", "routed_requests")

    def __init__(self, index: int, replica):
        self.index = index
        self.replica = replica
        self.alive = True
        self.inflight_rows = 0
        self.hosted: set = set()
        self.outstanding: Dict[int, int] = {}        # gid -> rows
        self.pending_deadlines: Dict[int, float] = {}  # gid -> abs deadline
        self.queue_depth = 0
        self.ewma_latency_s = 0.0
        self.routed_rows = 0
        self.routed_requests = 0

    def view(self) -> ReplicaView:
        return ReplicaView(self.index, alive=self.alive,
                           inflight_rows=self.inflight_rows,
                           queue_depth=self.queue_depth,
                           ewma_latency_s=self.ewma_latency_s)


class ServingGateway:
    """Front a fleet of InfServer-protocol replicas. See module docstring.

    `replicas` — in-process `InfServer`s, `InfServerClient`s, or a mix.
    `router` — a name from `repro_torch.serving.router.ROUTERS`, or an
    instance. `max_inflight_rows` — the fleet-wide admission cap.
    `deadline_edges_s` — the SLO bucket boundaries. `failover_retries` —
    how many replica deaths one request survives. `pump_interval_s` —
    cadence of the deadline pump thread once `start()`ed (telemetry
    refreshes ride the same thread every `telemetry_every` ticks)."""

    def __init__(self, replicas: Sequence[Any], *, router="lineage",
                 max_inflight_rows: int = 4096,
                 deadline_edges_s: Sequence[float] = (0.01, 0.05, 0.25, 1.0),
                 deadline_safety: float = 2.0,
                 failover_retries: int = 2,
                 pump_interval_s: float = 0.002,
                 telemetry_every: int = 25):
        assert replicas, "gateway needs at least one replica"
        self._handles = [_Handle(i, r) for i, r in enumerate(replicas)]
        self._router = make_router(router)
        self.max_inflight_rows = max_inflight_rows
        self.deadlines = DeadlineBuckets(deadline_edges_s)
        self.deadline_safety = deadline_safety
        self.failover_retries = failover_retries
        self.pump_interval_s = pump_interval_s
        self.telemetry_every = telemetry_every
        self._lock = threading.Lock()
        self._inflight_total = 0
        self._next_gid = 0
        # params the gateway can (re)install on a replica: rollout /
        # register_model keep the latest copy per route so spill targets
        # and failover targets warm lazily, hash-gated
        self._sources: Dict[Hashable, Tuple[Any, Optional[str],
                                            Optional[int]]] = {}
        # counters
        self.shed_requests = 0
        self.shed_rows = 0
        self.failovers = 0
        self.replicas_died = 0
        self.rollout_bytes_shipped = 0
        self.rollout_noops = 0
        self.requests = 0
        self.rows = 0
        self._pump_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- routing + admission -------------------------------------------------
    def submit(self, obs, model: Hashable = None,
               deadline_s: Optional[float] = None) -> GatewayTicket:
        """Route one observation batch into the fleet. Raises
        `AdmissionRejected` instead of queueing past the fleet cap."""
        obs = np.asarray(obs)
        rows = obs.shape[0]
        deadline_abs = (None if deadline_s is None
                        else time.perf_counter() + deadline_s)
        with self._lock:
            if self._inflight_total + rows > self.max_inflight_rows:
                self.shed_requests += 1
                self.shed_rows += rows
                retry = max((h.ewma_latency_s for h in self._handles
                             if h.alive), default=0.0) or 0.01
                raise AdmissionRejected(
                    "overload", rows=rows,
                    inflight_rows=self._inflight_total,
                    limit=self.max_inflight_rows, retry_after_s=retry)
            try:
                idx = self._router.route(
                    model, rows, [h.view() for h in self._handles])
            except NoReplicas:
                self.shed_requests += 1
                self.shed_rows += rows
                raise AdmissionRejected(
                    "no_replicas", rows=rows,
                    inflight_rows=self._inflight_total,
                    limit=self.max_inflight_rows) from None
            h = self._handles[idx]
            gid = self._next_gid
            self._next_gid += 1
            self._acquire(h, gid, rows, deadline_abs)
        h, inner = self._submit_on(h, gid, obs, model, deadline_abs)
        gt = GatewayTicket(gid, model, obs, deadline_s, h, inner, self)
        with self._lock:
            self.requests += 1
            self.rows += rows
        return gt

    def _acquire(self, h: _Handle, gid: int, rows: int,
                 deadline_abs: Optional[float]) -> None:
        """Ledger a routed request onto `h` (gateway lock held)."""
        h.inflight_rows += rows
        h.outstanding[gid] = rows
        h.routed_rows += rows
        h.routed_requests += 1
        if deadline_abs is not None:
            h.pending_deadlines[gid] = deadline_abs
        self._inflight_total += rows

    def _release(self, gid: int, h: _Handle) -> bool:
        """Un-ledger; idempotent (False when already released — e.g. the
        handle died and its ledger was swept)."""
        with self._lock:
            rows = h.outstanding.pop(gid, None)
            h.pending_deadlines.pop(gid, None)
            if rows is None:
                return False
            h.inflight_rows -= rows
            self._inflight_total -= rows
            return True

    def _submit_on(self, h: _Handle, gid: int, obs, model,
                   deadline_abs: Optional[float]) -> Tuple[_Handle, Any]:
        """The replica call, OUTSIDE the gateway lock (it may block for a
        replica flush). A transport death here fails over immediately.
        Returns (handle, inner ticket) for the replica the submit
        actually LANDED on — every failover hop releases the previous
        handle's ledger and re-acquires (deadline intact) on the next, so
        the caller's ticket always points at the replica holding the
        rows."""
        while True:
            try:
                if model is not None:
                    self._ensure_route(h, model)
                return h, h.replica.submit(obs, model=model)
            except (TransportError, OSError):
                self._mark_dead(h)
                self._release(gid, h)
                with self._lock:
                    try:
                        idx = self._router.route(
                            model, obs.shape[0],
                            [x.view() for x in self._handles])
                    except NoReplicas:
                        raise AdmissionRejected(
                            "no_replicas", rows=obs.shape[0],
                            inflight_rows=self._inflight_total,
                            limit=self.max_inflight_rows) from None
                    h = self._handles[idx]
                    self._acquire(h, gid, obs.shape[0], deadline_abs)
                self.failovers += 1

    def _ensure_route(self, h: _Handle, model: Hashable) -> None:
        """Install `model` on `h` if the gateway knows its params and has
        not installed it there yet (hash-gated on the replica side, so a
        replica that already hosts the content ships zero bytes)."""
        if model in h.hosted:
            return
        src = self._sources.get(model)
        if src is None:
            # the replica may host it natively (e.g. its default route);
            # let the submit itself be the probe
            return
        params, content_hash, version = src
        h.replica.register_model(model, params, content_hash=content_hash,
                                 version=version)
        h.hosted.add(model)

    # -- resolution + failover -----------------------------------------------
    def get(self, gt: GatewayTicket) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
        """Resolve a gateway ticket. Survives up to `failover_retries`
        replica deaths by resubmitting the retained observations to a
        surviving replica. Records the deadline outcome."""
        deaths = 0
        while True:
            h = gt.handle
            try:
                a, logp, v = h.replica.get(gt.inner)
                break
            except (TransportError, OSError) as e:
                self._mark_dead(h)
                deaths += 1
                if deaths > self.failover_retries:
                    self._release(gt.gid, h)
                    raise
                self._failover(gt)
            except RemoteError:
                # the replica is alive but no longer holds the ticket
                # (restarted, or expired it) — resubmit, same budget.
                # On exhaustion the ledger must be released HERE: the
                # replica stays alive, so no _mark_dead sweep will ever
                # reclaim this gid's rows or its pending deadline.
                deaths += 1
                if deaths > self.failover_retries:
                    self._release(gt.gid, h)
                    raise
                self._failover(gt)
        self._release(gt.gid, h)
        latency = time.perf_counter() - gt.t_submit
        self.deadlines.record(gt.deadline_s, latency)
        w = 0.2                       # ewma of observed request latency:
        with self._lock:              # the pump's flush-margin estimate
            h.ewma_latency_s = ((1 - w) * h.ewma_latency_s + w * latency
                                if h.ewma_latency_s else latency)
        return np.asarray(a), np.asarray(logp), np.asarray(v)

    def _failover(self, gt: GatewayTicket) -> None:
        """Re-route a ticket whose replica died: re-ledger on a survivor
        and resubmit the retained obs rows."""
        self._release(gt.gid, gt.handle)
        with self._lock:
            try:
                idx = self._router.route(
                    gt.model, gt.rows, [h.view() for h in self._handles])
            except NoReplicas:
                raise AdmissionRejected(
                    "no_replicas", rows=gt.rows,
                    inflight_rows=self._inflight_total,
                    limit=self.max_inflight_rows) from None
            h2 = self._handles[idx]
            deadline_abs = (None if gt.deadline_s is None
                            else gt.t_submit + gt.deadline_s)
            self._acquire(h2, gt.gid, gt.rows, deadline_abs)
        self.failovers += 1
        gt.handle, gt.inner = self._submit_on(
            h2, gt.gid, gt.obs, gt.model, deadline_abs)

    def _mark_dead(self, h: _Handle) -> None:
        with self._lock:
            if not h.alive:
                return
            h.alive = False
            self.replicas_died += 1
            # sweep its ledger: every ticket it held will re-ledger on a
            # survivor at its own failover
            for gid, rows in list(h.outstanding.items()):
                h.inflight_rows -= rows
                self._inflight_total -= rows
            h.outstanding.clear()
            h.pending_deadlines.clear()

    def mark_dead(self, index: int) -> None:
        """Operator/escape hatch: take a replica out of rotation."""
        self._mark_dead(self._handles[index])

    # -- SLO pump + telemetry ------------------------------------------------
    def pump(self, now: Optional[float] = None) -> int:
        """One deadline pass: flush every alive replica holding a pending
        request whose deadline is within `deadline_safety` x the
        replica's expected latency (+ one pump interval of slack). The
        InfServer's own size trigger (`max_batch` rows) stays primary —
        this is the tail-latency bound for half-full batches. Returns
        how many replicas were flushed."""
        now = time.perf_counter() if now is None else now
        to_flush: List[_Handle] = []
        with self._lock:
            for h in self._handles:
                if not (h.alive and h.pending_deadlines):
                    continue
                margin = (self.deadline_safety * h.ewma_latency_s
                          + self.pump_interval_s)
                if min(h.pending_deadlines.values()) <= now + margin:
                    h.pending_deadlines.clear()
                    to_flush.append(h)
        self._flush_fanout(to_flush)
        return len(to_flush)

    def flush(self) -> None:
        """Flush the whole fleet concurrently (and clear the deadline
        ledger): remote replicas take a pipelined `flush_async`, so one
        slow replica no longer serializes the rest."""
        with self._lock:
            handles = [h for h in self._handles if h.alive]
            for h in handles:
                h.pending_deadlines.clear()
        self._flush_fanout(handles)

    def _flush_fanout(self, handles) -> None:
        """Submit every flush before awaiting any ack; in-process
        replicas (no `flush_async`) flush inline."""
        futs = []
        for h in handles:
            fa = getattr(h.replica, "flush_async", None)
            try:
                if fa is None:
                    h.replica.flush()
                else:
                    futs.append((h, fa()))
            except (TransportError, OSError):
                self._mark_dead(h)
        for h, fut in futs:
            try:
                fut.result()
            except (TransportError, OSError):
                self._mark_dead(h)
            except RemoteError:
                pass                   # replica alive; flush itself failed

    def refresh_telemetry(self, probe_timeout_s: float = 0.25) -> None:
        """Pull each replica's occupancy/latency probe into the router's
        view of the fleet — `InfServer.telemetry()` in-process, a
        pipelined `telemetry_async` fan-out over RPC. All probes go out
        before any reply is awaited, under ONE shared deadline: a replica
        that cannot answer within `probe_timeout_s` just keeps its stale
        view (NOT marked dead — a late reply resolves harmlessly in the
        reader; liveness is the failover path's call), so one stalled
        replica can no longer freeze the router's occupancy view or the
        pump thread's deadline math. A replica whose transport is
        actually gone IS marked dead."""
        probes = []
        for h in self._handles:
            if not h.alive:
                continue
            probe = getattr(h.replica, "telemetry_async", None)
            if probe is None:          # in-process replica: local + cheap
                try:
                    self._fold_telemetry(h, h.replica.telemetry())
                except (TransportError, OSError):
                    self._mark_dead(h)
                continue
            try:
                probes.append((h, probe()))
            except (TransportError, OSError):
                self._mark_dead(h)
        deadline = time.perf_counter() + probe_timeout_s
        for h, fut in probes:
            try:
                t = fut.result(max(0.0, deadline - time.perf_counter()))
            except TimeoutError:
                continue               # stale this round, not dead
            except (TransportError, OSError):
                self._mark_dead(h)
                continue
            except RemoteError:
                continue               # replica alive; probe itself failed
            self._fold_telemetry(h, t)

    def _fold_telemetry(self, h: "_Handle", t: dict) -> None:
        with self._lock:
            h.queue_depth = int(t.get("queue_depth", 0))
            lat = t.get("mean_batch_latency_ms")
            if lat:
                h.ewma_latency_s = max(h.ewma_latency_s, lat / 1e3)

    def start(self) -> "ServingGateway":
        """Run the deadline pump (+ periodic telemetry refresh) in a
        daemon thread until `stop()`/`close()`."""
        if self._pump_thread is not None:
            return self
        self._stop.clear()

        def loop():
            tick = 0
            while not self._stop.wait(self.pump_interval_s):
                self.pump()
                tick += 1
                if tick % self.telemetry_every == 0:
                    self.refresh_telemetry()

        self._pump_thread = threading.Thread(
            target=loop, name="gateway-pump", daemon=True)
        self._pump_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5.0)
            self._pump_thread = None

    close = stop

    # -- fleet param plane ---------------------------------------------------
    def register_model(self, key: Hashable, params,
                       content_hash: Optional[str] = None,
                       version: Optional[int] = None) -> None:
        """Broadcast a route to every alive replica (replica-side
        hash-gated: identical refreshes no-op) and retain the copy as the
        install source for spill/failover targets."""
        with self._lock:
            self._sources[key] = (params, content_hash, version)
            handles = [h for h in self._handles if h.alive]
        for h in handles:
            h.replica.register_model(key, params, content_hash=content_hash,
                                     version=version)
            h.hosted.add(key)

    def update_params(self, params, key: Hashable = None,
                      content_hash: Optional[str] = None,
                      version: Optional[int] = None) -> None:
        self.register_model(key, params, content_hash=content_hash,
                            version=version)

    def rollout(self, key: Hashable, params, manifest=None) -> dict:
        """Propagate a (frozen) model to the whole fleet, `has_model`
        probes first: a replica already hosting `manifest.tree_hash`
        receives ZERO param bytes (one tiny probe round trip). Returns
        the propagation report the bench records — per-replica shipped
        flag/bytes/latency and the fleet totals."""
        if manifest is None:
            manifest = build_manifest(params, version=0)
        t0 = time.perf_counter()
        per: List[dict] = []
        bytes_shipped = 0
        with self._lock:
            handles = [h for h in self._handles if h.alive]
        # probe the whole fleet concurrently (pipelined has_model_async
        # on RPC replicas), then ship params only where the probe said
        # the content is missing — the warm-fleet rollout pays N
        # overlapped probe round trips instead of N serial ones
        t1s: Dict[int, float] = {}
        hosted: Dict[int, bool] = {}
        probes = []
        for h in handles:
            t1s[h.index] = time.perf_counter()
            probe = getattr(h.replica, "has_model_async", None)
            if probe is None:          # in-process replica
                hosted[h.index] = bool(
                    h.replica.has_model(key, manifest.tree_hash))
                continue
            try:
                probes.append((h, probe(key, manifest.tree_hash)))
            except (TransportError, OSError):
                self._mark_dead(h)
        for h, fut in probes:
            try:
                hosted[h.index] = bool(fut.result())
            except (TransportError, OSError, RemoteError):
                self._mark_dead(h)
        for h in handles:
            if h.index not in hosted:
                continue               # died during the probe pass
            if hosted[h.index]:
                shipped = False
                self.rollout_noops += 1
            else:
                h.replica.register_model(
                    key, params, content_hash=manifest.tree_hash,
                    version=manifest.version)
                shipped = True
                bytes_shipped += manifest.nbytes
            h.hosted.add(key)
            per.append({"replica": h.index, "shipped": shipped,
                        "bytes": manifest.nbytes if shipped else 0,
                        "ms": (time.perf_counter() - t1s[h.index]) * 1e3})
        with self._lock:
            self._sources[key] = (params, manifest.tree_hash,
                                  manifest.version)
            self.rollout_bytes_shipped += bytes_shipped
        return {"key": str(key), "tree_hash": manifest.tree_hash,
                "version": manifest.version, "replicas": per,
                "bytes_shipped": bytes_shipped,
                "shipped_to": sum(p["shipped"] for p in per),
                "already_hosted": sum(not p["shipped"] for p in per),
                "propagation_ms": (time.perf_counter() - t0) * 1e3}

    def rollout_from_pool(self, pool, key: Hashable) -> dict:
        """Warm the fleet from a ModelPool: ONE (delta-cached) pull from
        the pool, then the probe-gated fleet rollout — the frozen-model
        propagation path."""
        manifest = pool.manifest(key)
        params = pool.pull(key)
        return self.rollout(key, params, manifest=manifest)

    # -- introspection -------------------------------------------------------
    @property
    def inflight_rows(self) -> int:
        return self._inflight_total

    @property
    def alive_replicas(self) -> int:
        return sum(h.alive for h in self._handles)

    def stats(self) -> dict:
        with self._lock:
            per = [{"replica": h.index, "alive": h.alive,
                    "inflight_rows": h.inflight_rows,
                    "routed_rows": h.routed_rows,
                    "routed_requests": h.routed_requests,
                    "queue_depth": h.queue_depth,
                    "ewma_latency_ms": h.ewma_latency_s * 1e3,
                    "hosted": len(h.hosted)}
                   for h in self._handles]
            out = {
                "replicas": per,
                "alive_replicas": sum(h.alive for h in self._handles),
                "requests": self.requests,
                "rows": self.rows,
                "inflight_rows": self._inflight_total,
                "max_inflight_rows": self.max_inflight_rows,
                "shed_requests": self.shed_requests,
                "shed_rows": self.shed_rows,
                "failovers": self.failovers,
                "replicas_died": self.replicas_died,
                "rollout_bytes_shipped": self.rollout_bytes_shipped,
                "rollout_noops": self.rollout_noops,
                "router": type(self._router).__name__,
            }
        for attr in ("spills", "affinity_hits"):
            val = getattr(self._router, attr, None)
            if val is not None:
                out[f"router_{attr}"] = val
        out["deadlines"] = self.deadlines.snapshot()
        return out

    def telemetry(self) -> dict:
        """Fleet-level analogue of `InfServer.telemetry()`: what a
        front-of-gateway poller (an HPA metric exporter, a higher tier
        of routing) reads cheaply."""
        with self._lock:
            return {
                "queue_depth": self._inflight_total,
                "alive_replicas": sum(h.alive for h in self._handles),
                "mean_batch_latency_ms": 1e3 * max(
                    (h.ewma_latency_s for h in self._handles if h.alive),
                    default=0.0),
                "shed_requests": self.shed_requests,
            }


class GatewayBackend:
    """RPC adapter: put a `ServingGateway` behind an `RpcServer` under the
    `inf` namespace and every existing `InfServerClient` (and therefore
    every served Actor) talks to the FLEET without knowing it — the same
    trick `InfServerBackend` plays for one server, one level up. Tickets
    cross the wire as integers; the retained `GatewayTicket`s (and their
    failover obs payloads) stay here. Outstanding tickets are bounded
    exactly like `InfServerBackend`'s."""

    def __init__(self, gateway: ServingGateway, max_outstanding: int = 4096):
        self._gw = gateway
        self._max_outstanding = max_outstanding
        self._tickets: Dict[int, GatewayTicket] = {}   # insertion-ordered
        self._lock = threading.Lock()

    def submit(self, obs, model: Hashable = None,
               deadline_s: Optional[float] = None) -> int:
        gt = self._gw.submit(np.asarray(obs), model=model,
                             deadline_s=deadline_s)
        with self._lock:
            self._tickets[gt.gid] = gt
            while len(self._tickets) > self._max_outstanding:
                stale = next(iter(self._tickets))
                dead = self._tickets.pop(stale)
                self._gw._release(dead.gid, dead.handle)
        return gt.gid

    def poll(self, gid: int) -> bool:
        with self._lock:
            gt = self._tickets.get(gid)
        if gt is None:
            return False
        done = getattr(gt.inner, "done", None)
        return bool(done()) if callable(done) else False

    def get(self, gid: int):
        with self._lock:
            gt = self._tickets.pop(gid)
        a, logp, v = self._gw.get(gt)
        return np.asarray(a), np.asarray(logp), np.asarray(v)

    def flush(self) -> None:
        self._gw.flush()

    def update_params(self, params, key: Hashable = None,
                      content_hash: Optional[str] = None,
                      version: Optional[int] = None) -> None:
        self._gw.update_params(params, key=key, content_hash=content_hash,
                               version=version)

    def ensure_model(self, key: Hashable, params,
                     content_hash: Optional[str] = None) -> None:
        # fleet semantics: idempotent == hash-gated broadcast
        self._gw.register_model(key, params, content_hash=content_hash)

    def register_model(self, key: Hashable, params,
                       content_hash: Optional[str] = None,
                       version: Optional[int] = None) -> None:
        self._gw.register_model(key, params, content_hash=content_hash,
                                version=version)

    def has_model(self, key: Hashable,
                  content_hash: Optional[str] = None) -> bool:
        with self._gw._lock:
            src = self._gw._sources.get(key)
            handles = [h for h in self._gw._handles if h.alive]
        if src is not None and (content_hash is None
                                or src[1] == content_hash):
            return True
        return any(h.replica.has_model(key, content_hash) for h in handles)

    def stats(self) -> dict:
        return self._gw.stats()

    def telemetry(self) -> dict:
        return self._gw.telemetry()
