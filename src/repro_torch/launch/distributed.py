"""Multiprocess league launch: the runtime's thread seams as process
boundaries; counterpart of `repro.launch.distributed`.

The event-driven runtime (`repro_torch.league.runtime`) already
communicates only through the decoupled-service seams; this module places
those seams on the `repro_torch.distributed.transport` RPC layer so
LeagueMgr/ModelPool, each Learner, each Actor and a shared InfServer run
as separate OS processes — the paper's §3.4 hybrid-cluster layout, with
TCP standing in for ZeroMQ.

Process roles (each is `python -m repro_torch.launch.train --role <role>`,
a fresh interpreter started with `subprocess`):

  * **coordinator** — owns LeagueMgr + ModelPool (and the shared InfServer
    unless a separate `--role infserver` process is launched), serves them
    over one RPC socket, runs the freeze/stop control plane (`ctrl`
    namespace: endpoint registry, learner step reports, the stop flag).
  * **learner** (one per role) — hosts its role's DataServer behind its
    own RPC socket (registered with the coordinator so actors can find
    it), pulls θ from the remote ModelPool, drains the ring, pushes θ
    back, polls `should_freeze` at step boundaries and executes freezes
    through `LeagueMgrClient.end_learning_period` — params cross the wire,
    so the pool entry stays authoritative exactly as in-process.
  * **actor** — requests tasks and reports results against the remote
    LeagueMgr, ships trajectory segments into its role's remote DataServer
    (`put_when_room`: ring-full backpressure crosses the process
    boundary), and in `--served` mode routes every policy forward through
    the shared InfServer via `InfServerClient`.
  * **infserver** — a standalone serving process hosting the grouped θ+φ
    forward.

`run_multiprocess` (`train.py --workers N`) is the one-command form: the
parent becomes the coordinator and spawns one learner process per role
plus N actor processes (round-robin over roles), then tears everything
down on the stop condition and prints the merged report.

On the card: every role runs on `device` (CUDA when None, raising where
there is none; `--device cpu` asks for the plain versions by name, as the
CPU tests do), and `run_multiprocess` passes it to every child. The wire
carries only numpy (see the transport), so each process puts what it
receives on its own device: the coordinator's pool keeps HOST leaves (its
seed params are made on its device and brought over once), a Learner
snapshots its pulls onto the card, a local Actor's pulls land on the card
through `_PlacedPool` (a NotModified pull then uploads nothing), and an
InfServer uploads the routes it is sent. Every role's result carries its
process's kernel launch counts (`kernel_report`), and the CLI prints it as
one JSON line, so a caller can hold each process to exact counts.
`sharded` lays the served InfServer out over a mesh of this process's card
(`_build_mesh`): its own process group of one, torn down when the role
stops.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import torch

from repro_torch.distributed.heartbeat import (BeatRegistry, Heartbeat,
                                               HeartbeatMonitor)
from repro_torch.distributed.transport import (DataServerClient, FaultPlan,
                                               InfServerClient,
                                               LeagueMgrClient,
                                               ModelPoolClient, ParamDelta,
                                               RetryableError, RpcClient,
                                               RpcServer, TransportError,
                                               serve_league)
from repro_torch.utils import resolve_device, tree_map

_POLL_S = 0.05
_HEARTBEAT_INTERVAL_S = 1.0
DEFAULT_HEARTBEAT_TIMEOUT_S = 30.0
# lease plane defaults: an actor that neither finishes a segment nor beats
# the ctrl plane for ACTOR_STALE_S is presumed dead and its lease reaped;
# the TTL itself is the backstop for actors that never identified themselves
DEFAULT_LEASE_TTL_S = 30.0
DEFAULT_ACTOR_STALE_S = 10.0
_REAP_INTERVAL_S = 1.0
# in-process restart budget for crashed actor children (run_multiprocess);
# mirrored into the k8s renderer's backoff annotations
DEFAULT_ACTOR_RESTARTS = 2


class Ctrl:
    """Coordinator control plane, served under the `ctrl` namespace: a
    process-boundary replacement for the runtime's in-process Coordinator
    thread state. All methods are called over RPC from worker processes;
    the lock makes them linearizable (the RpcServer runs one thread per
    connection). `ping` exposes the coordinator heartbeat — workers run a
    `HeartbeatMonitor` against it so a WEDGED coordinator (stopped,
    deadlocked, partitioned — sockets open, no progress) is
    distinguished from a merely slow one and triggers clean shutdown
    instead of an eternal blocked recv."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stop = False
        self._endpoints: Dict[str, str] = {}
        self._steps: Dict[str, int] = {}
        self._segments: Dict[str, int] = {}
        self._frames: Dict[str, int] = {}
        self.heartbeat = Heartbeat()
        self.beats = BeatRegistry()     # per-actor liveness (lease reaper feed)

    # -- liveness -----------------------------------------------------------
    def ping(self) -> int:
        """Current beat count of the coordinator's beater thread."""
        return self.heartbeat.ping()

    # -- stop flag ----------------------------------------------------------
    def stop(self) -> None:
        with self._lock:
            self._stop = True

    def should_stop(self) -> bool:
        with self._lock:
            return self._stop

    # -- endpoint registry --------------------------------------------------
    def register_endpoint(self, name: str, address: str) -> None:
        """`name` is free-form (`data/<role>`, `inf/shared`); workers poll
        `endpoint` until the owning process has bound and registered."""
        with self._lock:
            self._endpoints[name] = address

    def endpoint(self, name: str) -> Optional[str]:
        with self._lock:
            return self._endpoints.get(name)

    # -- progress reports ---------------------------------------------------
    def report_learner(self, role: str, steps: int) -> None:
        with self._lock:
            self._steps[role] = steps

    def report_actor(self, actor_id: str, segments: int, frames: int) -> None:
        self.beats.beat(actor_id)       # a progress report IS a liveness beat
        with self._lock:
            self._segments[actor_id] = segments
            self._frames[actor_id] = frames

    def actor_beat(self, actor_id: str) -> int:
        """Explicit liveness beat: actors call this while waiting out
        DataServer backpressure, when segment completion (and therefore
        `report_actor`) can stall arbitrarily long on a slow learner —
        a backpressured actor must not look dead to the lease reaper."""
        return self.beats.beat(actor_id)

    def progress(self) -> dict:
        with self._lock:
            return {"learner_steps": dict(self._steps),
                    "actor_segments": dict(self._segments),
                    "frames_total": sum(self._frames.values())}


def _window(warm, end) -> Optional[dict]:
    """The league's rate between the first poll at which every role's
    learner had taken a step (its start-up and cold first step behind it)
    and the stop: frames the actors reported shipped and learner steps,
    over the coordinator's clock. None when no such poll came."""
    if warm is None:
        return None
    (t_w, w), (t_e, e) = warm, end
    secs = t_e - t_w
    frames = e["frames_total"] - w["frames_total"]
    steps = sum(e["learner_steps"].values()) - sum(w["learner_steps"].values())
    return {"start_s": round(t_w, 3), "seconds": round(secs, 3),
            "frames": frames, "learner_steps": steps,
            "frames_per_s": frames / secs if secs > 0 else None,
            "learner_steps_per_s": steps / secs if secs > 0 else None}


def _ctrl_client(address: str) -> RpcClient:
    return RpcClient(address)


class _Spent(dict):
    """Wall time a worker loop spends per part: `with spent("learn"): ...`
    adds to `part`'s `[seconds, calls, first call's seconds]`. Rides in the
    role's result line, so a reader can tell which part bounds a process
    (host clock; a part that waits for the card shows the card's time) and
    how much of it the first call, which warms everything up, took."""

    @contextlib.contextmanager
    def __call__(self, part: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            rec = self.setdefault(part, [0.0, 0, dt])
            rec[0] += dt
            rec[1] += 1


def _close(*clients) -> None:
    """Close a worker's RPC clients at exit: each unlinks its shm ring,
    which the process's resource tracker would otherwise report leaked."""
    for c in clients:
        c.close()


def _ctrl_call(address: str, method: str):
    """One ctrl call on a short-lived connection (the supervisor's)."""
    client = RpcClient(address, connect_retries=1)
    try:
        return client.call(method)
    finally:
        client.close()


def _wait_endpoint(ctrl: RpcClient, name: str, timeout: float = 60.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        addr = ctrl.call("ctrl.endpoint", name)
        if addr:
            return addr
        time.sleep(_POLL_S)
    raise TimeoutError(f"endpoint {name!r} never registered with coordinator")


def _coordinator_alive(connect: str) -> bool:
    """Probe the coordinator with a fresh connection (the cached client's
    socket may be the thing that just died). Short socket timeout: a
    wedged coordinator that accepts but never answers counts as dead."""
    probe = RpcClient(connect, timeout=3.0, connect_retries=1,
                      retry_delay_s=0.01)
    try:
        probe.call("ctrl.should_stop")
        return True
    except TransportError:
        return False
    finally:
        probe.close()


def _start_monitor(connect: str, timeout_s: float, stop_event: threading.Event,
                   clients) -> HeartbeatMonitor:
    """Worker-side liveness: watch `ctrl.ping` on its own connection; on
    a stalled heartbeat set the stop flag and close the worker's RPC
    clients, turning any blocked in-flight `recv` into the
    `TransportError` the worker loops already treat as shutdown."""
    def _on_dead():
        stop_event.set()
        for c in clients:
            try:
                # abort, not close: the worker thread may be blocked in
                # recv HOLDING the client lock — shutdown wakes it with a
                # TransportError (close would deadlock/never wake it)
                getattr(c, "abort", c.close)()
            except Exception:            # noqa: BLE001 — best-effort unblock
                pass

    mon = HeartbeatMonitor(connect, interval_s=_HEARTBEAT_INTERVAL_S,
                           timeout_s=timeout_s, on_dead=_on_dead)
    mon.start()
    return mon


def _advertised(address: str) -> str:
    """What to publish in the ctrl endpoint registry for a socket bound at
    `address`: a wildcard bind (0.0.0.0 / ::) is reachable by nobody, so
    advertise this machine's hostname instead (inside k8s that resolves
    via the pod's Service). Loopback binds are advertised as-is — correct
    for the single-host default, never routable across hosts (bind
    0.0.0.0 for multi-host layouts)."""
    import socket

    host, _, port = address.rpartition(":")
    if host in ("0.0.0.0", "::", ""):
        return f"{socket.gethostname()}:{port}"
    return address


def _build_mesh(sharded: bool, device):
    """The served InfServer's mesh: None, or with `sharded` the local mesh
    on `device` over this process's own process group of one."""
    if not sharded:
        return None
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(device)


def _close_mesh(mesh) -> None:
    if mesh is not None:
        from repro_torch.launch.mesh import close_local_mesh
        close_local_mesh()


def kernel_report(device) -> dict:
    """This process's kernel launch counts (each wrapper's `.launches`),
    the dispatch's per-call routing counts, and its peak CUDA memory."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.adamw.ops import adamw_update, global_norm
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.vtrace_scan.ops import reverse_discounted_scan_p

    wrappers = (rmsnorm, flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv, reverse_discounted_scan_p, adamw_update, global_norm)
    on_card = torch.device(device).type == "cuda"
    return {"launches": {w.__name__: w.launches for w in wrappers},
            "dispatch": dispatch.stats(),
            "peak_cuda_bytes": (torch.cuda.max_memory_allocated()
                                if on_card else None)}


class _PlacedPool:
    """A remote pool whose pulls land on `device`. The local Actor's
    CachedPuller then caches θ and φ there: a NotModified pull uploads
    nothing and a delta uploads only its changed leaves. Everything else
    is the wrapped client's."""

    def __init__(self, pool, device: torch.device):
        self._pool = pool
        self._device = device

    def __getattr__(self, name):
        return getattr(self._pool, name)

    def _place(self, tree):
        return tree_map(lambda a: torch.as_tensor(a, device=self._device),
                        tree)

    def pull(self, key, copy=None):
        return self._place(self._pool.pull(key, copy=copy))

    def pull_if_changed(self, key, have_version=None, copy=None,
                        have_hashes=None):
        r = self._pool.pull_if_changed(key, have_version, copy=copy,
                                       have_hashes=have_hashes)
        if not isinstance(r, ParamDelta):
            return r
        return dataclasses.replace(
            r, params=None if r.params is None else self._place(r.params),
            leaves=None if r.leaves is None else
            {p: self._place(x) for p, x in r.leaves.items()})


# -- coordinator -------------------------------------------------------------
def run_coordinator(spec, *, env_name: str = "rps",
                    arch: str = "tleague-policy-s", seed: int = 0,
                    served: bool = False, sharded: bool = False,
                    pbt: bool = False, bind: str = "127.0.0.1:0",
                    max_seconds: Optional[float] = None,
                    max_steps_per_role: Optional[int] = None,
                    lease_ttl_s: Optional[float] = DEFAULT_LEASE_TTL_S,
                    actor_stale_s: float = DEFAULT_ACTOR_STALE_S,
                    fault_plan: Optional[FaultPlan] = None,
                    on_bound=None, verbose: bool = True,
                    device=None) -> dict:
    """Host the league services and run the stop-condition loop. Blocks
    until `max_seconds` elapses or every role's learner reported
    `max_steps_per_role` steps, then raises the ctrl stop flag, lingers
    briefly so workers can observe it, and returns the final report.

    With NO stop condition the coordinator serves until something calls
    `ctrl.stop` over RPC (or the process is killed) — the k8s Deployment
    semantics, where the pod's lifetime is the run's lifetime.

    Liveness: a reaper thread classifies actors by their ctrl-plane beat
    age (`actor_stale_s`), extends the leases of live ones, and reaps the
    leases of stale/silent ones (`lease_ttl_s`; None disables the lease
    plane entirely). `fault_plan` (or the REPRO_FAULT_PLAN env var — the
    chaos smoke's cross-process seam) arms seeded fault injection on the
    serving socket.

    The pool keeps host leaves, which is what the wire delivers: the seed
    params are made on `device` (`role_params`, as the threaded runtime
    makes them) and brought to the host in one copy before the roles are
    installed, so no pull or manifest mint here waits for the device. The
    served InfServer runs on `device`. The report's `after_first_steps`
    is the league's rate once every learner has stepped (`_window`)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.transport import parse_addr
    from repro_torch.envs import make_env
    from repro_torch.infserver import InfServer
    from repro_torch.league.roles import install_roles
    from repro_torch.league.runtime import role_params
    from repro_torch.utils.host import to_host

    dev = resolve_device(device)
    env = make_env(env_name, device=dev)
    cfg = get_arch(arch)
    seeds = to_host([role_params(cfg, seed, i, dev) for i in range(len(spec))])
    league = install_roles(spec, seeds.__getitem__, pbt=pbt, seed=seed,
                           lease_ttl_s=lease_ttl_s)
    mesh = _build_mesh(served and sharded, dev)
    try:
        inf_server = None
        if served:
            inf_server = InfServer(cfg, env.spec.num_actions, seed=seed + 7919,
                                   max_batch=max(64, 16 * spec.num_actors_total),
                                   device=dev, mesh=mesh)
        ctrl = Ctrl()
        # the beater thread is the liveness signal: it advances even when the
        # stop-condition loop below is busy, and stops only with the process
        ctrl.heartbeat.start_beating(_HEARTBEAT_INTERVAL_S)
        if fault_plan is None:
            fault_plan = FaultPlan.from_env()
            if fault_plan is not None and verbose:
                print(f"[coordinator] fault plan armed: {fault_plan.to_json()}",
                      flush=True)
        host, port = parse_addr(bind)
        server = serve_league(league, inf_server, extra={"ctrl": ctrl},
                              host=host, port=port, fault_plan=fault_plan)
        reaper_stop = threading.Event()

        def _reap_loop():
            while not reaper_stop.wait(_REAP_INTERVAL_S):
                alive, stale = ctrl.beats.split(actor_stale_s)
                for actor_id in alive:
                    league.touch_actor(actor_id)
                reaped = league.reap_leases(dead_actors=stale)
                if reaped and verbose:
                    # the holders name a live actor reaped on its TTL too
                    print(f"[coordinator] reaped {len(reaped)} lease(s) of "
                          f"{[l.actor_id for l in reaped]} "
                          f"(stale actors: {stale})", flush=True)

        reaper = None
        if lease_ttl_s is not None:
            reaper = threading.Thread(target=_reap_loop, name="lease-reaper",
                                      daemon=True)
            reaper.start()
        if inf_server is not None:
            ctrl.register_endpoint("inf/shared", _advertised(server.address))
        if on_bound is not None:
            on_bound(server.address)
        if verbose:
            print(f"[coordinator] serving league at {server.address} "
                  f"(roles: {[r.name for r in spec]})", flush=True)
        t0 = time.monotonic()
        warm = None          # (s, progress) once every role's learner has stepped
        try:
            while not ctrl.should_stop():
                if max_seconds is not None and time.monotonic() - t0 >= max_seconds:
                    break
                prog = ctrl.progress()
                steps = prog["learner_steps"]
                stepped = len(steps) == len(spec)
                if warm is None and stepped and all(s >= 1 for s in steps.values()):
                    warm = (time.monotonic() - t0, prog)
                if (max_steps_per_role is not None and stepped
                        and all(s >= max_steps_per_role for s in steps.values())):
                    break
                time.sleep(_POLL_S)
            end = (time.monotonic() - t0, ctrl.progress())
            ctrl.stop()
            time.sleep(1.0)          # let workers observe the flag and detach
            report = {
                "wall_s": round(time.monotonic() - t0, 3),
                "progress": ctrl.progress(),
                "after_first_steps": _window(warm, end),
                "league": league.league_state(),
                "leases": league.lease_state(),
                "faults": fault_plan.stats() if fault_plan is not None else None,
                "serving": inf_server.stats() if inf_server is not None else None,
                "kernels": kernel_report(dev),
            }
            if verbose:
                print(f"[coordinator] done: {json.dumps(report['progress'])}",
                      flush=True)
                print(f"[coordinator] leases: {json.dumps(report['leases'])}",
                      flush=True)
            return report
        finally:
            ctrl.stop()
            reaper_stop.set()
            if reaper is not None:
                reaper.join(timeout=5.0)
            ctrl.heartbeat.stop_beating()
            server.close()
    finally:
        _close_mesh(mesh)


# -- learner -----------------------------------------------------------------
def run_learner(role_name: str, connect: str, *, env_name: str = "rps",
                arch: str = "tleague-policy-s", loss: str = "ppo",
                lr: float = 3e-4, seed: int = 0, num_envs: int = 8,
                unroll_len: int = 8, ring_segments: int = 4,
                data_bind: str = "127.0.0.1:0",
                advertise: Optional[str] = None,
                heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
                pool_endpoints: Optional[str] = None,
                verbose: bool = True, device=None) -> dict:
    """One role's Learner as a process: local DataServer (served to the
    role's actors over RPC), remote league protocol for everything else.
    `advertise` overrides the address registered for `data/<role>` —
    under k8s that is the learner's Service DNS name, which stays stable
    across pod restarts. A `HeartbeatMonitor` watches the coordinator:
    `heartbeat_timeout_s` without a beat advance and this process shuts
    down cleanly instead of blocking forever on a wedged socket.
    `pool_endpoints` (comma list) replicates the pool READ path across
    those endpoints; pushes stay pinned to the coordinator's pool. The
    Learner, its train step and its DataServer's staging run on `device`;
    each push brings θ to the host in one copy (the transport)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.transport import parse_addr
    from repro_torch.envs import make_env
    from repro_torch.learners import DataServer, Learner, build_env_train_step
    from repro_torch.optim import adamw

    dev = resolve_device(device)
    env = make_env(env_name, device=dev)
    cfg = get_arch(arch)
    league = LeagueMgrClient(connect, pool_endpoints=pool_endpoints)
    ctrl = _ctrl_client(connect)
    ctrl.call("ctrl.should_stop")    # probe: a bad endpoint fails loudly here
    coord_dead = threading.Event()
    monitor = _start_monitor(connect, heartbeat_timeout_s, coord_dead,
                             [ctrl, league])
    seg_frames = num_envs * env.spec.team_size * unroll_len
    ds = DataServer(capacity_frames=ring_segments * seg_frames, blocking=True,
                    device=dev)
    spent = _Spent()
    host, port = parse_addr(data_bind)
    data_srv = RpcServer({"data": ds}, host=host, port=port).start()
    try:
        ctrl.call("ctrl.register_endpoint", f"data/{role_name}",
                  advertise or _advertised(data_srv.address))

        opt = adamw(lr, clip_norm=1.0)
        step = build_env_train_step(cfg, env.spec.num_actions, opt, loss=loss)
        # warm-start from the role's CURRENT key, not version 0: a learner
        # process restarted mid-run (the k8s auto-restart path) must adopt
        # the lineage where it left off, not push seed weights over it
        current = league.agents[role_name].current
        learner = Learner(league, step, opt, league.model_pool.pull(current),
                          agent_id=role_name, data_server=ds, device=dev)
        # the Learner snapshotted the boot pull and syncs through its own
        # CachedPuller from here on — drop the client cache's copy so a
        # model-sized allocation isn't pinned for the process lifetime
        league.model_pool.drop(current)
        period_steps, freezes = 0, 0
        while not coord_dead.is_set() and not ctrl.call("ctrl.should_stop"):
            with spent("should_freeze"):
                reason = league.should_freeze(role_name, period_steps)
            if reason:
                with spent("freeze"):
                    new_key = learner.end_learning_period(reason=reason)
                freezes += 1
                period_steps = 0
                if verbose:
                    print(f"[learner/{role_name}] froze ({reason}) "
                          f"-> {new_key}", flush=True)
                continue
            with spent("wait_ready"):
                ready = ds.wait_ready(timeout=_POLL_S)
            if not ready:
                continue
            with spent("learn"):
                learned = learner.learn(num_steps=1)
            if learned:
                period_steps += 1
                # one-way telemetry: nobody consumes a reply, so the train
                # loop no longer pays a ctrl round trip per step (the loop
                # condition's should_stop still detects a dead coordinator)
                ctrl.notify("ctrl.report_learner", role_name,
                            learner.step_count)
        steps = learner.step_count
    except TransportError as e:
        # the coordinator owns the run's lifetime: once we were connected,
        # its disappearance IS the shutdown signal, not a failure (the stop
        # flag and the socket close race — a worker mid-poll sees whichever
        # comes first; a heartbeat-timeout monitor closes our clients and
        # lands here too). A *connect* failure still raises out of RpcClient.
        if verbose:
            why = "heartbeat timed out" if coord_dead.is_set() else str(e)
            print(f"[learner/{role_name}] coordinator gone ({why}); "
                  "shutting down", flush=True)
        steps, freezes = -1, -1
    finally:
        monitor.stop()
        data_srv.close()
        _close(ctrl, league)
    return {"role": role_name, "steps": steps, "freezes": freezes,
            "heartbeat_dead": coord_dead.is_set(), "seconds": spent,
            "kernels": kernel_report(dev)}


# -- actor -------------------------------------------------------------------
def run_actor(role_name: str, connect: str, *, actor_index: int = 0,
              env_name: str = "rps", arch: str = "tleague-policy-s",
              num_envs: int = 8, unroll_len: int = 8, seed: int = 0,
              served: bool = False,
              heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
              pool_endpoints: Optional[str] = None,
              verbose: bool = True, device=None) -> dict:
    """One Actor as a process: remote task/result protocol, remote
    DataServer put (with cross-process backpressure), and optionally the
    shared InfServer for every policy forward. A `HeartbeatMonitor`
    watches the coordinator (see `run_learner`).

    Robustness: the actor names itself on every `request_task` so the
    coordinator can lease-track it, beats the ctrl plane while waiting
    out backpressure (a backpressured actor is slow, not dead), pulls
    params with failover across `pool_endpoints` when given, and treats
    an ambiguous segment ship (`RetryableError`) as a dropped segment —
    trajectory frames are data, losing one is cheaper than double-feeding
    the ring. Segment shipping is overlapped: `put_when_room_async` puts
    the rows on the wire immediately and the next segment's env steps run
    while the server waits out ring backpressure; beats and progress
    reports ride one-way notifies instead of round trips.

    The env and (local mode) the policy forwards run on `device`; pulled
    params land there through `_PlacedPool`. A served actor only ships
    params to the InfServer, so its pulls stay on the host. The result's
    `frames_produced` counts every segment run, also when the coordinator
    went away first (`frames` is then -1, as in `repro`), `loop_s` is
    the wall time of the segment loop up to the end of its last segment
    (the process's start-up and shutdown excluded) and `seconds` splits
    the loop: `segment` (`run_segment`: the task, the pulls, the rollout
    and the result reports), `settle` (waiting for the previous segment's
    admission) and `ship`. `segments_dropped` counts ambiguous ships while
    the run was live; a ship lost because its learner closed at the stop
    counts in `segments_unsettled_at_stop`."""
    from repro_torch.actors import Actor
    from repro_torch.configs import get_arch
    from repro_torch.envs import make_env

    dev = resolve_device(device)
    env = make_env(env_name, device=dev)
    cfg = get_arch(arch)
    league = LeagueMgrClient(connect, pool_endpoints=pool_endpoints)
    if not served:
        league.model_pool = _PlacedPool(league.model_pool, dev)
    ctrl = _ctrl_client(connect)
    ctrl.call("ctrl.should_stop")    # probe: a bad endpoint fails loudly here
    actor_id = f"{role_name}/{actor_index}"
    segments = 0
    segments_dropped = 0
    segments_unsettled = 0
    actor, t_loop, t_last = None, None, None
    spent = _Spent()
    coord_dead = threading.Event()
    clients = [ctrl, league]
    monitor = _start_monitor(connect, heartbeat_timeout_s, coord_dead, clients)
    try:
        data = DataServerClient(_wait_endpoint(ctrl, f"data/{role_name}"))
        clients.append(data)
        inf = None
        if served:
            inf = InfServerClient(_wait_endpoint(ctrl, "inf/shared"))
            clients.append(inf)
        actor = Actor(env, cfg, league, agent_id=role_name, num_envs=num_envs,
                      unroll_len=unroll_len,
                      seed=seed * 1000 + actor_index, inf_server=inf,
                      actor_id=actor_id, device=dev)
        # the ship pipeline: at most ONE segment in flight. The rows go on
        # the wire (or the shm ring) the moment a segment completes; the
        # server-side backpressure wait then overlaps the NEXT segment's
        # env steps + inference instead of blocking the actor. Depth 1 is
        # deliberate — deeper would buffer trajectories actor-side exactly
        # when the learner is already the bottleneck.
        pending = None                     # (_ShipFuture, traj)

        def _stopping() -> bool:
            try:
                return coord_dead.is_set() or bool(ctrl.call("ctrl.should_stop"))
            except TransportError:
                return True

        def _settle(fut, traj):
            """Resolve one in-flight ship: re-submit on server-side
            ring-full timeouts, beat the ctrl plane while waiting (a
            backpressured actor is slow, not dead), drop the segment on
            an ambiguous failure. The server blocks on the ring condition
            for the whole timeout, so a LONG timeout means the segment is
            shipped once and waits server-side — client-side re-polling
            would re-serialize the full pytree 20x/s exactly when the
            learner is already the bottleneck."""
            nonlocal segments, segments_dropped, segments_unsettled
            while not coord_dead.is_set():
                try:
                    ok = fut.result(timeout=2.5)
                except TimeoutError:
                    ctrl.notify("ctrl.actor_beat", actor_id)  # slow != dead
                    continue
                except RetryableError:
                    # the learner may or may not have taken the segment (a
                    # restarting learner pod, a dropped reply): frames are
                    # data, not protocol state — drop it and move on rather
                    # than risk feeding the ring twice. A learner that
                    # closed because the run is stopping loses the segment
                    # in flight by design: that is not a drop.
                    if _stopping():
                        segments_unsettled += 1
                    else:
                        segments_dropped += 1
                    return
                if ok:
                    segments += 1
                    return
                # server-side timeout: the ring stayed full — re-ship
                # unless the run is coming down anyway
                if ctrl.call("ctrl.should_stop"):
                    return
                ctrl.notify("ctrl.actor_beat", actor_id)
                fut = data.put_when_room_async(traj, timeout=2.0)

        t_loop = time.monotonic()
        while not coord_dead.is_set() and not ctrl.call("ctrl.should_stop"):
            with spent("segment"):
                traj, _task = actor.run_segment()
            t_last = time.monotonic()
            if pending is not None:        # previous ship: await admission
                with spent("settle"):
                    _settle(*pending)
                pending = None
            ctrl.notify("ctrl.actor_beat", actor_id)
            with spent("ship"):
                pending = (data.put_when_room_async(traj, timeout=2.0), traj)
            # one-way progress telemetry: no reply consumed, no round trip
            ctrl.notify("ctrl.report_actor", actor_id, segments,
                        actor.frames_produced)
        if pending is not None and not coord_dead.is_set():
            _settle(*pending)              # drain the in-flight ship
            pending = None
        frames = actor.frames_produced
    except TransportError as e:
        # a vanished coordinator is shutdown, not failure (see run_learner)
        # — but this handler also guards calls to the learner's DataServer
        # and the InfServer, whose death with a live coordinator is a REAL
        # failure that must surface (nonzero exit -> k8s restarts the pod)
        if not coord_dead.is_set() and _coordinator_alive(connect):
            raise
        if verbose:
            why = "heartbeat timed out" if coord_dead.is_set() else str(e)
            print(f"[actor/{actor_id}] coordinator gone ({why}); "
                  "shutting down", flush=True)
        frames = -1
    finally:
        monitor.stop()
        _close(*clients)
    if verbose:
        print(f"[actor/{actor_id}] {segments} segments "
              f"({segments_dropped} dropped), {frames} frames", flush=True)
    return {"actor": actor_id, "segments": segments,
            "segments_dropped": segments_dropped,
            "segments_unsettled_at_stop": segments_unsettled, "frames": frames,
            "frames_produced": actor.frames_produced if actor else 0,
            "loop_s": t_last - t_loop if t_last else 0.0,
            "seconds": spent,
            "heartbeat_dead": coord_dead.is_set(),
            "kernels": kernel_report(dev)}


# -- standalone inference server ---------------------------------------------
def run_infserver(connect: str, *, env_name: str = "rps",
                  arch: str = "tleague-policy-s", seed: int = 0,
                  sharded: bool = False, max_batch: int = 256,
                  bind: str = "127.0.0.1:0", advertise: Optional[str] = None,
                  heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
                  verbose: bool = True, device=None) -> dict:
    """A standalone serving process: host the grouped θ+φ forward on
    `device` (with `sharded`, over a mesh of this process's card,
    `_build_mesh`) and register as the shared `inf/shared` endpoint.
    Routes are installed lazily by served Actors
    (`update_params`/`ensure_model` over RPC).

    `advertise` overrides the registered address. REQUIRED for replicated
    deployments: N replicas each registering their own pod hostname under
    the single `inf/shared` key would last-write-win and leave N-1 idle —
    advertising the k8s Service name instead lets the Service spread
    actor connections across all replicas."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.transport import InfServerBackend, parse_addr
    from repro_torch.envs import make_env
    from repro_torch.infserver import InfServer

    dev = resolve_device(device)
    env = make_env(env_name, device=dev)
    cfg = get_arch(arch)
    mesh = _build_mesh(sharded, dev)
    try:
        server = InfServer(cfg, env.spec.num_actions, seed=seed,
                           max_batch=max_batch, device=dev, mesh=mesh)
        ctrl = _ctrl_client(connect)
        coord_dead = threading.Event()
        monitor = _start_monitor(connect, heartbeat_timeout_s, coord_dead, [ctrl])
        host, port = parse_addr(bind)
        rpc = RpcServer({"inf": InfServerBackend(server)},
                        host=host, port=port).start()
        try:
            ctrl.call("ctrl.register_endpoint", "inf/shared",
                      advertise or _advertised(rpc.address))
            if verbose:
                print(f"[infserver] serving at {rpc.address}", flush=True)
            while not coord_dead.is_set() and not ctrl.call("ctrl.should_stop"):
                time.sleep(_POLL_S)
        except TransportError:
            pass                         # coordinator gone == shutdown signal
        finally:
            monitor.stop()
            rpc.close()
        return {**server.stats(), "kernels": kernel_report(dev)}
    finally:
        _close_mesh(mesh)


# -- pool read replica --------------------------------------------------------
def run_pool_replica(connect: str, *, replica_index: int = 0,
                     sync_interval_s: float = 0.5,
                     bind: str = "127.0.0.1:0",
                     advertise: Optional[str] = None,
                     heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
                     verbose: bool = True) -> dict:
    """A ModelPool READ replica as a process — the paper's M_M pool
    instances. Follows the coordinator's authoritative pool over the
    manifest/delta protocol (an unchanged key per sync cycle costs one
    NotModified tag) and serves the read half of the pool protocol under
    the `pool` namespace, so actors pointed here via `--pool-endpoints`
    keep pulling through a primary-pool outage. Writes are refused —
    learners push to the coordinator. Registers as
    `pool/replica/<index>`; `advertise` overrides the published address
    (the k8s Service name for replicated Deployments)."""
    from repro_torch.core.model_pool import ModelPoolReplica
    from repro_torch.distributed.transport import parse_addr

    primary = ModelPoolClient(RpcClient(connect))
    ctrl = _ctrl_client(connect)
    ctrl.call("ctrl.should_stop")    # probe: a bad endpoint fails loudly here
    coord_dead = threading.Event()
    monitor = _start_monitor(connect, heartbeat_timeout_s, coord_dead,
                             [ctrl, primary])
    replica = ModelPoolReplica(primary, sync_interval_s=sync_interval_s)
    host, port = parse_addr(bind)
    srv = RpcServer({"pool": replica}, host=host, port=port).start()
    try:
        # first catch-up BEFORE advertising: by the time the endpoint is
        # discoverable the replica already serves the current pool
        try:
            replica.sync_once()
        except Exception:                # noqa: BLE001 — follower retries
            pass
        replica.start_following()
        ctrl.call("ctrl.register_endpoint", f"pool/replica/{replica_index}",
                  advertise or _advertised(srv.address))
        if verbose:
            print(f"[pool-replica/{replica_index}] serving pool replica at "
                  f"{srv.address} ({len(replica.keys())} keys)", flush=True)
        while not coord_dead.is_set() and not ctrl.call("ctrl.should_stop"):
            time.sleep(_POLL_S)
    except TransportError:
        if verbose:
            print(f"[pool-replica/{replica_index}] coordinator gone; "
                  "shutting down", flush=True)
    finally:
        monitor.stop()
        replica.stop()
        srv.close()
    stats = dict(replica.sync_stats)
    stats["heartbeat_dead"] = coord_dead.is_set()
    return stats


# -- one-command multiprocess launch ------------------------------------------
def _spawn_role(role: str, connect: str, extra: List[str],
                env_overrides: Optional[Dict[str, str]] = None) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--role", role, "--connect", connect] + extra
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), env.get("PYTHONPATH")) if p)
    env.update(env_overrides or {})
    return subprocess.Popen(cmd, env=env)


def run_multiprocess(spec, *, workers: int, env_name: str = "rps",
                     arch: str = "tleague-policy-s", loss: str = "ppo",
                     num_envs: int = 8, unroll_len: int = 8, lr: float = 3e-4,
                     seed: int = 0, served: bool = False, sharded: bool = False,
                     pbt: bool = False,
                     max_seconds: Optional[float] = None,
                     max_steps_per_role: Optional[int] = None,
                     heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
                     max_actor_restarts: int = DEFAULT_ACTOR_RESTARTS,
                     verbose: bool = True, device=None) -> dict:
    """`train.py --workers N`: this process becomes the coordinator; one
    learner process per role plus `workers` actor processes (round-robin
    over roles, min one each) are spawned as `--role` children. Returns
    the coordinator report with per-child exit codes merged in.

    Actor supervision: a crashed actor child (nonzero exit while the run
    is live) is respawned with the same CLI up to `max_actor_restarts`
    times per slot — the respawn starts clean, requests a fresh task
    (fresh lease), and the reaper has already re-issued whatever the dead
    actor held. Learners are NOT respawned here (their in-memory
    optimizer state is the run); k8s restartPolicy owns that layer.

    `device` (CUDA when None) is resolved here, before anything starts,
    and passed to every child as `--device`."""
    assert workers >= 1, "--workers needs at least one actor process"
    assert max_seconds is not None or max_steps_per_role is not None, \
        "--workers needs a stop condition (--max-seconds / --max-steps)"
    dev = resolve_device(device)
    ctrl_box: Dict[str, object] = {}
    addr_ready = threading.Event()

    def _on_bound(address: str):
        ctrl_box["address"] = address
        addr_ready.set()

    def _coordinator():
        try:
            ctrl_box["report"] = run_coordinator(
                spec, env_name=env_name, arch=arch, seed=seed, served=served,
                sharded=sharded, pbt=pbt, max_seconds=max_seconds,
                max_steps_per_role=max_steps_per_role,
                on_bound=_on_bound, verbose=verbose, device=dev)
        except BaseException as e:      # noqa: BLE001 — re-raised by parent
            ctrl_box["error"] = e
            addr_ready.set()            # unblock the parent if bind failed

    coord = threading.Thread(target=_coordinator, name="coordinator",
                             daemon=True)
    coord.start()
    assert addr_ready.wait(timeout=30.0), "coordinator failed to bind"
    if "error" in ctrl_box:
        raise RuntimeError("coordinator failed") from ctrl_box["error"]  # type: ignore[arg-type]
    address = str(ctrl_box["address"])

    common = ["--env", env_name, "--arch", arch, "--loss", loss,
              "--num-envs", str(num_envs), "--unroll-len", str(unroll_len),
              "--lr", str(lr), "--seed", str(seed),
              "--heartbeat-timeout", str(heartbeat_timeout_s),
              "--device", str(dev)]
    if served:
        common.append("--served")
    # children as supervision records: actors carry their spawn args so a
    # crashed one can be relaunched; learners get restarts=None (never
    # respawned — their in-memory optimizer state IS the run)
    children: List[Dict[str, object]] = []
    try:
        for role in spec:
            args = common + ["--league-role", role.name]
            children.append({"proc": _spawn_role("learner", address, args),
                             "role": "learner", "args": args, "restarts": None})
        role_names = [r.name for r in spec]
        for w in range(workers):
            role = role_names[w % len(role_names)]
            args = common + ["--league-role", role, "--actor-index", str(w)]
            children.append({"proc": _spawn_role("actor", address, args),
                             "role": "actor", "args": args, "restarts": 0})

        def _run_stopping() -> bool:
            """True when the coordinator has raised (or lost) its stop flag —
            crashes during shutdown are expected, don't respawn into them."""
            try:
                return bool(_ctrl_call(address, "ctrl.should_stop"))
            except TransportError:
                return True

        actor_restarts = 0
        # the coordinator loop owns the stop condition — but if every child
        # died (e.g. crashed on startup) a step-quota coordinator would wait
        # forever, so raise its ctrl stop flag through its own RPC socket
        while coord.is_alive():
            coord.join(timeout=1.0)
            if not coord.is_alive():
                break
            for rec in children:
                proc: subprocess.Popen = rec["proc"]           # type: ignore[assignment]
                if (rec["restarts"] is None or proc.poll() is None
                        or proc.returncode == 0):
                    continue                   # learner / running / clean exit
                if rec["restarts"] >= max_actor_restarts or _run_stopping():  # type: ignore[operator]
                    continue
                rec["restarts"] = int(rec["restarts"]) + 1     # type: ignore[arg-type]
                actor_restarts += 1
                if verbose:
                    print(f"[supervisor] actor exited {proc.returncode}; "
                          f"respawn {rec['restarts']}/{max_actor_restarts} "
                          f"({' '.join(rec['args'][-2:])})", flush=True)  # type: ignore[index]
                rec["proc"] = _spawn_role("actor", address, list(rec["args"]))  # type: ignore[arg-type]
            if all(r["proc"].poll() is not None for r in children):  # type: ignore[union-attr]
                try:
                    _ctrl_call(address, "ctrl.stop")
                except TransportError:
                    pass
                coord.join(timeout=30.0)
                break
        deadline = time.monotonic() + 30.0
        exit_codes = []
        for rec in children:
            c: subprocess.Popen = rec["proc"]                  # type: ignore[assignment]
            try:
                exit_codes.append(c.wait(
                    timeout=max(0.1, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                c.terminate()
                exit_codes.append(c.wait(timeout=10.0))
    finally:
        for rec in children:                 # no orphans if anything raised
            c = rec["proc"]                                # type: ignore[assignment]
            if c.poll() is None:                           # type: ignore[union-attr]
                c.kill()                                   # type: ignore[union-attr]
                c.wait(timeout=10.0)                       # type: ignore[union-attr]
    if "error" in ctrl_box:
        # children saw the dead socket as shutdown and exited 0 — the
        # coordinator's own failure must still fail the run
        raise RuntimeError("coordinator crashed mid-run") from ctrl_box["error"]  # type: ignore[arg-type]
    report = dict(ctrl_box.get("report") or {})
    report["worker_exit_codes"] = exit_codes
    report["actor_restarts"] = actor_restarts
    report["clean_shutdown"] = all(code == 0 for code in exit_codes)
    return report
