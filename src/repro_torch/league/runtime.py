"""Event-driven league runtime: the paper's decoupled services (§3.2,
Fig. 2) as threads over the thread-capable seams; counterpart of
`repro.league.runtime`.

A synchronous driver interleaves every actor segment with every learner
step in one loop — actors idle while the learner steps and vice versa.
This runtime gives each module its own thread, communicating only through
the services the paper names:

  * **ActorWorker** (one per Actor) — pulls a Task from the LeagueMgr,
    runs a rollout segment, pushes the trajectory into its role's
    DataServer. Blocks on ring-full backpressure (`wait_for_room`) so a
    slow learner throttles its producers instead of losing frames.
  * **LearnerWorker** (one per role) — drains the DataServer continuously
    (`wait_ready`), steps the train step, publishes theta to the
    ModelPool (and the InfServer hot-swap path when serving centrally).
    Executes freeze requests at step boundaries, where the params are
    quiescent.
  * **Coordinator** (one per league) — polls each role's FreezeGate via
    `LeagueMgr.should_freeze` and posts freeze requests to the owning
    LearnerWorker; owns the league-level stop conditions.

Freeze decisions are made by the coordinator but *executed* by the learner
thread that owns the params — the request/execute split keeps every pytree
single-writer, and the request->execute delay is the `freeze_latency_s`
telemetry in the run report.

Liveness: the coordinator beats a shared `Heartbeat` every loop; Actor
and Learner workers treat a beat gap longer than `heartbeat_timeout_s`
as "coordinator dead" and exit their loops cleanly instead of producing
into a leaderless league forever — the in-process form of the worker
heartbeat `repro`'s multiprocess runtime runs over RPC.

On the card every thread enqueues onto the same device: the actors' env
steps and forwards and the learners' train steps interleave there, and
the host's interpreter lock serializes their Python. The kernels' launch
counters are locked (`kernels/_build.py:count_launch`), so the counts of
a run hold every launch of every thread.
"""
from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.actors import Actor
from repro_torch.configs import get_arch
from repro_torch.core import LeagueMgr, ModelKey
from repro_torch.distributed.heartbeat import Heartbeat
from repro_torch.envs import make_env
from repro_torch.infserver import InfServer
from repro_torch.league.roles import install_roles
from repro_torch.league.spec import LeagueSpec, RoleSpec
from repro_torch.learners import DataServer, Learner, build_env_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw
from repro_torch.utils import resolve_device


class _Worker(threading.Thread):
    """Stoppable loop thread that captures its own failure instead of
    dying silently (the runtime re-raises after shutdown)."""

    def __init__(self, name: str):
        super().__init__(name=name, daemon=True)
        self.stop_event = threading.Event()
        self.error: Optional[BaseException] = None
        self.error_tb: str = ""

    def run(self):
        try:
            self._loop()
        except BaseException as e:          # noqa: BLE001 — reported, not hidden
            self.error = e
            self.error_tb = traceback.format_exc()

    def stop(self):
        self.stop_event.set()

    def _loop(self):
        raise NotImplementedError


class ActorWorker(_Worker):
    def __init__(self, name: str, actor: Actor, data_server: DataServer,
                 poll_s: float = 0.05, heartbeat: Optional[Heartbeat] = None,
                 heartbeat_timeout_s: float = 30.0):
        super().__init__(name)
        self.actor = actor
        self.data_server = data_server
        self.poll_s = poll_s
        self.heartbeat = heartbeat
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.segments = 0

    def _coordinator_dead(self) -> bool:
        return (self.heartbeat is not None
                and self.heartbeat.stalled(self.heartbeat_timeout_s))

    def _loop(self):
        while not self.stop_event.is_set():
            if self._coordinator_dead():
                return                     # clean exit: nobody to freeze us
            traj, _task = self.actor.run_segment()
            # backpressure: never bury frames the learner has not consumed.
            # put_when_room holds the room predicate and the write under one
            # lock, so producers of the same role can't jointly overshoot.
            while not self.stop_event.is_set() and not self._coordinator_dead():
                if self.data_server.put_when_room(traj, timeout=self.poll_s):
                    self.segments += 1
                    break


class LearnerWorker(_Worker):
    def __init__(self, name: str, learner: Learner, data_server: DataServer,
                 poll_s: float = 0.05, heartbeat: Optional[Heartbeat] = None,
                 heartbeat_timeout_s: float = 30.0):
        super().__init__(name)
        self.learner = learner
        self.data_server = data_server
        self.poll_s = poll_s
        self.heartbeat = heartbeat
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.period_steps = 0               # steps since the last freeze
        self.total_steps = 0
        self.freezes: List[dict] = []
        self._freeze_request: Optional[Tuple[str, float]] = None

    # -- coordinator-facing ---------------------------------------------------
    def request_freeze(self, reason: str) -> None:
        """Posted by the coordinator; executed by this worker at the next
        step boundary (params are single-writer: this thread owns them)."""
        if self._freeze_request is None:
            self._freeze_request = (reason, time.monotonic())

    @property
    def freeze_pending(self) -> bool:
        return self._freeze_request is not None

    # -- loop ----------------------------------------------------------------
    def _loop(self):
        while not self.stop_event.is_set():
            if (self.heartbeat is not None
                    and self.heartbeat.stalled(self.heartbeat_timeout_s)):
                return                     # coordinator dead: clean exit
            req = self._freeze_request
            if req is not None:
                reason, t_req = req
                old_key = self.learner.current_key
                new_key = self.learner.end_learning_period(reason=reason)
                self.freezes.append({
                    "frozen": str(old_key), "minted": str(new_key),
                    "reason": reason, "period_steps": self.period_steps,
                    "latency_s": time.monotonic() - t_req,
                })
                self.period_steps = 0
                self._freeze_request = None
                continue
            if not self.data_server.wait_ready(timeout=self.poll_s):
                continue
            m = self.learner.learn(num_steps=1)
            if m:
                self.period_steps += 1
                self.total_steps += 1


@dataclass
class RoleRuntime:
    spec: RoleSpec
    actors: List[ActorWorker]
    learner: LearnerWorker
    data_server: DataServer


class Coordinator(_Worker):
    """Applies freeze decisions and owns the league-level stop conditions."""

    def __init__(self, league: LeagueMgr, roles: List[RoleRuntime],
                 done_event: threading.Event, poll_s: float = 0.01,
                 max_freezes_per_role: Optional[int] = None,
                 max_steps_per_role: Optional[int] = None,
                 deadline: Optional[float] = None,
                 heartbeat: Optional[Heartbeat] = None):
        super().__init__("league-coordinator")
        self.league = league
        self.roles = roles
        self.done_event = done_event
        self.poll_s = poll_s
        self.max_freezes = max_freezes_per_role
        self.max_steps = max_steps_per_role
        self.deadline = deadline
        self.heartbeat = heartbeat

    def _role_quota_met(self, role: RoleRuntime) -> bool:
        """True once every stop condition that was actually set is met."""
        met_any = False
        if self.max_freezes is not None:
            if (len(role.learner.freezes) < self.max_freezes
                    or role.learner.freeze_pending):
                return False
            met_any = True
        if self.max_steps is not None:
            if role.learner.total_steps < self.max_steps:
                return False
            met_any = True
        return met_any

    def _loop(self):
        while not self.stop_event.is_set():
            if self.heartbeat is not None:
                self.heartbeat.beat()      # liveness: workers watch this
            for role in self.roles:
                lw = role.learner
                if lw.freeze_pending:
                    continue
                if (self.max_freezes is not None
                        and len(lw.freezes) >= self.max_freezes):
                    continue                 # quota filled: stop freezing
                reason = self.league.should_freeze(role.spec.name,
                                                   lw.period_steps)
                if reason:
                    lw.request_freeze(reason)
            quota = ((self.max_freezes is not None
                      or self.max_steps is not None)
                     and all(self._role_quota_met(r) for r in self.roles))
            timed_out = (self.deadline is not None
                         and time.monotonic() >= self.deadline)
            if quota or timed_out:
                self.done_event.set()
                return
            time.sleep(self.poll_s)


class LeagueRuntime:
    """Owns the worker threads for one league. `run` is the one-call
    entry: start everything, wait for the stop condition, shut down
    cleanly, and either raise the first worker failure or return the
    run report."""

    def __init__(self, league: LeagueMgr, roles: List[RoleRuntime],
                 inf_server: Optional[InfServer] = None,
                 coordinator_poll_s: float = 0.01,
                 heartbeat: Optional[Heartbeat] = None):
        self.league = league
        self.roles = roles
        self.inf_server = inf_server
        self.coordinator_poll_s = coordinator_poll_s
        self.heartbeat = heartbeat
        self.done_event = threading.Event()
        self._coordinator: Optional[Coordinator] = None

    # -- lifecycle -------------------------------------------------------------
    def _workers(self) -> List[_Worker]:
        ws: List[_Worker] = []
        for r in self.roles:
            ws.extend(r.actors)
            ws.append(r.learner)
        if self._coordinator is not None:
            ws.append(self._coordinator)
        return ws

    def start(self, *, max_freezes_per_role: Optional[int] = None,
              max_steps_per_role: Optional[int] = None,
              max_seconds: Optional[float] = None) -> None:
        deadline = (time.monotonic() + max_seconds
                    if max_seconds is not None else None)
        self.done_event.clear()
        if self.heartbeat is not None:
            self.heartbeat.beat()    # fresh epoch: a runtime built long ago
                                     # must not look dead at worker start
        self._coordinator = Coordinator(
            self.league, self.roles, self.done_event,
            poll_s=self.coordinator_poll_s,
            max_freezes_per_role=max_freezes_per_role,
            max_steps_per_role=max_steps_per_role, deadline=deadline,
            heartbeat=self.heartbeat)
        for w in self._workers():
            w.start()

    def stop(self, join_timeout: float = 180.0) -> List[_Worker]:
        """Signal every worker and join. Returns workers that failed (the
        in-flight segment of an ActorWorker can take a while to drain —
        hence the generous join timeout)."""
        workers = self._workers()
        for w in workers:
            w.stop()
        deadline = time.monotonic() + join_timeout
        for w in workers:
            w.join(timeout=max(0.0, deadline - time.monotonic()))
        stuck = [w for w in workers if w.is_alive()]
        if stuck:
            raise RuntimeError(f"workers failed to shut down: {[w.name for w in stuck]}")
        return [w for w in workers if w.error is not None]

    def run(self, *, max_seconds: Optional[float] = None,
            max_freezes_per_role: Optional[int] = None,
            max_steps_per_role: Optional[int] = None,
            join_timeout: float = 180.0) -> dict:
        if all(x is None for x in (max_seconds, max_freezes_per_role, max_steps_per_role)):
            raise ValueError("the runtime needs at least one stop condition")
        t0 = time.monotonic()
        self.start(max_freezes_per_role=max_freezes_per_role,
                   max_steps_per_role=max_steps_per_role,
                   max_seconds=max_seconds)
        try:
            while not self.done_event.wait(timeout=0.05):
                dead = [w for w in self._workers() if w.error is not None]
                if dead:
                    break
        finally:
            failed = self.stop(join_timeout=join_timeout)
        if failed:
            details = "\n\n".join(f"[{w.name}]\n{w.error_tb}" for w in failed)
            raise RuntimeError(
                f"{len(failed)} league worker(s) failed:\n{details}")
        return self.report(wall_s=time.monotonic() - t0)

    # -- telemetry ------------------------------------------------------------
    def report(self, wall_s: float) -> dict:
        per_role = {}
        frames_total = 0
        latencies: List[float] = []
        for r in self.roles:
            frames = sum(a.actor.frames_produced for a in r.actors)
            frames_total += frames
            latencies.extend(f["latency_s"] for f in r.learner.freezes)
            tp = r.data_server.throughput()
            per_role[r.spec.name] = {
                "role": r.spec.role,
                "segments": sum(a.segments for a in r.actors),
                "frames_produced": frames,
                "learner_steps": r.learner.total_steps,
                "freezes": list(r.learner.freezes),
                "rfps": round(tp["rfps"], 1),
                "cfps": round(tp["cfps"], 1),
                "rfps_window": round(tp["rfps_window"], 1),
                "cfps_window": round(tp["cfps_window"], 1),
                "sampler": r.data_server.sampler.name,
            }
        return {
            "wall_s": round(wall_s, 3),
            "frames_total": frames_total,
            "frames_per_s": round(frames_total / max(wall_s, 1e-9), 1),
            "freeze_latency_s_mean": (round(sum(latencies) / len(latencies), 4)
                                      if latencies else None),
            "freeze_latency_s_max": (round(max(latencies), 4)
                                     if latencies else None),
            "roles": per_role,
            "league": self.league.league_state(),
            "clean_shutdown": True,
        }


# ---------------------------------------------------------------------------
def role_params(cfg, seed: int, i: int, device) -> dict:
    """Role i's seed params, on `device`: drawn from a `torch.Generator`
    there seeded with `seed * 1000 + i`. The threaded runtime, the
    multiprocess coordinator, the `--sync` loop and the serving fleet all
    make their seed params here (`repro` folds `i` into `PRNGKey(seed)`)."""
    return init_params(torch.Generator(device=device).manual_seed(seed * 1000 + i), cfg)


def build_runtime(spec: LeagueSpec, *, env_name: str = "rps",
                  arch: str = "tleague-policy-s", loss: str = "ppo",
                  num_envs: int = 8, unroll_len: int = 8, lr: float = 3e-4,
                  seed: int = 0, served: bool = False, pbt: bool = False,
                  ring_segments: Optional[int] = None,
                  heartbeat_timeout_s: float = 30.0,
                  sampler: str = "uniform", prefetch: bool = True,
                  device=None) -> LeagueRuntime:
    """Wire a LeagueRuntime from a LeagueSpec: per-role Actors + Learner +
    DataServer over one shared LeagueMgr/ModelPool/PayoffMatrix (and one
    shared InfServer when `served`). `ring_segments` sizes each role's ring
    in segments; default = 2x the role's actor count so every actor can
    stay one segment ahead of the learner before backpressure bites.
    `heartbeat_timeout_s` is how long workers keep running without a
    coordinator beat before exiting cleanly. `sampler` picks each role's
    replay strategy (`repro_torch.learners.samplers`); non-uniform samplers
    run the DataServer off-policy (blocking=False) since their whole point
    is revisiting old rows. `prefetch` is each DataServer's own (the
    staging of the next batch while the current step runs).

    Everything runs on `device`: CUDA when None (raising where there is
    none), the CPU when asked by name. Role i's seed params come from
    `role_params` on that device; the actors' generators are seeded as
    `repro` seeds its actors' keys."""
    dev = resolve_device(device)
    env = make_env(env_name, device=dev)
    cfg = get_arch(arch)
    league = install_roles(spec, lambda i: role_params(cfg, seed, i, dev),
                           pbt=pbt, seed=seed)
    opt = adamw(lr, clip_norm=1.0)
    inf_server = None
    if served:
        inf_server = InfServer(
            cfg, env.spec.num_actions, seed=seed + 7919, device=dev,
            max_batch=max(64, num_envs * env.spec.num_agents
                          * spec.num_actors_total))

    n_learner_slots = env.spec.team_size
    seg_rows = num_envs * n_learner_slots
    seg_frames = seg_rows * unroll_len

    heartbeat = Heartbeat()
    roles: List[RoleRuntime] = []
    for i, role in enumerate(spec):
        segs = ring_segments or max(2, 2 * role.num_actors)
        ds = DataServer(capacity_frames=segs * seg_frames,
                        blocking=(sampler == "uniform"), sampler=sampler,
                        prefetch=prefetch, device=dev)
        actor_workers = []
        for a in range(role.num_actors):
            actor = Actor(env, cfg, league, agent_id=role.name,
                          num_envs=num_envs, unroll_len=unroll_len,
                          seed=seed * 1000 + i * 100 + a,
                          inf_server=inf_server, device=dev)
            actor_workers.append(ActorWorker(
                f"actor/{role.name}/{a}", actor, ds, heartbeat=heartbeat,
                heartbeat_timeout_s=heartbeat_timeout_s))
        step = build_env_train_step(cfg, env.spec.num_actions, opt, loss=loss)
        learner = Learner(league, step, opt,
                          league.model_pool.pull(ModelKey(role.name, 0)),
                          agent_id=role.name, data_server=ds, device=dev)
        roles.append(RoleRuntime(
            spec=role, actors=actor_workers,
            learner=LearnerWorker(f"learner/{role.name}", learner, ds,
                                  heartbeat=heartbeat,
                                  heartbeat_timeout_s=heartbeat_timeout_s),
            data_server=ds))
    return LeagueRuntime(league, roles, inf_server=inf_server,
                         heartbeat=heartbeat)
