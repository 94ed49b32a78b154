"""LeagueMgr: sponsors the training, coordinates all other modules (§3.2);
counterpart of `repro.core.league_mgr`, with the same decisions for the
same seeds.

Lifecycle per learning agent (M_G of them can run in parallel):
  - the current learning model key theta is registered with GameMgr+HyperMgr
  - Actors call `request_task` at each episode beginning -> Task(theta, phi~Q)
  - Actors call `report_result` at each episode end -> payoff/Elo update
  - the Learner calls `request_learner_task` at each learning-period
    beginning (rank-0 only, as in the paper's MPI semantics)
  - `end_learning_period` freezes theta into the pool (M <- M + {theta}),
    mints theta_{v+1} (inheriting params via the ModelPool and hypers via
    HyperMgr — optionally PBT-perturbed), and returns the new key.

Role-based scheduling (AlphaStar / Minimax-Exploiter extension): each
learning agent can carry a role (`main`, `main_exploiter`,
`league_exploiter`, `minimax_exploiter`), a `FreezeGate` that gates
freezing on pool winrate (freeze when winrate >= tau vs the frozen pool,
or on timeout) instead of a fixed period count, and a reset-on-freeze
policy (`continue` keeps training from theta; `seed` restores the
imitation/random seed params, the exploiter reset of AlphaStar). The
league coordinator polls `should_freeze` and the Learner executes the
freeze via `end_learning_period`.

Every public method is thread-safe (one RLock): in the async runtime
Actors, Learners and the coordinator call in concurrently from their own
threads.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.game_mgr import GameMgr, SelfPlayPFSPGameMgr
from repro_torch.core.hyper_mgr import HyperMgr
from repro_torch.core.model_pool import ModelPool
from repro_torch.core.payoff import PayoffMatrix
from repro_torch.core.types import (FreezeGate, Hyperparam, MatchResult, ModelKey,
                              Task)
from repro_torch.utils.pytree import tree_copy

ROLES = ("main", "main_exploiter", "league_exploiter", "minimax_exploiter")


@dataclass
class LearningAgent:
    agent_id: str
    current: ModelKey
    game_mgr: GameMgr
    frozen_count: int = 0
    role: str = "main"
    gate: Optional[FreezeGate] = None
    reset_on_freeze: str = "continue"      # 'continue' | 'seed'
    seed_params: Any = None                # kept only when reset needs it


@dataclass
class TaskLease:
    """One outstanding match: who holds it, and until when.

    A lease is completed by the first `report_result` quoting its task_id,
    released when the same actor requests its next task, or *reaped* when
    its deadline passes / its actor is declared dead — in which case the
    match template re-enters the matchmaking queue under a fresh task_id
    (a new generation) and any late results quoting the old id are dropped."""
    task_id: int
    task: Task
    agent_id: str
    actor_id: Optional[str]
    deadline: float
    issued_t: float
    reissue_of: Optional[int] = None


# how many reaped task_ids we remember for the late-result generation guard
_REAPED_MEMORY = 4096


class LeagueMgr:
    def __init__(self, model_pool: Optional[ModelPool] = None,
                 hyper_mgr: Optional[HyperMgr] = None,
                 payoff: Optional[PayoffMatrix] = None,
                 pbt: bool = False, seed: int = 0,
                 lease_ttl_s: Optional[float] = None):
        self.model_pool = model_pool or ModelPool()
        self.hyper_mgr = hyper_mgr or HyperMgr(seed=seed)
        self.payoff = payoff or PayoffMatrix()
        self.agents: Dict[str, LearningAgent] = {}
        self.frozen_pool: List[ModelKey] = []   # M, ordered by freeze time
        self.pbt = pbt
        self._task_ids = itertools.count()
        self._results: List[MatchResult] = []
        self._lock = threading.RLock()
        # incremental pool-membership filter: the opponent list only changes
        # when a model freezes or pool membership moves, so cache it behind a
        # (frozen-pool length, pool membership version) signature instead of
        # re-filtering O(pool) on every request_task
        self._opp_cache: Tuple[ModelKey, ...] = ()
        self._opp_sig: Tuple[int, int] = (-1, -1)
        self.freeze_events: List[dict] = []     # telemetry: who froze, why, when
        # -- lease plane (active only when lease_ttl_s is set) ----------------
        # With lease_ttl_s=None the task_id counter still runs but no lease
        # state is kept: legacy drivers keep the exact pre-lease behavior and
        # memory profile. With a TTL, every request_task records a TaskLease;
        # `reap_leases` (called by the coordinator, fed by heartbeat counters)
        # expires them, re-queues the match, and arms the generation guard.
        self.lease_ttl_s = lease_ttl_s
        self._leases: Dict[int, TaskLease] = {}
        self._actor_lease: Dict[str, int] = {}          # actor_id -> outstanding task_id
        self._reaped: "collections.OrderedDict[int, float]" = collections.OrderedDict()
        self._reissue: Dict[str, collections.deque] = {}  # agent_id -> Task templates
        self.lease_stats = {
            "issued": 0, "completed": 0, "released": 0, "reaped": 0,
            "reissued": 0, "dropped_results": 0,
        }

    # -- setup -------------------------------------------------------------------
    def add_learning_agent(self, agent_id: str, init_params: Any,
                           game_mgr: Optional[GameMgr] = None,
                           hyper: Optional[Hyperparam] = None,
                           seed_into_pool: bool = True,
                           role: str = "main",
                           gate: Optional[FreezeGate] = None,
                           reset_on_freeze: str = "continue") -> ModelKey:
        """Register a learning agent with its seed model theta_1 (random init
        or imitation-learned, §3.1)."""
        assert role in ROLES, f"unknown role {role!r}; pick from {ROLES}"
        assert reset_on_freeze in ("continue", "seed"), reset_on_freeze
        with self._lock:
            gm = game_mgr or SelfPlayPFSPGameMgr(payoff=self.payoff)
            gm.payoff = self.payoff             # all agents share one payoff matrix
            key = ModelKey(agent_id, 0)
            self.model_pool.push(key, init_params)
            self.hyper_mgr.register(key, hyper)
            gm.add_player(key)
            seed_params = tree_copy(init_params) if reset_on_freeze == "seed" else None
            self.agents[agent_id] = LearningAgent(
                agent_id, key, gm, role=role, gate=gate,
                reset_on_freeze=reset_on_freeze, seed_params=seed_params)
            if seed_into_pool:
                # the seed policy is a valid opponent from the start
                frozen_seed = ModelKey(agent_id, 0)
                if frozen_seed not in self.frozen_pool:
                    self.frozen_pool.append(frozen_seed)
            return key

    # -- actor-facing API -----------------------------------------------------
    def _opponents(self) -> Tuple[ModelKey, ...]:
        """Frozen-pool members whose params are pullable, cached until the
        frozen pool or the ModelPool's key set actually changes."""
        sig = (len(self.frozen_pool), self.model_pool.membership_version)
        if sig != self._opp_sig:
            self._opp_cache = tuple(k for k in self.frozen_pool
                                    if k in self.model_pool)
            self._opp_sig = sig
        return self._opp_cache

    def request_task(self, agent_id: str = "main",
                     actor_id: Optional[str] = None) -> Task:
        """Actor-facing: sample an opponent and return a fresh Task. Holds
        the league lock only for the matchmaking draw — never blocks on
        anything else. The returned Task is an immutable value object
        (safe to ship across threads or the RPC transport); params are NOT
        included — the Actor pulls them from the ModelPool by key.

        When the lease plane is active, the Task is issued under a lease
        with deadline `now + lease_ttl_s`; a reaped match waiting in the
        re-issue queue wins over a fresh matchmaking draw (under a NEW
        task_id — the old generation stays dead). An actor names itself
        via `actor_id` so its previous lease is released on its next
        request (one task in flight per actor) and so the reaper can tie
        leases to heartbeat liveness."""
        with self._lock:
            ag = self.agents[agent_id]
            tid = next(self._task_ids)
            task = self._pop_reissue(ag)
            if task is not None:
                self.lease_stats["reissued"] += 1
                task = Task(learner_key=task.learner_key,
                            opponent_keys=task.opponent_keys,
                            hyperparam=task.hyperparam, task_id=tid)
            else:
                opp = ag.game_mgr.get_opponent(ag.current, self._opponents())
                task = Task(learner_key=ag.current, opponent_keys=(opp,),
                            hyperparam=self.hyper_mgr.get(ag.current),
                            task_id=tid)
            if self.lease_ttl_s is not None:
                now = time.monotonic()
                if actor_id is not None:
                    self._release_actor(actor_id)
                    self._actor_lease[actor_id] = tid
                self._leases[tid] = TaskLease(
                    task_id=tid, task=task, agent_id=agent_id,
                    actor_id=actor_id, deadline=now + self.lease_ttl_s,
                    issued_t=now)
                self.lease_stats["issued"] += 1
            return task

    def _pop_reissue(self, ag: LearningAgent) -> Optional[Task]:
        """Next reaped match template for this agent, skipping templates
        whose learner key went stale (the lineage froze past them — the
        fresh draw is strictly better evidence)."""
        q = self._reissue.get(ag.agent_id)
        while q:
            t = q.popleft()
            if t.learner_key == ag.current:
                return t
        return None

    def _release_actor(self, actor_id: str):
        """The actor moved on: its previous lease is done (released), not
        reaped — no re-issue, and its late results stay acceptable."""
        prev = self._actor_lease.pop(actor_id, None)
        if prev is not None and self._leases.pop(prev, None) is not None:
            self.lease_stats["released"] += 1

    def report_result(self, result: MatchResult):
        """Actor-facing: record an episode outcome on the shared payoff
        matrix (and the owning agent's matchmaker state). Non-blocking
        (lock only); safe to call from any worker thread at any rate —
        freeze gating reads the same payoff under the same lock, so a
        result is visible to `should_freeze` as soon as this returns.

        Generation guard: a result quoting a reaped lease is dropped with
        telemetry (`lease_stats['dropped_results']`) — the match was
        re-issued to someone else, and double-recording would corrupt the
        payoff matrix. Results with task_id=-1 (legacy/eval traffic)
        bypass the guard entirely."""
        with self._lock:
            tid = getattr(result, "task_id", -1)
            if tid in self._reaped:
                self.lease_stats["dropped_results"] += 1
                return
            lease = self._leases.pop(tid, None) if tid >= 0 else None
            if lease is not None:
                self.lease_stats["completed"] += 1
                if lease.actor_id is not None and \
                        self._actor_lease.get(lease.actor_id) == tid:
                    del self._actor_lease[lease.actor_id]
            self._results.append(result)
            for key in (result.learner_key, *result.opponent_keys):
                if key not in self.payoff:
                    self.payoff.add_model(key)
            ag = self.agents.get(result.learner_key.agent_id)
            if ag is not None:
                ag.game_mgr.on_match_result(result)
            else:
                # unknown lineage (eval traffic, a lineage whose learner
                # already detached): record straight on the shared payoff
                # matrix instead of minting a throwaway GameMgr per result
                self.payoff.record(result)

    # -- lease plane (coordinator API) -----------------------------------------
    def touch_actor(self, actor_id: str, now: Optional[float] = None):
        """Heartbeat feed: the actor is alive — push its outstanding
        lease's deadline out to now + lease_ttl_s."""
        with self._lock:
            if self.lease_ttl_s is None:
                return
            tid = self._actor_lease.get(actor_id)
            lease = self._leases.get(tid) if tid is not None else None
            if lease is not None:
                t = time.monotonic() if now is None else now
                lease.deadline = t + self.lease_ttl_s

    def reap_leases(self, now: Optional[float] = None,
                    dead_actors: Iterable[str] = ()) -> List[TaskLease]:
        """Coordinator-facing: expire leases past their deadline or held by
        a dead actor. Each reaped match template re-enters its agent's
        re-issue queue (served to the next `request_task` under a fresh
        task_id) and the old task_id is remembered so late results from
        the presumed-dead actor are dropped. Returns the reaped leases."""
        with self._lock:
            if not self._leases:
                return []
            t = time.monotonic() if now is None else now
            dead = set(dead_actors)
            reaped = [l for l in self._leases.values()
                      if l.deadline <= t or
                      (l.actor_id is not None and l.actor_id in dead)]
            for lease in reaped:
                del self._leases[lease.task_id]
                if lease.actor_id is not None and \
                        self._actor_lease.get(lease.actor_id) == lease.task_id:
                    del self._actor_lease[lease.actor_id]
                self._reaped[lease.task_id] = t
                q = self._reissue.setdefault(lease.agent_id,
                                             collections.deque())
                q.append(lease.task)
                self.lease_stats["reaped"] += 1
            while len(self._reaped) > _REAPED_MEMORY:
                self._reaped.popitem(last=False)
            return reaped

    def lease_state(self) -> dict:
        """Lease-plane telemetry: counters plus current occupancy. The
        chaos smoke asserts `dropped_results` here — the payoff matrix
        never saw a reaped generation's outcome."""
        with self._lock:
            return {
                **self.lease_stats,
                "outstanding": len(self._leases),
                "reissue_queued": sum(len(q) for q in self._reissue.values()),
                "ttl_s": self.lease_ttl_s,
            }

    # -- learner-facing API ------------------------------------------------------
    def request_learner_task(self, agent_id: str = "main") -> Task:
        return self.request_task(agent_id)

    # -- freeze gating (league coordinator API) ----------------------------------
    def pool_winrate(self, agent_id: str) -> Tuple[float, float]:
        """theta's aggregate (winrate, games) vs the current frozen pool —
        the FreezeGate signal."""
        with self._lock:
            ag = self.agents[agent_id]
            opponents = [k for k in self._opponents() if k != ag.current]
            return self.payoff.aggregate_vs(ag.current, opponents)

    def should_freeze(self, agent_id: str, steps: int) -> Optional[str]:
        """Freeze reason if this agent's gate fires at `steps` learner steps
        into the current period; None to keep training. Agents without a
        gate (legacy fixed-period drivers) never self-trigger."""
        with self._lock:
            ag = self.agents[agent_id]
            if ag.gate is None:
                return None
            wr, games = self.pool_winrate(agent_id)
            return ag.gate.check(steps, wr, games)

    def end_learning_period(self, agent_id: str, params: Any,
                            reason: str = "period") -> ModelKey:
        """Freeze theta, mint theta_{v+1} (same lineage), PBT if enabled.

        theta_{v+1} warm-starts from theta, unless the agent's
        reset-on-freeze policy is 'seed' (exploiter roles), in which case it
        restarts from the stashed seed params — the AlphaStar exploiter
        reset. Callers that hold live params (the Learner) must re-pull
        theta_{v+1} from the ModelPool afterwards.

        Contract: non-blocking (league lock only, briefly also the pool
        lock via push/freeze). `params` is stored LIVE as the frozen final
        weights AND (under 'continue') as theta_{v+1}'s warm start — hand
        over a snapshot, never a buffer a train step may change. The
        single-writer discipline (only the owning Learner thread calls
        this for its agent) is by convention, not enforced."""
        with self._lock:
            ag = self.agents[agent_id]
            old = ag.current
            self.model_pool.push(old, params)       # final weights
            self.model_pool.freeze(old)
            if old not in self.frozen_pool:
                self.frozen_pool.append(old)
            new = ModelKey(agent_id, old.version + 1)
            if ag.reset_on_freeze == "seed" and ag.seed_params is not None:
                self.model_pool.push(new, tree_copy(ag.seed_params))
            else:
                self.model_pool.push(new, params)   # warm start from theta
            self.hyper_mgr.inherit(new, old)
            if self.pbt:
                self._maybe_pbt(agent_id, new)
            ag.game_mgr.add_player(new, parent=old)
            if new not in self.payoff:
                self.payoff.add_model(new)
            ag.current = new
            ag.frozen_count += 1
            self.freeze_events.append({
                "key": str(old), "agent": agent_id, "role": ag.role,
                "reason": reason, "t": time.monotonic()})
            return new

    def _maybe_pbt(self, agent_id: str, new_key: ModelKey):
        """If this agent's Elo trails the best learning agent by >100, copy
        the leader's params+hypers (exploit) and perturb (explore)."""
        if len(self.agents) < 2:
            self.hyper_mgr.explore(new_key)
            return
        elos = {aid: self.payoff.elo.get(a.current, self.payoff.init_elo)
                for aid, a in self.agents.items()}
        best = max(elos, key=elos.get)
        if best != agent_id and elos[best] - elos[agent_id] > 100.0:
            leader = self.agents[best]
            # deep-copy the leader's pytree: the pulled object is (or will
            # be adopted as) live learner state, and sharing it between two
            # lineages lets one lineage's train step reach the other's
            # buffers
            self.model_pool.push(new_key,
                                 self.model_pool.pull(leader.current, copy=True))
            self.hyper_mgr.exploit_explore(new_key, leader.current)
        else:
            self.hyper_mgr.explore(new_key)

    # -- introspection ---------------------------------------------------------
    def current_model_key(self, agent_id: str) -> ModelKey:
        """The lineage's current learning key. Cheap by design (one small
        value, lock only) — the RPC transport's per-step `current_key`
        lookups land here instead of on the full `league_state` dump."""
        with self._lock:
            return self.agents[agent_id].current

    def league_state(self) -> dict:
        with self._lock:
            return {
                "frozen_pool": [str(k) for k in self.frozen_pool],
                "agents": {aid: str(a.current) for aid, a in self.agents.items()},
                "roles": {aid: a.role for aid, a in self.agents.items()},
                "elo": {str(k): v for k, v in self.payoff.elo.items()},
                "num_results": len(self._results),
                "num_freezes": len(self.freeze_events),
            }
