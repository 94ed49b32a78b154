"""Actor: the data-producing module (§3.2); counterpart of
`repro.actors.actor`.

Loop per the paper: at each segment beginning request a Task from LeagueMgr
(learning policy theta + opponent phi), pull both parameter sets from the
ModelPool, run the Env-Agt interaction, ship the trajectory segment to the
Learner (a DataServer queue), and report game outcomes back to LeagueMgr at
episode endings.

Two inference modes:
  * local (default): θ and φ forwards run in the collector's loop on the
    Actor's device (`JitCollector`).
  * served: pass `inf_server=` and every policy forward is routed through
    the central continuous-batching InfServer (SEED-style), with θ and φ
    hosted as separate routes of one grouped forward. The Actor keeps the
    server's routes fresh from the ModelPool before each segment.

Parameter sync rides the param plane (`repro_torch.params`): θ and φ are
pulled through a `CachedPuller`, so a segment whose models did not change
costs one `NotModified` tag per key instead of a full pytree copy, while a
Learner publish ships only the changed leaves. The served refresh is
hash-gated: `update_params`/`ensure_model` carry the manifest's
`tree_hash`, so the InfServer no-ops identical swaps.

The Actor runs on CUDA unless asked for the CPU; its env must be on the same
device. Its random draws (env resets, action sampling) come from one
`torch.Generator` on that device, seeded from `seed`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.actors.collector import JitCollector, ServedCollector
from repro_torch.core import LeagueMgr, MatchResult
from repro_torch.envs.base import MultiAgentEnv
from repro_torch.envs.vector import TorchVectorEnv
from repro_torch.params import CachedPuller
from repro_torch.utils import resolve_device


class Actor:
    def __init__(self, env: MultiAgentEnv, cfg, league: LeagueMgr, *,
                 agent_id: str = "main", num_envs: int = 16, unroll_len: int = 16,
                 learner_slots=None, seed: int = 0, inf_server=None,
                 actor_id: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"Actor on {self.device}, its env on {env.device}")
        self.env, self.cfg, self.league = env, cfg, league
        self.agent_id = agent_id
        # lease identity: when set, request_task names this actor so the
        # league can tie the lease to heartbeat liveness (and release the
        # previous lease when the next segment starts)
        self.actor_id = actor_id
        self.inf_server = inf_server
        venv = TorchVectorEnv(env, num_envs)
        if inf_server is None:
            self.collector = JitCollector(venv, cfg, unroll_len=unroll_len,
                                          learner_slots=learner_slots)
        else:
            self.collector = ServedCollector(venv, unroll_len=unroll_len,
                                             learner_slots=learner_slots)
        self.rollout, self.init_carry = self.collector.collect, self.collector.init_carry
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.carry = None
        # version-cached pulls: unchanged models cost a NotModified tag,
        # Learner publishes arrive as changed-leaf deltas
        self._puller = CachedPuller(league.model_pool)
        self._theta_key = None        # current lineage key (cache eviction)
        self._served_theta_key = None
        self._evict_backlog = set()   # routes declined while requests pending
        self.num_envs, self.unroll_len = num_envs, unroll_len
        self.frames_produced = 0   # rfps numerator (paper Table 3)

    def run_segment(self):
        """One Task -> one unroll segment. Returns (trajectory, task); the
        trajectory's leaves are host numpy arrays."""
        if self.actor_id is None:
            task = self.league.request_task(self.agent_id)
        else:
            task = self.league.request_task(self.agent_id, actor_id=self.actor_id)
        # the lineage advanced: drop the superseded theta's cache entry —
        # it is only ever pulled again if it froze into the pool and comes
        # back as somebody's φ (one full re-pull then)
        if self._theta_key is not None and self._theta_key != task.learner_key:
            self._puller.drop(self._theta_key)
        self._theta_key = task.learner_key
        theta, theta_man = self._puller.get_with_manifest(task.learner_key)
        phi, phi_man = self._puller.get_with_manifest(task.opponent_keys[0])
        if self.carry is None:
            self.carry = self.init_carry(self.gen)
        if self.inf_server is None:
            self.carry, traj, episodes = self.rollout(theta, phi, self.carry, self.gen)
        else:
            self._maybe_refresh_served(task, theta, theta_man, phi, phi_man)
            self.carry, traj, episodes = self.rollout(
                self.inf_server, task.learner_key, task.opponent_keys[0],
                self.carry, self.gen)
        self._report(task, episodes)
        self.frames_produced += self.num_envs * self.unroll_len
        return traj, task

    def _maybe_refresh_served(self, task, theta, theta_man, phi, phi_man):
        """Refresh the shared InfServer's routes from the pool: θ hot-swaps
        whenever its content changed (the Learner keeps pushing), frozen φ
        registers once; the previous lineage route is evicted when θ's key
        advances, unless it froze into the pool (then it is a legitimate
        opponent route other workers may be mid-segment on). `evict_model`
        declines while requests are queued for the route, so whatever
        remains is retried next segment. Every refresh carries the
        manifest's `tree_hash` and pool version, so the server no-ops
        identical content and drops stale versions; the calls stay
        unconditional because they double as the route existence check."""
        prev = self._served_theta_key
        if prev is not None and prev != task.learner_key:
            self._evict_backlog.add(prev)
        self._evict_backlog.discard(task.learner_key)
        self._evict_backlog.discard(task.opponent_keys[0])
        frozen = set(self.league.frozen_pool)
        self._evict_backlog = {
            k for k in self._evict_backlog
            if k not in frozen and not self.inf_server.evict_model(k)}
        self._served_theta_key = task.learner_key
        self.inf_server.update_params(
            theta, key=task.learner_key,
            content_hash=theta_man.tree_hash if theta_man else None,
            version=theta_man.version if theta_man else None)
        self.inf_server.ensure_model(
            task.opponent_keys[0], phi,
            content_hash=phi_man.tree_hash if phi_man else None)

    def _report(self, task, episodes):
        done = np.asarray(episodes["done"])      # (T, E)
        outcome = np.asarray(episodes["outcome"])
        for t, e in zip(*np.nonzero(done)):
            self.league.report_result(MatchResult(
                learner_key=task.learner_key,
                opponent_keys=task.opponent_keys,
                outcome=int(outcome[t, e]),
                episode_len=int(t) + 1,
                task_id=task.task_id))
