"""Learner: the data-consuming module (§3.2); counterpart of
`repro.learners.learner`.

Owns the train step, an embedded DataServer, and the league protocol:
requests its task at each learning-period beginning, pushes theta to the
ModelPool every `publish_every` steps so Actors stay fresh, and at
learning-period end freezes theta into the opponent pool via LeagueMgr.
Runs on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import LeagueMgr
from repro_torch.kernels import dispatch
from repro_torch.learners.replay import DataServer
from repro_torch.params import CachedPuller
from repro_torch.utils import resolve_device, tree_map


def _snapshot(params, device=None):
    """A copy of a param tree that shares no storage with it (on `device`
    when given). The port's train step donates nothing, but the pool must
    never alias the Learner's working copy, nor the Learner the pool's."""
    def copy(x):
        x = torch.as_tensor(x).detach()
        return x.clone() if device is None else x.to(device, copy=True)
    return tree_map(copy, params)


class Learner:
    def __init__(self, league: LeagueMgr, train_step: Callable, optimizer,
                 init_params, *, agent_id: str = "main",
                 publish_every: int = 1, data_server: Optional[DataServer] = None,
                 device_feed: bool = True,
                 priority_fn: Optional[Callable] = None, device=None):
        """`device` holds the working params and the batches: CUDA when None
        (raising where there is none), the CPU when asked by name. The
        default DataServer stages onto the same device.

        `device_feed` routes minibatches through the DataServer's
        double-buffered `sample_to_device` path (host-to-device copies
        overlap the train step); data servers without that path are read
        with `sample`, whose host arrays are then moved to `device`.

        `priority_fn(traj, metrics) -> per-row priorities` closes the
        prioritized-replay loop: after each train step it is called with
        the consumed minibatch and the step metrics, and its result is
        written back through `data_server.update_priorities` against the
        slots/generations the server recorded for that batch."""
        self.league = league
        self.agent_id = agent_id
        self.train_step = train_step
        self.optimizer = optimizer
        self.device_feed = device_feed
        self.device = resolve_device(device)
        # private working copy: the caller's init_params object is typically
        # also the ModelPool's seed entry
        self.params = _snapshot(init_params, self.device)
        self.opt_state = optimizer.init(self.params)
        # version-cached pool pulls for the post-freeze adopt: an exploiter
        # reset or PBT exploit ships only the changed leaves. copy=False: the
        # cache may alias the pool's live entry, which is safe because pool
        # entries are replaced, never mutated, and the adopt below snapshots
        self._puller = CachedPuller(league.model_pool, copy=False)
        self.data_server = data_server or DataServer(device=self.device)
        self.priority_fn = priority_fn
        self.publish_every = publish_every
        self.step_count = 0
        self.task = league.request_learner_task(agent_id)

    @property
    def current_key(self):
        return self.league.agents[self.agent_id].current

    def _next_batch(self):
        if self.device_feed and hasattr(self.data_server, "sample_to_device"):
            return self.data_server.sample_to_device()
        return tree_map(lambda a: torch.as_tensor(a).to(self.device),
                        self.data_server.sample())

    def learn(self, num_steps: int = 1):
        """Consume `num_steps` minibatches from the DataServer."""
        last_metrics = {}
        for _ in range(num_steps):
            if not self.data_server.ready():
                break
            traj = self._next_batch()
            info = (self.data_server.last_sample_info()
                    if self.priority_fn is not None
                    and hasattr(self.data_server, "last_sample_info") else None)
            self.params, self.opt_state, last_metrics = self.train_step(
                self.params, self.opt_state, traj)
            if info is not None and info.get("slots") is not None:
                self.data_server.update_priorities(
                    info["slots"], self.priority_fn(traj, last_metrics),
                    gen=info.get("gen"))
            self.step_count += 1
            if self.step_count % self.publish_every == 0:
                self.league.model_pool.push(self.current_key,
                                            _snapshot(self.params),
                                            step=self.step_count)
        return last_metrics

    def stats(self) -> dict:
        """Learner-side telemetry: step progress, the DataServer's feed
        rates, and the port's per-call kernel routing counts (a
        '...|reference' key for a CUDA learner means a misroute)."""
        out = {"step_count": self.step_count}
        if hasattr(self.data_server, "throughput"):
            out["data_server"] = self.data_server.throughput()
        out["dispatch"] = dispatch.stats()
        return out

    def end_learning_period(self, reason: str = "period"):
        """Freeze theta into M, adopt theta_{v+1} (paper lifecycle).

        theta_{v+1} is re-pulled from the ModelPool rather than assumed to
        equal our live params: the LeagueMgr may have reset it to the seed
        (exploiter reset-on-freeze) or PBT-exploited the leader's weights,
        and the pool entry is authoritative. The pull rides the param plane
        (`CachedPuller`) and is then snapshotted onto `device`, so the
        working copy never shares storage with the pool or the cache."""
        old_key = self.current_key
        new_key = self.league.end_learning_period(
            self.agent_id, _snapshot(self.params), reason=reason)
        self.params = _snapshot(self._puller.get(new_key), self.device)
        if old_key != new_key:
            self._puller.drop(old_key)       # one lineage key cached, ever
        self.opt_state = self.optimizer.init(self.params)   # fresh moments
        self.task = self.league.request_learner_task(self.agent_id)
        return new_key
