"""Collector: owns N VectorEnv slots, drives acting, assembles segments;
counterpart of `repro.actors.collector`.

The `VectorEnv` steps slots, the Collector decides *where actions come
from* (local params vs. InfServer tickets) and emits the
`(carry, traj, episodes)` segment contract everything downstream (`Actor`,
`ActorWorker`, `DataServer`) speaks, with `repro`'s record layout: the
learner slots' rows as (E·k, T, ...), `done` repeated over the learner
slots, and the bootstrap value of the final observation.

* **JitCollector** — local-params acting. It keeps `repro`'s name so a
  reader finds the counterpart, but the port has no compiled scan: it is
  an eager loop over `unroll_len` steps, each one θ forward, one φ
  forward, one env step and one fresh reset of every slot for the
  autoreset select, all on the env's device. Nothing in the loop reads a
  device value on the host (slots are picked with slices or index tensors
  made once, actions are cast on the card), so the host only enqueues
  work; the segment comes off the card once, at the end (`to_host`).
* **ServedCollector** — SEED-style acting through an InfServer ticket
  stream, the phase machine of `repro` (`begin` / `submit_step` /
  `complete_step` / `submit_bootstrap` / `finish`) so many collectors can
  interleave their submits into one server and coalesce into dense
  batches; `collect(...)` runs the phases back-to-back for the solo case.
  With ``coalesce=True`` (default) the collector never calls
  `server.flush()` — the first `get()` of an unresolved ticket flushes
  everything pending on the server. Observations go to the server as
  numpy, as in `repro`; the env runs on the collector's device.

`collect_interleaved` drives K collectors over one server in lockstep.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.actors.policy import make_obs_policy
from repro_torch.envs.vector import VectorEnv
from repro_torch.utils.host import to_host


def _resolve_slots(spec, learner_slots):
    learner_slots = tuple(learner_slots if learner_slots is not None
                          else range(spec.team_size))
    opp_slots = tuple(i for i in range(spec.num_agents)
                      if i not in learner_slots)
    return learner_slots, opp_slots


def _selector(slots, device):
    """Index for the agent axis: a slice when `slots` is a contiguous run,
    else an index tensor on `device`, made once (a Python list index would
    be a host-to-device copy per use)."""
    if slots and list(slots) == list(range(slots[0], slots[0] + len(slots))):
        return slice(slots[0], slots[0] + len(slots))
    return torch.tensor(slots, dtype=torch.long, device=device)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class JitCollector:
    """Local-params collector: an eager loop over `unroll_len` steps.

    ``collect(learner_params, opponent_params, carry, gen)`` returns
    `(carry, traj, episodes)` with the carry on the device and the segment
    as host numpy arrays; `collect_on_device` is the same with the segment
    left on the device (no host sync at all).
    """

    def __init__(self, venv: VectorEnv, cfg, *, unroll_len: int,
                 learner_slots: Sequence[int] | None = None):
        if not venv.jittable:
            raise ValueError("JitCollector needs a batched VectorEnv "
                             "(use ServedCollector / HostVectorEnv for host-loop envs)")
        spec = venv.spec
        self.venv = venv
        self.unroll_len = unroll_len
        self.learner_slots, self.opp_slots = _resolve_slots(spec, learner_slots)
        self.policy = make_obs_policy(cfg, spec.num_actions)
        self._sel_l = _selector(self.learner_slots, venv.device)
        self._sel_o = _selector(self.opp_slots, venv.device) if self.opp_slots else None

    def _act(self, params, gen, obs_slots):
        E, k, L = obs_slots.shape
        a, logp, v = self.policy.act(params, gen, obs_slots.reshape(E * k, L))
        return a.view(E, k).to(torch.int32), logp.view(E, k), v.view(E, k)

    @torch.no_grad()
    def collect_on_device(self, learner_params, opponent_params, carry, gen):
        venv, T = self.venv, self.unroll_len
        E, A, n_l = venv.num_envs, venv.spec.num_agents, len(self.learner_slots)
        states, obs = carry
        recs = []
        for _ in range(T):
            obs_l = obs[:, self._sel_l]
            a_l, logp_l, v_l = self._act(learner_params, gen, obs_l)
            acts = torch.empty((E, A), dtype=torch.int32, device=venv.device)
            acts[:, self._sel_l] = a_l
            if self._sel_o is not None:
                acts[:, self._sel_o] = self._act(opponent_params, gen, obs[:, self._sel_o])[0]
            states, obs, rewards, done, outcome = venv.step_autoreset(states, acts, gen)
            recs.append((obs_l, a_l, logp_l, v_l, rewards[:, self._sel_l], done, outcome))
        # bootstrap value of the final observation
        v_boot = self._act(learner_params, gen, obs[:, self._sel_l])[2]

        obs_r, act_r, logp_r, v_r, rew_r, done_r, out_r = (torch.stack(x) for x in zip(*recs))

        def to_bt(x):                      # (T, E, k, ...) -> (E*k, T, ...)
            return x.movedim(0, 2).reshape((E * n_l, T) + x.shape[3:])

        traj = {
            "obs": to_bt(obs_r),
            "actions": to_bt(act_r),
            "behavior_logp": to_bt(logp_r),
            "behavior_values": to_bt(v_r),
            "rewards": to_bt(rew_r),
            "done": done_r.T.repeat_interleave(n_l, dim=0),        # (E*k, T)
            "bootstrap_value": v_boot.reshape(E * n_l),
        }
        episodes = {"done": done_r, "outcome": out_r}              # (T, E)
        return (states, obs), traj, episodes

    def collect(self, learner_params, opponent_params, carry, gen):
        carry, traj, episodes = self.collect_on_device(learner_params, opponent_params,
                                                       carry, gen)
        traj, episodes = to_host((traj, episodes))
        return carry, traj, episodes

    def init_carry(self, gen):
        return self.venv.reset(gen)


class ServedCollector:
    """Ticket-stream collector: policy forwards go through an InfServer.

    Phase-split per step so K collectors can interleave on one server:

        c.begin(carry, gen)
        for t in range(unroll_len):
            c.submit_step(server, theta_key, phi_key)   # enqueue tickets
            c.complete_step(server)                     # resolve + step env
        c.submit_bootstrap(server, theta_key)
        carry, traj, episodes = c.finish(server)

    `complete_step`'s first `server.get()` flushes every pending ticket
    on the server — including other collectors' — so interleaved drivers
    get one dense grouped forward per step instead of one per collector.
    """

    def __init__(self, venv: VectorEnv, *, unroll_len: int,
                 learner_slots: Sequence[int] | None = None,
                 coalesce: bool = True):
        spec = venv.spec
        self.venv = venv
        self.unroll_len = unroll_len
        self.coalesce = coalesce
        self.learner_slots, self.opp_slots = _resolve_slots(spec, learner_slots)
        self.n_l, self.n_o = len(self.learner_slots), len(self.opp_slots)
        self._phase = "idle"

    # -- phase machine ------------------------------------------------------
    def begin(self, carry, gen):
        if self._phase != "idle":
            raise RuntimeError(f"begin() in phase {self._phase}")
        self._states, self._obs = carry
        self._gen = gen
        self._t = 0
        self._recs = []
        self._pending = None
        self._phase = "submit"

    def submit_step(self, server, theta_key, phi_key):
        if self._phase != "submit":
            raise RuntimeError(f"submit_step() in phase {self._phase}")
        E, n_l, n_o = self.venv.num_envs, self.n_l, self.n_o
        obs_np = _host(self._obs)
        sub = getattr(server, "submit_async", None) or server.submit
        tkt_l = sub(obs_np[:, list(self.learner_slots)].reshape(E * n_l, -1),
                    model=theta_key)
        tkt_o = None
        if self.opp_slots:
            tkt_o = sub(obs_np[:, list(self.opp_slots)].reshape(E * n_o, -1),
                        model=phi_key)
        if not self.coalesce:
            server.flush()                     # eager: θ and φ share one forward
        self._pending = (obs_np, tkt_l, tkt_o)
        self._phase = "complete"

    def complete_step(self, server):
        if self._phase != "complete":
            raise RuntimeError(f"complete_step() in phase {self._phase}")
        E, n_l, n_o = self.venv.num_envs, self.n_l, self.n_o
        obs_np, tkt_l, tkt_o = self._pending
        self._pending = None
        # get() self-flushes anything still pending on the server — in the
        # interleaved layout this is the single grouped forward per step
        a_l, logp_l, v_l = (x.reshape(E, n_l) for x in server.get(tkt_l))
        acts = np.zeros((E, self.venv.spec.num_agents), np.int32)
        acts[:, list(self.learner_slots)] = a_l
        if tkt_o is not None:
            acts[:, list(self.opp_slots)] = server.get(tkt_o)[0].reshape(E, n_o)
        self._states, self._obs, rewards, done, outcome = self.venv.step_autoreset(
            self._states, torch.from_numpy(acts).to(self.venv.device), self._gen)
        self._recs.append({
            "obs": obs_np[:, list(self.learner_slots)],
            "actions": a_l,
            "behavior_logp": logp_l,
            "behavior_values": v_l,
            "rewards": _host(rewards)[:, list(self.learner_slots)],
            "done": _host(done),
            "outcome": _host(outcome),
        })
        self._t += 1
        self._phase = "submit" if self._t < self.unroll_len else "bootstrap"

    def submit_bootstrap(self, server, theta_key):
        if self._phase != "bootstrap":
            raise RuntimeError(f"submit_bootstrap() in phase {self._phase}")
        E, n_l = self.venv.num_envs, self.n_l
        final_obs = _host(self._obs)
        sub = getattr(server, "submit_async", None) or server.submit
        self._boot_tkt = sub(final_obs[:, list(self.learner_slots)].reshape(E * n_l, -1),
                             model=theta_key)
        if not self.coalesce:
            server.flush()
        self._phase = "finish"

    def finish(self, server):
        if self._phase != "finish":
            raise RuntimeError(f"finish() in phase {self._phase}")
        E, n_l, T = self.venv.num_envs, self.n_l, self.unroll_len
        v_boot = server.get(self._boot_tkt)[2]
        recs = self._recs

        def to_bt(name):
            x = np.stack([r[name] for r in recs], axis=1)   # (E, T, k, ...)
            x = np.moveaxis(x, 2, 1)                          # (E, k, T, ...)
            return x.reshape((E * n_l, T) + x.shape[3:])

        done_te = np.stack([r["done"] for r in recs], axis=0)     # (T, E)
        traj = {
            "obs": to_bt("obs"),
            "actions": to_bt("actions"),
            "behavior_logp": to_bt("behavior_logp"),
            "behavior_values": to_bt("behavior_values"),
            "rewards": to_bt("rewards"),
            "done": np.repeat(done_te.T, n_l, axis=0),            # (E*k, T)
            "bootstrap_value": v_boot.reshape(E * n_l),
        }
        episodes = {"done": done_te,
                    "outcome": np.stack([r["outcome"] for r in recs], axis=0)}
        self._recs, self._boot_tkt = [], None
        self._phase = "idle"
        return (self._states, self._obs), traj, episodes

    # -- solo driver --------------------------------------------------------
    def collect(self, server, theta_key, phi_key, carry, gen):
        """`build_served_rollout`-compatible: run all phases back-to-back."""
        self.begin(carry, gen)
        for _ in range(self.unroll_len):
            self.submit_step(server, theta_key, phi_key)
            self.complete_step(server)
        self.submit_bootstrap(server, theta_key)
        return self.finish(server)

    def init_carry(self, gen):
        return self.venv.reset(gen)


def collect_interleaved(collectors: Sequence[ServedCollector], server,
                        jobs: Sequence[Tuple]) -> list:
    """Drive K ServedCollectors over one shared server in lockstep.

    ``jobs[i] = (theta_key, phi_key, carry, gen)`` for ``collectors[i]``.
    Every collector submits its step-t tickets before any of them
    completes, so each step runs as one dense grouped forward over all
    K collectors' slots. All collectors must share one `unroll_len`.
    Returns ``[(carry, traj, episodes), ...]`` in collector order.
    """
    if not collectors or len(collectors) != len(jobs):
        raise ValueError("one job per collector, at least one collector")
    T = collectors[0].unroll_len
    if any(c.unroll_len != T for c in collectors):
        raise ValueError("interleaved collectors must share unroll_len")
    for c, (theta, phi, carry, gen) in zip(collectors, jobs):
        c.begin(carry, gen)
    for _ in range(T):
        for c, (theta, phi, _, _) in zip(collectors, jobs):
            c.submit_step(server, theta, phi)
        for c in collectors:
            c.complete_step(server)
    for c, (theta, _, _, _) in zip(collectors, jobs):
        c.submit_bootstrap(server, theta)
    return [c.finish(server) for c in collectors]
