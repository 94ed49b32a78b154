"""VectorEnv: batched env slots behind one interface (the collector plane);
counterpart of `repro.envs.vector`.

A `VectorEnv` owns N independent instances ("slots") of one
`MultiAgentEnv` and exposes batched `reset`/`step`/`autoreset` over slot
arrays — the env-stepping layer the Collector drives.

Two adapters implement the interface:

* **TorchVectorEnv** — the counterpart of `JaxVectorEnv`. The port's envs
  are batched already (`envs/base.py`), so its ops are the env's own, one
  call for every slot, on the env's device. `jittable` keeps `repro`'s
  name and here means "batched tensor ops": the local-params collector
  requires it.
* **HostVectorEnv** — the host-loop seam for envs whose reset/step are
  plain Python (an external simulator, a C++ binding): slots are stepped
  one by one, each as a batch of 1, and stacked with NumPy. States are a
  per-slot list, opaque to callers.

RNG: one `torch.Generator` on the env's device goes in; the batched env
draws every slot's numbers from it in one call (`repro` splits a key per
slot instead, so the streams differ and only deterministic quantities are
compared across the packages).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.envs.base import EnvSpec, MultiAgentEnv
from repro_torch.utils import tree_map


class VectorEnv:
    """Interface + shared combinators. Subclasses provide `reset`,
    `step` and set `jittable`."""

    jittable: bool = False

    def __init__(self, env: MultiAgentEnv, num_envs: int):
        if num_envs < 1:
            raise ValueError("a VectorEnv needs at least one slot")
        self.env = env
        self.num_envs = num_envs

    @property
    def spec(self) -> EnvSpec:
        return self.env.spec

    @property
    def device(self) -> torch.device:
        return self.env.device

    # -- batched protocol ---------------------------------------------------
    def reset(self, gen) -> Tuple[Any, Any]:
        """gen -> (states, obs) with a leading (num_envs,) slot axis."""
        raise NotImplementedError

    def step(self, states, actions, gen):
        """(states, actions (E, A), gen) -> (states, obs, rewards, done,
        info), everything carrying the slot axis."""
        raise NotImplementedError

    def autoreset(self, done, reset_states, reset_obs, states, obs):
        """Select per slot: the fresh (reset) state where `done`, the
        stepped state elsewhere. A where-select over every leaf, so the
        host never reads `done`."""
        sel = lambda a, b: torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
        return tree_map(sel, reset_states, states), sel(reset_obs, obs)

    def step_autoreset(self, states, actions, gen):
        """One collector step: step every slot, auto-reset finished ones
        (from a fresh reset of every slot, so no slot waits on a host read
        of `done`). Returns (states, obs, rewards, done, outcome) —
        `outcome` is the env's per-slot episode outcome (zeros when the env
        reports none), pulled out of `info`."""
        states2, obs2, rewards, done, info = self.step(states, actions, gen)
        states3, obs3 = self.reset(gen)
        states_n, obs_n = self.autoreset(done, states3, obs3, states2, obs2)
        outcome = info.get("outcome")
        if outcome is None:
            outcome = torch.zeros((self.num_envs,), dtype=torch.int32, device=self.device)
        return states_n, obs_n, rewards, done, outcome


class TorchVectorEnv(VectorEnv):
    """Slot-batched env on its device: the env's own batched ops."""

    jittable = True

    def reset(self, gen):
        return self.env.reset(gen, self.num_envs)

    def step(self, states, actions, gen):
        return self.env.step(states, actions, gen)


class HostVectorEnv(VectorEnv):
    """Host-loop adapter: slots stepped one at a time (each a batch of 1),
    results stacked with NumPy. For envs that cannot batch (external
    simulators); the port's envs also run here, which is what the tests
    drive it with."""

    jittable = False

    def reset(self, gen):
        pairs = [self.env.reset(gen, 1) for _ in range(self.num_envs)]
        obs = np.stack([o[0].cpu().numpy() for _, o in pairs])
        return [s for s, _ in pairs], obs

    def step(self, states, actions, gen):
        if not isinstance(actions, torch.Tensor):
            actions = torch.from_numpy(np.asarray(actions, np.int32))
        actions = actions.to(self.device)
        outs = [self.env.step(states[i], actions[i:i + 1], gen)
                for i in range(self.num_envs)]
        obs = np.stack([o[1][0].cpu().numpy() for o in outs])
        rewards = np.stack([o[2][0].cpu().numpy() for o in outs])
        done = np.array([bool(o[3][0]) for o in outs])
        info = {}
        if "outcome" in outs[0][4]:
            info["outcome"] = np.array([int(o[4]["outcome"][0]) for o in outs], np.int32)
        return [o[0] for o in outs], obs, rewards, done, info

    def autoreset(self, done, reset_states, reset_obs, states, obs):
        done = np.asarray(done)
        states_n = [reset_states[i] if done[i] else states[i] for i in range(self.num_envs)]
        obs_n = np.where(done.reshape((-1,) + (1,) * (np.ndim(obs) - 1)),
                         np.asarray(reset_obs), np.asarray(obs))
        return states_n, obs_n

    def step_autoreset(self, states, actions, gen):
        states2, obs2, rewards, done, info = self.step(states, actions, gen)
        states3, obs3 = self.reset(gen)
        states_n, obs_n = self.autoreset(done, states3, obs3, states2, obs2)
        outcome = info.get("outcome", np.zeros((self.num_envs,), np.int32))
        return states_n, obs_n, rewards, done, outcome


def make_vector_env(env: MultiAgentEnv, num_envs: int, *, host: bool = False) -> VectorEnv:
    """Adapter selection: every in-repo env is batched, so the default is
    `TorchVectorEnv`; `host=True` opts into the host-loop seam."""
    if host:
        return HostVectorEnv(env, num_envs)
    return TorchVectorEnv(env, num_envs)
