"""Batched multi-agent environment protocol (the Arena/Env role, §3.2, §3.5);
counterpart of `repro.envs.base`.

`repro`'s envs are pure JAX functions of one slot, and `JaxVectorEnv` vmaps
them over slots. The port has no vmap, so its envs are batched from the
start: every function takes and returns a leading slot axis E, and one call
steps every slot with a few dozen tensor ops on the env's device.

    state, obs = env.reset(gen, num_envs)
    state, obs, rewards, done, info = env.step(state, actions, gen)

Shapes and dtypes are `repro`'s with E in front: obs (E, num_agents,
obs_len) int32 *tokens*, actions (E, num_agents) int32, rewards
(E, num_agents) fp32, done (E,) bool, `info["outcome"]` (E,) int32 where
the env reports one. Every state leaf carries E too. Random draws come from
`gen`, a `torch.Generator` on the env's device; nothing reads global RNG
state. The envs run on CUDA unless `make_env` is asked for the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.utils import resolve_device
from repro_torch.utils.registry import Registry


@dataclass(frozen=True)
class EnvSpec:
    name: str
    num_agents: int
    obs_len: int            # tokens per observation
    num_actions: int
    max_steps: int
    obs_vocab: int          # obs token ids live in [0, obs_vocab)
    team_size: int = 1      # >1: consecutive slots form teams (Pommerman Team mode)
    zero_sum: bool = True


class MultiAgentEnv(NamedTuple):
    spec: EnvSpec
    reset: Callable      # (gen, num_envs) -> (state, obs)
    step: Callable       # (state, actions, gen) -> (state, obs, rewards, done, info)
    device: torch.device


ENVS: Registry = Registry("env")


def make_env(name: str, device=None, **kw) -> MultiAgentEnv:
    """The registered env `name`, its constants on `device` (CUDA when None,
    raising where there is none)."""
    return ENVS.get(name)(device=resolve_device(device), **kw)
