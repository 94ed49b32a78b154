"""Evaluation harness: pit policies (learned or scripted) against each other
in any bundled env; counterpart of `repro.eval`.

A slot policy is `fn(obs (1, L) numpy, np_rng) -> (1,) actions`, as in
`repro`. `play_episodes` runs its env as a batch of one slot on the env's
device (CUDA unless the env was made for the CPU); `learned_policy_fn`
acts on its params' device with a `torch.Generator` seeded from `seed`.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.actors.policy import make_obs_policy
from repro_torch.envs.base import MultiAgentEnv
from repro_torch.utils import resolve_device


def learned_policy_fn(cfg, num_actions, params, seed=0, device=None):
    dev = resolve_device(device)
    policy = make_obs_policy(cfg, num_actions)
    gen = torch.Generator(device=dev).manual_seed(seed)

    @torch.no_grad()
    def fn(obs, np_rng):
        a, _, _ = policy.act(params, gen, torch.as_tensor(np.asarray(obs), device=dev))
        return a.to(torch.int32).cpu().numpy()

    return fn


def play_episodes(env: MultiAgentEnv, slot_policies: Sequence[Callable],
                  episodes: int = 10, seed: int = 0) -> Dict:
    """slot_policies[i](obs (1,L), np_rng) -> (1,) action for agent slot i.
    Returns outcomes, per-slot reward sums, and env-specific info (frags)."""
    if len(slot_policies) != env.spec.num_agents:
        raise ValueError(f"{len(slot_policies)} policies for {env.spec.num_agents} slots")
    gen = torch.Generator(device=env.device).manual_seed(seed)
    np_rng = np.random.default_rng(seed)
    outcomes, reward_sums, frags = [], [], []
    for _ in range(episodes):
        state, obs = env.reset(gen, 1)
        done = False
        rsum = np.zeros(env.spec.num_agents)
        info = {}
        t = 0
        while not done and t < env.spec.max_steps + 1:
            obs_np = obs[0].cpu().numpy()
            acts = np.concatenate([slot_policies[i](obs_np[i:i + 1], np_rng)
                                   for i in range(env.spec.num_agents)])
            state, obs, rew, done_, info = env.step(
                state, torch.from_numpy(acts.astype(np.int32))[None].to(env.device), gen)
            rsum += rew[0].cpu().numpy()
            done = bool(done_[0])
            t += 1
        outcomes.append(int(info["outcome"][0]) if "outcome" in info else 0)
        reward_sums.append(rsum)
        if "frags" in info:
            frags.append(info["frags"][0].cpu().numpy())
    out = {"outcomes": np.array(outcomes), "reward_sums": np.stack(reward_sums)}
    if frags:
        out["frags"] = np.stack(frags)
    return out


def winrate_vs(outcomes: np.ndarray) -> float:
    """Ties half-counted, as the paper's Fig. 4 does."""
    wins = (outcomes > 0).sum() + 0.5 * (outcomes == 0).sum()
    return float(wins / len(outcomes))
