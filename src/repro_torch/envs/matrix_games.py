"""Matrix games: Rock-Paper-Scissors and friends (§3.1's motivating example);
counterpart of `repro.envs.matrix_games`, batched over a leading slot axis.

`rps` is iterated RPS with the opponent's last move in the observation —
rich enough that independent RL visibly circulates while FSP converges to
the uniform NE.
"""
from __future__ import annotations

import torch

from repro_torch.envs.base import ENVS, EnvSpec, MultiAgentEnv

# payoff for (my_action, opp_action): rows rock/paper/scissors
RPS_PAYOFF = [
    [0.0, -1.0, 1.0],
    [1.0, 0.0, -1.0],
    [-1.0, 1.0, 0.0],
]

# biased variant: scissors-wins pay double (NE no longer uniform)
RPS_BIASED = [
    [0.0, -1.0, 1.0],
    [1.0, 0.0, -2.0],
    [-1.0, 2.0, 0.0],
]


def _make_rps(payoff, name: str, episode_len: int, device: torch.device) -> MultiAgentEnv:
    spec = EnvSpec(name=name, num_agents=2, obs_len=2, num_actions=3,
                   max_steps=episode_len, obs_vocab=8)
    table = torch.tensor(payoff, dtype=torch.float32, device=device)

    def _obs(state):
        # per agent: [opponent_last_action_token, step_parity]
        opp_last = state["last"].flip(1)
        parity = (state["t"] % 2 + 4)[:, None].expand(-1, 2)
        return torch.stack([opp_last, parity], dim=2)

    def reset(gen, num_envs):
        state = {"t": torch.zeros((num_envs,), dtype=torch.int32, device=device),
                 "last": torch.full((num_envs, 2), 3, dtype=torch.int32, device=device)}
        return state, _obs(state)

    def step(state, actions, gen):
        actions = actions.to(torch.int32)
        r0 = table[actions[:, 0], actions[:, 1]]
        state = {"t": state["t"] + 1, "last": actions}
        done = state["t"] >= episode_len
        return state, _obs(state), torch.stack([r0, -r0], dim=1), done, {}

    return MultiAgentEnv(spec, reset, step, device)


ENVS.register("rps", lambda device, episode_len=8: _make_rps(RPS_PAYOFF, "rps", episode_len,
                                                               device))
ENVS.register("rps_biased", lambda device, episode_len=8: _make_rps(RPS_BIASED, "rps_biased",
                                                                      episode_len, device))
