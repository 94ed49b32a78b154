"""Agt: the policy wrapper an Actor embeds (§3.2); counterpart of
`repro.actors.policy`.

Observations are token sequences; the action head is the (masked) LM head
at the last position, the value the scalar head there. Params and
observations may carry a leading model axis M (the InfServer's grouped
forward); outputs then do too.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models.transformer import forward_train
from repro_torch.rl.distributions import categorical_logp, categorical_sample


class ObsPolicy(NamedTuple):
    logits_values: Callable   # (params, obs (..., B, L)) -> (logits (..., B, A), values (..., B))
    act: Callable             # (params, gen, obs) -> (action, logp, value)


def make_obs_policy(cfg, num_actions: int) -> ObsPolicy:
    if num_actions > cfg.vocab_size:
        raise ValueError(f"{num_actions} actions exceed vocab {cfg.vocab_size}")

    def logits_values(params, obs):
        logits, values, _ = forward_train(params, cfg, {"tokens": obs})
        return logits[..., -1, :num_actions], values[..., -1]

    def act(params, gen, obs):
        lg, v = logits_values(params, obs)
        a = categorical_sample(gen, lg)
        return a, categorical_logp(lg, a), v

    return ObsPolicy(logits_values, act)
